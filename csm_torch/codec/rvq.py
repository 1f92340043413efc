"""Split residual vector quantizer for the Mimi codec.

1 semantic + 31 acoustic codebooks of 2048 × 256, with input/output
projections between the 512-d latent and the 256-d VQ space.  Codebooks are
stored as ``embed_sum`` / ``cluster_usage``; the effective embedding is
``embed_sum / max(cluster_usage, eps)``.  Same parameters as the JAX
package's ``codec/rvq.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

EPS = 1e-5


class RVQParams(NamedTuple):
    input_proj: torch.Tensor  # (hidden, vq_dim)
    output_proj: torch.Tensor  # (vq_dim, hidden)
    embed_sum: torch.Tensor  # (Q, codebook_size, vq_dim)
    cluster_usage: torch.Tensor  # (Q, codebook_size)


class SplitRVQParams(NamedTuple):
    semantic: RVQParams  # Q = 1
    acoustic: RVQParams  # Q = 31


def codebook_embeddings(p: RVQParams) -> torch.Tensor:
    """(Q, codebook_size, vq_dim) effective embeddings."""
    return p.embed_sum / p.cluster_usage.clamp_min(EPS)[..., None]


def rvq_encode(p: RVQParams, x: torch.Tensor) -> torch.Tensor:
    """(B, T, hidden) latents → (B, Q, T) int32 codes, nearest codebook
    entry per residual stage (argmax of 2 r·e − ||e||²)."""
    embeds = codebook_embeddings(p).float()
    residual = (x @ p.input_proj).float()
    codes = []
    for embed in embeds:  # (C, D)
        scores = 2.0 * (residual @ embed.T) - (embed**2).sum(dim=-1)
        idx = scores.argmax(dim=-1)  # (B, T)
        residual = residual - embed[idx]
        codes.append(idx)
    return torch.stack(codes, dim=1).to(torch.int32)


def rvq_decode(p: RVQParams, codes: torch.Tensor) -> torch.Tensor:
    """(B, Q, T) codes (Q may be below the codebook count) → (B, T, hidden)."""
    embeds = codebook_embeddings(p)
    codes = codes.long()
    summed = sum(embeds[q][codes[:, q]] for q in range(codes.shape[1]))
    return summed @ p.output_proj


def split_rvq_encode(
    p: SplitRVQParams, x: torch.Tensor, num_quantizers: int | None = None
) -> torch.Tensor:
    """(B, T, hidden) → (B, K, T) codes; codebook 0 is semantic."""
    sem = rvq_encode(p.semantic, x)
    if num_quantizers == 1:
        return sem
    ac = rvq_encode(p.acoustic, x)
    if num_quantizers is not None:
        ac = ac[:, : num_quantizers - 1]
    return torch.cat([sem, ac], dim=1)


def split_rvq_decode(p: SplitRVQParams, codes: torch.Tensor) -> torch.Tensor:
    """(B, K, T) codes → (B, T, hidden) latents."""
    out = rvq_decode(p.semantic, codes[:, :1])
    if codes.shape[1] > 1:
        out = out + rvq_decode(p.acoustic, codes[:, 1:])
    return out
