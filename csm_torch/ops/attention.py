"""Grouped-query attention, plain PyTorch.

The reference path for short prefill and the decoder's first (S=2) call,
and the oracle the kernels are held against.  Scores and softmax in float32
with a finite NEG_INF, so a fully masked row stays finite (uniform weights,
as in the JAX package).
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def gqa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """q (B, S, Hq, D), k/v (B, T, Hkv, D), mask (B|1, S, T) bool
    (True = attend) → (B, S, Hq, D) in q's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).float()
    scale = 1.0 / (D**0.5)
    scores = torch.einsum("bskgd,btkd->bskgt", qf * scale, k.float())
    scores = scores.masked_fill(~mask[:, :, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bskgt,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def causal_mask_from_positions(q_pos: torch.Tensor, kv_pos: torch.Tensor) -> torch.Tensor:
    """mask[b, i, j] = kv_pos[b, j] <= q_pos[b, i]; kv_pos (T,) or (B, T).

    Padding / unwritten slots carry the PAD_POS sentinel (models/csm.py),
    larger than any real query position, so no real query attends them."""
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :]
    return kv_pos[:, None, :] <= q_pos[:, :, None]
