"""Token sampling: temperature → top-k → one categorical draw per row.

Same semantics as the JAX package's ``sample_topk``: inverse-CDF over the
top-k VALUES with one uniform per row.  ``uniforms`` lets a caller feed the
draws (the tests feed JAX's); otherwise they come from ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def topk_mask(logits: torch.Tensor, topk: int) -> torch.Tensor:
    """Logits strictly below the k-th largest → NEG_INF (ties survive)."""
    kth = torch.topk(logits, topk, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, NEG_INF)


def sample_topk(
    logits: torch.Tensor,
    topk: int,
    temperature,
    generator: Optional[torch.Generator] = None,
    uniforms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(..., vocab) logits → (...,) int32 token ids.

    ``temperature``: a float, or a float32 device scalar (a CUDA graph's
    frame step reads it from a buffer, so one capture serves every
    temperature).  ``uniforms``: optional (..., 1) float32 draws in
    [0, 1); when None they are drawn with ``generator`` on the logits'
    device."""
    logits = logits.float() / temperature
    vals, idx = torch.topk(logits, topk, dim=-1)  # sorted descending
    c = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    if uniforms is None:
        uniforms = torch.rand(
            logits.shape[:-1] + (1,), generator=generator, device=logits.device
        )
    j = torch.clamp((c < uniforms).sum(dim=-1), max=topk - 1)  # searchsorted
    return torch.gather(idx, -1, j[..., None])[..., 0].to(torch.int32)


def topk_probs(logits: torch.Tensor, topk: int, temperature: float) -> torch.Tensor:
    """The exact distribution ``sample_topk`` draws from."""
    return torch.softmax(topk_mask(logits.float() / temperature, topk), dim=-1)
