"""Rotary position embeddings with Llama-3.x frequency scaling.

Half-split ("rotate_half") convention, as in the JAX package: q/k projection
rows are stored in half-split order, so the weights bridge as a plain copy.
Tables are computed in float64 on the host, kept as float32 on the device
(one copy per configuration and device).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from csm_torch.models.config import TransformerConfig


def scaled_rope_freqs(
    head_dim: int,
    rope_base: float = 500_000.0,
    scale_factor: float = 32.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    old_context_len: int = 8192,
) -> np.ndarray:
    """Per-pair inverse frequencies with Llama-3.1 band scaling, float64
    numpy of shape (head_dim // 2,)."""
    exponents = np.arange(0, head_dim, 2, dtype=np.float64) / head_dim
    freqs = 1.0 / (rope_base**exponents)
    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor
    wavelen = 2.0 * math.pi / freqs
    smooth = (old_context_len / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    return np.where(
        wavelen < high_freq_wavelen,
        freqs,
        np.where(
            wavelen > low_freq_wavelen,
            freqs / scale_factor,
            (1.0 - smooth) * freqs / scale_factor + smooth * freqs,
        ),
    )


@functools.lru_cache(maxsize=16)
def _rope_tables(cfg: TransformerConfig, device: torch.device):
    freqs = scaled_rope_freqs(
        cfg.head_dim,
        cfg.rope_base,
        cfg.rope_scale_factor,
        cfg.rope_low_freq_factor,
        cfg.rope_high_freq_factor,
        cfg.rope_old_context_len,
    )
    angles = np.outer(np.arange(cfg.max_seq_len, dtype=np.float64), freqs)
    cos = torch.from_numpy(np.cos(angles).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(angles).astype(np.float32)).to(device)
    return cos, sin


def rope_tables(cfg: TransformerConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (max_seq_len, head_dim // 2) float32 on ``device``."""
    return _rope_tables(cfg, torch.device(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, D); cos/sin: (seq, D/2) or (batch, seq, D/2).
    Rotation in float32, result in x's dtype."""
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos = cos.unsqueeze(-2)  # broadcast over heads
    sin = sin.unsqueeze(-2)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def rope_at_positions(cfg: TransformerConfig, positions: torch.Tensor):
    """Gather (cos, sin) at integer positions, (seq,) or (batch, seq).

    Indices follow JAX's gather: negative ones wrap once, and out-of-range
    ones (the PAD_POS sentinel of padding slots) clamp to the last row —
    harmless, since those slots are never attended by a real query."""
    cos, sin = rope_tables(cfg, positions.device)
    n = cos.shape[0]
    idx = torch.where(positions < 0, positions + n, positions).clamp(0, n - 1).long()
    return cos[idx], sin[idx]
