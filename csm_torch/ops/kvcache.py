"""Static-shape KV caches for incremental decoding, float or int8.

Layout (num_layers, batch, max_seq, num_kv_heads, head_dim), as in the JAX
package.  Unlike the functional JAX cache, the port writes new keys and
values IN PLACE: ``update_layer`` mutates the cache tensors it is given and
returns them.  The write column is a Python int (a slice) or a device index
tensor (``index_copy_``), the second for a CUDA graph that replays one
capture at a column that moves from frame to frame.

int8 (``QuantKV``): keys and values are quantized when they are written,
with one symmetric float32 scale per (batch, position, kv head) row over
head_dim, and dequantized where attention reads them.  The cache never
holds float K/V.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from csm_torch.models.config import TransformerConfig


class QuantKV(NamedTuple):
    """int8 half of a KV cache (keys OR values)."""

    q: torch.Tensor  # int8, the float cache's shape (L?, B, S, Hkv, D)
    s: torch.Tensor  # float32 per-row scale (L?, B, S, Hkv, 1), absmax / 127


KVHalf = Union[torch.Tensor, QuantKV]


class KVCache(NamedTuple):
    k: KVHalf  # (L, B, S, Hkv, D) tensor, or QuantKV of the same shape
    v: KVHalf

    @property
    def max_seq_len(self) -> int:
        leaf = self.k.q if isinstance(self.k, QuantKV) else self.k
        return leaf.shape[2]


def layer_half(c: KVHalf, layer: int) -> KVHalf:
    """One layer of a layer-stacked cache half (a view: writes land in the
    cache)."""
    if isinstance(c, QuantKV):
        return QuantKV(c.q[layer], c.s[layer])
    return c[layer]


def quantize_kv_rows(x: torch.Tensor) -> QuantKV:
    """Symmetric int8 per (..., row) over the last (head_dim) axis."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True)
    s = (m / 127.0).clamp_min(1e-8)
    return QuantKV(torch.round(xf / s).to(torch.int8), s)


def dequantize_kv(c: KVHalf, dtype) -> torch.Tensor:
    """QuantKV → dense at ``dtype``; a float tensor passes through."""
    if isinstance(c, QuantKV):
        return (c.q.float() * c.s).to(dtype)
    return c


def init_kv_cache(
    cfg: TransformerConfig,
    batch_size: int,
    dtype=torch.bfloat16,
    max_seq_len: int | None = None,
    device="cpu",
) -> KVCache:
    """All-zero cache; ``max_seq_len`` overrides the config length (the
    decoder's cache holds ``audio_num_codebooks`` slots).  ``torch.int8``
    makes a quantized cache (QuantKV halves: int8 codes, float32 scales)."""
    seq = max_seq_len if max_seq_len is not None else cfg.max_seq_len
    shape = (cfg.num_layers, batch_size, seq, cfg.num_kv_heads, cfg.head_dim)
    if dtype == torch.int8:
        def half():
            return QuantKV(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1] + (1,), dtype=torch.float32, device=device),
            )

        return KVCache(half(), half())
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def update_layer(
    k_cache: KVHalf,
    v_cache: KVHalf,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: Union[int, torch.Tensor],
):
    """Write (B, S, Hkv, D) keys/values into one layer's (B, Smax, Hkv, D)
    cache in place; returns the two cache halves.  ``offset`` is the first
    column as a Python int, or the S columns as an int64 device tensor
    (S,).  A QuantKV cache quantizes the new rows here."""
    S = k_new.shape[1]
    if isinstance(offset, torch.Tensor):
        def write(dst, src):
            dst.index_copy_(1, offset, src.to(dst.dtype))
    else:
        cols = slice(offset, offset + S)

        def write(dst, src):
            dst[:, cols] = src.to(dst.dtype)
    if isinstance(k_cache, QuantKV):
        for cache, new in ((k_cache, k_new), (v_cache, v_new)):
            qn = quantize_kv_rows(new)
            write(cache.q, qn.q)
            write(cache.s, qn.s)
        return k_cache, v_cache
    write(k_cache, k_new)
    write(v_cache, v_new)
    return k_cache, v_cache
