"""Static-shape KV caches for incremental decoding, float or int8.

Layout (num_layers, batch, max_seq, num_kv_heads, head_dim), as in the JAX
package.  Unlike the functional JAX cache, the port writes new keys and
values IN PLACE: ``update_layer`` mutates the cache tensors it is given and
returns them.  The write columns take one of three forms:

  * a Python int: the first of the S columns every row writes (a slice);
  * an int64 device tensor (S,): the S columns every row writes
    (``index_copy_``), for a CUDA graph that replays one capture at a column
    that moves from frame to frame;
  * ``RowOffsets``: an S=1 write at a column of each row's own (serving,
    where every slot's row fills independently).  A column at or past the
    cache's end is dropped, as the JAX package's scatter drops it: the
    write reads the old entry back in its place, and nothing is clamped
    onto the last column.

The per-row form has a type of its own because its tensor is (B,), which
at B=1 has the shape of the all-rows form's (1,).

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


class RowOffsets(NamedTuple):
    """The column each row of an S=1 step writes: ``cols[b]`` for row b."""

    cols: torch.Tensor  # (B,) int64


Offset = Union[int, torch.Tensor, RowOffsets]


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


def cache_leaves(cache: KVCache) -> list:
    """The cache's tensors: k and v, or the q and s of each QuantKV half."""
    return [t for half in cache for t in (half if isinstance(half, QuantKV) else (half,))]


def reset_kv_cache(cache: KVCache) -> KVCache:
    """Zero every leaf of the cache in place (a CUDA graph keeps reading the
    same tensors); returns the cache."""
    for leaf in cache_leaves(cache):
        leaf.zero_()
    return cache


def write_rows(dst: torch.Tensor, src: torch.Tensor, cols: torch.Tensor) -> None:
    """Row b of ``src`` (B, 1, ...) into column ``cols[b]`` of row b of
    ``dst`` (B, Smax, ...), in place; a column >= Smax is dropped.  Flat
    ``index_select`` / ``index_copy_`` over (B·Smax, ...): no host read, so
    a CUDA graph holds it."""
    B, T = dst.shape[:2]
    flat = dst.view(B * T, *dst.shape[2:])
    keep = (cols < T).view(B, *([1] * (dst.dim() - 2)))
    idx = torch.arange(B, device=dst.device) * T + cols.clamp(max=T - 1)
    new = torch.where(keep, src[:, 0].to(dst.dtype), flat.index_select(0, idx))
    flat.index_copy_(0, idx, new)


def update_layer(
    k_cache: KVHalf,
    v_cache: KVHalf,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: Offset,
):
    """Write (B, S, Hkv, D) keys/values into one layer's (B, Smax, Hkv, D)
    cache in place; returns the two cache halves.  ``offset`` is the first
    column as a Python int, the S columns as an int64 device tensor (S,),
    or each row's column as ``RowOffsets`` (S must be 1; columns past the
    end are dropped).  A QuantKV cache quantizes the new rows here."""
    S = k_new.shape[1]
    if isinstance(offset, RowOffsets):
        if S != 1:
            raise ValueError(f"per-row cache offsets need S == 1, got S={S}")

        def write(dst, src):
            write_rows(dst, src, offset.cols)
    elif isinstance(offset, torch.Tensor):
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
