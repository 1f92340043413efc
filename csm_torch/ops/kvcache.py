"""Static-shape float KV caches for incremental decoding.

Layout (num_layers, batch, max_seq, num_kv_heads, head_dim), as in the JAX
package.  Unlike the functional JAX cache, the port writes new keys and
values IN PLACE: ``update_layer`` mutates the cache tensors it is given and
returns them.  The int8 ``QuantKV`` cache waits for quantized inference
(ROADMAP.md A.8).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from csm_torch.models.config import TransformerConfig


class KVCache(NamedTuple):
    k: torch.Tensor  # (L, B, S, Hkv, D)
    v: torch.Tensor

    @property
    def max_seq_len(self) -> int:
        return self.k.shape[2]


def init_kv_cache(
    cfg: TransformerConfig,
    batch_size: int,
    dtype=torch.bfloat16,
    max_seq_len: int | None = None,
    device="cpu",
) -> KVCache:
    """All-zero cache; ``max_seq_len`` overrides the config length (the
    decoder's cache holds ``audio_num_codebooks`` slots)."""
    if dtype == torch.int8:
        raise NotImplementedError(
            "int8 KV caches wait for quantized inference (ROADMAP.md A.8)"
        )
    seq = max_seq_len if max_seq_len is not None else cfg.max_seq_len
    shape = (cfg.num_layers, batch_size, seq, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
    )


def update_layer(
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    offset: int,
):
    """Write (B, S, Hkv, D) keys/values into one layer's (B, Smax, Hkv, D)
    cache at column ``offset``, in place; returns the two cache tensors."""
    S = k_new.shape[1]
    k_cache[:, offset : offset + S] = k_new.to(k_cache.dtype)
    v_cache[:, offset : offset + S] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
