"""Single-query GQA decode attention: CUDA kernel and its plain version.

``decode_gqa_attention`` runs every cached S=1 attention of the frame step
(16 backbone layers + 4 decoder layers × 30 steps per frame).  On a CUDA
tensor it launches ``csrc/decode_attention.cu`` (the port of the TPU kernel
in the JAX package's ``ops/decode_attention.py``); on a CPU tensor it
computes ``decode_attention_plain``.  There is no fallback between the two.
The kernel splits T over a thread-block cluster by ``decode_plan``, which
reads shapes only, so one launch a call holds in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from csm_torch.utils.cuda_build import load_library
from csm_torch.utils.device import sm_count

SOURCE = "decode_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
MAX_SPLITS = 16  # blocks of a cluster that share one (kv head, row)'s keys

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)


def decode_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    q (B, 1, Hq, D), k/v (B, T, Hkv, D), mask bool (B|1, 1, T) → (B, 1, Hq, D)
    in q's dtype.  q is scaled by 1/sqrt(D) and rounded to its dtype before
    the dot (as the reference kernel does); scores, softmax and the P·V sum
    in float32; a row whose mask is all False gives zeros."""
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qs = (q.float() * (1.0 / math.sqrt(D))).to(q.dtype).float()
    qs = qs[:, 0].reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,btkd->bkgt", qs, k.float())
    live = mask.expand(B, 1, T)[:, 0][:, None, None, :]
    s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgt,btkd->bkgd", p, v.float()) / torch.where(l > 0, l, 1.0)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


class DecodePlan(NamedTuple):
    tile: int  # keys a tile: the unit of loading and of skipping masked keys
    splits: int  # blocks of a cluster that share one (kv head, row)'s tiles


def tile_keys(D: int) -> int:
    """Keys a tile: 64, or 32 at D = 128 (8 KB of bf16 K either way from D = 64)."""
    return 32 if D == 128 else 64


@functools.lru_cache(maxsize=None)
def decode_plan(B: int, Hkv: int, T: int, D: int, sm_count: int) -> DecodePlan:
    """The kernel's launch plan, from shapes alone (never the mask, so a
    CUDA graph can hold the launch): split T so that the B·Hkv clusters
    cover the SMs, at most MAX_SPLITS ways and never more ways than tiles,
    so every split has one."""
    tile = tile_keys(D)
    ntiles = -(-T // tile)
    splits = max(1, min(MAX_SPLITS, ntiles, -(-sm_count // (B * Hkv))))
    return DecodePlan(tile, splits)


def decode_shares(T: int, plan: DecodePlan) -> list[tuple[int, int]]:
    """The keys [t0, t1) each split takes, as the kernel computes them:
    whole tiles, split r from r·n/splits to (r+1)·n/splits of the n tiles."""
    n, S = -(-T // plan.tile), plan.splits
    return [(r * n // S * plan.tile, min(T, (r + 1) * n // S * plan.tile)) for r in range(S)]


def _check(q, k, v, mask):
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or k.shape != v.shape:
        raise ValueError(f"k/v must be (B, T, Hkv, D): {tuple(k.shape)}, {tuple(v.shape)}")
    T, Hkv = k.shape[1], k.shape[2]
    if Hq % Hkv or T < 1:
        raise ValueError(f"bad heads/length: Hq={Hq}, Hkv={Hkv}, T={T}")
    if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[1:] != (1, T) or mask.shape[0] not in (1, B):
        raise ValueError(f"mask must be bool (B|1, 1, T), got {mask.dtype} {tuple(mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v must share a float32 or bfloat16 dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("mask", mask)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t is not mask and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _lib():
    lib = load_library(SOURCE)
    fn = lib.csm_decode_attention
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i,
                       ctypes.c_longlong, ctypes.c_float, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def decode_gqa_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Single-step GQA attention over a float KV cache.

    q (B, 1, Hq, D); k/v (B, T, Hkv, D); mask bool (B, 1, T) or (1, 1, T),
    True = attend.  Returns (B, 1, Hq, D) in q's dtype.  CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, mask)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa_attention: unsupported device {q.device}")
    global launches
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    plan = decode_plan(B, Hkv, T, D, sm_count(q.device))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            B, T, Hq, Hkv, D, T if mask.shape[0] == B and B > 1 else 0,
            1.0 / math.sqrt(D), *plan, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    launches += 1
    return out
