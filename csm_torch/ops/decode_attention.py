"""Single-query GQA decode attention: CUDA kernel and its plain version.

``decode_gqa_attention`` runs every cached S=1 attention of the frame step
(16 backbone layers + 4 decoder layers × 30 steps per frame).  On a CUDA
tensor it launches ``csrc/decode_attention.cu`` (the port of the TPU kernel
in the JAX package's ``ops/decode_attention.py``); on a CPU tensor it
computes ``decode_attention_plain``.  There is no fallback between the two.
The kernel splits T over a thread-block cluster by ``decode_plan``, which
reads shapes only, so one launch a call holds in a CUDA graph.

Given ``QuantKV`` halves (an int8 cache: codes and per-row scales), the
same call launches the kernel's int8 form, which dequantizes each tile in
registers, or on the CPU computes ``decode_attention_int8_plain``; no dense
copy of the cache is made.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from csm_torch.ops.kvcache import KVHalf, QuantKV, dequantize_kv
from csm_torch.utils.cuda_build import load_library
from csm_torch.utils.device import sm_count

SOURCE = "decode_attention.cu"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
MAX_SPLITS = 16  # blocks of a cluster that share one (kv head, row)'s keys

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)
int8_launches = 0  # launches of the int8 form, counted apart


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


def decode_attention_int8_plain(
    q: torch.Tensor, kq: torch.Tensor, ks: torch.Tensor, vq: torch.Tensor, vs: torch.Tensor,
    mask: torch.Tensor,
) -> torch.Tensor:
    """The int8 form's function in plain PyTorch: kq/vq (B, T, Hkv, D) int8,
    ks/vs (B, T, Hkv, 1) float32 scales (``QuantKV``'s layout).  Each
    element is float(code) · scale rounded to q's dtype (``dequantize_kv``),
    then ``decode_attention_plain``."""
    return decode_attention_plain(q, dequantize_kv(QuantKV(kq, ks), q.dtype),
                                  dequantize_kv(QuantKV(vq, vs), q.dtype), mask)


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
    """The checks of either form; k and v are tensors, or QuantKV halves
    whose codes are checked as k and v and whose scales beside them."""
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Hq, D), got {tuple(q.shape)}")
    B, _, Hq, D = q.shape
    quant = isinstance(k, QuantKV)
    if quant != isinstance(v, QuantKV):
        raise ValueError("k and v must both be QuantKV halves, or both tensors")
    kt, vt = (k.q, v.q) if quant else (k, v)
    if kt.dim() != 4 or kt.shape[0] != B or kt.shape[3] != D or kt.shape != vt.shape:
        raise ValueError(f"k/v must be (B, T, Hkv, D): {tuple(kt.shape)}, {tuple(vt.shape)}")
    T, Hkv = kt.shape[1], kt.shape[2]
    if Hq % Hkv or T < 1:
        raise ValueError(f"bad heads/length: Hq={Hq}, Hkv={Hkv}, T={T}")
    if mask.dtype != torch.bool or mask.dim() != 3 or mask.shape[1:] != (1, T) or mask.shape[0] not in (1, B):
        raise ValueError(f"mask must be bool (B|1, 1, T), got {mask.dtype} {tuple(mask.shape)}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q's dtype must be float32 or bfloat16, got {q.dtype}")
    tensors = [("q", q), ("mask", mask)]
    if quant:
        if not (kt.dtype == vt.dtype == torch.int8):
            raise ValueError(f"QuantKV codes must be int8: {kt.dtype}, {vt.dtype}")
        for name, s in (("k.s", k.s), ("v.s", v.s)):
            if s.dtype != torch.float32 or s.shape != (B, T, Hkv, 1):
                raise ValueError(f"{name} must be float32 (B, T, Hkv, 1), got {s.dtype} "
                                 f"{tuple(s.shape)}")
        tensors += [("k.q", kt), ("v.q", vt), ("k.s", k.s), ("v.s", v.s)]
    else:
        if not (q.dtype == kt.dtype == vt.dtype):
            raise ValueError(f"q/k/v must share a float32 or bfloat16 dtype: {q.dtype}, "
                             f"{kt.dtype}, {vt.dtype}")
        tensors += [("k", kt), ("v", vt)]
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        align = 1 if t is mask else 4 if name.endswith(".s") else 16
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")


def _lib(name: str):
    fn = getattr(load_library(SOURCE), name)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        pointers = 5 if name == "csm_decode_attention" else 7
        fn.argtypes = [vp] * pointers + [i, i, i, i, i, ctypes.c_longlong, ctypes.c_float,
                                          i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def decode_gqa_attention(
    q: torch.Tensor, k: KVHalf, v: KVHalf, mask: torch.Tensor
) -> torch.Tensor:
    """Single-step GQA attention over a float or an int8 KV cache.

    q (B, 1, Hq, D); k/v (B, T, Hkv, D) tensors of q's dtype, or ``QuantKV``
    halves (int8 codes of that shape, float32 scales (B, T, Hkv, 1)); mask
    bool (B, 1, T) or (1, 1, T), True = attend.  Returns (B, 1, Hq, D) in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (its int8 form for QuantKV halves) or raise."""
    _check(q, k, v, mask)
    quant = isinstance(k, QuantKV)
    if q.device.type == "cpu":
        if quant:
            return decode_attention_int8_plain(q, k.q, k.s, v.q, v.s, mask)
        return decode_attention_plain(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"decode_gqa_attention: unsupported device {q.device}")
    global launches, int8_launches
    B, _, Hq, D = q.shape
    kt = k.q if quant else k
    T, Hkv = kt.shape[1], kt.shape[2]
    plan = decode_plan(B, Hkv, T, D, sm_count(q.device))
    out = torch.empty_like(q)
    cache = ((k.q, k.s, v.q, v.s) if quant else (k, v))
    with torch.cuda.device(q.device):
        err = _lib("csm_decode_attention_int8" if quant else "csm_decode_attention")(
            q.data_ptr(), *(t.data_ptr() for t in cache), mask.data_ptr(), out.data_ptr(),
            B, T, Hq, Hkv, D, T if mask.shape[0] == B and B > 1 else 0,
            1.0 / math.sqrt(D), *plan, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"decode attention kernel launch failed: cudaError {err}")
    if quant:
        int8_launches += 1
    else:
        launches += 1
    return out
