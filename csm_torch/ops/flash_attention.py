"""Causal GQA flash-attention forward: CUDA kernel and its plain version.

Prefill of S >= ``FLASH_MIN_SEQ`` tokens attends the whole backbone cache
through ``flash_gqa_attention``, with the mask taken from integer positions
(``kv_pos <= q_pos``) instead of a materialized (S, T) mask.  On a CUDA tensor
it launches ``csrc/flash_attention.cu`` (the port of the TPU forward kernel
in the JAX package's ``ops/flash_attention.py``); on a CPU tensor it computes
``flash_attention_plain``.  There is no fallback between the two.  The
backward kernels wait for training (ROADMAP.md B.4).
"""

from __future__ import annotations

import ctypes
import math

import torch

from csm_torch.utils.cuda_build import load_library

SOURCE = "flash_attention.cu"
FLASH_MIN_SEQ = 256
L_EMPTY = 1e30  # LSE of a row that sees no key
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)


def flash_attention_plain(q, k, v, q_pos, kv_pos):
    """The kernel's function in plain PyTorch.

    q (B, S, Hq, D), k/v (B, T, Hkv, D), q_pos (B, S) int, kv_pos (T,) or
    (B, T) int → (out (B, S, Hq, D) in q's dtype, lse (B, Hq, S) float32).
    Scale applied after the dot; a row with no visible key gives zeros and
    lse = L_EMPTY."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :].expand(B, T)
    vis = kv_pos[:, None, :] <= q_pos[:, :, None]  # (B, S, T)
    s = torch.einsum("bskgd,btkd->bskgt", q.float().reshape(B, S, Hkv, G, D), k.float())
    s = (s * (1.0 / math.sqrt(D))).masked_fill(~vis[:, :, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bskgt,btkd->bskgd", p, v.float()) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, L_EMPTY))
    lse = lse.reshape(B, S, Hq).transpose(1, 2).contiguous()
    return out.reshape(B, S, Hq, D).to(q.dtype), lse


def _check(q, k, v, q_pos, kv_pos):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,Hq,D) and k/v (B,T,Hkv,D): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or S < 1 or T < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B, S):
        raise ValueError(f"q_pos must be int32 (B, S), got {q_pos.dtype} {tuple(q_pos.shape)}")
    if kv_pos.dtype != torch.int32 or kv_pos.shape not in ((T,), (B, T), (1, T)):
        raise ValueError(f"kv_pos must be int32 (T,) or (B, T), got {kv_pos.dtype} {tuple(kv_pos.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v must share a float32 or bfloat16 dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and name in ("q", "k", "v"):
            raise ValueError(f"{name} must be 16-byte aligned")


def _lib():
    lib = load_library(SOURCE)
    fn = lib.csm_flash_attention_fwd
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
                       ctypes.c_longlong, ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return fn


def flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos):
    """Flash forward with the per-row log-sum-exp.

    q (B, S, Hq, D); k/v (B, T, Hkv, D); q_pos (B, S) int32; kv_pos (T,) or
    (B, T) int32 (PAD_POS marks dead slots).  Returns (out (B, S, Hq, D) in
    q's dtype, lse (B, Hq, S) float32, L_EMPTY where no key is visible).
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    _check(q, k, v, q_pos, kv_pos)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos)
    if q.device.type != "cuda":
        raise ValueError(f"flash_gqa_attention: unsupported device {q.device}")
    global launches
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    kv_bstride = T if kv_pos.dim() == 2 and kv_pos.shape[0] == B and B > 1 else 0
    with torch.cuda.device(q.device):
        err = _lib()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
            out.data_ptr(), lse.data_ptr(), B, S, T, Hq, Hkv, D, kv_bstride,
            1.0 / math.sqrt(D), _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"flash attention kernel launch failed: cudaError {err}")
    launches += 1
    return out, lse


def flash_gqa_attention(q, k, v, q_pos, kv_pos) -> torch.Tensor:
    """Flash forward, output only: equal to ``gqa_attention`` under
    ``causal_mask_from_positions(q_pos, kv_pos)`` wherever a row sees a key."""
    return flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos)[0]
