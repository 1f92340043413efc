"""Grouped-int4 fused-dequant matmul: CUDA kernel and its plain version.

``int4_matmul(x, q)`` multiplies (..., K) activations by a grouped-int4
(K, N) weight (utils/quantize.py's format).  Leading dims flatten to M rows.
Decode-sized calls (M <= ``MAX_KERNEL_ROWS``) go through
``fused_int4_matmul``: on a CUDA tensor it launches ``csrc/int4_matmul.cu``
(the port of the TPU kernel in the JAX package's ``ops/int4_matmul.py``),
on a CPU tensor it computes ``int4_matmul_plain``; there is no fallback
between the two.  The kernel takes bf16 x with groups of a multiple of 16
rows on the tensor cores, K split across a thread-block cluster and reduced
inside the one launch in a fixed order (so two calls give the same bytes),
and float32 x or smaller groups on the CUDA cores.  Larger M dequantizes the
weight to x's dtype and runs one ``torch.matmul``, as the JAX package leaves
those shapes to XLA.

Differentiable in x (``Int4Matmul``: dx = g · Wᵀ through the dequantized
weight, no gradient for the frozen int4 weight), for int4-base adapter
training.
"""

from __future__ import annotations

import ctypes

import torch

from csm_torch.utils.cuda_build import load_library
from csm_torch.utils.quantize import dequantize_weight_int4, unpack_int4

SOURCE = "int4_matmul.cu"
MAX_KERNEL_ROWS = 64  # above this many rows the dequant + matmul route runs
MAX_GROUP_SIZE = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)
dequant_calls = 0  # calls that took the dequant + matmul route (M > 64)


def int4_matmul_plain(x: torch.Tensor, q: dict) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: per group a float32 dot of
    x with the sign-extended nibbles, times the group's float32 scale,
    summed over groups in float32 and rounded once to x's dtype.

    x (..., K); q {"w4p": uint8 (K/2, N), "scale4": bf16 (G, N)} → (..., N)."""
    p, s = q["w4p"], q["scale4"]
    K, N = 2 * p.shape[0], p.shape[1]
    G = s.shape[0]
    xg = x.reshape(-1, G, K // G).float().transpose(0, 1)  # (G, M, gs)
    w = unpack_int4(p).float().reshape(G, K // G, N)
    part = torch.bmm(xg, w)  # (G, M, N)
    y = (part * s.float()[:, None, :]).sum(dim=0)
    return y.to(x.dtype).reshape(*x.shape[:-1], N)


def _check(x, q):
    p, s = q["w4p"], q["scale4"]
    if x.dim() != 2 or not 1 <= x.shape[0] <= MAX_KERNEL_ROWS:
        raise ValueError(f"x must be (M <= {MAX_KERNEL_ROWS}, K), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    K = x.shape[1]
    if p.dtype != torch.uint8 or p.dim() != 2 or 2 * p.shape[0] != K:
        raise ValueError(f"w4p must be uint8 (K/2, N) with K={K}: {p.dtype} {tuple(p.shape)}")
    N = p.shape[1]
    if s.dtype != torch.bfloat16 or s.dim() != 2 or s.shape[1] != N or K % s.shape[0]:
        raise ValueError(f"scale4 must be bf16 (G, {N}) with G | {K}: {s.dtype} {tuple(s.shape)}")
    gs = K // s.shape[0]
    if gs % 2 or gs > MAX_GROUP_SIZE:
        raise ValueError(f"group size {gs} must be even and <= {MAX_GROUP_SIZE}")
    for name, t in (("w4p", p), ("scale4", s)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("w4p", p), ("scale4", s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _lib():
    lib = load_library(SOURCE)
    fn = lib.csm_int4_matmul
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def fused_int4_matmul(x: torch.Tensor, q: dict) -> torch.Tensor:
    """(M <= 64, K) @ grouped-int4 (K, N) → (M, N) in x's dtype, the
    dequantization fused into the matmul.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(x, q)
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q)
    if x.device.type != "cuda":
        raise ValueError(f"fused_int4_matmul: unsupported device {x.device}")
    global launches
    p, s = q["w4p"], q["scale4"]
    M, K = x.shape
    N = p.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(
            x.data_ptr(), p.data_ptr(), s.data_ptr(), y.data_ptr(), M, K, N, K // s.shape[0],
            _DTYPES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err:
        raise RuntimeError(f"int4 matmul kernel launch failed: cudaError {err}")
    launches += 1
    return y


def _int4_matmul(x: torch.Tensor, q: dict) -> torch.Tensor:
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    if x2.shape[0] <= MAX_KERNEL_ROWS:
        y = fused_int4_matmul(x2.contiguous(), q)
    else:
        global dequant_calls
        dequant_calls += 1
        y = x2 @ dequantize_weight_int4(q, x.dtype)
    return y.reshape(*x.shape[:-1], y.shape[-1])


class Int4Matmul(torch.autograd.Function):
    """``int4_matmul`` with a gradient for x only: dx = g · Wᵀ through the
    dequantized weight (the JAX package's custom VJP; that backward has no
    TPU kernel)."""

    @staticmethod
    def forward(ctx, x, w4p, scale4):
        ctx.save_for_backward(w4p, scale4)
        return _int4_matmul(x, {"w4p": w4p, "scale4": scale4})

    @staticmethod
    def backward(ctx, g):
        w4p, scale4 = ctx.saved_tensors
        w = dequantize_weight_int4({"w4p": w4p, "scale4": scale4}, g.dtype)
        return g @ w.T, None, None


def int4_matmul(x: torch.Tensor, q: dict) -> torch.Tensor:
    """(..., K) @ grouped-int4 (K, N) → (..., N) in x's dtype."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Int4Matmul.apply(x, q["w4p"], q["scale4"])
    return _int4_matmul(x, q)
