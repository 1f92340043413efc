"""M=1 matvec: CUDA kernel and its plain version.

``matvec(x, w)`` computes ``x @ w`` for one row x (1, K) and a row-major
weight w (K, N), accumulating in float32 and returning x's dtype.  On a
CUDA tensor it launches ``csrc/matvec.cu`` (the port of the TPU kernel of
``scripts/bench_matvec_pallas.py``); on a CPU tensor it computes
``matvec_plain``.  There is no fallback between the two.  Its caller is the
weight-streaming probe ``csm_torch/scripts/bench_matvec.py``.
"""

from __future__ import annotations

import ctypes

import torch

from csm_torch.utils.cuda_build import load_library

SOURCE = "matvec.cu"
MAX_X_BYTES = 96 * 1024  # x is staged whole in one block's shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)


def matvec_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 ``x @ w`` rounded
    once to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def _check(x, w):
    if x.dim() != 2 or x.shape[0] != 1 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"x must be (1, K) and w (K, N): {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share a float32 or bfloat16 dtype: {x.dtype}, {w.dtype}")
    K, N = w.shape
    if N % 8:
        raise ValueError(f"N = {N} must be a multiple of 8 (16-byte rows)")
    if K * x.element_size() > MAX_X_BYTES:
        raise ValueError(f"K = {K} is too long: x must fit {MAX_X_BYTES} bytes")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    for name, t in (("x", x), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _lib():
    fn = load_library(SOURCE).csm_matvec
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def matvec(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(1, K) @ (K, N) → (1, N) in x's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(x, w)
    if x.device.type == "cpu":
        return matvec_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matvec: unsupported device {x.device}")
    global launches
    K, N = w.shape
    y = torch.empty((1, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(), K, N, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"matvec kernel launch failed: cudaError {err}")
    launches += 1
    return y
