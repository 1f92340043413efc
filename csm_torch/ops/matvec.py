"""M=1 matvec: CUDA kernel and its plain version.

``matvec(x, w)`` computes ``x @ w`` for one row x (1, K) and a row-major
weight w (K, N), accumulating in float32 and returning x's dtype.  On a
CUDA tensor it launches ``csrc/matvec.cu`` (the port of the TPU kernel of
``scripts/bench_matvec_pallas.py``); on a CPU tensor it computes
``matvec_plain``.  There is no fallback between the two.  Its caller is the
weight-streaming probe ``csm_torch/scripts/bench_matvec.py``.  The kernel
splits K over a thread-block cluster by ``matvec_plan``, from shapes alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from csm_torch.utils.cuda_build import load_library
from csm_torch.utils.device import sm_count

SOURCE = "matvec.cu"
MAX_X_BYTES = 96 * 1024  # a block stages its chunk of x (all of it at cluster 1) in shared memory
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPAN_BYTES = 512  # of each row a block owns: 16 bytes a lane of a warp
STAGE_ROWS = 32  # rows of one copy stage; K is split in whole stages
MAX_CLUSTER = 16  # blocks that split K (above 8 with the non-portable opt-in)

launches = 0  # kernel launches since the last reset (read by chip_smoke.py)


def matvec_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: float32 ``x @ w`` rounded
    once to x's dtype."""
    return (x.float() @ w.float()).to(x.dtype)


class MatvecPlan(NamedTuple):
    span: int  # output columns a block owns
    cluster: int  # blocks of a cluster, which split K between them
    stage_rows: int  # K is split in whole stages of this many rows


@functools.lru_cache(maxsize=None)
def matvec_plan(K: int, N: int, elem_bytes: int, sm_count: int) -> MatvecPlan:
    """The kernel's launch plan, from shapes alone: spans of SPAN_BYTES of
    each row, and K split over a cluster so that spans × cluster fills the
    SMs about once (never more than one block an SM, at most MAX_CLUSTER
    blocks, at least one stage each)."""
    spans = -(-N // (SPAN_BYTES // elem_bytes))
    stages = -(-K // STAGE_ROWS)
    cluster = max(1, min(MAX_CLUSTER, stages, sm_count // spans))
    return MatvecPlan(SPAN_BYTES // elem_bytes, cluster, STAGE_ROWS)


def matvec_shares(K: int, plan: MatvecPlan) -> list[tuple[int, int]]:
    """The input rows [k0, k1) each rank of a cluster takes, as the kernel
    computes them: whole stages, rank r from r·S/cs to (r+1)·S/cs."""
    S, cs = -(-K // plan.stage_rows), plan.cluster
    return [(r * S // cs * plan.stage_rows, min(K, (r + 1) * S // cs * plan.stage_rows))
            for r in range(cs)]


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
        fn.argtypes = [vp, vp, vp, i, i, i, i, i, i, vp]
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
    plan = matvec_plan(K, N, x.element_size(), sm_count(x.device))
    y = torch.empty((1, N), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib()(x.data_ptr(), w.data_ptr(), y.data_ptr(), K, N, *plan, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"matvec kernel launch failed: cudaError {err}")
    launches += 1
    return y
