"""Probe: is the grouped-int4 kernel faster on the CUDA cores than on the
tensor cores at M <= 8?

``csrc/int4_matmul.cu`` multiplies bf16 x by weights with groups of a
multiple of 16 rows on the tensor cores at every M from 1 to 64.  This probe
builds that source as it is, and a copy (``cuda_core_source``) whose
split-K kernel multiplies on the CUDA cores for M <= 8 instead: the same
cp.async ring, the same split of K over a thread-block cluster and the same
reduction inside the launch; each lane turns the packed bytes of its 8
columns into floats (the 2^23 exponent trick, exactly) and FMAs them into
float32 sums per group and row, scaled per group in float32, the lanes of a
quad summed at the end.  Both are held against ``int4_matmul_plain`` (one
bf16 ulp, atol 2**-8 of the output's RMS), called twice for the same bytes,
and timed in device time (CUDA events; median of 30 launches, each after a
256 MB write that evicts the L2) at the CSM-1B decoder's and backbone's
int4 projections, M = 1, 2 and 8, group size 128.

    python -m csm_torch.scripts.bench_int4_cuda_cores

Needs a CUDA card and nvcc.  Prints the card's name and power limit, one
JSON line a shape ({"shape", "M", "tensor_cores_ms", "cuda_cores_ms"}) and
a last JSON line with every row.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess

import numpy as np
import torch

from csm_torch.ops.int4_matmul import SOURCE, int4_matmul_plain
from csm_torch.utils.cuda_build import BUILD_DIR, CSRC, NVCC_FLAGS, _nvcc, load_library
from csm_torch.utils.quantize import quantize_weight_int4

# (name, K, N): the CSM-1B decoder's projections, then the backbone's
SHAPES = (("decoder wqkv", 1024, 1536), ("decoder wo", 1024, 1024), ("decoder w2", 8192, 1024),
          ("decoder w13", 1024, 16384), ("backbone wo", 2048, 2048),
          ("backbone w13", 2048, 16384))
ROWS = (1, 2, 8)
GROUP = 128
ITERS = 30  # timed launches a shape and route

# Text edits that turn csrc/int4_matmul.cu into the CUDA-core variant: the
# split-K kernel gains a row count CCR (0: tensor cores), a CUDA-core
# compute and its per-lane partials, and the M <= 8 dispatch takes it.
_EDITS = (
    ("template <int MB, int NTL, int WN>\n__global__ void __launch_bounds__(kThreads)\n"
     "int4_mma_kernel(",
     "template <int MB, int NTL, int WN, int CCR>\n__global__ void __launch_bounds__(kThreads)\n"
     "int4_mma_kernel("),
    ("  // k-steps a group (a power of two but for odd group sizes such as 48)",
     """  constexpr int CR = CCR > 0 ? CCR : 1;
  float pc[CR][C::W], ac[CR][C::W];
#pragma unroll
  for (int m = 0; m < CR; ++m)
#pragma unroll
    for (int c = 0; c < C::W; ++c) pc[m][c] = ac[m][c] = 0.f;
  auto flush_cc = [&](const bf16* ss, int gi) {
    const bf16* sc = ss + gi * C::BN + cw;
#pragma unroll
    for (int c = 0; c < C::W; ++c) {
      const float sv = __bfloat162float(sc[c]);
#pragma unroll
      for (int m = 0; m < CR; ++m) {
        ac[m][c] = fmaf(pc[m][c], sv, ac[m][c]);
        pc[m][c] = 0.f;
      }
    }
  };
  auto nib = [](uint32_t w, int shift) {
    return __uint_as_float((((w >> shift) & 0xFu) ^ 0x8u) | 0x4B000000u) - 8388616.0f;
  };

  // k-steps a group (a power of two but for odd group sizes such as 48)"""),
    ("      if (gi != gcur) {\n        if (gcur >= 0) flush(ss, gcur);\n",
     "      if (gi != gcur) {\n        if (gcur >= 0) {\n"
     "          if constexpr (CCR > 0) flush_cc(ss, gcur);\n"
     "          else flush(ss, gcur);\n        }\n"),
    ("      unpack<C::W>(w0, w1, lo, hi);\n",
     """      if constexpr (CCR > 0) {
        float wf[C::W][4];  // k = 2t, 2t+1, 2t+8, 2t+9 of the step, per column
#pragma unroll
        for (int c = 0; c < C::W; ++c) {
          const int sh = 8 * (c % 4);
          wf[c][0] = nib(w0[c / 4], sh);
          wf[c][1] = nib(w0[c / 4], sh + 4);
          wf[c][2] = nib(w1[c / 4], sh);
          wf[c][3] = nib(w1[c / 4], sh + 4);
        }
#pragma unroll
        for (int m = 0; m < CR; ++m) {
          if (m >= M) break;
          const bf16* xr = xs + m * XS + 16 * s + 2 * t;
          const float2 xa = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr));
          const float2 xb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(xr + 8));
#pragma unroll
          for (int c = 0; c < C::W; ++c) {
            float v = pc[m][c];
            v = fmaf(xa.x, wf[c][0], v);
            v = fmaf(xa.y, wf[c][1], v);
            v = fmaf(xb.x, wf[c][2], v);
            pc[m][c] = fmaf(xb.y, wf[c][3], v);
          }
        }
        continue;
      }
      unpack<C::W>(w0, w1, lo, hi);
"""),
    ("    if (gcur >= 0) flush(ss, gcur);\n  };",
     "    if (gcur >= 0) {\n      if constexpr (CCR > 0) flush_cc(ss, gcur);\n"
     "      else flush(ss, gcur);\n    }\n  };"),
    ("  float* red = part_s + C::WK * M * C::BN;          // [M][BN]\n",
     """  float* red = part_s + C::WK * M * C::BN;          // [M][BN]
  if constexpr (CCR > 0) {
#pragma unroll
    for (int m = 0; m < CR; ++m)
#pragma unroll
      for (int c = 0; c < C::W; ++c) {
        float v = ac[m][c];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (t == 0 && m < M) part_s[(wk * M + m) * C::BN + cw + c] = v;
      }
  } else
"""),
    ("template <int MB, int NTL, int WN>\ncudaError_t launch(",
     "template <int MB, int NTL, int WN, int CCR = 0>\ncudaError_t launch("),
    ("allow_large_clusters<int4_mma_kernel<MB, NTL, WN>>",
     "allow_large_clusters<int4_mma_kernel<MB, NTL, WN, CCR>>"),
    ("csm::ensure_smem<int4_mma_kernel<MB, NTL, WN>>",
     "csm::ensure_smem<int4_mma_kernel<MB, NTL, WN, CCR>>"),
    ("csm::launch_cluster(int4_mma_kernel<MB, NTL, WN>,",
     "csm::launch_cluster(int4_mma_kernel<MB, NTL, WN, CCR>,"),
    ("  if (M <= 8) return launch<1, 4, 1>(x, w4p, s4, y, g, stream);\n",
     "  if (M == 1) return launch<1, 4, 1, 1>(x, w4p, s4, y, g, stream);\n"
     "  if (M == 2) return launch<1, 4, 1, 2>(x, w4p, s4, y, g, stream);\n"
     "  if (M <= 4) return launch<1, 4, 1, 4>(x, w4p, s4, y, g, stream);\n"
     "  if (M <= 8) return launch<1, 4, 1, 8>(x, w4p, s4, y, g, stream);\n"),
)


def cuda_core_source(src: str) -> str:
    """``src`` (the text of csrc/int4_matmul.cu) with the M <= 8 route on the
    CUDA cores; raises if the source no longer has what an edit replaces."""
    for old, new in _EDITS:
        if src.count(old) != 1:
            raise ValueError(f"int4_matmul.cu changed: {old[:60]!r} is not there once")
        src = src.replace(old, new)
    return src


def _build_variant() -> ctypes.CDLL:
    out = BUILD_DIR / "int4_cuda_cores"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "int4_matmul_cuda_cores.cu", out / "int4_matmul_cuda_cores.so"
    cu.write_text(cuda_core_source((CSRC / SOURCE).read_text()))
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for the CUDA-core variant:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(so))


def _entry(lib):
    fn = lib.csm_int4_matmul
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run() -> list:
    """Both routes at every shape in SHAPES and M in ROWS; raises if either
    disagrees with the plain version or gives other bytes a second time."""
    dev = torch.device("cuda")
    fns = {"tensor_cores_ms": _entry(load_library(SOURCE)),
           "cuda_cores_ms": _entry(_build_variant())}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def timed(fn):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(ITERS)]
        for a, b in ev:
            flush.zero_()
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in ev)

    rng = np.random.default_rng(0)
    rows = []
    for name, K, N in SHAPES:
        w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) / K**0.5)
        q = quantize_weight_int4(w.to(dev, torch.bfloat16), GROUP)
        for M in ROWS:
            x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
            x = x.to(dev, torch.bfloat16)
            want = int4_matmul_plain(x, q).float()
            atol = 2**-8 * want.pow(2).mean().sqrt().item()
            row = {"shape": name, "K": K, "N": N, "M": M}
            for key, fn in fns.items():
                y, y2 = (torch.empty(M, N, device=dev, dtype=torch.bfloat16) for _ in range(2))

                def call(out=y):
                    return fn(x.data_ptr(), q["w4p"].data_ptr(), q["scale4"].data_ptr(),
                              out.data_ptr(), M, K, N, GROUP, 1,
                              torch.cuda.current_stream().cuda_stream)

                if call() or call(y2):
                    raise RuntimeError(f"{key} {name} M={M}: the launch failed")
                torch.cuda.synchronize()
                err = (y.float() - want).abs()
                if not (err <= atol + 2**-7 * want.abs()).all():
                    raise AssertionError(f"{key} {name} M={M}: max |kernel - plain| "
                                         f"{err.max().item():.3e}")
                if not torch.equal(y, y2):
                    raise AssertionError(f"{key} {name} M={M}: two calls gave other bytes")
                row[key] = timed(call)
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("bench_int4_cuda_cores needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = run()
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
