// Grouped-int4 fused-dequant matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel csm_tpu/ops/int4_matmul.py:_kernel (launched by
// _int4_matmul_kernel, entry int4_matmul):
//
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * q[k, n]
//
// for x (M <= 64, K) in float32 or bf16, q the sign-extended two's-complement
// nibbles of w4p (K/2, N) uint8 (byte row k/2: low nibble for even k, high
// nibble for odd k) and s the bf16 scales (K/gs, N).  Each group's dot is
// accumulated in float32, scaled in float32, and the output rounded once.
//
// What bounds it on the H100: bytes.  At M <= 64 the packed weight
// (K*N/2 bytes) and its scales (2*G*N) are most of the traffic and every
// weight serves at most 64 rows, far below the ~295 operations per byte the
// card needs before arithmetic is the limit (CSM-1B's backbone w13, K=2048,
// N=16384, streams 17.3 MB: 5.2 us at 3.35 TB/s).
//
// Design: blocks tile N in 128 columns, so the packed weight is read from
// device memory once per block for all M rows.  Each block walks K in chunks
// of whole groups (<= 256 input rows): the chunk's packed bytes (16-byte
// loads along N, which is the contiguous axis, so a warp's loads coalesce),
// its scales and its x slice are staged in shared memory; the next chunk's
// packed bytes are loaded into registers while this one is computed.  A
// thread owns 8 columns and TM rows; for small M the block's threads also
// split a chunk's byte rows (KS ways), each keeping a float32 partial per
// group that it scales and adds into a float32 accumulator at every group
// boundary; the KS accumulators are summed in shared memory at the end.
// A nibble becomes a float with two integer operations and one add (the
// 2^23 exponent trick), exactly.  Ragged N is masked.
//
// Known limits: few blocks when N is small (wo/w2 at N=2048 give 16 blocks
// for 132 SMs, the fused wqkv 24), which split-K would fix; no cp.async/TMA
// pipeline beyond one chunk of register prefetch; CUDA-core FMAs instead of
// tensor cores, which leaves M=64 bound by arithmetic.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                      // output columns per block
constexpr int kColThreads = 16;               // threads across a block's columns
constexpr int kTN = kBN / kColThreads;        // 8 columns per thread
constexpr int kLanesOfRest = kThreads / kColThreads;  // 16 = row threads x K splits
constexpr int kMaxChunkRows = 256;            // input rows staged per chunk
constexpr int kMaxChunkGroups = 32;
constexpr int kVecPerRow = kBN / 16;          // 16-byte vectors per packed row of a block
constexpr int kVecPerThread = (kMaxChunkRows / 2) * kVecPerRow / kThreads;  // 4

// Sign-extended nibble at bit ``shift`` of ``w`` as a float: 2^23 + (q + 8)
// in the mantissa, minus 2^23 + 8.
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float((((w >> shift) & 0xFu) ^ 0x8u) | 0x4B000000u) - 8388616.0f;
}

struct Shape {
  int M, K, N, gs, gpc, rt_n;  // gpc: groups per chunk; rt_n: row threads
};

// Shared memory: packed bytes (ch/2, kBN) | scales (gpc, kBN) f32 | x (m_pad, ch)
// f32; the KS partial sums (ks_n, m_pad, kBN) f32 reuse it at the end.
template <int TM>
size_t smem_bytes(const Shape& s) {
  const int ch = s.gpc * s.gs, ks_n = kLanesOfRest / s.rt_n, m_pad = s.rt_n * TM;
  const size_t stage = (size_t)(ch / 2) * kBN + (size_t)s.gpc * kBN * 4 + (size_t)m_pad * ch * 4;
  const size_t red = ks_n > 1 ? (size_t)ks_n * m_pad * kBN * 4 : 0;
  return stage > red ? stage : red;
}

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const T* __restrict__ x,                 // (M, K)
                   const uint8_t* __restrict__ w4p,         // (K/2, N)
                   const __nv_bfloat16* __restrict__ s4,    // (G, N)
                   T* __restrict__ y,                       // (M, N)
                   Shape sh, int vec_ok) {
  const int M = sh.M, K = sh.K, N = sh.N, gs = sh.gs, gpc = sh.gpc, rt_n = sh.rt_n;
  const int G = K / gs, ch = gpc * gs, gs2 = gs / 2;
  const int ks_n = kLanesOfRest / rt_n, m_pad = rt_n * TM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tn = tid % kColThreads, rest = tid / kColThreads;
  const int rt = rest % rt_n, ks = rest / rt_n;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* w_s = smem;
  float* s_s = reinterpret_cast<float*>(smem + (size_t)(ch / 2) * kBN);
  float* x_s = s_s + gpc * kBN;

  uint4 pre[kVecPerThread];
  // packed bytes of chunk c into registers; rows past the chunk and columns
  // past N read as 0
  auto prefetch = [&](int c) {
    const int rows = min(gpc, G - c * gpc) * gs2;
    const size_t r0 = (size_t)c * gpc * gs2;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = tid + i * kThreads, r = v / kVecPerRow, n = n0 + (v % kVecPerRow) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        const uint8_t* src = w4p + (r0 + r) * (size_t)N + n;
        if (vec_ok && n + 16 <= N) {
          val = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
          for (int b = 0; b < 16 && n + b < N; ++b) wd[b / 4] |= (uint32_t)src[b] << (8 * (b % 4));
          val = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
      pre[i] = val;
    }
  };

  float acc[TM][kTN], part[TM][kTN];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[t][j] = part[t][j] = 0.f;

  auto flush = [&](int gi) {
    const float* sc = s_s + gi * kBN + tn * kTN;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const float s = sc[j];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        acc[t][j] = fmaf(part[t][j], s, acc[t][j]);
        part[t][j] = 0.f;
      }
    }
  };

  const int nchunks = (G + gpc - 1) / gpc;
  prefetch(0);
  for (int c = 0; c < nchunks; ++c) {
    const int g0 = c * gpc, ng = min(gpc, G - g0), kc = ng * gs, rows = ng * gs2;
    const int k0 = g0 * gs;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = tid + i * kThreads, r = v / kVecPerRow;
      if (r < rows) *reinterpret_cast<uint4*>(w_s + r * kBN + (v % kVecPerRow) * 16) = pre[i];
    }
    for (int i = tid; i < ng * kBN; i += kThreads) {
      const int n = n0 + i % kBN;
      s_s[i] = n < N ? __bfloat162float(s4[(size_t)(g0 + i / kBN) * N + n]) : 0.f;
    }
    for (int i = tid; i < m_pad * kc; i += kThreads) {
      const int m = i / kc, kk = i % kc;
      x_s[m * ch + kk] = m < M ? csm::to_float(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (c + 1 < nchunks) prefetch(c + 1);  // in flight while this chunk is computed

    int gi = -1, next = 0;  // group (within the chunk) of the partial; its end
    for (int r = ks; r < rows; r += ks_n) {
      if (r >= next) {
        if (gi >= 0) flush(gi);
        gi = r / gs2;
        next = (gi + 1) * gs2;
      }
      const uint2 wv = *reinterpret_cast<const uint2*>(w_s + r * kBN + tn * kTN);
      float lo[kTN], hi[kTN];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        lo[b] = nibble(wv.x, 8 * b);
        hi[b] = nibble(wv.x, 8 * b + 4);
        lo[4 + b] = nibble(wv.y, 8 * b);
        hi[4 + b] = nibble(wv.y, 8 * b + 4);
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const float2 xv = *reinterpret_cast<const float2*>(x_s + (rt + rt_n * t) * ch + 2 * r);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          part[t][j] = fmaf(xv.x, lo[j], part[t][j]);
          part[t][j] = fmaf(xv.y, hi[j], part[t][j]);
        }
      }
    }
    if (gi >= 0) flush(gi);
    __syncthreads();
  }

  if (ks_n == 1) {
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int m = rt + rt_n * t;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tn * kTN + j;
        if (m < M && n < N) y[(size_t)m * N + n] = csm::from_float<T>(acc[t][j]);
      }
    }
    return;
  }
  float* red = reinterpret_cast<float*>(smem);  // (ks_n, m_pad, kBN)
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[((size_t)ks * m_pad + rt + rt_n * t) * kBN + tn * kTN + j] = acc[t][j];
  __syncthreads();
  for (int i = tid; i < m_pad * kBN; i += kThreads) {
    const int m = i / kBN, n = n0 + i % kBN;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
    for (int s = 0; s < ks_n; ++s) sum += red[(size_t)s * m_pad * kBN + i];
    y[(size_t)m * N + n] = csm::from_float<T>(sum);
  }
}

template <typename T, int TM>
cudaError_t launch(const void* x, const void* w4p, const void* s4, void* y, Shape sh,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<TM>(sh);
  auto kernel = int4_matmul_kernel<T, TM>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec_ok = sh.N % 16 == 0 && reinterpret_cast<uintptr_t>(w4p) % 16 == 0;
  kernel<<<(sh.N + kBN - 1) / kBN, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w4p),
      static_cast<const __nv_bfloat16*>(s4), static_cast<T*>(y), sh, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const void* w4p, const void* s4, void* y, Shape sh,
                          cudaStream_t stream) {
  if (sh.M <= kLanesOfRest) {  // one row per thread; spare threads split K
    sh.rt_n = 1;
    while (sh.rt_n < sh.M) sh.rt_n *= 2;
    return launch<T, 1>(x, w4p, s4, y, sh, stream);
  }
  sh.rt_n = kLanesOfRest;  // 17..64 rows: four per thread
  return launch<T, 4>(x, w4p, s4, y, sh, stream);
}

}  // namespace

// x (M, K) of dtype (0 = float32, 1 = bfloat16), w4p (K/2, N) uint8,
// scale4 (K/gs, N) bf16, y (M, N) of x's dtype; all contiguous.  Takes
// 1 <= M <= 64 and an even group size gs <= 256 dividing K.  Returns the
// launch's cudaError_t.
extern "C" int csm_int4_matmul(const void* x, const void* w4p, const void* scale4, void* y,
                               int M, int K, int N, int gs, int dtype, void* stream) {
  if (M < 1 || M > 64 || N < 1 || gs < 2 || gs % 2 || gs > kMaxChunkRows || K % gs)
    return (int)cudaErrorInvalidValue;
  Shape sh{M, K, N, gs, 0, 0};
  const int G = K / gs;
  sh.gpc = kMaxChunkRows / gs;
  if (sh.gpc > kMaxChunkGroups) sh.gpc = kMaxChunkGroups;
  if (sh.gpc > G) sh.gpc = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16)
    return (int)dispatch_rows<__nv_bfloat16>(x, w4p, scale4, y, sh, s);
  if (dtype == csm::kFloat32) return (int)dispatch_rows<float>(x, w4p, scale4, y, sh, s);
  return (int)cudaErrorInvalidValue;
}
