// M=1 matvec for Hopper (sm_90a): y = x @ w for x (1, K), w (K, N) row-major.
//
// Replaces the TPU kernel scripts/bench_matvec_pallas.py:_matvec_kernel
// (launched by matvec_pallas): one output row, float32 accumulation, y in
// x's dtype (float32 or bf16).  Its caller is the weight-streaming probe
// (csm_torch/scripts/bench_matvec.py), which runs the CSM-1B backbone's four
// decode projections per layer (wqkv 2048x3072, wo 2048x2048, w13
// 2048x16384, w2 8192x2048) through it.
//
// What bounds it on the H100: bytes.  Every weight is used once, for two
// flops, far below the ~295 operations per byte the card needs before
// arithmetic is the limit.  The least traffic is 2*K*N + 2*K + 2*N bytes in
// bf16: 67.1 MB for w13, 20 us at 3.35 TB/s; 1.95 GB for the 16 layers'
// four projections, 0.58 ms.
//
// Design.  Blocks own narrow column slabs so that even N = 2048 (wo, w2)
// gives at least two blocks per SM: a slab is 32, 16 or 8 bf16 columns
// (16, 8 or 4 float32), the widest that still gives 2 x (number of SMs)
// blocks.  Each of the block's 512 threads owns one 16-byte vector of the
// slab's row (neighbouring threads on neighbouring columns, so a row's
// slab is one coalesced segment) and a stride of input rows: K is split
// across the threads and warps of the block.  x is staged once per block
// in shared memory (16 KB at K = 8192 in bf16).  Each thread keeps four
// 16-byte weight loads in flight and accumulates in float32; partial sums
// are reduced with warp shuffles, then across the 16 warps in shared memory
// in a fixed order, with no atomics, so the result is deterministic.
// Simple first: no cp.async/TMA pipeline and no split of K across blocks.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte weight loads in flight per thread

// LPR: threads across a slab's row; a slab is LPR 16-byte vectors wide.
template <typename T, int LPR>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x,  // (1, K)
              const T* __restrict__ w,  // (K, N)
              T* __restrict__ y,        // (1, N)
              int K, int N) {
  constexpr int VN = csm::Vec<T>::n;  // elements in 16 bytes
  constexpr int NB = LPR * VN;        // slab width
  constexpr int RPP = kThreads / LPR; // input rows per pass of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* part = reinterpret_cast<float*>(smem_raw);                  // (kWarps, NB)
  T* xs = reinterpret_cast<T*>(smem_raw + kWarps * NB * sizeof(float));  // (K,)

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int k = tid; k < K; k += kThreads) xs[k] = x[k];
  __syncthreads();

  const int lc = tid % LPR, kr = tid / LPR;
  const int n = blockIdx.x * NB + lc * VN;
  float acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  if (n < N) {
    const T* wp = w + n;
    int k = kr;
    for (; k + (kUnroll - 1) * RPP < K; k += kUnroll * RPP) {
      float wv[kUnroll][VN];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) csm::load_vec<T>(wp + (size_t)(k + u * RPP) * N, wv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float xv = csm::to_float<T>(xs[k + u * RPP]);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[e] = fmaf(xv, wv[u][e], acc[e]);
      }
    }
    for (; k < K; k += RPP) {
      float wv[VN];
      csm::load_vec<T>(wp + (size_t)k * N, wv);
      const float xv = csm::to_float<T>(xs[k]);
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[e] = fmaf(xv, wv[e], acc[e]);
    }
  }
  // lanes lc, lc + LPR, ... hold the same columns: sum them
#pragma unroll
  for (int o = 16; o >= LPR; o >>= 1)
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (lane < LPR)
#pragma unroll
    for (int e = 0; e < VN; ++e) part[warp * NB + lane * VN + e] = acc[e];
  __syncthreads();
  if (tid < NB) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += part[i * NB + tid];
    const int col = blockIdx.x * NB + tid;
    if (col < N) y[col] = csm::from_float<T>(s);
  }
}

template <typename T, int LPR>
cudaError_t launch(const void* x, const void* w, void* y, int K, int N, cudaStream_t stream) {
  constexpr int NB = LPR * csm::Vec<T>::n;
  const size_t smem = kWarps * NB * sizeof(float) + (size_t)K * sizeof(T);
  auto kernel = matvec_kernel<T, LPR>;
  const cudaError_t err = csm::ensure_smem<matvec_kernel<T, LPR>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<(N + NB - 1) / NB, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y), K, N);
  return cudaGetLastError();
}

// The widest slab (LPR 4, 2 or 1 vectors) that gives two blocks per SM.
template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* y, int K, int N, cudaStream_t s) {
  constexpr int VN = csm::Vec<T>::n;
  const long long want = 2LL * csm::sm_count();
  if ((N + 4 * VN - 1) / (4 * VN) >= want) return launch<T, 4>(x, w, y, K, N, s);
  if ((N + 2 * VN - 1) / (2 * VN) >= want) return launch<T, 2>(x, w, y, K, N, s);
  return launch<T, 1>(x, w, y, K, N, s);
}

}  // namespace

// x (1, K) and w (K, N) row-major of one dtype (0 = float32, 1 = bfloat16),
// contiguous, 16-byte aligned, N a multiple of 8; y (1, N) in that dtype.
// Returns the launch's cudaError_t.
extern "C" int csm_matvec(const void* x, const void* w, void* y, int K, int N, int dtype,
                          void* stream) {
  if (K < 1 || N < 1 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16) return (int)dispatch<__nv_bfloat16>(x, w, y, K, N, s);
  if (dtype == csm::kFloat32) return (int)dispatch<float>(x, w, y, K, N, s);
  return (int)cudaErrorInvalidValue;
}
