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
// Design.  A block owns a span of 512 bytes of every row (256 bf16 or 128
// float32 columns): lane l of each warp streams the 16 bytes at offset 16·l,
// so one warp-wide copy covers 512 contiguous bytes of one row.  K is split
// across the blocks of a thread-block cluster (up to 16, the non-portable
// sizes above 8): rank r takes whole stages of 32 rows, r·S/cs to
// (r+1)·S/cs of the S stages, so every rank has rows.  The launch plan
// (span, cluster size, stage rows) comes from the caller
// (ops/matvec.py:matvec_plan, sized so that spans × cluster fills the SMs
// about once) and is refused here if this kernel cannot run it.  Each
// thread keeps its own ring of 4 stages of cp.async copies (3 in flight, 4
// rows of 16 bytes a stage: 48 KB in flight a block) and reads back only
// the bytes it copied, so the ring needs no barrier.  The block stages its
// chunk of x in shared memory after it has issued the first weight stages,
// behind the one barrier of the loop.  Each lane accumulates its columns in
// float32 over its warp's rows; the 8 warps' sums meet in shared memory,
// and the cluster's blocks sum each other's through distributed shared
// memory in rank order (every rank's sum read at once, so the remote reads
// overlap): one launch, no atomics, no scratch, a deterministic result.
// Tried on the H100 and not kept: spans of 1 or 2 KB of a row, 8-stage
// rings and 512 threads were each as fast or slower at every probe shape.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSpanBytes = 512;  // a span row: 16 bytes a lane
constexpr int kStageRows = 32;   // rows a stage (16 KB)
constexpr int kRowsPerWarp = kStageRows / kWarps;
constexpr int kStages = 4;
constexpr int kMaxCluster = 16;

// Shared memory: the ring (kStages x kStageRows x 512 bytes), the x chunk
// (rows a block takes at most, in T, padded to 16 bytes), the warps' sums
// (kWarps x span floats) and the block's sums (span floats).
template <typename T>
size_t smem_bytes(int max_rows) {
  constexpr int NB = kSpanBytes / sizeof(T);
  const size_t x_bytes = ((size_t)max_rows * sizeof(T) + 15) / 16 * 16;
  return (size_t)kStages * kStageRows * kSpanBytes + x_bytes + (size_t)(kWarps + 1) * NB * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x,  // (1, K)
              const T* __restrict__ w,  // (K, N)
              T* __restrict__ y,        // (1, N)
              int K, int N, int max_rows) {
  constexpr int VN = csm::Vec<T>::n;  // columns a lane
  constexpr int NB = 32 * VN;         // span columns
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nst = (K + kStageRows - 1) / kStageRows;
  const int s0 = rank * nst / cs, ns = (rank + 1) * nst / cs - s0;
  const int k0 = s0 * kStageRows, k1 = min(K, (s0 + ns) * kStageRows);
  const int col = blockIdx.y * NB + lane * VN;
  const bool live_col = col < N;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  T* xs = reinterpret_cast<T*>(ring + kStages * kStageRows * kSpanBytes);
  float* part = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(xs) + ((size_t)max_rows * sizeof(T) + 15) / 16 * 16);
  float* red = part + kWarps * NB;

  // stage st's rows warp, warp + 8, ... : this lane's 16 bytes of each
  auto load = [&](int st, int slot) {
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int row = warp + kWarps * j, k = st * kStageRows + row;
      const bool ok = live_col && k < K;
      csm::tc::cp_async16(ring + ((size_t)slot * kStageRows + row) * kSpanBytes + 16 * lane,
                          ok ? w + (size_t)k * N + col : w, ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) load(s0 + i, i);
    csm::tc::cp_async_commit();
  }
  for (int i = tid; i < k1 - k0; i += kThreads) xs[i] = x[k0 + i];
  __syncthreads();  // x's chunk is staged

  float acc[VN];
#pragma unroll
  for (int e = 0; e < VN; ++e) acc[e] = 0.f;
  for (int it = 0; it < ns; ++it) {
    csm::tc::cp_async_wait<kStages - 2>();  // this thread's copies of stage it have landed
    if (it + kStages - 1 < ns) load(s0 + it + kStages - 1, (it + kStages - 1) % kStages);
    csm::tc::cp_async_commit();
    const int slot = it % kStages, kb = (s0 + it) * kStageRows;
#pragma unroll
    for (int j = 0; j < kRowsPerWarp; ++j) {
      const int row = warp + kWarps * j;
      if (kb + row < K) {
        float wv[VN];
        csm::load_vec<T>(reinterpret_cast<const T*>(
                             ring + ((size_t)slot * kStageRows + row) * kSpanBytes + 16 * lane),
                         wv);
        const float xv = csm::to_float<T>(xs[kb + row - k0]);
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[e] = fmaf(xv, wv[e], acc[e]);
      }
    }
  }
  csm::tc::cp_async_wait<0>();

  // fixed-order reduction: the warps' sums in this block, then the
  // cluster's blocks in rank order through distributed shared memory, each
  // block writing its share of the span's columns
#pragma unroll
  for (int e = 0; e < VN; ++e) part[warp * NB + lane * VN + e] = acc[e];
  __syncthreads();
  for (int c = tid; c < NB; c += kThreads) {
    float s = part[c];
#pragma unroll
    for (int i = 1; i < kWarps; ++i) s += part[i * NB + c];
    red[c] = s;
  }
  cluster.sync();
  const int per = (NB + cs - 1) / cs;
  for (int c = rank * per + tid; c < min(NB, (rank + 1) * per); c += kThreads) {
    float v[kMaxCluster];  // every rank's sum read at once, added in rank order
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) v[q] = q < cs ? cluster.map_shared_rank(red, q)[c] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) s += v[q];
    const int n = blockIdx.y * NB + c;
    if (n < N) y[n] = csm::from_float<T>(s);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int K, int N, int span, int cluster,
                   int stage_rows, cudaStream_t stream) {
  const int nst = (K + kStageRows - 1) / kStageRows;
  if (span != kSpanBytes / (int)sizeof(T) || stage_rows != kStageRows || cluster < 1 ||
      cluster > kMaxCluster || cluster > nst)
    return cudaErrorInvalidValue;
  const int max_rows = (nst + cluster - 1) / cluster * kStageRows;
  const size_t smem = smem_bytes<T>(max_rows);
  cudaError_t err = csm::allow_large_clusters<matvec_kernel<T>>(kMaxCluster);
  if (err != cudaSuccess) return err;
  err = csm::ensure_smem<matvec_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  return csm::launch_cluster(matvec_kernel<T>, dim3(cluster, (N + span - 1) / span, 1), kThreads,
                             smem, stream, cluster, static_cast<const T*>(x),
                             static_cast<const T*>(w), static_cast<T*>(y), K, N, max_rows);
}

}  // namespace

// x (1, K) and w (K, N) row-major of one dtype (0 = float32, 1 = bfloat16),
// contiguous, 16-byte aligned, N a multiple of 8; y (1, N) in that dtype.
// The plan (span columns, cluster size, stage rows) is ops/matvec.py's
// matvec_plan; a plan this kernel cannot run is refused.  Returns the
// launch's cudaError_t.
extern "C" int csm_matvec(const void* x, const void* w, void* y, int K, int N, int span,
                          int cluster, int stage_rows, int dtype, void* stream) {
  if (K < 1 || N < 1 || N % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16)
    return (int)launch<__nv_bfloat16>(x, w, y, K, N, span, cluster, stage_rows, s);
  if (dtype == csm::kFloat32)
    return (int)launch<float>(x, w, y, K, N, span, cluster, stage_rows, s);
  return (int)cudaErrorInvalidValue;
}
