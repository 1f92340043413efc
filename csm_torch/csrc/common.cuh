// Shared helpers for the port's kernels: float conversion, 16-byte vector
// loads of bf16 / f32 rows into float registers, warp reductions, the
// once-per-size shared-memory attribute, the SM count, and the launch of a
// grid in thread-block clusters (the split-K / split-T kernels).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <utility>

namespace csm {

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// Load Vec<T>::n consecutive elements (16-byte aligned) as floats.
template <typename T> __device__ __forceinline__ void load_vec(const T* src, float* dst);
template <> __device__ __forceinline__ void load_vec<float>(const float* src, float* dst) {
  const float4 r = *reinterpret_cast<const float4*>(src);
  dst[0] = r.x; dst[1] = r.y; dst[2] = r.z; dst[3] = r.w;
}
template <> __device__ __forceinline__ void load_vec<__nv_bfloat16>(const __nv_bfloat16* src,
                                                                    float* dst) {
  const uint4 r = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// Allow `Kernel` `bytes` of dynamic shared memory on the current device.
// cudaFuncSetAttribute is a host call of its own, so it runs only when a
// launch needs more than the largest size set so far on that device, not
// on every launch.
template <auto Kernel>
cudaError_t ensure_smem(size_t bytes) {
  static size_t set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes <= set[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) set[dev] = bytes;
  return err;
}

// Streaming multiprocessors of the current device, read once (132 on the
// H100 SXM if the query fails).
inline int sm_count() {
  static int n[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (!n[dev] && cudaDeviceGetAttribute(&n[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    n[dev] = 132;
  return n[dev];
}

// Let `Kernel` launch in clusters of more than 8 blocks (the non-portable
// sizes, up to 16 on the H100), once per device.
template <auto Kernel>
cudaError_t allow_large_clusters(int max_cluster) {
  static bool done[64] = {};
  if (max_cluster <= 8) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) done[dev] = true;
  return err;
}

// Launch `kernel` on `grid` in clusters of `cluster_x` blocks along x, then
// return the launch's error.  A cluster of one block launches as a plain
// grid (each block its own implicit cluster): on the H100 the cluster
// attribute alone made decode attention at the decoder's shape, one block
// a cluster, measurably slower.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), dim3 grid, int threads, size_t smem,
                           cudaStream_t stream, int cluster_x, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster_x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster_x > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace csm
