// Shared helpers for the port's attention kernels: float conversion and
// 16-byte vector loads of bf16 / f32 rows into float registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace csm
