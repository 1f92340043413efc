// Tensor-core building blocks shared by the port's bf16 kernels (the flash
// forward, the flash backward and the int4 matmul): mma.sync m16n8k16 with
// bf16 operands and float32 accumulators, ldmatrix fragment loads from
// XOR-swizzled bf16 tiles in shared memory, cp.async copies into them, the
// SFU's exp2, and the warp reductions and row arithmetic of "stacked" GQA
// rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace csm {
namespace tc {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the SFU's ex2.approx (flushing denormal results to 0).  p is rounded
// to bf16 before every product that takes it, far coarser than ex2's ~2 ulp;
// exp2f's extra handling of denormal results costs time and, at the training
// shapes on the H100, changed no gradient bit.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Element offset of 16-byte chunk c of row r in a tile of D bf16 a row.  The
// chunk index is XOR-swizzled with the row so that the 8 rows an ldmatrix
// (or a transposing ldmatrix) reads at one chunk column land in 8 different
// bank groups: no bank conflicts for any D in {16, 32, 64, 128}.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  if constexpr (CPR >= 8) {
    return (r * CPR + (c ^ (r & 7))) * 8;
  } else {
    return (r * CPR + (c ^ ((r / (8 / CPR)) & (CPR - 1)))) * 8;
  }
}

// cp.async of 16 (or 4) bytes; an invalid source reads nothing and fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a·b for a 16x16 A fragment and a 16x8 B fragment (b0, b1).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Fragment addresses in a swizzled tile of D-wide rows, for this lane:
//  a_at: A operand, rows m0.. (16), k-chunk kc (16 columns from 8*kc);
//  b_at: B operand stored [n][k] (x4: n-tiles n0.. and n0+8..), k-chunk kc;
//  bt_at: B operand stored [k][n] (transposing x4: rows k0..k0+15, n-chunk nc, nc+1).
template <int D>
__device__ __forceinline__ const bf16* a_at(const bf16* t, int m0, int kc, int lane) {
  return t + swz<D>(m0 + (lane & 15), kc + (lane >> 4));
}
template <int D>
__device__ __forceinline__ const bf16* b_at(const bf16* t, int n0, int kc, int lane) {
  return t + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3), kc + ((lane >> 3) & 1));
}
template <int D>
__device__ __forceinline__ const bf16* bt_at(const bf16* t, int k0, int nc, int lane) {
  return t + swz<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3), nc + (lane >> 4));
}

// The first set bit >= t of a bitmap of nwords words, or -1.
__device__ __forceinline__ int next_tile(const unsigned* vis, int nwords, int t) {
  for (int w = t >> 5; w < nwords; ++w) {
    unsigned bits = vis[w];
    if (w == (t >> 5)) bits &= ~0u << (t & 31);
    if (bits) return (w << 5) + __ffs(bits) - 1;
  }
  return -1;
}

__device__ __forceinline__ int warp_max_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ int warp_min_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Offset of stacked row f = i·G + g (position i, head kvh·G + g) in a
// (B, S, Hq, D) tensor: a group's heads are adjacent at each position.
__device__ __forceinline__ size_t row_off(int b, int f, int S, int Hq, int G, int kvh, int D) {
  return (((size_t)b * S + f / G) * Hq + kvh * G + f % G) * D;
}

}  // namespace tc
}  // namespace csm
