// Causal GQA flash-attention forward for Hopper (sm_90a), masks from positions.
//
// Replaces the TPU kernel csm_tpu/ops/flash_attention.py:_kernel (launched by
// _flash_fwd, entries flash_gqa_attention / flash_gqa_attention_with_lse):
// out[b,i,h] = softmax_j(q·k_j * scale | kv_pos[b,j] <= q_pos[b,i]) · V and the
// per-row log-sum-exp L = m + log l, with L = 1e30 and a zero row where no key
// is visible.
//
// What bounds it on the H100: at the main path's prefill shapes (S = 256 or
// 512, Hq = 32, Hkv = 8, D = 64), bytes.  Scores and P·V take 4·D flops per
// visible (query, key) pair, about 4·Hq·D·S²/2 in all, against one read of
// Q, K and V and one write of O: about 0.4·S flops per byte, which passes
// the card's bf16 tensor-core rate over its memory rate (~295) only from
// S ≈ 740 up.  That operations bound assumes tensor cores, which this body
// does not use yet: its float32 CUDA-core FMAs reach a small fraction of
// that rate, so in practice the arithmetic limits it at every S.
//
// Design (correctness first): a block owns 64 query rows of one query head
// and loops over 64-key K/V tiles staged in shared memory as float32; each
// of its 128 threads computes a 4x8 block of scores and a 4x(D/8) block of
// the output with CUDA-core FMAs, softmax online in float32.  Key tiles whose
// smallest position exceeds the largest query position of the block are
// skipped (causal chunk skipping, as on the TPU).  Ragged S and T are handled
// by bounds: rows >= S and keys >= T are never loaded or written, where the
// TPU kernel pads with sentinel positions.  A padded prompt row carries
// q_pos = PAD_POS and therefore attends every slot with kv_pos <= PAD_POS,
// exactly as the reference does.  Tensor cores (mma / wgmma) and GQA sharing
// of K/V tiles across the group's query heads are later work.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr int RA = 4;   // score / output rows per thread: ty + 16*a
constexpr int CB = 8;   // score columns per thread: tx + 8*c
constexpr float kLseEmpty = 1e30f;

template <int D>
size_t flash_smem_bytes() {
  const size_t floats = (size_t)BQ * (D + 1)  // Q tile
                        + BK * (D + 1)        // K tile
                        + BK * D              // V tile
                        + BQ * (BK + 1)       // scores / probabilities
                        + 3 * BQ;             // m, l, rescale factor
  return floats * sizeof(float) + (BQ + BK) * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,         // (B, S, Hq, D)
                 const T* __restrict__ k,         // (B, T, Hkv, D)
                 const T* __restrict__ v,         // (B, T, Hkv, D)
                 const int* __restrict__ q_pos,   // (B, S)
                 const int* __restrict__ kv_pos,  // (B|1, T)
                 T* __restrict__ out,             // (B, S, Hq, D)
                 float* __restrict__ lse,         // (B, Hq, S)
                 int S, int T_len, int Hq, int Hkv, long long kv_bstride, float scale) {
  constexpr int QS = D + 1, KS = D + 1, PS = BK + 1, DC = D / 8, VN = csm::Vec<T>::n;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + BQ * QS;
  float* v_s = k_s + BK * KS;
  float* p_s = v_s + BK * D;
  float* m_s = p_s + BQ * PS;
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(corr_s + BQ);
  int* kpos_s = qpos_s + BQ;

  for (int i = tid; i < BQ * (D / VN); i += kThreads) {
    const int r = i / (D / VN), c = (i % (D / VN)) * VN;
    float x[VN];
    if (q0 + r < S) {
      csm::load_vec<T>(q + (((size_t)b * S + q0 + r) * Hq + h) * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) q_s[r * QS + c + e] = x[e];
  }
  for (int r = tid; r < BQ; r += kThreads) {
    qpos_s[r] = q0 + r < S ? q_pos[(size_t)b * S + q0 + r] : INT_MIN;
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();
  int qmax = INT_MIN;
  for (int r = 0; r < BQ; ++r) qmax = max(qmax, qpos_s[r]);

  float acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  const int* kp = kv_pos + (size_t)b * kv_bstride;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    const int n = min(BK, T_len - k0);
    // causal chunk skipping: is any key of this tile visible to any row?
    int visible = 0;
    if (tid < n) {
      const int p = kp[k0 + tid];
      kpos_s[tid] = p;
      visible = p <= qmax;
    }
    if (!__syncthreads_or(visible)) continue;

    for (int i = tid; i < n * (D / VN); i += kThreads) {
      const int j = i / (D / VN), c = (i % (D / VN)) * VN;
      const size_t off = (((size_t)b * T_len + k0 + j) * Hkv + kvh) * D + c;
      float kv[VN], vv[VN];
      csm::load_vec<T>(k + off, kv);
      csm::load_vec<T>(v + off, vv);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[j * KS + c + e] = kv[e];
        v_s[j * D + c + e] = vv[e];
      }
    }
    __syncthreads();

    float s[RA][CB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c) s[a][c] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qa[RA], kc[CB];
#pragma unroll
      for (int a = 0; a < RA; ++a) qa[a] = q_s[(ty + 16 * a) * QS + d];
#pragma unroll
      for (int c = 0; c < CB; ++c) kc[c] = k_s[(tx + 8 * c) * KS + d];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CB; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int j = tx + 8 * c;
        const bool ok = j < n && q0 + r < S && kpos_s[j] <= qpos_s[r];
        p_s[r * PS + j] = ok ? s[a][c] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one thread per row
    if (tid < BQ) {
      const int r = tid;
      float mx = -INFINITY;
      for (int j = 0; j < BK; ++j) mx = fmaxf(mx, p_s[r * PS + j]);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < BK; ++j) {
        const float x = p_s[r * PS + j];
        const float p = x == -INFINITY ? 0.f : expf(x - m_new);
        p_s[r * PS + j] = p;
        sum += p;
      }
      // m_new == -inf: nothing visible yet, acc and l are still 0
      const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
      corr_s[r] = corr;
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
    }
    __syncthreads();

#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const float corr = corr_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= corr;
    }
    for (int j = 0; j < n; ++j) {
      float pv[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) pv[a] = p_s[(ty + 16 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vj = v_s[j * D + tx + 8 * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(pv[a], vj, acc[a][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    if (q0 + r >= S) continue;
    const float l = l_s[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* orow = out + (((size_t)b * S + q0 + r) * Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 8 * c] = csm::from_float<T>(acc[a][c] * inv);
  }
  for (int r = tid; r < BQ; r += kThreads) {
    if (q0 + r >= S) continue;
    const float l = l_s[r];
    lse[((size_t)b * Hq + h) * S + q0 + r] = l > 0.f ? m_s[r] + logf(l) : kLseEmpty;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, void* out, void* lse, int B, int S, int T_len, int Hq,
                   int Hkv, long long kv_bstride, float scale, cudaStream_t stream) {
  const size_t smem = flash_smem_bytes<D>();
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), static_cast<T*>(out),
      static_cast<float*>(lse), S, T_len, Hq, Hkv, kv_bstride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, const void* q_pos,
                         const void* kv_pos, void* out, void* lse, int B, int S, int T_len,
                         int Hq, int Hkv, long long kv_bstride, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 32: return launch<T, 32>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 64: return launch<T, 64>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 128: return launch<T, 128>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, Hq, D), k/v (B, T, Hkv, D) of one dtype (0 = float32,
// 1 = bfloat16); q_pos int32 (B, S); kv_pos int32 (B|1, T) with batch stride
// kv_bstride (0 broadcasts one row); out (B, S, Hq, D) in q's dtype; lse
// float32 (B, Hq, S).  All contiguous and 16-byte aligned.  Returns the
// launch's cudaError_t.
extern "C" int csm_flash_attention_fwd(const void* q, const void* k, const void* v,
                                       const void* q_pos, const void* kv_pos, void* out,
                                       void* lse, int B, int S, int T_len, int Hq, int Hkv,
                                       int D, long long kv_bstride, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16)
    return (int)dispatch_dim<__nv_bfloat16>(D, q, k, v, q_pos, kv_pos, out, lse, B, S, T_len,
                                            Hq, Hkv, kv_bstride, scale, s);
  if (dtype == csm::kFloat32)
    return (int)dispatch_dim<float>(D, q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv,
                                    kv_bstride, scale, s);
  return (int)cudaErrorInvalidValue;
}
