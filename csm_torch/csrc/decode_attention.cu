// Single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel csm_tpu/ops/decode_attention.py:_kernel (launched
// by _decode_attention_kernel, entry decode_gqa_attention): one query per
// row, softmax over a (B, T, Hkv, D) KV cache under a bool mask.
//
// What bounds it on the H100: bytes.  Each step reads the whole K and V
// cache once (2*B*T*Hkv*D elements) and does 4 flops per element read, far
// below the ~295 flop/byte the card needs before its arithmetic is the limit.
//
// Design: one block per (kv head, batch row) serves the G = Hq/Hkv query heads
// that share that kv head, so each cached K/V row is read from device memory
// exactly once.  T is streamed in tiles through shared memory with 16-byte
// loads that stop at T (nothing past the end of the cache is read — the TPU
// kernel reads a garbage tail and relies on p = 0).  The softmax is online
// in float32; a row whose mask is all False keeps l = 0 and writes zeros.
// The TPU kernel's block-diagonal query and tiled-identity projection exist
// only to feed the TPU's matrix unit and are not carried over.
// Known limit: at B=1 the backbone launches Hkv = 8 blocks on 132 SMs, so a
// long cache streams through 8 SMs; split-K (flash-decoding) fixes that.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D> struct DecodeTile {
  static constexpr int TT = 4096 / D;  // keys per tile: 64 at D=64, 32 at D=128 (16 KB of K)
  static constexpr int KS = D + 1;     // padded K row (floats): conflict-free column reads
};

template <int D>
size_t decode_smem_bytes(int G) {
  using Tile = DecodeTile<D>;
  const size_t floats = (size_t)G * D        // q
                        + Tile::TT * Tile::KS  // K tile
                        + Tile::TT * D         // V tile
                        + (size_t)G * Tile::TT // scores / probabilities
                        + (size_t)G * D        // output accumulator
                        + 3 * (size_t)G;       // m, l, rescale factor
  return floats * sizeof(float) + Tile::TT;    // + key validity flags
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,        // (B, Hq, D)
                        const T* __restrict__ k,        // (B, T, Hkv, D)
                        const T* __restrict__ v,        // (B, T, Hkv, D)
                        const bool* __restrict__ mask,  // (B|1, T)
                        T* __restrict__ out,            // (B, Hq, D)
                        int T_len, int Hq, int Hkv, long long mask_bstride, float scale) {
  using Tile = DecodeTile<D>;
  constexpr int TT = Tile::TT, KS = Tile::KS, VN = csm::Vec<T>::n;
  const int G = Hq / Hkv;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + G * D;
  float* v_s = k_s + TT * KS;
  float* p_s = v_s + TT * D;
  float* acc_s = p_s + G * TT;
  float* m_s = acc_s + G * D;
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  bool* valid_s = reinterpret_cast<bool*>(corr_s + G);

  // queries pre-scaled by 1/sqrt(D) and rounded to the input type, as the
  // reference does before its dot
  const T* qb = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = csm::to_float(csm::from_float<T>(csm::to_float(qb[i]) * scale));
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  const bool* mb = mask + (size_t)b * mask_bstride;

  for (int t0 = 0; t0 < T_len; t0 += TT) {
    const int n = min(TT, T_len - t0);
    // bounded tile load: rows t < n only
    for (int i = tid; i < n * (D / VN); i += kThreads) {
      const int t = i / (D / VN), c = (i % (D / VN)) * VN;
      const size_t off = (((size_t)b * T_len + t0 + t) * Hkv + h) * D + c;
      float kv[VN], vv[VN];
      csm::load_vec<T>(k + off, kv);
      csm::load_vec<T>(v + off, vv);
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[t * KS + c + e] = kv[e];
        v_s[t * D + c + e] = vv[e];
      }
    }
    for (int t = tid; t < TT; t += kThreads) valid_s[t] = t < n && mb[t0 + t];
    __syncthreads();

    for (int i = tid; i < G * TT; i += kThreads) {
      const int g = i / TT, t = i % TT;
      float s = -INFINITY;
      if (valid_s[t]) {
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a = fmaf(q_s[g * D + d], k_s[t * KS + d], a);
        s = a;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < TT; t += 32) mx = fmaxf(mx, p_s[g * TT + t]);
      mx = csm::warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < TT; t += 32) {
        const float s = p_s[g * TT + t];
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        p_s[g * TT + t] = p;
        sum += p;
      }
      sum = csm::warp_sum(sum);
      if (lane == 0) {
        // m_new == -inf: nothing visible yet, acc and l are still 0
        const float corr = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        corr_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = acc_s[i] * corr_s[g];
      for (int t = 0; t < n; ++t) a = fmaf(p_s[g * TT + t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  T* ob = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = l_s[i / D];
    ob[i] = csm::from_float<T>(l > 0.f ? acc_s[i] / l : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* mask, void* out,
                   int B, int T_len, int Hq, int Hkv, long long mask_bstride, float scale,
                   cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<D>(Hq / Hkv);
  auto kernel = decode_attention_kernel<T, D>;
  cudaError_t err = csm::ensure_smem<decode_attention_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const bool*>(mask), static_cast<T*>(out), T_len, Hq, Hkv, mask_bstride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, const void* mask,
                         void* out, int B, int T_len, int Hq, int Hkv, long long mask_bstride,
                         float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, stream);
    case 32: return launch<T, 32>(q, k, v, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, stream);
    case 64: return launch<T, 64>(q, k, v, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, stream);
    case 128: return launch<T, 128>(q, k, v, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, Hq, D), k/v (B, T, Hkv, D), mask bool (B|1, 1, T) with batch
// stride mask_bstride (0 broadcasts one row), out (B, 1, Hq, D); all
// contiguous, 16-byte aligned, of one dtype (0 = float32, 1 = bfloat16).
// Returns the launch's cudaError_t.
extern "C" int csm_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int T_len, int Hq,
                                    int Hkv, int D, long long mask_bstride, float scale,
                                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16)
    return (int)dispatch_dim<__nv_bfloat16>(D, q, k, v, mask, out, B, T_len, Hq, Hkv,
                                            mask_bstride, scale, s);
  if (dtype == csm::kFloat32)
    return (int)dispatch_dim<float>(D, q, k, v, mask, out, B, T_len, Hq, Hkv, mask_bstride,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}
