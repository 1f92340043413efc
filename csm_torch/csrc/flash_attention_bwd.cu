// Causal GQA flash-attention backward for Hopper (sm_90a), masks from positions.
//
// Replaces the two TPU kernels of csm_tpu/ops/flash_attention.py launched by
// _flash_bwd_pallas (the custom_vjp backward of flash_gqa_attention and
// flash_gqa_attention_with_lse):
//   _dq_kernel   dq[i]  = scale · Σ_j ds_ij k_j
//   _dkv_kernel  dv[j]  = Σ_{h in group, i} p_ij dO_i
//                dk[j]  = scale · Σ_{h in group, i} ds_ij q_i
// with p_ij = exp(scale·q_i·k_j − L_i) where kv_pos[b,j] <= q_pos[b,i] (else 0),
// ds_ij = p_ij (dO_i·v_j − Dr_i), L the forward's per-row log-sum-exp (1e30
// for a row with no visible key, so p = 0 there) and Dr_i = Σ_d dO_i·O_i
// (minus the LSE cotangent when there is one), computed by the caller.
//
// What bounds it on the H100.  Bytes: one read of Q, K, V, dO, L and Dr and
// one write of dQ, dK and dV.  Operations: five products per visible
// (query head, key) pair (the S recompute, dP, dV, dQ and dK), 2·D flops
// each.  At the training shape (B=2, S=T=512, Hq=32, Hkv=8, D=64, bf16)
// that is ~17 MB (5 µs at 3.35 TB/s) against ~5.4 GFLOP (5.4 µs at the bf16
// tensor-core rate): balanced; at S=T=2048 ~86 GFLOP (87 µs), bound by
// operations.  That bound assumes tensor cores, which this body does not
// use: its float32 CUDA-core FMAs reach a small fraction of that rate, so
// in practice the arithmetic limits both kernels at every S.
//
// Design (correctness first).  Both kernels stage 64-row tiles in shared
// memory as float32 (at D = 128 the dk/dv kernel's K, V, Q, dO, P and dS
// tiles take ~166 KB of the 227 KB a block may use) and use 256 threads, each
// holding a 2x8 block of a 64x64 score tile and a 2x(D/8) block of its
// accumulators, so no variant needs more than ~128 registers.
//  * dq: one block per (b, query head, 64 query rows).  It loops over 64-key
//    tiles, recomputes s, p, dP = dO·Vᵀ and dS = p(dP − Dr), stages dS and
//    accumulates dq += dS·K in float32; dq is written once, in q's dtype.
//    A key tile whose smallest position exceeds the block's largest query
//    position is skipped (the causal skip of the forward).
//  * dk/dv: one block per (b, kv head, 64 keys).  It loops over the group's
//    Hq/Hkv query heads and their 64-row query tiles, skipping a query tile
//    whose largest position is below the key tile's smallest, and
//    accumulates dv += Pᵀ·dO and dk += dSᵀ·Q in float32.  The GQA sum stays
//    inside the block, as on the TPU: no atomics, so the result is
//    deterministic.  dk/dv are written once, in k's dtype.
// Ragged S and T are handled by bounds: rows >= S and keys >= T are never
// loaded (their tiles read as zeros, their p as 0) or written, where the TPU
// kernels pad with sentinel positions.  Tensor cores (mma.sync / wgmma) and
// K/V tiles shared across a group's query heads in the dq kernel are later
// work.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;  // query rows per tile
constexpr int BK = 64;  // keys per tile
constexpr int RA = 2;   // tile rows per thread: ty + 32*a
constexpr int CB = 8;   // tile columns per thread: tx + 8*c
constexpr float kLseEmpty = 1e30f;

// Stage 64 rows of D elements (row r at base + r*row_stride) into dst with
// leading dimension ld, as float32; rows >= n read as zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* base, size_t row_stride,
                                           int n, int tid) {
  constexpr int VN = csm::Vec<T>::n, CV = D / VN;
  for (int i = tid; i < 64 * CV; i += kThreads) {
    const int r = i / CV, c = (i % CV) * VN;
    float x[VN];
    if (r < n) {
      csm::load_vec<T>(base + r * row_stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * ld + c + e] = x[e];
  }
}

template <int D>
size_t dq_smem_bytes() {
  const size_t floats = (size_t)2 * BQ * (D + 1)  // Q, dO
                        + 2 * BK * (D + 1)        // K, V
                        + BQ * (BK + 1)           // dS
                        + 2 * BQ;                 // L, Dr
  return floats * sizeof(float) + (BQ + BK) * sizeof(int);
}

template <int D>
size_t dkv_smem_bytes() {
  const size_t floats = (size_t)2 * BK * (D + 1)  // K, V
                        + 2 * BQ * (D + 1)        // Q, dO
                        + 2 * BK * (BQ + 1)       // P, dS (key-major)
                        + 2 * BQ;                 // L, Dr
  return floats * sizeof(float) + (BQ + BK) * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q,         // (B, S, Hq, D)
                    const T* __restrict__ k,         // (B, T, Hkv, D)
                    const T* __restrict__ v,         // (B, T, Hkv, D)
                    const int* __restrict__ q_pos,   // (B, S)
                    const int* __restrict__ kv_pos,  // (B|1, T)
                    const T* __restrict__ dout,      // (B, S, Hq, D)
                    const float* __restrict__ lse,   // (B, Hq, S)
                    const float* __restrict__ delta, // (B, Hq, S)
                    T* __restrict__ dq,              // (B, S, Hq, D)
                    int S, int T_len, int Hq, int Hkv, long long kv_bstride, float scale) {
  constexpr int LD = D + 1, PS = BK + 1, DC = D / 8;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (Hq / Hkv);
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + BQ * LD;
  float* k_s = do_s + BQ * LD;
  float* v_s = k_s + BK * LD;
  float* ds_s = v_s + BK * LD;
  float* l_s = ds_s + BQ * PS;
  float* dr_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(dr_s + BQ);
  int* kpos_s = qpos_s + BQ;

  const int rows = min(BQ, S - q0);
  const size_t qrow = (size_t)Hq * D;
  const size_t qoff = (((size_t)b * S + q0) * Hq + h) * D;
  stage_rows<T, D>(q_s, LD, q + qoff, qrow, rows, tid);
  stage_rows<T, D>(do_s, LD, dout + qoff, qrow, rows, tid);
  for (int r = tid; r < BQ; r += kThreads) {
    const bool ok = r < rows;
    const size_t lr = ((size_t)b * Hq + h) * S + q0 + r;
    qpos_s[r] = ok ? q_pos[(size_t)b * S + q0 + r] : INT_MIN;
    l_s[r] = ok ? lse[lr] : kLseEmpty;
    dr_s[r] = ok ? delta[lr] : 0.f;
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
  const size_t krow = (size_t)Hkv * D;
  for (int k0 = 0; k0 < T_len; k0 += BK) {
    const int n = min(BK, T_len - k0);
    // causal tile skipping: is any key of this tile visible to any row?
    int visible = 0;
    if (tid < BK) {
      const int p = tid < n ? kp[k0 + tid] : INT_MAX;
      kpos_s[tid] = p;
      visible = tid < n && p <= qmax;
    }
    if (!__syncthreads_or(visible)) continue;

    const size_t koff = (((size_t)b * T_len + k0) * Hkv + kvh) * D;
    stage_rows<T, D>(k_s, LD, k + koff, krow, n, tid);
    stage_rows<T, D>(v_s, LD, v + koff, krow, n, tid);
    __syncthreads();

    // s = Q·Kᵀ and dP = dO·Vᵀ for rows ty + 32a, keys tx + 8c
    float s[RA][CB], dp[RA][CB];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < CB; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[RA], oa[RA], kc[CB], vc[CB];
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        qa[a] = q_s[(ty + 32 * a) * LD + d];
        oa[a] = do_s[(ty + 32 * a) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        kc[c] = k_s[(tx + 8 * c) * LD + d];
        vc[c] = v_s[(tx + 8 * c) * LD + d];
      }
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
          dp[a][c] = fmaf(oa[a], vc[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 32 * a;
      const float L = l_s[r], Dr = dr_s[r];
      const int qp = qpos_s[r];
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int j = tx + 8 * c;
        const bool ok = j < n && kpos_s[j] <= qp;
        const float p = ok ? expf(s[a][c] * scale - L) : 0.f;
        ds_s[r * PS + j] = ok ? p * (dp[a][c] - Dr) : 0.f;
      }
    }
    __syncthreads();

    // dq += dS·K
    for (int j = 0; j < n; ++j) {
      float dsa[RA];
#pragma unroll
      for (int a = 0; a < RA; ++a) dsa[a] = ds_s[(ty + 32 * a) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kj = k_s[j * LD + tx + 8 * c];
#pragma unroll
        for (int a = 0; a < RA; ++a) acc[a][c] = fmaf(dsa[a], kj, acc[a][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 32 * a;
    if (r >= rows) continue;
    T* row = dq + qoff + r * qrow;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 8 * c] = csm::from_float<T>(acc[a][c] * scale);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q,         // (B, S, Hq, D)
                     const T* __restrict__ k,         // (B, T, Hkv, D)
                     const T* __restrict__ v,         // (B, T, Hkv, D)
                     const int* __restrict__ q_pos,   // (B, S)
                     const int* __restrict__ kv_pos,  // (B|1, T)
                     const T* __restrict__ dout,      // (B, S, Hq, D)
                     const float* __restrict__ lse,   // (B, Hq, S)
                     const float* __restrict__ delta, // (B, Hq, S)
                     T* __restrict__ dk,              // (B, T, Hkv, D)
                     T* __restrict__ dv,              // (B, T, Hkv, D)
                     int S, int T_len, int Hq, int Hkv, long long kv_bstride, float scale) {
  constexpr int LD = D + 1, PQ = BQ + 1, DC = D / 8;
  const int k0 = blockIdx.x * BK;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, tx = tid % 8, ty = tid / 8;

  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + BK * LD;
  float* q_s = v_s + BK * LD;
  float* do_s = q_s + BQ * LD;
  float* p_s = do_s + BQ * LD;
  float* ds_s = p_s + BK * PQ;
  float* l_s = ds_s + BK * PQ;
  float* dr_s = l_s + BQ;
  int* qpos_s = reinterpret_cast<int*>(dr_s + BQ);
  int* kpos_s = qpos_s + BQ;

  const int n = min(BK, T_len - k0);
  const size_t krow = (size_t)Hkv * D;
  const size_t koff = (((size_t)b * T_len + k0) * Hkv + kvh) * D;
  stage_rows<T, D>(k_s, LD, k + koff, krow, n, tid);
  stage_rows<T, D>(v_s, LD, v + koff, krow, n, tid);
  const int* kp = kv_pos + (size_t)b * kv_bstride;
  for (int j = tid; j < BK; j += kThreads) kpos_s[j] = j < n ? kp[k0 + j] : INT_MAX;
  __syncthreads();
  int kmin = INT_MAX;
  for (int j = 0; j < BK; ++j) kmin = min(kmin, kpos_s[j]);

  float dk_acc[RA][DC], dv_acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const size_t qrow = (size_t)Hq * D;
  for (int g = 0; g < G; ++g) {  // the group's query heads: the GQA sum
    const int h = kvh * G + g;
    for (int q0 = 0; q0 < S; q0 += BQ) {
      const int rows = min(BQ, S - q0);
      // causal tile skipping: does any row of this tile see any key?
      int visible = 0;
      if (tid < BQ) {
        const bool ok = tid < rows;
        const size_t lr = ((size_t)b * Hq + h) * S + q0 + tid;
        const int p = ok ? q_pos[(size_t)b * S + q0 + tid] : INT_MIN;
        qpos_s[tid] = p;
        l_s[tid] = ok ? lse[lr] : kLseEmpty;
        dr_s[tid] = ok ? delta[lr] : 0.f;
        visible = ok && p >= kmin;
      }
      if (!__syncthreads_or(visible)) continue;

      const size_t qoff = (((size_t)b * S + q0) * Hq + h) * D;
      stage_rows<T, D>(q_s, LD, q + qoff, qrow, rows, tid);
      stage_rows<T, D>(do_s, LD, dout + qoff, qrow, rows, tid);
      __syncthreads();

      // key-major tiles: sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for keys ty + 32a, rows tx + 8c
      float s[RA][CB], dp[RA][CB];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < CB; ++c) s[a][c] = dp[a][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[RA], va[RA], qc[CB], oc[CB];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          ka[a] = k_s[(ty + 32 * a) * LD + d];
          va[a] = v_s[(ty + 32 * a) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          qc[c] = q_s[(tx + 8 * c) * LD + d];
          oc[c] = do_s[(tx + 8 * c) * LD + d];
        }
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int c = 0; c < CB; ++c) {
            s[a][c] = fmaf(ka[a], qc[c], s[a][c]);
            dp[a][c] = fmaf(va[a], oc[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int j = ty + 32 * a;
        const int kpj = kpos_s[j];
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const int r = tx + 8 * c;
          const bool ok = j < n && r < rows && kpj <= qpos_s[r];
          const float p = ok ? expf(s[a][c] * scale - l_s[r]) : 0.f;
          p_s[j * PQ + r] = p;
          ds_s[j * PQ + r] = ok ? p * (dp[a][c] - dr_s[r]) : 0.f;
        }
      }
      __syncthreads();

      // dv += Pᵀ·dO and dk += dSᵀ·Q
      for (int r = 0; r < rows; ++r) {
        float pa[RA], dsa[RA];
#pragma unroll
        for (int a = 0; a < RA; ++a) {
          pa[a] = p_s[(ty + 32 * a) * PQ + r];
          dsa[a] = ds_s[(ty + 32 * a) * PQ + r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = do_s[r * LD + tx + 8 * c];
          const float qq = q_s[r * LD + tx + 8 * c];
#pragma unroll
          for (int a = 0; a < RA; ++a) {
            dv_acc[a][c] = fmaf(pa[a], o, dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dsa[a], qq, dk_acc[a][c]);
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int j = ty + 32 * a;
    if (j >= n) continue;
    T* dk_row = dk + koff + j * krow;
    T* dv_row = dv + koff + j * krow;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_row[tx + 8 * c] = csm::from_float<T>(dk_acc[a][c] * scale);
      dv_row[tx + 8 * c] = csm::from_float<T>(dv_acc[a][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *q_pos, *kv_pos, *dout, *lse, *delta;
  void *out0, *out1;  // dq, or dk and dv
  int B, S, T_len, Hq, Hkv;
  long long kv_bstride;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BQ - 1) / BQ, a.Hq, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.S, a.T_len, a.Hq, a.Hkv,
      a.kv_bstride, a.scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_bytes<D>();
  auto kernel = flash_bwd_dkv_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + BK - 1) / BK, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.S, a.T_len, a.Hq, a.Hkv, a.kv_bstride, a.scale);
  return cudaGetLastError();
}

template <typename T, bool DQ>
cudaError_t dispatch_dim(int D, const Args& a) {
  switch (D) {
    case 16: return DQ ? launch_dq<T, 16>(a) : launch_dkv<T, 16>(a);
    case 32: return DQ ? launch_dq<T, 32>(a) : launch_dkv<T, 32>(a);
    case 64: return DQ ? launch_dq<T, 64>(a) : launch_dkv<T, 64>(a);
    case 128: return DQ ? launch_dq<T, 128>(a) : launch_dkv<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool DQ>
int dispatch(int D, int dtype, const Args& a) {
  if (dtype == csm::kBFloat16) return (int)dispatch_dim<__nv_bfloat16, DQ>(D, a);
  if (dtype == csm::kFloat32) return (int)dispatch_dim<float, DQ>(D, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/dout (B, S, Hq, D), k/v (B, T, Hkv, D) of one dtype (0 = float32,
// 1 = bfloat16); q_pos int32 (B, S); kv_pos int32 (B|1, T) with batch stride
// kv_bstride (0 broadcasts one row); lse and delta float32 (B, Hq, S).  All
// contiguous and 16-byte aligned.  dq is (B, S, Hq, D) in q's dtype.  Returns
// the launch's cudaError_t.
extern "C" int csm_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* q_pos, const void* kv_pos,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, int B, int S, int T_len, int Hq, int Hkv,
                                          int D, long long kv_bstride, float scale, int dtype,
                                          void* stream) {
  const Args a{q, k, v, q_pos, kv_pos, dout, lse, delta, dq, nullptr, B, S, T_len, Hq, Hkv,
               kv_bstride, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, dtype, a);
}

// As above; dk and dv are (B, T, Hkv, D) in k's dtype, each summed over the
// kv head's Hq/Hkv query heads.
extern "C" int csm_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* q_pos, const void* kv_pos,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dk, void* dv, int B, int S, int T_len, int Hq,
                                           int Hkv, int D, long long kv_bstride, float scale,
                                           int dtype, void* stream) {
  const Args a{q, k, v, q_pos, kv_pos, dout, lse, delta, dk, dv, B, S, T_len, Hq, Hkv,
               kv_bstride, scale, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, dtype, a);
}
