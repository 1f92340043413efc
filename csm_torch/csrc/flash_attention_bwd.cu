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
// operations.
//
// Two routes, chosen by dtype in `dispatch`:
//
// bf16: tensor cores.  All five products are mma.sync.m16n8k16 (bf16 in,
// float32 accumulators in registers), fed by ldmatrix from bf16 tiles in
// shared memory whose 16-byte chunks are XOR-swizzled by row, so ldmatrix
// and its transposing form read without bank conflicts at every D.
// mma.sync rather than wgmma: it needs no warpgroup-wide descriptors or
// 64-row tiles, its A operand can come from registers at any 16x16 (so P
// and dS go from the S/dP accumulators straight into the next product), and
// it is the smaller step from the float32 kernels; wgmma is later work.
// Rows of one kv head's group are "stacked": row f = i·G + g is position i,
// query head kvh·G + g, and a group's heads are adjacent in (B, S, Hq, D).
//  * dq: one block (4 warps) per 64 stacked rows of a kv head (the group's
//    G heads at 64/G positions), so every K/V tile loaded serves the whole
//    group, as the JAX kernel stacks its qpk heads.  It walks 64-key tiles
//    with cp.async double buffering (the next K/V tile and its positions
//    load while this one is computed).  Each warp owns 16 rows: S = Q·Kᵀ and
//    dP = dO·Vᵀ, then p and dS = p (dP − Dr) in registers; dS is rounded to
//    bf16 (as the JAX kernel rounds it) and becomes the A operand of
//    dq += dS·K.  Blocks start from the last rows, which see the most keys.
//  * dk/dv: one block (4 warps) per 32 keys of a kv head.  It walks tiles of
//    64 stacked rows with cp.async double buffering of Q, dO, L, Dr and the
//    positions; the GQA sum is part of each product, with no atomics, so the
//    result is deterministic.  Warp w owns keys 16·(w%2).. and the rows
//    32·(w/2).. of each tile: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ and dSᵀ
//    rounded to bf16 (as the JAX kernel rounds p and ds) are the A operands
//    of dv += Pᵀ·dO and dk += dSᵀ·Q.  The two row halves are summed through
//    shared memory at the end.  32-key blocks, and two warps on every 16
//    keys, fill the card at the training shape: at B=2, S=T=512 the grid is
//    256 blocks of 4 warps for 132 SMs, where 64-key blocks gave 128.
// Blocks are 4 warps: at ~160 registers a thread (D <= 64) three fit an SM.
// Causal tile skipping both ways: a bitmap of the tiles holding a visible
// (row, key) pair is built first (a warp vote per tile); only those tiles
// are loaded and computed.
//
// float32: CUDA cores, unchanged since the first version (no tensor core
// takes float32 without rounding it to TF32).  Both kernels stage 64-row
// float32 tiles in shared memory and use 256 threads, each holding a 2x8
// block of a 64x64 score tile and a 2x(D/8) block of its accumulators.
//  * dq: one block per (b, query head, 64 query rows) over 64-key tiles,
//    dq += dS·K in float32; a key tile no row sees is skipped.
//  * dk/dv: one block per (b, kv head, 64 keys) over the group's query heads
//    and their 64-row tiles, dv += Pᵀ·dO and dk += dSᵀ·Q in float32, the
//    GQA sum inside the block, no atomics.
//
// Both routes: ragged S and T are handled by bounds: rows >= S and keys >= T
// are never loaded (their tiles read as zeros, their p as 0) or written,
// where the TPU kernels pad with sentinel positions; a row with L = 1e30
// gets p = 0; dq, dk and dv are written once, in the inputs' dtype.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate).
namespace tc {

using namespace csm::tc;
// 4 warps a block: at D <= 64 the kernels take ~160 registers a thread, so
// three blocks (12 warps) fit an SM where one 8-warp block would
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int DQ_ROWS = 16 * kWarps;  // stacked (position, head) rows of a dq block
constexpr int DQ_BK = 64;             // keys per tile of the dq kernel
constexpr int KV_BK = 32;             // keys of a dk/dv block: 16 per warp row group
constexpr int KV_KW = KV_BK / 16;     // warp row groups of a dk/dv block
constexpr int KV_BQ = 64;             // stacked rows per tile of the dk/dv kernel: 32 per warp half
static_assert(kWarps == 2 * KV_KW, "each 16 keys take two warps, one per half of a row tile");

template <int D>
size_t dq_smem_bytes(int T_len) {
  const int nwords = ((T_len + DQ_BK - 1) / DQ_BK + 31) / 32;
  return (size_t)2 * DQ_ROWS * D * 2    // Q, dO
         + (size_t)2 * 2 * DQ_BK * D * 2  // K, V: two stages
         + 2 * DQ_BK * 4                  // key positions: two stages
         + nwords * 4 + 4;                // visible key tiles, qmax
}

template <int D>
size_t dkv_smem_bytes(int S, int G) {
  const int nwords = ((S * G + KV_BQ - 1) / KV_BQ + 31) / 32;
  return (size_t)2 * KV_BK * D * 2       // K, V
         + (size_t)2 * 2 * KV_BQ * D * 2  // Q, dO: two stages (the dk/dv sum at the end)
         + 2 * 3 * KV_BQ * 4              // L, Dr, positions: two stages
         + nwords * 4 + 4;                // visible query tiles, kmin
}

// dq for DQ_ROWS stacked rows of one kv head's group: every K/V tile loaded
// serves the group's G query heads.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int S, int T_len, int Hq,
          int Hkv, long long kv_bstride, float scale) {
  constexpr int CPR = D / 8;
  const int G = Hq / Hkv, nrows = S * G;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;  // the rows with most keys first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwords = ((T_len + DQ_BK - 1) / DQ_BK + 31) / 32;

  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* do_s = q_s + DQ_ROWS * D;
  bf16* kv_s = do_s + DQ_ROWS * D;  // [stage][K, V][DQ_BK * D]
  int* kpos_s = reinterpret_cast<int*>(kv_s + 2 * 2 * DQ_BK * D);  // [stage][DQ_BK]
  unsigned* vis = reinterpret_cast<unsigned*>(kpos_s + 2 * DQ_BK);
  int* qmax_s = reinterpret_cast<int*>(vis + nwords);

  for (int i = tid; i < DQ_ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR, f = f0 + r;
    const bool ok = f < nrows;
    const size_t off = ok ? row_off(b, f, S, Hq, G, kvh, D) + c * 8 : 0;
    cp_async16(q_s + swz<D>(r, c), q + off, ok);
    cp_async16(do_s + swz<D>(r, c), dout + off, ok);
  }
  cp_async_commit();
  for (int i = tid; i < nwords; i += kThreads) vis[i] = 0u;
  if (tid == 0) *qmax_s = INT_MIN;

  // this thread's two rows of the warp's 16: lane/4 and lane/4 + 8
  float nL[2], Dr[2];
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 16 * warp + (lane >> 2) + 8 * h;
    const bool ok = f < nrows;
    const int i = ok ? f / G : 0;
    const size_t lr = ((size_t)b * Hq + kvh * G + (ok ? f % G : 0)) * S + i;
    qp[h] = ok ? q_pos[(size_t)b * S + i] : INT_MIN;
    nL[h] = ok ? -lse[lr] * kLog2e : 0.f;
    Dr[h] = ok ? delta[lr] : 0.f;
  }
  __syncthreads();
  const int wmax = warp_max_int(max(qp[0], qp[1]));
  if (lane == 0) atomicMax(qmax_s, wmax);
  __syncthreads();
  const int qmax = *qmax_s;
  // causal tile skipping: the key tiles holding a key some row sees
  const int* kp = kv_pos + (size_t)b * kv_bstride;
  for (int t = warp; t * DQ_BK < T_len; t += kWarps) {
    bool seen = false;
    for (int j = t * DQ_BK + lane; j < min(T_len, (t + 1) * DQ_BK); j += 32) seen |= kp[j] <= qmax;
    if (__any_sync(0xffffffffu, seen) && lane == 0) atomicOr(&vis[t >> 5], 1u << (t & 31));
  }
  __syncthreads();

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * DQ_BK;
    bf16* ks = kv_s + stage * 2 * DQ_BK * D;
    bf16* vs = ks + DQ_BK * D;
    for (int i = tid; i < DQ_BK * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR, j = k0 + r;
      const bool ok = j < T_len;
      const size_t off = ok ? (((size_t)b * T_len + j) * Hkv + kvh) * D + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), k + off, ok);
      cp_async16(vs + swz<D>(r, c), v + off, ok);
    }
    for (int i = tid; i < DQ_BK; i += kThreads)
      cp_async4(kpos_s + stage * DQ_BK + i, kp + (k0 + i < T_len ? k0 + i : 0), k0 + i < T_len);
  };

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl = scale * kLog2e;
  const int m0 = 16 * warp;

  int cur = next_tile(vis, nwords, 0), stage = 0;
  if (cur >= 0) load_kv(cur, 0);
  cp_async_commit();
  while (cur >= 0) {
    const int nxt = next_tile(vis, nwords, cur + 1);
    if (nxt >= 0) load_kv(nxt, stage ^ 1);  // prefetch: overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kv_s + stage * 2 * DQ_BK * D;
    const bf16* vs = ks + DQ_BK * D;
    const int* kps = kpos_s + stage * DQ_BK;
    const int k0 = cur * DQ_BK;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows x 64 keys a warp
    float s[DQ_BK / 8][4], dp[DQ_BK / 8][4];
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, a_at<D>(q_s, m0, 2 * kk, lane));
      ldsm_x4(ao, a_at<D>(do_s, m0, 2 * kk, lane));
#pragma unroll
      for (int np = 0; np < DQ_BK / 16; ++np) {
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, b_at<D>(ks, 16 * np, 2 * kk, lane));
        ldsm_x4(bv, b_at<D>(vs, 16 * np, 2 * kk, lane));
        mma(s[2 * np], aq, bk[0], bk[1]);
        mma(s[2 * np + 1], aq, bk[2], bk[3]);
        mma(dp[2 * np], ao, bv[0], bv[1]);
        mma(dp[2 * np + 1], ao, bv[2], bv[3]);
      }
    }
    // p = exp(s·scale − L) where visible, dS = p (dP − Dr), rounded to bf16
    // (as the JAX kernel rounds ds) into the A operand of dS·K
    uint32_t ads[DQ_BK / 16][4];
#pragma unroll
    for (int n = 0; n < DQ_BK / 8; ++n) {
      float d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, j = n * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = k0 + j < T_len && kps[j] <= qp[h];
        const float p = ok ? exp2_approx(fmaf(s[n][e], sl, nL[h])) : 0.f;
        d4[e] = p * (dp[n][e] - Dr[h]);
      }
      ads[n >> 1][(n & 1) * 2] = pack_bf16(d4[0], d4[1]);
      ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d4[2], d4[3]);
    }
    // dq += dS·K
#pragma unroll
    for (int kt = 0; kt < DQ_BK / 16; ++kt)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bk[4];
        ldsm_x4_t(bk, bt_at<D>(ks, 16 * kt, 2 * dn, lane));
        mma(acc[2 * dn], ads[kt], bk[0], bk[1]);
        mma(acc[2 * dn + 1], ads[kt], bk[2], bk[3]);
      }
    __syncthreads();  // the stage is read: the next prefetch may overwrite it
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + m0 + (lane >> 2) + 8 * h;
    if (f >= nrows) continue;
    bf16* row = dq + row_off(b, f, S, Hq, G, kvh, D) + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// dk and dv for KV_BK keys of one kv head, summed over the group's heads:
// the block walks stacked-row tiles (positions x the group's heads), so the
// GQA sum is part of each product.  Warp w owns keys 16·(w%KV_KW).. and the
// stacked rows 32·(w/KV_KW).. of every tile; the two halves add at the end.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 64 ? 3 : 2)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
           const int* __restrict__ q_pos, const int* __restrict__ kv_pos,
           const bf16* __restrict__ dout, const float* __restrict__ lse,
           const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
           int S, int T_len, int Hq, int Hkv, long long kv_bstride, float scale) {
  constexpr int CPR = D / 8;
  const int G = Hq / Hkv, nrows = S * G;
  const int k0 = blockIdx.x * KV_BK, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp % KV_KW, qh = warp / KV_KW;
  const int nwords = ((nrows + KV_BQ - 1) / KV_BQ + 31) / 32;

  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* k_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* v_s = k_s + KV_BK * D;
  bf16* st = v_s + KV_BK * D;  // [stage][Q, dO][KV_BQ * D]
  float* l_s = reinterpret_cast<float*>(st + 2 * 2 * KV_BQ * D);  // [stage][KV_BQ]
  float* dr_s = l_s + 2 * KV_BQ;
  int* qp_s = reinterpret_cast<int*>(dr_s + 2 * KV_BQ);
  unsigned* vis = reinterpret_cast<unsigned*>(qp_s + 2 * KV_BQ);
  int* kmin_s = reinterpret_cast<int*>(vis + nwords);

  const size_t krow = (size_t)Hkv * D;
  const size_t koff = (((size_t)b * T_len + k0) * Hkv + kvh) * D;
  for (int i = tid; i < KV_BK * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = k0 + r < T_len;
    const size_t off = ok ? koff + r * krow + c * 8 : 0;
    cp_async16(k_s + swz<D>(r, c), k + off, ok);
    cp_async16(v_s + swz<D>(r, c), v + off, ok);
  }
  cp_async_commit();
  for (int i = tid; i < nwords; i += kThreads) vis[i] = 0u;
  if (tid == 0) *kmin_s = INT_MAX;

  // this thread's two keys of the warp's 16: lane/4 and lane/4 + 8
  const int* kp = kv_pos + (size_t)b * kv_bstride;
  int kpj[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + 16 * kw + (lane >> 2) + 8 * h;
    kpj[h] = j < T_len ? kp[j] : INT_MAX;
  }
  __syncthreads();
  const int wmin = warp_min_int(min(kpj[0], kpj[1]));
  if (lane == 0) atomicMin(kmin_s, wmin);
  __syncthreads();
  const int kmin = *kmin_s;
  // causal tile skipping: the stacked-row tiles holding a row that sees a key
  for (int t = warp; t * KV_BQ < nrows; t += kWarps) {
    const int i1 = min(nrows, (t + 1) * KV_BQ) - 1;  // the tile's last stacked row
    bool seen = false;
    for (int i = t * KV_BQ / G + lane; i <= i1 / G; i += 32) seen |= q_pos[(size_t)b * S + i] >= kmin;
    if (__any_sync(0xffffffffu, seen) && lane == 0) atomicOr(&vis[t >> 5], 1u << (t & 31));
  }
  __syncthreads();

  auto load_q = [&](int t, int stage) {
    const int f0 = t * KV_BQ;
    bf16* qs = st + stage * 2 * KV_BQ * D;
    bf16* os = qs + KV_BQ * D;
    for (int i = tid; i < KV_BQ * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR, f = f0 + r;
      const bool ok = f < nrows;
      const size_t off = ok ? row_off(b, f, S, Hq, G, kvh, D) + c * 8 : 0;
      cp_async16(qs + swz<D>(r, c), q + off, ok);
      cp_async16(os + swz<D>(r, c), dout + off, ok);
    }
    for (int r = tid; r < KV_BQ; r += kThreads) {
      const int f = f0 + r;
      const bool ok = f < nrows;
      const int i = ok ? f / G : 0;
      const size_t lr = ((size_t)b * Hq + kvh * G + (ok ? f % G : 0)) * S + i;
      cp_async4(l_s + stage * KV_BQ + r, lse + lr, ok);
      cp_async4(dr_s + stage * KV_BQ + r, delta + lr, ok);
      cp_async4(qp_s + stage * KV_BQ + r, q_pos + (size_t)b * S + i, ok);
    }
  };

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const float sl = scale * kLog2e;
  const int m0 = 16 * kw, c0 = 32 * qh;

  int cur = next_tile(vis, nwords, 0), stage = 0;
  if (cur >= 0) load_q(cur, 0);
  cp_async_commit();
  while (cur >= 0) {
    const int nxt = next_tile(vis, nwords, cur + 1);
    if (nxt >= 0) load_q(nxt, stage ^ 1);  // prefetch Q, dO, L, Dr, positions
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* qs = st + stage * 2 * KV_BQ * D;
    const bf16* os = qs + KV_BQ * D;
    const float* ls = l_s + stage * KV_BQ;
    const float* drs = dr_s + stage * KV_BQ;
    const int* qps = qp_s + stage * KV_BQ;
    const int f0 = cur * KV_BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 16 keys x 32 stacked rows a warp
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(ak, a_at<D>(k_s, m0, 2 * kk, lane));
      ldsm_x4(av, a_at<D>(v_s, m0, 2 * kk, lane));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, b_at<D>(qs, c0 + 16 * np, 2 * kk, lane));
        ldsm_x4(bo, b_at<D>(os, c0 + 16 * np, 2 * kk, lane));
        mma(s[2 * np], ak, bq[0], bq[1]);
        mma(s[2 * np + 1], ak, bq[2], bq[3]);
        mma(dp[2 * np], av, bo[0], bo[1]);
        mma(dp[2 * np + 1], av, bo[2], bo[3]);
      }
    }
    // Pᵀ and dSᵀ, rounded to bf16 (as the JAX kernel rounds p and ds) into
    // the A operands of Pᵀ·dO and dSᵀ·Q
    uint32_t ap[2][4], ads[2][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      float p4[4], d4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, r = c0 + n * 8 + 2 * (lane & 3) + (e & 1);
        const bool ok = f0 + r < nrows && kpj[h] <= qps[r];
        const float p = ok ? exp2_approx(fmaf(s[n][e], sl, -ls[r] * kLog2e)) : 0.f;
        p4[e] = p;
        d4[e] = p * (dp[n][e] - drs[r]);
      }
      ap[n >> 1][(n & 1) * 2] = pack_bf16(p4[0], p4[1]);
      ap[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p4[2], p4[3]);
      ads[n >> 1][(n & 1) * 2] = pack_bf16(d4[0], d4[1]);
      ads[n >> 1][(n & 1) * 2 + 1] = pack_bf16(d4[2], d4[3]);
    }
    // dv += Pᵀ·dO and dk += dSᵀ·Q
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bo[4], bq[4];
        ldsm_x4_t(bo, bt_at<D>(os, c0 + 16 * kt, 2 * dn, lane));
        ldsm_x4_t(bq, bt_at<D>(qs, c0 + 16 * kt, 2 * dn, lane));
        mma(dv_acc[2 * dn], ap[kt], bo[0], bo[1]);
        mma(dv_acc[2 * dn + 1], ap[kt], bo[2], bo[3]);
        mma(dk_acc[2 * dn], ads[kt], bq[0], bq[1]);
        mma(dk_acc[2 * dn + 1], ads[kt], bq[2], bq[3]);
      }
    __syncthreads();  // the stage is read: the next prefetch may overwrite it
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();
  __syncthreads();

  // the two halves of the stacked rows: the second half's warps hand their
  // sums to the first half's through shared memory (the Q/dO stages), which
  // add and write once
  float* red = reinterpret_cast<float*>(st);  // [dk, dv][KV_BK][D]
  if (qh == 1) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = (m0 + (lane >> 2) + 8 * (e >> 1)) * D + 8 * n + 2 * (lane & 3) + (e & 1);
        red[idx] = dk_acc[n][e];
        red[KV_BK * D + idx] = dv_acc[n][e];
      }
  }
  __syncthreads();
  if (qh == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + (lane >> 2) + 8 * h;
      if (k0 + r >= T_len) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const int col = 8 * n + 2 * (lane & 3), idx = r * D + col;
        const size_t o = koff + r * krow + col;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(
            (dk_acc[n][2 * h] + red[idx]) * scale, (dk_acc[n][2 * h + 1] + red[idx + 1]) * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) =
            __floats2bfloat162_rn(dv_acc[n][2 * h] + red[KV_BK * D + idx],
                                  dv_acc[n][2 * h + 1] + red[KV_BK * D + idx + 1]);
      }
    }
  }
}

}  // namespace tc

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
  cudaError_t err = csm::ensure_smem<flash_bwd_dq_kernel<T, D>>(smem);
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
  cudaError_t err = csm::ensure_smem<flash_bwd_dkv_kernel<T, D>>(smem);
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

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  const size_t smem = tc::dq_smem_bytes<D>(a.T_len);
  auto kernel = tc::dq_kernel<D>;
  cudaError_t err = csm::ensure_smem<tc::dq_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  const dim3 grid((a.S * G + tc::DQ_ROWS - 1) / tc::DQ_ROWS, a.Hkv, a.B);
  using T = __nv_bfloat16;
  kernel<<<grid, tc::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), a.S, a.T_len, a.Hq, a.Hkv,
      a.kv_bstride, a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv_tc(const Args& a) {
  const size_t smem = tc::dkv_smem_bytes<D>(a.S, a.Hq / a.Hkv);
  auto kernel = tc::dkv_kernel<D>;
  cudaError_t err = csm::ensure_smem<tc::dkv_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.T_len + tc::KV_BK - 1) / tc::KV_BK, a.Hkv, a.B);
  using T = __nv_bfloat16;
  kernel<<<grid, tc::kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.q_pos), static_cast<const int*>(a.kv_pos),
      static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<T*>(a.out0), static_cast<T*>(a.out1),
      a.S, a.T_len, a.Hq, a.Hkv, a.kv_bstride, a.scale);
  return cudaGetLastError();
}

template <bool DQ>
cudaError_t dispatch_dim_tc(int D, const Args& a) {
  switch (D) {
    case 16: return DQ ? launch_dq_tc<16>(a) : launch_dkv_tc<16>(a);
    case 32: return DQ ? launch_dq_tc<32>(a) : launch_dkv_tc<32>(a);
    case 64: return DQ ? launch_dq_tc<64>(a) : launch_dkv_tc<64>(a);
    case 128: return DQ ? launch_dq_tc<128>(a) : launch_dkv_tc<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The dtype route: bf16 on the tensor cores, float32 on the CUDA cores.
template <bool DQ>
int dispatch(int D, int dtype, const Args& a) {
  if (dtype == csm::kBFloat16) return (int)dispatch_dim_tc<DQ>(D, a);
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
