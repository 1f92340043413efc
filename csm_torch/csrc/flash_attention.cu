// Causal GQA flash-attention forward for Hopper (sm_90a), masks from positions.
//
// Replaces the TPU kernel csm_tpu/ops/flash_attention.py:_kernel (launched by
// _flash_fwd, entries flash_gqa_attention / flash_gqa_attention_with_lse):
// out[b,i,h] = softmax_j(q·k_j * scale | kv_pos[b,j] <= q_pos[b,i]) · V and the
// per-row log-sum-exp L = m + log l, with L = 1e30 and a zero row where no key
// is visible.
//
// What bounds it on the H100.  Scores and P·V take 4·D flops per visible
// (query head, key) pair against one read of Q, K and V and one write of O
// and L: about 0.4·S flops per byte at Hq=32, Hkv=8, D=64, which passes the
// card's bf16 tensor-core rate over its memory rate (~295) from S ≈ 740 up.
// At the prefill (S = 256) bytes bound it, and one wave of 128 blocks makes
// launch latency most of its time; at the training shapes (S = 512, 2048)
// operations do.
//
// Two routes, chosen by dtype in `csm_flash_attention_fwd`:
//
// bf16: tensor cores, the FA2 shape on the building blocks of tc.cuh.  Rows
// of one kv head's group are "stacked": row f = i·G + g is position i, query
// head kvh·G + g.  A block (4 warps) owns 64 or 128 stacked rows of one kv
// head, so every K/V tile it loads serves the group's G query heads, as the
// JAX kernel stacks its qpk heads; each warp owns one or two 16-row m-tiles
// (two where the grid still fills the card at D <= 64: each K and V
// fragment read from shared memory then serves two products).  Q is loaded
// once into a swizzled bf16 tile and its A fragments are kept in registers.
// The block
// walks the 64-key tiles that some row of it sees (a bitmap built first: the
// causal skip) with cp.async double buffering: the next K/V tile and its
// positions load while this one is computed.  S = Q·Kᵀ by mma.sync m16n8k16
// into float32 registers; the mask comes from positions in registers; the
// online softmax works on scale·log2e-scaled scores with exp2, the row max by
// quad shuffles, the row sum l kept per thread and summed once at the end (no
// shared memory and no barrier inside the softmax).  p = exp2(s − m_running)
// is rounded to bf16 and packed from the S accumulators straight into the A
// operand of O += P·V, whose B fragments come from a transposing ldmatrix of
// V; l sums the unrounded p, as the JAX kernel rounds p (`p.astype(v.dtype)`)
// only for the product.  O is written once in bf16, L once in float32.
// Blocks start from the last rows, which see the most keys.
//
// float32: CUDA cores, unchanged since the first version (no tensor core takes
// float32 without rounding it): a block owns 64 query rows of one query head
// and loops over 64-key K/V tiles staged in shared memory as float32; each of
// its 128 threads computes a 4x8 block of scores and a 4x(D/8) block of the
// output with FMAs, softmax online in float32; key tiles no row of the block
// sees are skipped.
//
// Both routes: ragged S and T are handled by bounds: rows >= S and keys >= T
// are never loaded (their tiles read as zeros, their p as 0) or written,
// where the TPU kernel pads with sentinel positions.  A padded prompt row
// carries q_pos = PAD_POS and therefore attends every slot with
// kv_pos <= PAD_POS, exactly as the reference does.
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

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
  cudaError_t err = csm::ensure_smem<flash_fwd_kernel<T, D>>(smem);
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

// ---------------------------------------------------------------------------
// bf16 route: tensor cores (mma.sync m16n8k16, bf16 in, float32 accumulate).
namespace tc {

using namespace csm::tc;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int TBK = 64;  // keys per tile
constexpr float kLn2 = 0.6931471805599453f;

// MT: 16-row m-tiles a warp owns; a block owns 16·MT·4 stacked rows.
template <int D, int MT>
size_t smem_bytes(int T_len) {
  const int nwords = ((T_len + TBK - 1) / TBK + 31) / 32;
  return (size_t)16 * MT * kWarps * D * 2  // Q
         + (size_t)2 * 2 * TBK * D * 2  // K, V: two stages
         + 2 * TBK * 4                  // key positions: two stages
         + nwords * 4 + 4;              // visible key tiles, qmax
}

template <int D, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 && D <= 64 ? 3 : 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ q_pos,
                     const int* __restrict__ kv_pos, bf16* __restrict__ out,
                     float* __restrict__ lse, int S, int T_len, int Hq, int Hkv,
                     long long kv_bstride, float scale) {
  constexpr int CPR = D / 8, ROWS = 16 * MT * kWarps;
  const int G = Hq / Hkv, nrows = S * G;
  const int f0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // the rows with most keys first
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwords = ((T_len + TBK - 1) / TBK + 31) / 32;

  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);
  bf16* kv_s = q_s + ROWS * D;  // [stage][K, V][TBK * D]
  int* kpos_s = reinterpret_cast<int*>(kv_s + 2 * 2 * TBK * D);  // [stage][TBK]
  unsigned* vis = reinterpret_cast<unsigned*>(kpos_s + 2 * TBK);
  int* qmax_s = reinterpret_cast<int*>(vis + nwords);

  for (int i = tid; i < ROWS * CPR; i += kThreads) {
    const int r = i / CPR, c = i % CPR, f = f0 + r;
    const bool ok = f < nrows;
    const size_t off = ok ? row_off(b, f, S, Hq, G, kvh, D) + c * 8 : 0;
    cp_async16(q_s + swz<D>(r, c), q + off, ok);
  }
  cp_async_commit();
  for (int i = tid; i < nwords; i += kThreads) vis[i] = 0u;
  if (tid == 0) *qmax_s = INT_MIN;

  // this thread's rows: lane/4 and lane/4 + 8 of each of the warp's m-tiles
  const int m0 = 16 * MT * warp;
  int qp[MT][2], rmax = INT_MIN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + m0 + 16 * mt + (lane >> 2) + 8 * h;
      qp[mt][h] = f < nrows ? q_pos[(size_t)b * S + f / G] : INT_MIN;
      rmax = max(rmax, qp[mt][h]);
    }
  __syncthreads();
  const int wmax = warp_max_int(rmax);
  if (lane == 0) atomicMax(qmax_s, wmax);
  __syncthreads();
  const int qmax = *qmax_s;
  // causal tile skipping: the key tiles holding a key some row sees
  const int* kp = kv_pos + (size_t)b * kv_bstride;
  for (int t = warp; t * TBK < T_len; t += kWarps) {
    bool seen = false;
    for (int j = t * TBK + lane; j < min(T_len, (t + 1) * TBK); j += 32) seen |= kp[j] <= qmax;
    if (__any_sync(0xffffffffu, seen) && lane == 0) atomicOr(&vis[t >> 5], 1u << (t & 31));
  }
  __syncthreads();

  auto load_kv = [&](int t, int stage) {
    const int k0 = t * TBK;
    bf16* ks = kv_s + stage * 2 * TBK * D;
    bf16* vs = ks + TBK * D;
    for (int i = tid; i < TBK * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR, j = k0 + r;
      const bool ok = j < T_len;
      const size_t off = ok ? (((size_t)b * T_len + j) * Hkv + kvh) * D + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), k + off, ok);
      cp_async16(vs + swz<D>(r, c), v + off, ok);
    }
    for (int i = tid; i < TBK; i += kThreads)
      cp_async4(kpos_s + stage * TBK + i, kp + (k0 + i < T_len ? k0 + i : 0), k0 + i < T_len);
  };

  int cur = next_tile(vis, nwords, 0), stage = 0;
  if (cur >= 0) load_kv(cur, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();
  uint32_t qa[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) ldsm_x4(qa[mt][kk], a_at<D>(q_s, m0 + 16 * mt, 2 * kk, lane));

  float acc[MT][D / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
  float m[MT][2], l[MT][2];  // m in log2 units
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = -INFINITY, l[mt][0] = l[mt][1] = 0.f;
  const float sl = scale * kLog2e;

  while (cur >= 0) {
    const int nxt = next_tile(vis, nwords, cur + 1);
    if (nxt >= 0) load_kv(nxt, stage ^ 1);  // prefetch: overlaps this tile's math
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* ks = kv_s + stage * 2 * TBK * D;
    const bf16* vs = ks + TBK * D;
    const int* kps = kpos_s + stage * TBK;
    const int k0 = cur * TBK;

    // S = Q·Kᵀ: 16·MT rows x 64 keys a warp; each K fragment serves every m-tile
    float s[MT][TBK / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int n = 0; n < TBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < TBK / 16; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, b_at<D>(ks, 16 * np, 2 * kk, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(s[mt][2 * np], qa[mt][kk], bk[0], bk[1]);
          mma(s[mt][2 * np + 1], qa[mt][kk], bk[2], bk[3]);
        }
      }
    uint32_t ap[MT][TBK / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // mask from positions, scale into log2 units, the tile's row max
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < TBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, j = n * 8 + 2 * (lane & 3) + (e & 1);
          const bool ok = k0 + j < T_len && kps[j] <= qp[mt][h];
          s[mt][n][e] = ok ? s[mt][n][e] * sl : -INFINITY;
          mx[h] = fmaxf(mx[h], s[mt][n][e]);
        }
      // a row's 64 scores lie in the 4 lanes of a quad
      float mu[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[mt][h], mx[h]);
        // m_new = -inf: nothing visible yet, acc and l are still 0
        const float corr = m_new == -INFINITY ? 1.f : exp2_approx(m[mt][h] - m_new);
        l[mt][h] *= corr;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[mt][n][2 * h] *= corr;
          acc[mt][n][2 * h + 1] *= corr;
        }
        m[mt][h] = m_new;
        mu[h] = m_new == -INFINITY ? 0.f : m_new;
      }
      // p = exp2(s − m): l sums it unrounded; rounded to bf16 it becomes the
      // A operand of P·V
#pragma unroll
      for (int n = 0; n < TBK / 8; ++n) {
        float p4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p4[e] = exp2_approx(s[mt][n][e] - mu[e >> 1]);
          l[mt][e >> 1] += p4[e];
        }
        ap[mt][n >> 1][(n & 1) * 2] = pack_bf16(p4[0], p4[1]);
        ap[mt][n >> 1][(n & 1) * 2 + 1] = pack_bf16(p4[2], p4[3]);
      }
    }
    // O += P·V; each V fragment serves every m-tile
#pragma unroll
    for (int kt = 0; kt < TBK / 16; ++kt)
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t bv[4];
        ldsm_x4_t(bv, bt_at<D>(vs, 16 * kt, 2 * dn, lane));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma(acc[mt][2 * dn], ap[mt][kt], bv[0], bv[1]);
          mma(acc[mt][2 * dn + 1], ap[mt][kt], bv[2], bv[3]);
        }
      }
    __syncthreads();  // the stage is read: the next prefetch may overwrite it
    stage ^= 1;
    cur = nxt;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lr = l[mt][h];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int f = f0 + m0 + 16 * mt + (lane >> 2) + 8 * h;
      if (f >= nrows) continue;
      const float inv = lr > 0.f ? 1.f / lr : 0.f;
      bf16* row = out + row_off(b, f, S, Hq, G, kvh, D) + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) =
            __floats2bfloat162_rn(acc[mt][n][2 * h] * inv, acc[mt][n][2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[((size_t)b * Hq + kvh * G + f % G) * S + f / G] =
            lr > 0.f ? m[mt][h] * kLn2 + logf(lr) : kLseEmpty;
    }
}

template <int D, int MT>
cudaError_t launch_mt(const void* q, const void* k, const void* v, const void* q_pos,
                      const void* kv_pos, void* out, void* lse, int B, int S, int T_len, int Hq,
                      int Hkv, long long kv_bstride, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D, MT>(T_len);
  cudaError_t err = csm::ensure_smem<flash_fwd_mma_kernel<D, MT>>(smem);
  if (err != cudaSuccess) return err;
  const int rows = 16 * MT * kWarps;
  const dim3 grid((S * (Hq / Hkv) + rows - 1) / rows, Hkv, B);
  flash_fwd_mma_kernel<D, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(q_pos), static_cast<const int*>(kv_pos), static_cast<bf16*>(out),
      static_cast<float*>(lse), S, T_len, Hq, Hkv, kv_bstride, scale);
  return cudaGetLastError();
}

// Two m-tiles a warp (128 rows a block) halve the K/V fragment reads per
// product, where the grid still fills the card; one (64 rows) where it would
// not, as at the B=1, S=256 prefill, and at D = 128, whose two m-tiles would
// not fit the registers.
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* q_pos,
                   const void* kv_pos, void* out, void* lse, int B, int S, int T_len, int Hq,
                   int Hkv, long long kv_bstride, float scale, cudaStream_t stream) {
  if constexpr (D <= 64) {
    const long long blocks2 = (long long)((S * (Hq / Hkv) + 127) / 128) * Hkv * B;
    if (blocks2 >= csm::sm_count())
      return launch_mt<D, 2>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride,
                             scale, stream);
  }
  return launch_mt<D, 1>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride,
                         scale, stream);
}

cudaError_t dispatch_dim(int D, const void* q, const void* k, const void* v, const void* q_pos,
                         const void* kv_pos, void* out, void* lse, int B, int S, int T_len,
                         int Hq, int Hkv, long long kv_bstride, float scale,
                         cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 32: return launch<32>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 64: return launch<64>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    case 128: return launch<128>(q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv, kv_bstride, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

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
    return (int)tc::dispatch_dim(D, q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv,
                                 kv_bstride, scale, s);
  if (dtype == csm::kFloat32)
    return (int)dispatch_dim<float>(D, q, k, v, q_pos, kv_pos, out, lse, B, S, T_len, Hq, Hkv,
                                    kv_bstride, scale, s);
  return (int)cudaErrorInvalidValue;
}
