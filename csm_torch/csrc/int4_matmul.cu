// Grouped-int4 fused-dequant matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel csm_tpu/ops/int4_matmul.py:_kernel (launched by
// _int4_matmul_kernel, entry int4_matmul):
//
//   y[m, n] = sum_g s[g, n] * sum_{k in g} x[m, k] * q[k, n]
//
// for x (M <= 64, K) in float32 or bf16, q the sign-extended two's-complement
// nibbles of w4p (K/2, N) uint8 (byte row k/2: low nibble for even k, high
// nibble for odd k) and s the bf16 scales (K/gs, N).  Each group's dot is
// accumulated in float32, scaled in float32, and the output rounded once.
//
// What bounds it on the H100: bytes.  At M <= 64 the packed weight
// (K*N/2 bytes) and its scales (2*G*N) are most of the traffic and every
// weight serves at most 64 rows, far below the ~295 operations per byte the
// card needs before arithmetic is the limit (CSM-1B's backbone w13, K=2048,
// N=16384, streams 17.3 MB: 5.2 us at 3.35 TB/s).  The frame's most frequent
// shapes are small (the decoder's wo is 0.5 MB): there the launch and the
// first bytes' latency set the time, and the grid must still reach every SM.
//
// Three routes, chosen in `csm_int4_matmul`:
//
// bf16 x, groups of a multiple of 16 rows (every main-path weight: gs = 128):
// tensor cores, split K.  mma.sync m16n8k16 with the weight as the A operand
// (16 output columns x 16 k) and x as B (16 k x 8 rows, rows >= M zero), so
// M <= 8 wastes no more than one 8-row tile.  The packed bytes of rows r
// and r + 4 of a column (k = 2r, 2r+1 and 2r+8, 2r+9) give two A registers
// exactly, with the mma's k order permuted and x's B fragments permuted
// alike: a prmt puts the two bytes in the two halves, one lop3 a half puts
// a nibble, offset-binary, in the mantissa of 128, and a bf16x2
// subtraction of 136 leaves q: three instructions a register.  Each
// group's mma partial is multiplied by its float32 scale into a second
// float32 accumulator (dot then scale, as the JAX kernel does; q·s would
// not fit bf16's mantissa).
// A block owns 64 or 128 output columns; its 4 warps split columns or the
// k-steps of a stage by M (one route for M = 1..64).  K is split in whole
// stages (128 input rows, whole groups) across the blocks of a thread-block
// cluster of up to 16 (8 from M = 17), sized so the grid has two blocks per
// SM at M <= 16 (one above): the decoder's wo (1024 x 1024) gives 128
// blocks where one block per 128 columns gave 8.
// The split is reduced inside the same launch, no atomics: each block's
// warps leave their sums in its shared memory, and the cluster's blocks read
// each other's through distributed shared memory, in rank order, so the
// result is deterministic, with no second launch and no zeroed scratch.
// Loads: a 4-stage cp.async ring of packed bytes, x and scales per block
// (rows of packed bytes swizzled so a warp's reads hit distinct banks).  N
// that is not a multiple of 16, or an unaligned pointer, takes plain loads
// into the same ring.
//
// float32 x, or bf16 x with groups that are not a multiple of 16 rows (a
// group smaller than one mma k-step cannot be scaled after its own mma; the
// tests use gs = 2 ... 8; no main-path weight): CUDA cores, the first
// design.  Blocks tile N in 128 columns and walk all of K in chunks of whole
// groups (<= 256 rows) staged in shared memory, the next chunk's packed
// bytes loaded into registers while this one is computed; a thread owns 8
// columns and TM rows, for small M the block's threads also split a chunk's
// rows (KS ways), each keeping a float32 partial per group that it scales
// into a float32 accumulator; the KS accumulators are summed in shared
// memory at the end.  A nibble becomes a float with two integer operations
// and one add (the 2^23 exponent trick), exactly.
//
// All routes: ragged N is masked.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"
#include "tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 128;                      // output columns per block
constexpr int kColThreads = 16;               // threads across a block's columns
constexpr int kTN = kBN / kColThreads;        // 8 columns per thread
constexpr int kLanesOfRest = kThreads / kColThreads;  // 16 = row threads x K splits
constexpr int kMaxChunkRows = 256;            // input rows staged per chunk
constexpr int kMaxChunkGroups = 32;
constexpr int kVecPerRow = kBN / 16;          // 16-byte vectors per packed row of a block
constexpr int kVecPerThread = (kMaxChunkRows / 2) * kVecPerRow / kThreads;  // 4

// Sign-extended nibble at bit ``shift`` of ``w`` as a float: 2^23 + (q + 8)
// in the mantissa, minus 2^23 + 8.
__device__ __forceinline__ float nibble(uint32_t w, int shift) {
  return __uint_as_float((((w >> shift) & 0xFu) ^ 0x8u) | 0x4B000000u) - 8388616.0f;
}

struct Shape {
  int M, K, N, gs, gpc, rt_n;  // gpc: groups per chunk; rt_n: row threads
};

// Shared memory: packed bytes (ch/2, kBN) | scales (gpc, kBN) f32 | x (m_pad, ch)
// f32; the KS partial sums (ks_n, m_pad, kBN) f32 reuse it at the end.
template <int TM>
size_t smem_bytes(const Shape& s) {
  const int ch = s.gpc * s.gs, ks_n = kLanesOfRest / s.rt_n, m_pad = s.rt_n * TM;
  const size_t stage = (size_t)(ch / 2) * kBN + (size_t)s.gpc * kBN * 4 + (size_t)m_pad * ch * 4;
  const size_t red = ks_n > 1 ? (size_t)ks_n * m_pad * kBN * 4 : 0;
  return stage > red ? stage : red;
}

template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const T* __restrict__ x,                 // (M, K)
                   const uint8_t* __restrict__ w4p,         // (K/2, N)
                   const __nv_bfloat16* __restrict__ s4,    // (G, N)
                   T* __restrict__ y,                       // (M, N)
                   Shape sh, int vec_ok) {
  const int M = sh.M, K = sh.K, N = sh.N, gs = sh.gs, gpc = sh.gpc, rt_n = sh.rt_n;
  const int G = K / gs, ch = gpc * gs, gs2 = gs / 2;
  const int ks_n = kLanesOfRest / rt_n, m_pad = rt_n * TM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tn = tid % kColThreads, rest = tid / kColThreads;
  const int rt = rest % rt_n, ks = rest / rt_n;

  extern __shared__ __align__(16) unsigned char smem[];
  uint8_t* w_s = smem;
  float* s_s = reinterpret_cast<float*>(smem + (size_t)(ch / 2) * kBN);
  float* x_s = s_s + gpc * kBN;

  uint4 pre[kVecPerThread];
  // packed bytes of chunk c into registers; rows past the chunk and columns
  // past N read as 0
  auto prefetch = [&](int c) {
    const int rows = min(gpc, G - c * gpc) * gs2;
    const size_t r0 = (size_t)c * gpc * gs2;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = tid + i * kThreads, r = v / kVecPerRow, n = n0 + (v % kVecPerRow) * 16;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        const uint8_t* src = w4p + (r0 + r) * (size_t)N + n;
        if (vec_ok && n + 16 <= N) {
          val = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t wd[4] = {0u, 0u, 0u, 0u};
          for (int b = 0; b < 16 && n + b < N; ++b) wd[b / 4] |= (uint32_t)src[b] << (8 * (b % 4));
          val = make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
      pre[i] = val;
    }
  };

  float acc[TM][kTN], part[TM][kTN];
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[t][j] = part[t][j] = 0.f;

  auto flush = [&](int gi) {
    const float* sc = s_s + gi * kBN + tn * kTN;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const float s = sc[j];
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        acc[t][j] = fmaf(part[t][j], s, acc[t][j]);
        part[t][j] = 0.f;
      }
    }
  };

  const int nchunks = (G + gpc - 1) / gpc;
  prefetch(0);
  for (int c = 0; c < nchunks; ++c) {
    const int g0 = c * gpc, ng = min(gpc, G - g0), kc = ng * gs, rows = ng * gs2;
    const int k0 = g0 * gs;
#pragma unroll
    for (int i = 0; i < kVecPerThread; ++i) {
      const int v = tid + i * kThreads, r = v / kVecPerRow;
      if (r < rows) *reinterpret_cast<uint4*>(w_s + r * kBN + (v % kVecPerRow) * 16) = pre[i];
    }
    for (int i = tid; i < ng * kBN; i += kThreads) {
      const int n = n0 + i % kBN;
      s_s[i] = n < N ? __bfloat162float(s4[(size_t)(g0 + i / kBN) * N + n]) : 0.f;
    }
    for (int i = tid; i < m_pad * kc; i += kThreads) {
      const int m = i / kc, kk = i % kc;
      x_s[m * ch + kk] = m < M ? csm::to_float(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    if (c + 1 < nchunks) prefetch(c + 1);  // in flight while this chunk is computed

    int gi = -1, next = 0;  // group (within the chunk) of the partial; its end
    for (int r = ks; r < rows; r += ks_n) {
      if (r >= next) {
        if (gi >= 0) flush(gi);
        gi = r / gs2;
        next = (gi + 1) * gs2;
      }
      const uint2 wv = *reinterpret_cast<const uint2*>(w_s + r * kBN + tn * kTN);
      float lo[kTN], hi[kTN];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        lo[b] = nibble(wv.x, 8 * b);
        hi[b] = nibble(wv.x, 8 * b + 4);
        lo[4 + b] = nibble(wv.y, 8 * b);
        hi[4 + b] = nibble(wv.y, 8 * b + 4);
      }
#pragma unroll
      for (int t = 0; t < TM; ++t) {
        const float2 xv = *reinterpret_cast<const float2*>(x_s + (rt + rt_n * t) * ch + 2 * r);
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          part[t][j] = fmaf(xv.x, lo[j], part[t][j]);
          part[t][j] = fmaf(xv.y, hi[j], part[t][j]);
        }
      }
    }
    if (gi >= 0) flush(gi);
    __syncthreads();
  }

  if (ks_n == 1) {
#pragma unroll
    for (int t = 0; t < TM; ++t) {
      const int m = rt + rt_n * t;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int n = n0 + tn * kTN + j;
        if (m < M && n < N) y[(size_t)m * N + n] = csm::from_float<T>(acc[t][j]);
      }
    }
    return;
  }
  float* red = reinterpret_cast<float*>(smem);  // (ks_n, m_pad, kBN)
#pragma unroll
  for (int t = 0; t < TM; ++t)
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      red[((size_t)ks * m_pad + rt + rt_n * t) * kBN + tn * kTN + j] = acc[t][j];
  __syncthreads();
  for (int i = tid; i < m_pad * kBN; i += kThreads) {
    const int m = i / kBN, n = n0 + i % kBN;
    if (m >= M || n >= N) continue;
    float sum = 0.f;
    for (int s = 0; s < ks_n; ++s) sum += red[(size_t)s * m_pad * kBN + i];
    y[(size_t)m * N + n] = csm::from_float<T>(sum);
  }
}

template <typename T, int TM>
cudaError_t launch(const void* x, const void* w4p, const void* s4, void* y, Shape sh,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<TM>(sh);
  auto kernel = int4_matmul_kernel<T, TM>;
  cudaError_t err = csm::ensure_smem<int4_matmul_kernel<T, TM>>(smem);
  if (err != cudaSuccess) return err;
  const int vec_ok = sh.N % 16 == 0 && reinterpret_cast<uintptr_t>(w4p) % 16 == 0;
  kernel<<<(sh.N + kBN - 1) / kBN, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w4p),
      static_cast<const __nv_bfloat16*>(s4), static_cast<T*>(y), sh, vec_ok);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_rows(const void* x, const void* w4p, const void* s4, void* y, Shape sh,
                          cudaStream_t stream) {
  if (sh.M <= kLanesOfRest) {  // one row per thread; spare threads split K
    sh.rt_n = 1;
    while (sh.rt_n < sh.M) sh.rt_n *= 2;
    return launch<T, 1>(x, w4p, s4, y, sh, stream);
  }
  sh.rt_n = kLanesOfRest;  // 17..64 rows: four per thread
  return launch<T, 4>(x, w4p, s4, y, sh, stream);
}

// ---------------------------------------------------------------------------
// bf16 route, groups of a multiple of 16 rows: tensor cores, split K across
// the blocks of a thread-block cluster.
namespace tc {

using namespace csm::tc;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;       // cp.async ring of packed bytes, x and scales
constexpr int kStageRows = 128;  // input rows a stage holds (whole groups, at least one)

struct Geo {
  int M, K, N, gs;
  int gpc, kc, nst, cs;  // groups and rows a stage; stages in all; blocks of a cluster
  int vec;               // every copy is 16-byte aligned: cp.async, else plain loads
};

// A warp owns NTL tiles of 16 output columns and MB tiles of 8 x rows; the
// block's warps are WN across columns times 4/WN across the k-steps of a
// stage.
template <int MB, int NTL, int WN>
struct Cfg {
  static constexpr int WK = kWarps / WN;
  static constexpr int BN = WN * 16 * NTL;  // columns a block
  static constexpr int W = 2 * NTL;         // packed bytes a thread reads from a row
  static constexpr int CPR = BN / 16;       // 16-byte chunks of a packed row
  // the grid's target, in blocks per SM: M <= 16 streams bytes, and more
  // blocks keep more in flight; from M = 17 the tensor work of a block
  // grows, and fewer, longer blocks are faster
  static constexpr int kBlocksPerSM = MB <= 2 ? 2 : 1;
  // blocks a cluster may have: 16 (above the portable 8, which the H100
  // allows) where a block's shared memory is small, so a long K over few
  // column tiles (the decoder's w2, 8192 x 1024) splits 16 ways
  static constexpr int kMaxCluster = MB <= 2 ? 16 : 8;
  static_assert(CPR == 4 || CPR == 8, "packed rows of 64 or 128 columns");
};

// Swizzled 16-byte chunk of packed row r: the 4 rows a warp's lanes read at
// once land in distinct bank groups.
template <int CPR>
__device__ __forceinline__ int wswz(int r, int c) {
  if constexpr (CPR == 8) return c ^ ((r & 3) << 1);
  else return c ^ (r & 2);
}

// Byte J of the words w0 (packed row r0) and w1 (packed row r1 = r0 + 4) of
// one column as two bf16x2 A registers, exactly: (lo nibble of r0, lo of
// r1) and (hi of r0, hi of r1), i.e. the weights at k = (2·r0, 2·r1) and
// (2·r0 + 1, 2·r1 + 1).  prmt puts the two bytes in the two halves; one
// lop3 a half keeps a nibble, turns it offset-binary (u = q + 8) and puts
// it in the mantissa of 128 (0x4300 | u = 128 + u); minus 136 gives q.
template <int J>
__device__ __forceinline__ void nibble_pairs(uint32_t w0, uint32_t w1, uint32_t& lo,
                                             uint32_t& hi) {
  constexpr uint32_t sel = J | (J << 4) | ((4 + J) << 8) | ((4 + J) << 12);
  uint32_t v, l, h;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(v) : "r"(w0), "r"(w1), "n"(sel));
  // mask ? v ^ K : K, with K = 0x4308 a half and the mask 0x000F a half
  asm("lop3.b32 %0, %1, %2, %3, 0x6c;" : "=r"(l) : "r"(v), "r"(0x43084308u), "r"(0x000F000Fu));
  asm("lop3.b32 %0, %1, %2, %3, 0x6c;" : "=r"(h) : "r"(v >> 4), "r"(0x43084308u), "r"(0x000F000Fu));
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.f, 136.f);
  __nv_bfloat162 lq = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l), off);
  __nv_bfloat162 hq = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h), off);
  lo = *reinterpret_cast<const uint32_t*>(&lq);
  hi = *reinterpret_cast<const uint32_t*>(&hq);
}

// The W packed bytes of rows r0 (w0[]) and r1 (w1[]), 4 a word, as W lo
// and W hi registers (nibble_pairs).
template <int W>
__device__ __forceinline__ void unpack(const uint32_t (&w0)[W / 4], const uint32_t (&w1)[W / 4],
                                       uint32_t (&lo)[W], uint32_t (&hi)[W]) {
#pragma unroll
  for (int wd = 0; wd < W / 4; ++wd) {
    nibble_pairs<0>(w0[wd], w1[wd], lo[4 * wd], hi[4 * wd]);
    nibble_pairs<1>(w0[wd], w1[wd], lo[4 * wd + 1], hi[4 * wd + 1]);
    nibble_pairs<2>(w0[wd], w1[wd], lo[4 * wd + 2], hi[4 * wd + 2]);
    nibble_pairs<3>(w0[wd], w1[wd], lo[4 * wd + 3], hi[4 * wd + 3]);
  }
}

// A stage: packed rows (kc/2, BN) | x rows (M, kc + 8) bf16 | scales (gpc, BN)
// bf16; the x rows are padded by 16 bytes so a warp's fragment reads hit
// distinct banks.
template <int MB, int NTL, int WN>
__host__ __device__ size_t stage_bytes(const Geo& g) {
  using C = Cfg<MB, NTL, WN>;
  return (size_t)(g.kc / 2) * C::BN + (size_t)g.M * (g.kc + 8) * 2 + (size_t)g.gpc * C::BN * 2;
}

template <int MB, int NTL, int WN>
size_t smem_bytes(const Geo& g) {
  using C = Cfg<MB, NTL, WN>;
  const size_t ring = kStages * stage_bytes<MB, NTL, WN>(g);
  const size_t red = (size_t)(C::WK + 1) * g.M * C::BN * 4;
  return ring > red ? ring : red;
}

template <int MB, int NTL, int WN>
__global__ void __launch_bounds__(kThreads)
int4_mma_kernel(const bf16* __restrict__ x,       // (M, K)
                const uint8_t* __restrict__ w4p,  // (K/2, N)
                const bf16* __restrict__ s4,      // (K/gs, N)
                bf16* __restrict__ y,             // (M, N)
                Geo g) {
  using C = Cfg<MB, NTL, WN>;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = g.cs;
  const int M = g.M, K = g.K, N = g.N, gs = g.gs, KC = g.kc, XS = KC + 8, G = K / gs;
  const int n0 = blockIdx.y * C::BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wn = warp % WN, wk = warp / WN, gl = lane >> 2, t = lane & 3;
  // this block's slice of K: whole stages, in rank order
  const int st0 = rank * g.nst / cs, nst = (rank + 1) * g.nst / cs - st0;

  extern __shared__ __align__(128) unsigned char smem[];
  const size_t wbytes = (size_t)(KC / 2) * C::BN, xbytes = (size_t)M * XS * 2;
  const size_t sbytes = stage_bytes<MB, NTL, WN>(g);
  auto w_at = [&](int slot) { return smem + slot * sbytes; };
  auto x_at = [&](int slot) { return reinterpret_cast<bf16*>(smem + slot * sbytes + wbytes); };
  auto s_at = [&](int slot) {
    return reinterpret_cast<bf16*>(smem + slot * sbytes + wbytes + xbytes);
  };

  auto load = [&](int st, int slot) {
    const int g0 = st * g.gpc, ng = min(g.gpc, G - g0), rows = ng * gs, k0 = g0 * gs;
    uint8_t* ws = w_at(slot);
    for (int i = tid; i < (rows / 2) * C::CPR; i += kThreads) {
      const int r = i / C::CPR, c = i % C::CPR, n = n0 + 16 * c;
      const uint8_t* src = w4p + (size_t)(k0 / 2 + r) * N + n;
      uint8_t* dst = ws + r * C::BN + 16 * wswz<C::CPR>(r, c);
      if (g.vec) {
        cp_async16(dst, n < N ? src : w4p, n < N);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = n + e < N ? src[e] : 0;
      }
    }
    bf16* xs = x_at(slot);
    for (int i = tid; i < M * (rows / 8); i += kThreads) {
      const int m = i / (rows / 8), c = i % (rows / 8);
      const bf16* src = x + (size_t)m * K + k0 + 8 * c;
      bf16* dst = xs + m * XS + 8 * c;
      if (g.vec) {
        cp_async16(dst, src, true);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = src[e];
      }
    }
    bf16* ss = s_at(slot);
    for (int i = tid; i < ng * (C::BN / 8); i += kThreads) {
      const int gg = i / (C::BN / 8), c = i % (C::BN / 8), n = n0 + 8 * c;
      const bf16* src = s4 + (size_t)(g0 + gg) * N + n;
      bf16* dst = ss + gg * C::BN + 8 * c;
      if (g.vec) {
        cp_async16(dst, n < N ? src : s4, n < N);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = n + e < N ? src[e] : __float2bfloat16(0.f);
      }
    }
  };

  // part: this group's dots; acc: the scaled sum over groups.  Element e of
  // tile (mb, j): output column cw + (e >> 1) * NTL + j, x row 8·mb + 2t + (e & 1).
  const int cw = wn * 16 * NTL + C::W * gl;
  float part[MB][NTL][4], acc[MB][NTL][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[mb][j][e] = acc[mb][j][e] = 0.f;

  auto flush = [&](const bf16* ss, int gi) {  // acc += part · s[group], dot then scale
    float sv[C::W];
    const bf16* sc = ss + gi * C::BN + cw;
#pragma unroll
    for (int c = 0; c < C::W; c += 2) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(sc + c));
      sv[c] = f.x;
      sv[c + 1] = f.y;
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int j = 0; j < NTL; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mb][j][e] = fmaf(part[mb][j][e], sv[(e >> 1) * NTL + j], acc[mb][j][e]);
          part[mb][j][e] = 0.f;
        }
  };

  // k-steps a group (a power of two but for odd group sizes such as 48)
  const int spg = gs / 16, spg_log2 = (spg & (spg - 1)) ? -1 : __ffs(spg) - 1;
  auto compute = [&](int st, int slot) {
    const int g0 = st * g.gpc, rows = min(g.gpc, G - g0) * gs;
    const uint8_t* ws = w_at(slot);
    const bf16* xs = x_at(slot);
    const bf16* ss = s_at(slot);
    const int c = cw / 16, o = cw % 16;
    int gcur = -1;
    for (int s = wk; s < rows / 16; s += C::WK) {
      const int gi = spg_log2 >= 0 ? s >> spg_log2 : s / spg;
      if (gi != gcur) {
        if (gcur >= 0) flush(ss, gcur);
        gcur = gi;
      }
      // packed rows r0 = 8s + t (k = 16s + 2t, +1) and r1 = r0 + 4 (k + 8).
      // The mma's k positions (2t, 2t+1, 2t+8, 2t+9) take the weights at k
      // = 16s + (2t, 2t+8, 2t+1, 2t+9): A from nibble_pairs, B permuted alike.
      constexpr int NW = C::W / 4;
      uint32_t w0[NW], w1[NW], lo[C::W], hi[C::W];
      const int r0 = 8 * s + t, r1 = r0 + 4;
      const uint8_t* p0 = ws + r0 * C::BN + 16 * wswz<C::CPR>(r0, c) + o;
      const uint8_t* p1 = ws + r1 * C::BN + 16 * wswz<C::CPR>(r1, c) + o;
      if constexpr (NW == 2) {
        const uint2 a = *reinterpret_cast<const uint2*>(p0), b = *reinterpret_cast<const uint2*>(p1);
        w0[0] = a.x; w0[1] = a.y; w1[0] = b.x; w1[1] = b.y;
      } else {
        w0[0] = *reinterpret_cast<const uint32_t*>(p0);
        w1[0] = *reinterpret_cast<const uint32_t*>(p1);
      }
      unpack<C::W>(w0, w1, lo, hi);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        // B: x rows 8·mb + g, zero from row M on (those rows are not staged)
        const bool live = 8 * mb + gl < M;
        const bf16* xr = xs + (live ? 8 * mb + gl : 0) * XS + 16 * s + 2 * t;
        const uint32_t x0 = live ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        const uint32_t x1 = live ? *reinterpret_cast<const uint32_t*>(xr + 8) : 0u;
        uint32_t b0, b1;  // (x[2t], x[2t+8]) and (x[2t+1], x[2t+9]) of the step
        asm("prmt.b32 %0, %1, %2, 0x5410;" : "=r"(b0) : "r"(x0), "r"(x1));
        asm("prmt.b32 %0, %1, %2, 0x7632;" : "=r"(b1) : "r"(x0), "r"(x1));
#pragma unroll
        for (int j = 0; j < NTL; ++j) {
          // A: rows = output columns cw + j (g) and cw + NTL + j (g + 8)
          const uint32_t a[4] = {lo[j], lo[NTL + j], hi[j], hi[NTL + j]};
          mma(part[mb][j], a, b0, b1);
        }
      }
    }
    if (gcur >= 0) flush(ss, gcur);
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < nst) load(st0 + i, i);
    cp_async_commit();
  }
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage it has landed; stage it - 1 is read by every warp
    if (it + kStages - 1 < nst) load(st0 + it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    compute(st0 + it, it % kStages);
  }
  cp_async_wait<0>();
  __syncthreads();

  // in-launch reduction, fixed order, no atomics: every warp's sums go to
  // its block's shared memory and are summed over the block's k-warps; then
  // the cluster's blocks share out the tile's elements, each summing its
  // elements over the cluster's blocks in rank order through distributed
  // shared memory
  float* part_s = reinterpret_cast<float*>(smem);  // [WK][M][BN]
  float* red = part_s + C::WK * M * C::BN;          // [M][BN]
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < NTL; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 8 * mb + 2 * t + (e & 1);
        if (m < M) part_s[(wk * M + m) * C::BN + cw + (e >> 1) * NTL + j] = acc[mb][j][e];
      }
  __syncthreads();
  for (int i = tid; i < M * C::BN; i += kThreads) {
    float sum = part_s[i];
#pragma unroll
    for (int w = 1; w < C::WK; ++w) sum += part_s[w * M * C::BN + i];
    red[i] = sum;
  }
  cluster.sync();
  const int per = (M * C::BN + cs - 1) / cs;  // elements of this block's share
  for (int i = rank * per + tid; i < min(M * C::BN, (rank + 1) * per); i += kThreads) {
    const int m = i / C::BN, n = n0 + i % C::BN;
    float v[C::kMaxCluster];
#pragma unroll
    for (int q = 0; q < C::kMaxCluster; ++q)
      v[q] = q < cs ? cluster.map_shared_rank(red, q)[i] : 0.f;
    float sum = v[0];
#pragma unroll
    for (int q = 1; q < C::kMaxCluster; ++q) sum += v[q];
    if (n < N) y[(size_t)m * N + n] = __float2bfloat16(sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int MB, int NTL, int WN>
cudaError_t launch(const void* x, const void* w4p, const void* s4, void* y, Geo g,
                   cudaStream_t stream) {
  using C = Cfg<MB, NTL, WN>;
  const int ntiles = (g.N + C::BN - 1) / C::BN;
  // split K until the grid has its blocks per SM, at most a cluster's
  // blocks and at least one stage a block
  const int want = (C::kBlocksPerSM * csm::sm_count() + ntiles - 1) / ntiles;
  g.cs = want < C::kMaxCluster ? want : C::kMaxCluster;
  if (g.cs > g.nst) g.cs = g.nst;
  if (g.cs < 1) g.cs = 1;
  cudaError_t err = csm::allow_large_clusters<int4_mma_kernel<MB, NTL, WN>>(C::kMaxCluster);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes<MB, NTL, WN>(g);
  err = csm::ensure_smem<int4_mma_kernel<MB, NTL, WN>>(smem);
  if (err != cudaSuccess) return err;
  return csm::launch_cluster(int4_mma_kernel<MB, NTL, WN>, dim3(g.cs, ntiles, 1), kThreads, smem,
                             stream, g.cs, static_cast<const bf16*>(x),
                             static_cast<const uint8_t*>(w4p), static_cast<const bf16*>(s4),
                             static_cast<bf16*>(y), g);
}

cudaError_t dispatch(const void* x, const void* w4p, const void* s4, void* y, int M, int K,
                     int N, int gs, cudaStream_t stream) {
  Geo g{M, K, N, gs, 0, 0, 0, 1, 0};
  const int G = K / gs;
  g.gpc = gs < kStageRows ? kStageRows / gs : 1;
  if (g.gpc > G) g.gpc = G;
  g.kc = g.gpc * gs;
  g.nst = (G + g.gpc - 1) / g.gpc;
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  g.vec = N % 16 == 0 && aligned(x) && aligned(w4p) && aligned(s4);
  if (M <= 8) return launch<1, 4, 1>(x, w4p, s4, y, g, stream);
  if (M <= 16) return launch<2, 4, 2>(x, w4p, s4, y, g, stream);
  if (M <= 32) return launch<4, 2, 4>(x, w4p, s4, y, g, stream);
  return launch<8, 2, 4>(x, w4p, s4, y, g, stream);
}

}  // namespace tc

}  // namespace

// x (M, K) of dtype (0 = float32, 1 = bfloat16), w4p (K/2, N) uint8,
// scale4 (K/gs, N) bf16, y (M, N) of x's dtype; all contiguous.  Takes
// 1 <= M <= 64 and an even group size gs <= 256 dividing K.  Returns the
// launch's cudaError_t.
extern "C" int csm_int4_matmul(const void* x, const void* w4p, const void* scale4, void* y,
                               int M, int K, int N, int gs, int dtype, void* stream) {
  if (M < 1 || M > 64 || N < 1 || gs < 2 || gs % 2 || gs > kMaxChunkRows || K % gs)
    return (int)cudaErrorInvalidValue;
  Shape sh{M, K, N, gs, 0, 0};
  const int G = K / gs;
  sh.gpc = kMaxChunkRows / gs;
  if (sh.gpc > kMaxChunkGroups) sh.gpc = kMaxChunkGroups;
  if (sh.gpc > G) sh.gpc = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == csm::kBFloat16 && gs % 16 == 0)
    return (int)tc::dispatch(x, w4p, scale4, y, M, K, N, gs, s);
  if (dtype == csm::kBFloat16)
    return (int)dispatch_rows<__nv_bfloat16>(x, w4p, scale4, y, sh, s);
  if (dtype == csm::kFloat32) return (int)dispatch_rows<float>(x, w4p, scale4, y, sh, s);
  return (int)cudaErrorInvalidValue;
}
