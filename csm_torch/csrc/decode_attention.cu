// Single-query GQA decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel csm_tpu/ops/decode_attention.py:_kernel (launched
// by _decode_attention_kernel, entry decode_gqa_attention): one query per
// row, softmax over a (B, T, Hkv, D) KV cache under a bool mask.
//
// What bounds it on the H100: bytes.  A step reads the live part of the K
// and V cache once (2·B·T_live·Hkv·D elements) and does 4 flops per element
// read, far below the ~295 flop/byte the card needs before its arithmetic
// is the limit.  At B=1 every main-path shape moves less than a launch
// costs (0.01-1.3 us at 3.35 TB/s), so latency sets the time: the grid must
// reach many SMs, and each block must do little serial work.
//
// Design (flash-decoding in one launch).  The grid is (splits, Hkv·HC, B):
// the `splits` blocks of one (kv head, row) form a thread-block cluster and
// share its key tiles, rank r taking tiles r·n/splits to (r+1)·n/splits of
// the n tiles; each block serves up to 4 of the G = Hq/Hkv query heads that
// share the kv head (HC = ceil(G/4) head chunks; one at every main-path
// shape), so each K/V row is read from device memory once.  The plan (key
// tile, splits) is the caller's (ops/decode_attention.py:decode_plan, from
// shapes only, so a CUDA graph can hold the launch) and is refused here if
// this kernel cannot run it.
// Masked tiles are skipped: before it loads anything a block reads its
// share's mask bytes, a warp ballot per 32 keys, into a bitmap of live
// tiles, and only those tiles are loaded or computed: a default generate
// (1189 slots, few live early on) pays for its live slots only.
// Inside a block, live tiles stream through a double-buffered cp.async ring
// in the input type.  Keys are spread over the 4 warps and D over lanes
// (D/8 lanes a key, 8 elements a lane, so a warp reads 512 contiguous bytes
// of a bf16 tile a step); q for the block's heads sits in registers,
// pre-scaled by 1/sqrt(D) and rounded to the input type as the reference
// does.  A score is reduced by warp shuffles over the key's lanes; each
// lane group runs its own online softmax in float32 over its keys, and the
// groups, then the warps, then the cluster's blocks are merged once at the
// end, each through (m, l, acc) rescaled by 2^(m_i - M) (scores in log2
// units, exp2 by the SFU): the blocks through distributed shared memory, in
// rank order, so the result is deterministic, with no second launch and no
// scratch tensor.  A split with no live key has m = -inf and l = 0 and adds
// nothing; a row with no live key anywhere writes zeros.  With one split
// (the decoder's 32-slot cache) the block writes its result itself, and the
// grid launches without the cluster attribute, which alone cost time.
//
// The int8 form (csm_decode_attention_int8) reads a QuantKV cache: int8
// codes (B, T, Hkv, D) and a float32 scale a (row, position, kv head),
// the layout of ops/kvcache.py.  Its tiles carry the codes and their
// scale column through the same ring, half the bytes of a bf16 tile, and
// are dequantized in registers as float(code) * scale rounded to q's type
// (what dequantize_kv computes), so no dense copy of the cache is made.
// The tile keeps its keys (64, or 32 at D = 128): a lane's 8 elements are
// 8 bytes, a warp-step still covers 32 / (D/8) keys, and the plan, the
// shares and the bitmap of live tiles are the float form's.  The JAX
// package sends an int8 cache to plain attention instead
// (csm_tpu/models/llama.py); XLA fuses its dequantization into the read.
#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "tc.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplits = 16;
constexpr int kWindowWords = 8;  // tiles whose liveness one pass records: 32 a word
constexpr int kWindowTiles = 32 * kWindowWords;
constexpr int kHeads = 4;        // query heads a block (with G < 4 some stay idle)

// keys a tile: 64, or 32 at D = 128 (8 KB of bf16 K either way at D >= 64)
template <int D> __host__ __device__ constexpr int tile_keys() { return D == 128 ? 32 : 64; }
template <int D> __host__ __device__ constexpr int key_words() { return kWindowTiles * tile_keys<D>() / 32; }

template <typename T>
__device__ __forceinline__ void load8(const T* src, float* dst);
template <> __device__ __forceinline__ void load8<__nv_bfloat16>(const __nv_bfloat16* src,
                                                                 float* dst) {
  csm::load_vec<__nv_bfloat16>(src, dst);
}
template <> __device__ __forceinline__ void load8<float>(const float* src, float* dst) {
  csm::load_vec<float>(src, dst);
  csm::load_vec<float>(src + 4, dst + 4);
}
// 8 int8 codes (8-byte aligned) as floats, exactly, without the
// conversion unit (a sixteenth of the FMA rate on the H100, which made it
// the int8 form's limit at serving's batches): each byte, made offset
// binary, becomes the low byte of the float 2^23 + (code + 128).
template <> __device__ __forceinline__ void load8<int8_t>(const int8_t* src, float* dst) {
  const uint2 r = *reinterpret_cast<const uint2*>(src);
  const unsigned w[2] = {r.x ^ 0x80808080u, r.y ^ 0x80808080u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    dst[e] = __uint_as_float(__byte_perm(w[e / 4], 0x4B000000u, 0x7540u | (e % 4))) - 8388736.f;
}

// x rounded to T and back: round to nearest even for bf16, done on the
// integer units (x is finite); float32 as it is.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// Eight elements of a K or V row as the attention reads them: the float
// form's as loaded; the int8 form's codes times the row's scale, rounded to
// q's type T, as ops/kvcache.py:dequantize_kv rounds them.
template <typename T, typename KV>
__device__ __forceinline__ void load_row8(const KV* src, float scale, float* dst) {
  load8<KV>(src, dst);
  if constexpr (std::is_same_v<KV, int8_t>) {
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = round_to<T>(dst[e] * scale);
  }
}

// Fold (om, ol, oa) into (m, l, acc): rescale both to the larger max
// (scores in log2 units).
__device__ __forceinline__ void merge(float& m, float& l, float (&acc)[8], float om, float ol,
                                      const float (&oa)[8]) {
  const float M = fmaxf(m, om);
  if (M == -INFINITY) return;  // both empty
  const float c1 = csm::tc::exp2_approx(m - M), c2 = csm::tc::exp2_approx(om - M);  // 0 if empty
  l = l * c1 + ol * c2;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = acc[e] * c1 + oa[e] * c2;
  m = M;
}

template <typename KV> __host__ __device__ constexpr bool quantized() { return std::is_same_v<KV, int8_t>; }

template <typename KV, int D>
size_t smem_bytes() {
  return 2 * 2 * (size_t)tile_keys<D>() * D * sizeof(KV)  // ring: 2 slots of K and V tiles
         + (quantized<KV>() ? 2 * 2 * tile_keys<D>() * sizeof(float) : 0)  // and their scales
         + (kWindowWords + key_words<D>()) * sizeof(unsigned)  // live tiles, live keys
         + (size_t)(kWarps + 1) * kHeads * (D + 2) * sizeof(float);  // warps' and block's (m, l, acc)
}

// T: q's and out's type; KV: the cache's (T, or int8 with the scales ksc/vsc)
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q,        // (B, Hq, D)
                        const KV* __restrict__ k,       // (B, T, Hkv, D)
                        const KV* __restrict__ v,       // (B, T, Hkv, D)
                        const float* __restrict__ ksc,  // (B, T, Hkv) scales of int8 k, else unused
                        const float* __restrict__ vsc,  // (B, T, Hkv) scales of int8 v
                        const bool* __restrict__ mask,  // (B|1, T)
                        T* __restrict__ out,            // (B, Hq, D)
                        int T_len, int Hq, int Hkv, long long mask_bstride, float scale) {
  constexpr int TT = tile_keys<D>();
  constexpr int LK = D / 8;                 // lanes a key
  constexpr int KW = 32 / LK;               // keys a warp-step
  constexpr int NK = TT / (kWarps * KW);    // keys a lane group takes from a tile
  constexpr int VN = csm::Vec<KV>::n;       // cache elements in 16 bytes
  constexpr int CPR = D / VN;               // 16-byte chunks a row
  constexpr bool kQuant = quantized<KV>();
  static_assert(NK >= 1 && TT % (kWarps * KW) == 0, "tile must cover whole warp-steps");
  static_assert(CPR >= 1, "a row must be whole 16-byte chunks");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int G = Hq / Hkv, HC = (G + kHeads - 1) / kHeads;
  const int kvh = blockIdx.y / HC, g0 = (blockIdx.y % HC) * kHeads, gn = min(kHeads, G - g0);
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lg = lane / LK, ld = lane % LK;  // key of the warp-step, 8-element chunk of D
  const int ntiles = (T_len + TT - 1) / TT;
  const int ta = rank * ntiles / cs, tb = (rank + 1) * ntiles / cs;
  const bool* mb = mask + (size_t)b * mask_bstride;

  extern __shared__ __align__(16) unsigned char smem[];
  KV* ring = reinterpret_cast<KV*>(smem);  // [slot][K | V][TT][D]
  float* sring = reinterpret_cast<float*>(smem + 2 * 2 * TT * D * sizeof(KV));  // [slot][K | V][TT]
  unsigned* bits = reinterpret_cast<unsigned*>(sring + (kQuant ? 2 * 2 * TT : 0));
  unsigned* key_bits = bits + kWindowWords;  // the window's keys, 32 a word
  float* wm = reinterpret_cast<float*>(key_bits + key_words<D>());  // [warp][kHeads]
  float* wl = wm + kWarps * kHeads;
  float* wacc = wl + kWarps * kHeads;                             // [warp][kHeads][D]
  float* bm = wacc + kWarps * kHeads * D;                         // [kHeads]
  float* bl = bm + kHeads;
  float* bacc = bl + kHeads;                                      // [kHeads][D]

  // this lane's 8 elements of each head's query; loaded here, scaled and
  // rounded only once the first tile's copies are in flight, so that the
  // mask scan does not wait for q
  float qr[kHeads][8];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g < gn) {
      load8<T>(q + ((size_t)b * Hq + (size_t)kvh * G + g0 + g) * D + 8 * ld, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qr[g][e] = 0.f;
    }
  }
  bool q_ready = false;
  float m[kHeads], l[kHeads], acc[kHeads][8];
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  auto load = [&](int tile, int slot) {
    const int t0 = tile * TT, n = min(TT, T_len - t0);
    KV* ks = ring + (size_t)slot * 2 * TT * D;
    KV* vs = ks + TT * D;
    for (int i = tid; i < TT * CPR; i += kThreads) {
      const int r = i / CPR, c = (i % CPR) * VN;
      const bool ok = r < n;
      const size_t off = (((size_t)b * T_len + t0 + r) * Hkv + kvh) * D + c;
      csm::tc::cp_async16(ks + r * D + c, ok ? k + off : k, ok);
      csm::tc::cp_async16(vs + r * D + c, ok ? v + off : v, ok);
    }
    if constexpr (kQuant) {  // the tile's scale column: 4 bytes a key (0 past T)
      float* kss = sring + slot * 2 * TT;
      for (int r = tid; r < TT; r += kThreads) {
        const bool ok = r < n;
        const size_t off = ((size_t)b * T_len + t0 + r) * Hkv + kvh;
        csm::tc::cp_async4(kss + r, ok ? ksc + off : ksc, ok);
        csm::tc::cp_async4(kss + TT + r, ok ? vsc + off : vsc, ok);
      }
    }
  };

  auto compute = [&](int tile, int slot, int w0) {
    const KV* ks = ring + (size_t)slot * 2 * TT * D;
    const KV* vs = ks + TT * D;
    const float* kss = sring + slot * 2 * TT;  // read only by the int8 form
    float s[NK][kHeads];
    bool live[NK];
#pragma unroll
    for (int r = 0; r < NK; ++r) {
      const int kt = r * kWarps * KW + warp * KW + lg, t = tile * TT + kt, kw = t - w0 * TT;
      live[r] = t < T_len && (key_bits[kw >> 5] >> (kw & 31)) & 1u;
      float kf[8];
      load_row8<T, KV>(ks + kt * D + 8 * ld, kQuant ? kss[kt] : 0.f, kf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) a = fmaf(qr[g][e], kf[e], a);
        s[r][g] = a;
      }
    }
#pragma unroll
    for (int o = LK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int r = 0; r < NK; ++r)
#pragma unroll
        for (int g = 0; g < kHeads; ++g) s[r][g] += __shfl_xor_sync(0xffffffffu, s[r][g], o);
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      float mt = -INFINITY;
#pragma unroll
      for (int r = 0; r < NK; ++r)
        if (live[r]) mt = fmaxf(mt, s[r][g]);
      const float mn = fmaxf(m[g], mt);
      if (mn == -INFINITY) continue;  // nothing live for this lane group yet
      const float corr = csm::tc::exp2_approx(m[g] - mn);
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
      m[g] = mn;
    }
#pragma unroll
    for (int r = 0; r < NK; ++r) {
      if (!live[r]) continue;
      const int kt = r * kWarps * KW + warp * KW + lg;
      float vf[8];
      load_row8<T, KV>(vs + kt * D + 8 * ld, kQuant ? kss[TT + kt] : 0.f, vf);
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        const float p = csm::tc::exp2_approx(s[r][g] - m[g]);
        l[g] += p;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
  };

  // the share's tiles, a window of up to kWindowTiles at a time: mark the
  // live ones, then stream those
  for (int w0 = ta; w0 < tb; w0 += kWindowTiles) {
    __syncthreads();  // every thread is done with the last window's bitmap
    if (tid < kWindowWords) bits[tid] = 0u;
    __syncthreads();
    const int key0 = w0 * TT, key1 = min(T_len, min(tb, w0 + kWindowTiles) * TT);
    for (int base = key0 + 32 * warp; base < key1; base += kThreads) {
      const int t = base + lane;  // 32 keys of one tile: TT is a multiple of 32
      const unsigned vote = __ballot_sync(0xffffffffu, t < key1 && mb[t]);
      if (lane == 0) {
        key_bits[(base - key0) >> 5] = vote;
        const int tile = (base - key0) / TT;
        if (vote) atomicOr(&bits[tile >> 5], 1u << (tile & 31));
      }
    }
    __syncthreads();
    int cur = csm::tc::next_tile(bits, kWindowWords, 0), slot = 0;
    if (cur >= 0) load(w0 + cur, 0);
    csm::tc::cp_async_commit();
    if (!q_ready) {  // scaled by 1/sqrt(D) and rounded as the reference does, then to log2 units
#pragma unroll
      for (int g = 0; g < kHeads; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          qr[g][e] = csm::to_float(csm::from_float<T>(qr[g][e] * scale)) * csm::tc::kLog2e;
      q_ready = true;
    }
    while (cur >= 0) {
      const int nxt = csm::tc::next_tile(bits, kWindowWords, cur + 1);
      if (nxt >= 0) load(w0 + nxt, slot ^ 1);
      csm::tc::cp_async_commit();
      csm::tc::cp_async_wait<1>();
      __syncthreads();  // tile cur has landed for every thread
      compute(w0 + cur, slot, w0);
      __syncthreads();  // every warp is done with slot before it is refilled
      cur = nxt;
      slot ^= 1;
    }
  }
  csm::tc::cp_async_wait<0>();

  // merge: the lane groups of a warp (shuffles), then the warps (shared
  // memory), then the cluster's blocks (distributed shared memory, in rank
  // order); every step in a fixed order
#pragma unroll
  for (int o = LK; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      const float om = __shfl_xor_sync(0xffffffffu, m[g], o);
      const float ol = __shfl_xor_sync(0xffffffffu, l[g], o);
      float oa[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) oa[e] = __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      merge(m[g], l[g], acc[g], om, ol, oa);
    }
  if (lg == 0) {
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (ld == 0) {
        wm[warp * kHeads + g] = m[g];
        wl[warp * kHeads + g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * kHeads + g) * D + 8 * ld + e] = acc[g][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < kHeads * D; i += kThreads) {
    const int g = i / D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kHeads + g]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = csm::tc::exp2_approx(wm[w * kHeads + g] - M);
        L += c * wl[w * kHeads + g];
        A += c * wacc[w * kHeads * D + i];
      }
    }
    if (cs == 1) {  // one split: this block's result is the row's
      if (g < gn)
        out[((size_t)b * Hq + (size_t)kvh * G + g0 + g) * D + i % D] =
            csm::from_float<T>(L > 0.f ? A / L : 0.f);
      continue;
    }
    bacc[i] = A;
    if (i % D == 0) {
      bm[g] = M;
      bl[g] = L;
    }
  }
  if (cs == 1) return;
  cluster.sync();
  const int per = (gn * D + cs - 1) / cs;
  for (int i = rank * per + tid; i < min(gn * D, (rank + 1) * per); i += kThreads) {
    // every rank's values read at once (the remote reads overlap), summed in
    // rank order
    const int g = i / D;
    float rm[kMaxSplits], rl[kMaxSplits], ra[kMaxSplits];
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      const bool in = r < cs;
      rm[r] = in ? cluster.map_shared_rank(bm, r)[g] : -INFINITY;
      rl[r] = in ? cluster.map_shared_rank(bl, r)[g] : 0.f;
      ra[r] = in ? cluster.map_shared_rank(bacc, r)[i] : 0.f;
    }
    float M = -INFINITY;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) M = fmaxf(M, rm[r]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float c = csm::tc::exp2_approx(rm[r] - M);
        L += c * rl[r];
        A += c * ra[r];
      }
    }
    out[((size_t)b * Hq + (size_t)kvh * G + g0 + g) * D + i % D] =
        csm::from_float<T>(L > 0.f ? A / L : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The cache's pointers: k and v (of type KV), and for int8 their scales.
struct Cache {
  const void* k;
  const void* v;
  const void* ks;
  const void* vs;
};

template <typename T, typename KV, int D>
cudaError_t launch(const void* q, Cache c, const void* mask, void* out, int B, int T_len,
                   int Hq, int Hkv, long long mask_bstride, float scale, int tile, int splits,
                   cudaStream_t stream) {
  constexpr int TT = tile_keys<D>();
  if (tile != TT || splits < 1 || splits > kMaxSplits || splits > (T_len + TT - 1) / TT)
    return cudaErrorInvalidValue;
  const int HC = (Hq / Hkv + kHeads - 1) / kHeads;
  const size_t smem = smem_bytes<KV, D>();
  cudaError_t err = csm::allow_large_clusters<decode_attention_kernel<T, KV, D>>(kMaxSplits);
  if (err != cudaSuccess) return err;
  err = csm::ensure_smem<decode_attention_kernel<T, KV, D>>(smem);
  if (err != cudaSuccess) return err;
  return csm::launch_cluster(decode_attention_kernel<T, KV, D>, dim3(splits, Hkv * HC, B), kThreads, smem, stream, splits,
                             static_cast<const T*>(q), static_cast<const KV*>(c.k),
                             static_cast<const KV*>(c.v), static_cast<const float*>(c.ks),
                             static_cast<const float*>(c.vs), static_cast<const bool*>(mask),
                             static_cast<T*>(out), T_len, Hq, Hkv, mask_bstride, scale);
}

template <typename T, typename KV>
cudaError_t dispatch_dim(int D, const void* q, Cache c, const void* mask, void* out, int B,
                         int T_len, int Hq, int Hkv, long long mask_bstride, float scale,
                         int tile, int splits, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, KV, 16>(q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, tile, splits, s);
    case 32: return launch<T, KV, 32>(q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, tile, splits, s);
    case 64: return launch<T, KV, 64>(q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, tile, splits, s);
    case 128: return launch<T, KV, 128>(q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride, scale, tile, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, 1, Hq, D), k/v (B, T, Hkv, D), mask bool (B|1, 1, T) with batch
// stride mask_bstride (0 broadcasts one row), out (B, 1, Hq, D); all
// contiguous, 16-byte aligned, of one dtype (0 = float32, 1 = bfloat16).
// (tile, splits) is ops/decode_attention.py's decode_plan; a plan this
// kernel cannot run is refused.  Returns the launch's cudaError_t.
extern "C" int csm_decode_attention(const void* q, const void* k, const void* v,
                                    const void* mask, void* out, int B, int T_len, int Hq,
                                    int Hkv, int D, long long mask_bstride, float scale,
                                    int tile, int splits, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cache c{k, v, nullptr, nullptr};
  if (dtype == csm::kBFloat16)
    return (int)dispatch_dim<__nv_bfloat16, __nv_bfloat16>(D, q, c, mask, out, B, T_len, Hq, Hkv,
                                                           mask_bstride, scale, tile, splits, s);
  if (dtype == csm::kFloat32)
    return (int)dispatch_dim<float, float>(D, q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride,
                                           scale, tile, splits, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 form: kq/vq int8 (B, T, Hkv, D), 16-byte aligned; ks/vs float32
// (B, T, Hkv, 1); q, mask, out and the plan as above, dtype q's.
extern "C" int csm_decode_attention_int8(const void* q, const void* kq, const void* ks,
                                         const void* vq, const void* vs, const void* mask,
                                         void* out, int B, int T_len, int Hq, int Hkv, int D,
                                         long long mask_bstride, float scale, int tile,
                                         int splits, int dtype, void* stream) {
  if (B < 1 || T_len < 1 || Hkv < 1 || Hq % Hkv) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Cache c{kq, vq, ks, vs};
  if (dtype == csm::kBFloat16)
    return (int)dispatch_dim<__nv_bfloat16, int8_t>(D, q, c, mask, out, B, T_len, Hq, Hkv,
                                                    mask_bstride, scale, tile, splits, s);
  if (dtype == csm::kFloat32)
    return (int)dispatch_dim<float, int8_t>(D, q, c, mask, out, B, T_len, Hq, Hkv, mask_bstride,
                                            scale, tile, splits, s);
  return (int)cudaErrorInvalidValue;
}
