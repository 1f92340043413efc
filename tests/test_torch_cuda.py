"""The port's CUDA kernels held against their plain versions on a card.

Every test here needs a CUDA card and skips without one; this file imports
neither JAX nor the JAX package, so it runs on a machine with only
PyTorch (``python -m pytest --noconftest tests/test_torch_cuda.py``, as the
README says).  Float32 agrees to 1e-5 (one rounding of float32 sums); bf16
to one bf16 ulp (rtol 2**-7, atol 1e-4 for outputs near zero), since kernel
and plain version both accumulate in float32 and round the output once.
The int4 matmul's and the matvec's atol scale with their output: 2**-8 of
the plain output's RMS in bf16, 1e-5 of it in float32.  The flash kernels
take bf16 on the tensor cores, rounding p (and ds) to bf16 as their plain
versions do, and float32 on the CUDA cores.  The bf16 forward rounds
p = exp(s - m) against the running row max, its plain version against the
final one, so each O element is also allowed FWD_P_SHARE of the
root-sum-square of the terms it sums (``fwd_rounding_allowance`` in
``csm_torch.ops.flash_attention``).  The int4
kernel takes bf16 with groups of a multiple of 16 rows on the tensor cores
(K split across a cluster's blocks, reduced in the launch) and everything
else on the CUDA cores.  Decode attention splits T across a cluster and
skips key tiles whose mask is all False, and the matvec splits K across a
cluster, both merged in rank order in the launch: their tests cover masks
and K that hit those splits unevenly, and hold both kernels to give the
same bytes on every launch and under CUDA-graph replay.
"""

import numpy as np
import pytest
import torch

from csm_torch.ops import decode_attention as tdec
from csm_torch.ops import flash_attention as tfa
from csm_torch.ops import int4_matmul as tint4
from csm_torch.ops import matvec as tmv
from csm_torch.utils.quantize import quantize_weight_int4

PAD = 1 << 28
def assert_fwd_close(o, lse, q, k, v, q_pos, kv_pos):
    """The forward's O and L against the plain version: float32 to 1e-5; bf16
    to one bf16 ulp plus the rounding allowance of p; L to 1e-4."""
    o_p, lse_p = tfa.flash_attention_plain(q, k, v, q_pos, kv_pos)
    if q.dtype == torch.float32:
        torch.testing.assert_close(o, o_p, atol=1e-5, rtol=1e-5)
    else:
        tol = tfa.fwd_rounding_allowance(q, k, v, q_pos, kv_pos) + 1e-4 + 2**-7 * o_p.float().abs()
        err = (o.float() - o_p.float()).abs()
        assert torch.isfinite(o.float()).all() and (err <= tol).all(), (
            f"max |kernel - plain| {err.max().item():.3e}, {(err / tol).max().item():.2f}x the tolerance")
    torch.testing.assert_close(lse, lse_p, atol=1e-4, rtol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _decode_inputs(B, Hq, Hkv, D, T, seed=0):
    """q/k/v plus a per-row causal mask; the last row is fully masked."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    pos = rng.integers(T // 2, T, B)
    mask = np.arange(T)[None, None, :] <= pos[:, None, None]
    mask[-1] = False
    return q, k, v, mask


def _flash_inputs(S, T, lens, Hq=4, Hkv=1, D=64, seed=0):
    """Main-path prefill layout: row b holds lens[b] real tokens then
    PAD_POS rows; the cache's first S slots carry those positions and the
    rest are unwritten (PAD_POS).  A row with lens = 0 has q_pos = -1
    everywhere: it sees no key at all."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    col = np.arange(S)
    q_pos = np.stack([np.where(col < n, col, PAD if n else -1) for n in lens]).astype(np.int32)
    kv_pos = np.full((B, T), PAD, np.int32)
    kv_pos[:, :S] = np.where(q_pos >= 0, q_pos, col)
    return q, k, v, q_pos, kv_pos


def decode_pattern_mask(pattern, B, T):
    """Masks (B, 1, T), or (1, 1, T) for "shared", that exercise the decode
    kernel's split of T and its skipping of masked key tiles:

      causal      each row live up to a random length >= T/2, the last row
                  dead (``_decode_inputs``'s mask);
      full        every key live;
      mid_tiles   every key live but the whole 64-key tiles of keys
                  128-383 (the middle of a long cache);
      last_split  only the last 40 keys live (in the last split at T=1189);
      live89      only the first 89 keys live (a default generate's 1189
                  slots, 25 frames in);
      shared      one (1, 1, T) row live up to 2T/3, broadcast to every row;
      dead        row 0 sees no key (zeros), the others the first T/2."""
    t = np.arange(T)[None, None, :]
    if pattern == "causal":
        return _decode_inputs(B, 1, 1, 8, T)[3]
    if pattern == "shared":
        return t < (2 * T) // 3
    mask = {
        "full": np.ones((1, 1, T), bool),
        "mid_tiles": (t < 128) | (t >= 384),
        "last_split": t >= T - 40,
        "live89": t < 89,
        "dead": t < T // 2,
    }[pattern]
    mask = np.broadcast_to(mask, (B, 1, T)).copy()
    if pattern == "dead":
        mask[0] = False
    return mask


# (B, Hq, Hkv, D, T, mask pattern): the backbone's heads at every cache
# length a generate attends, the decoder's (Hq=8, Hkv=2, D=128, T=32) at
# B = 1 and 2, and the other head dims
DECODE_CASES = [(1, 32, 8, 64, 89, "full"), (2, 32, 8, 64, 1189, "causal"),
                (2, 8, 2, 128, 32, "causal"), (2, 4, 2, 16, 70, "causal"),
                (1, 32, 8, 64, 1189, "mid_tiles"), (2, 4, 2, 32, 500, "mid_tiles"),
                (1, 32, 8, 64, 1189, "last_split"), (2, 32, 8, 64, 1189, "last_split"),
                (1, 32, 8, 64, 1189, "live89"), (2, 32, 8, 64, 2048, "live89"),
                (1, 8, 2, 128, 32, "full"), (2, 32, 8, 64, 281, "shared"),
                (2, 32, 8, 64, 89, "dead"), (1, 8, 2, 128, 32, "dead")]


def _decode_case(B, Hq, Hkv, D, T, pattern, dev, dtype, seed=0):
    q, k, v, _ = _decode_inputs(B, Hq, Hkv, D, T, seed)
    mask = torch.from_numpy(decode_pattern_mask(pattern, B, T)).to(dev)
    return (*(torch.from_numpy(x).to(dev, dtype) for x in (q, k, v)), mask)


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 2**-7)])
@pytest.mark.parametrize("B,Hq,Hkv,D,T,pattern", DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, dtype, atol, rtol, B, Hq, Hkv, D, T, pattern):
    q, k, v, mask = _decode_case(B, Hq, Hkv, D, T, pattern, cuda, dtype)
    n = tdec.launches
    got = tdec.decode_gqa_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert tdec.launches == n + 1
    want = tdec.decode_attention_plain(q, k, v, mask)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    dead = ~mask.expand(B, 1, T)[:, 0].any(-1)
    assert not got[dead].any()  # a row with no live key gives zeros


@pytest.mark.parametrize("T,pattern", [(1189, "live89"), (1189, "full"), (32, "full")])
def test_decode_kernel_is_deterministic_and_replays_in_a_graph(cuda, T, pattern):
    """The cluster's partial softmaxes are merged in a fixed order: two
    launches give the same bytes, and one launch captured in a CUDA graph
    and replayed gives the eager bytes.  The wrapper counts the captured
    launch; replays run the kernel without it."""
    Hq, Hkv, D = (32, 8, 64) if T > 32 else (8, 2, 128)
    q, k, v, mask = _decode_case(1, Hq, Hkv, D, T, pattern, cuda, torch.bfloat16)
    a = tdec.decode_gqa_attention(q, k, v, mask)  # also the warm-up: attributes set outside capture
    b = tdec.decode_gqa_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    n = tdec.launches
    with torch.cuda.graph(graph):
        out = tdec.decode_gqa_attention(q, k, v, mask)
    assert tdec.launches == n + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert tdec.launches == n + 1 and torch.equal(out, a)


def int8_decode_mask(pattern, B, T, seed=0):
    """Masks (B, 1, T) of the int8 cache's main paths, beside
    ``decode_pattern_mask``'s:

      serving  a serving batch: rows live up to 48-111 keys of the cache,
               the last row dead;
      ring     a full sliding-window ring (anchor T - 256): row b's prompt
               of 1000 - 9·b positions, its latest 256 frames wrapped over
               the ring (positions out of column order), rows 0 and 2
               re-anchored (negative positions), the last row dead."""
    rng = np.random.default_rng(seed)
    if pattern == "serving":
        mask = np.arange(T)[None, None, :] < rng.integers(48, 112, B)[:, None, None]
        mask[-1] = False
        return mask
    if pattern != "ring":
        return decode_pattern_mask(pattern, B, T)
    anchor = T - 256
    kv_pos = np.full((B, T), PAD, np.int64)
    q_pos = np.zeros(B, np.int64)
    for b in range(B):
        prompt, frames, delta = 1000 - 9 * b, 300 + 97 * b, 1100 if b in (0, 2) else 0
        kv_pos[b, :prompt] = np.arange(prompt) - delta
        t = np.arange(frames - 256, frames)
        kv_pos[b, anchor + t % 256] = prompt + t - delta
        q_pos[b] = prompt + frames - 1 - delta
    mask = (kv_pos <= q_pos[:, None])[:, None]
    mask[-1] = False
    return mask


# (B, Hq, Hkv, D, T, mask pattern) of an int8 cache: generation at T=89,
# serving's ragged batch of 8, the 1280-column ring, the decoder's and the
# small head dims
INT8_CASES = [(1, 32, 8, 64, 89, "full"), (8, 32, 8, 64, 1024, "serving"),
              (8, 32, 8, 64, 1280, "ring"), (2, 32, 8, 64, 1189, "live89"),
              (2, 8, 2, 128, 32, "causal"), (2, 4, 2, 16, 70, "causal")]


def _int8_case(B, Hq, Hkv, D, T, pattern, dev, dtype, seed=0):
    from csm_torch.ops.kvcache import quantize_kv_rows

    q, k, v, _ = _decode_inputs(B, Hq, Hkv, D, T, seed)
    kq, vq = (quantize_kv_rows(torch.from_numpy(x).to(dev)) for x in (k, v))
    mask = torch.from_numpy(int8_decode_mask(pattern, B, T, seed)).to(dev)
    return torch.from_numpy(q).to(dev, dtype), kq, vq, mask


@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 1e-5, 1e-5), (torch.bfloat16, 1e-4, 2**-7)])
@pytest.mark.parametrize("B,Hq,Hkv,D,T,pattern", INT8_CASES)
def test_decode_int8_kernel_matches_plain(cuda, dtype, atol, rtol, B, Hq, Hkv, D, T, pattern):
    """The int8 form against ``decode_attention_int8_plain`` (the cache
    dequantized to q's dtype, then the plain attention), with the float
    form's tolerances: both dequantize each element to the same value and
    differ only in the order of their float32 sums.  It counts apart from
    the float form."""
    q, kq, vq, mask = _int8_case(B, Hq, Hkv, D, T, pattern, cuda, dtype)
    n, n8 = tdec.launches, tdec.int8_launches
    got = tdec.decode_gqa_attention(q, kq, vq, mask)
    torch.cuda.synchronize()
    assert (tdec.launches, tdec.int8_launches) == (n, n8 + 1)
    want = tdec.decode_attention_int8_plain(q, kq.q, kq.s, vq.q, vq.s, mask)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    dead = ~mask.expand(B, 1, T)[:, 0].any(-1)
    assert not got[dead].any()


def test_decode_int8_kernel_is_deterministic_and_replays_in_a_graph(cuda):
    q, kq, vq, mask = _int8_case(8, 32, 8, 64, 1280, "ring", cuda, torch.bfloat16)
    a = tdec.decode_gqa_attention(q, kq, vq, mask)
    b = tdec.decode_gqa_attention(q, kq, vq, mask)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tdec.decode_gqa_attention(q, kq, vq, mask)
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,lens,Hq,Hkv,D", [(256, (200, 0), 32, 8, 64), (300, (131,), 4, 2, 16),
                                             (64, (64,), 8, 2, 128)])
def test_flash_kernel_matches_plain(cuda, dtype, S, lens, Hq, Hkv, D):
    q, k, v, q_pos, kv_pos = (torch.from_numpy(x).to(cuda)
                              for x in _flash_inputs(S, S + 25, lens, Hq, Hkv, D))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    n = tfa.launches
    o, lse = tfa.flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    assert tfa.launches == n + 1
    assert_fwd_close(o, lse, q, k, v, q_pos, kv_pos)


@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_flash_fwd_bf16_tensor_cores(cuda, D):
    """bf16 at every head dim: ragged S (300 rows: 4.7 stacked-row blocks),
    PAD_POS rows (which attend every slot up to PAD_POS), and a row with no
    visible key (zeros, L = 1e30)."""
    q, k, v, q_pos, kv_pos = (torch.from_numpy(x).to(cuda)
                              for x in _flash_inputs(300, 325, (300, 131, 0), 8, 2, D, seed=D))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    o, lse = tfa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    assert_fwd_close(o, lse, q, k, v, q_pos, kv_pos)
    assert not o[2].any() and (lse[2] == tfa.L_EMPTY).all()
    pad = q_pos == PAD
    assert pad.any() and o[pad].abs().amax() > 0


def test_flash_fwd_bf16_s_below_t_with_per_row_kv_pos(cuda):
    """S < T (the queries are the last 200 of 300 positions) with a (B, T)
    kv_pos whose rows mark other slots dead, at the training shape's heads."""
    q, k, v, q_pos, kv_pos, *_ = _bwd_inputs(200, 300, 32, 8, 64, 2, cuda, torch.bfloat16)
    o, lse = tfa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    assert_fwd_close(o, lse, q, k, v, q_pos, kv_pos)


def test_flash_fwd_float32_stays_on_cuda_cores(cuda):
    """float32 at the training shape agrees with the plain version to 1e-5:
    the CUDA-core route.  Inputs rounded to bf16 (or TF32) for a tensor core
    would miss by ~1e-3."""
    q, k, v, q_pos, kv_pos, *_ = _bwd_inputs(512, 512, 32, 8, 64, 1, cuda, torch.float32)
    o, lse = tfa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    assert_fwd_close(o, lse, q, k, v, q_pos, kv_pos)


def test_wrappers_refuse_a_card_tensor_they_cannot_take(cuda):
    """On a card there is no plain fallback: what the kernel does not take
    raises."""
    q, k, v, mask = (torch.from_numpy(x).to(cuda) for x in _decode_inputs(1, 4, 2, 16, 8))
    with pytest.raises(ValueError, match="contiguous"):
        tdec.decode_gqa_attention(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, mask)
    with pytest.raises(ValueError, match="on"):
        tdec.decode_gqa_attention(q, k.cpu(), v, mask)


def _int4_inputs(M, K, N, gs, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) / K**0.5)
    q = quantize_weight_int4(w.to(dev), gs)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev, dtype)
    return x, q


@pytest.mark.parametrize("dtype,rel_atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                                 (torch.bfloat16, 2**-8, 2**-7)])
@pytest.mark.parametrize("M,K,N,gs", [(1, 2048, 3072, 128), (2, 2048, 16384, 128),
                                      (64, 8192, 2048, 128), (17, 1024, 640, 64),
                                      (3, 96, 200, 32), (5, 512, 1000, 256), (1, 64, 24, 2)])
def test_int4_kernel_matches_plain(cuda, dtype, rel_atol, rtol, M, K, N, gs):
    """Main-path shapes, rows handled four to a thread (M=17, 64), ragged
    and unaligned N (200, 1000, 24: the byte path) and group sizes 2-256."""
    x, q = _int4_inputs(M, K, N, gs, cuda, dtype)
    n = tint4.launches
    got = tint4.fused_int4_matmul(x, q)
    torch.cuda.synchronize()
    assert tint4.launches == n + 1 and got.dtype == dtype and got.shape == (M, N)
    want = tint4.int4_matmul_plain(x, q)
    rms = want.float().pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), want.float(), atol=rel_atol * rms, rtol=rtol)


def _int4_check(M, K, N, gs, dev, x=None):
    """bf16 kernel against the plain version (one bf16 ulp plus 2**-8 of
    the output's RMS); returns the kernel's output."""
    x0, q = _int4_inputs(M, K, N, gs, dev, torch.bfloat16, seed=M + K + N + gs)
    x = x0 if x is None else x.copy_(x0)
    got = tint4.fused_int4_matmul(x, q)
    torch.cuda.synchronize()
    want = tint4.int4_matmul_plain(x, q)
    rms = want.float().pow(2).mean().sqrt().item()
    assert rms > 0 and got.shape == (M, N)
    torch.testing.assert_close(got.float(), want.float(), atol=2**-8 * rms, rtol=2**-7)
    return got


@pytest.mark.parametrize("M", [1, 2])
@pytest.mark.parametrize("K,N", [(1024, 1536), (1024, 1024), (8192, 1024), (1024, 16384)])
def test_int4_kernel_decoder_shapes(cuda, M, K, N):
    """The CSM-1B decoder's wqkv, wo, w2 and w13 at M = 1 and 2: 496 of the
    560 int4 launches of a frame."""
    _int4_check(M, K, N, 128, cuda)


@pytest.mark.parametrize("M", [1, 2, 16, 17, 33, 64])
def test_int4_kernel_every_row_tiling(cuda, M):
    """Each row tiling of the tensor-core route: one 8-row x tile (M <= 8),
    two, four and eight."""
    _int4_check(M, 2048, 3072, 128, cuda)


@pytest.mark.parametrize("K", [1920, 2176])
def test_int4_kernel_uneven_split(cuda, K):
    """K in 15 and 17 stages of 128 rows at N = 1024 (16 column tiles): a
    cluster of 15 blocks, one stage each, and one of 16 blocks whose slices
    are of unequal length."""
    _int4_check(1, K, 1024, 128, cuda)


@pytest.mark.parametrize("N", [200, 1000, 640, 24])
def test_int4_kernel_ragged_and_unaligned(cuda, N):
    """N not a multiple of a block's columns (640), nor of 16 (200, 1000, 24:
    plain loads into the ring); then x at an address that is not 16-byte
    aligned."""
    _int4_check(3, 256, N, 32, cuda)
    x = torch.empty(3 * 256 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(3, 256)
    _int4_check(3, 256, N, 32, cuda, x=x)


@pytest.mark.parametrize("gs", [2, 32, 128, 256])
def test_int4_kernel_group_sizes(cuda, gs):
    """gs = 2 takes the CUDA-core route (a group smaller than one mma
    k-step); 32, 128 and 256 the tensor cores (a stage of 4, 1 and 1
    groups)."""
    _int4_check(5, 1024, 512, gs, cuda)


def test_int4_kernel_is_deterministic(cuda):
    """The split of K is reduced in a fixed order: two calls give the same
    bytes."""
    x, q = _int4_inputs(1, 2048, 16384, 128, cuda, torch.bfloat16)
    a = tint4.fused_int4_matmul(x, q)
    b = tint4.fused_int4_matmul(x, q)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_int4_routes_on_rows(cuda):
    """int4_matmul sends M <= 64 rows to the kernel and more rows to
    dequant + matmul; a layer slice of a stacked weight goes in as it is."""
    x, q = _int4_inputs(65, 256, 128, 64, cuda, torch.bfloat16)
    stacked = {k: torch.stack([v, v]) for k, v in q.items()}
    layer = {k: v[1] for k, v in stacked.items()}
    n, d = tint4.launches, tint4.dequant_calls
    tint4.int4_matmul(x[:64].reshape(2, 32, 256), layer)
    assert (tint4.launches, tint4.dequant_calls) == (n + 1, d)
    tint4.int4_matmul(x, layer)
    assert (tint4.launches, tint4.dequant_calls) == (n + 1, d + 1)


def test_int4_kernel_refuses_what_it_cannot_take(cuda):
    x, q = _int4_inputs(2, 512, 256, 128, cuda, torch.bfloat16)
    with pytest.raises(ValueError, match="M <= 64"):
        tint4.fused_int4_matmul(torch.cat([x] * 33), q)
    with pytest.raises(ValueError, match="contiguous"):
        tint4.fused_int4_matmul(x.t().contiguous().t(), q)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tint4.fused_int4_matmul(x.half(), q)
    with pytest.raises(ValueError, match="scale4"):
        tint4.fused_int4_matmul(x, dict(q, scale4=q["scale4"].float()))
    with pytest.raises(ValueError, match="group size"):
        x1, q1 = _int4_inputs(1, 512, 256, 512, cuda, torch.bfloat16)
        tint4.fused_int4_matmul(x1, q1)
    with pytest.raises(ValueError, match="on"):
        tint4.fused_int4_matmul(x, dict(q, w4p=q["w4p"].cpu()))


def _bwd_inputs(S, T, Hq, Hkv, D, kv_rows, dev, dtype, seed=0, B=2):
    """Backward inputs: the queries are the last S of T positions; with
    kv_rows = 2 each row's (B, T) kv_pos marks a few slots dead (PAD_POS),
    never slot 0, so every row sees a key.  out and lse from the plain
    forward in float32 (p unrounded), out then cast to dtype."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, dtype)  # noqa: E731
    q, k, v, g = f(B, S, Hq, D), f(B, T, Hkv, D), f(B, T, Hkv, D), f(B, S, Hq, D)
    q_pos = torch.arange(T - S, T, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev).expand(B, T).contiguous()
    if kv_rows == 2:
        for b in range(B):
            kv_pos[b, torch.from_numpy(rng.choice(np.arange(1, T), 7 * (b + 1), replace=False))] = PAD
    else:
        kv_pos = kv_pos[0].contiguous()
    out, lse = tfa.flash_attention_plain(q.float(), k.float(), v.float(), q_pos, kv_pos)
    out = out.to(dtype)
    g_lse = torch.from_numpy(rng.standard_normal((B, Hq, S)).astype(np.float32)).to(dev)
    return q, k, v, q_pos, kv_pos, out, lse, g, g_lse


@pytest.mark.parametrize("dtype,rel_atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                                 (torch.bfloat16, 2**-8, 2**-7)])
@pytest.mark.parametrize("S,T,Hq,Hkv,D,kv_rows,with_lse", [
    (256, 256, 32, 8, 64, 1, False),  # the training shape's heads, (T,) kv_pos
    (300, 300, 4, 2, 16, 2, True),    # ragged S = T, (B, T) kv_pos, an LSE cotangent
    (200, 300, 8, 2, 128, 2, False),  # S < T, D = 128 (the largest tiles)
    (70, 130, 4, 1, 32, 1, True),     # one kv head for four query heads
])
def test_flash_bwd_kernels_match_plain(cuda, dtype, rel_atol, rtol, S, T, Hq, Hkv, D, kv_rows,
                                       with_lse):
    """Both backward kernels against the plain version; the atol scales with
    each gradient's RMS (1e-5 of it in float32, 2**-8 in bf16, where the
    kernel and the plain version round the float32 sums to bf16 once)."""
    q, k, v, q_pos, kv_pos, out, lse, g, g_lse = _bwd_inputs(S, T, Hq, Hkv, D, kv_rows, cuda,
                                                             dtype)
    delta = tfa.bwd_delta(out, g, g_lse if with_lse else None)
    n = (tfa.dq_launches, tfa.dkv_launches)
    dq = tfa.flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta)
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse, delta)
    torch.cuda.synchronize()
    assert (tfa.dq_launches, tfa.dkv_launches) == (n[0] + 1, n[1] + 1)
    want = tfa.flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, g,
                                         g_lse if with_lse else None)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == dtype, name
        rms = ref.float().pow(2).mean().sqrt().item()
        torch.testing.assert_close(got.float(), ref.float(), atol=rel_atol * rms, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_autograd_launches_the_kernels(cuda):
    """On a card the autograd Function's forward and backward go through the
    kernels (one launch each), with a non-contiguous cotangent."""
    q, k, v, q_pos, kv_pos, *_ = _bwd_inputs(256, 256, 8, 2, 64, 1, cuda, torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    n = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    out = tfa.flash_gqa_attention(q, k, v, q_pos, kv_pos)
    g = torch.randn(out.shape[::-1], device=cuda, dtype=out.dtype).permute(3, 2, 1, 0)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == (n[0] + 1, n[1] + 1, n[2] + 1)
    assert all(torch.isfinite(x.float()).all() for x in grads)


def _matvec_inputs(K, N, dev, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.standard_normal((K, N)) / K**0.5).astype(np.float32)).to(dev, dtype)
    return x, w


@pytest.mark.parametrize("dtype,rel_atol,rtol", [(torch.float32, 1e-5, 1e-5),
                                                 (torch.bfloat16, 2**-8, 2**-7)])
@pytest.mark.parametrize("K,N", [(2048, 3072), (2048, 2048), (2048, 16384), (8192, 2048),
                                 (8192, 384), (37, 1000), (300, 8), (2080, 2048), (4000, 3072),
                                 (1000, 16384), (8288, 384)])
def test_matvec_kernel_matches_plain(cuda, dtype, rel_atol, rtol, K, N):
    """The CSM-1B backbone's four projections, a narrow N, a ragged K and
    N = 8 (one span, partly live), and K that the plan splits unevenly over
    its cluster (65 stages over 16 blocks, 125 over 11, a last stage of 8
    rows, 259 stages over 16)."""
    x, w = _matvec_inputs(K, N, cuda, dtype)
    n = tmv.launches
    got = tmv.matvec(x, w)
    torch.cuda.synchronize()
    assert tmv.launches == n + 1 and got.dtype == dtype and got.shape == (1, N)
    want = tmv.matvec_plain(x, w)
    rms = want.float().pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), want.float(), atol=rel_atol * rms, rtol=rtol)


@pytest.mark.parametrize("K,N", [(2048, 16384), (4000, 3072)])
def test_matvec_kernel_is_deterministic_and_replays_in_a_graph(cuda, K, N):
    """The split of K is reduced in rank order: two launches give the same
    bytes, and one launch captured in a CUDA graph and replayed gives the
    eager bytes.  The wrapper counts the captured launch, not replays."""
    x, w = _matvec_inputs(K, N, cuda, torch.bfloat16)
    a = tmv.matvec(x, w)  # also the warm-up: attributes set outside capture
    b = tmv.matvec(x, w)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    graph = torch.cuda.CUDAGraph()
    n = tmv.launches
    with torch.cuda.graph(graph):
        out = tmv.matvec(x, w)
    assert tmv.launches == n + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert tmv.launches == n + 1 and torch.equal(out, a)


def test_matvec_kernel_refuses_what_it_cannot_take(cuda):
    x, w = torch.ones(1, 64, device=cuda), torch.ones(64, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        tmv.matvec(x, w[:, :12].contiguous())
    with pytest.raises(ValueError, match="on"):
        tmv.matvec(x, w.cpu())
    with pytest.raises(ValueError, match="16-byte aligned"):
        tmv.matvec(torch.ones(1, 65, device=cuda)[:, 1:], w)


def _bwd_check(S, T, Hq, Hkv, D, dtype, rel_atol, rtol, B=2):
    q, k, v, q_pos, kv_pos, out, lse, g, _ = _bwd_inputs(S, T, Hq, Hkv, D, 1, "cuda", dtype, B=B)
    delta = tfa.bwd_delta(out, g)
    got = (tfa.flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta),
           *tfa.flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse, delta))
    torch.cuda.synchronize()
    want = tfa.flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, g)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        rms = b.float().pow(2).mean().sqrt().item()
        assert rms > 0, name
        torch.testing.assert_close(a.float(), b.float(), atol=rel_atol * rms, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")


def test_flash_bwd_bf16_long_d128(cuda):
    """bf16 on the tensor cores at D = 128 and S = T = 2048: 32 key tiles
    and 128 stacked-row tiles a kv head, causal skipping over most of them."""
    _bwd_check(2048, 2048, 8, 2, 128, torch.bfloat16, 2**-8, 2**-7, B=1)


def test_flash_bwd_float32_stays_on_cuda_cores(cuda):
    """float32 at the training shape's heads agrees with the plain version to
    1e-5 of each gradient's RMS: the CUDA-core route.  Inputs rounded to bf16
    (or TF32) for a tensor core would miss by ~1e-3."""
    _bwd_check(512, 512, 32, 8, 64, torch.float32, 1e-5, 1e-5)


# ---------------------------------------------------------------- CUDA graphs


@pytest.mark.parametrize("M,K,N", [(1, 2048, 16384), (2, 1024, 1536), (64, 2048, 3072)])
def test_int4_kernel_replays_in_a_graph(cuda, M, K, N):
    """A cluster launch captured in a CUDA graph and replayed gives the
    eager bytes: one decode row, the decoder's S=2 call and a 64-row
    prefill.  The wrapper counts the captured launch, not the replay."""
    x, q = _int4_inputs(M, K, N, 128, cuda, torch.bfloat16)
    a = tint4.fused_int4_matmul(x, q)  # also the warm-up: attributes set outside capture
    graph = torch.cuda.CUDAGraph()
    n = tint4.launches
    with torch.cuda.graph(graph):
        out = tint4.fused_int4_matmul(x, q)
    assert tint4.launches == n + 1
    out.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert tint4.launches == n + 1 and torch.equal(out, a)


@pytest.mark.parametrize("lens", [(200,), (200, 150)])
def test_flash_fwd_replays_in_a_graph(cuda, lens):
    """The prefill's flash forward (bucket 256 over a 281-slot cache)
    captured and replayed gives the eager bytes of O and L."""
    q, k, v, q_pos, kv_pos = (torch.from_numpy(x).to(cuda)
                              for x in _flash_inputs(256, 281, lens, 32, 8, 64))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    a, la = tfa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    graph = torch.cuda.CUDAGraph()
    n = tfa.launches
    with torch.cuda.graph(graph):
        out, lse = tfa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    out.zero_()
    lse.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert tfa.launches == n + 1 and torch.equal(out, a) and torch.equal(lse, la)


def _tiny_generation(dev, mode, bucket):
    """A tiny bf16 CSM on the card (int4 at group 32), fused, with a 512-slot
    backbone for the 256 bucket."""
    import dataclasses

    from csm_torch.models import config
    from csm_torch.models.csm import fuse_csm_params
    from csm_torch.utils.params import cast_params, random_csm_params
    from csm_torch.utils.quantize import quantize_csm_params_int4

    args = config.tiny_test_args()
    if bucket > 128:
        args = dataclasses.replace(
            args, backbone_config=dataclasses.replace(args.backbone, max_seq_len=512))
    params = cast_params(random_csm_params(args, seed=0, device=dev), torch.bfloat16)
    if mode == "int4":
        params = quantize_csm_params_int4(params, group_size=32)
    return args, fuse_csm_params(params)


def _tiny_prompts(args, B, bucket, dev, seed=3):
    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    lens = np.asarray([bucket - 10, bucket - 40][:B], np.int32)
    tokens = np.zeros((B, bucket, K + 1), np.int32)
    mask = np.zeros((B, bucket, K + 1), bool)
    for b, n in enumerate(lens):
        tokens[b, :n, -1] = rng.integers(1, args.text_vocab_size, n)
        mask[b, :n, -1] = True
    return tuple(torch.from_numpy(x).to(dev) for x in (tokens, mask, lens))


@pytest.mark.parametrize("bucket", [64, 256])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("mode", ["bf16", "int4", "kv_int8"])
def test_generation_graphs_match_eager(cuda, mode, B, bucket):
    """The graphed entry (capture, then replays) against the eager loop on
    one seed: codes equal at topk=1 and at topk=50, and a second call on the
    captured graphs gives them again."""
    from csm_torch.models import generation as tgen

    args, params = _tiny_generation(cuda, mode, bucket)
    prompts = _tiny_prompts(args, B, bucket, cuda)
    for topk in (1, 50):
        kw = dict(max_frames=tgen.CHUNK + 3, temperature=0.9, topk=topk,
                  compute_dtype=torch.bfloat16, device=cuda,
                  kv_dtype=torch.int8 if mode == "kv_int8" else None)
        eager = tgen.generate_audio_tokens(
            params, args, *prompts, generator=torch.Generator(cuda).manual_seed(5), **kw)
        cache = tgen.GraphCache()
        runs = [tgen.generate_audio_tokens_jit(
            params, args, *prompts, generator=torch.Generator(cuda).manual_seed(5), graphs=cache,
            **kw) for _ in range(2)]
        assert runs[0].capture_s > 0 and runs[1].capture_s == 0
        for r in runs:
            assert torch.equal(r.frames, eager.frames), f"topk={topk}"
            assert torch.equal(r.num_frames, eager.num_frames)
        cache.clear()


def test_one_frame_generation_captures_the_prefill_only(cuda, monkeypatch):
    """At ``max_frames`` 1 the frame step never runs: only the prefill is
    warmed up and captured (a step would write past the one-frame buffer),
    and the graphed entry and ``Generator.generate`` give the eager loop's
    frame."""
    from csm_torch import generator as tgenr
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.models import generation as tgen

    args, params = _tiny_generation(cuda, "bf16", 64)
    prompts = _tiny_prompts(args, 2, 64, cuda)
    kw = dict(max_frames=1, compute_dtype=torch.bfloat16, device=cuda)
    eager = tgen.generate_audio_tokens(
        params, args, *prompts, generator=torch.Generator(cuda).manual_seed(5), **kw)
    cache = tgen.GraphCache()
    for _ in range(2):
        r = tgen.generate_audio_tokens_jit(
            params, args, *prompts, generator=torch.Generator(cuda).manual_seed(5), graphs=cache,
            **kw)
        assert r.steps == 0 and torch.equal(r.frames, eager.frames)
        assert torch.equal(r.num_frames, eager.num_frames)
    (fg,) = cache._items.values()
    assert len(fg.graphs) == 1
    cache.clear()
    torch.cuda.synchronize()

    g = tgenr.load_csm(args=args, compute_dtype=torch.bfloat16, device=cuda,
                       text_tokenizer=ByteTokenizer())
    graphed = g.generate("hello there", max_audio_length_ms=80, seed=3)
    assert g.last_stats["steps"] == 0 and g.last_stats["capture_s"] > 0
    monkeypatch.setattr(tgenr, "generate_audio_tokens_jit",
                        lambda *a, graphs=None, **k: tgen.generate_audio_tokens(*a, **k))
    np.testing.assert_array_equal(graphed, g.generate("hello there", max_audio_length_ms=80, seed=3))
    g.close()
    torch.cuda.synchronize()


def test_replays_add_the_captured_launch_counts(cuda):
    """Each graph records the kernel launches its capture saw; the capture
    itself leaves the counters as they were, and every replay adds its
    graph's counts: after a generate of N steps the counters moved by the
    prefill's counts plus N times the step's."""
    from csm_torch.models import generation as tgen

    args, params = _tiny_generation(cuda, "int4", 64)
    prompts = _tiny_prompts(args, 1, 64, cuda)
    kw = dict(max_frames=2 * tgen.CHUNK + 2, compute_dtype=torch.bfloat16, device=cuda)
    cache = tgen.GraphCache()
    tgen.generate_audio_tokens_jit(params, args, *prompts, graphs=cache, **kw)
    (fg,) = cache._items.values()
    (_, prefill), (_, step) = fg.graphs
    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    int4_frame = 4 * L_bb + 4 * L_dec * (K - 1)  # the 64-row prefill takes the kernel too
    # counters: decode, flash forward, int4, int4 dequant route, decode's int8 form
    assert step == [L_bb + (K - 2) * L_dec, 0, int4_frame, 0, 0]
    assert prefill == [(K - 2) * L_dec, 0, int4_frame, 0, 0]
    before = tgen._counts()
    res = tgen.generate_audio_tokens_jit(params, args, *prompts, graphs=cache, **kw)
    torch.cuda.synchronize()
    assert res.capture_s == 0 and res.steps == 2 * tgen.CHUNK + 1
    assert tgen._counts() == [b + p + res.steps * s for b, p, s in zip(before, prefill, step)]


def test_a_failed_capture_raises(cuda, monkeypatch):
    """A frame step that reads the host cannot be captured: the graphed
    entry raises, and nothing runs the eager loop in its place."""
    from csm_torch.models import generation as tgen

    args, params = _tiny_generation(cuda, "bf16", 64)
    prompts = _tiny_prompts(args, 1, 64, cuda)
    monkeypatch.setattr(tgen.FrameGraphs, "step", lambda fg: fg.done.all().item())
    monkeypatch.setattr(tgen, "generate_audio_tokens", None)
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        tgen.generate_audio_tokens_jit(params, args, *prompts, max_frames=3,
                                       compute_dtype=torch.bfloat16, device=cuda)
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()


# ---------------------------------------------------------------- serving


def _serving_requests(args, specs, seed=11):
    """StreamRequests (prompt length, request id, max_frames) of random text
    frames."""
    from csm_torch.serving import StreamRequest

    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    out = []
    for T, rid, max_frames in specs:
        tokens = np.zeros((T, K + 1), np.int32)
        mask = np.zeros((T, K + 1), bool)
        tokens[:, -1] = rng.integers(1, args.text_vocab_size, T)
        mask[:, -1] = True
        out.append(StreamRequest(tokens, mask, max_frames=max_frames, request_id=rid))
    return out


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "int4", "kv_int8"])
def test_server_graphs_match_eager(cuda, mode, pipelined):
    """The server through its CUDA graphs (every graph captured by
    ``warmup``) against the same server without them, on one seed at
    topk=50: the same codes for six requests over four slots (admission,
    compaction to 1, 2 and the full batch, a 150-frame prompt whose prefill
    takes the flash kernel), and the same launch counts (each replay adds
    its capture's)."""
    from csm_torch.models import generation as tgen
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "int4" if mode == "int4" else "bf16", 256)
    specs = [(20, 0, 9), (33, 1, 5), (150, 2, 12), (40, 3, 7), (12, 4, 3), (25, 5, 10)]
    got = {}
    for graphs in (True, False):
        server = BatchedServer(params, args, n_slots=4, max_seq_len=512, temperature=0.9,
                               topk=50, chunk_size=4, compute_dtype=torch.bfloat16,
                               kv_dtype="int8" if mode == "kv_int8" else "bf16",
                               pipelined=pipelined, device=cuda)
        if not graphs:  # the same functions without capture
            server.graphs = False
        if graphs:
            server.warmup()
            assert set(server._decodes) == {1, 2, 4}
            assert all(d.graph is not None for d in server._decodes.values())
        server.reset(seed=7)
        before = tgen._counts()
        results, _ = server.run(_serving_requests(args, specs))
        torch.cuda.synchronize()
        got[graphs] = ({r.request_id: r.frames for r in results},
                       [a - b for a, b in zip(tgen._counts(), before)])
        server.close()
    (codes_g, counts_g), (codes_e, counts_e) = got[True], got[False]
    assert set(codes_g) == set(range(6))
    for rid in codes_e:
        np.testing.assert_array_equal(codes_g[rid], codes_e[rid])
    assert counts_g == counts_e and counts_g[0] > 0
    assert counts_g[1] == args.backbone.num_layers  # the one 256-bucket prefill
    assert (counts_g[2] > 0) == (mode == "int4")
    assert (counts_g[4] > 0) == (mode == "kv_int8")  # the int8 form, inside the step graphs


def test_server_compaction_round_trip(cuda):
    """Two live streams in an 8-slot server decode at capacity 2, then 1
    (rows gathered into the capacity's buffers, scattered back): their
    codes at topk=50 equal a dedicated 2-slot server's on the same seed,
    and the six idle rows of the resident cache are never written."""
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "bf16", 64)
    specs = [(20, 0, 14), (37, 1, 11)]
    codes = {}
    for n in (8, 2):
        server = BatchedServer(params, args, n_slots=n, max_seq_len=128, temperature=0.9,
                               topk=50, chunk_size=4, compute_dtype=torch.bfloat16, device=cuda)
        server.reset(seed=3)
        server.state.cache.k[:, 2:].fill_(7)
        results, _ = server.run(_serving_requests(args, specs))
        torch.cuda.synchronize()
        codes[n] = {r.request_id: r.frames for r in results}
        if n == 8:
            assert set(server._decodes) == {1, 2}  # capacity 1 once the shorter one ends
            assert bool((server.state.cache.k[:, 2:] == 7).all())
        server.close()
    for rid in (0, 1):
        np.testing.assert_array_equal(codes[8][rid], codes[2][rid])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_windowed_server_graphs_match_eager(cuda, kv_dtype):
    """A 96-column window with a 30-position re-anchor headroom, through
    graphs captured on first use (mid-traffic: no warmup) against the same
    server without them, topk=50 on one seed: equal codes for three
    streams of 140-160 frames that wrap their rings and re-anchor.  (A
    capture's eager warm-up pass adds its launches to the counts, so they
    are not compared.)"""
    from csm_torch.models import generation as tgen
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "bf16", 64)
    specs = [(20, 0, 160), (12, 1, 150), (30, 2, 140)]
    got = {}
    for graphs in (True, False):
        server = BatchedServer(params, args, n_slots=4, max_seq_len=128, temperature=0.9, topk=50,
                               chunk_size=4, compute_dtype=torch.bfloat16, kv_dtype=kv_dtype,
                               window=96, reanchor_headroom=30, device=cuda)
        server.graphs = graphs
        rows = []
        real = server._reanchor
        server._reanchor = lambda row, delta: rows.append(row) or real(row, delta)
        server.reset(seed=5)
        before = tgen._counts()
        results, _ = server.run(_serving_requests(args, specs))
        torch.cuda.synchronize()
        got[graphs] = ({r.request_id: r.frames for r in results},
                       [a - b for a, b in zip(tgen._counts(), before)], sorted(set(rows)))
        if graphs:
            assert all(d.graph is not None for d in server._decodes.values())
        server.close()
    (codes_g, counts_g, rows_g), (codes_e, counts_e, rows_e) = got[True], got[False]
    assert rows_g == rows_e == [0, 1, 2]
    for rid in codes_e:
        assert len(codes_g[rid]) == specs[rid][2]
        np.testing.assert_array_equal(codes_g[rid], codes_e[rid])
    assert counts_g[0] > 0 and counts_e[0] > 0  # the decode kernel ran in both


def test_prefix_server_graphs_match_eager(cuda):
    """Prefixes of buckets 32 and 256 (its registration runs the flash
    kernel at S = T = 256), requests naming them with suffixes of buckets
    64 and 256 (flash after the prefix) beside a plain one, through the
    registration and admission graphs (captured on first use) against the
    same server without them, topk=50 on one seed: equal codes, and the
    flash kernel launched in both."""
    from csm_torch.models import generation as tgen
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "bf16", 256)
    ctx = {name: _serving_requests(args, [(T, 0, 1)], seed=T)[0] for name, T in (("a", 20), ("b", 200))}
    got = {}
    for graphs in (True, False):
        server = BatchedServer(params, args, n_slots=4, max_seq_len=768, temperature=0.9, topk=50,
                               chunk_size=4, compute_dtype=torch.bfloat16, device=cuda)
        server.graphs = graphs
        before = tgen._counts()
        for name, r in ctx.items():
            server.register_prefix(name, r.tokens, r.mask)
        server.reset(seed=9)
        reqs = _serving_requests(args, [(10, 0, 12), (220, 1, 9), (15, 2, 10), (30, 3, 8)])
        for r, prefix in zip(reqs, ("a", "b", "b", None)):
            r.prefix = prefix
        results, _ = server.run(reqs)
        torch.cuda.synchronize()
        got[graphs] = ({r.request_id: r.frames for r in results},
                       [a - b for a, b in zip(tgen._counts(), before)])
        if graphs:
            assert set(server._prefix_prefills) == {(32, 64), (256, 256), (256, 64)}
            assert all(p.graph is not None for p in server._prefix_prefills.values())
        server.close()
    (codes_g, counts_g), (codes_e, counts_e) = got[True], got[False]
    assert set(codes_g) == set(range(4))
    for rid in codes_e:
        np.testing.assert_array_equal(codes_g[rid], codes_e[rid])
    # flash: the registration of "b" (S = 256) and request 1's 256-bucket suffix
    assert counts_e[1] == 2 * args.backbone.num_layers and counts_g[1] > 0


# ---------------------------------------------------------------- watermark, loaders


def _speech_band(seconds, sr=24_000):
    """Tones in the speech band over a noise floor."""
    t = np.arange(int(seconds * sr)) / sr
    x = sum(0.05 * np.sin(2 * np.pi * f * t) for f in (180, 420, 950, 2300))
    return (x + 0.005 * np.random.default_rng(0).standard_normal(t.size)).astype(np.float32)


def test_watermark_card_matches_cpu(cuda, monkeypatch):
    """Encode and the message decoder's logits on the card against the
    CPU, float32 with TF32 off inside the watermarker's calls whatever the
    process set: encode within 1e-5 of the input's peak (the watermark is
    ~2e-2 of it), logits within 1e-5 of their largest with equal argmax;
    one shift a chunk gives the logits of one batch to the same share and
    argmax (cuDNN may pick another algorithm for another batch size, which
    rounds otherwise).  The input is speech-band tones over a noise floor: without
    one, STFT bins near zero carry the phase of rounding noise, which the
    encoder writes the watermark with, and any two float32 implementations
    (the JAX package and the port on the CPU too) part there far more."""
    from csm_torch.watermarking import model as wm
    from csm_torch.watermarking import watermarker as wmk

    params = wm.init_watermark_params(torch.Generator().manual_seed(0))
    card = wmk.Watermarker(params, device=cuda)
    host = wmk.Watermarker(params, device="cpu")
    audio = _speech_band(1.0)
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        enc = card.encode_wav(audio, 24_000, wmk.CSM_1B_GH_WATERMARK)
        y = torch.from_numpy(np.stack([enc[s: s + 20_000] for s in (0, 10, 20)]))
        logits_card = card._decode_frames(card.params, y.to(cuda)).cpu()
        monkeypatch.setattr(wmk, "DECODE_BUDGET_BYTES", 1)
        logits_chunked = card._decode_frames(card.params, y.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == keep
    want = host.encode_wav(audio, 24_000, wmk.CSM_1B_GH_WATERMARK)
    assert np.abs(enc - want).max() <= 1e-5 * np.abs(audio).max()
    logits_host = host._decode_frames(host.params, y)
    scale = logits_host.abs().max().item()
    assert (logits_card - logits_host).abs().max().item() <= 1e-5 * scale
    assert torch.equal(logits_card.argmax(1), logits_host.argmax(1))
    assert (logits_chunked - logits_card).abs().max().item() <= 1e-5 * scale
    assert torch.equal(logits_chunked.argmax(1), logits_card.argmax(1))


@pytest.mark.parametrize("suffix", [".pt", ".safetensors"])
def test_checkpoint_loads_on_the_card(cuda, tmp_path, suffix):
    """A bf16 torchtune file of tiny-file-flavor weights: ``load_csm`` on the
    card gives the written weights (fused, bf16) bit for bit and generates."""
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.generator import load_csm
    from csm_torch.models.config import tiny_file_args
    from csm_torch.models.csm import fuse_csm_params
    from csm_torch.utils import safetensors
    from csm_torch.utils.checkpoint_compat import export_to_torch_names
    from csm_torch.utils.params import cast_params, random_csm_params, tree_map

    args = tiny_file_args()
    params = cast_params(random_csm_params(args, seed=0), torch.bfloat16)
    state = {k: v.to(torch.bfloat16) for k, v in export_to_torch_names(params, args).items()}
    path = str(tmp_path / f"ckpt{suffix}")
    if suffix == ".pt":
        torch.save(state, path)
    else:
        safetensors.write(path, state)
    g = load_csm(path, args=args, text_tokenizer=ByteTokenizer(), device=cuda)
    want = fuse_csm_params(tree_map(lambda t: t.to(cuda), params))
    for comp in ("backbone", "decoder"):
        for k, v in want[comp].items():
            assert torch.equal(g.params[comp][k], v), (comp, k)
    assert torch.equal(g.params["audio_head"], want["audio_head"])
    audio = g.generate("from a file", max_audio_length_ms=240, topk=1)
    assert audio.shape == (3 * 1920,) and np.isfinite(audio).all()


# ---------------------------------------------------------------- multi-LoRA and QLoRA


_ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _tiny_adapter(args, dev, seed, **cfg):
    """(adapter tree, LoRAConfig, None) with B drawn N(0, 0.05^2)."""
    from csm_torch.training import lora as tlora

    lcfg = tlora.LoRAConfig(**cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo = tlora.init_lora_params(gen, args, lcfg, device=dev)
    for comp in lo.values():
        for ad in comp.values():
            ad["b"].normal_(0.0, 0.05, generator=gen)
    return lo, lcfg, None


def _bank_requests(args, specs, names):
    reqs = _serving_requests(args, specs)
    for i, r in enumerate(reqs):
        r.adapter = names[i % len(names)]
    return reqs


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "int4"])
def test_bank_server_graphs_match_eager(cuda, mode, pipelined):
    """A bank of three adapters (r=4 on q/v, r=2 on all seven, decoder-only)
    through the server's CUDA graphs against the same server without them,
    topk=50 on one seed: the same codes for six requests over ids 0-3 and
    four slots (admission, compaction, a flash prefill), and the same
    launch counts."""
    from csm_torch.models import generation as tgen
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "int4" if mode == "int4" else "bf16", 256)
    bank = {"a": _tiny_adapter(args, cuda, 1, r=4), "b": _tiny_adapter(args, cuda, 2, r=2,
                                                                      target_modules=_ALL7),
            "d": _tiny_adapter(args, cuda, 3, r=4, apply_to_backbone=False)}
    specs = [(20, 0, 9), (33, 1, 5), (150, 2, 12), (40, 3, 7), (12, 4, 3), (25, 5, 10)]
    got = {}
    for graphs in (True, False):
        server = BatchedServer(params, args, n_slots=4, max_seq_len=512, temperature=0.9,
                               topk=50, chunk_size=4, compute_dtype=torch.bfloat16,
                               pipelined=pipelined, adapters=bank, device=cuda)
        if not graphs:
            server.graphs = False
        else:
            server.warmup()
            assert server.captures > 0
        server.reset(seed=7)
        before = tgen._counts()
        results, _ = server.run(_bank_requests(args, specs, [None, "a", "b", "d"]))
        torch.cuda.synchronize()
        got[graphs] = ({r.request_id: r.frames for r in results},
                       [a - b for a, b in zip(tgen._counts(), before)])
        server.close()
    (codes_g, counts_g), (codes_e, counts_e) = got[True], got[False]
    assert set(codes_g) == set(range(6))
    for rid in codes_e:
        np.testing.assert_array_equal(codes_g[rid], codes_e[rid])
    assert counts_g == counts_e and counts_g[0] > 0 and counts_g[1] == args.backbone.num_layers
    assert (counts_g[2] > 0) == (mode == "int4")


def test_bank_swap_in_place_during_a_pipelined_chunk(cuda):
    """A pipelined graph server with a chunk in flight: removing an unused
    adapter from the middle of the bank and adding another into its id
    copies into the same bank tensors on the serving stream, with no
    capture, and every stream's codes equal the run without the swap; an
    adapter of a larger rank then replaces the bank, retakes the captures at
    their next use and serves like a server built with it."""
    from csm_torch.serving import BatchedServer

    args, params = _tiny_generation(cuda, "bf16", 64)
    mk = lambda seed, r=4: _tiny_adapter(args, cuda, seed, r=r)  # noqa: E731
    server = BatchedServer(params, args, n_slots=4, max_seq_len=128, temperature=0.9, topk=50,
                           chunk_size=4, compute_dtype=torch.bfloat16, pipelined=True,
                           adapters={"a": mk(1), "c": mk(2), "b": mk(3)}, device=cuda)
    server.warmup()
    ptrs = {n: ad["b"].data_ptr() for n, ad in server.bank["backbone"].items()}
    specs = [(20, 0, 14), (33, 1, 11), (12, 2, 13), (25, 3, 9)]
    runs = []
    for swap in (False, True):
        server.reset(seed=5)
        for r in _bank_requests(args, specs, [None, "a", "b"]):
            assert server.submit(r) is not None
        done = server.step()
        assert server._inflight is not None  # a chunk in flight
        c0 = server.captures
        if swap:
            server.remove_adapter("c")
            assert server.add_adapter("e", mk(4)) == 2
            with pytest.raises(ValueError, match="in use"):
                server.remove_adapter("a")
        done += server.run([])[0]
        runs.append({r.request_id: r.frames for r in done})
        assert server.captures == c0
    assert {n: ad["b"].data_ptr() for n, ad in server.bank["backbone"].items()} == ptrs
    for rid, f in runs[0].items():
        np.testing.assert_array_equal(runs[1][rid], f)
    wide = mk(5, r=32)
    server.add_adapter("wide", wide)
    c0 = server.captures
    server.reset(seed=5)
    res, _ = server.run(_bank_requests(args, specs[:2], ["wide", "e"]))
    assert server.captures > c0
    ref = BatchedServer(params, args, n_slots=4, max_seq_len=128, temperature=0.9, topk=50,
                        chunk_size=4, compute_dtype=torch.bfloat16, pipelined=True,
                        adapters={"a": mk(1), "e": mk(4), "b": mk(3), "wide": wide}, device=cuda)
    ref.reset(seed=5)
    want, _ = ref.run(_bank_requests(args, specs[:2], ["wide", "e"]))
    torch.cuda.synchronize()
    want = {r.request_id: r.frames for r in want}
    for r in res:
        np.testing.assert_array_equal(r.frames, want[r.request_id])
    server.close()
    ref.close()


def test_int8_matmul_function_matches_autograd(cuda):
    """The int8 base's ``autograd.Function`` on the card in bf16: output and
    input gradient equal autograd through ``(x @ w8.to(bf16)) * scale``
    bit for bit, and the backward saves the int8 weight and its scales."""
    from csm_torch.models.llama import _proj
    from csm_torch.utils.quantize import quantize_weight

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = quantize_weight(torch.randn(2048, 512, generator=gen, device=cuda))
    x = torch.randn(2, 256, 2048, generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    g = torch.randn(2, 256, 512, generator=gen, device=cuda).to(torch.bfloat16)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = _proj(x, q)
    (dx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_()
    y2 = (x2 @ q["w8"].to(x2.dtype)) * q["scale"].to(x2.dtype)
    (dx2,) = torch.autograd.grad(y2, x2, g)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=0)
    assert {t.dtype for t in saved} == {torch.int8, torch.bfloat16}
