"""The two attention kernels' plain versions, held against the JAX
package's Pallas kernels run in interpret mode on the CPU (the CUDA kernels
themselves are held against these plain versions on a card, in
tests/test_torch_cuda.py), and the decode kernel's launch plan, which is
computed here in Python and passed to the kernel.

Float32 on the CPU; tolerances are float32 rounding of sums over at most a
few hundred keys (2e-5).  The flash forward is also compared in bf16, where
both sides round p to bf16 before the P·V product.  The JAX decode kernel reads past the end
of its last chunk and returns NaN whenever T is not a multiple of 128, so it
is compared only at T in {256, 512}; ragged T is held against
``gqa_attention`` instead.
"""

import importlib.util
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from csm_tpu.ops import attention as jattn
from csm_tpu.ops import decode_attention as jdec
from csm_tpu.ops import flash_attention as jfa
from csm_torch.ops import decode_attention as tdec
from csm_torch.ops import flash_attention as tfa
from test_torch_cuda import PAD, _decode_inputs, _flash_inputs, decode_pattern_mask

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)  # stdlib only at import: its shape tables


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every pallas_call through the Pallas interpreter."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        kw.pop("compiler_params", None)  # Mosaic-only knob
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("B,Hq,Hkv,D,T", [(2, 32, 8, 64, 256), (3, 8, 2, 128, 512)])
def test_decode_plain_matches_jax_kernel(interpret_pallas, B, Hq, Hkv, D, T):
    q, k, v, mask = _decode_inputs(B, Hq, Hkv, D, T)
    want = np.asarray(jdec.decode_gqa_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = tdec.decode_gqa_attention(*map(torch.from_numpy, (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    assert not got[-1].any()  # fully masked row → zeros, as in the reference


@pytest.mark.parametrize("T", [32, 89, 200, 1189])
def test_decode_plain_ragged_T_matches_gqa(T):
    """Ragged cache lengths, per-row masks and a (1, 1, T) broadcast mask."""
    q, k, v, mask = _decode_inputs(2, 8, 2, 64, T, seed=T)
    mask[-1, 0, : T // 3] = True
    for m in (mask, mask[:1]):
        want = jattn.gqa_attention(*map(jnp.asarray, (q, k, v, m)))
        got = tdec.decode_gqa_attention(*map(torch.from_numpy, (q, k, v, m)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,Hq,Hkv,D,T,pattern", [
    (2, 8, 2, 64, 300, "mid_tiles"), (2, 8, 2, 64, 1189, "last_split"),
    (2, 8, 2, 64, 1189, "live89"), (1, 8, 2, 128, 32, "full"), (3, 8, 2, 64, 281, "shared"),
    (2, 8, 2, 64, 89, "dead")])
def test_decode_plain_mask_patterns_match_gqa(B, Hq, Hkv, D, T, pattern):
    """The masks the card tests hold the kernel to (``decode_pattern_mask``:
    whole masked tiles mid-cache, live keys only in the last split, 89 live
    of 1189, the decoder's fresh cache at B=1, a broadcast (1, 1, T) mask,
    a dead row): the plain version against the JAX package's attention.  A
    row with no live key gives zeros, as the JAX decode kernel does
    (``gqa_attention``'s finite NEG_INF gives it the mean of V instead)."""
    q, k, v, _ = _decode_inputs(B, Hq, Hkv, D, T, seed=T)
    mask = decode_pattern_mask(pattern, B, T)
    want = np.asarray(jattn.gqa_attention(*map(jnp.asarray, (q, k, v, mask))))
    got = tdec.decode_gqa_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    live = np.broadcast_to(mask, (B, 1, T))[:, 0].any(-1)
    np.testing.assert_allclose(got[live], want[live], atol=2e-5, rtol=2e-5)
    assert not got[~live].any() and live.any()


def _decode_plan_shapes():
    shapes = [(s["B"], s["Hkv"], s["T"], s["D"]) for s in chip_smoke.DECODE_SHAPES]
    return sorted(set(shapes)) + [(1, 1, 1, 16), (3, 2, 70, 16), (4, 8, 100000, 32)]


@pytest.mark.parametrize("B,Hkv,T,D", _decode_plan_shapes())
def test_decode_plan_covers_T(B, Hkv, T, D):
    """At every phase-3 shape (and a few edges) on the H100's 132 SMs, the
    plan's splits take whole tiles that cover T exactly, in order, each
    split at least one tile; at most 16 splits; the grid covers the SMs
    unless T has too few tiles; and the plan reads shapes only."""
    plan = tdec.decode_plan(B, Hkv, T, D, 132)
    assert plan.tile == tdec.tile_keys(D) and 1 <= plan.splits <= tdec.MAX_SPLITS
    shares = tdec.decode_shares(T, plan)
    assert shares[0][0] == 0 and shares[-1][1] == T
    assert all(a < b and a % plan.tile == 0 for a, b in shares)
    assert all(shares[i][1] == shares[i + 1][0] for i in range(len(shares) - 1))
    ntiles = -(-T // plan.tile)
    assert B * Hkv * plan.splits >= 132 or plan.splits == min(tdec.MAX_SPLITS, ntiles)
    assert tdec.decode_plan(B, Hkv, T, D, 132) == plan
    assert list(inspect.signature(tdec.decode_plan).parameters) == ["B", "Hkv", "T", "D", "sm_count"]


@pytest.mark.parametrize("S,lens", [(256, (200, 256, 0)), (300, (131, 300))])
def test_flash_plain_matches_jax_kernel(interpret_pallas, S, lens):
    """O and L for every row: real rows, PAD_POS rows (which attend every
    slot up to PAD_POS, PAD slots included) and rows with no key."""
    T = S + 25
    q, k, v, q_pos, kv_pos = _flash_inputs(S, T, lens)
    o_j, l_j = jfa._flash_fwd(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)), 256)
    o_t, l_t = tfa.flash_gqa_attention_with_lse(*map(torch.from_numpy, (q, k, v, q_pos, kv_pos)))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=2e-5, rtol=2e-5)
    pad_rows = q_pos == PAD
    assert pad_rows.any() and np.abs(o_t.numpy()[pad_rows]).max() > 0
    if 0 in lens:
        empty = lens.index(0)
        assert not o_t[empty].any() and (l_t[empty] == tfa.L_EMPTY).all()


@pytest.mark.parametrize("S,lens,Hkv", [(256, (200, 256), 1), (300, (131, 300), 2)])
def test_flash_plain_matches_jax_kernel_bf16(interpret_pallas, S, lens, Hkv):
    """bf16: the same numpy inputs cast to bf16 on both sides.  Both round
    p = exp(s - m) to bf16 before the P·V product and sum l from the
    unrounded p; the JAX kernel takes m as the running max over its key
    chunks, the plain version the final max, and the two sum in other
    orders, so a p may round apart: each O element is allowed one bf16 ulp
    (rtol 2**-7, atol 1e-4) plus FWD_P_SHARE of the root-sum-square of the
    terms p_j·v_jd / l it sums (``fwd_rounding_allowance``), as the CUDA
    kernel is held on a card.  L agrees to 1e-4 (float32 of the same bf16
    scores).  Every row sees a key (the JAX kernel gives an empty row the
    mean of V).

    That tolerance does not tell p rounded from p kept in float32: a plain
    version that leaves p unrounded is within 0.40-0.42 of it here (0.23-0.26
    with p rounded).  What tells them apart is how many O elements differ at
    all: ~0.05 % with p rounded, ~37 % without, which the last assert
    holds."""
    q, k, v, q_pos, kv_pos = _flash_inputs(S, S + 25, lens, Hkv=Hkv)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    o_j, l_j = jfa._flash_fwd(jq, jk, jv, jnp.asarray(q_pos), jnp.asarray(kv_pos), 256)
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)  # noqa: E731
    args = (bf(q), bf(k), bf(v), torch.from_numpy(q_pos), torch.from_numpy(kv_pos))
    o_t, l_t = tfa.flash_gqa_attention_with_lse(*args)
    assert o_t.dtype == torch.bfloat16
    want = torch.from_numpy(np.asarray(o_j, np.float32))
    tol = 1e-4 + 2**-7 * want.abs() + tfa.fwd_rounding_allowance(*args)
    err = (o_t.float() - want).abs()
    assert (err <= tol).all(), f"{(err / tol).max().item():.2f}x the tolerance"
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-4, rtol=1e-5)
    unrounded = tfa.flash_attention_plain(*(a.float() for a in args[:3]), *args[3:])[0]
    differ = lambda o: (o.float() != want).float().mean().item()  # noqa: E731
    assert differ(o_t) < 0.01 and differ(unrounded.bfloat16()) > 0.1


def test_flash_plain_with_shared_kv_pos_matches_gqa():
    """(T,) kv positions; every row sees at least one key."""
    S, T = 64, 80
    q, k, v, q_pos, kv_pos = _flash_inputs(S, T, (50, 64), Hq=8, Hkv=2, D=16)
    kv1 = kv_pos[1]
    mask = jattn.causal_mask_from_positions(jnp.asarray(q_pos), jnp.asarray(kv1))
    want = jattn.gqa_attention(*map(jnp.asarray, (q, k, v)), mask)
    got = tfa.flash_gqa_attention(*map(torch.from_numpy, (q, k, v, q_pos, kv1)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=2e-5)


def test_wrappers_check_inputs_and_count_only_launches():
    q, k, v, mask = map(torch.from_numpy, _decode_inputs(1, 4, 2, 16, 8))
    before = (tdec.launches, tfa.launches)
    tdec.decode_gqa_attention(q, k, v, mask)  # CPU tensors: the plain version
    assert (tdec.launches, tfa.launches) == before
    with pytest.raises(ValueError, match="mask"):
        tdec.decode_gqa_attention(q, k, v, mask.int())
    with pytest.raises(ValueError, match="dtype"):
        tdec.decode_gqa_attention(q.double(), k.double(), v.double(), mask)
    with pytest.raises(ValueError, match="head_dim"):
        tdec.decode_gqa_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                                  v[..., :8].contiguous(), mask)
    qf = torch.zeros(1, 4, 4, 16)
    pos = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="q_pos"):
        tfa.flash_gqa_attention(qf, k, v, pos, torch.zeros(8, dtype=torch.int32))
