"""The two attention kernels' plain versions, held against the JAX
package's Pallas kernels run in interpret mode on the CPU (the CUDA kernels
themselves are held against these plain versions on a card, in
tests/test_torch_cuda.py).

Float32 throughout on the CPU; tolerances are float32 rounding of sums over
at most a few hundred keys (2e-5).  The JAX decode kernel reads past the end
of its last chunk and returns NaN whenever T is not a multiple of 128, so it
is compared only at T in {256, 512}; ragged T is held against
``gqa_attention`` instead.
"""

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
from test_torch_cuda import PAD, _decode_inputs, _flash_inputs


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
