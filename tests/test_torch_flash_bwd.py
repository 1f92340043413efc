"""The flash-attention backward: the plain version of the port's two backward
kernels held against the JAX package's Pallas backward (``_dq_kernel`` and
``_dkv_kernel`` through ``_flash_bwd_pallas``) run in interpret mode on the
CPU, and the port's autograd Function held against autograd through plain
attention.  The CUDA kernels themselves are held against the plain version
on a card (tests/test_torch_cuda.py).

Float32, tolerance 2e-5: float32 rounding of sums over a few hundred keys
(as tests/test_torch_kernels.py); and the plain version against the Pallas
backward in bf16, where both round p and ds to bf16 before the products.
Every query row sees at least one key: the JAX forward gives a row with no
visible key, inside a visited key tile, L = -1e30 (its finite NEG_INF), and
its backward is then not defined for that row, while the port gives
L = 1e30 and p = 0.
Training rows never are empty (positions are arange(T)).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from csm_tpu.ops import flash_attention as jfa
from csm_torch.ops import flash_attention as tfa
from csm_torch.ops.attention import causal_mask_from_positions, gqa_attention

PAD = 1 << 28
TOL = 2e-5


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run every pallas_call through the Pallas interpreter."""
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        kw.pop("compiler_params", None)  # Mosaic-only knob
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)


def bwd_inputs(S, T, Hkv, D, per_row_kv=False, B=2, Hq=4, seed=0):
    """q/k/v/dO and positions.  S = T: causal self-attention over arange(T).
    S < T: the queries are the last S positions; with ``per_row_kv`` each
    row's kv_pos (B, T) marks a few of its slots dead (PAD_POS), never slot
    0, so every query still sees a key."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    g = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(T - S, T), (B, S)).astype(np.int32).copy()
    kv_pos = np.broadcast_to(np.arange(T), (B, T)).astype(np.int32).copy()
    if per_row_kv:
        for b in range(B):
            kv_pos[b, rng.choice(np.arange(1, T), 7 * (b + 1), replace=False)] = PAD
    return q, k, v, g, q_pos, kv_pos


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


BWD_SHAPES = [
    (256, 256, 1, 64, False),
    (300, 300, 2, 16, False),  # ragged: S, T not multiples of a tile
    (200, 300, 2, 64, True),   # S < T, (B, T) kv_pos with dead slots
]


@pytest.mark.parametrize("S,T,Hkv,D,per_row_kv", BWD_SHAPES)
def test_bwd_plain_matches_jax_kernels(interpret_pallas, S, T, Hkv, D, per_row_kv):
    q, k, v, g, q_pos, kv_pos = bwd_inputs(S, T, Hkv, D, per_row_kv)
    jq, jk, jv, jg, jqp, jkp = map(jnp.asarray, (q, k, v, g, q_pos, kv_pos))
    out, L = jfa._flash_fwd(jq, jk, jv, jqp, jkp, 256)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jqp, jkp, out, L, jg, 256)
    got = tfa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, q_pos, kv_pos, np.array(out), np.array(L), g)))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("S,T,Hkv,D,per_row_kv", BWD_SHAPES)
def test_bwd_plain_matches_jax_kernels_bf16(interpret_pallas, S, T, Hkv, D, per_row_kv):
    """bf16: the same numpy inputs cast to bf16 on both sides, the JAX
    forward's out and L fed to both backwards.  Both round p and ds to bf16
    before the dq, dk and dv products and sum in float32, in other orders,
    so a gradient element differs only where a sum lands on the other side
    of a bf16 rounding boundary: by one bf16 ulp (rtol 2**-7; atol 2**-8 of
    the gradient's RMS for elements near zero), in under 1 % of the elements
    (0.01-0.3 % measured; without the rounding of p and ds ~40 % differ)."""
    q, k, v, g, q_pos, kv_pos = bwd_inputs(S, T, Hkv, D, per_row_kv)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    jqp, jkp = jnp.asarray(q_pos), jnp.asarray(kv_pos)
    out, L = jfa._flash_fwd(jq, jk, jv, jqp, jkp, 256)
    want = jfa._flash_bwd_pallas(jq, jk, jv, jqp, jkp, out, L, jg, 256)
    bf = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)  # noqa: E731
    got = tfa.flash_attention_bwd_plain(bf(q), bf(k), bf(v), torch.from_numpy(q_pos),
                                        torch.from_numpy(kv_pos), bf(out),
                                        torch.from_numpy(np.array(L)), bf(g))
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        np.testing.assert_allclose(a, b, rtol=2**-7, atol=2**-8 * np.sqrt(np.mean(b**2)))
        assert np.mean(a != b) < 0.01


def test_bwd_plain_with_lse_cotangent_matches_jax(interpret_pallas):
    """``g_lse`` folds into the row term: held against the VJP of the JAX
    package's flash_gqa_attention_with_lse through both outputs."""
    q, k, v, g, q_pos, kv_pos = bwd_inputs(256, 256, 2, 16)
    g_lse = np.random.default_rng(1).standard_normal((2, 4, 256)).astype(np.float32)
    jargs = tuple(map(jnp.asarray, (q, k, v)))
    (out, L), vjp = jax.vjp(
        lambda a, b, c: jfa.flash_gqa_attention_with_lse(a, b, c, jnp.asarray(q_pos),
                                                         jnp.asarray(kv_pos)), *jargs)
    want = vjp((jnp.asarray(g), jnp.asarray(g_lse)))
    got = tfa.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, q_pos, kv_pos, np.array(out), np.array(L), g)),
        g_lse=torch.from_numpy(g_lse))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("kv_rows", [1, 2])
def test_autograd_functions_match_plain_attention(kv_rows):
    """flash_gqa_attention's gradients on the CPU equal autograd through
    gqa_attention under causal_mask_from_positions, for (T,) and (B, T)
    kv_pos; flash_gqa_attention_with_lse's through both outputs equal those
    of plain attention plus a masked logsumexp."""
    q, k, v, g, q_pos, kv_pos = bwd_inputs(40, 72, 2, 16, per_row_kv=kv_rows == 2)
    q, k, v, g = (torch.from_numpy(x).requires_grad_(x is not g) for x in (q, k, v, g))
    q_pos = torch.from_numpy(q_pos)
    kv = torch.from_numpy(kv_pos[0] if kv_rows == 1 else kv_pos)
    mask = causal_mask_from_positions(q_pos, kv)
    want = torch.autograd.grad(gqa_attention(q, k, v, mask), (q, k, v), g)
    got = torch.autograd.grad(tfa.flash_gqa_attention(q, k, v, q_pos, kv), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)

    g_lse = torch.randn(2, 4, 40, generator=torch.Generator().manual_seed(0))
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, dim=2)) / math.sqrt(16)
    lse = torch.logsumexp(s.masked_fill(~mask[:, None], float("-inf")), dim=-1)
    want = torch.autograd.grad(
        (gqa_attention(q, k, v, mask) * g).sum() + (lse * g_lse).sum(), (q, k, v))
    out, l = tfa.flash_gqa_attention_with_lse(q, k, v, q_pos, kv)
    got = torch.autograd.grad((out * g).sum() + (l * g_lse).sum(), (q, k, v))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def test_bwd_wrappers_check_inputs_and_count_only_launches():
    q, k, v, g, q_pos, kv_pos = map(torch.from_numpy, bwd_inputs(64, 64, 2, 16))
    out, lse = tfa.flash_attention_plain(q, k, v, q_pos, kv_pos)
    delta = tfa.bwd_delta(out, g)
    before = (tfa.launches, tfa.dq_launches, tfa.dkv_launches)
    dq = tfa.flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta)  # CPU: the plain version
    dk, dv = tfa.flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse, delta)
    assert (tfa.launches, tfa.dq_launches, tfa.dkv_launches) == before
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    with pytest.raises(ValueError, match="delta"):
        tfa.flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta.double())
    with pytest.raises(ValueError, match="lse"):
        tfa.flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse[:, :, :-1], delta)
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g.transpose(1, 2).contiguous()
                                   .transpose(1, 2), lse, delta)
