"""The port's KV-cache writes against the JAX package's ``ops/kvcache.py``
on the CPU: ``reset_kv_cache`` and the per-row S=1 write of serving
(``RowOffsets``), float and int8, including a row whose column is past the
cache's end (the JAX scatter drops it; the port must drop it too, without
clamping it onto the last column).  Float32 writes are copies, and int8
rows quantize with the same arithmetic, so everything is compared exactly.
The per-row form against the all-rows column form at B=1 is in
tests/test_torch_serving.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models.config import tiny_test_args
from csm_tpu.ops import kvcache as jkv
from csm_torch.models import config as tconfig
from csm_torch.ops import kvcache as tkv

B, T, H, D = 3, 8, 2, 4


def _leaves(half):
    return [half.q, half.s] if isinstance(half, (jkv.QuantKV, tkv.QuantKV)) else [half]


def _cache(int8, seed=0):
    """The same random cache contents in both packages: one layer's
    (B, T, H, D) halves, float32 or int8 codes with float32 scales."""
    rng = np.random.default_rng(seed)

    def half():
        x = rng.standard_normal((B, T, H, D)).astype(np.float32)
        if not int8:
            return jnp.asarray(x), torch.from_numpy(x.copy())
        q = rng.integers(-127, 128, (B, T, H, D)).astype(np.int8)
        s = rng.random((B, T, H, 1)).astype(np.float32)
        return (jkv.QuantKV(jnp.asarray(q), jnp.asarray(s)),
                tkv.QuantKV(torch.from_numpy(q.copy()), torch.from_numpy(s.copy())))

    (jk, tk), (jv, tv) = half(), half()
    return (jk, jv), (tk, tv)


def _assert_same(j_half, t_half):
    for a, b in zip(_leaves(j_half), _leaves(t_half)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cols", [(2, 5, 7), (0, 8, 3), (9, 7, 100)])
def test_per_row_write_matches_jax(int8, cols):
    """Row b writes column cols[b]; a column >= T (8, 9, 100) is dropped in
    both packages and leaves the row as it was."""
    (jk, jv), (tk, tv) = _cache(int8)
    rng = np.random.default_rng(1)
    k_new = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    v_new = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    jk2, jv2 = jkv.update_layer(jk, jv, jnp.asarray(k_new), jnp.asarray(v_new),
                                jnp.asarray(cols, jnp.int32))
    before = [x.clone() for x in _leaves(tk)]
    off = tkv.RowOffsets(torch.tensor(cols, dtype=torch.int64))
    tk2, tv2 = tkv.update_layer(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new), off)
    assert tk2 is tk and tv2 is tv  # in place
    _assert_same(jk2, tk)
    _assert_same(jv2, tv)
    for b, c in enumerate(cols):
        for now, old in zip(_leaves(tk), before):
            if c >= T:  # dropped: the whole row is untouched, column T-1 too
                assert torch.equal(now[b], old[b])
            else:
                assert torch.equal(now[b, :c], old[b, :c])
                assert torch.equal(now[b, c + 1:], old[b, c + 1:])


@pytest.mark.parametrize("int8", [False, True])
def test_reset_kv_cache_matches_jax(int8):
    """``reset_kv_cache`` zeroes every leaf in place, as the JAX reset
    returns zeros."""
    args = tconfig.tiny_test_args()
    cache = tkv.init_kv_cache(args.backbone, 2, torch.int8 if int8 else torch.float32)
    leaves = [x for half in cache for x in _leaves(half)]
    for leaf in leaves:
        leaf.fill_(3)
    assert tkv.reset_kv_cache(cache) is cache
    assert [x for half in cache for x in _leaves(half)] == leaves  # the same tensors
    want = jkv.reset_kv_cache(jkv.init_kv_cache(
        tiny_test_args().backbone, 2, jnp.int8 if int8 else jnp.float32))
    for jh, th in zip(want, cache):
        _assert_same(jh, th)


def test_per_row_write_needs_one_column():
    (_, _), (tk, tv) = _cache(False)
    x = torch.zeros(B, 2, H, D)
    with pytest.raises(ValueError, match="S == 1"):
        tkv.update_layer(tk, tv, x, x, tkv.RowOffsets(torch.zeros(B, dtype=torch.int64)))
