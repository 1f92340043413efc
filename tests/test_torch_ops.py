"""The port's plain tensor ops (csm_torch/ops, models/csm embeddings,
utils/params) held against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; both
compute in float32, so the tolerances are float32 rounding (1e-6 relative
on single ops, 1e-5 on attention's sums over keys).  Token outputs are
compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.models.llama import fuse_projections as j_fuse
from csm_tpu.ops import attention as jattn
from csm_tpu.ops import kvcache as jkv
from csm_tpu.ops import norms as jnorms
from csm_tpu.ops import rope as jrope
from csm_tpu.ops import sampling as jsampling
from csm_torch.codec.convs import ConvParams
from csm_torch.codec.rvq import SplitRVQParams
from csm_torch.models import csm as tcsm
from csm_torch.models import config as tconfig
from csm_torch.models.llama import fuse_projections as t_fuse
from csm_torch.ops import attention as tattn
from csm_torch.ops import kvcache as tkv
from csm_torch.ops import norms as tnorms
from csm_torch.ops import rope as trope
from csm_torch.ops import sampling as tsampling
from csm_torch.utils.params import params_from_jax

PAD = 1 << 28


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams, params_from_jax(jparams)


def test_config_copy_matches():
    """The copied dataclasses give the same configurations."""
    from csm_tpu.models import config as jconfig

    for name in ("tiny_test_args", "csm_1b_args"):
        a, b = getattr(jconfig, name)(), getattr(tconfig, name)()
        assert a.to_json() == b.to_json()
        assert jconfig.csm_param_count(a) == tconfig.csm_param_count(b)


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    s = rng.standard_normal(64).astype(np.float32)
    _close(tnorms.rms_norm(_t(x), _t(s)), jnorms.rms_norm(jnp.asarray(x), jnp.asarray(s)), 1e-6)


def test_rope_at_positions_and_apply(tiny):
    """Tables, gathers at real / PAD_POS / negative positions, rotation."""
    jargs, targs, _, _ = tiny
    cfg_j, cfg_t = jargs.backbone, targs.backbone
    np.testing.assert_array_equal(
        trope.scaled_rope_freqs(64), jrope.scaled_rope_freqs(64)
    )
    pos = np.array([[0, 1, 5, 127, PAD, -1], [3, 4, 6, PAD, PAD, 0]], np.int32)
    cos_t, sin_t = trope.rope_at_positions(cfg_t, _t(pos))
    cos_j, sin_j = jrope.rope_at_positions(cfg_j, jnp.asarray(pos))
    np.testing.assert_array_equal(cos_t.numpy(), np.asarray(cos_j))
    np.testing.assert_array_equal(sin_t.numpy(), np.asarray(sin_j))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 4, cfg_t.head_dim)).astype(np.float32)
    _close(trope.apply_rope(_t(x), cos_t, sin_t),
           jrope.apply_rope(jnp.asarray(x), cos_j, sin_j), 1e-6)


@pytest.mark.parametrize("kv_batched", [False, True])
def test_mask_and_gqa_attention(kv_batched):
    """PAD_POS slots are never attended by a real row; a PAD_POS row sees
    every slot; an all-masked row stays finite (uniform weights)."""
    rng = np.random.default_rng(2)
    B, S, T, Hq, Hkv, D = 2, 5, 9, 4, 2, 16
    q_pos = np.array([[0, 1, 2, PAD, -1], [3, 4, 5, 6, 7]], np.int32)
    kv_pos = np.array([0, 1, 2, 3, 4, 5, PAD, PAD, 6], np.int32)
    if kv_batched:
        kv_pos = np.stack([kv_pos, np.where(kv_pos == 2, PAD, kv_pos)])
    m_t = tattn.causal_mask_from_positions(_t(q_pos), _t(kv_pos))
    m_j = jattn.causal_mask_from_positions(jnp.asarray(q_pos), jnp.asarray(kv_pos))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    out_t = tattn.gqa_attention(_t(q), _t(k), _t(v), m_t)
    out_j = jattn.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), m_j)
    _close(out_t, out_j, 1e-5)


def test_kvcache_writes_in_place(tiny):
    jargs, targs, _, _ = tiny
    cfg = targs.backbone
    c_t = tkv.init_kv_cache(cfg, 2, torch.float32, max_seq_len=12)
    c_j = jkv.init_kv_cache(jargs.backbone, 2, jnp.float32, max_seq_len=12)
    assert tuple(c_t.k.shape) == c_j.k.shape and c_t.max_seq_len == 12
    rng = np.random.default_rng(3)
    kn = rng.standard_normal((2, 3, cfg.num_kv_heads, cfg.head_dim)).astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)
    kt, vt = tkv.update_layer(c_t.k[1], c_t.v[1], _t(kn), _t(vn), 4)
    kj, vj = jkv.update_layer(c_j.k[1], c_j.v[1], jnp.asarray(kn), jnp.asarray(vn), jnp.int32(4))
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert kt.data_ptr() == c_t.k[1].data_ptr()  # the port's cache is written in place
    np.testing.assert_array_equal(c_t.k[1].numpy(), np.asarray(kj))
    # torch.int8 makes the quantized cache (held against the JAX package in
    # tests/test_torch_quantize.py)
    c8 = tkv.init_kv_cache(cfg, 1, torch.int8)
    assert isinstance(c8.k, tkv.QuantKV) and c8.k.q.dtype == torch.int8
    assert c8.max_seq_len == cfg.max_seq_len


def test_sample_topk_greedy():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((3, 7, 2051)).astype(np.float32)
    got = tsampling.sample_topk(_t(logits), 1, 0.9)
    want = jsampling.sample_topk(jax.random.key(0), jnp.asarray(logits), 1, 0.9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("topk", [5, 50])
def test_sample_topk_with_jax_uniforms(topk):
    """Fed JAX's own uniforms, the inverse-CDF draw picks the same tokens."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((64, 2051)).astype(np.float32) * 3
    key = jax.random.key(7)
    u = jax.random.uniform(key, (64, 1), dtype=jnp.float32)
    want = jsampling.sample_topk(key, jnp.asarray(logits), topk, 0.8)
    got = tsampling.sample_topk(_t(logits), topk, 0.8, uniforms=_t(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _close(tsampling.topk_probs(_t(logits), topk, 0.8),
           jsampling.topk_probs(jnp.asarray(logits), topk, 0.8), 1e-6)


def test_embeddings(tiny):
    jargs, targs, jparams, tparams = tiny
    rng = np.random.default_rng(6)
    K = targs.audio_num_codebooks
    tokens = np.concatenate(
        [rng.integers(0, targs.audio_vocab_size, (2, 7, K)),
         rng.integers(0, targs.text_vocab_size, (2, 7, 1))], axis=-1).astype(np.int32)
    mask = rng.random((2, 7, K + 1)) < 0.6
    got = tcsm.masked_embed_sum(tparams, targs, _t(tokens), _t(mask))
    jp = jax.tree.map(jnp.asarray, jparams)
    want = jcsm.masked_embed_sum(jp, jargs, jnp.asarray(tokens), jnp.asarray(mask))
    _close(got, want, 1e-6)
    _close(tcsm.embed_audio(tparams, targs, 2, _t(tokens[:, 0, 2])),
           jcsm.embed_audio(jp, jargs, 2, jnp.asarray(tokens[:, 0, 2])), 0)


def test_fused_projections_and_param_bridge(tiny):
    """The bridge is a plain copy, and fusing agrees leaf by leaf."""
    _, _, jparams, tparams = tiny
    for name, leaf in tparams["backbone"].items():
        np.testing.assert_array_equal(leaf.numpy(), jparams["backbone"][name])
    fused_t = t_fuse(tparams["decoder"])
    fused_j = j_fuse(jax.tree.map(jnp.asarray, jparams["decoder"]))
    assert set(fused_t) == set(fused_j)
    for name in fused_t:
        np.testing.assert_array_equal(fused_t[name].numpy(), np.asarray(fused_j[name]))
    # codec trees: NamedTuples become the port's classes, None stays None
    from csm_tpu.codec import convs as jconvs, rvq as jrvq

    jconv = jconvs.ConvParams(np.ones((2, 3, 4), np.float32), None)
    assert isinstance(params_from_jax(jconv), ConvParams)
    assert params_from_jax(jconv).b is None
    jq = jrvq.RVQParams(*(np.zeros((1, 2), np.float32),) * 4)
    assert isinstance(params_from_jax(jrvq.SplitRVQParams(jq, jq)), SplitRVQParams)
