"""The port's transformer, frame step and frame loop held against the JAX
package at ``tiny_test_args()`` in float32 on the CPU.

Both packages get the same weights (the JAX tree bridged with
``params_from_jax``) and the same token frames made with numpy from a seed.
Hidden states agree to 2e-4 (float32 through a few layers, as
tests/test_model_parity.py holds the JAX package against its torch oracle);
tokens at topk=1 agree exactly.  On the CPU the port's attention routes run
the kernels' plain versions; the routing itself is counted here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models import generation as jgen
from csm_tpu.models.config import tiny_test_args
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.models import generation as tgen
from csm_torch.models import llama as tllama
from csm_torch.utils.params import params_from_jax

TOL = 2e-4


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams, params_from_jax(jparams)


def random_frames(args, B, S, seed=1):
    """Random (tokens, mask) in the (K+1)-column frame layout."""
    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    tokens = np.zeros((B, S, K + 1), np.int32)
    mask = np.zeros((B, S, K + 1), bool)
    text = rng.random((B, S)) < 0.5
    tokens[..., -1] = np.where(text, rng.integers(0, args.text_vocab_size, (B, S)), 0)
    mask[..., -1] = text
    tokens[..., :K] = np.where(~text[..., None], rng.integers(0, args.audio_vocab_size, (B, S, K)), 0)
    mask[..., :K] = ~text[..., None]
    return tokens, mask


class RouteCounter:
    """Counts the calls that reach each attention route of models/llama."""

    def __init__(self, monkeypatch):
        self.calls = {"decode": 0, "flash": 0}
        for route, name in (("decode", "decode_gqa_attention"), ("flash", "flash_gqa_attention")):
            fn = getattr(tllama, name)
            monkeypatch.setattr(tllama, name, self._wrap(route, fn))

    def _wrap(self, route, fn):
        def counted(*a, **kw):
            self.calls[route] += 1
            return fn(*a, **kw)

        return counted


def test_backbone_forward(tiny):
    jargs, targs, jparams, tparams = tiny
    tokens, mask = random_frames(targs, B=2, S=12)
    want = jax.jit(jcsm.backbone_forward, static_argnames=("args", "compute_dtype"))(
        jax.tree.map(jnp.asarray, jparams), jargs, jnp.asarray(tokens), jnp.asarray(mask),
        compute_dtype=jnp.float32)
    got = tcsm.backbone_forward(tparams, targs, torch.from_numpy(tokens),
                                torch.from_numpy(mask), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_transformer_apply_cached_prefill_then_decode(tiny):
    """Prefill 9 positions into a 24-slot cache, then one S=1 step (the
    decode route); hidden states and the cache agree."""
    from csm_tpu.models.llama import transformer_apply as j_apply
    from csm_tpu.ops.attention import causal_mask_from_positions as j_mask
    from csm_tpu.ops.kvcache import init_kv_cache as j_cache
    from csm_torch.ops.attention import causal_mask_from_positions as t_mask
    from csm_torch.ops.kvcache import init_kv_cache as t_cache

    jargs, targs, jparams, tparams = tiny
    cfg = targs.backbone
    rng = np.random.default_rng(2)
    B, T = 2, 24
    kv_pos = np.full((B, T), 1 << 28, np.int32)
    jp = jax.tree.map(jnp.asarray, jparams["backbone"])
    cj = j_cache(jargs.backbone, B, jnp.float32, T)
    ct = t_cache(cfg, B, torch.float32, T)
    for offset, S in ((0, 9), (9, 1)):
        h = rng.standard_normal((B, S, cfg.embed_dim)).astype(np.float32)
        pos = np.broadcast_to(np.arange(offset, offset + S, dtype=np.int32), (B, S))
        kv_pos[:, offset : offset + S] = pos
        hj, cj = j_apply(jp, jargs.backbone, jnp.asarray(h), jnp.asarray(pos),
                         j_mask(jnp.asarray(pos), jnp.asarray(kv_pos)), cj, jnp.int32(offset))
        tp, tk = torch.from_numpy(pos.copy()), torch.from_numpy(kv_pos.copy())
        ht, ct = tllama.transformer_apply(tparams["backbone"], cfg, torch.from_numpy(h), tp,
                                          t_mask(tp, tk), ct, offset)
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ct.k.numpy(), np.asarray(cj.k), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(ct.v.numpy(), np.asarray(cj.v), atol=TOL, rtol=TOL)


def test_generate_frame_argmax(tiny, monkeypatch):
    """Prefill frame then one step, fused weights, topk=1: tokens and kv
    positions equal.  The decoder's S=1 steps take the decode route."""
    jargs, targs, jparams, tparams = tiny
    K = targs.audio_num_codebooks
    tokens, mask = random_frames(targs, B=2, S=9)
    B, S, _ = tokens.shape
    jp = jcsm.fuse_csm_params(jax.tree.map(jnp.asarray, jparams))
    tp = tcsm.fuse_csm_params(tparams)
    step = jax.jit(jcsm.generate_frame, static_argnames=("args", "topk", "compute_dtype"))
    js = jcsm.init_frame_state(jargs, B, jnp.float32, max_seq_len=32)
    ts = tcsm.init_frame_state(targs, B, torch.float32, max_seq_len=32)
    routes = RouteCounter(monkeypatch)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    for _ in range(2):
        fj, js = step(jp, jargs, jax.random.key(0), jnp.asarray(tokens), jnp.asarray(mask),
                      jnp.asarray(pos), js, temperature=1.0, topk=1, compute_dtype=jnp.float32)
        ft, ts = tcsm.generate_frame(tp, targs, None, torch.from_numpy(tokens),
                                     torch.from_numpy(mask), torch.from_numpy(pos.copy()), ts,
                                     1.0, 1, torch.float32)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        tokens = np.zeros((B, 1, K + 1), np.int32)
        tokens[:, 0, :K] = np.asarray(fj)
        mask = np.zeros_like(tokens, bool)
        mask[..., :K] = True
        pos = np.full((B, 1), S, np.int32)
    assert ts.offset == int(js.offset) == S + 1
    np.testing.assert_array_equal(ts.kv_pos.numpy(), np.asarray(js.kv_pos))
    L_bb, L_dec = targs.backbone.num_layers, targs.decoder.num_layers
    assert routes.calls == {"decode": 2 * (K - 2) * L_dec + L_bb, "flash": 0}


def _prompts(args, lens, S_pad, seed=3):
    tokens, mask = random_frames(args, len(lens), S_pad, seed)
    for b, n in enumerate(lens):
        tokens[b, n:] = 0
        mask[b, n:] = False
    return tokens, mask, np.asarray(lens, np.int32)


def _generate_both(jargs, targs, jparams, tparams, lens, S_pad, max_frames):
    tokens, mask, plen = _prompts(targs, lens, S_pad)
    want = jgen.generate_audio_tokens_jit(
        jcsm.fuse_csm_params(jax.tree.map(jnp.asarray, jparams)), jargs, jax.random.key(0),
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(plen), max_frames=max_frames,
        temperature=1.0, topk=1, compute_dtype=jnp.float32)
    got = tgen.generate_audio_tokens(
        tcsm.fuse_csm_params(tparams), targs, tokens, mask, plen, max_frames=max_frames,
        temperature=1.0, topk=1, compute_dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(got.frames.numpy(), np.asarray(want.frames))
    np.testing.assert_array_equal(got.num_frames.numpy(), np.asarray(want.num_frames))
    return got


def test_generate_audio_tokens(tiny, monkeypatch):
    """Bucketed prefill of two ragged prompts, then the frame loop."""
    jargs, targs, jparams, tparams = tiny
    routes = RouteCounter(monkeypatch)
    max_frames = 6
    got = _generate_both(jargs, targs, jparams, tparams, (20, 33), 64, max_frames)
    assert got.steps == max_frames - 1
    K = targs.audio_num_codebooks
    L_bb, L_dec = targs.backbone.num_layers, targs.decoder.num_layers
    assert routes.calls == {
        "decode": max_frames * (K - 2) * L_dec + got.steps * L_bb, "flash": 0}


def test_flash_route_prefill(tiny, monkeypatch):
    """Prompts over 128 tokens pad to the 256 bucket: the port's prefill
    takes the flash route over the whole cache, the JAX package on the CPU
    takes XLA attention; frames agree."""
    jargs, targs, jparams, tparams = tiny
    long_j = dataclasses.replace(
        jargs, backbone_config=dataclasses.replace(jargs.backbone, max_seq_len=512))
    long_t = dataclasses.replace(
        targs, backbone_config=dataclasses.replace(targs.backbone, max_seq_len=512))
    routes = RouteCounter(monkeypatch)
    _generate_both(long_j, long_t, jparams, tparams, (150, 139), 256, 3)
    assert routes.calls["flash"] == long_t.backbone.num_layers


def test_entry_point_needs_a_card_unless_asked(tiny):
    _, targs, _, tparams = tiny
    tokens, mask, plen = _prompts(targs, (5,), 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tgen.generate_audio_tokens(tparams, targs, tokens, mask, plen, 2)
    with pytest.raises(ValueError, match="params are on"):
        tgen.generate_audio_tokens(tparams, targs, tokens, mask, plen, 2, device="meta")
