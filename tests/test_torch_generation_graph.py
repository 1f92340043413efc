"""The graphed generation entry's step loop on the CPU, held against the JAX
package and against the port's eager loop.

``generate_audio_tokens_jit`` runs the prefill frame and the S=1 frame step
as functions of static buffers (``FrameGraphs``); on a card they are CUDA
graph replays, here they run without capture, and the host reads ``done``
once per ``CHUNK`` steps.  At ``tiny_test_args()`` in float32: tokens equal
the JAX ``generate_audio_tokens`` at topk=1 (float, int8, int4, int8 KV;
B=1 and 2; the flash route's plain version at bucket 256), codes equal the
eager loop's at topk=50 on one seed, a forced EOS in the middle of a chunk
gives the eager loop's frames and counts, and a second prompt on the same
buffers gives a fresh run's frames.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models import generation as jgen
from csm_tpu.models.config import tiny_test_args
from csm_tpu.ops import kvcache as jkv
from csm_tpu.utils import quantize as jq
from csm_torch import generator as tgenr
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.models import generation as tgen
from csm_torch.models import llama as tllama
from csm_torch.ops import kvcache as tkv
from csm_torch.utils.params import params_from_jax

CHUNK = tgen.CHUNK


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams


def _long(args):
    """``args`` with a 512-slot backbone, for prompts in the 256 bucket."""
    return dataclasses.replace(
        args, backbone_config=dataclasses.replace(args.backbone, max_seq_len=512))


def _prompts(args, lens, S_pad, seed=3):
    rng = np.random.default_rng(seed)
    K, B = args.audio_num_codebooks, len(lens)
    tokens = np.zeros((B, S_pad, K + 1), np.int32)
    mask = np.zeros((B, S_pad, K + 1), bool)
    for b, n in enumerate(lens):
        tokens[b, :n, -1] = rng.integers(1, args.text_vocab_size, n)
        mask[b, :n, -1] = True
    return tokens, mask, np.asarray(lens, np.int32)


def _jax_frames(jargs, jp, prompts, max_frames, kv8=False):
    tokens, mask, plen = prompts
    r = jgen.generate_audio_tokens_jit(
        jcsm.fuse_csm_params(jax.tree.map(jnp.asarray, jp)), jargs, jax.random.key(0),
        jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(plen), max_frames=max_frames,
        temperature=1.0, topk=1, compute_dtype=jnp.float32, kv_dtype=jnp.int8 if kv8 else None)
    return np.array(r.frames), np.array(r.num_frames)


def _kw(max_frames, topk=1, kv8=False, **extra):
    return dict(max_frames=max_frames, temperature=1.0, topk=topk, compute_dtype=torch.float32,
                device="cpu", kv_dtype=torch.int8 if kv8 else None, **extra)


class HostReads:
    """Counts the step loop's host reads of ``done``."""

    def __init__(self, monkeypatch):
        self.n = 0
        inner = tgen.FrameGraphs.all_done

        def all_done(fg):
            self.n += 1
            return inner(fg)

        monkeypatch.setattr(tgen.FrameGraphs, "all_done", all_done)


@pytest.mark.parametrize("lens,S_pad,max_frames", [
    ((20,), 64, CHUNK + 3), ((20, 33), 64, CHUNK + 3), ((150, 139), 256, 4)])
def test_step_loop_matches_jax(tiny, monkeypatch, lens, S_pad, max_frames):
    """Tokens at topk=1 equal the JAX program's, with one host read after
    the prefill and one per chunk; at bucket 256 the prefill takes the
    flash route (its plain version here)."""
    jargs, targs, jparams = tiny
    if S_pad > 128:
        jargs, targs = _long(jargs), _long(targs)
    prompts = _prompts(targs, lens, S_pad)
    want_frames, want_num = _jax_frames(jargs, jparams, prompts, max_frames)
    reads = HostReads(monkeypatch)
    flash = []
    inner = tllama.flash_gqa_attention
    monkeypatch.setattr(tllama, "flash_gqa_attention", lambda *a: flash.append(1) or inner(*a))
    got = tgen.generate_audio_tokens_jit(
        tcsm.fuse_csm_params(params_from_jax(jparams)), targs, *prompts, **_kw(max_frames))
    np.testing.assert_array_equal(got.frames.numpy(), want_frames)
    np.testing.assert_array_equal(got.num_frames.numpy(), want_num)
    assert got.steps == max_frames - 1 and got.capture_s == 0.0
    assert reads.n == 1 + math.ceil((max_frames - 1) / CHUNK)
    assert len(flash) == (targs.backbone.num_layers if S_pad >= 256 else 0)


class ForcedEOS:
    """The port's sampler, except that row b samples 0 for every codebook
    from frame ``eos_at[b]`` on (frame = call // K: one call per codebook
    a frame, the prefill frame being 0)."""

    def __init__(self, inner, K, eos_at):
        self.inner, self.K, self.eos_at, self.calls = inner, K, eos_at, 0

    def __call__(self, logits, topk, temperature, generator=None, uniforms=None):
        out = self.inner(logits, topk, temperature, generator, uniforms)
        frame = self.calls // self.K
        self.calls += 1
        dead = torch.tensor([frame >= f for f in self.eos_at])
        return torch.where(dead, 0, out)


def test_forced_eos_in_the_middle_of_a_chunk(tiny, monkeypatch):
    """Rows emit EOS at frames 3 and CHUNK + 3: every row is done inside the
    second chunk.  The step loop runs that chunk to its end, the eager loop
    stops at the EOS; frames, counts and the zeros after each row's EOS are
    equal, and equal the JAX program's frames cut at each row's EOS (rows
    do not interact, so a row's frames before its EOS are the unforced
    run's)."""
    jargs, targs, jparams = tiny
    K = targs.audio_num_codebooks
    eos_at, max_frames = (3, CHUNK + 3), 2 * CHUNK + 3
    prompts = _prompts(targs, (20, 33), 64)
    want_frames, _ = _jax_frames(jargs, jparams, prompts, max_frames)
    for b, f in enumerate(eos_at):
        want_frames[b, f:] = 0
    params = tcsm.fuse_csm_params(params_from_jax(jparams))
    inner = tcsm.sample_topk
    runs = {}
    for name, fn in (("eager", tgen.generate_audio_tokens), ("steps", tgen.generate_audio_tokens_jit)):
        monkeypatch.setattr(tcsm, "sample_topk", ForcedEOS(inner, K, eos_at))
        runs[name] = fn(params, targs, *prompts, **_kw(max_frames))
    for r in runs.values():
        np.testing.assert_array_equal(r.frames.numpy(), want_frames)
        np.testing.assert_array_equal(r.num_frames.numpy(), eos_at)
    assert runs["eager"].steps == max(eos_at)
    assert runs["steps"].steps == 2 * CHUNK  # the chunk holding the last EOS runs out


def test_step_loop_matches_eager_at_topk50(tiny):
    """The same uniforms in the same order from one seed: codes equal the
    eager loop's at topk=50 and temperature 0.9, B=2."""
    _, targs, jparams = tiny
    params = tcsm.fuse_csm_params(params_from_jax(jparams))
    prompts = _prompts(targs, (20, 33), 64)
    kw = _kw(CHUNK + 3, topk=50)
    kw["temperature"] = 0.9
    eager = tgen.generate_audio_tokens(params, targs, *prompts,
                                       generator=torch.Generator().manual_seed(7), **kw)
    steps = tgen.generate_audio_tokens_jit(params, targs, *prompts,
                                           generator=torch.Generator().manual_seed(7), **kw)
    np.testing.assert_array_equal(steps.frames.numpy(), eager.frames.numpy())
    np.testing.assert_array_equal(steps.num_frames.numpy(), eager.num_frames.numpy())
    assert len(np.unique(eager.frames.numpy())) > 10  # sampled, not argmax


@pytest.mark.parametrize("mode", ["int8", "int4", "kv_int8"])
def test_step_loop_quantized_matches_jax(tiny, mode):
    jargs, targs, jparams = tiny
    jp = jax.tree.map(jnp.asarray, jparams)
    if mode == "int8":
        jp = jq.quantize_csm_params(jp)
    elif mode == "int4":
        jp = jq.quantize_csm_params_int4(jp, group_size=32)
    jp = jax.tree.map(np.asarray, jp)
    kv8 = mode == "kv_int8"
    prompts = _prompts(targs, (20, 33), 64)
    want_frames, want_num = _jax_frames(jargs, jp, prompts, CHUNK + 2, kv8)
    got = tgen.generate_audio_tokens_jit(
        tcsm.fuse_csm_params(params_from_jax(jp)), targs, *prompts, **_kw(CHUNK + 2, kv8=kv8))
    np.testing.assert_array_equal(got.frames.numpy(), want_frames)
    np.testing.assert_array_equal(got.num_frames.numpy(), want_num)


@pytest.mark.parametrize("kv8", [False, True])
def test_second_generate_reuses_the_buffers(tiny, kv8):
    """A shorter prompt in the same bucket replays on the buffers the first
    one left (stale cache, frames, counters): frames equal a fresh run's."""
    _, targs, jparams = tiny
    params = tcsm.fuse_csm_params(params_from_jax(jparams))
    cache = tgen.GraphCache()
    kw = _kw(CHUNK + 1, topk=50, kv8=kv8)
    tgen.generate_audio_tokens_jit(params, targs, *_prompts(targs, (40,), 64, seed=5),
                                   generator=torch.Generator().manual_seed(1), graphs=cache, **kw)
    (fg,) = cache._items.values()
    short = _prompts(targs, (12,), 64, seed=6)
    again = tgen.generate_audio_tokens_jit(params, targs, *short, graphs=cache,
                                           generator=torch.Generator().manual_seed(2), **kw)
    fresh = tgen.generate_audio_tokens_jit(params, targs, *short,
                                           generator=torch.Generator().manual_seed(2), **kw)
    assert list(cache._items.values()) == [fg]
    np.testing.assert_array_equal(again.frames.numpy(), fresh.frames.numpy())
    np.testing.assert_array_equal(again.num_frames.numpy(), fresh.num_frames.numpy())


def test_graph_cache_is_a_small_lru(tiny):
    _, targs, jparams = tiny
    params = tcsm.fuse_csm_params(params_from_jax(jparams))
    cache = tgen.GraphCache(size=2)
    for max_frames in (2, 3, 2, 4):
        tgen.generate_audio_tokens_jit(params, targs, *_prompts(targs, (9,), 64), graphs=cache,
                                       **_kw(max_frames))
    assert [k.max_frames for k in cache._items] == [2, 4]
    cache.clear()
    assert len(cache) == 0


@pytest.mark.parametrize("quantized", [False, True])
def test_update_layer_device_index_matches_slice(tiny, quantized):
    """The write at a device column index (``index_copy_``) equals the slice
    write and the JAX ``update_layer`` over a cache holding stale rows."""
    jargs, targs, _ = tiny
    cfg = targs.backbone
    rng = np.random.default_rng(8)
    shape = (2, 12, cfg.num_kv_heads, cfg.head_dim)
    old = rng.standard_normal(shape).astype(np.float32)
    kn = rng.standard_normal((2, 3) + shape[2:]).astype(np.float32)
    vn = rng.standard_normal(kn.shape).astype(np.float32)

    def cache():
        if quantized:
            return tuple(tkv.quantize_kv_rows(torch.from_numpy(old)) for _ in range(2))
        return tuple(torch.from_numpy(old.copy()) for _ in range(2))

    by_slice = tkv.update_layer(*cache(), torch.from_numpy(kn), torch.from_numpy(vn), 4)
    by_index = tkv.update_layer(*cache(), torch.from_numpy(kn), torch.from_numpy(vn),
                                torch.arange(4, 7))
    if quantized:
        jc = jkv.quantize_kv_rows(jnp.asarray(old))
        want = jkv.update_layer(jc, jc, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(4))
        leaves = [(a.q, b.q, c.q) for a, b, c in zip(by_slice, by_index, want)]
        leaves += [(a.s, b.s, c.s) for a, b, c in zip(by_slice, by_index, want)]
    else:
        jc = jnp.asarray(old)
        want = jkv.update_layer(jc, jc, jnp.asarray(kn), jnp.asarray(vn), jnp.int32(4))
        leaves = list(zip(by_slice, by_index, want))
    for a, b, c in leaves:
        np.testing.assert_array_equal(b.numpy(), a.numpy())
        np.testing.assert_array_equal(b.numpy(), np.asarray(c))


def _eager_in_place(monkeypatch):
    """``Generator`` runs the eager loop where it calls the graphed entry."""
    monkeypatch.setattr(tgenr, "generate_audio_tokens_jit",
                        lambda *a, graphs=None, **k: tgen.generate_audio_tokens(*a, **k))


def test_generator_routes_through_the_graphed_entry(tiny, monkeypatch):
    """``Generator`` calls the graphed entry and keeps its key; the eager
    loop put in its place gives the same waveform, and ``close`` drops the
    graphs and the weights."""
    _, targs, _ = tiny
    g = tgenr.load_csm(args=targs, device="cpu", text_tokenizer=ByteTokenizer())
    called = []
    inner = tgenr.generate_audio_tokens_jit
    monkeypatch.setattr(tgenr, "generate_audio_tokens_jit",
                        lambda *a, **k: called.append(k["graphs"]) or inner(*a, **k))
    kw = dict(max_audio_length_ms=400, topk=50, seed=3)
    graphed = g.generate("hello there", **kw)
    assert called == [g.graphs] and len(g.graphs) == 1 and g.last_stats["steps"] == 4
    _eager_in_place(monkeypatch)
    eager = g.generate("hello there", **kw)
    np.testing.assert_array_equal(graphed, eager)
    g.close()
    assert len(g.graphs) == 0 and g.params is None


def test_one_frame_generate_matches_the_eager_loop(tiny, monkeypatch):
    """At ``max_frames`` 1 (80 to 159 ms of audio) only the prefill frame
    runs: the graphed entry and ``Generator.generate`` give the eager loop's
    frame, with no step."""
    _, targs, jparams = tiny
    params = tcsm.fuse_csm_params(params_from_jax(jparams))
    prompts = _prompts(targs, (20, 33), 64)
    kw = _kw(1, topk=50)
    eager = tgen.generate_audio_tokens(
        params, targs, *prompts, generator=torch.Generator().manual_seed(2), **kw)
    got = tgen.generate_audio_tokens_jit(
        params, targs, *prompts, generator=torch.Generator().manual_seed(2), **kw)
    assert got.steps == eager.steps == 0 and got.frames.shape[1] == 1
    np.testing.assert_array_equal(got.frames.numpy(), eager.frames.numpy())
    np.testing.assert_array_equal(got.num_frames.numpy(), eager.num_frames.numpy())

    g = tgenr.load_csm(args=targs, device="cpu", text_tokenizer=ByteTokenizer())
    graphed = g.generate("hello there", max_audio_length_ms=150, seed=3)
    assert g.last_stats["steps"] == 0 and len(graphed) > 0
    _eager_in_place(monkeypatch)
    np.testing.assert_array_equal(graphed, g.generate("hello there", max_audio_length_ms=150, seed=3))
