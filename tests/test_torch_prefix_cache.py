"""Shared-prefix serving in the port, on the CPU, against the JAX package.

The port's counterparts of tests/test_prefix_cache.py: both packages'
``BatchedServer`` run ``tiny_test_args()`` in float32 on the same weights
(the JAX random init bridged with ``params_from_jax``) and the same
requests, and at topk=1 a request served from a registered prefix gives
exactly the frames of the same request with the context inlined, in both
packages.  Beyond those: the registered blocks (k, v, kv_pos) against the
JAX ``register_prefix``'s within float32 rounding, a stream admitted before
its prefix is dropped or replaced keeps its frames, and a request of the
256 bucket after a prefix (the flash route's plain version in the port, the
masked path in the JAX package: the same function) equals the inline run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models.config import tiny_test_args, with_horizon
from csm_tpu.serving import BatchedServer as JaxServer
from csm_tpu.serving import StreamRequest as JaxRequest
from csm_torch.models import config as tconfig
from csm_torch.ops import kvcache as tkv
from csm_torch.serving import BatchedServer, StreamRequest
from test_torch_serving import _weights

ARGS = tconfig.tiny_test_args()
K = ARGS.audio_num_codebooks
F32 = dict(temperature=1.0, topk=1)


def make_frames(T, seed, audio_rows=0):
    """(T, K+1) frames: leading audio-context rows, then text rows."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((T, K + 1), np.int32)
    mask = np.zeros((T, K + 1), bool)
    tokens[:audio_rows, :K] = rng.integers(1, ARGS.audio_vocab_size, (audio_rows, K))
    mask[:audio_rows, :K] = True
    tokens[audio_rows:, -1] = rng.integers(1, ARGS.text_vocab_size, T - audio_rows)
    mask[audio_rows:, -1] = True
    return tokens, mask


def inline(ctx, txt):
    return tuple(np.concatenate([a, b]) for a, b in zip(ctx, txt))


class Both:
    """The port's server and the JAX server, built alike."""

    def __init__(self, args=None, params=None, **kw):
        jp, tp = params or _weights()
        jargs = args[0] if args else tiny_test_args()
        self.port = BatchedServer(tp, args[1] if args else ARGS, compute_dtype=torch.float32,
                                  device="cpu", **F32, **kw)
        self.jax = JaxServer(jp, jargs, compute_dtype=jnp.float32, **F32, **kw)

    def register(self, name, tokens, mask):
        self.port.register_prefix(name, tokens, mask)
        self.jax.register_prefix(name, tokens, mask)

    def serve(self, specs):
        """specs: (tokens, mask, max_frames, rid, prefix); the two servers'
        frames by id, asserted equal; returns the port's."""
        out = []
        for server, cls in ((self.port, StreamRequest), (self.jax, JaxRequest)):
            reqs = [cls(t, m, max_frames=mf, request_id=rid, prefix=p) for t, m, mf, rid, p in specs]
            out.append({r.request_id: r.frames for r in server.run(reqs)[0]})
        assert_same(*out)
        return out[0]


def assert_same(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")


def test_prefix_matches_inline():
    """Argmax decoding: a prefix-cached request == its context inlined."""
    ctx = make_frames(40, seed=7, audio_rows=36)
    kw = dict(n_slots=2, max_seq_len=256)
    txts = [make_frames(9 + rid, seed=rid + 1) for rid in range(2)]
    want = Both(**kw).serve([(*inline(ctx, t), 5, rid, None) for rid, t in enumerate(txts)])
    both = Both(**kw)
    both.register("voice", *ctx)
    got = both.serve([(*t, 5, rid, "voice") for rid, t in enumerate(txts)])
    assert_same(got, want)


def test_prefix_and_plain_share_a_server():
    ctx = make_frames(20, seed=3, audio_rows=16)
    kw = dict(n_slots=2, max_seq_len=256)
    txt, plain = make_frames(7, seed=4), make_frames(11, seed=5)
    want = Both(**kw).serve([(*inline(ctx, txt), 4, 0, None), (*plain, 4, 1, None)])
    both = Both(**kw)
    both.register("voice", *ctx)
    assert_same(both.serve([(*txt, 4, 0, "voice"), (*plain, 4, 1, None)]), want)


def test_prefix_int8_kv():
    """Quantized at registration == quantized at an inline prefill."""
    ctx, txt = make_frames(30, seed=11, audio_rows=24), make_frames(8, seed=12)
    kw = dict(n_slots=1, max_seq_len=256, kv_dtype="int8")
    want = Both(**kw).serve([(*inline(ctx, txt), 4, 0, None)])
    both = Both(**kw)
    both.register("voice", *ctx)
    assert_same(both.serve([(*txt, 4, 0, "voice")]), want)


def test_slot_reuse_after_prefix_request():
    """A slot that served a prefix request admits a longer plain request:
    the old prefix columns past the new prompt are never attended."""
    ctx = make_frames(40, seed=21, audio_rows=36)
    kw = dict(n_slots=1, max_seq_len=256)
    plain = make_frames(6, seed=22)
    want = Both(**kw).serve([(*plain, 5, 1, None)])
    both = Both(**kw)
    both.register("voice", *ctx)
    both.serve([(*make_frames(8, seed=23), 5, 0, "voice")])
    assert_same(both.serve([(*plain, 5, 1, None)]), want)


@pytest.mark.parametrize("int8", [False, True])
def test_prefix_blocks_match_jax(int8):
    """The registered K/V blocks and positions against the JAX
    ``register_prefix``'s: positions equal, float blocks within float32
    rounding, int8 codes within one step and scales within rounding."""
    ctx = make_frames(40, seed=7, audio_rows=36)
    both = Both(n_slots=1, max_seq_len=256, kv_dtype="int8" if int8 else "bf16")
    pre = both.port.register_prefix("voice", *ctx)
    jpre = both.jax.register_prefix("voice", *ctx)
    assert (pre.length, pre.bucket, pre.adapter) == (jpre.length, jpre.bucket, jpre.adapter) == (40, 64, None)
    np.testing.assert_array_equal(pre.kv_pos.numpy(), np.asarray(jpre.kv_pos))
    for half, jhalf in ((pre.k, jpre.k), (pre.v, jpre.v)):
        if int8:
            assert isinstance(half, tkv.QuantKV)
            assert np.abs(half.q.numpy().astype(int) - np.asarray(jhalf.q).astype(int)).max() <= 1
            np.testing.assert_allclose(half.s.numpy(), np.asarray(jhalf.s), rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_allclose(half.numpy(), np.asarray(jhalf), rtol=1e-5, atol=1e-5)
        assert (half.q if int8 else half).shape == (ARGS.backbone.num_layers, 1, 64,
                                                    ARGS.backbone.num_kv_heads,
                                                    ARGS.backbone.head_dim)


def test_prefix_then_flash_suffix_matches_inline():
    """A request of the 256 bucket after a 64-bucket prefix: the suffix's
    prefill takes the flash route from query position ``p_len``, over a
    row whose columns [p_len, 64) read PAD_POS.  Its frames equal the same
    request inlined (240 frames: the flash route over a whole prompt) and the
    JAX prefix server's."""
    jargs, targs = with_horizon(tiny_test_args(), 1024), tconfig.with_horizon(ARGS, 1024)
    assert dataclasses.asdict(jargs) == dataclasses.asdict(targs)
    ctx, txt = make_frames(40, seed=31, audio_rows=36), make_frames(200, seed=32)
    kw = dict(n_slots=1, max_seq_len=1024, args=(jargs, targs))
    want = Both(**kw).serve([(*inline(ctx, txt), 4, 0, None)])
    both = Both(**kw)
    both.register("voice", *ctx)
    assert_same(both.serve([(*txt, 4, 0, "voice")]), want)
    assert set(both.port._prefix_prefills) == {(64, 256)}


def test_prefix_errors():
    ctx, txt = make_frames(20, seed=31, audio_rows=16), make_frames(6, seed=32)
    server = BatchedServer(_weights()[1], ARGS, n_slots=1, max_seq_len=128, compute_dtype=torch.float32,
                           device="cpu", **F32)
    server.register_prefix("voice", *ctx)
    with pytest.raises(ValueError, match="unknown prefix"):
        server.submit(StreamRequest(*txt, max_frames=2, request_id=0, prefix="nope"))
    # prefix bucket 32 + prompt bucket 64 + 40 frames > 128
    with pytest.raises(ValueError, match="prefix bucket 32 \\+ prompt bucket 64"):
        server.submit(StreamRequest(*txt, max_frames=40, request_id=1, prefix="voice"))
    # adapters: the JAX package's refusals (an adapter that is not loaded;
    # a request under another adapter than its prefix's)
    with pytest.raises(ValueError, match="unknown adapter 'spk'"):
        server.register_prefix("x", *ctx, adapter="spk")
    with pytest.raises(ValueError, match="computed under adapter None"):
        server.submit(StreamRequest(*txt, max_frames=2, request_id=2, prefix="voice", adapter="spk"))
    assert not server.active.any()


def test_unregister_and_hot_swap_prefix():
    """unregister_prefix refuses later requests naming it; registering the
    name again swaps the preset: later requests decode as on a fresh server
    with the new context."""
    kw = dict(n_slots=1, max_seq_len=256)
    ctx_a = make_frames(20, seed=61, audio_rows=16)
    ctx_b = make_frames(24, seed=62, audio_rows=20)
    txt = make_frames(6, seed=63)
    want = {}
    for key, ctx in (("a", ctx_a), ("b", ctx_b)):
        fresh = Both(**kw)
        fresh.register("voice", *ctx)
        want[key] = fresh.serve([(*txt, 3, 0, "voice")])[0]
    both = Both(**kw)
    both.register("voice", *ctx_a)
    np.testing.assert_array_equal(both.serve([(*txt, 3, 0, "voice")])[0], want["a"])
    server = both.port
    server.unregister_prefix("voice")
    with pytest.raises(ValueError, match="unknown prefix"):
        server.submit(StreamRequest(*txt, max_frames=3, request_id=1, prefix="voice"))
    with pytest.raises(ValueError, match="unknown prefix"):
        server.unregister_prefix("voice")
    server.register_prefix("voice", *ctx_b)
    results, _ = server.run([StreamRequest(*txt, max_frames=3, request_id=2, prefix="voice")])
    np.testing.assert_array_equal(results[0].frames, want["b"])


@pytest.mark.parametrize("change", ["unregister", "re-register"])
def test_admitted_stream_keeps_its_prefix(change):
    """A stream admitted from a prefix keeps its frames when the prefix is
    dropped or replaced mid-stream (admission copied the blocks), and a
    second stream admitted from the new prefix gets the new context."""
    kw = dict(n_slots=2, max_seq_len=256, chunk_size=2)
    ctx_a, ctx_b = make_frames(20, seed=71, audio_rows=16), make_frames(30, seed=72, audio_rows=26)
    txt = make_frames(6, seed=73)
    want = {}
    for key, ctx in (("a", ctx_a), ("b", ctx_b)):
        fresh = Both(**kw)
        fresh.register("voice", *ctx)
        want[key] = fresh.serve([(*txt, 8, 0, "voice")])[0]
    server = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", **F32, **kw)
    server.register_prefix("voice", *ctx_a)
    server.submit(StreamRequest(*txt, max_frames=8, request_id="a", prefix="voice"))
    done = server.step()
    server.unregister_prefix("voice")
    if change == "re-register":
        server.register_prefix("voice", *ctx_b)
        server.submit(StreamRequest(*txt, max_frames=8, request_id="b", prefix="voice"))
    done += server.run([])[0]
    got = {r.request_id: r.frames for r in done}
    np.testing.assert_array_equal(got["a"], want["a"])
    if change == "re-register":
        np.testing.assert_array_equal(got["b"], want["b"])


def test_prefix_too_long_rejected():
    server = BatchedServer(_weights()[1], ARGS, n_slots=1, max_seq_len=64, compute_dtype=torch.float32,
                           device="cpu", **F32)
    with pytest.raises(ValueError, match="leaves no room"):
        server.register_prefix("big", *make_frames(60, seed=41, audio_rows=50))
    assert not server._prefixes


def test_warmup_covers_prefix_programs():
    """warmup() also runs the (prefix bucket, prompt bucket) admission of
    every registered prefix, and leaves the prefix registered."""
    server = BatchedServer(_weights()[1], ARGS, n_slots=1, max_seq_len=256, compute_dtype=torch.float32,
                           device="cpu", **F32)
    server.register_prefix("voice", *make_frames(20, seed=51, audio_rows=16))
    assert set(server._register_fns) == {32} and server.register_calls == {32: 1}
    assert server.warmup() > 0 and not server.active.any()
    assert set(server._prefix_prefills) == {(32, 64)}  # a 20-frame context takes bucket 32
    results, _ = server.run([StreamRequest(*make_frames(6, seed=52), max_frames=3, request_id=0,
                                           prefix="voice")])
    assert results and 1 <= results[0].frames.shape[0] <= 3
