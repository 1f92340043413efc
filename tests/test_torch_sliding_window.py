"""Sliding-window serving in the port, on the CPU, against the JAX package.

The port's counterparts of tests/test_sliding_window.py: inside the window
a windowed server equals a plain one; beyond it the ring write equals an
explicit-eviction oracle (a large cache whose evicted entries read
PAD_POS); a session runs past ``max_seq_len``; the RoPE re-anchor keeps
greedy decode exactly (float and int8 KV); a window that holds only the
prompt is refused; ``with_horizon`` extends RoPE only; pipelined equals
synchronous.  Frames are held equal to the JAX ``BatchedServer``'s at topk=1
on the same weights (``tiny_test_args()`` in float32, the JAX random init
bridged with ``params_from_jax``).  The port's own cases: the constructor's
checks with the JAX package's messages, a prefix under a window, and a
capacity captured for the first time while windowed rows are live
(``capture_graphs`` replaced by its eager warm-up pass, as on a card): the
live rows' codes do not change.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args, with_horizon
from csm_tpu.serving import BatchedServer as JaxServer
from csm_tpu.serving import StreamRequest as JaxRequest
from csm_torch import serving
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.serving import BatchedServer, StreamRequest
from test_torch_serving import _weights

ARGS = tconfig.tiny_test_args()
K = ARGS.audio_num_codebooks
SERVER = dict(n_slots=2, max_seq_len=128, temperature=1.0, topk=1, chunk_size=4)


def _prompt(T=20, seed=3):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((T, K + 1), np.int32)
    mask = np.zeros((T, K + 1), bool)
    tokens[:, -1] = rng.integers(1, ARGS.text_vocab_size, T)
    mask[:, -1] = True
    return tokens, mask


def port_serve(window, max_frames, T=20, seed=3, **kw):
    srv = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", window=window,
                        **dict(SERVER, **kw))
    results, _ = srv.run([StreamRequest(*_prompt(T, seed), max_frames=max_frames)])
    return results[0]


def jax_serve(window, max_frames, T=20, seed=3, **kw):
    srv = JaxServer(_weights()[0], tiny_test_args(), compute_dtype=jnp.float32, window=window,
                    **dict(SERVER, **kw))
    results, _ = srv.run([JaxRequest(*_prompt(T, seed), max_frames=max_frames)])
    return results[0]


def test_windowed_matches_plain_inside_window():
    """No eviction (prompt and frames fit the window): the frames of the
    unwindowed server, and of the JAX windowed server."""
    windowed = port_serve(96, 20)  # anchor: the 64 bucket; a 32-column ring > 20 frames
    np.testing.assert_array_equal(windowed.frames, port_serve(None, 20).frames)
    np.testing.assert_array_equal(windowed.frames, jax_serve(96, 20).frames)


def test_ring_eviction_matches_explicit_eviction_oracle():
    """generate_frame driven directly: ring writes into a W-column cache
    give the greedy codes of a large cache whose decode entries older than
    the ring read PAD_POS, step by step over several wraps; and the JAX
    package's ring run gives the same codes."""
    anchor, ring, steps = 8, 6, 16
    W = anchor + ring
    jp, tp = _weights()
    rng = np.random.default_rng(0)
    prompt = np.zeros((1, anchor, K + 1), np.int32)
    pmask = np.zeros((1, anchor, K + 1), bool)
    prompt[0, :, -1] = rng.integers(1, ARGS.text_vocab_size, anchor)
    pmask[0, :, -1] = True
    gen = torch.Generator().manual_seed(0)
    step_mask = torch.zeros((1, 1, K + 1), dtype=torch.bool)
    step_mask[0, 0, :K] = True

    def frame(tokens, mask, pos, state):
        return tcsm.generate_frame(tp, ARGS, gen, tokens, mask, pos, state, 1.0, 1, torch.float32)

    def step(f, pos, state):
        tokens = torch.zeros((1, 1, K + 1), dtype=torch.int32)
        tokens[0, 0, :K] = f[0]
        return frame(tokens, step_mask, torch.full((1, 1), pos, dtype=torch.int32), state)

    ppos = torch.arange(anchor, dtype=torch.int32)[None]
    f_ring, st_ring = frame(torch.from_numpy(prompt), torch.from_numpy(pmask), ppos,
                            tcsm.init_frame_state(ARGS, 1, torch.float32, W))
    f_big, st_big = frame(torch.from_numpy(prompt), torch.from_numpy(pmask), ppos,
                          tcsm.init_frame_state(ARGS, 1, torch.float32, 128))
    np.testing.assert_array_equal(f_ring.numpy(), f_big.numpy())
    ring_codes = [f_ring.numpy()]
    for t in range(steps):
        pos = anchor + t
        st_ring = st_ring._replace(offset=anchor + (st_ring.offset - anchor) % ring)
        f_ring, st_ring = step(f_ring, pos, st_ring)
        kv = st_big.kv_pos
        kv[(kv >= anchor) & (kv <= pos - ring)] = tcsm.PAD_POS  # evict, keep the anchor
        f_big, st_big = step(f_big, pos, st_big)
        np.testing.assert_array_equal(f_ring.numpy(), f_big.numpy(), err_msg=f"step {t}")
        ring_codes.append(f_ring.numpy())

    jargs = tiny_test_args()

    @jax.jit
    def jframe(tokens, mask, pos, state):
        return jcsm.generate_frame(jp, jargs, jax.random.key(1), tokens, mask, pos, state, 1.0, 1,
                                   jnp.float32)

    jf, jst = jframe(jnp.asarray(prompt), jnp.asarray(pmask), jnp.asarray(ppos.numpy()),
                     jcsm.init_frame_state(jargs, 1, jnp.float32, max_seq_len=W))
    jcodes = [np.asarray(jf)]
    jmask = jnp.asarray(step_mask.numpy())
    for t in range(steps):
        jst = jst._replace(offset=jnp.int32(anchor + (int(jst.offset) - anchor) % ring))
        tokens = jnp.zeros((1, 1, K + 1), jnp.int32).at[:, 0, :K].set(jf)
        jf, jst = jframe(tokens, jmask, jnp.full((1, 1), anchor + t, jnp.int32), jst)
        jcodes.append(np.asarray(jf))
    np.testing.assert_array_equal(np.stack(ring_codes), np.stack(jcodes))


def test_unbounded_session_runs_past_max_seq_len():
    """A stream longer than the cache holds runs its whole budget (random
    weights never emit EOS here), with the JAX server's frames."""
    res = port_serve(96, 220)
    assert res.n_steps == 220
    np.testing.assert_array_equal(res.frames, jax_serve(96, 220).frames)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_reanchor_preserves_greedy_decode(kv_dtype):
    """Frequent re-anchors (a 30-position headroom: from position 118, every
    20 frames) give the greedy stream of a server that never re-anchors, and
    the JAX server's with the same headroom.  int8: the rotated region is
    requantized (one more int8 rounding), the rest keeps its codes."""
    base = port_serve(96, 160, T=12, kv_dtype=kv_dtype)
    server = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", window=96,
                           reanchor_headroom=30, kv_dtype=kv_dtype, **SERVER)
    rows = []
    real = server._reanchor
    server._reanchor = lambda row, delta: rows.append((row, delta)) or real(row, delta)
    results, _ = server.run([StreamRequest(*_prompt(12), max_frames=160)])
    assert len(rows) >= 3 and all(d > 0 for _, d in rows)
    assert int(server.state.kv_pos[0, 0]) < 0  # the anchor's positions went negative
    np.testing.assert_array_equal(results[0].frames, base.frames)
    np.testing.assert_array_equal(
        results[0].frames, jax_serve(96, 160, T=12, kv_dtype=kv_dtype, reanchor_headroom=30).frames)


def test_windowed_rejects_promptonly_window():
    server = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", window=66,
                           **dict(SERVER, n_slots=1))
    with pytest.raises(ValueError, match="ring"):
        server.submit(StreamRequest(*_prompt(20), max_frames=10))  # bucket 64 + 10 > 66
    assert not server.active.any()


@pytest.mark.parametrize("kw", [dict(window=256), dict(window=9), dict(window=96, reanchor_headroom=15)])
def test_window_checks_match_jax(kw):
    """The constructor refuses a window past max_seq_len, one too small for
    two chunks, and a headroom under 3·chunk + 4, with the JAX messages."""
    with pytest.raises(ValueError) as port:
        BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", **SERVER, **kw)
    with pytest.raises(ValueError) as ref:
        JaxServer(_weights()[0], tiny_test_args(), compute_dtype=jnp.float32, **SERVER, **kw)
    assert str(port.value) == str(ref.value)


def test_with_horizon_extends_rope_only():
    a = tconfig.with_horizon(ARGS, 4096)
    assert a.backbone.max_seq_len == 4096
    assert a.decoder.max_seq_len == ARGS.decoder.max_seq_len
    assert a.audio_vocab_size == ARGS.audio_vocab_size
    assert tconfig.with_horizon(ARGS, 16) is ARGS  # never shrinks
    assert dataclasses.asdict(a) == dataclasses.asdict(with_horizon(tiny_test_args(), 4096))
    server = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", window=96,
                           **SERVER)
    assert server.args.backbone.max_seq_len == 96 + 1024 and server.cache_len == 96
    assert server.state.kv_pos.shape == (2, 96)


def test_windowed_pipelined_matches_sync():
    sync = port_serve(96, 100, T=12)
    np.testing.assert_array_equal(port_serve(96, 100, T=12, pipelined=True).frames, sync.frames)
    np.testing.assert_array_equal(sync.frames, jax_serve(96, 100, T=12).frames)


def test_prefix_under_a_window_matches_jax():
    """A prefix request in windowed mode: the anchor is prefix bucket +
    prompt bucket, the ring the rest, re-anchors rotate the prefix's
    columns too; a plain request beside it.  Both streams run past
    ``max_seq_len`` with the JAX server's frames."""
    rng = np.random.default_rng(9)
    ctx_t = np.zeros((24, K + 1), np.int32)
    ctx_t[:, :K] = rng.integers(1, ARGS.audio_vocab_size, (24, K))
    ctx_m = np.zeros((24, K + 1), bool)
    ctx_m[:, :K] = True
    kw = dict(SERVER, window=120, reanchor_headroom=40)
    got = []
    for server, cls in ((BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", **kw),
                         StreamRequest),
                        (JaxServer(_weights()[0], tiny_test_args(), compute_dtype=jnp.float32, **kw),
                         JaxRequest)):
        server.register_prefix("voice", ctx_t, ctx_m)
        results, _ = server.run([cls(*_prompt(10, 4), max_frames=150, request_id=0, prefix="voice"),
                                 cls(*_prompt(14, 5), max_frames=140, request_id=1)])
        got.append({r.request_id: r.frames for r in results})
    assert {rid: len(f) for rid, f in got[0].items()} == {0: 150, 1: 140}
    for rid in (0, 1):
        np.testing.assert_array_equal(got[0][rid], got[1][rid], err_msg=f"request {rid}")


class _Eager:
    """A stand-in for a captured graph: its replay runs the function."""

    def __init__(self, fn):
        self.fn = fn

    def reset(self):
        pass


def _eager_capture(fns, device, pool=None):
    """``capture_graphs`` on the CPU: the eager warm-up pass that precedes
    every capture on a card, then "graphs" that run the functions."""
    for fn in fns:
        fn()
    return [(_Eager(fn), []) for fn in fns]


def test_lazy_capture_leaves_live_windowed_rows(monkeypatch):
    """A capacity captured for the first time while a windowed row has
    wrapped its ring: the capture's warm-up pass (every row dead, every
    column past the cache) writes nothing, so the live rows' codes equal a
    server whose capacities ``warmup`` captured before any traffic, and an
    uncaptured one."""
    monkeypatch.setattr(serving, "capture_graphs", _eager_capture)
    monkeypatch.setattr(serving, "replay", lambda entry: entry[0].fn())

    def scenario(warm, graphs=True):
        server = BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu",
                               window=96, **dict(SERVER, n_slots=4))
        server.graphs = graphs
        if warm:
            server.warmup()
        server.reset(0)
        first = [StreamRequest(*_prompt(12, 1), max_frames=90, request_id="a")]
        later = [StreamRequest(*_prompt(9 + i, 2 + i), max_frames=40, request_id=i) for i in range(3)]
        server.submit(first[0])
        done = []
        for _ in range(12):  # 48 frames: the 32-column ring has wrapped
            done += server.step()
        assert server._pos_host[0] > 12 + 32  # more frames than ring columns
        for r in later:  # 4 live rows: the full batch, captured now unless warmed
            server.submit(r)
        done += server.run([])[0]
        return {r.request_id: r.frames for r in done}, server

    lazy, server = scenario(warm=False)
    assert set(server._decodes) == {1, 4}  # the full batch was captured mid-traffic
    warm, _ = scenario(warm=True)
    plain, _ = scenario(warm=False, graphs=False)
    for rid in warm:
        np.testing.assert_array_equal(lazy[rid], warm[rid], err_msg=f"request {rid}")
        np.testing.assert_array_equal(plain[rid], warm[rid], err_msg=f"request {rid}")
