"""The port's continuous-batching server on the CPU against the JAX
package's ``BatchedServer``.

Both run ``tiny_test_args()`` in float32 on the same weights (the JAX
random init bridged with ``params_from_jax``) and the same requests; at
topk=1 every stream's frames must be exactly equal.  These are the port's
counterparts of tests/test_serving.py (all but meshes and adapters, which
wait for later slices and raise; prefixes and windows have files of their
own, test_torch_prefix_cache.py and test_torch_sliding_window.py): the server against
single-stream generation, continuous admission and slot reuse, budget
validation, chunked decode, quantized weights and the ``auto`` policy, the
int8 KV cache, streams finished at submit, streaming callbacks, the
capacity selector, a compacted server against a dedicated one, warmup,
cancel, the ramp chunk, and the pipelined server.  Two cases are the
port's own: streams whose dead rows' cache columns run past the cache's
end (dropped in both packages), and the per-row offset at B=1.  Sampled
codes (topk > 1) are compared only between two port servers: the JAX
server's ``fold_in`` key schedule is not reproduced.
"""

import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.serving import BatchedServer as JaxServer
from csm_tpu.serving import StreamRequest as JaxRequest
from csm_torch.models import config as tconfig
from csm_torch.models import csm as tcsm
from csm_torch.models import generation as tgen
from csm_torch.ops import kvcache as tkv
from csm_torch.serving import BatchedServer, StreamRequest
from csm_torch.utils import quantize as tq
from csm_torch.utils.params import params_from_jax

ARGS = tconfig.tiny_test_args()
K = ARGS.audio_num_codebooks


@functools.lru_cache(maxsize=1)
def _weights():
    """(JAX params, the same weights as port tensors)."""
    jp = jcsm.init_csm_params(jax.random.key(0), tiny_test_args(), jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _prompt(T, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((T, K + 1), np.int32)
    mask = np.zeros((T, K + 1), bool)
    tokens[:, -1] = rng.integers(1, ARGS.text_vocab_size, T)
    mask[:, -1] = True
    return tokens, mask


def make_request(T, rid, seed, max_frames=4, cls=StreamRequest):
    return cls(*_prompt(T, seed), max_frames=max_frames, request_id=rid)


def port_server(**kw):
    kw = dict(dict(temperature=1.0, topk=1), **kw)
    return BatchedServer(_weights()[1], ARGS, compute_dtype=torch.float32, device="cpu", **kw)


def serve(specs, **kw):
    """The port server's frames by request id; ``specs`` are
    (T, rid, seed, max_frames) tuples."""
    results, _ = port_server(**kw).run([make_request(*s) for s in specs])
    return {r.request_id: r.frames for r in results}


@functools.lru_cache(maxsize=None)
def jax_serve(specs, **kw):
    """The JAX server's frames on the same requests (cached per case)."""
    kw = dict(dict(temperature=1.0, topk=1), **kw)
    server = JaxServer(_weights()[0], tiny_test_args(), compute_dtype=jnp.float32, **kw)
    results, _ = server.run([make_request(*s, cls=JaxRequest) for s in specs])
    return {r.request_id: r.frames for r in results}


def _halves(half):
    return [half.q, half.s] if isinstance(half, tkv.QuantKV) else [half]


def assert_same(got, want):
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")


def solo_frames(T, seed, max_frames, params=None, kv_dtype=None):
    """The port's single-stream eager generation of one request."""
    tokens, mask = _prompt(T, seed)
    toks = np.zeros((1, 64, K + 1), np.int32)
    msk = np.zeros((1, 64, K + 1), bool)
    toks[0, :T], msk[0, :T] = tokens, mask
    res = tgen.generate_audio_tokens(
        params if params is not None else _weights()[1], ARGS, toks, msk, np.array([T], np.int32),
        max_frames=max_frames, temperature=1.0, topk=1, compute_dtype=torch.float32,
        device="cpu", kv_dtype=kv_dtype)
    return res.frames[0, : int(res.num_frames[0])].numpy()


# ---------------------------------------------------------------- the server against JAX


TWO = ((6, 0, 1, 4), (9, 1, 2, 4))


def test_server_matches_jax_and_single_stream():
    kw = dict(n_slots=2, max_seq_len=128)
    got = serve(TWO, **kw)
    assert_same(got, jax_serve(TWO, **kw))
    for T, rid, seed, mf in TWO:
        np.testing.assert_array_equal(got[rid], solo_frames(T, seed, mf))


@pytest.mark.parametrize("case", ["admission", "slot_reuse", "chunked"])
def test_continuous_batching_matches_jax(case):
    """3 requests over 2 slots (the third admits when a slot frees); 8
    requests through one slot, far more frames than the cache holds (each
    admission starts its row over); chunk 4."""
    specs, kw = {
        "admission": (tuple((5 + i, i, 10 + i, 3) for i in range(3)),
                      dict(n_slots=2, max_seq_len=256)),
        "slot_reuse": (tuple((6, i, 1, 20) for i in range(8)),
                       dict(n_slots=1, max_seq_len=96, chunk_size=2)),
        "chunked": (((6, 0, 1, 6), (9, 1, 2, 6)), dict(n_slots=2, max_seq_len=256, chunk_size=4)),
    }[case]
    got = serve(specs, **kw)
    assert_same(got, jax_serve(specs, **kw))
    if case == "slot_reuse":  # identical prompts, identical argmax streams
        assert all(np.array_equal(f, got[0]) for f in got.values())


def test_budget_validation():
    server = port_server(n_slots=1, max_seq_len=80)
    with pytest.raises(ValueError, match="exceeds max_seq_len"):
        server.submit(make_request(6, 0, 3, max_frames=50))
    assert not server.active.any()


@pytest.mark.parametrize("weight_dtype", ["int8", "int8-decoder", "int4", "auto"])
def test_quantized_weights_match_jax(weight_dtype):
    """The server quantizes as told; the JAX server on the same float
    weights and mode gives the same frames, and a server handed weights
    quantized beforehand gives them too.  ``auto`` is int8 at every slot
    count."""
    kw = dict(n_slots=2, max_seq_len=128, chunk_size=2, weight_dtype=weight_dtype)
    server = port_server(**kw)
    probe = server.params["decoder" if weight_dtype == "int8-decoder" else "backbone"]["wqkv"]
    if weight_dtype == "int4":
        assert tq.is_quantized_int4(probe)
    else:
        assert tq.is_quantized(probe)
    assert server.weight_dtype == {"auto": "int8"}.get(weight_dtype, weight_dtype)
    if weight_dtype == "int8-decoder":
        assert not tq.is_quantized(server.params["backbone"]["wqkv"])
    results, _ = server.run([make_request(*s) for s in TWO])
    got = {r.request_id: r.frames for r in results}
    assert_same(got, jax_serve(TWO, **kw))
    pre = {"int4": lambda p: tq.quantize_csm_params_int4(p),
           "int8-decoder": lambda p: tq.quantize_csm_params(p, components=("decoder",))
           }.get(weight_dtype, tq.quantize_csm_params)(_weights()[1])
    again = BatchedServer(pre, ARGS, compute_dtype=torch.float32, device="cpu", temperature=1.0,
                          topk=1, **kw).run([make_request(*s) for s in TWO])[0]
    assert_same({r.request_id: r.frames for r in again}, got)
    assert port_server(n_slots=128, weight_dtype="auto").weight_dtype == "int8"
    with pytest.raises(ValueError):
        port_server(n_slots=1, weight_dtype="fp8")


def test_int8_kv_matches_jax_and_single_stream():
    kw = dict(n_slots=2, max_seq_len=128, kv_dtype="int8")
    server = port_server(**kw)
    assert isinstance(server.state.cache.k, tkv.QuantKV)
    results, _ = server.run([make_request(*s) for s in TWO])
    got = {r.request_id: r.frames for r in results}
    assert_same(got, jax_serve(TWO, **kw))
    for T, rid, seed, mf in TWO:
        np.testing.assert_array_equal(got[rid], solo_frames(T, seed, mf, kv_dtype=torch.int8))


def test_submit_time_finish_is_returned():
    """Budgets 1 and 0: the first finishes with its frame 0 at the next
    step, the second at submit; both come back from run()."""
    specs = ((6, 0, 1, 1), (6, 1, 2, 3), (6, 2, 3, 0))
    got = serve(specs, n_slots=1, max_seq_len=96)
    assert got[0].shape[0] <= 1 and got[2].shape == (0, K)
    assert_same(got, jax_serve(specs, n_slots=1, max_seq_len=96))


def test_dead_rows_run_past_the_cache_end():
    """A 3-slot server, chunk 8, one slot idle, two streams whose bucket +
    max_frames is max_seq_len (64 + 58 = 122), the second admitted one
    chunk after the first.  The first stream's last chunk has one live step;
    for the other seven its row is dead in the full batch beside the live
    second stream and writes columns 122-127, past the cache's end.  Those
    writes are dropped in both packages (the JAX loop runs those steps too:
    a row is still live), nothing asserts, and the frames equal the JAX
    server's."""
    kw = dict(n_slots=3, max_seq_len=122, chunk_size=8)
    a, b = (20, 0, 5, 58), (30, 1, 6, 58)
    port = port_server(**kw)
    jax_server = JaxServer(_weights()[0], tiny_test_args(), compute_dtype=jnp.float32,
                           temperature=1.0, topk=1, **kw)
    got = {}
    for server, cls in ((port, StreamRequest), (jax_server, JaxRequest)):
        server.submit(make_request(*a, cls=cls))
        done = server.step()
        server.submit(make_request(*b, cls=cls))
        done += server.run([])[0]
        got[cls] = {r.request_id: r.frames for r in done}
    assert all(f.shape[0] == 58 for f in got[StreamRequest].values())
    assert int(port.offsets[0]) > 122  # the first stream's row did run past the end
    assert_same(got[StreamRequest], got[JaxRequest])


@pytest.mark.parametrize("int8", [False, True])
def test_row_offsets_and_column_offsets_at_b1(int8):
    """At B=1 a per-row offset and the all-rows column tensor of a CUDA
    graph's frame step are both (1,) tensors; their types keep them apart.
    One S=1 frame step from the same state through each form: the same
    frame and cache, and each form's next offset keeps its type (the
    column form advances as a tensor, the per-row form as RowOffsets).  A
    per-row column past the end drops the write and leaves the cache and
    ``kv_pos`` as they were."""
    targs = ARGS
    params = tcsm.fuse_csm_params(_weights()[1])
    kv = torch.int8 if int8 else None
    tokens = torch.zeros((1, 1, K + 1), dtype=torch.int32)
    tokens[0, 0, :K] = torch.arange(1, K + 1)
    mask = torch.zeros((1, 1, K + 1), dtype=torch.bool)
    mask[:, :, :K] = True
    pos = torch.tensor([[5]], dtype=torch.int32)
    u = torch.full((K, 1, 1), 0.5)

    def frame(offset, S_max=16):
        st = tcsm.init_frame_state(targs, 1, torch.float32, S_max, kv_dtype=kv)
        st.kv_pos[:, :5] = torch.arange(5, dtype=torch.int32)
        f, new = tcsm.generate_frame(params, targs, None, tokens, mask, pos,
                                     st._replace(offset=offset), 1.0, 1, torch.float32, uniforms=u)
        return f, new, st

    f_col, n_col, s_col = frame(torch.tensor([5]))
    f_row, n_row, s_row = frame(tkv.RowOffsets(torch.tensor([5])))
    assert torch.equal(f_col, f_row)
    assert torch.equal(s_col.kv_pos, s_row.kv_pos) and int(s_row.kv_pos[0, 5]) == 5
    for a, b in zip([x for h in s_col.cache for x in _halves(h)],
                    [x for h in s_row.cache for x in _halves(h)]):
        assert torch.equal(a, b)
    assert type(n_col.offset) is torch.Tensor and n_col.offset.tolist() == [6]
    assert isinstance(n_row.offset, tkv.RowOffsets) and n_row.offset.cols.tolist() == [6]

    # a per-row column past the end: nothing written (16 columns, column 16)
    _, n_drop, s_drop = frame(tkv.RowOffsets(torch.tensor([16])))
    assert n_drop.offset.cols.tolist() == [17]
    assert torch.equal(s_drop.kv_pos[0, 5:], torch.full((11,), tcsm.PAD_POS, dtype=torch.int32))
    for x in [x for h in s_drop.cache for x in _halves(h)]:
        assert not x.any()


# ---------------------------------------------------------------- streaming, cancel


@pytest.mark.parametrize("pipelined", [False, True])
def test_streaming_callbacks(pipelined):
    """Streamed chunks concatenate to the final frames; done=True fires
    exactly once per request (3 requests over 2 slots), pipelined or not."""
    streamed, done_count = {}, {}

    def on_frames(rid, new, done):
        assert new.ndim == 2 and new.shape[1] == K
        streamed.setdefault(rid, []).append(new)
        done_count[rid] = done_count.get(rid, 0) + int(done)

    reqs = [make_request(5 + i, i, 20 + i, max_frames=5) for i in range(3)]
    for r in reqs:
        r.on_frames = on_frames
    results, _ = port_server(n_slots=2, max_seq_len=256, chunk_size=2,
                             pipelined=pipelined).run(reqs)
    assert done_count == {0: 1, 1: 1, 2: 1}
    for r in results:
        np.testing.assert_array_equal(np.concatenate(streamed[r.request_id]), r.frames)


def test_streaming_callback_immediate_budget():
    calls = []
    r = make_request(6, 7, 3, max_frames=1)
    r.on_frames = lambda rid, new, done: calls.append((rid, new.shape[0], done))
    results, _ = port_server(n_slots=1, max_seq_len=128).run([r])
    assert [c for c in calls if c[2]] == [(7, 1, True)]
    assert results[0].frames.shape[0] == 1


@pytest.mark.parametrize("pipelined", [False, True])
def test_cancel_frees_slot_and_leaves_others_exact(pipelined):
    """cancel(): the slot dies on the device and admits a new request at
    once; the survivor's frames are its frames without the cancel (the JAX
    server's); done=True fires once for the cancelled stream.  Pipelined:
    cancel reads the chunk in flight first."""
    server = port_server(n_slots=2, max_seq_len=128, chunk_size=2, pipelined=pipelined)
    events = []
    r0 = make_request(6, 0, 1, max_frames=20)
    r0.on_frames = lambda rid, new, done: events.append((rid, new.shape[0], done))
    server.submit(r0)
    server.submit(make_request(6, 1, 2, max_frames=8))
    server.step()
    server.step()
    assert server.cancel(99) is None
    res = server.cancel(0)
    assert res is not None and res.cancelled and res.request_id == 0
    assert res.frames.shape[0] == res.n_steps
    assert server._inflight is None
    assert [e[2] for e in events].count(True) == 1 and events[-1][2]
    assert server.cancel(0) is None
    assert server.submit(make_request(6, 2, 3, max_frames=4)) == 0  # the freed slot
    results, _ = server.run([])
    by_id = {r.request_id: r.frames for r in results}
    assert set(by_id) == {1, 2}
    want = jax_serve(((6, 1, 2, 8), (6, 2, 3, 4)), n_slots=2, max_seq_len=128, chunk_size=2)
    assert_same(by_id, want)


# ---------------------------------------------------------------- compaction, warmup


def test_decode_capacity_selector():
    server = port_server(n_slots=8, max_seq_len=128)
    assert [server._decode_capacity(n) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]


def test_compacted_serving_matches_dedicated_server():
    """A mostly idle 8-slot server runs its live rows at the capacity a
    dedicated server has, with the same draws from one seed: sampled
    codes (topk=8) are equal, not just argmax ones."""
    for specs, n in ((((6, 0, 5, 6),), 1), (((6, 0, 6, 5), (9, 1, 7, 5)), 2)):
        kw = dict(max_seq_len=128, topk=8)
        a, b = serve(specs, n_slots=8, **kw), serve(specs, n_slots=n, **kw)
        assert_same(a, b)
    assert_same(serve(specs, n_slots=8, max_seq_len=128), jax_serve(specs, n_slots=8, max_seq_len=128))


@pytest.mark.parametrize("ramp_chunk", [None, 1])
def test_warmup_runs_every_capacity_then_serves(ramp_chunk):
    """warmup() runs the prefill of every bucket that fits and every
    capacity (1, 2, 4 and the full 8), and leaves the server clean; a
    request afterwards gives its single-stream frames."""
    server = port_server(n_slots=8, max_seq_len=128, chunk_size=2, ramp_chunk=ramp_chunk)
    assert server.warmup() > 0 and not server.active.any()
    assert set(server._prefills) == {64}  # 128 + 3 frames do not fit
    assert set(server._decodes) == {1, 2, 4, 8}
    results, _ = server.run([make_request(6, 0, 1)])
    np.testing.assert_array_equal(results[0].frames, solo_frames(6, 1, 4))


# ---------------------------------------------------------------- ramp, pipelining


def test_ramp_chunk_parity_and_first_read():
    """ramp_chunk: the frames of an unramped server; the read right after
    an admission holds frame 0 and at most ramp_chunk decoded frames, the
    next one a full chunk."""
    kw = dict(n_slots=2, max_seq_len=128, chunk_size=6)
    specs = tuple((6, i, i + 1, 9) for i in range(2))
    assert_same(serve(specs, ramp_chunk=2, **kw), jax_serve(specs, **kw))
    ramp = port_server(ramp_chunk=2, **kw)
    ramp.submit(make_request(6, 9, 3, max_frames=12))
    assert len(ramp.slot_frames[0]) == 0  # frame 0 stays on the device
    ramp.step()
    n1 = len(ramp.slot_frames[0])
    assert 1 <= n1 <= 3
    ramp.step()
    assert len(ramp.slot_frames[0]) == n1 + 6
    with pytest.raises(ValueError):
        port_server(ramp_chunk=6, **kw)


def test_pipelined_matches_unpipelined_and_jax():
    """Six requests of mixed lengths and budgets over 2 slots, chunk 3:
    the pipelined server's frames equal the synchronous server's and the
    JAX server's, and once drained nothing is in flight."""
    kw = dict(n_slots=2, max_seq_len=128, chunk_size=3)
    specs = tuple((5 + i % 3, i, i + 1, 3 + i % 4) for i in range(6))
    server = port_server(pipelined=True, **kw)
    results, _ = server.run([make_request(*s) for s in specs])
    assert server._inflight is None and not server.active.any()
    got = {r.request_id: r.frames for r in results}
    assert_same(got, serve(specs, **kw))
    assert_same(got, jax_serve(specs, **kw))


def test_pipelined_bitexact_when_no_churn():
    """Equal budgets, temperature 0.8, topk 5: the pipelined server runs
    the same steps and draws the same uniforms in the same order, so its
    sampled codes equal the synchronous server's bit for bit."""
    kw = dict(n_slots=2, max_seq_len=128, temperature=0.8, topk=5, chunk_size=4)
    specs = tuple((6, i, i + 1, 8) for i in range(2))
    got = {}
    for pipelined in (False, True):
        server = port_server(pipelined=pipelined, **kw)
        results, _ = server.run([make_request(*s) for s in specs])
        got[pipelined] = {r.request_id: r.frames for r in results}
        # frame 0 from the prefill, then 7 steps (chunks of 4 and 3): no
        # chunk runs a step that no row's budget allows, pipelined or not
        assert server.step_calls == {2: 7}
    assert_same(got[True], got[False])


def test_pipelined_ramp_keeps_first_read():
    server = port_server(n_slots=2, max_seq_len=128, chunk_size=6, ramp_chunk=2, pipelined=True)
    server.submit(make_request(6, 0, 3, max_frames=12))
    server.step()
    assert 1 <= len(server.slot_frames[0]) <= 3  # read at once, not a step later
    server.run([])
    assert server.warmup() > 0 and server._inflight is None


# ---------------------------------------------------------------- surfaces that wait


@pytest.mark.parametrize("what", ["mesh", "adapters", "add_adapter", "request_adapter"])
def test_unported_surfaces_raise(what, tmp_path):
    """Meshes wait (A.11).  The adapter surfaces are ported (their tests
    against the JAX server are in test_torch_adapter_bank.py): an adapter
    directory that is not there is refused at construction and at
    ``add_adapter``, and a request naming an adapter that is not loaded is
    refused at submit, leaving the server idle."""
    missing = str(tmp_path / "nowhere")
    if what == "mesh":
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            port_server(n_slots=1, max_seq_len=96, mesh=object())
        return
    if what == "adapters":
        with pytest.raises(FileNotFoundError):
            port_server(n_slots=1, max_seq_len=96, adapters={"a": missing})
        return
    server = port_server(n_slots=1, max_seq_len=96)
    if what == "add_adapter":
        with pytest.raises(FileNotFoundError):
            server.add_adapter("a", missing)
        assert server.bank is None and not server._adapter_id
    else:
        r = make_request(6, 0, 1)
        r.adapter = "x"
        with pytest.raises(ValueError, match="unknown adapter 'x'"):
            server.submit(r)
    assert not server.active.any()


def test_serving_imports_without_jax():
    code = ("import sys, csm_torch.serving, csm_torch.cli.serve; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'csm_tpu'))]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)
