"""The port's multi-LoRA serving (``BatchedServer(adapters=)``, hot
``add_adapter`` / ``remove_adapter``, a request's ``adapter``, a prefix
under an adapter) against the JAX package's ``BatchedServer`` at
``tiny_test_args()`` in float32 on the CPU.

Both servers get the same weights (``params_from_jax``) and the same
adapters (``lora_from_jax``, B made non-zero); at topk=1 every stream's
frames must be exactly equal to the JAX server's and to a solo run on the
merged params (``merge_lora``).  The refusals are the JAX package's:
unknown adapter, adapter in use, adapter referenced by a prefix, a prefix
under another adapter than the request's, and a name loaded twice.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.serving import BatchedServer as JaxServer
from csm_tpu.serving import StreamRequest as JaxRequest
from csm_tpu.training import lora as jlora
from csm_torch.models import config as tconfig
from csm_torch.serving import BatchedServer, StreamRequest
from csm_torch.training import lora as tlora
from csm_torch.utils.params import lora_from_jax, params_from_jax

ARGS = tconfig.tiny_test_args()
K = ARGS.audio_num_codebooks
KW = dict(max_seq_len=96, temperature=1.0, topk=1, chunk_size=2)
CFGS = {
    "alice": dict(r=4),
    "bob": dict(r=2, alpha=8.0, target_modules=("q_proj", "k_proj", "v_proj")),
    "carol": dict(r=8, target_modules=("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                       "up_proj", "down_proj")),
    "dec": dict(r=4, apply_to_backbone=False),
}


@functools.lru_cache(maxsize=1)
def _setup():
    """(JAX params, port params, {name: (JAX tree, port tree, port cfg)})."""
    jargs = tiny_test_args()
    jp = jcsm.init_csm_params(jax.random.key(0), jargs, jnp.float32)
    ads = {}
    for i, (name, kw) in enumerate(CFGS.items()):
        lo = jlora.init_lora_params(jax.random.key(1 + i), jargs, jlora.LoRAConfig(**kw))
        lo = jax.tree.map(lambda x, s=0.02 + 0.01 * i: np.asarray(x + s), lo)
        ads[name] = (lo, lora_from_jax(lo), tlora.LoRAConfig(**kw))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp)), ads


def port_adapters(names):
    ads = _setup()[2]
    return {n: (ads[n][1], ads[n][2], None) for n in names}


def port_server(names=(), params=None, **kw):
    return BatchedServer(_setup()[1] if params is None else params, ARGS,
                         adapters=port_adapters(names) or None, compute_dtype=torch.float32,
                         device="cpu", **dict(KW, **kw))


def _prompt(T, seed):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((T, K + 1), np.int32)
    mask = np.zeros((T, K + 1), bool)
    tokens[:, -1] = rng.integers(1, ARGS.text_vocab_size, T)
    mask[:, -1] = True
    return tokens, mask


def request(T, rid, seed, adapter=None, max_frames=4, cls=StreamRequest, prefix=None):
    return cls(*_prompt(T, seed), max_frames=max_frames, request_id=rid, adapter=adapter,
               prefix=prefix)


@functools.lru_cache(maxsize=None)
def jax_frames(names, specs, n_slots):
    ads = _setup()[2]
    server = JaxServer(_setup()[0], tiny_test_args(), n_slots=n_slots,
                       adapters={n: (ads[n][0], jlora.LoRAConfig(**CFGS[n]), None) for n in names},
                       compute_dtype=jnp.float32, **KW)
    results, _ = server.run([request(*s, cls=JaxRequest) for s in specs])
    return {r.request_id: r.frames for r in results}


def merged_solo(spec, name):
    """A one-slot server without a bank on the merged params."""
    T, rid, seed, _, mf = spec
    params = _setup()[1]
    if name is not None:
        _, lo, cfg = _setup()[2][name]
        params = tlora.merge_lora(params, lo, cfg)
    res, _ = port_server(params=params, n_slots=1).run([request(T, rid, seed, max_frames=mf)])
    return res[0].frames


MIXED = ((6, 0, 1, None, 4), (7, 1, 2, "alice", 4), (5, 2, 3, "bob", 4), (8, 3, 4, "carol", 4),
         (6, 4, 5, "dec", 4))


def test_bank_server_matches_jax_and_merged_solo():
    """Five streams over ids 0-4 (base, r=4 q/v, r=2 q/k/v, r=8 on all seven,
    decoder-only) in one 8-slot batch: each equals the JAX bank server's
    stream and a solo run on its merged params, and the adapters act."""
    names = tuple(CFGS)
    got, _ = port_server(names, n_slots=8).run([request(*s) for s in MIXED])
    got = {r.request_id: r.frames for r in got}
    want = jax_frames(names, MIXED, 8)
    assert set(got) == set(want)
    for spec in MIXED:
        rid = spec[1]
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"request {rid}")
        np.testing.assert_array_equal(got[rid], merged_solo(spec, spec[3]),
                                      err_msg=f"request {rid} merged")
    base = {s[1]: merged_solo(s[:3] + (None, 4), None) for s in MIXED[1:]}
    assert any(not np.array_equal(got[rid], f) for rid, f in base.items())


def test_compacted_capacity_carries_the_ids():
    """Two live streams of an 8-slot server run in the capacity-2 buffers:
    the ids follow the rows there and back (the same frames as 2 slots)."""
    specs = ((6, 0, 1, "bob", 6), (7, 1, 2, "alice", 6))
    a, _ = port_server(("alice", "bob"), n_slots=8).run([request(*s) for s in specs])
    b, _ = port_server(("alice", "bob"), n_slots=2).run([request(*s) for s in specs])
    assert {r.request_id: r.frames.tolist() for r in a} == {r.request_id: r.frames.tolist()
                                                            for r in b}
    assert {r.request_id: r.frames.tolist() for r in a} == {
        k: v.tolist() for k, v in jax_frames(("alice", "bob"), specs, 8).items()}


def test_hot_add_and_remove_with_refusals(tmp_path):
    """add_adapter on a running server serves like one loaded at
    construction, from a ``save_lora`` directory too; the JAX package's
    refusals; a removed id is reused and the survivors are unchanged."""
    want = {n: merged_solo((6, 0, 1, n, 4), n) for n in ("alice", "bob", None)}
    srv = port_server(("alice",), n_slots=2)
    with pytest.raises(ValueError, match="unknown adapter"):
        srv.submit(request(6, 0, 1, adapter="bob"))
    srv.submit(request(6, 0, 1, max_frames=8))
    srv.step()  # a base stream in flight
    _, lo, cfg = _setup()[2]["bob"]
    path = tlora.save_lora(str(tmp_path / "bob"), lo, cfg, ARGS)
    assert srv.add_adapter("bob", path) == 2
    with pytest.raises(ValueError, match="already loaded"):
        srv.add_adapter("bob", path)
    srv.submit(request(6, 1, 1, adapter="bob"))
    res, _ = srv.run([])
    by_id = {r.request_id: r.frames for r in res}
    np.testing.assert_array_equal(by_id[1], want["bob"])
    np.testing.assert_array_equal(by_id[0][:4], want[None])

    srv.submit(request(6, 2, 2, adapter="bob", max_frames=8))
    with pytest.raises(ValueError, match="in use"):
        srv.remove_adapter("bob")
    srv.cancel(2)
    srv.remove_adapter("bob")
    with pytest.raises(ValueError, match="unknown adapter"):
        srv.remove_adapter("bob")
    assert srv.add_adapter("carol", (lo, cfg, None)) == 2  # the id is reused
    r, _ = srv.run([request(6, 0, 1, adapter="carol")])
    np.testing.assert_array_equal(r[0].frames, want["bob"])
    r, _ = srv.run([request(6, 0, 1, adapter="alice")])
    np.testing.assert_array_equal(r[0].frames, want["alice"])
    other = tlora.LoRAConfig(r=2)
    wrong = tconfig.ModelArgs(backbone_flavor="tiny", decoder_flavor="tiny", text_vocab_size=64)
    with pytest.raises(ValueError, match="different model shape"):
        srv.add_adapter("x", (lo, other, wrong))


def test_prefix_under_an_adapter():
    """A prefix registered under an adapter: its requests equal the JAX
    server's; a request under another adapter is refused, as is removing
    the adapter while the prefix stands."""
    ctx = _prompt(20, 7)
    jp, _, ads = _setup()
    jsrv = JaxServer(jp, tiny_test_args(), n_slots=2, compute_dtype=jnp.float32,
                     adapters={"alice": (ads["alice"][0], jlora.LoRAConfig(**CFGS["alice"]), None)},
                     **dict(KW, max_seq_len=128))
    jsrv.register_prefix("voice", *ctx, adapter="alice")
    want, _ = jsrv.run([request(5, 0, 8, adapter="alice", prefix="voice", cls=JaxRequest)])
    srv = port_server(("alice",), n_slots=2, max_seq_len=128)
    with pytest.raises(ValueError, match="unknown adapter"):
        srv.register_prefix("voice", *ctx, adapter="nobody")
    pre = srv.register_prefix("voice", *ctx, adapter="alice")
    assert pre.adapter == "alice"
    with pytest.raises(ValueError, match="computed under adapter"):
        srv.submit(request(5, 1, 8, prefix="voice"))
    got, _ = srv.run([request(5, 0, 8, adapter="alice", prefix="voice")])
    np.testing.assert_array_equal(got[0].frames, want[0].frames)
    with pytest.raises(ValueError, match="referenced by prefix"):
        srv.remove_adapter("alice")
    srv.unregister_prefix("voice")
    srv.remove_adapter("alice")
    assert srv.bank is None


def bank_ids(srv):
    return {k: id(t) for k, t in tlora.flatten_lora(
        {c: sub for c, sub in srv.bank.items() if sub}).items()}


def test_same_shape_swap_in_place_and_reshape():
    """Removing and adding the middle adapter keeps the bank's shapes: the
    same tensors, updated in place.  A larger rank replaces them."""
    ads = port_adapters(("alice", "bob"))
    srv = port_server(n_slots=2)
    for name in ("alice", "bob", "alice2"):
        srv.add_adapter(name, ads[name.rstrip("2")])
    before = bank_ids(srv)
    old = srv.bank["backbone"]["wqkv"]["b"].clone()
    srv.remove_adapter("bob")  # id 2 frees, the tail stays: same shapes
    assert bank_ids(srv) == before and not srv.bank["backbone"]["wqkv"]["b"][:, 2].any()
    assert srv.add_adapter("bob", ads["bob"]) == 2
    assert bank_ids(srv) == before
    torch.testing.assert_close(srv.bank["backbone"]["wqkv"]["b"], old, rtol=0, atol=0)
    srv.add_adapter("carol", port_adapters(("carol",))["carol"])  # r=8 over all seven
    assert bank_ids(srv) != before
    assert set(srv.bank["backbone"]) == {"wqkv", "wo", "w13", "w2"}
    r, _ = srv.run([request(6, 0, 1, adapter="carol")])
    np.testing.assert_array_equal(r[0].frames, merged_solo((6, 0, 1, None, 4), "carol"))
