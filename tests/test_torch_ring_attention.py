"""The port's ring attention and sequence-parallel training on the CPU over
gloo, held against the JAX package.

Ranks are child processes (``csm_torch.parallel.launch``; see
tests/test_torch_parallel.py).  One 2-rank group runs ``sharded_ring_attention``
in both layouts (with PAD rows), the sequence-parallel train step in both
layouts at T=128 and LoRA over an int8 and an int4 base on the (data, seq)
mesh; one 4-rank group runs the 4-chunk ring (128-query chunks at T=512,
the size at which the card sends every chunk through the flash kernel) and
the zigzag train step.  Tolerances are the JAX package's
(tests/test_ring_attention.py): outputs atol 3e-5, gradients atol 5e-4 /
rtol 1e-3, the loss rtol 2e-4 and parameters after two steps atol 2e-5.

The chunk attention itself (the flash plain version on the CPU, the kernel
on the card) is held against the JAX ring's chunk attention on a chunk
that sees no key (contiguous layout: rank 0's queries against the last
rank's keys) and on a zigzag chunk whose positions jump inside a 64-key
tile; in the first, the gradients through the merge are exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.ops.attention import causal_mask_from_positions, gqa_attention
from csm_tpu.parallel import ring_attention as jring
from csm_torch.parallel import ring_attention as tring
from csm_torch.parallel.launch import start
from test_torch_parallel import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, Setup,
                                 assert_matches, jax_reference)

OUT_ATOL = 3e-5
PAD = 1 << 28


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def ring_case(name, seq, layout, B, S, seed, pad_len=None):
    """Inputs of one ring check, and the JAX single-device attention and
    gradients it is held to."""
    Hq, Hkv, D = 4, 2, 32
    q, k, v = rand((B, S, Hq, D), seed), rand((B, S, Hkv, D), seed + 1), rand((B, S, Hkv, D),
                                                                                   seed + 2)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    rows = np.ones((B, S), bool)
    if pad_len is not None:  # dead slots past each row's length, which no cotangent reaches
        rows = np.arange(S)[None] < np.asarray(pad_len)[:, None]
        pos = np.where(rows, pos, PAD).astype(np.int32)
    g = rand((B, S, Hq, D), seed + 3) * rows[:, :, None, None]

    def f(q, k, v):
        out = gqa_attention(q, k, v, causal_mask_from_positions(jnp.asarray(pos), jnp.asarray(pos)))
        return (out * g).sum(), out

    (_, out), grads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    case = dict(name=name, seq=seq, layout=layout, q=torch.from_numpy(q), k=torch.from_numpy(k),
                v=torch.from_numpy(v), q_pos=torch.from_numpy(pos), kv_pos=torch.from_numpy(pos),
                g=torch.from_numpy(g))
    ref = dict(out=np.asarray(out), grads=[np.asarray(x) for x in grads], rows=rows)
    return case, ref


SP_TRAIN = {
    "sp2_contiguous": dict(parallel=dict(seq_parallel=2, ring_layout="contiguous")),
    "sp2_zigzag": dict(parallel=dict(seq_parallel=2, ring_layout="zigzag")),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    setup = Setup(tmp, B=2, T=128, ratio=16)
    rings, refs = [], {}
    for name, seq, layout, B, S, pad in (("c2", 2, "contiguous", 2, 256, [200, 256]),
                                         ("z2", 2, "zigzag", 1, 256, None),
                                         ("z4", 4, "zigzag", 1, 512, None),
                                         ("c4", 4, "contiguous", 1, 512, None)):
        case, ref = ring_case(name, seq, layout, B, S, seed=len(rings) * 10, pad_len=pad)
        rings.append(case)
        refs[name] = ref
    lcfg = dict(r=4, alpha=8.0, target_modules=("q_proj", "v_proj"))
    lora_cases = [dict(name=f"qlora_{q}", parallel=dict(seq_parallel=2), ratio=setup.ratio,
                       lora=lcfg, quant=q) for q in ("int8", "int4")]
    two = start("csm_torch.parallel.witness:run", 2, tmp / "two", setup.spec(
        ring=[r for r in rings if r["seq"] == 2],
        cases=[dict(name=n, ratio=setup.ratio, **c) for n, c in SP_TRAIN.items()] + lora_cases))
    four = start("csm_torch.parallel.witness:run", 4, tmp / "four", setup.spec(
        ring=[r for r in rings if r["seq"] == 4],
        cases=[dict(name="sp4_zigzag", ratio=setup.ratio,
                    parallel=dict(seq_parallel=4, ring_layout="auto"))]))
    mp = pytest.MonkeyPatch()
    try:  # while the ranks run: the JAX step, and the port on one rank over the same bases
        setup.patch_jax_selection(mp)
        ref = jax_reference(setup)
        from csm_torch.parallel.witness import run_case

        single = {c["name"]: run_case(dict(c, parallel={}), setup.spec(), torch.device("cpu"))
                  for c in lora_cases}
    except BaseException:
        two.kill(), four.kill()
        raise
    finally:
        mp.undo()
    return dict(two=two.wait(), four=four.wait(), refs=refs, ref=ref, single=single, setup=setup)


@pytest.mark.parametrize("S,n", [(16, 2), (512, 4), (320, 2)])
def test_zigzag_perm_matches_jax(S, n):
    np.testing.assert_array_equal(tring.zigzag_perm(S, n), jring.zigzag_perm(S, n))
    with pytest.raises(ValueError, match="must divide by"):
        tring.zigzag_perm(S + 2, n)


def test_auto_layout_is_the_jax_choice():
    """``ring_layout="auto"``: zigzag when T divides by 2·seq, else
    contiguous (csm_tpu/training/losses.py)."""
    assert tring.resolve_layout("auto", 256, 4) == "zigzag"
    assert tring.resolve_layout("auto", 36, 4) == "contiguous"
    assert tring.resolve_layout("contiguous", 256, 4) == "contiguous"
    with pytest.raises(ValueError, match="unknown layout"):
        tring.resolve_layout("striped", 256, 4)


@pytest.mark.parametrize("name", ["c2", "z2", "z4", "c4"])
def test_ring_attention_matches_jax(runs, name):
    """Output (atol 3e-5, live rows) and dq, dk, dv (atol 5e-4, rtol 1e-3)
    against the JAX single-device attention under the positions' mask."""
    group = runs["two"] if name.endswith("2") else runs["four"]
    got, ref = group[0]["ring:" + name], runs["refs"][name]
    rows = ref["rows"]
    np.testing.assert_allclose(got["out"].numpy()[rows], ref["out"][rows], atol=OUT_ATOL)
    for what, a, b in zip(("dq", "dk", "dv"), (got["dq"], got["dk"], got["dv"]), ref["grads"]):
        np.testing.assert_allclose(a.numpy(), b, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=what)


def _chunk(q, k, v, qp, kp):
    args = [torch.from_numpy(x) for x in (q, k, v)]
    for a in args:
        a.requires_grad_()
    return args, tring._chunk_attention(*args, torch.from_numpy(qp), torch.from_numpy(kp))


@pytest.mark.parametrize("kind", ["empty", "zigzag"])
def test_chunk_attention_matches_jax(kind):
    """One ring step's chunk attention against the JAX ring's
    (``_xla_chunk_attention``, its route off the TPU): output and lse.
    "empty": rank 0's queries against the last rank's keys of a contiguous
    split (no key visible): zeros and lse −inf.  "zigzag": rank 0's zigzag
    chunk (positions 0-79 and 240-319 of T=320) against itself, so a
    64-key tile spans the jump."""
    B, Hq, Hkv, D = 2, 4, 2, 16
    if kind == "empty":
        qp = np.broadcast_to(np.arange(0, 64, dtype=np.int32), (B, 64)).copy()
        kp = np.broadcast_to(np.arange(192, 256, dtype=np.int32), (B, 64)).copy()
    else:
        cols = tring.zigzag_perm(320, 2)[:160].astype(np.int32)
        assert (np.diff(cols[64:128]) < 0).any() or (np.diff(cols[64:128]) > 1).any()
        qp = kp = np.broadcast_to(cols, (B, 160)).copy()
    S, T = qp.shape[1], kp.shape[1]
    q, k, v = rand((B, S, Hq, D), 1), rand((B, T, Hkv, D), 2), rand((B, T, Hkv, D), 3)
    _, (out, lse) = _chunk(q, k, v, qp, kp)
    jout, jlse = jring._xla_chunk_attention(q, k, v, qp, kp)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=OUT_ATOL)
    assert np.array_equal(np.isinf(lse.detach().numpy()), np.isinf(np.asarray(jlse)))
    fin = np.isfinite(np.asarray(jlse))
    np.testing.assert_allclose(lse.detach().numpy()[fin], np.asarray(jlse)[fin], atol=OUT_ATOL)
    if kind == "empty":
        assert (out == 0).all() and torch.isneginf(lse).all()


def test_empty_chunk_gradients_are_exactly_zero():
    """Through the log-space merge: a query row's first chunk sees no key,
    the second does.  The empty chunk's dq, dk, dv are exactly zero with no
    NaN, and the row's output and gradients equal the visible chunk's
    alone."""
    B, Hq, Hkv, D, S = 1, 4, 2, 16, 64
    qp = np.broadcast_to(np.arange(64, 128, dtype=np.int32), (B, S)).copy()
    k_far = np.broadcast_to(np.arange(128, 192, dtype=np.int32), (B, S)).copy()  # not visible
    k_near = np.broadcast_to(np.arange(0, 64, dtype=np.int32), (B, S)).copy()
    q = rand((B, S, Hq, D), 5)
    kf, vf, kn, vn = (rand((B, S, Hkv, D), s) for s in (6, 7, 8, 9))
    g = torch.from_numpy(rand((B, S, Hq, D), 10))
    qt = torch.from_numpy(q).requires_grad_()
    kft, vft, knt, vnt = (torch.from_numpy(x).requires_grad_() for x in (kf, vf, kn, vn))
    acc = torch.zeros((B, S, Hq, D))
    lse = torch.full((B, S, Hq), float("-inf"))
    for kk, vv, kp in ((kft, vft, k_far), (knt, vnt, k_near)):  # the ring's merge, by hand
        o_i, lse_i = tring._chunk_attention(qt, kk, vv, torch.from_numpy(qp), torch.from_numpy(kp))
        lse_new = tring._logaddexp(lse, lse_i)
        fin = torch.isfinite(lse_new)
        base = torch.where(fin, lse_new, torch.zeros_like(lse_new))
        a_old = torch.where(fin, torch.exp(lse - base), torch.zeros_like(base))
        a_new = torch.where(fin, torch.exp(lse_i - base), torch.zeros_like(base))
        acc = acc * a_old[..., None] + o_i * a_new[..., None]
        lse = lse_new
    (acc * g).sum().backward()
    for t in (kft, vft):
        assert torch.equal(t.grad, torch.zeros_like(t.grad))
    for t in (qt, knt, vnt):
        assert torch.isfinite(t.grad).all()
    q2, kn2, vn2 = (torch.from_numpy(x).requires_grad_() for x in (q, kn, vn))
    o2, _ = tring._chunk_attention(q2, kn2, vn2, torch.from_numpy(qp), torch.from_numpy(k_near))
    (o2 * g).sum().backward()
    torch.testing.assert_close(acc, o2, atol=1e-6, rtol=1e-6)
    for a, b in ((qt, q2), (knt, kn2), (vnt, vn2)):
        torch.testing.assert_close(a.grad, b.grad, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["sp2_contiguous", "sp2_zigzag", "sp4_zigzag"])
def test_seq_parallel_step_matches_jax(runs, name):
    """The sequence-parallel train step at T=128 (B=2): loss, gradients and
    parameters after two steps against the JAX single-device step; every
    rank reports the same global losses."""
    group = runs["four"] if name.startswith("sp4") else runs["two"]
    assert len({tuple(r[name]["losses"]) for r in group}) == 1
    assert_matches(group[0][name], runs["ref"], name)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_seq_parallel_qlora_matches_single_rank(runs, quant):
    """LoRA on q/v over an int8 or int4 base on a (data, seq) mesh: the
    adapters' gradients and values after two steps against the
    single-process port over the same quantized base (itself held against
    the JAX package in tests/test_torch_lora_quant.py)."""
    name = f"qlora_{quant}"
    got, want = runs["two"][0][name], runs["single"][name]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    for path in want["grads"]:
        np.testing.assert_allclose(got["grads"][path].numpy(), want["grads"][path].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=path)
    for path in want["params"]:
        np.testing.assert_allclose(got["params"][path].numpy(), want["params"][path].numpy(),
                                   atol=PARAM_ATOL, err_msg=path)
    assert set(got["params"]) == {f"{c}/{p}/{ab}" for c in ("backbone", "decoder")
                                  for p in ("wq", "wv") for ab in ("a", "b")}
