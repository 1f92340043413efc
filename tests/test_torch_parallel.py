"""The port's meshes, data / tensor / FSDP layouts and training over them,
on the CPU over gloo, held against the JAX package.

Every rank is a child process started by ``csm_torch.parallel.launch``
(a file store, no TCP rendezvous port, one thread a rank, each rank's own
environment): the pytest process joins no process group and sets no
variable.  One 2-rank group runs DP, TP, FSDP and TP+FSDP, LoRA over TP,
FSDP and TP+FSDP, the trainer and the LoRA trainer over TP+FSDP with their
checkpoints and resumes, and ``csm-torch-train --fsdp``; one
4-rank group runs DP×TP with FSDP.  Each layout starts from the same
weights (the JAX tree, ``params_from_jax``), batches and frame scores, and
is held against the JAX package's single-device ``make_train_step`` and
``compute_loss`` gradients at the tolerances of the JAX package's own
parallel tests: the loss to rtol 2e-4 (tests/test_trainer_parallel.py),
each gradient to atol 5e-4 / rtol 1e-3 (tests/test_ring_attention.py), the
parameters after two AdamW steps to atol 2e-5 (tests/test_pipeline.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.parallel import sharding as jsharding
from csm_tpu.training import lora as jlora
from csm_tpu.training import losses as jlosses
from csm_tpu.training import optimizer as jopt
from csm_tpu.training import train_step as jstep
from csm_torch.models import config as tconfig
from csm_torch.parallel import distributed as tdist
from csm_torch.parallel import mesh as tmesh
from csm_torch.parallel import sharding as tsharding
from csm_torch.parallel.launch import start
from csm_torch.training.losses import Batch
from csm_torch.utils.params import lora_from_jax, params_from_jax
from test_torch_training import make_batch

LOSS_RTOL = 2e-4
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3
PARAM_ATOL = 2e-5
LR = 1e-3


def with_seq_len(args, n):
    return dataclasses.replace(
        args, backbone_config=dataclasses.replace(args.backbone_config, max_seq_len=n))


def flat_jax(tree) -> dict:
    """{"backbone/wq": numpy, ...} of a JAX tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(k, "key", k)) for k in path)] = np.asarray(leaf)
    return out


class Setup:
    """Weights, batches and frame scores both packages take, written for
    the ranks to load."""

    def __init__(self, tmp, B, T, ratio=4, seed=0, n_batches=2):
        self.jargs = tiny_test_args()
        self.targs = tconfig.tiny_test_args()
        if T > 128:
            self.jargs, self.targs = with_seq_len(self.jargs, 512), with_seq_len(self.targs, 512)
        self.jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(seed),
                                                                     self.jargs))
        self.params_path = str(tmp / "params.pt")
        torch.save(params_from_jax(self.jparams), self.params_path)
        self.batches = [make_batch(self.targs, B=B, T=T, seed=10 + i) for i in range(n_batches)]
        # one set of frame scores for every step: the JAX step ranks by it too
        self.scores = np.random.default_rng(7).random(B * T).astype(np.float32)
        self.ratio = ratio

    def spec(self, **kw):
        return dict(device="cpu", args=self.targs, params=self.params_path,
                    batches=[Batch(*map(torch.from_numpy, b)) for b in self.batches],
                    scores=[torch.from_numpy(self.scores)] * len(self.batches), **kw)

    def patch_jax_selection(self, monkeypatch):
        scores = jnp.asarray(self.scores)

        def select(key, target_mask, n_sub):
            s = jnp.where(target_mask.reshape(-1), scores, -1.0)
            idx = jax.lax.top_k(s, n_sub)[1]
            return idx, target_mask.reshape(-1)[idx]

        monkeypatch.setattr(jlosses, "_select_amortized_frames", select)


def jax_reference(setup: Setup, steps=2, lora=None):
    """The JAX package's single-device run: the first batch's loss
    gradients, then ``steps`` AdamW steps (losses, parameters).  ``lora``
    — (LoRAConfig, adapter tree): the adapters are trained instead."""
    jargs, ratio = setup.jargs, setup.ratio
    batches = [jlosses.Batch(*map(jnp.asarray, b)) for b in setup.batches]
    base = jax.tree.map(jnp.asarray, setup.jparams)
    if lora is None:
        def loss(p, b):
            return jlosses.compute_loss(p, jargs, jax.random.key(0), b, amortization_ratio=ratio,
                                        compute_dtype=jnp.float32)[0]
        grads = jax.grad(loss)(base, batches[0])
        tx = jopt.make_optimizer(base, learning_rate=LR)
        step = jstep.make_train_step(jargs, tx, compute_dtype=jnp.float32,
                                     amortization_ratio=ratio)
        state = jopt.init_train_state(jax.tree.map(jnp.array, base), tx)
        run = lambda st, i: step(st, jax.random.key(i), batches[i % len(batches)])  # noqa: E731
    else:
        lcfg, ad = lora
        ad = jax.tree.map(jnp.asarray, ad)

        def loss(a, b):
            return jlosses.compute_loss(base, jargs, jax.random.key(0), b,
                                        amortization_ratio=ratio, compute_dtype=jnp.float32,
                                        lora=a, lora_scale=lcfg.scaling)[0]
        grads = jax.grad(loss)(ad, batches[0])
        tx = jopt.make_lora_optimizer(learning_rate=LR)
        step = jstep.make_lora_train_step(jargs, tx, lcfg.scaling, compute_dtype=jnp.float32,
                                          amortization_ratio=ratio)
        state = jopt.init_train_state(jax.tree.map(jnp.array, ad), tx)
        run = lambda st, i: step(st, base, jax.random.key(i),  # noqa: E731
                                 batches[i % len(batches)])
    losses = []
    for i in range(steps):
        state, m = run(state, i)
        losses.append(float(m["loss"]))
    return {"grads": flat_jax(grads), "losses": losses, "params": flat_jax(state.params)}


def assert_matches(out: dict, ref: dict, what: str):
    np.testing.assert_allclose(out["losses"], ref["losses"], rtol=LOSS_RTOL, err_msg=what)
    assert set(out["grads"]) == set(ref["grads"]), what
    for path, g in out["grads"].items():
        np.testing.assert_allclose(g.numpy(), ref["grads"][path], atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"{what}: grad {path}")
    for path, p in out["params"].items():
        np.testing.assert_allclose(p.numpy(), ref["params"][path], atol=PARAM_ATOL,
                                   err_msg=f"{what}: param {path}")


# LoRA on every projection: TP splits the adapters of wq/wk/wv/w1/w3 by
# their output columns and those of wo/w2 by their input rows
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
LORA = dict(r=4, alpha=8.0, target_modules=ALL_TARGETS)
LORA_RANKS = [("lora_tp", dict(parallel=dict(model_parallel=2)), 0.0),
              ("lora_fsdp", dict(parallel=dict(fsdp=True)), 0.0),
              ("lora_tp_fsdp", dict(parallel=dict(model_parallel=2, fsdp=True)), 0.0),
              ("lora_dp_dropout", dict(parallel={}), 0.5),
              ("lora_tp_dropout", dict(parallel=dict(model_parallel=2)), 0.5)]

TWO_RANKS = {
    "dp": dict(parallel={}),
    "tp": dict(parallel=dict(model_parallel=2)),
    "fsdp": dict(parallel=dict(fsdp=True)),
    "tp_fsdp": dict(parallel=dict(model_parallel=2, fsdp=True)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, request):
    """The two rank groups of this file, and the JAX reference."""
    tmp = tmp_path_factory.mktemp("parallel")
    setup = Setup(tmp, B=4, T=16)
    data = tmp / "wavs"
    data.mkdir()
    from test_torch_trainer import sine
    from csm_torch.data import audio as taudio

    for i in range(2):
        taudio.save_wav(str(data / f"utt{i}.wav"), sine(1.2 + 0.3 * i, hz=200.0 + 50 * i), 24_000)
        (data / f"utt{i}.txt").write_text(f"synthetic utterance number {i}")
    cli = ["--audio-dir", str(data), "--tiny-test", "--device", "cpu", "--val-split", "0",
           "--epochs", "1", "--batch-size", "2", "--learning-rate", "1e-3", "--fsdp"]
    jl = jlora.LoRAConfig(**LORA)
    jad = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.key(5), setup.jargs, jl))
    # B starts at zero; move it so the first step's adapter gradients are not all zero
    jad = jax.tree.map(lambda x: x + np.float32(0.01), jad)
    lora_path = str(tmp / "lora.pt")
    torch.save(lora_from_jax(jad), lora_path)
    lora_cases = [dict(name=n, ratio=setup.ratio, lora=dict(LORA, dropout=d), lora_params=lora_path,
                       grads=d == 0.0, **c) for n, c, d in LORA_RANKS]
    two = start("csm_torch.parallel.witness:run", 2, tmp / "two", setup.spec(
        cases=[dict(name=n, ratio=setup.ratio, **c) for n, c in TWO_RANKS.items()] + lora_cases,
        trainers=[dict(name="tp_fsdp", parallel=dict(model_parallel=2, fsdp=True),
                       epochs=2, batch_size=4, out_dir=str(tmp / "trainer")),
                  dict(name="lora_tp_fsdp", parallel=dict(model_parallel=2, fsdp=True),
                       epochs=2, batch_size=4, lora=dict(lora_r=4, target_modules=ALL_TARGETS),
                       out_dir=str(tmp / "lora_trainer"))],
        calls=[("cli", "csm_torch.cli.train:main",
                cli + ["--output-dir", str(tmp / "cli_fsdp")])]))
    four = start("csm_torch.parallel.witness:run", 4, tmp / "four", setup.spec(
        cases=[dict(name="dp_tp_fsdp", ratio=setup.ratio,
                    parallel=dict(model_parallel=2, fsdp=True))]))
    mp = pytest.MonkeyPatch()
    try:  # while the ranks run
        setup.patch_jax_selection(mp)
        ref = jax_reference(setup)
        ref_lora = jax_reference(setup, lora=(jl, jad))
    except BaseException:
        two.kill(), four.kill()
        raise
    finally:
        mp.undo()
    return dict(setup=setup, two=two.wait(), four=four.wait(), ref=ref, ref_lora=ref_lora,
                tmp=tmp, cli=cli)


def test_parallel_config_validation():
    """The JAX package's checks and messages."""
    from csm_tpu.parallel.mesh import ParallelConfig as JConfig

    assert not tmesh.ParallelConfig().enabled and tmesh.ParallelConfig(fsdp=True).enabled
    assert [f.name for f in dataclasses.fields(tmesh.ParallelConfig)] == [
        f.name for f in dataclasses.fields(JConfig)]
    for kw in (dict(pipeline_parallel=2, model_parallel=2), dict(seq_parallel=2, fsdp=True),
               dict(pipeline_parallel=2, seq_parallel=2)):
        with pytest.raises(ValueError, match="mutually exclusive") as got:
            tmesh.ParallelConfig(**kw).build_mesh(world_size=4, rank=0)
        with pytest.raises(ValueError) as want:
            JConfig(**kw).build_mesh()
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="3 devices not divisible by model_parallel=2"):
        tmesh.ParallelConfig(model_parallel=2).build_mesh(world_size=3, rank=0)


def test_fit_spec_matches_jax():
    """An indivisible dim (the 2051 audio vocab) is replicated, every other
    dim kept: the JAX package's cases."""
    from jax.sharding import AbstractMesh, PartitionSpec as P

    jm = AbstractMesh((4, 2), ("data", "model"))
    tm = tmesh.build({"data": 4, "model": 2}, world_size=8, rank=0)
    cases = [((31, 1024, 2051), P(None, "data", "model")), ((2048, 2051), P("data", "model")),
             ((16, 2048, 2048), P(None, "data", "model")), ((8,), P(("data", "model"),)),
             ((4,), P(("data", "model"),)), ((), P())]
    for shape, spec in cases:
        want = jsharding.fit_spec(shape, spec, jm)
        assert tsharding.fit_spec(shape, tuple(spec), tm) == tuple(want) + (None,) * (
            len(tuple(spec)) - len(tuple(want)))


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_match_jax(fsdp):
    """The layout tree is the JAX package's PartitionSpec tree."""
    want = jsharding.csm_param_specs(fsdp)
    got = tsharding.csm_param_specs(fsdp)
    flat_w = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(s) for p, s in
              jax.tree_util.tree_flatten_with_path(
                  want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}
    from csm_torch.training.optimizer import named_leaves

    assert dict(named_leaves(got)) == flat_w
    assert tsharding.batch_specs() == {k: tuple(v) for k, v in jsharding.batch_specs().items()}


def test_mesh_layout_and_batch_slices():
    """Ranks lie row-major over the axes, data outermost, as the JAX meshes
    reshape the device list; ``process_batch_slice`` gives a rank the rows of
    its data index (the JAX package's contract), and the single-process
    ``initialize`` creates no group."""
    import torch.distributed as dist

    for r in range(8):
        m = tmesh.build({"data": 2, "pipe": 2, "model": 2}, world_size=8, rank=r)
        assert m.coords == {"data": r // 4, "pipe": (r // 2) % 2, "model": r % 2}
        assert m.members["model"] == (r - r % 2, r - r % 2 + 1)
        assert m.members["data"] == (r % 4, r % 4 + 4)
        assert tdist.process_batch_slice(8, m) == (4 * (r // 4), 4)
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        tdist.process_batch_slice(3, tmesh.build({"data": 2}, world_size=2, rank=0))
    assert tdist.process_batch_slice(6) == (0, 6)
    assert tdist.initialize("cpu") == (0, 1) and not dist.is_initialized()


def test_mesh_entry_points_without_a_card_raise(monkeypatch, tmp_path):
    """A rank's device is the CPU only when the caller asks for it: with no
    card visible, ``rank_device("cuda")``, ``CSMTrainer(parallel=...)`` on
    its default device and the CLI's ``parallel_config`` raise before any
    group is made, as every entry point of the port does."""
    import argparse

    import torch.distributed as dist

    from csm_torch.cli.common import parallel_config
    from csm_torch.training.trainer import CSMTrainer
    from csm_torch.utils.params import random_csm_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tdist.rank_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdist.rank_device("cuda")
    args = tconfig.tiny_test_args()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        CSMTrainer(output_dir=str(tmp_path), args=args, params=random_csm_params(args, seed=0),
                   parallel=tmesh.ParallelConfig(fsdp=True))
    flags = argparse.Namespace(model_parallel=1, fsdp=True, pipeline_parallel=1,
                               pp_microbatches=1, seq_parallel=1, ring_layout="auto",
                               distributed=False, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        parallel_config(flags)
    assert not dist.is_initialized()


@pytest.mark.parametrize("name", sorted(TWO_RANKS))
def test_two_rank_layout_matches_jax(runs, name):
    """DP, TP, FSDP and TP+FSDP on 2 ranks: loss, every gradient and the
    parameters after two steps against the JAX single-device step; every
    rank reports the same global losses."""
    two = runs["two"]
    assert two[0][name]["losses"] == two[1][name]["losses"]
    assert_matches(two[0][name], runs["ref"], name)


@pytest.mark.parametrize("name", ["lora_tp", "lora_fsdp", "lora_tp_fsdp"])
def test_lora_over_tp_and_fsdp_matches_jax(runs, name):
    """LoRA on every projection over a frozen base split over model (heads
    and FFN) and over data (FSDP): the adapters' loss, gradients and values
    after two steps against the JAX single-device LoRA step."""
    two = runs["two"]
    assert two[0][name]["losses"] == two[1][name]["losses"]
    assert_matches(two[0][name], runs["ref_lora"], name)


def test_lora_dropout_under_tp_matches_data_parallel(runs):
    """Adapter-input dropout 0.5 under TP: the masks are drawn over the
    whole input and each rank keeps its columns of those of wo and w2, so
    the run equals the data-parallel one, whose ranks draw the same masks
    for the whole batch (the masks are the port's own: no JAX reference)."""
    tp, dp = runs["two"][0]["lora_tp_dropout"], runs["two"][0]["lora_dp_dropout"]
    np.testing.assert_allclose(tp["losses"], dp["losses"], rtol=LOSS_RTOL)
    assert tp["losses"][0] != runs["two"][0]["lora_tp"]["losses"][0]
    for path, p in tp["params"].items():
        np.testing.assert_allclose(p.numpy(), dp["params"][path].numpy(), atol=PARAM_ATOL,
                                   err_msg=path)


def test_witness_reference_and_compare(runs):
    """The reference of the card's float32 witnesses
    (``witness.run_case(single=True)``) is the single-process step, with no
    mesh and no group: it matches the JAX single-device step.  ``compare``
    holds it to itself (every element strict), refuses an element with the
    largest gradient moved by 1e-4, and lets an element whose two
    gradients are within the measured noise move by up to 4·lr."""
    import copy

    import torch.distributed as dist

    from csm_torch.parallel import witness

    s = runs["setup"]
    out = witness.run_case(dict(name="single", parallel={}, ratio=s.ratio, lr=LR), s.spec(),
                           torch.device("cpu"), single=True)
    assert not dist.is_initialized() and out["shape"] == {}
    assert_matches(out, runs["ref"], "single")
    tol = dict(loss_rtol=LOSS_RTOL, grad_atol=GRAD_ATOL, grad_rtol=GRAD_RTOL,
               param_atol=PARAM_ATOL, lr=LR)
    same = witness.compare(out, out, tol)
    assert same["ok"] and same["free_elements"] == 0
    assert same["strict_elements"] == same["elements"] == sum(
        p.numel() for p in out["params"].values())
    ref = copy.deepcopy(out)
    g1, g2 = ref["grads"]["backbone/wq"].view(-1), ref["grads2"]["backbone/wq"].view(-1)
    i, quiet = int(g1.abs().argmax()), int(g1.abs().argmin())
    g1[quiet] = g2[quiet] = 1e-7  # an element whose gradients lie within the noise
    moved = copy.deepcopy(ref)
    moved["grads"]["backbone/wq"] += 1e-5  # gradient noise, within the gradients' tolerance
    moved["params"]["backbone/wq"].view(-1)[i] += 1e-4
    got = witness.compare(moved, ref, tol)
    assert not got["ok"] and got["grad_share"] < 1 and got["free_elements"] >= 1
    moved["params"]["backbone/wq"].view(-1)[i] -= 1e-4
    moved["params"]["backbone/wq"].view(-1)[quiet] += 3 * LR
    assert witness.compare(moved, ref, tol)["ok"]


def test_four_rank_dp_tp_fsdp_matches_jax(runs):
    """A (data=2, model=2) mesh with FSDP on 4 ranks."""
    out = runs["four"][0]["dp_tp_fsdp"]
    assert out["shape"] == {"data": 2, "model": 2}
    assert_matches(out, runs["ref"], "dp_tp_fsdp")


def test_tp_splits_heads_fsdp_splits_embed(runs):
    """What each rank holds: the backbone's heads and FFN over model, its
    embed dim over data; the tiny decoder (one kv head) whole on every model
    rank."""
    s = runs["setup"]
    whole = torch.load(s.params_path, weights_only=True)
    m = tmesh.build({"data": 2, "model": 2}, world_size=4, rank=3, fsdp=True)
    lay = tsharding.param_layouts(whole, s.targs, m)
    assert lay["backbone"]["wq"] == (None, "data", "model")
    assert lay["backbone"]["wo"] == (None, "model", "data")
    assert lay["decoder"]["wq"] == (None, "data", None)  # Hkv = 1: not split over model
    assert lay["audio_head"] == (None, "data", "model")
    assert lay["text_embeddings"] == ("model", "data")
    local = tsharding.shard_params(whole, m, s.targs)
    assert local["backbone"]["wq"].shape == (2, 32, 32)
    assert local["decoder"]["wq"] is not whole["decoder"]["wq"]  # a slice over data
    assert tsharding.shard_params(whole, m, s.targs, fsdp=False)["decoder"]["wq"] is (
        whole["decoder"]["wq"])  # whole: kept as it is
    torch.testing.assert_close(local["backbone"]["wq"], whole["backbone"]["wq"][:, 32:, 32:])


def test_trainer_over_mesh_matches_and_resumes(runs, tmp_path):
    """``CSMTrainer(parallel=ParallelConfig(model_parallel=2, fsdp=True))``:
    the single-process trainer's loss (rtol 2e-4) and parameters (2e-5);
    the run's checkpoint is the single-process layout (``state.pt`` of
    whole tensors, ``meta.json``, ``latest``), and a trainer resumed from it
    on the mesh continues bit for bit."""
    import copy
    import json
    import os

    from csm_torch.training.optimizer import named_leaves
    from csm_torch.training.trainer import CSMTrainer

    out = runs["two"][0]["trainer:tp_fsdp"]
    assert out["mesh"] == {"data": 1, "model": 2} and out["step_resumed"] == 4
    assert out["loss_resumed"] == out["loss_continued"]
    for (p, a), (_, b) in zip(named_leaves(out["continued"]), named_leaves(out["resumed"])):
        assert torch.equal(a, b), p
    s = runs["setup"]
    whole = torch.load(s.params_path, weights_only=True)
    tr = CSMTrainer(output_dir=str(tmp_path), args=s.targs, params=copy.deepcopy(whole),
                    learning_rate=LR, compute_dtype=torch.float32, remat=False, device="cpu")
    batches = [Batch(*map(torch.from_numpy, b)) for b in s.batches]
    loss = tr.train(batches, batch_size=4, epochs=2, save_every=10_000, val_every=10_000)
    np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL)
    for (p, a), (_, b) in zip(named_leaves(out["first"]), named_leaves(tr.state.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=PARAM_ATOL, err_msg=p)
    ck = os.path.join(str(runs["tmp"] / "trainer"), "checkpoints")
    assert json.load(open(os.path.join(ck, "latest.json")))["latest"] == "final"
    state = torch.load(os.path.join(ck, "first", "state.pt"), weights_only=True)
    assert state["params"]["backbone"]["wq"].shape == whole["backbone"]["wq"].shape
    assert state["opt_state"]["mu"]["backbone/wq"].shape == whole["backbone"]["wq"].shape
    assert not os.path.exists(os.path.join(str(runs["tmp"] / "trainer"), "training.rank0.log"))


def test_lora_trainer_over_tp_fsdp_matches_and_resumes(runs, tmp_path):
    """``CSMLoRATrainer(parallel=ParallelConfig(model_parallel=2,
    fsdp=True))`` with adapters on every projection: the single-process
    trainer's loss and adapters; resumed from its checkpoint it continues
    bit for bit."""
    import copy

    from csm_torch.training.optimizer import named_leaves
    from csm_torch.training.trainer import CSMLoRATrainer

    out = runs["two"][0]["trainer:lora_tp_fsdp"]
    assert out["mesh"] == {"data": 1, "model": 2} and out["step_resumed"] == 4
    assert out["loss_resumed"] == out["loss_continued"]
    for (p, a), (_, b) in zip(named_leaves(out["continued"]), named_leaves(out["resumed"])):
        assert torch.equal(a, b), p
    s = runs["setup"]
    whole = torch.load(s.params_path, weights_only=True)
    tr = CSMLoRATrainer(output_dir=str(tmp_path), args=s.targs, params=copy.deepcopy(whole),
                        learning_rate=LR, compute_dtype=torch.float32, remat=False,
                        device="cpu", lora_r=4, target_modules=ALL_TARGETS)
    batches = [Batch(*map(torch.from_numpy, b)) for b in s.batches]
    loss = tr.train(batches, batch_size=4, epochs=2, save_every=10_000, val_every=10_000)
    np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL)
    for (p, a), (_, b) in zip(named_leaves(out["first"]), named_leaves(tr.state.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=PARAM_ATOL, err_msg=p)


def test_cli_train_fsdp_over_two_ranks(runs):
    """``csm-torch-train --fsdp`` on 2 ranks trains to its end and rank 0
    writes the single-process checkpoint."""
    import json
    import os

    assert runs["two"][0]["call:cli"] == 0 == runs["two"][1]["call:cli"]
    out = str(runs["tmp"] / "cli_fsdp")
    meta = json.load(open(os.path.join(out, "checkpoints", "final", "meta.json")))
    assert meta["global_step"] >= 1
    assert os.path.exists(os.path.join(out, "training.rank1.log"))


def test_batch_feed_from_local_rows():
    """A feed that loads only its rows (``process_batch_slice``) gives each
    rank the part the loss takes from the global batch: its rows on a data
    layout, its ring positions too on a (data, seq) one."""
    from csm_torch.parallel.ring_attention import seq_columns

    s = tconfig.tiny_test_args()
    whole = Batch(*map(torch.from_numpy, make_batch(s, B=4, T=16, seed=3)))
    for r in range(4):
        m = tmesh.build({"data": 2, "seq": 2}, world_size=4, rank=r)
        start, n = tdist.process_batch_slice(4, m)
        rows = Batch(*(t[start:start + n] for t in whole))
        got = tdist.global_batch_from_local(rows, m, seq_sharded=True, layout="zigzag")
        cols = seq_columns(16, m, "zigzag")
        for a, b in zip(got, whole):
            assert torch.equal(a, b[start:start + n][:, cols])
        flat = tdist.global_batch_from_local(rows, m)
        assert all(torch.equal(a, b) for a, b in zip(flat, rows))
        assert all(torch.equal(a, b) for a, b in zip(tsharding.shard_batch(whole, m), rows))
    assert list(seq_columns(16, tmesh.build({"seq": 2}, world_size=2, rank=1), "zigzag")) == [
        4, 5, 6, 7, 8, 9, 10, 11]
