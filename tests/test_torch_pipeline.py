"""The port's pipeline parallelism on the CPU over gloo, held against the
JAX package.

Ranks are child processes (``csm_torch.parallel.launch``; see
tests/test_torch_parallel.py).  One 2-rank group runs the pipeline (2
stages, 2 microbatches), LoRA on q/v through it (the JAX package's
adapters, bridged), LoRA dropout through it twice, the LoRA trainer over it
with its checkpoint and resume, and ``csm-torch-finetune-lora
--pipeline-parallel 2``; one 4-rank group runs data × pipe and pipe ×
model (Megatron TP inside each stage).  Each is held against the JAX
package's single-device step at its pipeline tests' tolerances
(tests/test_pipeline.py, tests/test_trainer_parallel.py): the loss rtol
2e-4, parameters after two steps atol 2e-5, gradients atol 5e-4 / rtol
1e-3 (tests/test_ring_attention.py).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from csm_tpu.parallel import pipeline as jpipe
from csm_tpu.training import lora as jlora
from csm_torch.parallel import mesh as tmesh
from csm_torch.parallel import pipeline as tpipe
from csm_torch.parallel.launch import start
from csm_torch.training.optimizer import named_leaves
from csm_torch.utils.params import lora_from_jax
from test_torch_parallel import (LOSS_RTOL, PARAM_ATOL, Setup, assert_matches,
                                 jax_reference)

LCFG = dict(r=4, alpha=8.0, target_modules=("q_proj", "v_proj"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    setup = Setup(tmp, B=4, T=16)
    jl = jlora.LoRAConfig(**LCFG)
    jad = jax.tree.map(np.asarray, jlora.init_lora_params(jax.random.key(5), setup.jargs, jl))
    # B starts at zero; move it so the first step's adapter gradients are not all zero
    jad = jax.tree.map(lambda x: x + np.float32(0.01), jad)
    lora_path = str(tmp / "lora.pt")
    torch.save(lora_from_jax(jad), lora_path)
    pp = dict(pipeline_parallel=2, pp_microbatches=2)
    data = tmp / "wavs"
    data.mkdir()
    from csm_torch.data import audio as taudio
    from test_torch_trainer import sine

    for i in range(2):
        taudio.save_wav(str(data / f"utt{i}.wav"), sine(1.2 + 0.3 * i, hz=200.0 + 50 * i), 24_000)
        (data / f"utt{i}.txt").write_text(f"synthetic utterance number {i}")
    cli = ["--audio-dir", str(data), "--tiny-test", "--device", "cpu", "--val-split", "0",
           "--epochs", "1", "--batch-size", "2", "--lora-r", "4", "--pipeline-parallel", "2",
           "--pp-microbatches", "2", "--output-dir", str(tmp / "cli_pp")]
    two = start("csm_torch.parallel.witness:run", 2, tmp / "two", setup.spec(
        cases=[dict(name="pp", parallel=pp, ratio=setup.ratio),
               dict(name="pp_lora", parallel=pp, ratio=setup.ratio, lora=LCFG,
                    lora_params=lora_path),
               dict(name="drop_a", parallel=pp, ratio=setup.ratio, lora=dict(LCFG, dropout=0.5),
                    lora_params=lora_path, grads=False),
               dict(name="drop_b", parallel=pp, ratio=setup.ratio, lora=dict(LCFG, dropout=0.5),
                    lora_params=lora_path, grads=False)],
        trainers=[dict(name="lora_pp", parallel=pp, epochs=2, batch_size=4,
                       lora=dict(lora_r=4, target_modules=("q_proj", "v_proj")),
                       out_dir=str(tmp / "trainer"))],
        calls=[("cli", "csm_torch.cli.finetune_lora:main", cli)]))
    four = start("csm_torch.parallel.witness:run", 4, tmp / "four", setup.spec(
        cases=[dict(name="dp_pp", parallel=pp, ratio=setup.ratio),
               dict(name="pp_tp", parallel=pp, pp_model_parallel=2, ratio=setup.ratio)]))
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
    return dict(two=two.wait(), four=four.wait(), ref=ref, ref_lora=ref_lora, setup=setup,
                tmp=tmp)


@pytest.mark.parametrize("tp", [False, True])
def test_pp_param_specs_match_jax(tp):
    """The layout tree is the JAX package's pipeline PartitionSpec tree."""
    want = {"/".join(str(getattr(k, "key", k)) for k in p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                jpipe.pp_param_specs(tp), is_leaf=lambda x: isinstance(x, P))[0]}
    got = dict(named_leaves(tpipe.pp_param_specs(tp)))
    assert set(got) == set(want)
    for k in want:  # P() whole vs (None, ...): the same layout
        assert tuple(a for a in got[k] if a) == tuple(a for a in want[k] if a), k


def test_pipeline_meshes_and_errors():
    """(data, pipe[, model]) meshes and the JAX package's refusals."""
    m = tpipe.make_pp_mesh(world_size=8, rank=5, pipeline_parallel=2, model_parallel=2)
    assert m.shape == {"data": 2, "pipe": 2, "model": 2}
    assert m.coords == {"data": 1, "pipe": 0, "model": 1}
    with pytest.raises(ValueError, match="6 devices not divisible by pipeline_parallel=2 x "
                                         "model_parallel=2"):
        tpipe.make_pp_mesh(world_size=6, rank=0, pipeline_parallel=2, model_parallel=2)
    from csm_torch.models.config import TransformerConfig

    with pytest.raises(ValueError, match="3 layers not divisible by pipe=2"):
        tpipe.check_stages(TransformerConfig(num_layers=3, num_heads=2, num_kv_heads=1,
                                             embed_dim=32, intermediate_dim=64), m)
    assert tmesh.ParallelConfig(pipeline_parallel=2).build_mesh(world_size=4, rank=3).shape == {
        "data": 2, "pipe": 2}
    from csm_torch.models.config import tiny_test_args
    from csm_torch.utils.params import random_csm_params

    args = tiny_test_args()
    whole = random_csm_params(args, seed=0)
    mine = tpipe.shard_params_pp(whole, m, args)  # stage 0, model rank 1
    torch.testing.assert_close(mine["backbone"]["wq"], whole["backbone"]["wq"][:1, :, 32:])
    assert mine["text_embeddings"].shape == (64, 64)  # vocab 128 over pipe


def test_lora_layouts_follow_the_stages():
    """Backbone adapters split over pipe like their layers; a stack whose
    layer count the axis does not divide stays whole (the JAX
    ``shard_lora_pp`` rule)."""
    m = tpipe.make_pp_mesh(world_size=2, rank=1, pipeline_parallel=2)
    lora = {"backbone": {"wq": {"a": torch.zeros(4, 8, 2)}},
            "decoder": {"wq": {"a": torch.zeros(3, 8, 2)}}}
    lay = tpipe.lora_pp_layouts(lora, m)
    assert lay == {"backbone": {"wq": {"a": ("pipe", None, None)}},
                   "decoder": {"wq": {"a": (None, None, None)}}}
    assert tpipe.shard_lora_pp(lora, m)["backbone"]["wq"]["a"].shape == (2, 8, 2)


@pytest.mark.parametrize("name", ["pp", "dp_pp", "pp_tp"])
def test_pipeline_matches_jax(runs, name):
    """The pipelined train step (2 stages, 2 microbatches; with a data axis;
    with TP inside each stage): loss, gradients and parameters after two
    steps against the JAX single-device step."""
    group = runs["four"] if name in ("dp_pp", "pp_tp") else runs["two"]
    want_shape = {"pp": {"data": 1, "pipe": 2}, "dp_pp": {"data": 2, "pipe": 2},
                  "pp_tp": {"data": 1, "pipe": 2, "model": 2}}[name]
    assert group[0][name]["shape"] == want_shape
    assert len({tuple(r[name]["losses"]) for r in group}) == 1
    assert_matches(group[0][name], runs["ref"], name)


def test_pp_lora_matches_jax(runs):
    """LoRA on q/v through the pipeline (the backbone's adapters split with
    their stages, the decoder's gathered): against the JAX single-device
    LoRA step on the same adapters."""
    assert_matches(runs["two"][0]["pp_lora"], runs["ref_lora"], "pp_lora")


def test_pp_lora_dropout_trains(runs):
    """Dropout 0.5 through the stages: the masks come from the step's
    generator (two runs agree bit for bit), perturb the loss, and the
    adapters train."""
    a, b = runs["two"][0]["drop_a"], runs["two"][0]["drop_b"]
    assert a["losses"] == b["losses"] and np.isfinite(a["losses"]).all()
    assert a["losses"][0] != runs["two"][0]["pp_lora"]["losses"][0]
    moved = max((a["params"][p] - runs["two"][0]["pp_lora"]["params"][p]).abs().max().item()
                for p in a["params"])
    assert moved > 0


def test_lora_trainer_pipeline_matches_and_resumes(runs, tmp_path):
    """``CSMLoRATrainer(parallel=ParallelConfig(pipeline_parallel=2,
    pp_microbatches=2))``: the single-process trainer's loss and adapters;
    resumed from its checkpoint it continues bit for bit."""
    import copy

    from csm_torch.training.losses import Batch
    from csm_torch.training.trainer import CSMLoRATrainer

    out = runs["two"][0]["trainer:lora_pp"]
    assert out["mesh"] == {"data": 1, "pipe": 2}
    assert out["loss_resumed"] == out["loss_continued"]
    for (p, a), (_, b) in zip(named_leaves(out["continued"]), named_leaves(out["resumed"])):
        assert torch.equal(a, b), p
    s = runs["setup"]
    whole = torch.load(s.params_path, weights_only=True)
    tr = CSMLoRATrainer(output_dir=str(tmp_path), args=s.targs, params=copy.deepcopy(whole),
                        learning_rate=1e-3, compute_dtype=torch.float32, remat=False,
                        device="cpu", lora_r=4, target_modules=("q_proj", "v_proj"))
    batches = [Batch(*map(torch.from_numpy, b)) for b in s.batches]
    loss = tr.train(batches, batch_size=4, epochs=2, save_every=10_000, val_every=10_000)
    np.testing.assert_allclose(out["loss"], loss, rtol=LOSS_RTOL)
    for (p, a), (_, b) in zip(named_leaves(out["first"]), named_leaves(tr.state.params)):
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=PARAM_ATOL, err_msg=p)


def test_cli_finetune_lora_pipeline(runs):
    """``csm-torch-finetune-lora --pipeline-parallel 2 --pp-microbatches 2``
    on 2 ranks: rank 0 writes the whole adapter directory."""
    from csm_torch.training import lora as tlora

    assert runs["two"][0]["call:cli"] == 0 == runs["two"][1]["call:cli"]
    lo, cfg, _ = tlora.load_lora(str(runs["tmp"] / "cli_pp" / "adapter"))
    assert cfg.r == 4 and lo["backbone"]["wq"]["a"].shape[0] == runs["setup"].targs.backbone.num_layers
