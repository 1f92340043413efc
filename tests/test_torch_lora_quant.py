"""QLoRA (adapters over an int8 or int4 base), the LoRA trainers and the
background checkpoint writer, on the CPU at ``tiny_test_args()`` in float32.

Against the JAX package on the same numpy inputs: ``merge_lora`` over int8
and int4 bases (each targeted projection dequantized to bf16, the delta
added in bf16: equal to 1e-6 relative, the bf16 rounding of the same
float32 sums), the LoRA loss over quantized bases and its adapter
gradients (1e-5 relative; the JAX int4 matmul runs its plain arithmetic on
the CPU), and two train steps over each base (the adapters to 1e-3 of the
learning rate: Adam's per-entry normalization, test_torch_lora.py).  Then
the int8 base's ``autograd.Function`` against autograd through the
dequantized weight (bit-equal), tiny end-to-end runs of ``CSMLoRATrainer``
(int8 base, both save modes, resume) and ``MultiSpeakerLoRATrainer`` (one
base shared by the speakers), and the ``AsyncCheckpointWriter``: a failed
background save re-raises and ``latest`` never names a partial checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.training import lora as jlora
from csm_tpu.training import losses as jlosses
from csm_tpu.training import optimizer as jopt
from csm_tpu.training import train_step as jstep
from csm_tpu.utils import quantize as jq
from csm_torch.models import config as tconfig
from csm_torch.models import llama as tllama
from csm_torch.training import checkpoint as tckpt
from csm_torch.training import lora as tlora
from csm_torch.training import optimizer as topt
from csm_torch.training import train_step as tstep
from csm_torch.training.losses import Batch
from csm_torch.training.multi_speaker import MultiSpeakerLoRATrainer
from csm_torch.training.trainer import CSMLoRATrainer
from csm_torch.utils import quantize as tq
from csm_torch.utils.params import lora_from_jax, params_from_jax, random_csm_params
from test_torch_lora import (ALL7, FWD_TOL, LR, MERGE_TOL, STEP_ATOL, assert_trees_close,
                             jax_adapters, jax_loss_and_grads, make_batch, torch_loss_and_grads)

QUANT = {"int8": (jq.quantize_csm_params, tq.quantize_csm_params),
         "int4": (jq.quantize_csm_params_int4, tq.quantize_csm_params_int4)}


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    bases = {q: jax.tree.map(np.asarray, jax.jit(fn)(jax.tree.map(jnp.asarray, jparams)))
             for q, (fn, _) in QUANT.items()}
    return jargs, tconfig.tiny_test_args(), bases


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_merge_lora_over_quantized_base(tiny, quant):
    """Targeted projections come back dequantized to bf16 plus the delta,
    untargeted ones keep their quantized layout, as in the JAX package."""
    jargs, _, bases = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=("q_proj", "v_proj", "down_proj"))
    lo = jax_adapters(jargs, cfg, 2)
    want = jax.tree.map(lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32)),
                        jlora.merge_lora(bases[quant], lo, cfg))
    got = tlora.merge_lora(params_from_jax(bases[quant]), lora_from_jax(lo),
                           tlora.LoRAConfig(r=4, target_modules=cfg.target_modules))
    assert got["backbone"]["wq"].dtype == torch.bfloat16
    assert tq.is_quantized(got["backbone"]["wk"]) or tq.is_quantized_int4(got["backbone"]["wk"])
    got = {c: ({k: (v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
                for k, v in sub.items()} if isinstance(sub, dict) else sub)
           for c, sub in got.items()}
    for comp in ("backbone", "decoder"):
        for name in ("wq", "wv", "w2"):
            np.testing.assert_allclose(got[comp][name].numpy(), want[comp][name],
                                       rtol=MERGE_TOL, atol=MERGE_TOL, err_msg=f"{comp}/{name}")


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_qlora_loss_and_grads_match_jax(tiny, quant):
    jargs, targs, bases = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=ALL7)
    lo = jax_adapters(jargs, cfg, 7)
    batch = make_batch(targs, seed=1)
    want_loss, want_g = jax_loss_and_grads(jargs, bases[quant], lo, cfg, batch)
    got_loss, got_g = torch_loss_and_grads(targs, params_from_jax(bases[quant]),
                                           lora_from_jax(lo), cfg.scaling, batch)
    assert got_loss == pytest.approx(want_loss, rel=FWD_TOL)
    flat_want = {"/".join(k): v for k, v in _paths(want_g)}
    for path, g in got_g.items():
        w = flat_want[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=FWD_TOL, atol=FWD_TOL * np.abs(w).max(),
                                   err_msg=path)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_qlora_train_step_matches_jax(tiny, quant):
    jargs, targs, bases = tiny
    cfg = jlora.LoRAConfig(r=4)
    lo = jax_adapters(jargs, cfg, 8)
    jtx = jopt.make_lora_optimizer(learning_rate=LR)
    jfn = jstep.make_lora_train_step(jargs, jtx, cfg.scaling, amortization_ratio=1,
                                     compute_dtype=jnp.float32)
    jstate = jopt.init_train_state(jax.tree.map(jnp.asarray, lo), jtx)
    jbase = jax.tree.map(jnp.asarray, bases[quant])
    base = params_from_jax(bases[quant])
    ttx = topt.make_lora_optimizer(learning_rate=LR)
    tfn = tstep.make_lora_train_step(targs, ttx, cfg.scaling, amortization_ratio=1,
                                     compute_dtype=torch.float32)
    tstate = topt.init_train_state(lora_from_jax(lo), ttx)
    for i in range(2):
        b = make_batch(targs, seed=40 + i)
        jstate, jm = jfn(jstate, jbase, jax.random.key(i), jlosses.Batch(*map(jnp.asarray, b)))
        tstate, tm = tfn(tstate, base, torch.Generator().manual_seed(i),
                         Batch(*map(torch.from_numpy, b)))
        assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=FWD_TOL)
        assert_trees_close(tstate.params, jax.tree.map(np.asarray, jstate.params), 0.0,
                           atol=STEP_ATOL)


def test_int8_autograd_function_saves_the_int8_weight():
    """``Int8Matmul``: its output and input gradient equal autograd through
    ``(x @ w8.to(x.dtype)) * scale`` bit for bit, and what it saves for the
    backward is the int8 weight and its scales, not a float copy."""
    gen = torch.Generator().manual_seed(0)
    q = tq.quantize_weight(torch.randn(64, 48, generator=gen))
    x = torch.randn(3, 5, 64, generator=gen, requires_grad=True)
    g = torch.randn(3, 5, 48, generator=gen)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        y = tllama._proj(x, q)
    (dx,) = torch.autograd.grad(y, x, g)
    x2 = x.detach().clone().requires_grad_()
    y2 = (x2 @ q["w8"].to(x2.dtype)) * q["scale"].to(x2.dtype)
    (dx2,) = torch.autograd.grad(y2, x2, g)
    torch.testing.assert_close(y, y2, rtol=0, atol=0)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=0)
    assert {t.dtype for t in saved} == {torch.int8, torch.bfloat16}


# ---------------------------------------------------------------- trainers


def tiny_batches(n, targs):
    return [Batch(*map(torch.from_numpy, make_batch(targs, B=1, T=12, seed=60 + i)))
            for i in range(n)]


def lora_trainer(out, **kw):
    args = tconfig.tiny_test_args()
    kw.setdefault("params", random_csm_params(args, seed=0))
    return CSMLoRATrainer(output_dir=out, args=args, learning_rate=1e-3, lora_r=4,
                          compute_dtype=torch.float32, remat=False, device="cpu", **kw)


def test_lora_trainer_end_to_end(tmp_path):
    """int8 base: train two epochs with validation (the loss falls), the
    base untouched and without gradients, ``save_model`` both (the adapter
    directory loads back; the full checkpoint equals ``merge_lora``), a
    LoRA checkpoint whose params are the adapter tree resumes."""
    out = str(tmp_path / "run")
    tr = lora_trainer(out, quant_base="int8", async_checkpointing=True)
    assert tq.is_quantized(tr.params["backbone"]["wq"])
    base_wq = tr.params["backbone"]["wq"]["w8"].clone()
    data = tiny_batches(4, tr.args)
    tr.prepare_optimizer()
    first = tr.validate(data[:2], batch_size=1)
    loss = tr.train(data, val_dataset=data[:2], batch_size=1, epochs=2, val_every=4,
                    save_every=100)
    assert np.isfinite(loss) and tr.best_val_loss < first
    torch.testing.assert_close(tr.params["backbone"]["wq"]["w8"], base_wq, rtol=0, atol=0)
    assert not tr.params["text_embeddings"].requires_grad
    lora_dir, full_dir = tr.save_model(os.path.join(out, "adapter"), save_mode="both")
    lo, cfg, largs = tlora.load_lora(lora_dir)
    assert cfg == tr.lora_config and largs == tr.args
    assert_trees_close(lo, tr.state.params, 0.0, exact=True)
    merged = tlora.merge_lora(tr.params, tr.state.params, tr.lora_config)
    full, _ = tckpt.load_params(full_dir)
    torch.testing.assert_close(full["backbone"]["wq"], merged["backbone"]["wq"], rtol=0, atol=0)
    ckpt = tckpt.latest_checkpoint(os.path.join(out, "checkpoints"))
    assert ckpt.endswith("final")
    tr2 = lora_trainer(out, quant_base="int8")
    tr2.prepare_optimizer()
    tr2.load_checkpoint("latest")
    assert tr2.global_step == tr.global_step
    assert_trees_close(tr2.state.params, tr.state.params, 0.0, exact=True)
    assert np.isfinite(tr2.train(data[:2], batch_size=1, epochs=3))


def test_multi_speaker_trainer_shares_one_base(tmp_path):
    """Two speakers and a shared adapter over one int4 base: every trainer
    holds the same base tensors, the adapters start apart, each speaker
    trains and saves, and ``merge_speaker_models`` interpolates."""
    ms = MultiSpeakerLoRATrainer(
        [0, 1], output_dir=str(tmp_path), use_shared_adapter=True, args=tconfig.tiny_test_args(),
        params=random_csm_params(tconfig.tiny_test_args(), seed=0), quant_base="int4",
        learning_rate=1e-3, lora_r=4, compute_dtype=torch.float32, remat=False, device="cpu")
    t0, t1 = ms.trainers[0], ms.trainers[1]
    for t in (t1, ms.shared_trainer):  # the same storage
        for comp, name in (("backbone", "wq"), ("decoder", "w2"), ("text_embeddings", None)):
            a, b = t.params[comp], t0.params[comp]
            a, b = (a[name]["w4p"], b[name]["w4p"]) if name else (a, b)
            assert a.data_ptr() == b.data_ptr(), (comp, name)
    assert not torch.equal(t0.lora_params["backbone"]["wq"]["a"],
                           t1.lora_params["backbone"]["wq"]["a"])
    data = {sid: tiny_batches(2, t0.args) for sid in (0, 1)}
    losses = ms.train(data, epochs=1, batch_size=1)
    assert set(losses) == {0, 1} and all(np.isfinite(v) for v in losses.values())
    saved = ms.save_speaker_models()
    assert all(os.path.exists(os.path.join(p[0], "lora_metadata.json")) for p in saved.values())
    ms.shared_trainer.prepare_optimizer()
    mixed = ms.merge_speaker_models(1, shared_weight=0.25)
    want = tlora.interpolate_lora([ms.shared_trainer.state.params, t1.state.params], [0.25, 0.75])
    assert_trees_close(mixed, want, 0.0, exact=True)


def test_async_writer_failure_and_latest(tmp_path, monkeypatch):
    """A failed background save re-raises at the next ``wait`` and leaves
    ``latest`` on the last committed checkpoint (its meta and state whole);
    the next save commits again."""
    from csm_torch.training.optimizer import TrainState

    args = tconfig.tiny_test_args()
    state = TrainState({"w": torch.ones(3)}, {"count": 1}, 5)
    d = str(tmp_path)
    with tckpt.AsyncCheckpointWriter() as w:
        w.save(d, "good", state, args, global_step=5)
        w.wait()
        real = torch.save

        def broken(obj, path):
            with open(path, "wb") as f:
                f.write(b"partial")
            raise OSError("disk full")

        monkeypatch.setattr(tckpt.torch, "save", broken)
        w.save(d, "bad", state._replace(step=6), args, global_step=6)
        with pytest.raises(RuntimeError, match="async checkpoint save failed"):
            w.wait()
        assert tckpt.latest_checkpoint(d).endswith("good")
        assert not os.path.exists(os.path.join(d, "bad", "meta.json"))
        assert not os.path.exists(os.path.join(d, "bad", "state.pt"))
        st, meta = tckpt.load_checkpoint(tckpt.latest_checkpoint(d))
        assert meta["global_step"] == 5 and st.step == 5
        monkeypatch.setattr(tckpt.torch, "save", real)
        state.params["w"].add_(1)  # the snapshot was taken at save
        w.save(d, "again", state, args, global_step=7)
        state.params["w"].add_(1)
    st, meta = tckpt.load_checkpoint(tckpt.latest_checkpoint(d))
    assert meta["global_step"] == 7 and torch.equal(st.params["w"], torch.full((3,), 2.0))
    assert json.load(open(os.path.join(d, "latest.json"))) == {"latest": "again"}
