"""The port's LoRA adapters (csm_torch/training/lora.py, the unmerged layer
path, the LoRA loss and train step) held against the JAX package at
``tiny_test_args()`` in float32 on the CPU.

Both packages use the same base weights (the JAX tree bridged with
``params_from_jax``) and the same adapters (bridged with ``lora_from_jax``;
B is made non-zero so the adapters change the output).  Tolerances: the
bank is bit-equal (the same concatenations and one float32 multiply); the
merged weights agree to 1e-6 relative (a float32 einsum); forwards, losses
and gradients to 1e-5 relative (float32 through a few layers; gradient atol
1e-5 of the leaf's largest entry); adapters after optimizer steps to 1e-3
of the learning rate, absolute (Adam divides each entry's gradient by its
own root mean square, so an entry whose gradient is at rounding level moves
by up to the learning rate either way).
The train steps run with ``amortization_ratio=1`` (every valid frame in the
acoustic subset), so the JAX package's random selection needs no injection.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models import llama as jllama
from csm_tpu.models.config import tiny_test_args
from csm_tpu.ops.attention import causal_mask_from_positions as jmask
from csm_tpu.training import lora as jlora
from csm_tpu.training import losses as jlosses
from csm_tpu.training import optimizer as jopt
from csm_tpu.training import train_step as jstep
from csm_torch.models import config as tconfig
from csm_torch.models import llama as tllama
from csm_torch.ops.attention import causal_mask_from_positions as tmask
from csm_torch.training import lora as tlora
from csm_torch.training import losses as tlosses
from csm_torch.training import optimizer as topt
from csm_torch.training import train_step as tstep
from csm_torch.utils.params import lora_from_jax, params_from_jax

FWD_TOL = 1e-5
MERGE_TOL = 1e-6
LR = 1e-2
STEP_ATOL = 1e-3 * LR
ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams


def jax_adapters(jargs, cfg, seed, shift=0.02):
    """A JAX adapter tree with non-zero B (numpy leaves)."""
    lo = jlora.init_lora_params(jax.random.key(seed), jargs, cfg)
    return jax.tree.map(lambda x: np.asarray(x + shift), lo)


def make_batch(args, B=2, T=12, seed=0):
    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    tokens = np.zeros((B, T, K + 1), np.int32)
    tokens_mask = np.zeros((B, T, K + 1), bool)
    targets = np.zeros((B, T, K), np.int32)
    target_mask = np.zeros((B, T), bool)
    t_text = T // 2
    tokens[:, :t_text, -1] = rng.integers(1, args.text_vocab_size, (B, t_text))
    tokens_mask[:, :t_text, -1] = True
    audio = rng.integers(0, args.audio_vocab_size, (B, T - t_text, K))
    tokens[:, t_text:, :K] = audio
    tokens_mask[:, t_text:, :K] = True
    targets[:, t_text - 1 : T - 1] = audio
    target_mask[:, t_text - 1 : T - 1] = True
    return tokens, tokens_mask, targets, target_mask


def flat(tree, prefix=""):
    """{path: numpy} of a nested dict (numpy or tensor leaves)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        elif v is not None:
            out[prefix + k] = v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def assert_trees_close(got, want, rel, exact=False, atol=None):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        if exact:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        else:
            at = rel * max(np.abs(w[k]).max(), 1e-30) if atol is None else atol
            np.testing.assert_allclose(g[k], w[k], rtol=rel, atol=at, err_msg=k)


# ---------------------------------------------------------------- the adapter tree


@pytest.mark.parametrize("targets,layers", [(("q_proj", "v_proj"), None), (ALL7, (0,))],
                         ids=["qv", "all7-layer0"])
def test_init_shapes_and_frozen_layers(tiny, targets, layers):
    """The port's tree has the JAX tree's names and shapes; B is zero; A is
    N(0, 1/in) on targeted layers and zero on the frozen ones."""
    jargs, targs, _ = tiny
    cfg_kw = dict(r=4, target_modules=targets, target_layers=layers)
    want = jlora.init_lora_params(jax.random.key(1), jargs, jlora.LoRAConfig(**cfg_kw))
    got = tlora.init_lora_params(torch.Generator().manual_seed(1), targs,
                                 tlora.LoRAConfig(**cfg_kw))
    fg, fw = flat(got), flat(want)
    assert {k: v.shape for k, v in fg.items()} == {k: v.shape for k, v in fw.items()}
    for k, v in fg.items():
        if k.endswith("/b"):
            assert not v.any()
        elif layers is not None:
            assert v[0].any() and not v[1:].any(), k
        else:
            assert 0.5 < v.std() * np.sqrt(v.shape[-2]) < 1.5, k
    assert tlora.count_params(got) == jlora.count_params(want)


def test_config_json_and_names():
    cfg = tlora.LoRAConfig(r=16, alpha=32.0, target_modules=ALL7, target_layers=(0, 2))
    assert tlora.LoRAConfig.from_json(cfg.to_json()) == cfg
    assert cfg.to_json() == jlora.LoRAConfig(r=16, alpha=32.0, target_modules=ALL7,
                                             target_layers=(0, 2)).to_json()
    assert cfg.scaling == 2.0 and cfg.projections == ("wq", "wk", "wv", "wo", "w1", "w3", "w2")
    assert tlora.MODULE_NAME_MAP == jlora.MODULE_NAME_MAP


def test_merge_lora_matches_jax(tiny):
    jargs, _, jparams = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=ALL7)
    lo = jax_adapters(jargs, cfg, 2)
    want = jax.tree.map(np.asarray, jlora.merge_lora(jparams, lo, cfg))
    got = tlora.merge_lora(params_from_jax(jparams), lora_from_jax(lo),
                           tlora.LoRAConfig(r=4, target_modules=ALL7))
    assert_trees_close(got, want, MERGE_TOL)


@pytest.mark.parametrize("layout", ["fused", "separate"])
def test_fuse_lora_bank_bit_equal(tiny, layout):
    """Adapters of different ranks, alphas and targets (one decoder-only):
    the port's bank equals the JAX bank bit for bit in float32."""
    jargs, targs, _ = tiny
    cfgs = [jlora.LoRAConfig(r=4), jlora.LoRAConfig(r=2, alpha=8.0, target_modules=ALL7),
            jlora.LoRAConfig(r=3, apply_to_backbone=False)]
    los = [jax_adapters(jargs, c, 10 + i) for i, c in enumerate(cfgs)]
    want = jax.tree.map(np.asarray, jax.jit(lambda: jlora.fuse_lora_bank(
        list(zip(los, cfgs)), jargs, dtype=jnp.float32, layout=layout))())
    tcfgs = [tlora.LoRAConfig(**dataclasses.asdict(c)) for c in cfgs]
    got = tlora.fuse_lora_bank([(lora_from_jax(lo), c) for lo, c in zip(los, tcfgs)], targs,
                               dtype=torch.float32, layout=layout)
    assert sorted(got) == sorted(want)
    assert_trees_close(got, want, 0.0, exact=True)


def test_interpolate_lora(tiny):
    jargs, _, _ = tiny
    cfg = jlora.LoRAConfig(r=4)
    a, b = jax_adapters(jargs, cfg, 3), jax_adapters(jargs, cfg, 4, shift=-0.01)
    want = jax.tree.map(np.asarray, jlora.interpolate_lora([a, b], [0.3, 0.9]))
    got = tlora.interpolate_lora([lora_from_jax(a), lora_from_jax(b)], [0.3, 0.9])
    assert_trees_close(got, want, MERGE_TOL)


def test_save_load_round_trip(tiny, tmp_path):
    jargs, targs, _ = tiny
    cfg = tlora.LoRAConfig(r=4, target_modules=ALL7, target_layers=(1,))
    lo = lora_from_jax(jax_adapters(jargs, jlora.LoRAConfig(r=4, target_modules=ALL7), 5))
    path = tlora.save_lora(str(tmp_path / "adapter"), lo, cfg, targs)
    got, gcfg, gargs = tlora.load_lora(path)
    assert gcfg == cfg and gargs == targs
    assert_trees_close(got, lo, 0.0, exact=True)
    meta = (tmp_path / "adapter" / "lora_metadata.json").read_text()
    assert '"num_lora_params"' in meta and '"lora_config"' in meta and '"model_args"' in meta


# ---------------------------------------------------------------- the model


def _jax_fwd(params, cfg, h, lora, scale):
    B, S, _ = h.shape
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    out, _ = jllama.transformer_apply(jax.tree.map(jnp.asarray, params), cfg, jnp.asarray(h), pos,
                                      jmask(pos, pos[0]), lora=lora, lora_scale=scale)
    return np.asarray(out)


def _torch_fwd(params, cfg, h, lora=None, scale=0.0):
    B, S, _ = h.shape
    pos = torch.arange(S).expand(B, S)
    with torch.no_grad():
        out, _ = tllama.transformer_apply(params, cfg, torch.from_numpy(h), pos,
                                          tmask(pos, pos[0]), lora=lora, lora_scale=scale)
    return out.numpy()


@pytest.mark.parametrize("comp", ["backbone", "decoder"])
def test_unmerged_forward_matches_jax_and_merged(tiny, comp):
    jargs, targs, jparams = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=ALL7)
    lo = jax_adapters(jargs, cfg, 6)
    tcfg = getattr(targs, comp)
    h = np.random.default_rng(0).standard_normal((2, 9, tcfg.embed_dim)).astype(np.float32)
    tp = params_from_jax(jparams)
    want = _jax_fwd(jparams[comp], getattr(jargs, comp), h, jax.tree.map(jnp.asarray, lo[comp]),
                    cfg.scaling)
    got = _torch_fwd(tp[comp], tcfg, h, lora_from_jax(lo)[comp], cfg.scaling)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL * np.abs(want).max())
    merged = tlora.merge_lora(tp, lora_from_jax(lo), tlora.LoRAConfig(r=4, target_modules=ALL7))
    dense = _torch_fwd(merged[comp], tcfg, h)
    np.testing.assert_allclose(got, dense, rtol=FWD_TOL, atol=FWD_TOL * np.abs(dense).max())
    assert not np.allclose(got, _torch_fwd(tp[comp], tcfg, h), atol=1e-3)  # the adapter acts


def test_fused_layout_refuses_unmerged_adapters(tiny):
    _, targs, jparams = tiny
    from csm_torch.models.csm import fuse_csm_params

    fused = fuse_csm_params(params_from_jax(jparams))
    lo = tlora.init_lora_params(torch.Generator().manual_seed(0), targs, tlora.LoRAConfig(r=2))
    h = np.zeros((1, 3, targs.backbone.embed_dim), np.float32)
    with pytest.raises(ValueError, match="merged first"):
        _torch_fwd(fused["backbone"], targs.backbone, h, lo["backbone"], 2.0)


# ---------------------------------------------------------------- training


def jax_loss_and_grads(jargs, jparams, lo, cfg, batch, ratio=1):
    fn = jax.jit(jax.value_and_grad(
        lambda l: jlosses.compute_loss(jax.tree.map(jnp.asarray, jparams), jargs,
                                       jax.random.key(0), jlosses.Batch(*map(jnp.asarray, batch)),
                                       amortization_ratio=ratio, compute_dtype=jnp.float32,
                                       lora=l, lora_scale=cfg.scaling), has_aux=True))
    (loss, _), grads = fn(jax.tree.map(jnp.asarray, lo))
    return float(loss), jax.tree.map(np.asarray, grads)


def torch_loss_and_grads(targs, base, lo, scale, batch, ratio=1, remat=False, dropout=0.0,
                         seed=0):
    leaves = [t.requires_grad_() for _, t in topt.named_leaves(lo)]
    loss, _ = tlosses.compute_loss(
        base, targs, torch.Generator().manual_seed(seed),
        tlosses.Batch(*map(torch.from_numpy, batch)), amortization_ratio=ratio,
        compute_dtype=torch.float32, remat=remat, lora=lo, lora_scale=scale,
        lora_dropout=dropout)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip([p for p, _ in topt.named_leaves(lo)], grads))


@pytest.mark.parametrize("targets", [("q_proj", "v_proj"), ALL7], ids=["qv", "all7"])
def test_compute_loss_with_adapters_matches_jax(tiny, targets):
    """The loss and every adapter gradient agree with jax.value_and_grad of
    the JAX loss (dropout 0); the base gets no gradient."""
    jargs, targs, jparams = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=targets)
    lo = jax_adapters(jargs, cfg, 7)
    batch = make_batch(targs, seed=1)
    want_loss, want_g = jax_loss_and_grads(jargs, jparams, lo, cfg, batch)
    base = params_from_jax(jparams)
    got_loss, got_g = torch_loss_and_grads(targs, base, lora_from_jax(lo), cfg.scaling, batch)
    assert got_loss == pytest.approx(want_loss, rel=FWD_TOL)
    fw = flat(want_g)
    for path, g in got_g.items():
        w = fw[path]
        np.testing.assert_allclose(g.numpy(), w, rtol=FWD_TOL, atol=FWD_TOL * np.abs(w).max(),
                                   err_msg=path)
    assert all(t.grad is None and not t.requires_grad for _, t in topt.named_leaves(base))


@pytest.mark.parametrize("accum", [1, 2])
def test_lora_train_step_matches_jax(tiny, accum):
    """Two calls of ``make_lora_train_step`` with ``make_lora_optimizer``
    (an update on each, or one update over the two with
    ``accumulation_steps=2``): the adapters agree with the JAX step's."""
    jargs, targs, jparams = tiny
    cfg = jlora.LoRAConfig(r=4)
    lo = jax_adapters(jargs, cfg, 8)
    batches = [make_batch(targs, seed=20 + i) for i in range(2)]
    jtx = jopt.make_lora_optimizer(learning_rate=LR, accumulation_steps=accum)
    jfn = jstep.make_lora_train_step(jargs, jtx, cfg.scaling, amortization_ratio=1,
                                     compute_dtype=jnp.float32)
    jstate = jopt.init_train_state(jax.tree.map(jnp.asarray, lo), jtx)
    jbase = jax.tree.map(jnp.asarray, jparams)
    base = params_from_jax(jparams)
    ttx = topt.make_lora_optimizer(learning_rate=LR, accumulation_steps=accum)
    tfn = tstep.make_lora_train_step(targs, ttx, cfg.scaling, amortization_ratio=1,
                                     compute_dtype=torch.float32)
    tstate = topt.init_train_state(lora_from_jax(lo), ttx)
    for i, b in enumerate(batches):
        jstate, jm = jfn(jstate, jbase, jax.random.key(i), jlosses.Batch(*map(jnp.asarray, b)))
        tstate, tm = tfn(tstate, base, torch.Generator().manual_seed(i),
                         tlosses.Batch(*map(torch.from_numpy, b)))
        assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=FWD_TOL)
        assert tm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=FWD_TOL)
        assert_trees_close(tstate.params, jax.tree.map(np.asarray, jstate.params), 0.0,
                           atol=STEP_ATOL)
    moved = flat(tstate.params)
    assert any(not np.array_equal(moved[k], v) for k, v in flat(lo).items())
    assert all(t.grad is None for _, t in topt.named_leaves(base))


def test_dropout_eval_and_training(tiny):
    """Adapter dropout changes the training loss, the same seed draws the
    same masks, and the eval pass (dropout 0) equals no-dropout."""
    jargs, targs, jparams = tiny
    cfg = jlora.LoRAConfig(r=4, target_modules=ALL7)
    lo = lora_from_jax(jax_adapters(jargs, cfg, 9, shift=0.2))
    base = params_from_jax(jparams)
    batch = make_batch(targs, seed=2)
    plain, _ = torch_loss_and_grads(targs, base, lo, cfg.scaling, batch)
    a, _ = torch_loss_and_grads(targs, base, lo, cfg.scaling, batch, dropout=0.5, seed=3)
    b, _ = torch_loss_and_grads(targs, base, lo, cfg.scaling, batch, dropout=0.5, seed=3)
    c, _ = torch_loss_and_grads(targs, base, lo, cfg.scaling, batch, dropout=0.5, seed=4)
    assert a == b and a != plain and a != c
    with torch.no_grad():
        ev, _ = tlosses.compute_loss(base, targs, torch.Generator().manual_seed(3),
                                     tlosses.Batch(*map(torch.from_numpy, batch)),
                                     amortization_ratio=1, compute_dtype=torch.float32,
                                     lora=lo, lora_scale=cfg.scaling)
    assert ev.item() == plain


@pytest.mark.parametrize("T", [12, 256])
def test_dropout_gradients_equal_with_and_without_remat(tiny, T):
    """The masks are drawn before each layer runs, so the recompute under
    remat sees the forward's masks: the gradients with remat equal those
    without it under the same seed (at T=256 through the flash route)."""
    jargs, targs, jparams = tiny
    if T > targs.backbone.max_seq_len:
        targs = dataclasses.replace(targs, backbone_config=dataclasses.replace(
            targs.backbone_config, max_seq_len=T))
    cfg = jlora.LoRAConfig(r=4, target_modules=ALL7)
    lo = lora_from_jax(jax_adapters(jargs, cfg, 11, shift=0.1))
    base = params_from_jax(jparams)
    batch = make_batch(targs, T=T, seed=3)
    runs = [torch_loss_and_grads(targs, base, lo, cfg.scaling, batch, dropout=0.3, seed=5,
                                 remat=remat) for remat in (False, True)]
    (l0, g0), (l1, g1) = runs
    assert l0 == l1
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)
