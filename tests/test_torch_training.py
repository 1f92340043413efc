"""The port's training loss, optimizer and train step held against the JAX
package at ``tiny_test_args()`` in float32 on the CPU.

Both packages start from the same weights (the JAX tree bridged with
``params_from_jax``), the same batch made with numpy from a seed and, for
the optimizer, the same gradients with zero moments.  The loss and every
gradient leaf agree to 1e-5 relative (float32 through a few layers; the
gradient atol is 1e-5 of the leaf's largest entry); optimizer states agree
to 1e-6 (one float32 update of the same arithmetic as optax's).

At T = 12 both packages take plain attention under a mask; at T = 256 the
port takes its flash route (the kernels' plain versions on the CPU) and the
JAX package, on the CPU, the mask route: the same function.  With
``amortization_ratio=1`` every valid frame is in the acoustic subset, so
the loss does not depend on the order of selection; at ratio 16 both
packages are handed the same selection scores.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from csm_tpu.models import csm as jcsm
from csm_tpu.models.config import tiny_test_args
from csm_tpu.training import losses as jlosses
from csm_tpu.training import optimizer as jopt
from csm_torch.models import config as tconfig
from csm_torch.training import losses as tlosses
from csm_torch.training import optimizer as topt
from csm_torch.training import train_step as tstep
from csm_torch.utils.params import params_from_jax

LOSS_TOL = 1e-5
OPT_TOL = 1e-6


def with_seq_len(args, n):
    return dataclasses.replace(
        args, backbone_config=dataclasses.replace(args.backbone_config, max_seq_len=n))


@pytest.fixture(scope="module")
def tiny():
    jargs = tiny_test_args()
    jparams = jax.tree.map(np.asarray, jcsm.init_csm_params(jax.random.key(0), jargs))
    return jargs, tconfig.tiny_test_args(), jparams


def make_batch(args, B=2, T=12, seed=0):
    """numpy (tokens, tokens_mask, targets, target_mask): half text prompt,
    half audio frames; position t predicts the audio frame at t+1."""
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


def leaves_close(got: dict, want: dict, rel: float):
    for (path, a), b in zip(topt.named_leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rel,
                                   atol=rel * max(np.abs(b).max(), 1e-30), err_msg=path)


def jax_loss_and_grads(jargs, jparams, batch, ratio):
    fn = jax.jit(jax.value_and_grad(jlosses.compute_loss, has_aux=True),
                 static_argnames=("args", "amortization_ratio", "compute_dtype"))
    (loss, metrics), grads = fn(jax.tree.map(jnp.asarray, jparams), jargs, jax.random.key(0),
                                jlosses.Batch(*map(jnp.asarray, batch)),
                                amortization_ratio=ratio, compute_dtype=jnp.float32)
    return float(loss), metrics, grads


def torch_loss_and_grads(targs, jparams, batch, ratio, scores=None, remat=False):
    params = params_from_jax(jparams)
    leaves = [t.requires_grad_() for _, t in topt.named_leaves(params)]
    loss, metrics = tlosses.compute_loss(
        params, targs, torch.Generator().manual_seed(0),
        tlosses.Batch(*map(torch.from_numpy, batch)), amortization_ratio=ratio,
        compute_dtype=torch.float32, remat=remat, frame_scores=scores)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), metrics, dict(zip([p for p, _ in topt.named_leaves(params)], grads))


def unflatten(flat: dict) -> dict:
    tree = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t
    return tree


@pytest.mark.parametrize("T,remat", [(12, False), (256, True)])
def test_compute_loss_and_grads_match_jax(tiny, T, remat):
    """T=12: the mask route; T=256 (max_seq_len raised): the port's flash
    route, with remat (recomputed layers give the same gradients)."""
    jargs, targs, jparams = tiny
    if T > 128:
        jargs, targs = with_seq_len(jargs, 512), with_seq_len(targs, 512)
    batch = make_batch(targs, B=2, T=T)
    want_loss, want_m, want_g = jax_loss_and_grads(jargs, jparams, batch, ratio=1)
    got_loss, got_m, got_g = torch_loss_and_grads(targs, jparams, batch, ratio=1, remat=remat)
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_TOL)
    for key in ("semantic_loss", "acoustic_loss"):
        np.testing.assert_allclose(got_m[key].item(), float(want_m[key]), rtol=LOSS_TOL)
    for key in ("num_target_frames", "num_amortized_frames"):
        assert int(got_m[key]) == int(want_m[key])
    leaves_close(unflatten(got_g), want_g, LOSS_TOL)


def test_amortized_selection_with_injected_scores_matches_jax(tiny, monkeypatch):
    """Ratio 16: both packages rank frames by the same scores."""
    jargs, targs, jparams = tiny
    batch = make_batch(targs, B=2, T=32, seed=3)
    scores = np.random.default_rng(7).random(2 * 32).astype(np.float32)

    def select(key, target_mask, n_sub):
        s = jnp.where(target_mask.reshape(-1), jnp.asarray(scores), -1.0)
        idx = jax.lax.top_k(s, n_sub)[1]
        return idx, target_mask.reshape(-1)[idx]

    monkeypatch.setattr(jlosses, "_select_amortized_frames", select)
    want_loss, want_m, want_g = jax_loss_and_grads(jargs, jparams, batch, ratio=16)
    got_loss, got_m, got_g = torch_loss_and_grads(
        targs, jparams, batch, ratio=16, scores=torch.from_numpy(scores))
    assert int(got_m["num_amortized_frames"]) == int(want_m["num_amortized_frames"]) == 4
    np.testing.assert_allclose(got_loss, want_loss, rtol=LOSS_TOL)
    leaves_close(unflatten(got_g), want_g, LOSS_TOL)


def random_grads(jparams, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)).astype(np.float32),
                        jparams)


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("kw", [
    dict(max_grad_norm=1.0),  # clipping active (the gradients' norm is ~1e3)
    dict(max_grad_norm=1e6),  # clipping inactive
    dict(max_grad_norm=1.0, freeze_backbone=True, freeze_embeddings=True),
    dict(max_grad_norm=1.0, accumulation_steps=2),
], ids=["clip", "noclip", "frozen", "accum2"])
def test_optimizer_matches_optax(tiny, kw, n_steps):
    """Per-component AdamW with the same gradients: params after each call
    agree with optax's make_optimizer to 1e-6 (with accumulation, each call
    is one accumulated gradient, an update every second call)."""
    _, _, jparams = tiny
    calls = n_steps * kw.get("accumulation_steps", 1)
    opts = dict(learning_rate=1e-2, weight_decay=0.01, **kw)
    jtx = jopt.make_optimizer(jparams, **opts)
    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = jtx.init(jp)
    tp = params_from_jax(jparams)
    ttx = topt.make_optimizer(tp, **opts)
    tstate = ttx.init(tp)
    for i in range(calls):
        g = random_grads(jparams, seed=10 + i)
        updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        moved = ttx.update(tp, [torch.from_numpy(x) for x in jax.tree.leaves(g)], tstate)
        assert moved == ((i + 1) % kw.get("accumulation_steps", 1) == 0)
        leaves_close(tp, jp, OPT_TOL)
    if kw.get("freeze_backbone"):
        np.testing.assert_array_equal(tp["backbone"]["wq"].numpy(), jparams["backbone"]["wq"])
        assert "backbone/wq" not in tstate["mu"]


def test_optimizer_refuses_what_waits(tiny):
    """Adam moments stored in other dtypes (bf16 mu, f32 nu; bf16 both):
    the moments keep their dtype and three updates agree with optax's
    make_optimizer of the same dtypes (the update reads the moments as
    stored in both) to 1e-6 relative, or within one bf16 rounding of a
    moment a step: 2^-8 of the learning rate, times the three steps."""
    _, _, jparams = tiny
    for mu, nu in ((torch.bfloat16, None), (torch.bfloat16, torch.bfloat16)):
        jdt = {torch.bfloat16: jnp.bfloat16, None: None}
        opts = dict(learning_rate=1e-2, weight_decay=0.01, max_grad_norm=1.0)
        jtx = jopt.make_optimizer(jparams, mu_dtype=jdt[mu], nu_dtype=jdt[nu], **opts)
        jp = jax.tree.map(jnp.asarray, jparams)
        jstate = jtx.init(jp)
        tp = params_from_jax(jparams)
        ttx = topt.make_optimizer(tp, mu_dtype=mu, nu_dtype=nu, **opts)
        tstate = ttx.init(tp)
        for i in range(3):
            g = random_grads(jparams, seed=30 + i)
            updates, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
            jp = optax.apply_updates(jp, updates)
            ttx.update(tp, [torch.from_numpy(x) for x in jax.tree.leaves(g)], tstate)
        for (path, a), b in zip(topt.named_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=OPT_TOL,
                                       atol=3 * 2**-8 * 1e-2, err_msg=path)
        assert tstate["mu"]["decoder/wq"].dtype == mu
        assert tstate["nu"]["decoder/wq"].dtype == (nu or torch.float32)


def test_grad_microbatches_equal_one_batch(tiny):
    """Two microbatches of equal target counts give the full batch's
    gradients (mean of the halves' means) and the same metrics."""
    _, targs, jparams = tiny
    batch = tlosses.Batch(*map(torch.from_numpy, make_batch(targs, B=4, T=12, seed=5)))

    def run(n_micro):
        params = params_from_jax(jparams)
        loss_fn = lambda p, g, b, s: tlosses.compute_loss(  # noqa: E731
            p, targs, g, b, amortization_ratio=1, compute_dtype=torch.float32)
        return tstep._accumulated_grads(loss_fn, params, torch.Generator().manual_seed(0),
                                        batch, n_micro, None)

    (m1, g1), (m2, g2) = run(1), run(2)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5)
    for key in m1:
        torch.testing.assert_close(m2[key].float(), m1[key].float(), atol=0, rtol=1e-5)


def test_train_step_reports_raw_norm_and_updates_in_place(tiny):
    """One step: grad_norm equals JAX's global norm of the raw gradients
    (before clipping), and the step writes into the same tensors."""
    jargs, targs, jparams = tiny
    batch = make_batch(targs)
    _, _, want_g = jax_loss_and_grads(jargs, jparams, batch, ratio=1)
    params = params_from_jax(jparams)
    wq = params["decoder"]["wq"]
    before = wq.detach().clone()
    tx = topt.make_optimizer(params, learning_rate=1e-3)
    step = tstep.make_train_step(targs, tx, amortization_ratio=1, compute_dtype=torch.float32)
    state, metrics = step(topt.init_train_state(params, tx), torch.Generator().manual_seed(0),
                          tlosses.Batch(*map(torch.from_numpy, batch)))
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(optax.global_norm(want_g)),
                               rtol=LOSS_TOL)
    assert state.step == 1 and state.params["decoder"]["wq"] is wq
    assert not torch.equal(wq.detach(), before)
    ev = tstep.make_eval_step(targs, amortization_ratio=1, compute_dtype=torch.float32)
    assert torch.isfinite(ev(state.params, None, tlosses.Batch(*map(torch.from_numpy, batch)))["loss"])
