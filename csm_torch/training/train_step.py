"""Train and eval steps for CSM.

The counterpart of the JAX package's ``training/train_step.py``: one
optimizer step is the loss (semantic + amortized acoustic), its backward,
the raw gradients' global norm, the clip and the per-component AdamW
update.  PyTorch runs eagerly, so a step is a Python function instead of
one compiled program; on the card the backbone's attention runs through
the flash kernels in both passes.

``make_lora_train_step`` differentiates only an adapter tree: the frozen
base is passed along with ``requires_grad`` off and gets neither a
gradient nor optimizer state.

Parameters update IN PLACE (``torch.no_grad`` writes into the same
tensors): this replaces the JAX package's buffer donation, so a caller that
needs the old values copies them first.  Metrics come back as device
tensors; nothing here reads them on the host.

Over a mesh (``mesh`` / ``seq_mesh`` / ``pp_mesh`` with the ``layouts``
of the state's slices, parallel/sharding.py) each step takes a
``MeshView`` of this rank's slices, differentiates this rank's share of
the global loss, turns the gradients into its slices' gradients of the
global loss (``MeshView.local_grads``) and clips by the global norm
(``sharded_global_norm``); the optimizer then updates the slices and their
moments in place.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from csm_torch.models.config import ModelArgs
from csm_torch.training.losses import Batch, compute_loss
from csm_torch.training.optimizer import Optimizer, TrainState, global_norm, named_leaves


def _leaves(params):
    leaves = [t for _, t in named_leaves(params)]
    for t in leaves:
        if not t.requires_grad:
            t.requires_grad_(True)
    return leaves


def _accumulated_grads(loss_fn, params, generator, batch: Batch, n_micro: int, frame_scores,
                       view_fn=None):
    """(metrics, grads) over the whole batch, or the mean of the gradients of
    ``n_micro`` equal slices of it (count metrics ``num_*`` sum, the rest
    average): the JAX package's in-step microbatching.  ``view_fn(params)``
    — a mesh's ``MeshView`` of the slices, made anew for each slice of the
    batch (its gathered leaves are copies)."""
    leaves = _leaves(params) if view_fn is None else None
    B = batch.tokens.shape[0]
    if B % n_micro:
        raise ValueError(f"batch dim {B} not divisible by {n_micro} microbatches")
    m = B // n_micro
    grads, metrics = None, None
    for i in range(n_micro):
        part = Batch(*(t[i * m : (i + 1) * m] for t in batch))
        scores = None if frame_scores is None else frame_scores[i]
        if view_fn is None:
            loss, mt = loss_fn(params, generator, part, scores)
            g = torch.autograd.grad(loss, leaves)
        else:
            view = view_fn(params)
            loss, mt = loss_fn(view, generator, part, scores)
            g = view.local_grads(torch.autograd.grad(loss, view.leaves, allow_unused=True))
        if grads is None:
            grads, metrics = list(g), {k: v.detach() for k, v in mt.items()}
        else:
            for acc, gi in zip(grads, g):
                acc.add_(gi)
            metrics = {k: metrics[k] + mt[k].detach() for k in metrics}
    if n_micro > 1:
        grads = [g / n_micro for g in grads]
        metrics = {k: v if k.startswith("num_") else v / n_micro for k, v in metrics.items()}
    return metrics, grads


def make_train_step(
    args: ModelArgs,
    tx: Optimizer,
    semantic_weight: float = 100.0,
    acoustic_weight: float = 1.0,
    amortization_ratio: int = 16,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    seq_mesh=None,
    pp_mesh=None,
    grad_microbatches: int = 1,
    pp_microbatches: int = 1,
    ring_layout: str = "auto",
    mesh=None,
    layouts=None,
) -> Callable:
    """Returns ``step(state, generator, batch, frame_scores=None) ->
    (state, metrics)``.

    ``generator`` draws the amortized frame subset; ``frame_scores``
    replaces the draw (a list of ``grad_microbatches`` (B/M·T,) tensors, or
    one (B·T,) tensor when M = 1).  ``grad_microbatches`` — split the batch
    into M slices and average their gradients (the semantics of
    ``optax.MultiSteps``, within one step; must divide the batch).
    ``metrics["grad_norm"]`` is the raw global norm, before clipping.
    Over a mesh, ``state.params`` are this rank's slices in ``layouts``,
    ``batch`` and ``frame_scores`` are global."""
    mesh_kw = dict(seq_mesh=seq_mesh, pp_mesh=pp_mesh, mesh=mesh,
                   pp_microbatches=pp_microbatches, ring_layout=ring_layout)
    view_fn, norm = _mesh_hooks(tx, mesh_kw, layouts)

    def loss_fn(params, generator, batch, frame_scores):
        return compute_loss(
            params, args, generator, batch, semantic_weight=semantic_weight,
            acoustic_weight=acoustic_weight, amortization_ratio=amortization_ratio,
            compute_dtype=compute_dtype, remat=remat, frame_scores=frame_scores, **mesh_kw,
        )

    def step(state: TrainState, generator: Optional[torch.Generator], batch: Batch,
             frame_scores=None):
        if grad_microbatches == 1 and frame_scores is not None:
            frame_scores = [frame_scores]
        metrics, grads = _accumulated_grads(
            loss_fn, state.params, generator, batch, grad_microbatches, frame_scores, view_fn
        )
        metrics["grad_norm"] = norm(grads)
        tx.update(state.params, grads, state.opt_state)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step


def make_lora_train_step(
    args: ModelArgs,
    tx: Optimizer,
    lora_scale: float,
    semantic_weight: float = 100.0,
    acoustic_weight: float = 1.0,
    amortization_ratio: int = 16,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    lora_dropout: float = 0.0,
    seq_mesh=None,
    pp_mesh=None,
    pp_microbatches: int = 1,
    ring_layout: str = "auto",
    mesh=None,
    base_layouts=None,
    layouts=None,
) -> Callable:
    """Returns ``step(state, base_params, generator, batch, frame_scores=None)
    -> (state, metrics)``: the loss with the adapters ``state.params`` on
    the frozen ``base_params``, gradients for the adapters only, the
    optimizer (``make_lora_optimizer``) updating them in place.  Over a
    mesh (data, seq or pipe), the adapters and the base are this rank's
    slices in ``layouts`` / ``base_layouts``."""
    mesh_kw = dict(seq_mesh=seq_mesh, pp_mesh=pp_mesh, mesh=mesh,
                   pp_microbatches=pp_microbatches, ring_layout=ring_layout)
    view_fn, norm = _mesh_hooks(tx, mesh_kw, layouts)
    base_view = {}

    def step(state: TrainState, base_params, generator: Optional[torch.Generator], batch: Batch,
             frame_scores=None):
        base = base_params
        if view_fn is not None:  # the frozen base's view, gathered once
            if base_view.get("of") is not base_params:
                base_view.update(of=base_params, view=_base_view(base_params, base_layouts,
                                                                 mesh_kw))
            base = base_view["view"]

        def loss_fn(lora, generator, batch, scores):
            return compute_loss(
                base, args, generator, batch, semantic_weight=semantic_weight,
                acoustic_weight=acoustic_weight, amortization_ratio=amortization_ratio,
                compute_dtype=compute_dtype, remat=remat, lora=lora, lora_scale=lora_scale,
                lora_dropout=lora_dropout, frame_scores=scores, **mesh_kw,
            )

        metrics, grads = _accumulated_grads(
            loss_fn, state.params, generator, batch, 1,
            None if frame_scores is None else [frame_scores], view_fn,
        )
        metrics["grad_norm"] = norm(grads)
        tx.update(state.params, grads, state.opt_state)
        return TrainState(state.params, state.opt_state, state.step + 1), metrics

    return step


def make_eval_step(
    args: ModelArgs,
    semantic_weight: float = 100.0,
    acoustic_weight: float = 1.0,
    amortization_ratio: int = 16,
    compute_dtype=torch.bfloat16,
    seq_mesh=None,
    pp_mesh=None,
    pp_microbatches: int = 1,
    ring_layout: str = "auto",
    mesh=None,
    layouts=None,
) -> Callable:
    """Returns ``eval_step(params, generator, batch) -> metrics`` (device
    tensors, no gradients; global over a mesh, where ``params`` are this
    rank's slices in ``layouts``)."""
    mesh_kw = dict(seq_mesh=seq_mesh, pp_mesh=pp_mesh, mesh=mesh,
                   pp_microbatches=pp_microbatches, ring_layout=ring_layout)

    @torch.no_grad()
    def eval_step(params, generator: Optional[torch.Generator], batch: Batch):
        if layouts is not None:
            params = _base_view(params, layouts, mesh_kw)
        _, metrics = compute_loss(
            params, args, generator, batch, semantic_weight=semantic_weight,
            acoustic_weight=acoustic_weight, amortization_ratio=amortization_ratio,
            compute_dtype=compute_dtype, **mesh_kw,
        )
        return metrics

    return eval_step


def _the_mesh(mesh_kw):
    for k in ("seq_mesh", "pp_mesh", "mesh"):
        if mesh_kw.get(k) is not None:
            return mesh_kw[k]
    return None


def _base_view(params, layouts, mesh_kw):
    """A view of slices that get no gradient (a frozen base, an eval)."""
    from csm_torch.parallel.sharding import MeshView

    return MeshView(params, layouts, _the_mesh(mesh_kw), pipelined=mesh_kw.get("pp_mesh") is not None,
                    grad=False)


def _mesh_hooks(tx: Optimizer, mesh_kw: dict, layouts):
    """(view_fn, norm) of a step: on a mesh, the ``MeshView`` of the slices
    and the global norm from them (also the optimizer's clip norm); else
    (None, ``global_norm``)."""
    m = _the_mesh(mesh_kw)
    if m is None:
        return None, global_norm
    if layouts is None:
        raise ValueError("a step over a mesh needs the layouts of the state's slices")
    from csm_torch.parallel.sharding import MeshView, flat_layouts, sharded_global_norm

    specs = {}

    def view_fn(params):
        if "specs" not in specs:
            specs["specs"] = [s for _, s in flat_layouts(params, layouts)]
        return MeshView(params, layouts, m, pipelined=mesh_kw.get("pp_mesh") is not None)

    def norm(grads):
        return sharded_global_norm(grads, specs["specs"], m)

    tx.norm_fn = norm
    return view_fn, norm
