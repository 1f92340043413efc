"""Optimizer and train state for CSM training.

The counterpart of the JAX package's ``training/optimizer.py``: AdamW
(weight decay 0.01) per component, with learning-rate multipliers backbone
×0.1, decoder ×1.0, embeddings ×0.5, other ×1.0 and freeze flags per
component; global-norm clipping of the raw gradients; gradient accumulation
with ``optax.MultiSteps`` semantics.  The arithmetic follows optax's, so
the tests hold the two to float32 rounding:

  * clipping: ``g`` stays when ``norm < max_norm``, else ``g / norm ·
    max_norm`` (optax's ``clip_by_global_norm``, not ``clip_grad_norm_``'s
    ``+1e-6``);
  * Adam: ``mu = b1·mu + (1−b1)·g``, ``nu = b2·nu + (1−b2)·g²``,
    ``u = (mu/bc1) / (sqrt(nu/bc2) + eps)`` (eps outside the root,
    bias-corrected);
  * decoupled decay and the step: ``p −= lr · (u + wd · p)``;
  * a frozen component gets no update, no decay and no moments;
  * accumulation: a running mean ``acc += (g − acc) / (i + 1)`` over k
    calls, and the inner update on every k-th call;
  * moments stored in ``mu_dtype`` / ``nu_dtype`` (default: the param's
    dtype) with the math in float32, and the update computed from the
    moments as stored (the JAX package's ``scale_by_adam_dtypes``).

``make_lora_optimizer`` is the same update over an adapter tree: one group,
Adam, or AdamW when ``weight_decay`` is set (optax's ``adam`` / ``adamw``
behind the clip).

Parameters and moments are updated in place with in-place tensor ops (no
float32 copies of float32 leaves), and the update never reads a device
value on the host (the clip factor stays a device tensor), so a step does
not wait for the card.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch



class TrainState(NamedTuple):
    params: Any  # the parameter tree, updated in place
    opt_state: Any  # dict, see Optimizer.init
    step: int  # optimizer-step counter (calls of the train step)


# Reference multipliers (src/csm/training/trainer.py:123-173).
DEFAULT_LR_MULTIPLIERS = {
    "backbone": 0.1,
    "decoder": 1.0,
    "embeddings": 0.5,
    "other": 1.0,
}


def component_of(top_level_name: str) -> str:
    """Map a top-level param-tree key to its LR-group component."""
    if top_level_name == "backbone":
        return "backbone"
    if top_level_name == "decoder":
        return "decoder"
    if top_level_name in ("text_embeddings", "audio_embeddings"):
        return "embeddings"
    return "other"  # projection, codebook0_head, audio_head


def component_labels(
    params: Any,
    freeze_backbone: bool = False,
    freeze_decoder: bool = False,
    freeze_embeddings: bool = False,
) -> dict:
    """{top-level key: component name or 'frozen'} for ``params``."""
    frozen = {
        name for name, on in (("backbone", freeze_backbone), ("decoder", freeze_decoder),
                              ("embeddings", freeze_embeddings)) if on
    }
    labels = {}
    for key in params:
        comp = component_of(key)
        labels[key] = "frozen" if comp in frozen else comp
    return labels


def named_leaves(tree, prefix: str = ""):
    """[(path, tensor), ...] of a nested dict of tensors, in key order."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += named_leaves(v, f"{prefix}{k}/")
        return out
    return [(prefix[:-1], tree)]


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ x²) over every element of ``tensors``, float32 (optax's
    ``global_norm``), without a squared copy of each tensor."""
    norms = [torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


class Optimizer:
    """Per-component AdamW over a parameter tree (see the module note)."""

    eps = 1e-8  # outside the square root, as optax's

    def __init__(self, params, learning_rate, weight_decay, max_grad_norm, lr_multipliers,
                 labels, accumulation_steps, b1, b2, mu_dtype=None, nu_dtype=None):
        self.learning_rate = learning_rate
        self.lr_multipliers, self.labels = lr_multipliers, labels
        self.max_grad_norm = max_grad_norm
        self.weight_decay = weight_decay
        self.accumulation_steps = accumulation_steps
        self.b1, self.b2 = b1, b2
        self.mu_dtype, self.nu_dtype = mu_dtype, nu_dtype
        # the clip's norm of a call's gradients; over a mesh, the global
        # norm from this rank's slices (parallel/sharding.sharded_global_norm)
        self.norm_fn = global_norm
        if params is not None:
            self._bind(params)

    def _bind(self, params) -> None:
        """The leaves' paths and learning rates (None for a frozen leaf);
        ``labels`` None puts every leaf in one group of multiplier 1."""
        self.paths = [path for path, _ in named_leaves(params)]
        labels = self.labels or dict.fromkeys(params, "all")
        mults = self.lr_multipliers or {"all": 1.0}
        self.lrs = [None if labels[path.split("/")[0]] == "frozen"
                    else self.learning_rate * mults[labels[path.split("/")[0]]]
                    for path in self.paths]

    def init(self, params) -> dict:
        """Zero moments for every trained leaf, in ``mu_dtype`` / ``nu_dtype``
        (default its dtype) and on its device; the Adam count; the
        accumulator when k > 1."""
        if self.labels is None:
            self._bind(params)
        leaves = [t for _, t in named_leaves(params)]

        def zeros(dtype):
            return {p: torch.zeros_like(t, dtype=dtype or t.dtype)
                    for p, t, lr in zip(self.paths, leaves, self.lrs) if lr is not None}

        state = {"count": 0, "mu": zeros(self.mu_dtype), "nu": zeros(self.nu_dtype)}
        if self.accumulation_steps > 1:
            state["mini_step"] = 0
            state["acc"] = {p: torch.zeros_like(t) for p, t in zip(self.paths, leaves)}
        return state

    @torch.no_grad()
    def update(self, params, grads, state: dict) -> bool:
        """Apply one call's gradients (a list in ``named_leaves`` order) to
        ``params`` and ``state`` in place; the gradients are consumed (the
        clip scales them in place).  Returns whether the parameters moved
        (False on the first k−1 calls of an accumulation window)."""
        if self.accumulation_steps > 1:
            i = state["mini_step"]
            for path, g in zip(self.paths, grads):
                acc = state["acc"][path]
                acc.add_((g - acc) / (i + 1))
            if i + 1 < self.accumulation_steps:
                state["mini_step"] = i + 1
                return False
            state["mini_step"] = 0
            grads = [state["acc"][p] for p in self.paths]

        leaves = [t for _, t in named_leaves(params)]
        if self.max_grad_norm is not None:
            # optax: g stays below the limit, else g / norm · max_norm
            norm = self.norm_fn(grads)
            keep = norm < self.max_grad_norm
            div = torch.where(keep, torch.ones_like(norm), norm)
            mul = torch.where(keep, torch.ones_like(norm), torch.full_like(norm, self.max_grad_norm))
        state["count"] += 1
        count = torch.tensor(float(state["count"]), dtype=torch.float32)
        bc1 = (1.0 - self.b1 ** count).item()
        bc2 = (1.0 - self.b2 ** count).item()
        for path, p, g, lr in zip(self.paths, leaves, grads, self.lrs):
            if lr is None:
                continue
            # float32 math; for float32 leaves these are the tensors themselves
            gf, pf = g.float(), p.float()
            mu, nu = state["mu"][path], state["nu"][path]
            mu_f, nu_f = mu.float(), nu.float()
            if self.max_grad_norm is not None:
                gf.div_(div).mul_(mul)
            mu_f.mul_(self.b1).add_(gf, alpha=1.0 - self.b1)
            nu_f.mul_(self.b2).addcmul_(gf, gf, value=1.0 - self.b2)
            for stored, f in ((mu, mu_f), (nu, nu_f)):
                if stored is not f:  # the update reads the moments as stored
                    stored.copy_(f)
                    f.copy_(stored)
            u = mu_f.div(bc1).div_(nu_f.div(bc2).sqrt_().add_(self.eps))
            if self.weight_decay:
                u.add_(pf, alpha=self.weight_decay)
            pf.add_(u, alpha=-lr)
            if p is not pf:
                p.copy_(pf)
        if self.accumulation_steps > 1:
            for acc in state["acc"].values():
                acc.zero_()
        return True


def make_optimizer(
    params: Any,
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    max_grad_norm: Optional[float] = 1.0,
    lr_multipliers: Optional[dict] = None,
    freeze_backbone: bool = False,
    freeze_decoder: bool = False,
    freeze_embeddings: bool = False,
    accumulation_steps: int = 1,
    b1: float = 0.9,
    b2: float = 0.999,
    mu_dtype=None,
    nu_dtype=None,
) -> Optimizer:
    """The CSM training optimizer: AdamW per component with global-norm
    clipping of the raw gradients and ``accumulation_steps``-call
    accumulation.  ``mu_dtype`` / ``nu_dtype``: the moments' storage dtypes
    (None: each parameter's; the math runs in float32 either way)."""
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
    mults = dict(DEFAULT_LR_MULTIPLIERS)
    if lr_multipliers:
        mults.update(lr_multipliers)
    labels = component_labels(params, freeze_backbone, freeze_decoder, freeze_embeddings)
    return Optimizer(params, learning_rate, weight_decay, max_grad_norm, mults, labels,
                     accumulation_steps, b1, b2, mu_dtype, nu_dtype)


def make_lora_optimizer(
    learning_rate: float = 1e-4,
    max_grad_norm: Optional[float] = 1.0,
    weight_decay: float = 0.0,
    accumulation_steps: int = 1,
) -> Optimizer:
    """The optimizer over an adapter tree: the global-norm clip, then Adam,
    or AdamW when ``weight_decay`` is set; ``accumulation_steps`` calls to
    an update.  Its leaves are bound at ``init``."""
    if accumulation_steps < 1:
        raise ValueError(f"accumulation_steps must be >= 1, got {accumulation_steps}")
    return Optimizer(None, learning_rate, weight_decay, max_grad_norm, None, None,
                     accumulation_steps, 0.9, 0.999)


def init_train_state(params: Any, tx: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(params), step=0)
