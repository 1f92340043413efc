"""Layouts of the CSM parameter tree and batches over a mesh of ranks.

The counterpart of the JAX package's ``parallel/sharding.py``.  There a
PartitionSpec per leaf tells GSPMD where each dim lives and XLA inserts the
collectives; here the same specs (tuples of axis names, None = whole) are
LAYOUTS of the port's param dict: rank r stores, of each leaf, the slice
that its coordinate on each named axis selects, and the step moves data
itself:

  * tensor parallelism (Megatron): ``wq``/``wk``/``wv``/``w1``/``w3`` split
    their output columns over ``model`` and ``wo``/``w2`` their input rows,
    so a rank runs its 1/tp of the heads and of the FFN, and one all-reduce
    follows each block (``TransformerShard.exit``); a transformer whose head or
    FFN counts the axis does not divide stays whole on every model rank
    (the JAX package splits such dims inside a head, which a rank's own
    attention cannot);
  * FSDP (ZeRO-3): the same stacks split their embed dim over ``data``; a
    layer's slices are all-gathered (one flat message a layer) just before
    it runs, again in the remat recompute, and its gradients are
    reduce-scattered by that gather's backward; the AdamW moments are kept
    in the same slices;
  * every other leaf split over an axis (embeddings and heads over
    ``model``/``data``, the decoder's layers over ``pipe``) is gathered
    whole before the step and its whole gradient is reduced back to the
    slice after it (``MeshView.local_grads``): summed over data or pipe,
    whose ranks hold partial gradients, and sliced over model, whose ranks
    compute the same one;
  * data parallelism: a leaf not split over ``data`` (or ``seq``, ``pipe``)
    has its gradient summed over that axis.  Each rank's loss is its share
    of the global loss (training/losses.py), so the sum is the global
    gradient, as GSPMD computes it.

``fit_spec`` replicates a dim that a mesh axis does not divide (the 2051
audio vocab).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from csm_torch.parallel import distributed as D
from csm_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, SEQ_AXIS, Mesh

Spec = Tuple  # one entry per dim: an axis name, a tuple of names, or None

_STACKED = ("wq", "wk", "wv", "wo", "w1", "w2", "w3", "sa_norm", "mlp_norm")
LOSS_AXES = (DATA_AXIS, SEQ_AXIS, PIPE_AXIS)  # axes whose ranks hold partial losses


def _transformer_specs(fsdp: bool) -> dict:
    # Layer-stacked arrays: leading axis = layer.  FSDP shards the embed/in
    # dim over data; model axis shards heads / intermediate / output dims.
    d = DATA_AXIS if fsdp else None
    return {
        "wq": (None, d, MODEL_AXIS),
        "wk": (None, d, MODEL_AXIS),
        "wv": (None, d, MODEL_AXIS),
        "wo": (None, MODEL_AXIS, d),
        "w1": (None, d, MODEL_AXIS),
        "w3": (None, d, MODEL_AXIS),
        "w2": (None, MODEL_AXIS, d),
        "sa_norm": (None, None),
        "mlp_norm": (None, None),
        "norm": (None,),
    }


def csm_param_specs(fsdp: bool = False) -> dict:
    """The layout tree of ``random_csm_params`` output on a (data, model)
    mesh."""
    d = DATA_AXIS if fsdp else None
    return {
        "backbone": _transformer_specs(fsdp),
        "decoder": _transformer_specs(fsdp),
        "text_embeddings": (MODEL_AXIS, d),
        "audio_embeddings": (MODEL_AXIS, d),
        "projection": (d, MODEL_AXIS),
        "codebook0_head": (d, MODEL_AXIS),
        "audio_head": (None, d, MODEL_AXIS),
    }


def batch_specs() -> dict:
    """Batch rows over ``data``."""
    return {
        "tokens": (DATA_AXIS, None, None),
        "tokens_mask": (DATA_AXIS, None, None),
        "targets": (DATA_AXIS, None, None),
        "target_mask": (DATA_AXIS, None),
    }


def fit_spec(shape, spec: Spec, mesh) -> Spec:
    """Drop mesh axes from dims they don't evenly divide (that dim is
    replicated instead; the rest of the spec is kept).  The audio vocab is
    2051, indivisible by any mesh axis, so ``codebook0_head`` /
    ``audio_head`` vocab dims fall back to replication while every other
    dim stays sharded.  ``mesh`` needs only ``.shape`` {axis: size}."""
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        div = math.prod(mesh.shape.get(a, 1) for a in axes)
        out.append(axis if shape[i] % div == 0 else None)
    return tuple(out)


def _axes(spec: Spec) -> List[str]:
    out = []
    for a in spec:
        if a is not None:
            out += list(a) if isinstance(a, tuple) else [a]
    return out


def tp_splits(cfg, tp: int) -> bool:
    """Whether a transformer's heads, kv heads and FFN all divide by tp."""
    return (cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
            and cfg.intermediate_dim % tp == 0)


def param_layouts(params: dict, args, mesh: Mesh) -> dict:
    """The layout of every leaf of ``params`` (a CSM tree of full shapes)
    on ``mesh``: the (data, model) specs, the (data, pipe[, model]) specs
    of parallel/pipeline.py, or whole leaves on a (data, seq) mesh; model
    splits of a transformer whose heads or FFN the axis does not divide
    dropped; then ``fit_spec``."""
    from csm_torch.parallel.pipeline import pp_param_specs

    if PIPE_AXIS in mesh.shape:
        specs = pp_param_specs(tp=mesh.axis_size(MODEL_AXIS) > 1)
    elif SEQ_AXIS in mesh.shape:
        specs = None
    else:
        specs = csm_param_specs(mesh.fsdp)
    tp = mesh.axis_size(MODEL_AXIS)
    out = {}
    for key, leaf in params.items():
        if isinstance(leaf, dict):
            cfg = args.backbone if key == "backbone" else args.decoder
            keep_model = tp > 1 and tp_splits(cfg, tp)
            sub = {}
            for name, t in leaf.items():
                if isinstance(t, dict):  # a quantized projection: whole on every rank
                    sub[name] = {f: (None,) * v.dim() for f, v in t.items()}
                    continue
                s = (None,) * t.dim() if specs is None else specs[key][name]
                if not keep_model:
                    s = tuple(None if a == MODEL_AXIS else a for a in s)
                sub[name] = fit_spec(t.shape, s, mesh)
            out[key] = sub
        else:
            s = (None,) * leaf.dim() if specs is None else specs[key]
            out[key] = fit_spec(leaf.shape, s, mesh)
    return out


def _slice(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    for d, axis in enumerate(spec):
        if axis is None:
            continue
        axes = axis if isinstance(axis, tuple) else (axis,)
        n, idx = 1, 0
        for a in axes:  # row-major over a tuple of axes
            idx, n = idx * mesh.axis_size(a) + mesh.index(a), n * mesh.axis_size(a)
        if n > 1:
            x = x.chunk(n, dim=d)[idx]
    return x


def shard_tree(tree: dict, layouts: dict, mesh: Mesh) -> dict:
    """This rank's slices of a full tree (contiguous copies; a whole leaf
    is kept as it is)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = shard_tree(v, layouts[k], mesh)
        else:
            part = _slice(v, layouts[k], mesh)
            out[k] = v if part is v else part.contiguous().clone()
    return out


def shard_params(params: dict, mesh: Mesh, args, fsdp: Optional[bool] = None) -> dict:
    """This rank's slices of a full parameter tree (``fsdp`` overrides the
    mesh's)."""
    if fsdp is not None and fsdp != mesh.fsdp:
        import dataclasses

        mesh = dataclasses.replace(mesh, fsdp=fsdp)
    return shard_tree(params, param_layouts(params, args, mesh), mesh)


def _gather_whole(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """A leaf's slices put back together (no gradient)."""
    for d in reversed(range(len(spec))):
        axis = spec[d]
        if axis is None:
            continue
        for a in reversed(axis if isinstance(axis, tuple) else (axis,)):
            x = D._all_gather(x, mesh.groups[a], d) if mesh.axis_size(a) > 1 else x
    return x


def unshard_tree(tree: dict, layouts: dict, mesh: Mesh) -> dict:
    """The full tree from every rank's slices (an all-gather per sharded
    leaf; every rank gets the whole)."""
    with torch.no_grad():
        return {k: unshard_tree(v, layouts[k], mesh) if isinstance(v, dict)
                else _gather_whole(v, layouts[k], mesh) for k, v in tree.items()}


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global batch (over ``data``)."""
    from csm_torch.training.losses import Batch

    dp = mesh.axis_size(DATA_AXIS)
    if batch.tokens.shape[0] % dp:
        raise ValueError(f"batch size {batch.tokens.shape[0]} not divisible by the data axis "
                         f"({dp}); pick batch_size as a multiple")
    return Batch(*(t.chunk(dp, 0)[mesh.index(DATA_AXIS)] for t in batch))


def flat_layouts(params: dict, layouts: dict) -> List[Tuple[str, Spec]]:
    """[(path, layout)] in ``named_leaves`` order."""
    from csm_torch.training.optimizer import named_leaves

    flat = dict(named_leaves(layouts))
    return [(p, flat[p]) for p, _ in named_leaves(params)]


class TransformerShard:
    """A transformer's part of the mesh, the hook of each of its layers
    (``models/llama._layer_forward``): ``tp`` (heads and FFN split over
    ``model``, or 1), the FSDP gather of a layer's weight slices and
    Megatron's f / g over ``model``."""

    def __init__(self, mesh: Mesh, layouts: dict):
        self.mesh = mesh
        split = any(MODEL_AXIS in _axes(layouts[n]) for n in ("wq", "w1") if n in layouts)
        self.tp = mesh.axis_size(MODEL_AXIS) if split else 1
        self.model_group = mesh.groups.get(MODEL_AXIS) if self.tp > 1 else None
        # FSDP slices: {stack name: the data-split dim of a layer's leaf}
        self.fsdp_dims = {n: s.index(DATA_AXIS) - 1 for n, s in layouts.items()
                          if n in _STACKED and DATA_AXIS in s and s.index(DATA_AXIS) > 0
                          and mesh.axis_size(DATA_AXIS) > 1}

    def weights(self, lp: dict) -> dict:
        """A layer's weights with their ``data`` slices gathered: one flat
        all-gather (its backward: one reduce-scatter)."""
        if not self.fsdp_dims:
            return lp
        names = [n for n in self.fsdp_dims if n in lp]
        flat = torch.cat([lp[n].reshape(-1) for n in names])
        dp = self.mesh.axis_size(DATA_AXIS)
        parts = D.all_gather(flat, self.mesh.groups[DATA_AXIS], 0).view(dp, -1)
        out, off = dict(lp), 0
        for n in names:
            shape, d = lp[n].shape, self.fsdp_dims[n]
            seg = parts[:, off:off + lp[n].numel()].reshape(dp, *shape)
            out[n] = torch.cat(seg.unbind(0), dim=d)
            off += lp[n].numel()
        return out

    def adapter(self, name: str, a, b, keep=None):
        """A whole LoRA adapter of ``name`` as this rank applies it beside
        its slice of the weight: under TP the rank's output columns of
        ``b`` (wq, wk, wv, w1, w3), or its input rows of ``a`` and of the
        input-dropout mask ``keep`` (wo, w2: ``(x_r a_r) b`` is summed by
        the layer's g); both factors pass through f, so every rank's
        gradient of them is the sum over model."""
        if self.tp == 1:
            return a, b, keep
        a, b = self.enter(a), self.enter(b)
        i = self.mesh.index(MODEL_AXIS)
        if name in ("wo", "w2"):
            cut = lambda t: t.chunk(self.tp, dim=-1)[i]  # noqa: E731
            return a.chunk(self.tp, dim=-2)[i], b, None if keep is None else cut(keep)
        return a, b.chunk(self.tp, dim=-1)[i], keep

    def enter(self, x):
        return D.copy_to_group(x, self.model_group)

    def exit(self, y):
        return D.reduce_from_group(y, self.model_group)


class MeshView:
    """A step's view of this rank's parameter slices.

    ``params`` is the tree the loss computes with: transformer stacks as
    stored (this rank's model, pipe-stage and FSDP slices, which the layer
    hooks ``backbone`` / ``decoder`` handle), every other split leaf
    gathered whole into a new tensor that requires a gradient.  ``leaves``
    are the tensors to differentiate, in ``named_leaves`` order;
    ``local_grads`` turns their gradients into the stored slices'
    gradients of the global loss."""

    def __init__(self, local: dict, layouts: dict, mesh: Mesh, pipelined: bool = False,
                 grad: bool = True):
        from csm_torch.training.optimizer import named_leaves

        self.mesh = mesh
        flat = flat_layouts(local, layouts)
        self.paths = [p for p, _ in flat]
        self.specs = [s for _, s in flat]
        self.gathered: List[Tuple[int, ...]] = []  # per leaf: dims gathered before the step
        leaves = []
        tree: Dict = {}
        for (path, t), spec in zip(named_leaves(local), self.specs):
            top, _, rest = path.partition("/")
            kept = set()
            if rest.split("/")[0] in _STACKED:  # a layer stack (or its adapters)
                # handled in the layer: model and FSDP dims
                kept = {d for d, a in enumerate(spec) if a in (MODEL_AXIS, DATA_AXIS) and d > 0}
                if top == "backbone" and pipelined:
                    kept.add(0)  # this stage's block of layers
            dims = tuple(d for d, a in enumerate(spec) if a is not None and d not in kept)
            self.gathered.append(dims)
            if dims:
                with torch.no_grad():
                    full = t
                    for d in reversed(dims):
                        full = _gather_whole(full, tuple(spec[i] if i == d else None
                                                         for i in range(len(spec))), mesh)
                leaf = full.detach().requires_grad_(grad)
            else:
                leaf = t
                if grad and not leaf.requires_grad:
                    leaf.requires_grad_(True)
            leaves.append(leaf)
            node = tree
            parts = path.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
        self.params, self.leaves = tree, leaves
        self.backbone = self.decoder = None
        if isinstance(layouts.get("backbone", {}).get("wq"), tuple):  # a CSM tree
            self.backbone = TransformerShard(mesh, layouts["backbone"])
            self.decoder = TransformerShard(mesh, layouts["decoder"])

    def local_grads(self, grads: List[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        """The stored slices' gradients of the global loss from the
        gradients of ``leaves`` (None: zeros): a leaf gathered whole gets
        its own slice back, summed over data / pipe / seq and taken as it
        is over model; then every leaf is summed over the loss axes it is
        not split over (one all-reduce per group of leaves)."""
        out = []
        for g, leaf, spec, dims, path in zip(grads, self.leaves, self.specs, self.gathered,
                                             self.paths):
            if g is None:
                g = torch.zeros_like(leaf)
            for d in dims:
                axis = spec[d]
                for a in (axis if isinstance(axis, tuple) else (axis,)):
                    if self.mesh.axis_size(a) == 1:
                        continue
                    group = self.mesh.groups[a]
                    if a == MODEL_AXIS:
                        g = g.chunk(self.mesh.axis_size(a), dim=d)[self.mesh.index(a)]
                    else:
                        g = D._reduce_scatter(g, group, d)
            out.append(g.contiguous())
        return reduce_over_loss_axes(out, self.specs, self.mesh)


def reduce_over_loss_axes(grads: List[torch.Tensor], specs: List[Spec], mesh: Mesh):
    """Sum each gradient over every loss axis (data, seq, pipe) its leaf is
    not split over: flattened into one buffer per (axes, dtype) group."""
    buckets: Dict[Tuple, List[int]] = {}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        axes = tuple(a for a in LOSS_AXES if mesh.axis_size(a) > 1 and a not in _axes(spec))
        if axes:
            buckets.setdefault((axes, str(g.dtype)), []).append(i)
    for (axes, _), idx in sorted(buckets.items()):
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        for a in axes:
            D.all_reduce_(flat, mesh.groups[a])
        off = 0
        for i in idx:
            n = grads[i].numel()
            grads[i] = flat[off:off + n].view_as(grads[i])
            off += n
    return grads


def sharded_global_norm(grads: List[torch.Tensor], specs: List[Spec], mesh: Mesh):
    """sqrt(Σ x²) over the global gradient from this rank's slices: each
    leaf's sum of squares divided by the number of ranks holding the same
    slice, then one all-reduce over every rank."""
    import torch.distributed as dist

    total = None
    for g, spec in zip(grads, specs):
        reps = mesh.size // math.prod(mesh.axis_size(a) for a in _axes(spec))
        sq = torch.linalg.vector_norm(g, dtype=torch.float32).square() / reps
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float32)
    total = total.reshape(1).clone()
    if mesh.size > 1:
        D.all_reduce_(total, dist.group.WORLD)
    return total[0].sqrt()
