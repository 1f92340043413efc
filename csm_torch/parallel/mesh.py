"""Meshes of ranks for CSM training.

The counterpart of the JAX package's ``parallel/mesh.py``.  The JAX package
runs one program over a ``jax.sharding.Mesh`` of devices and lets GSPMD
insert the collectives; here every rank is a process of its own and a mesh
is a small record of named axes with one process group per axis line:

    data  — batch rows (gradients summed over it);
    model — Megatron tensor parallelism (heads, FFN intermediate);
    pipe  — pipeline stages (layer blocks of the backbone);
    seq   — ring-attention sequence parallelism (positions).

Ranks are laid out row-major over the axes in their order, data outermost,
as the JAX meshes reshape ``jax.devices()``: rank = ((d · P + p) · M + m)
for a (data, pipe, model) mesh.  The device and backend rule lives in
``distributed.rank_device`` / ``distributed.backend_for``.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, Optional, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Trainer-level parallelism selection (training/trainer.py).

    ``model_parallel``/``fsdp`` build a (data, model) mesh (Megatron TP +
    optional ZeRO-3 layout, parallel/sharding.py); ``pipeline_parallel``
    builds a (data, pipe) mesh instead (parallel/pipeline.py);
    ``seq_parallel`` builds a (data, seq) mesh for long-context
    ring-attention training (parallel/ring_attention.py; the batch's time
    dim shards over ``seq``, so it must be a multiple of the axis size).
    The three mesh layouts are mutually exclusive.  The remaining ranks
    always form the data axis.
    """

    model_parallel: int = 1
    fsdp: bool = False
    pipeline_parallel: int = 1
    pp_microbatches: int = 1
    seq_parallel: int = 1
    # ring-attention sequence layout for seq_parallel>1: "auto" uses the
    # balanced zigzag whenever T divides by 2*seq_parallel (contiguous
    # gives the last rank ~2x the causal work), else contiguous; results
    # are identical either way (parallel/ring_attention.py)
    ring_layout: str = "auto"

    @property
    def enabled(self) -> bool:
        return (
            self.model_parallel > 1
            or self.fsdp
            or self.pipeline_parallel > 1
            or self.seq_parallel > 1
        )

    def build_mesh(self, world_size: Optional[int] = None, rank: Optional[int] = None) -> "Mesh":
        """The mesh over ``world_size`` ranks (default: the process group's)
        with this process at ``rank``; builds the axis groups when a
        process group is up."""
        exclusive = (
            (self.pipeline_parallel > 1)
            + (self.seq_parallel > 1)
            + (self.model_parallel > 1 or self.fsdp)
        )
        if exclusive > 1:
            raise ValueError(
                "pipeline_parallel, seq_parallel, and model_parallel/fsdp "
                "are mutually exclusive mesh layouts"
            )
        if self.pipeline_parallel > 1:
            from csm_torch.parallel.pipeline import make_pp_mesh

            return make_pp_mesh(world_size, rank, pipeline_parallel=self.pipeline_parallel)
        if self.seq_parallel > 1:
            from csm_torch.parallel.ring_attention import make_sp_mesh

            return make_sp_mesh(world_size, rank, seq_parallel=self.seq_parallel)
        return make_mesh(world_size, rank, model_parallel=self.model_parallel, fsdp=self.fsdp)


@dataclasses.dataclass
class Mesh:
    """Named axes over ranks: ``shape`` {axis: size} in layout order,
    ``coords`` {axis: this rank's index}, ``groups`` {axis: the process
    group of this rank's line along the axis (None for one rank or no
    process group)}, ``members`` {axis: the global ranks of that line, in
    axis order}; ``fsdp`` marks the ZeRO-3 layout of a (data, model)
    mesh."""

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    groups: Dict[str, object]
    members: Dict[str, Tuple[int, ...]]
    fsdp: bool = False

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def _world(world_size, rank):
    if world_size is None or rank is None:
        import torch.distributed as dist

        on = dist.is_available() and dist.is_initialized()
        world_size = (dist.get_world_size() if on else 1) if world_size is None else world_size
        rank = (dist.get_rank() if on else 0) if rank is None else rank
    return world_size, rank


def build(shape: Dict[str, int], world_size=None, rank=None, fsdp: bool = False) -> Mesh:
    """A mesh of ``shape`` (axis sizes in layout order, one of them may be
    -1: the rest of the ranks) over the world; with a process group up,
    every rank creates every axis line's group, in one order."""
    world_size, rank = _world(world_size, rank)
    names = list(shape)
    sizes = [shape[a] for a in names]
    if -1 in sizes:
        rest = math.prod(s for s in sizes if s != -1)
        sizes[sizes.index(-1)] = world_size // rest
    if math.prod(sizes) != world_size:
        raise ValueError(f"mesh {dict(zip(names, sizes))} does not cover {world_size} ranks")
    strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
    coords = {a: (rank // st) % sz for a, st, sz in zip(names, strides, sizes)}
    import torch.distributed as dist

    group_up = world_size > 1 and dist.is_available() and dist.is_initialized()
    groups, members = {}, {}
    for i, axis in enumerate(names):
        others = [range(sizes[j]) for j in range(len(names)) if j != i]
        mine = None
        for fixed in itertools.product(*others):
            line = []
            for k in range(sizes[i]):
                c = list(fixed)
                c.insert(i, k)
                line.append(sum(ci * st for ci, st in zip(c, strides)))
            g = dist.new_group(line) if group_up and sizes[i] > 1 else None
            if rank in line:
                mine, members[axis] = g, tuple(line)
        groups[axis] = mine
    return Mesh(dict(zip(names, sizes)), rank, coords, groups, members, fsdp)


def mesh_kwargs(par: ParallelConfig, mesh: Mesh) -> dict:
    """The loss's and the steps' mesh arguments for a layout
    (training/losses.compute_loss)."""
    if par.pipeline_parallel > 1:
        return dict(pp_mesh=mesh, pp_microbatches=par.pp_microbatches)
    if par.seq_parallel > 1:
        return dict(seq_mesh=mesh, ring_layout=par.ring_layout)
    return dict(mesh=mesh)


def make_mesh(world_size=None, rank=None, model_parallel: int = 1, fsdp: bool = False) -> Mesh:
    """A (data, model) mesh: ``model_parallel`` divides the world; the rest
    is the data axis."""
    world_size, rank = _world(world_size, rank)
    if world_size % model_parallel != 0:
        raise ValueError(f"{world_size} devices not divisible by model_parallel={model_parallel}")
    return build({DATA_AXIS: -1, MODEL_AXIS: model_parallel}, world_size, rank, fsdp=fsdp)
