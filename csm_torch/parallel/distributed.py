"""Process groups, rank devices, batch slices and the collectives that
autograd goes through.

The counterpart of the JAX package's ``parallel/distributed.py``.  The JAX
package runs one process per host and one program over every device; the
port runs one process per rank (``python -m torch.distributed.run``, or
``parallel/launch.py``), each on one device:

  * ``initialize()`` joins the group from the ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` / ``MASTER_ADDR`` variables ``torch.distributed.run``
    sets (or an explicit ``init_method``), and in a single process
    returns (0, 1) and creates no group;
  * the device and backend rule, in one place: a rank takes
    ``cuda:LOCAL_RANK`` and the group is NCCL when the host has a card for
    each local rank; with fewer cards the ranks share them
    (``cuda:LOCAL_RANK % cards``; one H100: every rank on ``cuda:0``) and
    the group is gloo, since NCCL refuses two ranks on one device; ranks
    run on the CPU over gloo only when the caller asks for the CPU (a
    missing card raises, as every entry point of the port does);
  * the collectives pass CUDA tensors to NCCL as they are.  gloo reduces
    and gathers host tensors here: a CUDA tensor goes through host memory
    (copied into a pinned host buffer kept for reuse, reduced or gathered
    there, copied back), which is what the ranks that share one card do;
  * gloo has no reduce-scatter: ``_reduce_scatter`` is an all-reduce and
    this rank's slice of it (twice the traffic; ROADMAP.md §C.2).

The collectives that autograd goes through are ``torch.autograd.Function``s:
``all_gather`` (forward all-gather, backward reduce-scatter: the ranks hold
partial gradients), ``gather_replicated`` (forward all-gather, backward
this rank's slice: the ranks compute the same function), ``copy_to_group``
/ ``reduce_from_group`` (Megatron's f and g: identity forward and all-reduce
backward, and the reverse) and ``ring_shift`` (send to the next rank of the
line, receive from the previous one; the backward sends the gradient the
other way).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from csm_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh
from csm_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 600


def initialize(device="cuda") -> Tuple[int, int]:
    """Join the process group; returns (rank, world_size).

    Reads ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` as ``torch.distributed.run`` sets them (``env://``);
    the backend follows the ranks' ``device`` (``backend_for``).  A single
    process (no ``WORLD_SIZE`` above 1) creates no group and returns
    (0, 1); a call with a group up (a second one, or ranks started by
    ``parallel/launch.py``) returns that group's."""
    backend = backend_for(rank_device(device))  # raises here when no card is there
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    if "MASTER_ADDR" not in os.environ:
        raise RuntimeError("WORLD_SIZE > 1 without MASTER_ADDR: start the ranks with "
                           "python -m torch.distributed.run")
    rank = int(os.environ["RANK"])
    dist.init_process_group(backend=backend, init_method="env://", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    return rank, world


def local_rank() -> Tuple[int, int]:
    """(LOCAL_RANK, LOCAL_WORLD_SIZE), (0, 1) in a single process."""
    return (int(os.environ.get("LOCAL_RANK", "0")),
            int(os.environ.get("LOCAL_WORLD_SIZE", os.environ.get("WORLD_SIZE", "1"))))


def rank_device(device="cuda") -> torch.device:
    """This rank's device: for "cuda", ``cuda:LOCAL_RANK`` with a card per
    local rank, else the cards shared (``cuda:LOCAL_RANK % cards``), and a
    machine without a card raises (utils/device.resolve_device); the CPU
    only when ``device`` asks for it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    lr, _ = local_rank()
    return torch.device("cuda", lr % torch.cuda.device_count())


def backend_for(device: torch.device) -> str:
    """NCCL when every local rank has a card of its own, else gloo."""
    if device.type != "cuda":
        return "gloo"
    _, lw = local_rank()
    return "nccl" if torch.cuda.device_count() >= lw else "gloo"


def _is_gloo(group) -> bool:
    return dist.get_backend(group) == "gloo"


_pinned: dict = {}


def _staging(key: str, numel: int, dtype) -> torch.Tensor:
    """A pinned host buffer of ``numel`` elements, kept per (key, dtype) and
    grown as needed: pinned memory copies to and from the card at full
    speed, and a buffer allocated afresh each call would pay its page
    faults every time."""
    buf = _pinned.get((key, dtype))
    if buf is None or buf.numel() < numel:
        _pinned[(key, dtype)] = buf = torch.empty(numel, dtype=dtype, pin_memory=True)
    return buf[:numel]


_STAGE_BYTES = 256 << 20  # pinned memory is locked host RAM: a whole gradient would lock GBs


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum of the contiguous ``t`` over ``group`` (no-op for
    None): as it is for NCCL or a host tensor; a CUDA tensor in a gloo
    group a part of at most ``_STAGE_BYTES`` at a time through one pinned
    host buffer."""
    if group is None or t.numel() == 0:
        return t
    if t.device.type != "cuda" or not _is_gloo(group):
        dist.all_reduce(t, group=group)
        return t
    flat = t.view(-1)
    step = max(1, _STAGE_BYTES // t.element_size())
    buf = _staging("reduce", min(flat.numel(), step), t.dtype)
    for i in range(0, flat.numel(), step):
        part = flat[i:i + step]
        h = buf[:part.numel()]
        h.copy_(part)
        dist.all_reduce(h, group=group)
        part.copy_(h)
    return t


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    t = t.contiguous()
    if t.device.type == "cuda" and not _is_gloo(group):
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=group)
    elif t.device.type == "cuda":  # gloo: through pinned host buffers
        src = _staging("send", t.numel(), t.dtype).view(t.shape)
        src.copy_(t)
        recv = _staging("gather", n * t.numel(), t.dtype).view(n, *t.shape)
        dist.all_gather(list(recv.unbind(0)), src, group=group)
        out = recv.to(t.device)
    else:
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        out = torch.stack(parts)
    return torch.cat(out.unbind(0), dim=dim)


def _reduce_scatter(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if t.device.type == "cuda" and not _is_gloo(group):
        parts = t.movedim(dim, 0)
        parts = parts.reshape(n, parts.shape[0] // n, *parts.shape[1:]).contiguous()
        out = torch.empty(parts.shape[1:], dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, parts, group=group)
        return out.movedim(0, dim).contiguous()
    s = all_reduce_(t.contiguous().clone(), group)  # gloo: no reduce-scatter
    return s.chunk(n, dim=dim)[r].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate the group's ``x`` along ``dim``; the backward sums the
    gradient over the group and keeps this rank's slice (the ranks hold
    partial gradients: FSDP over data, a leaf gathered over pipe)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate the group's ``x`` along ``dim``; the backward keeps this
    rank's slice of the gradient, which every rank of the group computes
    whole (a leaf stored split over ``model`` but used whole)."""
    return x if group is None else _GatherReplicated.apply(x, group, dim)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: identity forward, all-reduce of the gradient."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: all-reduce forward, identity backward."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def _exchange(tensors: Sequence[torch.Tensor], members: Sequence[int], rank: int, shift: int):
    """Send each tensor to the rank ``shift`` places on along the line and
    receive the same shapes from ``shift`` places back."""
    n = len(members)
    i = members.index(rank)
    dst, src = members[(i + shift) % n], members[(i - shift) % n]
    outs, reqs = [], []
    for t in tensors:
        host = t.device.type == "cuda" and dist.get_backend() == "gloo"
        s = t.detach().to("cpu") if host else t.detach().contiguous()
        r = torch.empty_like(s)
        reqs += [dist.isend(s, dst), dist.irecv(r, src)]
        outs.append((r, t.device))
    for q in reqs:
        q.wait()
    return [r.to(dev) for r, dev in outs]


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, members, rank, shift, *tensors):
        ctx.members, ctx.rank, ctx.shift = members, rank, shift
        ctx.float_ = [t.is_floating_point() for t in tensors]
        ctx.like = [t for t in tensors if t.is_floating_point()]
        outs = _exchange(tensors, members, rank, shift)
        for o, f in zip(outs, ctx.float_):
            if not f:
                ctx.mark_non_differentiable(o)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        fl = [g for g, f in zip(grads, ctx.float_) if f]
        send = [torch.zeros_like(t) if g is None else g for g, t in zip(fl, ctx.like)]
        back = iter(_exchange(send, ctx.members, ctx.rank, -ctx.shift))
        return (None, None, None, *(next(back) if f else None for f in ctx.float_))


def ring_shift(mesh: Mesh, axis: str, *tensors: torch.Tensor, shift: int = 1):
    """Rotate ``tensors`` one place along the mesh ``axis`` (rank i of the
    line receives rank i−shift's tensors): the JAX ``ppermute`` with pairs
    (j, j+shift).  Differentiable in its float tensors: the backward sends
    each gradient back to the rank its tensor came from; integer tensors
    (positions) ride along without one.  Every rank of the line must call
    it, in the same order, forward and backward."""
    if mesh.axis_size(axis) == 1:
        return tuple(tensors)
    return _RingShift.apply(mesh.members[axis], mesh.rank, shift, *tensors)


def process_batch_slice(global_batch_size: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """(start, size) of the global-batch rows THIS rank should load.

    Without a mesh: an even contiguous split by rank.  With a mesh: by this
    rank's index on the data axis — ranks that differ only on model, pipe
    or seq load the same rows.  The global batch must divide the data
    axis (uneven slices would skew the gradient weighting)."""
    if mesh is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        n = dist.get_world_size() if dist.is_initialized() else 1
        if global_batch_size % n:
            raise ValueError(f"global batch {global_batch_size} not divisible by {n} processes")
        per = global_batch_size // n
        return rank * per, per
    dp = mesh.axis_size(DATA_AXIS)
    if global_batch_size % dp:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by the data axis ({dp})")
    per = global_batch_size // dp
    return mesh.index(DATA_AXIS) * per, per


def global_batch_from_local(local_batch, mesh: Mesh, seq_sharded: bool = False,
                            layout: str = "contiguous"):
    """This rank's part of the batch from its process's local rows
    (``process_batch_slice``): the rows as they are on a data-only layout;
    with ``seq_sharded`` (a (data, seq) mesh) the rank's positions of them
    under the ring ``layout`` as well (parallel/ring_attention.seq_columns).
    The port's losses take the global batch on every rank and slice it
    themselves; this is for a feed that loads only local rows."""
    from csm_torch.training.losses import Batch

    if not seq_sharded:
        return Batch(*local_batch)
    from csm_torch.parallel.ring_attention import seq_columns

    T = local_batch.tokens.shape[1]
    if T % mesh.axis_size(SEQ_AXIS):
        raise ValueError(f"batch spec has a sequence dim {T} the seq axis does not divide")
    cols = seq_columns(T, mesh, layout).to(local_batch.tokens.device)
    return Batch(*(t[:, cols] for t in local_batch))
