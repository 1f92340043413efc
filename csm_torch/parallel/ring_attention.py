"""Ring attention: sequence-parallel exact attention over a ``seq`` axis.

The counterpart of the JAX package's ``parallel/ring_attention.py``: the
sequence is split over the ranks of a ``seq`` line, so context length
scales with the rank count, with exact causal attention:

  * each rank holds S/n query rows and T/n key/value rows;
  * n ring steps: attend the local queries to the resident KV chunk
    through ``ops/flash_attention.flash_gqa_attention_with_lse`` (the flash
    kernel on the card, its plain version on the CPU, for every chunk: the
    ``FLASH_MIN_SEQ`` gate of the single-rank path does not apply), then
    pass the chunk and its positions to the next rank (``ring_shift``);
    the last rotation is skipped;
  * the partial results merge in log space: a chunk gives a normalized
    output and its rows' log-sum-exp (``L_EMPTY`` for a row that sees no
    key of the chunk, taken as −inf, so its weight is 0), and the running
    pair combines exactly;
  * causal masking comes from positions (``kv_pos <= q_pos``), so a layout
    is a permutation of the sequence and the ring needs no causal
    bookkeeping.

The gradient goes through autograd: the merge's lse cotangent reaches the
flash Function's backward, which folds it into Dr, and ``ring_shift``'s
backward sends each chunk's dk/dv back around the ring.  The merge guards
its exponentials so a row that has seen no key so far contributes zeros,
not NaN, to every gradient.

``zigzag_perm`` gives rank d the chunks (d, 2n−1−d) of 2n, which evens out
the causal work (the contiguous split gives the last rank ~2x the first's).
"""

from __future__ import annotations

import numpy as np
import torch

from csm_torch.ops.flash_attention import L_EMPTY, flash_gqa_attention_with_lse
from csm_torch.parallel import distributed as D
from csm_torch.parallel.mesh import DATA_AXIS, SEQ_AXIS, Mesh, build

_NEG_INF = float("-inf")


def _chunk_attention(q, k, v, q_pos, kv_pos):
    """(out float32 (B, S, Hq, D), lse (B, S, Hq)) of one KV chunk, −inf
    for a row that sees none of its keys."""
    out, L = flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos)
    lse = L.transpose(1, 2)
    lse = torch.where(lse > L_EMPTY / 2, torch.full_like(lse, _NEG_INF), lse)
    return out.float(), lse


def _logaddexp(a, b):
    """log(e^a + e^b) with −inf allowed on both sides and no NaN in its
    gradient (the shift is held constant: the result does not depend on
    it)."""
    m = torch.maximum(a, b).detach()
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    s = torch.exp(a - m) + torch.exp(b - m)
    pos = s > 0
    return torch.where(pos, m + torch.log(torch.where(pos, s, torch.ones_like(s))),
                       torch.full_like(s, _NEG_INF))


def ring_attention(q, k, v, q_pos, kv_pos, mesh: Mesh, axis: str = SEQ_AXIS):
    """Exact GQA causal attention with KV rotating around ``axis``.

    Every tensor is this rank's chunk: q (B, S/n, Hq, D); k/v
    (B, T/n, Hkv, D); q_pos (B, S/n) int32; kv_pos (B, T/n) int32 (PAD_POS
    for dead slots).  Returns the local (B, S/n, Hq, D) output in q's
    dtype: the single-rank attention under the positions' causal mask."""
    n = mesh.axis_size(axis)
    B, S, Hq, D_ = q.shape
    acc = torch.zeros((B, S, Hq, D_), dtype=torch.float32, device=q.device)
    lse = torch.full((B, S, Hq), _NEG_INF, dtype=torch.float32, device=q.device)
    k_c, v_c, kpos_c = k, v, kv_pos.to(torch.int32).contiguous()
    for j in range(n):
        o_i, lse_i = _chunk_attention(q, k_c, v_c, q_pos, kpos_c)
        lse_new = _logaddexp(lse, lse_i)
        fin = torch.isfinite(lse_new)
        base = torch.where(fin, lse_new, torch.zeros_like(lse_new))
        zero = torch.zeros_like(lse_new)
        a_old = torch.where(fin, torch.exp(lse - base), zero)
        a_new = torch.where(fin, torch.exp(lse_i - base), zero)
        acc = acc * a_old[..., None] + o_i * a_new[..., None]
        lse = lse_new
        if j < n - 1:  # the last rotation would be discarded
            k_c, v_c, kpos_c = D.ring_shift(mesh, axis, k_c, v_c, kpos_c)
    return acc.to(q.dtype)


def make_sp_mesh(world_size=None, rank=None, seq_parallel=None) -> Mesh:
    """A (data, seq) mesh; ``seq_parallel`` defaults to all ranks."""
    from csm_torch.parallel.mesh import _world

    world_size, rank = _world(world_size, rank)
    sp = seq_parallel or world_size
    if world_size % sp != 0:
        raise ValueError(f"{world_size} devices not divisible by seq_parallel={sp}")
    return build({DATA_AXIS: -1, SEQ_AXIS: sp}, world_size, rank)


def zigzag_perm(S: int, n: int) -> np.ndarray:
    """Zigzag sequence layout: rank d holds chunks (d, 2n-1-d) of 2n.

    Returns perm with ``x[:, perm]`` laid out so an even S/n split puts
    chunks (d, 2n-1-d) on rank d.  S must divide by 2n."""
    if S % (2 * n):
        raise ValueError(f"S={S} must divide by 2*seq={2 * n} for zigzag")
    c = S // (2 * n)
    chunks = np.arange(S).reshape(2 * n, c)
    order = []
    for d in range(n):
        order.append(chunks[d])
        order.append(chunks[2 * n - 1 - d])
    return np.concatenate(order)


def resolve_layout(layout: str, T: int, n: int) -> str:
    """"auto" → zigzag when T divides by 2n, else contiguous."""
    if layout == "auto":
        return "zigzag" if T % (2 * n) == 0 else "contiguous"
    if layout not in ("zigzag", "contiguous"):
        raise ValueError(f"unknown layout {layout!r}")
    return layout


def seq_columns(T: int, mesh: Mesh, layout: str = "contiguous") -> torch.Tensor:
    """The global positions this rank of the ``seq`` axis holds (int64)."""
    n = mesh.axis_size(SEQ_AXIS)
    if T % n:
        raise ValueError(f"sequence length {T} not divisible by the seq axis ({n})")
    layout = resolve_layout(layout, T, n)
    perm = zigzag_perm(T, n) if layout == "zigzag" else np.arange(T)
    i = mesh.index(SEQ_AXIS)
    return torch.from_numpy(perm[i * (T // n):(i + 1) * (T // n)].copy())


def sharded_ring_attention(mesh: Mesh, q, k, v, q_pos, kv_pos, layout: str = "contiguous"):
    """Global arrays in, global out: this rank takes its rows (over
    ``data``) and positions (over ``seq``, in ``layout``), runs the ring,
    and the outputs are gathered back in sequence order (the gather's
    backward keeps this rank's part: every rank computes the same from
    it).

    q (B, S, Hq, D); k/v (B, T, Hkv, D); q_pos (B, S); kv_pos (B, T) or
    (T,).  "zigzag" needs S == T."""
    B, S = q.shape[:2]
    T = k.shape[1]
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :].expand(B, T)
    if layout == "zigzag" and S != T:
        raise ValueError("zigzag layout requires S == T")
    rows = D.process_batch_slice(B, mesh)
    r = slice(rows[0], rows[0] + rows[1])
    qc = seq_columns(S, mesh, layout).to(q.device)
    kc = seq_columns(T, mesh, layout).to(q.device)
    out = ring_attention(q[r][:, qc].contiguous(), k[r][:, kc].contiguous(),
                         v[r][:, kc].contiguous(), q_pos[r][:, qc].to(torch.int32).contiguous(),
                         kv_pos[r][:, kc].to(torch.int32).contiguous(), mesh)
    out = D.gather_replicated(out, mesh.groups.get(SEQ_AXIS), dim=1)
    out = D.gather_replicated(out, mesh.groups.get(DATA_AXIS), dim=0)
    order = torch.cat([seq_columns(S, _at(mesh, i), layout) for i in range(mesh.axis_size(SEQ_AXIS))])
    inv = torch.empty_like(order)
    inv[order] = torch.arange(S)
    return out[:, inv.to(out.device)]


def _at(mesh: Mesh, seq_index: int) -> Mesh:
    """``mesh`` seen from the rank at ``seq_index`` on the seq axis (for its
    columns)."""
    import dataclasses

    return dataclasses.replace(mesh, coords=dict(mesh.coords, **{SEQ_AXIS: seq_index}))
