"""CSM training loss: semantic + compute-amortized acoustic.

The counterpart of the JAX package's ``training/losses.py``.  The backbone
learns codebook 0 on every frame; the audio decoder is trained on a random
1/``amortization_ratio`` subset of frames, teacher-forced over all 31
acoustic codebooks, in one batched decoder pass.  Cross-entropy runs in
float32.

The backbone attends through the flash kernels (forward and backward) for
T >= ``FLASH_MIN_SEQ`` and through plain attention under a materialized mask
below that, the JAX package's routing.  On the CPU the flash route computes
the kernels' plain versions.  LoRA adapters (``lora``) run unmerged in
both transformers, with adapter-input dropout in training only.

Over a mesh of ranks (``mesh`` for data / tensor / FSDP layouts,
``seq_mesh`` for ring attention, ``pp_mesh`` for the pipeline) every rank
is given the same GLOBAL batch and computes on its own frames: its rows
(over ``data``) and its positions (over ``seq``).  The frame subset is
drawn over the global batch on every rank alike, and each rank sums the
cross-entropy of its own frames over the global counts, so the returned
loss is this rank's share of the global loss: summed over the ranks (the
train step sums the gradients) it is the single-rank loss, as GSPMD
computes it in the JAX package.  The metrics are the global values.

Batch layout (made by ``csm_torch.data.dataset``):
    tokens       (B, T, K+1) int32  interleaved text+audio frames
    tokens_mask  (B, T, K+1) bool   column liveness
    targets      (B, T, K)   int32  the audio frame at input position t+1
    target_mask  (B, T)      bool   True where ``targets`` holds a real frame
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from csm_torch.models.config import ModelArgs
from csm_torch.models.csm import _matmul, masked_embed_sum
from csm_torch.models.llama import transformer_apply
from csm_torch.ops.attention import causal_mask_from_positions
from csm_torch.ops.flash_attention import FLASH_MIN_SEQ


class Batch(NamedTuple):
    tokens: torch.Tensor
    tokens_mask: torch.Tensor
    targets: torch.Tensor
    target_mask: torch.Tensor

    def to(self, device) -> "Batch":
        return Batch(*(t.to(device, non_blocking=True) for t in self))


def _select_amortized_frames(
    generator: Optional[torch.Generator],
    target_mask: torch.Tensor,
    n_sub: int,
    scores: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pick ``n_sub`` random valid (b, t) frames, a fixed number.

    ``scores`` — optional (B*T,) uniforms in [0, 1) to rank frames by
    (tests hand both packages the same ones); else drawn from ``generator``.
    Returns (flat_idx (n_sub,), sel_valid (n_sub,)); when fewer than
    ``n_sub`` frames are valid, the extras carry sel_valid=False."""
    flat_valid = target_mask.reshape(-1)
    if scores is None:
        scores = torch.rand(flat_valid.shape, generator=generator, device=flat_valid.device)
    scores = torch.where(flat_valid, scores.reshape(-1), -1.0)
    flat_idx = torch.topk(scores, n_sub).indices
    return flat_idx, flat_valid[flat_idx]


def compute_loss(
    params: dict,
    args: ModelArgs,
    generator: Optional[torch.Generator],
    batch: Batch,
    semantic_weight: float = 100.0,
    acoustic_weight: float = 1.0,
    amortization_ratio: int = 16,
    compute_dtype=torch.bfloat16,
    remat: bool = False,
    lora: Optional[dict] = None,
    lora_scale: float = 0.0,
    lora_dropout: float = 0.0,
    seq_mesh=None,
    pp_mesh=None,
    frame_scores: Optional[torch.Tensor] = None,
    pp_microbatches: int = 1,
    ring_layout: str = "auto",
    mesh=None,
) -> Tuple[torch.Tensor, dict]:
    """Total training loss and metrics (device tensors).

    total = semantic_weight · CE(codebook 0 over every target frame)
          + acoustic_weight · CE(codebooks 1..K-1 over a random
                                 1/amortization_ratio subset, teacher-forced)

    ``generator`` draws the subset; ``frame_scores`` (B*T,) replaces the
    draw.  ``lora`` — {"backbone": adapters, "decoder": adapters}
    (training/lora.py) applied at ``lora_scale``; ``lora_dropout`` > 0
    draws the adapters' input-dropout masks from ``generator`` too (the
    eval step passes 0).

    ``seq_mesh`` — a mesh with a ``seq`` axis: the backbone runs ring
    attention (parallel/ring_attention.py) over this rank's positions in
    ``ring_layout`` ("zigzag", "contiguous", or "auto": zigzag when T
    divides by 2x the axis).  ``pp_mesh`` — a mesh with a ``pipe`` axis:
    the backbone runs as a pipeline of ``pp_microbatches`` microbatches
    (parallel/pipeline.py) and its last stage computes the loss.  ``mesh``
    — a (data, model) mesh.  The two are mutually exclusive; with any of
    them ``params`` (and ``lora``) may be a ``parallel/sharding.MeshView``
    of this rank's slices, or a whole tree."""
    if seq_mesh is not None and pp_mesh is not None:
        raise ValueError("pp_mesh and seq_mesh are mutually exclusive")
    any_mesh = seq_mesh if seq_mesh is not None else pp_mesh if pp_mesh is not None else mesh
    if any_mesh is not None:
        return _mesh_loss(
            params, args, generator, batch, any_mesh,
            "seq" if seq_mesh is not None else "pipe" if pp_mesh is not None else "model",
            semantic_weight=semantic_weight, acoustic_weight=acoustic_weight,
            amortization_ratio=amortization_ratio, compute_dtype=compute_dtype, remat=remat,
            lora=lora, lora_scale=lora_scale, lora_dropout=lora_dropout,
            frame_scores=frame_scores, pp_microbatches=pp_microbatches, ring_layout=ring_layout)
    B, T, _ = batch.tokens.shape
    device = batch.tokens.device
    positions = torch.arange(T, dtype=torch.int32, device=device).expand(B, T).contiguous()
    # tables cast BEFORE the gather: the (B, T, 33, E) gather output is the
    # largest activation of the step
    h = masked_embed_sum(params, args, batch.tokens, batch.tokens_mask, dtype=compute_dtype)
    if T >= FLASH_MIN_SEQ:
        mask, flash_pos = None, (positions, positions[0].contiguous())
    else:
        mask, flash_pos = causal_mask_from_positions(positions, positions[0]), None
    lora_kw = lambda comp: dict(  # noqa: E731
        lora=None if lora is None else lora.get(comp), lora_scale=lora_scale,
        lora_dropout_rate=lora_dropout, lora_generator=generator)
    h, _ = transformer_apply(
        params["backbone"], args.backbone, h, positions, mask, flash_pos=flash_pos, remat=remat,
        **lora_kw("backbone"),
    )
    sem, ac, n_amortized = _loss_from_backbone_out(
        params, args, generator, batch, h, amortization_ratio=amortization_ratio,
        compute_dtype=compute_dtype, remat=remat, frame_scores=frame_scores,
        dec_lora=lora_kw("decoder"),
    )
    total = semantic_weight * sem + acoustic_weight * ac
    return total, _metrics(total, sem, ac, batch.target_mask, n_amortized)


def _metrics(loss, semantic_loss, acoustic_loss, target_mask, n_amortized) -> dict:
    return {
        "loss": loss,
        "semantic_loss": semantic_loss,
        "acoustic_loss": acoustic_loss,
        "num_target_frames": target_mask.sum(),
        "num_amortized_frames": n_amortized,
    }


def _loss_from_backbone_out(
    params, args, generator, batch, h, *, amortization_ratio, compute_dtype, remat,
    frame_scores=None, dec_lora=None, rows=None, dec_shard=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(semantic CE, amortized acoustic decoder CE, amortized frames), given
    the backbone's output ``h``: (B, T, E_b) over the whole batch, or over
    the frames a rank holds, ``rows`` = (first row, row count, positions)
    of the global batch.  Each CE sums over ``h``'s frames and divides by
    the whole batch's count, so the ranks' parts add up to the single-rank
    loss; the frame subset is drawn over the whole batch, and each rank
    decodes the chosen frames it holds (``dec_shard``: the decoder's part
    of the mesh)."""
    K = args.audio_num_codebooks
    B, T, _ = batch.tokens.shape
    device = h.device
    tm = batch.target_mask
    targets, own_mask = batch.targets, tm
    if rows is not None:
        r0, nb, cols = rows
        targets, own_mask = (t[r0:r0 + nb][:, cols] for t in (targets, tm))

    # ---- semantic loss: codebook 0 on every frame ----
    c0_logits = _matmul(h, params["codebook0_head"])  # (B, T, V)
    semantic = _ce_sum(c0_logits, targets[:, :, 0], own_mask) / tm.sum().clamp(min=1)

    # ---- acoustic loss: amortized decoder CE ----
    n_sub = max(1, (B * T) // amortization_ratio)
    flat_idx, sel_valid = _select_amortized_frames(generator, tm, n_sub, frame_scores)
    dec_lora = dict(dec_lora or {})
    if rows is None:
        loc, mine = flat_idx, slice(None)
    else:  # the chosen frames this rank holds, and where they lie in ``h``
        own = ((r0 + torch.arange(nb, device=device))[:, None] * T + cols[None, :]).reshape(-1)
        where = torch.full((B * T,), -1, dtype=torch.long, device=device)
        where[own] = torch.arange(own.numel(), device=device)
        mine = where[flat_idx] >= 0
        loc = where[flat_idx][mine]
        if dec_lora.get("lora_dropout_rate", 0.0) > 0.0:  # the whole subset's masks, its rows
            g = dec_lora["lora_generator"]
            dec_lora["lora_uniform"] = lambda lid, sh: torch.rand(  # noqa: E731
                (n_sub, K, sh[-1]), generator=g, device=device)[mine]
    h_flat = h.reshape(-1, h.shape[-1])[loc]  # (n, E_b)
    tgt_flat = batch.targets.reshape(B * T, K)[flat_idx[mine]].long()  # (n, K)
    valid = sel_valid[mine]

    # Teacher-forced decoder input: [h_t, embed(c0), ..., embed(c_{K-2})];
    # output j >= 1 predicts codebook j through audio_head[j-1].
    cb_idx = torch.arange(K - 1, device=device)
    cb_embeds = params["audio_embeddings"].to(compute_dtype)[
        tgt_flat[:, : K - 1] + cb_idx[None, :] * args.audio_vocab_size
    ]  # (n, K-1, E_b)
    dec_in = torch.cat([h_flat[:, None, :].to(cb_embeds.dtype), cb_embeds], dim=1)
    dec_in = _matmul(dec_in, params["projection"]).to(compute_dtype)

    n = dec_in.shape[0]  # 0 on a rank that holds none of the chosen frames
    k_pos = torch.arange(K, dtype=torch.int32, device=device)
    dec_pos = k_pos.expand(n, K)
    dec_mask = causal_mask_from_positions(dec_pos, k_pos)
    dh, _ = transformer_apply(
        params["decoder"], args.decoder, dec_in, dec_pos, dec_mask, remat=remat,
        shard=dec_shard, **dec_lora,
    )  # (n, K, E_d)

    head = params["audio_head"]
    dt = torch.promote_types(dh.dtype, head.dtype)
    dec_logits = torch.einsum("nkd,kdv->nkv", dh[:, 1:, :].to(dt), head.to(dt))
    acoustic = _ce_sum(dec_logits, tgt_flat[:, 1:], valid[:, None].expand(n, K - 1)) / (
        sel_valid.sum() * (K - 1)).clamp(min=1)
    return semantic, acoustic, sel_valid.sum()


def _ce_sum(logits, labels, mask):
    """Σ of the masked cross-entropy (float32), over the caller's count."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return (nll * mask).sum()


def _whole_view(tree, mesh):
    """A whole (replicated) tree as a mesh view: nothing gathered."""
    from csm_torch.parallel.sharding import MeshView

    if tree is None or hasattr(tree, "leaves"):
        return tree
    return MeshView(tree, _none_layouts(tree), mesh, grad=False)


def _none_layouts(tree):
    return {k: _none_layouts(v) if isinstance(v, dict) else (None,) * v.dim()
            for k, v in tree.items()}


def _mesh_loss(params, args, generator, batch, mesh, kind, *, semantic_weight,
               acoustic_weight, amortization_ratio, compute_dtype, remat, lora, lora_scale,
               lora_dropout, frame_scores, pp_microbatches, ring_layout):
    """``compute_loss`` on a mesh: this rank's share of the global loss and
    the global metrics (see the module note)."""
    from csm_torch.parallel import distributed as D
    from csm_torch.parallel.mesh import SEQ_AXIS
    from csm_torch.parallel.pipeline import pipelined_transformer
    from csm_torch.parallel.ring_attention import resolve_layout, ring_attention, seq_columns
    from csm_torch.parallel.sharding import LOSS_AXES

    view, lview = _whole_view(params, mesh), _whole_view(lora, mesh)
    p = view.params
    lo = None if lview is None else lview.params
    B, T, _ = batch.tokens.shape
    device = batch.tokens.device
    r0, nb = D.process_batch_slice(B, mesh)
    if kind == "seq":
        layout = resolve_layout(ring_layout, T, mesh.axis_size(SEQ_AXIS))
        cols = seq_columns(T, mesh, layout).to(device)
    else:
        cols = torch.arange(T, device=device)
    tokens, tokens_mask = (t[r0:r0 + nb][:, cols] for t in (batch.tokens, batch.tokens_mask))
    pos = cols.to(torch.int32)[None].expand(nb, -1).contiguous()
    drop = lo is not None and lora_dropout > 0.0

    def rows_uniform(lid, sh):  # this rank's part of a mask drawn for the whole batch
        return torch.rand((B, T, sh[-1]), generator=generator, device=device)[r0:r0 + nb][:, cols]

    def lora_kw(comp, uniform=None):
        return dict(lora=None if lo is None else lo.get(comp), lora_scale=lora_scale,
                    lora_dropout_rate=lora_dropout if drop else 0.0, lora_generator=generator,
                    lora_uniform=uniform)

    h = masked_embed_sum(p, args, tokens, tokens_mask, dtype=compute_dtype)
    last = True
    if kind == "pipe":
        seed = None
        if drop:
            seed = int(torch.randint(2**31 - 1, (1,), generator=generator, device=device).item())
        h, last = pipelined_transformer(
            p["backbone"], args.backbone, h, cols, mesh, pp_microbatches,
            lora=None if lo is None else lo.get("backbone"), lora_scale=lora_scale, remat=remat,
            lora_dropout_rate=lora_dropout if drop else 0.0, lora_dropout_seed=seed,
            shard=view.backbone)
    else:
        attn_impl = mask = flash_pos = None
        if kind == "seq":
            attn_impl = lambda q, k, v: ring_attention(q, k, v, pos, pos, mesh)  # noqa: E731
        elif T >= FLASH_MIN_SEQ:
            flash_pos = (pos, pos[0].contiguous())
        else:
            mask = causal_mask_from_positions(pos, pos[0])
        h, _ = transformer_apply(
            p["backbone"], args.backbone, h, pos, mask, flash_pos=flash_pos, remat=remat,
            shard=view.backbone, attn_impl=attn_impl,
            **lora_kw("backbone", rows_uniform if drop else None))

    tm = batch.target_mask
    if last:
        sem, ac, n_amortized = _loss_from_backbone_out(
            p, args, generator, batch, h, amortization_ratio=amortization_ratio,
            compute_dtype=compute_dtype, remat=remat, frame_scores=frame_scores,
            dec_lora=lora_kw("decoder"), rows=(r0, nb, cols), dec_shard=view.decoder)
        total = semantic_weight * sem + acoustic_weight * ac
    else:  # a pipeline stage before the last: its backward runs from its output
        total = (h.float() * 0).sum()
        sem = ac = torch.zeros((), dtype=torch.float32, device=device)
        n_amortized = tm.sum().clamp(max=max(1, (B * T) // amortization_ratio))  # the last's
    parts = torch.stack([sem.detach().float(), ac.detach().float()]).clone()
    for a in LOSS_AXES:
        if mesh.axis_size(a) > 1:
            D.all_reduce_(parts, mesh.groups[a])
    sem_g, ac_g = parts[0], parts[1]
    return total, _metrics(semantic_weight * sem_g + acoustic_weight * ac_g, sem_g, ac_g, tm,
                           n_amortized)
