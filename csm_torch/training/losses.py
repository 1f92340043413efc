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
both transformers, with adapter-input dropout in training only.  Sequence-
and pipeline-parallel backbones (``seq_mesh``, ``pp_mesh``) wait for a
later slice.

Batch layout (made by ``csm_torch.data.dataset``):
    tokens       (B, T, K+1) int32  interleaved text+audio frames
    tokens_mask  (B, T, K+1) bool   column liveness
    targets      (B, T, K)   int32  the audio frame at input position t+1
    target_mask  (B, T)      bool   True where ``targets`` holds a real frame
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from csm_torch.generator import _waits
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


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Mean CE over positions where ``mask`` is True (float32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    denom = mask.sum().clamp(min=1)
    return (nll * mask).sum() / denom


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
) -> Tuple[torch.Tensor, dict]:
    """Total training loss and metrics (device tensors).

    total = semantic_weight · CE(codebook 0 over every target frame)
          + acoustic_weight · CE(codebooks 1..K-1 over a random
                                 1/amortization_ratio subset, teacher-forced)

    ``generator`` draws the subset; ``frame_scores`` (B*T,) replaces the
    draw.  ``lora`` — {"backbone": adapters, "decoder": adapters}
    (training/lora.py) applied at ``lora_scale``; ``lora_dropout`` > 0
    draws the adapters' input-dropout masks from ``generator`` too (the
    eval step passes 0)."""
    if seq_mesh is not None or pp_mesh is not None:
        raise _waits("sequence- and pipeline-parallel training", "A.11")
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
    return _loss_from_backbone_out(
        params, args, generator, batch, h, semantic_weight=semantic_weight,
        acoustic_weight=acoustic_weight, amortization_ratio=amortization_ratio,
        compute_dtype=compute_dtype, remat=remat, frame_scores=frame_scores,
        dec_lora=lora_kw("decoder"),
    )


def _loss_from_backbone_out(
    params, args, generator, batch, h, *, semantic_weight, acoustic_weight,
    amortization_ratio, compute_dtype, remat, frame_scores=None, dec_lora=None,
) -> Tuple[torch.Tensor, dict]:
    """Semantic CE + amortized acoustic decoder CE, given the backbone's
    (B, T, E_b) output ``h``."""
    K = args.audio_num_codebooks
    B, T, _ = batch.tokens.shape
    device = h.device

    # ---- semantic loss: codebook 0 on every frame ----
    c0_logits = _matmul(h, params["codebook0_head"])  # (B, T, V)
    semantic_loss = masked_cross_entropy(c0_logits, batch.targets[:, :, 0], batch.target_mask)

    # ---- acoustic loss: amortized decoder CE ----
    n_sub = max(1, (B * T) // amortization_ratio)
    flat_idx, sel_valid = _select_amortized_frames(
        generator, batch.target_mask, n_sub, frame_scores
    )
    h_flat = h.reshape(B * T, -1)[flat_idx]  # (n_sub, E_b)
    tgt_flat = batch.targets.reshape(B * T, K)[flat_idx].long()  # (n_sub, K)

    # Teacher-forced decoder input: [h_t, embed(c0), ..., embed(c_{K-2})];
    # output j >= 1 predicts codebook j through audio_head[j-1].
    cb_idx = torch.arange(K - 1, device=device)
    cb_embeds = params["audio_embeddings"].to(compute_dtype)[
        tgt_flat[:, : K - 1] + cb_idx[None, :] * args.audio_vocab_size
    ]  # (n_sub, K-1, E_b)
    dec_in = torch.cat([h_flat[:, None, :].to(cb_embeds.dtype), cb_embeds], dim=1)
    dec_in = _matmul(dec_in, params["projection"]).to(compute_dtype)

    dec_pos = torch.arange(K, dtype=torch.int32, device=device).expand(n_sub, K)
    dec_mask = causal_mask_from_positions(dec_pos, dec_pos[0])
    dh, _ = transformer_apply(
        params["decoder"], args.decoder, dec_in, dec_pos, dec_mask, remat=remat,
        **(dec_lora or {}),
    )  # (n_sub, K, E_d)

    head = params["audio_head"]
    dt = torch.promote_types(dh.dtype, head.dtype)
    dec_logits = torch.einsum("nkd,kdv->nkv", dh[:, 1:, :].to(dt), head.to(dt))
    acoustic_loss = masked_cross_entropy(
        dec_logits, tgt_flat[:, 1:], sel_valid[:, None].expand(n_sub, K - 1)
    )

    total = semantic_weight * semantic_loss + acoustic_weight * acoustic_loss
    metrics = {
        "loss": total,
        "semantic_loss": semantic_loss,
        "acoustic_loss": acoustic_loss,
        "num_target_frames": batch.target_mask.sum(),
        "num_amortized_frames": sel_valid.sum(),
    }
    return total, metrics
