"""CSM dual-transformer model, PyTorch.

A Llama-3.2-1B backbone over interleaved text+audio token frames predicts
the semantic (codebook-0) Mimi token of each 80 ms frame; a Llama-3.2-100M
decoder fills the other 31 acoustic codebooks, over a 32-slot cache whose
slots are all rewritten every frame.  Same parameter tree as the JAX
package's ``models/csm.py``; the decoder loop is a Python loop of S=1
steps (unrolled inside a CUDA graph's capture, as the JAX ``lax.scan``
runs inside its program), and caches are written in place.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from csm_torch.models.config import ModelArgs
from csm_torch.models.llama import fuse_projections, transformer_apply, transformer_init
from csm_torch.ops.attention import causal_mask_from_positions
from csm_torch.ops.flash_attention import FLASH_MIN_SEQ
from csm_torch.ops.kvcache import KVCache, Offset, RowOffsets, init_kv_cache, write_rows
from csm_torch.ops.sampling import sample_topk

# Position of unwritten / padding cache slots: larger than any real query
# position, so the causal test kv_pos <= q_pos never selects them for a
# real query.
PAD_POS = 1 << 28


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b at the promoted dtype (bf16 @ f32 → f32, as in JAX)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def init_csm_params(
    args: ModelArgs, generator: torch.Generator, dtype=torch.float32, device="cpu"
) -> dict:
    """Random CSM parameters (normal / sqrt(fan_in)), the tree of the JAX
    package's ``init_csm_params``."""
    bb, dec = args.backbone, args.decoder
    V, K = args.audio_vocab_size, args.audio_num_codebooks

    def init(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / fan_in**0.5).to(dtype)

    return {
        "backbone": transformer_init(bb, generator, dtype, device),
        "decoder": transformer_init(dec, generator, dtype, device),
        "text_embeddings": init((args.text_vocab_size, bb.embed_dim), bb.embed_dim),
        "audio_embeddings": init((V * K, bb.embed_dim), bb.embed_dim),
        "projection": init((bb.embed_dim, dec.embed_dim), bb.embed_dim),
        "codebook0_head": init((bb.embed_dim, V), bb.embed_dim),
        "audio_head": init((K - 1, dec.embed_dim, V), dec.embed_dim),
    }


def fuse_csm_params(params: dict) -> dict:
    """Fused qkv / gate-up projections for backbone and decoder, float or
    quantized (idempotent)."""
    out = dict(params)
    for comp in ("backbone", "decoder"):
        if "wqkv" not in params[comp]:
            out[comp] = fuse_projections(params[comp])
    return out


def embed_audio(params: dict, args: ModelArgs, codebook, tokens: torch.Tensor) -> torch.Tensor:
    """Audio tokens of one codebook → embeddings (codebook-offset rows)."""
    return params["audio_embeddings"][tokens.long() + codebook * args.audio_vocab_size]


def embed_tokens(params: dict, args: ModelArgs, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """(B, S, K+1) token frame → (B, S, K+1, E); columns 0..K-1 audio, K text."""
    K = args.audio_num_codebooks
    text_table, audio_table = params["text_embeddings"], params["audio_embeddings"]
    if dtype is not None:
        text_table, audio_table = text_table.to(dtype), audio_table.to(dtype)
    tokens = tokens.long()
    text = text_table[tokens[:, :, -1]][:, :, None, :]
    offsets = args.audio_vocab_size * torch.arange(K, device=tokens.device)
    audio = audio_table[tokens[:, :, :K] + offsets]
    return torch.cat([audio, text], dim=-2)


def masked_embed_sum(params, args, tokens, tokens_mask, dtype=None) -> torch.Tensor:
    """Embed, mask and sum over the frame columns → (B, S, E)."""
    embeds = embed_tokens(params, args, tokens, dtype=dtype)
    return (embeds * tokens_mask[..., None].to(embeds.dtype)).sum(dim=2)


class FrameState(NamedTuple):
    """Decode-loop state: backbone KV cache (written in place), the number of
    cache columns written, and the position held by each slot (PAD_POS for
    unwritten / padding slots).  ``offset`` is the first column to write as
    a Python int; the S columns as an int64 device tensor (S,), a CUDA
    graph's frame step, whose column moves from replay to replay; or
    ``RowOffsets``, each row's own column of an S=1 step (serving: every
    slot's row fills independently, and a column past the cache's end is
    dropped)."""

    cache: KVCache
    offset: Offset
    kv_pos: torch.Tensor  # (B, max_seq) int32


class DecoderBuffers(NamedTuple):
    """The decoder's per-frame state: its K-slot cache, and the constant
    positions and masks of its K-1 calls.  Every slot is written before a
    query attends it (slots 0-1 by the S=2 call, slot i by step i), so a
    cache reused across frames needs no reset."""

    cache: KVCache
    pos01: torch.Tensor  # (B, 2) int32: positions 0 and 1
    mask01: torch.Tensor  # (B, 2, K) bool
    step_pos: torch.Tensor  # (K, B, 1) int32: entry i holds position i
    step_mask: torch.Tensor  # (K, B, 1, K) bool: entry i is step i's mask


def init_decoder_buffers(args: ModelArgs, batch_size: int, dtype, device) -> DecoderBuffers:
    K = args.audio_num_codebooks
    cache = init_kv_cache(args.decoder, batch_size, dtype, max_seq_len=K, device=device)
    kv_pos = torch.arange(K, dtype=torch.int32, device=device)
    pos01 = kv_pos[:2].expand(batch_size, 2)
    step_pos = kv_pos[:, None, None].expand(K, batch_size, 1).contiguous()
    return DecoderBuffers(
        cache, pos01, causal_mask_from_positions(pos01, kv_pos), step_pos,
        kv_pos[None, None, None, :] <= step_pos[..., None],
    )


def init_frame_state(
    args: ModelArgs, batch_size: int, dtype=torch.bfloat16, max_seq_len=None, device="cpu",
    kv_dtype=None,
) -> FrameState:
    """``kv_dtype`` overrides the backbone cache's dtype (``torch.int8``: a
    quantized cache, ops/kvcache.py); the decoder's per-frame cache stays
    float."""
    cache = init_kv_cache(args.backbone, batch_size, kv_dtype or dtype, max_seq_len, device)
    kv_pos = torch.full(
        (batch_size, cache.max_seq_len), PAD_POS, dtype=torch.int32, device=device
    )
    return FrameState(cache, 0, kv_pos)


def generate_frame(
    params: dict,
    args: ModelArgs,
    generator: Optional[torch.Generator],
    tokens: torch.Tensor,
    tokens_mask: torch.Tensor,
    input_pos: torch.Tensor,
    state: FrameState,
    temperature,
    topk: int,
    compute_dtype=torch.bfloat16,
    last_idx: Optional[torch.Tensor] = None,
    uniforms: Optional[torch.Tensor] = None,
    dec_bufs: Optional[DecoderBuffers] = None,
    lora: Optional[dict] = None,
    lora_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, FrameState]:
    """Generate one 32-codebook audio frame.

    Nothing here reads the host or depends on a value that changes from
    frame to frame when ``state.offset`` is a device tensor and
    ``uniforms``, ``temperature`` and ``dec_bufs`` are given, so a CUDA
    graph can capture it once and replay it every frame.

    Args:
        tokens/tokens_mask: (B, S, K+1) input frame(s).
        input_pos: (B, S) int32 absolute positions; padding rows carry PAD_POS.
        state: backbone cache state; new K/V are written IN PLACE at
            ``state.offset``.
        temperature: a float, or a float32 device scalar.
        last_idx: (B,) index of each row's last real prompt row (None → S-1).
        uniforms: (K, B, 1) float32 draws, one per codebook and row; None →
            drawn here from ``generator``.
        dec_bufs: the decoder's buffers (``init_decoder_buffers``); None →
            fresh ones.
        lora/lora_ids: an ADAPTER BANK ({"backbone": tree or None,
            "decoder": ...}, training/lora.fuse_lora_bank, scaling folded
            into b) and each row's adapter id (B,) int64, 0 = the base
            model: multi-LoRA serving.

    Returns ((B, K) int32 codes, the advanced FrameState).
    """
    K = args.audio_num_codebooks
    bb, dec = args.backbone, args.decoder
    B, S, _ = tokens.shape
    device = tokens.device
    if uniforms is None:
        uniforms = torch.rand((K, B, 1), generator=generator, device=device)
    if dec_bufs is None:
        dec_bufs = init_decoder_buffers(args, B, compute_dtype, device)

    # ---- backbone step ----
    h = masked_embed_sum(params, args, tokens, tokens_mask).to(compute_dtype)
    kv_pos, offset = state.kv_pos, state.offset
    if isinstance(offset, RowOffsets):  # one column a row, past the end dropped
        write_rows(kv_pos, input_pos.to(torch.int32), offset.cols)
        next_offset = RowOffsets(offset.cols + S)
    elif isinstance(offset, torch.Tensor):
        kv_pos.index_copy_(1, offset, input_pos.to(torch.int32))
        next_offset = offset + S
    else:
        kv_pos[:, offset : offset + S] = input_pos.to(torch.int32)
        next_offset = offset + S
    if S >= FLASH_MIN_SEQ:  # the JAX package's cutoff, so both take the same paths
        bb_mask, flash_pos = None, (input_pos.to(torch.int32).contiguous(), kv_pos)
    else:
        bb_mask, flash_pos = causal_mask_from_positions(input_pos, kv_pos), None
    bb_lora = lora.get("backbone") if lora else None
    dec_lora = lora.get("decoder") if lora else None
    h, cache = transformer_apply(
        params["backbone"], bb, h, input_pos, bb_mask, state.cache, state.offset,
        flash_pos=flash_pos, lora=bb_lora, lora_scale=1.0, lora_ids=lora_ids,
    )
    new_state = FrameState(cache, next_offset, kv_pos)
    last_h = h[:, -1, :] if last_idx is None else h[torch.arange(B, device=device), last_idx.long()]

    # ---- codebook 0 from the backbone head ----
    c0_logits = _matmul(last_h, params["codebook0_head"])
    c0 = sample_topk(c0_logits, topk, temperature, uniforms=uniforms[0])
    c0_embed = embed_audio(params, args, 0, c0).to(compute_dtype)

    # ---- decoder: its K slots rewritten every frame ----
    curr_h = torch.stack([last_h, c0_embed], dim=1)  # (B, 2, E_b)
    proj_h = _matmul(curr_h, params["projection"]).to(compute_dtype)
    dec_h, _ = transformer_apply(
        params["decoder"], dec, proj_h, dec_bufs.pos01, dec_bufs.mask01, dec_bufs.cache, 0,
        lora=dec_lora, lora_scale=1.0, lora_ids=lora_ids,
    )
    c1_logits = _matmul(dec_h[:, -1, :], params["audio_head"][0]).float()
    samples = [c0, sample_topk(c1_logits, topk, temperature, uniforms=uniforms[1])]

    # ---- codebooks 2..K-1: single-position decoder steps ----
    for i in range(2, K):
        emb = embed_audio(params, args, i - 1, samples[-1])[:, None, :]
        proj = _matmul(emb, params["projection"]).to(compute_dtype)
        dh, _ = transformer_apply(
            params["decoder"], dec, proj, dec_bufs.step_pos[i], dec_bufs.step_mask[i],
            dec_bufs.cache, i, lora=dec_lora, lora_scale=1.0, lora_ids=lora_ids,
        )
        logits = _matmul(dh[:, -1, :], params["audio_head"][i - 1]).float()
        samples.append(sample_topk(logits, topk, temperature, uniforms=uniforms[i]))
    return torch.stack(samples, dim=1).to(torch.int32), new_state


def backbone_forward(params, args, tokens, tokens_mask, positions=None, compute_dtype=torch.bfloat16):
    """Full-sequence (uncached) backbone pass → (B, S, E_b) hidden states."""
    B, S, _ = tokens.shape
    if positions is None:
        positions = torch.arange(S, device=tokens.device).expand(B, S)
    h = masked_embed_sum(params, args, tokens, tokens_mask).to(compute_dtype)
    mask = causal_mask_from_positions(positions, positions[0])
    h, _ = transformer_apply(params["backbone"], args.backbone, h, positions, mask)
    return h
