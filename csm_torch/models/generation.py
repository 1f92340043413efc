"""Autoregressive audio-token generation: bucketed prefill, then one
``generate_frame`` per 80 ms frame until every row has emitted the all-zero
EOS frame or ``max_frames`` is reached.

Same contract as the JAX package's ``models/generation.py``: prompts are
right-padded to a bucket with PAD_POS positions, EOS is tracked per row,
frames after a row's EOS are zero-filled, and frame i-1 is consumed at
position ``prompt_len + i - 1``.  The JAX ``while_loop`` becomes a Python
loop that exits early once every row is done (one host read per frame).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from csm_torch.models import csm
from csm_torch.models.config import ModelArgs
from csm_torch.utils.device import resolve_device

PROMPT_BUCKETS = (64, 128, 256, 512, 1024, 2048, 4096, 8192)


def bucket_length(n: int, buckets=PROMPT_BUCKETS) -> int:
    """Smallest bucket >= n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds max bucket {buckets[-1]}")


class GenerationResult(NamedTuple):
    frames: torch.Tensor  # (B, max_frames, K) int32; zero-filled after EOS
    num_frames: torch.Tensor  # (B,) int32 valid frame count per row
    steps: int  # frame steps run after the prefill frame
    prefill_s: float  # host time of the prefill frame, device work included


def generate_audio_tokens(
    params: dict,
    args: ModelArgs,
    prompt_tokens: torch.Tensor,
    prompt_mask: torch.Tensor,
    prompt_len: torch.Tensor,
    max_frames: int,
    temperature: float = 0.9,
    topk: int = 50,
    compute_dtype=torch.bfloat16,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    kv_dtype=None,
) -> GenerationResult:
    """Generate up to ``max_frames`` frames after the prompt.

    Args:
        params: CSM parameters on ``device``.
        prompt_tokens / prompt_mask: (B, S_pad, K+1) right-padded frames and
            column liveness (False on padding rows).
        prompt_len: (B,) real prompt lengths.
        (the three prompt arrays may be tensors or numpy arrays)
        generator: torch.Generator on ``device`` for the sampling draws.
        kv_dtype: backbone cache dtype (``torch.int8``: quantized KV cache;
            None: ``compute_dtype``).
    """
    device = resolve_device(device)
    if params["text_embeddings"].device.type != device.type:
        raise ValueError(f"params are on {params['text_embeddings'].device}, not {device}")
    K = args.audio_num_codebooks
    prompt_tokens = torch.as_tensor(prompt_tokens, device=device)
    prompt_mask = torch.as_tensor(prompt_mask, device=device)
    prompt_len = torch.as_tensor(prompt_len, device=device).to(torch.int32)
    B, S_pad, _ = prompt_tokens.shape
    t0 = time.perf_counter()

    state = csm.init_frame_state(args, B, compute_dtype, S_pad + max_frames, device, kv_dtype)
    col = torch.arange(S_pad, dtype=torch.int32, device=device)
    input_pos = torch.where(
        col[None, :] < prompt_len[:, None], col[None, :], torch.full_like(col, csm.PAD_POS)
    )

    frame, state = csm.generate_frame(
        params, args, generator, prompt_tokens, prompt_mask, input_pos, state,
        temperature, topk, compute_dtype, last_idx=prompt_len - 1,
    )
    frames_buf = torch.zeros((B, max_frames, K), dtype=torch.int32, device=device)
    done = (frame == 0).all(dim=1)
    frames_buf[:, 0] = torch.where(done[:, None], 0, frame)
    num_frames = (~done).to(torch.int32)
    all_done = bool(done.all())  # host read: also ends the prefill's device work
    prefill_s = time.perf_counter() - t0

    # frame i-1 is consumed as one token: audio columns live, text dead
    step_mask = torch.zeros((B, 1, K + 1), dtype=torch.bool, device=device)
    step_mask[:, :, :K] = True
    i = 1
    while i < max_frames and not all_done:
        step_tokens = torch.zeros((B, 1, K + 1), dtype=torch.int32, device=device)
        step_tokens[:, 0, :K] = frame
        pos = (prompt_len[:, None] + (i - 1)).to(torch.int32)
        frame, state = csm.generate_frame(
            params, args, generator, step_tokens, step_mask, pos, state,
            temperature, topk, compute_dtype,
        )
        done = done | (frame == 0).all(dim=1)
        frames_buf[:, i] = torch.where(done[:, None], 0, frame)
        num_frames += (~done).to(torch.int32)
        all_done = bool(done.all())
        i += 1
    return GenerationResult(frames_buf, num_frames, i - 1, prefill_s)
