"""The (T, 33) interleaved token-frame format.

The CSM sequence contract (reference: src/csm/generator.py:77-145):
each sequence position is a 33-wide vector — 32 audio codebook columns +
1 text column — with a boolean liveness mask selecting which columns are
real.  Text prompts are ``[{speaker}]{text}`` tokens in column 32; audio
is Mimi codes in columns 0..31 with an all-zero EOS frame appended.

Used by both the generation pipeline and the training dataset (mirrors
src/csm/data/training_data.py:245-313).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from csm_torch.models.config import ModelArgs


def text_frames(
    args: ModelArgs, token_ids: Sequence[int]
) -> Tuple[np.ndarray, np.ndarray]:
    """Text token ids → ((T, K+1) tokens, mask) with column K live
    (reference: src/csm/generator.py:91-96)."""
    K = args.audio_num_codebooks
    T = len(token_ids)
    tokens = np.zeros((T, K + 1), np.int32)
    mask = np.zeros((T, K + 1), bool)
    tokens[:, K] = np.asarray(token_ids, np.int32)
    mask[:, K] = True
    return tokens, mask


def audio_frames(
    args: ModelArgs, codes: np.ndarray, add_eos: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Mimi codes (K, F) → ((F[+1], K+1) tokens, mask) with audio columns
    live; optionally appends the all-zero EOS frame
    (reference: src/csm/generator.py:117-125)."""
    K = args.audio_num_codebooks
    codes = np.asarray(codes, np.int32)
    assert codes.shape[0] == K, f"expected {K} codebooks, got {codes.shape[0]}"
    F = codes.shape[1] + (1 if add_eos else 0)
    tokens = np.zeros((F, K + 1), np.int32)
    mask = np.zeros((F, K + 1), bool)
    tokens[: codes.shape[1], :K] = codes.T
    mask[:, :K] = True  # EOS frame is live all-zero audio
    return tokens, mask


def segment_frames(
    args: ModelArgs, text_ids: Sequence[int], codes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """One conversation segment = its text frames ++ audio frames
    (reference: src/csm/generator.py:142-145)."""
    tt, tm = text_frames(args, text_ids)
    at, am = audio_frames(args, codes)
    return np.concatenate([tt, at]), np.concatenate([tm, am])


def concat_frames(parts) -> Tuple[np.ndarray, np.ndarray]:
    toks = np.concatenate([p[0] for p in parts])
    masks = np.concatenate([p[1] for p in parts])
    return toks, masks
