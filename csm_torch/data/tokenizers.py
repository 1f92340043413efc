"""Text and audio tokenizers for the CSM pipeline.

Text: the Llama-3.2-1B tokenizer from the local Hugging Face cache, wrapped
with BOS/EOS; offline, a deterministic byte-level tokenizer, used only when
the caller opts in (``allow_byte_fallback=True`` or
``CSM_TPU_ALLOW_BYTE_TOKENIZER=1``, the same gate as the JAX package).

Audio: Mimi encode/decode on the codec parameters' device, with inputs
padded to 25-frame (2 s) buckets as in the JAX package.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from csm_torch.codec import mimi as mimi_mod

LLAMA_BOS = 128_000
LLAMA_EOS = 128_001


class ByteTokenizer:
    """Deterministic byte-level tokenizer: id = 2 + byte, BOS 0, EOS 1."""

    bos_id = 0
    eos_id = 1

    def encode(self, text: str) -> list[int]:
        return [self.bos_id] + [2 + b for b in text.encode("utf-8")] + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i - 2 for i in ids if i >= 2).decode("utf-8", errors="replace")


class LlamaTokenizer:
    """Hugging Face Llama-3.2 tokenizer with BOS/EOS wrapping."""

    def __init__(self, hf_tokenizer):
        self._tok = hf_tokenizer
        self.bos_id = hf_tokenizer.bos_token_id or LLAMA_BOS
        self.eos_id = hf_tokenizer.eos_token_id or LLAMA_EOS

    def encode(self, text: str) -> list[int]:
        ids = self._tok.encode(text, add_special_tokens=False)
        return [self.bos_id] + list(ids) + [self.eos_id]

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode([i for i in ids if i not in (self.bos_id, self.eos_id)])


def load_text_tokenizer(
    name: str = "meta-llama/Llama-3.2-1B", allow_byte_fallback: Optional[bool] = None
):
    """The Llama-3.2 tokenizer from the local HF cache; the byte fallback
    only when explicitly allowed (real weights fed byte ids speak garbage)."""
    try:
        from transformers import AutoTokenizer

        return LlamaTokenizer(AutoTokenizer.from_pretrained(name, local_files_only=True))
    except Exception as e:  # missing package, cold cache: both end here
        if allow_byte_fallback is None:
            allow_byte_fallback = os.environ.get(
                "CSM_TPU_ALLOW_BYTE_TOKENIZER", ""
            ).lower() in ("1", "true", "yes")
        if not allow_byte_fallback:
            raise RuntimeError(
                f"could not load the '{name}' tokenizer from the local HF cache "
                f"({type(e).__name__}: {e}). Pre-populate the cache, pass an "
                "explicit text_tokenizer, or opt into the byte fallback with "
                "CSM_TPU_ALLOW_BYTE_TOKENIZER=1."
            ) from e
        print(
            f"WARNING: '{name}' tokenizer unavailable: using the byte-level "
            "fallback; token ids will not match the Llama-3.2 vocabulary.",
            file=sys.stderr,
            flush=True,
        )
        return ByteTokenizer()


def _bucket_frames(n_frames: int) -> int:
    return max(25, -(-n_frames // 25) * 25)


class MimiAudioTokenizer:
    """Mimi encode/decode as an audio tokenizer on the parameters' device."""

    def __init__(self, params, cfg=None, num_quantizers: Optional[int] = None):
        self.cfg = cfg or mimi_mod.CSM_MIMI_CONFIG
        self.params = params
        self.sample_rate = self.cfg.sample_rate
        self.num_quantizers = num_quantizers or self.cfg.num_quantizers
        self.device = params["quantizer"].semantic.embed_sum.device

    @torch.inference_mode()
    def encode(self, audio: np.ndarray) -> np.ndarray:
        """(T,) float waveform → (K, F) int32 codes.  Samples pad to a
        25-frame bucket; the encoder is causal, so the padding cannot change
        the codes of the real frames."""
        spf = self.cfg.samples_per_frame
        n = len(audio)
        F = max(1, -(-n // spf))
        buf = np.zeros(_bucket_frames(F) * spf, np.float32)
        buf[:n] = audio
        x = torch.from_numpy(buf[None]).to(self.device)
        codes = mimi_mod.mimi_encode(self.params, x, self.cfg, self.num_quantizers)
        return codes[0, :, :F].cpu().numpy()

    @torch.inference_mode()
    def decode(self, codes: np.ndarray) -> np.ndarray:
        """(K, F) int codes → (F * samples_per_frame,) float32 waveform;
        codes clamp to the codebook (the CSM audio vocab has 3 more ids)."""
        K, F = codes.shape
        buf = np.zeros((K, _bucket_frames(F)), np.int64)
        buf[:, :F] = np.minimum(codes, self.cfg.codebook_size - 1)
        c = torch.from_numpy(buf[None]).to(self.device)
        audio = mimi_mod.mimi_decode(self.params, c, self.cfg)[0]
        return audio[: F * self.cfg.samples_per_frame].float().cpu().numpy()

    def stream_decoder(self):
        """A stateful streaming decoder (codec/streaming.py): O(chunk)
        codec work a chunk, the samples of the whole-clip ``decode``."""
        from csm_torch.codec.streaming import MimiStreamDecoder

        return MimiStreamDecoder(self.params, self.cfg)

    def stream_encoder(self):
        """A stateful streaming encoder (live audio in): chunks of a
        multiple of 1920 samples give the whole-clip ``encode``'s codes."""
        from csm_torch.codec.streaming import MimiStreamEncoder

        return MimiStreamEncoder(self.params, self.cfg, num_quantizers=self.num_quantizers)
