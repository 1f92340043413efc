"""Mimi neural audio codec, PyTorch.

24 kHz mono waveform ↔ 32 RVQ codebooks at 12.5 Hz (80 ms frames):

    encode:  SEANet encoder (→25 Hz) → 8-layer transformer → stride-2 causal
             downsample (→12.5 Hz) → split RVQ (1 semantic + 31 acoustic)
    decode:  split RVQ embed-sum → depthwise stride-2 transposed upsample
             (→25 Hz) → 8-layer transformer → SEANet decoder (→24 kHz)

Same parameter tree as the JAX package's ``codec/mimi.py``; a public Mimi
checkpoint loads through ``codec/convert.py``.  The streaming codec
(``codec/streaming.py``, ROADMAP.md A.14) waits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from csm_torch.codec.convs import (
    ConvParams,
    causal_conv1d,
    causal_conv_transpose1d,
    conv1d_output_length,
)
from csm_torch.codec.rvq import RVQParams, SplitRVQParams, split_rvq_decode, split_rvq_encode
from csm_torch.codec.seanet import (
    encoded_length,
    seanet_decode,
    seanet_decoder_init,
    seanet_encode,
    seanet_encoder_init,
)
from csm_torch.codec.transformer import (
    MimiTransformerConfig,
    mimi_transformer_apply,
    mimi_transformer_init,
)


@dataclasses.dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24_000
    frame_rate: float = 12.5
    hidden_size: int = 512
    num_filters: int = 64
    codebook_size: int = 2048
    codebook_dim: int = 256
    num_quantizers: int = 32
    num_semantic_quantizers: int = 1
    transformer: MimiTransformerConfig = MimiTransformerConfig()

    @property
    def samples_per_frame(self) -> int:
        return int(self.sample_rate / self.frame_rate)  # 1920 (80 ms)


CSM_MIMI_CONFIG = MimiConfig()


def mimi_encode(
    params: dict,
    audio: torch.Tensor,
    cfg: MimiConfig = CSM_MIMI_CONFIG,
    num_quantizers: Optional[int] = None,
) -> torch.Tensor:
    """(B, T) float waveform at 24 kHz → (B, K, T_frames) int32 codes."""
    latents = seanet_encode(params["encoder"], audio)
    latents = mimi_transformer_apply(params["encoder_transformer"], cfg.transformer, latents)
    latents = causal_conv1d(latents, params["downsample"], stride=2)
    return split_rvq_encode(params["quantizer"], latents, num_quantizers)


def mimi_decode(params: dict, codes: torch.Tensor, cfg: MimiConfig = CSM_MIMI_CONFIG) -> torch.Tensor:
    """(B, K, T_frames) int codes → (B, T) float waveform at 24 kHz."""
    latents = split_rvq_decode(params["quantizer"], codes)
    latents = causal_conv_transpose1d(
        latents, params["upsample"], stride=2, groups=cfg.hidden_size
    )
    latents = mimi_transformer_apply(params["decoder_transformer"], cfg.transformer, latents)
    return seanet_decode(params["decoder"], latents)


def mimi_num_frames(audio_len: int) -> int:
    """Frames produced for an input length (encoder chain + downsample)."""
    return conv1d_output_length(encoded_length(audio_len), 4, 2)


def mimi_init(
    gen: torch.Generator, cfg: MimiConfig = CSM_MIMI_CONFIG, dtype=torch.float32, device="cpu"
) -> dict:
    """Random Mimi parameters from ``gen`` (real use loads a checkpoint)."""
    H, D, C = cfg.hidden_size, cfg.codebook_dim, cfg.codebook_size

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    def rvq_init(Q):
        return RVQParams(
            input_proj=(randn(H, D) / H**0.5).to(dtype),
            output_proj=(randn(D, H) / D**0.5).to(dtype),
            embed_sum=randn(Q, C, D).to(dtype),
            cluster_usage=torch.ones((Q, C), dtype=dtype, device=device),
        )

    return {
        "encoder": seanet_encoder_init(gen, cfg.num_filters, H, dtype, device),
        "encoder_transformer": mimi_transformer_init(gen, cfg.transformer, dtype, device),
        "downsample": ConvParams((randn(4, H, H) / (4 * H) ** 0.5).to(dtype), None),
        "upsample": ConvParams((randn(4, 1, H) / 2.0).to(dtype), None),
        "decoder_transformer": mimi_transformer_init(gen, cfg.transformer, dtype, device),
        "decoder": seanet_decoder_init(gen, cfg.num_filters, H, dtype, device),
        "quantizer": SplitRVQParams(
            semantic=rvq_init(cfg.num_semantic_quantizers),
            acoustic=rvq_init(cfg.num_quantizers - cfg.num_semantic_quantizers),
        ),
    }
