"""SEANet convolutional encoder/decoder for the Mimi codec.

24 kHz mono waveform ↔ 512-d latents at 25 Hz.  Encoder: init conv (1→64,
k7), four [residual unit → ELU → strided conv] stages with ratios
(4, 5, 6, 8) doubling channels, then ELU + final conv (1024→512, k3).  The
decoder mirrors it with transposed convs and ratios (8, 6, 5, 4).  Residual
unit: ELU → conv k3 (C→C/2) → ELU → conv k1 (C/2→C) + identity.  Same
parameter tree as the JAX package's ``codec/seanet.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from csm_torch.codec.convs import (
    ConvParams,
    causal_conv1d,
    causal_conv_transpose1d,
    conv1d_output_length,
)

ENCODER_RATIOS = (4, 5, 6, 8)
DECODER_RATIOS = (8, 6, 5, 4)


def _res_unit(x: torch.Tensor, conv1: ConvParams, conv2: ConvParams) -> torch.Tensor:
    y = causal_conv1d(F.elu(x), conv1)
    y = causal_conv1d(F.elu(y), conv2)
    return x + y


def seanet_encode(params: dict, audio: torch.Tensor) -> torch.Tensor:
    """(B, T) waveform → (B, T/960, 512) latents at 25 Hz."""
    x = causal_conv1d(audio[..., None], params["init"])
    for blk, stride in zip(params["blocks"], ENCODER_RATIOS):
        x = _res_unit(x, blk["res_conv1"], blk["res_conv2"])
        x = causal_conv1d(F.elu(x), blk["down"], stride=stride)
    return causal_conv1d(F.elu(x), params["final"])


def seanet_decode(params: dict, latents: torch.Tensor) -> torch.Tensor:
    """(B, F, 512) latents at 25 Hz → (B, F*960) waveform."""
    x = causal_conv1d(latents, params["init"])
    for blk, stride in zip(params["blocks"], DECODER_RATIOS):
        x = causal_conv_transpose1d(F.elu(x), blk["up"], stride=stride)
        x = _res_unit(x, blk["res_conv1"], blk["res_conv2"])
    x = causal_conv1d(F.elu(x), params["final"])
    return x[..., 0]


def encoded_length(audio_len: int) -> int:
    """Number of 25 Hz latent frames the encoder produces."""
    n = conv1d_output_length(audio_len, 7, 1)
    for stride in ENCODER_RATIOS:
        n = conv1d_output_length(n, 2 * stride, stride)
    return conv1d_output_length(n, 3, 1)


def _conv_init(gen, k, cin, cout, dtype, device):
    w = torch.randn((k, cin, cout), generator=gen, device=device) / (k * cin) ** 0.5
    return ConvParams(w.to(dtype), torch.zeros((cout,), dtype=dtype, device=device))


def seanet_encoder_init(gen, num_filters=64, hidden=512, dtype=torch.float32, device="cpu"):
    c = num_filters
    params = {"init": _conv_init(gen, 7, 1, c, dtype, device)}
    blocks = []
    for stride in ENCODER_RATIOS:
        blocks.append({
            "res_conv1": _conv_init(gen, 3, c, c // 2, dtype, device),
            "res_conv2": _conv_init(gen, 1, c // 2, c, dtype, device),
            "down": _conv_init(gen, 2 * stride, c, 2 * c, dtype, device),
        })
        c *= 2
    params["blocks"] = blocks
    params["final"] = _conv_init(gen, 3, c, hidden, dtype, device)
    return params


def seanet_decoder_init(gen, num_filters=64, hidden=512, dtype=torch.float32, device="cpu"):
    c = num_filters * 16
    params = {"init": _conv_init(gen, 7, hidden, c, dtype, device)}
    blocks = []
    for stride in DECODER_RATIOS:
        blocks.append({
            "up": _conv_init(gen, 2 * stride, c, c // 2, dtype, device),
            "res_conv1": _conv_init(gen, 3, c // 2, c // 4, dtype, device),
            "res_conv2": _conv_init(gen, 1, c // 4, c // 2, dtype, device),
        })
        c //= 2
    params["blocks"] = blocks
    params["final"] = _conv_init(gen, 3, c, 1, dtype, device)
    return params
