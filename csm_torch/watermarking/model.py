"""Watermark CNNs (the SilentCipher architecture), in PyTorch.

The counterpart of the JAX package's ``watermarking/model.py``:
  * gated conv blocks: BN(conv(x) * sigmoid(gate(x))), BatchNorm folded in;
  * the encoder: 3 gated 3x3 conv layers, 1→32→32 channels, and a linear
    message embedder padded to the full frequency axis;
  * the carrier decoder: 96-channel gated convs → 1 channel, band-limited
    to ``message_band_size`` and RMS/SDR-normalised;
  * the message decoder: 10 gated conv layers at 128 channels over the
    message band, then a linear collapse of the frequency axis.

The convolutions are ``F.conv2d`` (NCHW, OIHW weights); the JAX package's
are ``lax.conv_general_dilated`` in the same layout.  Each gated conv
works in place after its two convolutions, so a layer holds three of its
activations at once (input, conv, gate): the phase-shift search sizes its
chunks from that (watermarker.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class GatedConv(NamedTuple):
    w: torch.Tensor  # (out, in, kh, kw)
    b: torch.Tensor  # (out,)
    gw: torch.Tensor
    gb: torch.Tensor
    bn_scale: torch.Tensor  # gamma / sqrt(var + eps)
    bn_shift: torch.Tensor  # beta - mean * bn_scale


def gated_conv(x: torch.Tensor, p: GatedConv, padding: int = 1) -> torch.Tensor:
    h = F.conv2d(x, p.w, p.b, padding=padding)
    h.mul_(F.conv2d(x, p.gw, p.gb, padding=padding).sigmoid_())
    return h.mul_(p.bn_scale[None, :, None, None]).add_(p.bn_shift[None, :, None, None])


def _stack(x, layers, paddings):
    for p, pad in zip(layers, paddings):
        x = gated_conv(x, p, pad)
    return x


def encoder_apply(params: dict, carrier: torch.Tensor) -> torch.Tensor:
    """(B, 1, F, T) magnitude → (B, 32, F, T) carrier features."""
    return _stack(carrier, params["layers"], [1] * len(params["layers"]))


def transform_message(params: dict, msg: torch.Tensor, n_fft: int) -> torch.Tensor:
    """(B, 1, message_dim, T) one-hot → (B, 1, F, T) band-limited embed."""
    x = torch.einsum("bcdt,de->bcet", msg, params["linear_w"])
    x = x + params["linear_b"][None, None, :, None]
    return F.pad(x, (0, 0, 0, n_fft // 2 + 1 - x.shape[2]))


def carrier_decoder_apply(params: dict, merged: torch.Tensor, message_sdr: float,
                          message_band_size: int) -> torch.Tensor:
    """(B, 96, F, T) → (B, 1, F, T) additive message perturbation,
    band-limited and RMS/SDR-normalised."""
    n = len(params["layers"])
    h = _stack(merged, params["layers"], [1] * (n - 1) + [0])
    h[:, :, message_band_size:] = 0
    rms = torch.sqrt(torch.mean(h * h, dim=2, keepdim=True))
    return h / rms.clamp_min(1e-12) / (10.0 ** (message_sdr / 20.0))


def msg_decoder_apply(params: dict, carrier: torch.Tensor, message_band_size: int):
    """(B, 1, F, T) magnitude → (B, 1, message_dim, T) logits."""
    x = carrier[:, :, :message_band_size, :]
    h = _stack(x, params["layers"], [1] * len(params["layers"]))
    h = torch.einsum("bcft,f->bct", h, params["linear_w"]) + params["linear_b"]
    return h[:, None]


def place_params(params: dict, device) -> dict:
    """A watermark tree with every tensor in float32 on ``device``."""

    def put(t):
        return t.to(device, torch.float32)

    return {name: {k: ([GatedConv(*map(put, g)) for g in v] if k == "layers" else put(v))
                   for k, v in part.items()}
            for name, part in params.items()}


# ---- init / import ----


def _init_gated(gen, cin, cout, k, dtype, device) -> GatedConv:
    scale = 1.0 / math.sqrt(cin * k * k)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device) * scale

    zeros = torch.zeros(cout, dtype=dtype, device=device)
    return GatedConv(w=randn(cout, cin, k, k), b=zeros, gw=randn(cout, cin, k, k),
                     gb=zeros.clone(), bn_scale=torch.ones_like(zeros), bn_shift=zeros.clone())


def init_watermark_params(
    gen: torch.Generator,
    message_dim: int = 5,
    message_band_size: int = 512,
    n_fft: int = 1024,
    enc_layers: int = 3,
    dec_c_layers: int = 4,
    dec_m_layers: int = 10,
    channel_dim: int = 128,
    dtype=torch.float32,
    device="cpu",
) -> dict:
    """Random weights with the reference's layer and channel plan, drawn
    from ``gen`` on ``device`` (real use imports the SilentCipher
    checkpoint).  The values differ from the JAX package's random init."""

    def gated(cin, cout, k):
        return _init_gated(gen, cin, cout, k, dtype, device)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    enc = [gated(1, 32, 3)] + [gated(32, 32, 3) for _ in range(enc_layers - 1)]
    dec_c = [gated(96, 96, 3) for _ in range(dec_c_layers - 1)] + [gated(96, 1, 1)]
    dec_m = ([gated(1, channel_dim, 3)]
             + [gated(channel_dim, channel_dim, 3) for _ in range(dec_m_layers - 2)]
             + [gated(channel_dim, message_dim, 3)])
    return {
        "enc_c": {"layers": enc,
                  "linear_w": randn(message_dim, message_band_size) / math.sqrt(message_dim),
                  "linear_b": torch.zeros(message_band_size, dtype=dtype, device=device)},
        "dec_c": {"layers": dec_c},
        "dec_m": {"layers": dec_m,
                  "linear_w": randn(message_band_size) / math.sqrt(message_band_size),
                  "linear_b": torch.zeros((), dtype=dtype, device=device)},
    }


def _conv_indices(state: dict) -> list:
    """The ``main.{i}`` indices that hold a gated conv, in order (the
    message decoder interleaves Dropout modules: its convs sit at odd
    indices)."""
    return sorted({int(k.split(".")[1]) for k in state
                   if k.startswith("main.") and ".conv." in k})


def convert_torch_watermark_state(enc_c: dict, dec_c: dict, dec_m: dict) -> dict:
    """SilentCipher state dicts (enc_c.ckpt, dec_c.ckpt, dec_m_0.ckpt) →
    this layout in float32 on the CPU, BatchNorm running stats folded into
    a scale and a shift."""

    def t(x):
        return torch.as_tensor(x).detach().to("cpu", torch.float32)

    def gated(state, prefix, eps=1e-5):
        # numpy's float32 sqrt, which PyTorch's vectorised one misses by an
        # ulp on some inputs: the fold is the JAX package's to the bit
        n = {k: t(state[f"{prefix}.bn.{k}"]).numpy()
             for k in ("weight", "bias", "running_mean", "running_var")}
        scale = n["weight"] / np.sqrt(n["running_var"] + eps)
        return GatedConv(
            w=t(state[f"{prefix}.conv.weight"]), b=t(state[f"{prefix}.conv.bias"]),
            gw=t(state[f"{prefix}.gate.weight"]), gb=t(state[f"{prefix}.gate.bias"]),
            bn_scale=torch.from_numpy(scale),
            bn_shift=torch.from_numpy(n["bias"] - n["running_mean"] * scale),
        )

    def layers(state):
        return [gated(state, f"main.{i}") for i in _conv_indices(state)]

    return {
        "enc_c": {"layers": layers(enc_c), "linear_w": t(enc_c["linear.weight"]).T.contiguous(),
                  "linear_b": t(enc_c["linear.bias"])},
        "dec_c": {"layers": layers(dec_c)},
        "dec_m": {"layers": layers(dec_m), "linear_w": t(dec_m["linear.weight"])[0].contiguous(),
                  "linear_b": t(dec_m["linear.bias"])[0].contiguous()},
    }
