"""Centred STFT / iSTFT (periodic Hann window), in PyTorch.

The counterpart of the JAX package's ``watermarking/stft.py``, with its
conventions: the input is right-padded to a window multiple and
reflect-padded by half a window at each end; the magnitude is zero-safe
(``sqrt(x²+eps) − sqrt(eps)`` where the power is exactly 0); the phase is
``atan2``.  The inverse recombines magnitude and phase, overlap-adds with
squared-window normalisation (``torch.istft`` semantics) and trims the pad.

The DFT is one matmul against a (n_fft, F) real/imaginary basis, as in the
JAX package.  Frames come from ``Tensor.unfold``; the overlap-add is
``F.fold``, which sums each output sample's frames in a fixed order (no
atomics), so two runs on the card give the same bits.  Both functions run
under ``float32_math``: IEEE float32 whatever precision the process asked
its matmuls for.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_math():
    """IEEE float32 for the body of the block, on the card and on the CPU:
    no TF32 or bf16 inside cuDNN's or oneDNN's convolutions and matmuls,
    whatever the process set (``torch.set_float32_matmul_precision("high")``
    makes oneDNN round float32 operands to TF32 where the CPU has it).  The
    previous settings come back after."""
    b = torch.backends
    knobs = (b.cudnn.conv, b.cuda.matmul, b.mkldnn.conv, b.mkldnn.matmul)
    keep = [k.fp32_precision for k in knobs]
    for k in knobs:
        k.fp32_precision = "ieee"
    try:
        yield
    finally:
        for k, v in zip(knobs, keep):
            k.fp32_precision = v


@functools.lru_cache(maxsize=8)
def _basis(n_fft: int):
    """Real-DFT analysis basis (n_fft, F), F = n_fft//2 + 1 (host numpy)."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _hann(win: int):
    # periodic hann, matching torch.hann_window
    n = np.arange(win)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32)


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(device=like.device, dtype=like.dtype)


@float32_math()
def stft(x: torch.Tensor, n_fft: int = 1024, hop: int = 512):
    """(B, T) → (magnitude, phase), each (B, F, n_frames)."""
    T = x.shape[1]
    x = F.pad(x, (0, n_fft - T % n_fft))
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = x.unfold(1, n_fft, hop) * _const(_hann(n_fft), x)  # (B, N, n_fft)
    cos_b, sin_b = _basis(n_fft)
    real = torch.matmul(frames, _const(cos_b, x))  # (B, N, F)
    imag = torch.matmul(frames, _const(sin_b, x))
    sq = real * real + imag * imag
    eps = torch.where(sq == 0, 1e-24, 0.0).to(sq.dtype)
    mag = torch.sqrt(sq + eps) - torch.sqrt(eps)
    phase = torch.atan2(imag, real)
    return mag.transpose(1, 2), phase.transpose(1, 2)


@float32_math()
def istft(mag: torch.Tensor, phase: torch.Tensor, num_samples: int,
          n_fft: int = 1024, hop: int = 512) -> torch.Tensor:
    """(B, F, n_frames) magnitude and phase → (B, num_samples) waveform."""
    B, _, N = mag.shape
    real = (mag * torch.cos(phase)).transpose(1, 2)  # (B, N, F)
    imag = (mag * torch.sin(phase)).transpose(1, 2)
    cos_b, sin_b = _basis(n_fft)
    # x_n = (1/N) Σ_k w_k (Re_k cos θ − Im_k sin θ); sin_b holds −sin
    w = np.full(n_fft // 2 + 1, 2.0, np.float32)
    w[0] = 1.0
    w[-1] = 1.0 if n_fft % 2 == 0 else 2.0
    w = _const(w, mag)
    frames = (torch.matmul(real * w, _const(cos_b.T, mag))
              + torch.matmul(imag * w, _const(sin_b.T, mag))) / n_fft  # (B, N, n_fft)
    win = _const(_hann(n_fft), mag)
    frames = frames * win
    T_pad = n_fft + (N - 1) * hop

    def overlap_add(cols):  # (B', n_fft, N) → (B', T_pad)
        return F.fold(cols, (1, T_pad), (1, n_fft), stride=(1, hop))[:, 0, 0]

    out = overlap_add(frames.transpose(1, 2))
    wsum = overlap_add((win * win)[None, :, None].expand(1, n_fft, N))
    out = out / wsum.clamp_min(1e-11)
    return out[:, n_fft // 2:][:, :num_samples]
