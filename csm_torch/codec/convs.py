"""Causal 1-D convolutions for the Mimi codec, channels-last.

Same semantics and parameter layout as the JAX package's ``codec/convs.py``:

  * causal Conv1d: left-pad ``(k-1)*dilation + 1 - stride`` zeros plus the
    right "extra padding" that completes the last window (Encodec's
    ``pad_for_conv1d`` rule);
  * causal ConvTranspose1d: full transposed conv, then trim ``k - stride``
    samples from the right.

Activations are (batch, time, channels) at the public functions; weights
are 'WIO' ``(k, in_ch // groups, out_ch)``, with the transposed conv's
kernel stored already flipped (the JAX layout), and are rearranged to
PyTorch's layout at each call.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F


class ConvParams(NamedTuple):
    w: torch.Tensor  # (k, in_ch // groups, out_ch)
    b: Optional[torch.Tensor]  # (out_ch,) or None


def causal_conv1d_padding(
    length: int, kernel_size: int, stride: int, dilation: int = 1
) -> tuple[int, int]:
    """(left, right) zero padding for a causal Mimi conv at a static length."""
    k_eff = (kernel_size - 1) * dilation + 1
    padding_total = k_eff - stride
    n_frames = math.ceil((length - k_eff + padding_total) / stride + 1) - 1
    ideal_length = n_frames * stride + k_eff - padding_total
    return padding_total, ideal_length - length


def conv1d_output_length(length: int, kernel_size: int, stride: int, dilation: int = 1) -> int:
    left, right = causal_conv1d_padding(length, kernel_size, stride, dilation)
    k_eff = (kernel_size - 1) * dilation + 1
    return (length + left + right - k_eff) // stride + 1


def conv_weight(p: ConvParams, dtype) -> torch.Tensor:
    """The conv's weight in PyTorch's layout (C_out, C_in // groups, k)."""
    return p.w.to(dtype).permute(2, 1, 0)


def conv_transpose_weight(p: ConvParams, dtype, groups: int = 1) -> torch.Tensor:
    """The transposed conv's weight in PyTorch's layout (C_in, C_out //
    groups, k): the stored kernel is pre-flipped for the JAX package's
    input-dilated conv, so it is flipped back."""
    k, cin_g, cout = p.w.shape
    w = p.w.to(dtype).flip(0)  # (k, C_in // groups, C_out)
    w = w.reshape(k, cin_g, groups, cout // groups).permute(2, 1, 3, 0)
    return w.reshape(groups * cin_g, cout // groups, k)


def causal_conv1d(
    x: torch.Tensor, p: ConvParams, stride: int = 1, dilation: int = 1, groups: int = 1
) -> torch.Tensor:
    """Causal conv. x: (B, T, C_in) → (B, T', C_out)."""
    k = p.w.shape[0]
    left, right = causal_conv1d_padding(x.shape[1], k, stride, dilation)
    xc = F.pad(x.transpose(1, 2), (left, right))
    b = None if p.b is None else p.b.to(x.dtype)
    out = F.conv1d(xc, conv_weight(p, x.dtype), b, stride=stride, dilation=dilation, groups=groups)
    return out.transpose(1, 2)


def causal_conv_transpose1d(
    x: torch.Tensor, p: ConvParams, stride: int, groups: int = 1
) -> torch.Tensor:
    """Causal transposed conv with right-trim. x: (B, T, C_in) →
    (B, T*stride, C_out).

    The JAX package runs this as an input-dilated conv with the stored
    (pre-flipped) kernel; a transposed conv with the kernel flipped back
    computes the same sums."""
    k = p.w.shape[0]
    b = None if p.b is None else p.b.to(x.dtype)
    out = F.conv_transpose1d(x.transpose(1, 2), conv_transpose_weight(p, x.dtype, groups), b,
                             stride=stride, groups=groups)
    # full length = (T-1)*stride + k; causal trim k - stride from the right
    return out[:, :, : out.shape[2] - (k - stride)].transpose(1, 2)
