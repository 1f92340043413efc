"""Mimi bottleneck transformer (encoder and decoder side).

8 layers, d=512, 8-head MHA, plain RoPE (θ=10000, rotate-half), pre-LayerNorm
with bias, LayerScale residual gains, exact-GELU MLP, causal attention over a
sliding window of 250.  Same layer-stacked parameters as the JAX package's
``codec/transformer.py``; the layer loop is a Python loop.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MimiTransformerConfig:
    num_layers: int = 8
    num_heads: int = 8
    embed_dim: int = 512
    intermediate_dim: int = 2048
    head_dim: int = 64
    rope_theta: float = 10_000.0
    sliding_window: int = 250
    norm_eps: float = 1e-5


@functools.lru_cache(maxsize=8)
def _rope_tables(head_dim: int, theta: float, length: int):
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    ang = np.outer(np.arange(length, dtype=np.float64), inv)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (S, D/2); rotate-half, in float32."""
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _layer_norm(x, scale, bias, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def mimi_transformer_apply(
    params: dict, cfg: MimiTransformerConfig, h: torch.Tensor
) -> torch.Tensor:
    """Full-sequence pass, (B, S, E) → (B, S, E); position i attends to j
    in (i - window, i]."""
    B, S, E = h.shape
    H, D = cfg.num_heads, cfg.head_dim
    cos_np, sin_np = _rope_tables(D, cfg.rope_theta, max(S, 1))
    cos = torch.from_numpy(cos_np[:S]).to(h.device)
    sin = torch.from_numpy(sin_np[:S]).to(h.device)
    i = torch.arange(S, device=h.device)[:, None]
    j = torch.arange(S, device=h.device)[None, :]
    mask = (j <= i) & (j > i - cfg.sliding_window)  # (S, S)
    scale = 1.0 / float(np.sqrt(np.float32(D)))

    layers = params["layers"]
    for layer in range(cfg.num_layers):
        lp = {name: t[layer] for name, t in layers.items()}
        x = _layer_norm(h, lp["ln1_scale"], lp["ln1_bias"], cfg.norm_eps)
        q = _apply_rope((x @ lp["wq"]).reshape(B, S, H, D), cos, sin)
        k = _apply_rope((x @ lp["wk"]).reshape(B, S, H, D), cos, sin)
        v = (x @ lp["wv"]).reshape(B, S, H, D)
        scores = torch.einsum("bshd,bthd->bhst", q.float() * scale, k.float())
        scores = scores.masked_fill(~mask, -1e30)
        attn = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v.float())
        h = h + lp["attn_scale"] * (attn.reshape(B, S, E).to(h.dtype) @ lp["wo"])
        x = _layer_norm(h, lp["ln2_scale"], lp["ln2_bias"], cfg.norm_eps)
        h = h + lp["mlp_scale"] * (F.gelu(x @ lp["fc1"]) @ lp["fc2"])
    return h


def mimi_transformer_init(gen, cfg: MimiTransformerConfig, dtype=torch.float32, device="cpu"):
    E, I, L = cfg.embed_dim, cfg.intermediate_dim, cfg.num_layers

    def init(shape, fan_in):
        w = torch.randn(shape, generator=gen, device=device) / fan_in**0.5
        return w.to(dtype)

    def full(value):
        return torch.full((L, E), value, dtype=dtype, device=device)

    return {
        "layers": {
            "wq": init((L, E, E), E),
            "wk": init((L, E, E), E),
            "wv": init((L, E, E), E),
            "wo": init((L, E, E), E),
            "fc1": init((L, E, I), E),
            "fc2": init((L, I, E), I),
            "ln1_scale": full(1.0),
            "ln1_bias": full(0.0),
            "ln2_scale": full(1.0),
            "ln2_bias": full(0.0),
            "attn_scale": full(0.01),
            "mlp_scale": full(0.01),
        }
    }
