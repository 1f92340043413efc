"""Llama-3.2-style transformer (backbone and audio decoder), PyTorch.

Same parameter layout as the JAX package: a dict of layer-stacked tensors
(leading axis = num_layers), weights stored (in, out) so every projection is
``x @ W``, q/k rows in half-split RoPE order, and the fused inference layout
(``wqkv``, ``w13``) from ``fuse_projections``.  The layer loop is a Python
loop; the KV cache is written in place (ops/kvcache.py).

A projection is a float tensor, an int8 dict ``{"w8", "scale"}`` or a
grouped-int4 dict ``{"w4p", "scale4"}`` (utils/quantize.py); int4 goes
through ``int4_matmul`` (the fused-dequant kernel at M <= 64).

Attention routing (the JAX package's paths on its TPU, but for one):
  * cached S=1 steps → ``decode_gqa_attention`` (the decode kernel); over
    an int8 (QuantKV) cache its int8 form, which reads the codes and scales
    and dequantizes in registers.  The JAX package sends an int8 cache's
    steps to plain attention over the dequantized cache, which XLA fuses
    into one read; a dense copy here would cost a float32 and a bf16 copy
    of the layer's cache a step;
  * ``flash_pos`` given (cached prefill of S >= FLASH_MIN_SEQ over the whole
    cache, or the uncached training pass of T >= FLASH_MIN_SEQ) → the flash
    kernels, masked from positions, forward and backward;
  * everything else (short prefill, the decoder's S=2 call) → plain
    ``gqa_attention`` under the materialized mask.
An int8 cache is dequantized (one layer's temporary) for the flash and
plain routes only.

LoRA adapters run unmerged, as in the JAX package's layer: each targeted
projection adds ``((x @ a) @ b) · scale`` on top of its float, int8 or int4
base, so only the adapters get gradients and no merged weight exists.  An
adapter BANK (training/lora.fuse_lora_bank: per layer (A+1, in, R) and
(A+1, R, out), scaling folded into b) applies each batch row's own adapter
by its id (0 = zeros = the base model).  Adapter-input dropout takes one
mask per (layer, projection), drawn in ``transformer_apply`` before the
layer runs: a mask drawn inside a layer that ``torch.utils.checkpoint``
recomputes would come out different in the recompute when it is drawn from
an explicit generator (checkpoint restores only the global RNG).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from csm_torch.models.config import TransformerConfig
from csm_torch.ops.attention import gqa_attention
from csm_torch.ops.decode_attention import decode_gqa_attention
from csm_torch.ops.flash_attention import flash_gqa_attention
from csm_torch.ops.int4_matmul import int4_matmul
from csm_torch.ops.kvcache import KVCache, Offset, dequantize_kv, layer_half, update_layer
from csm_torch.ops.norms import rms_norm
from csm_torch.ops.rope import apply_rope, rope_at_positions


def transformer_init(
    cfg: TransformerConfig, generator: torch.Generator, dtype=torch.float32, device="cpu"
) -> dict:
    """Random layer-stacked parameters (normal / sqrt(fan_in), unit norms),
    the shapes of the JAX package's ``transformer_init``."""
    E, I, L = cfg.embed_dim, cfg.intermediate_dim, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim

    def init(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / fan_in**0.5).to(dtype)

    return {
        "wq": init((L, E, qd), E),
        "wk": init((L, E, kvd), E),
        "wv": init((L, E, kvd), E),
        "wo": init((L, qd, E), qd),
        "w1": init((L, E, I), E),
        "w3": init((L, E, I), E),
        "w2": init((L, I, E), I),
        "sa_norm": torch.ones((L, E), dtype=dtype, device=device),
        "mlp_norm": torch.ones((L, E), dtype=dtype, device=device),
        "norm": torch.ones((E,), dtype=dtype, device=device),
    }


def fuse_weights(ws: list):
    """Concatenate projections along the out axis; quantized dicts field by
    field (int8 and int4 pack and scale along axes the concat leaves
    alone)."""
    if isinstance(ws[0], dict):
        return {k: torch.cat([w[k] for w in ws], dim=-1) for k in ws[0]}
    return torch.cat(ws, dim=-1)


def fuse_projections(tp: dict) -> dict:
    """wq/wk/wv → wqkv and w1/w3 → w13 (inference layout: the same bytes
    through fewer, larger matmuls)."""
    out = {k: v for k, v in tp.items() if k not in ("wq", "wk", "wv", "w1", "w3")}
    out["wqkv"] = fuse_weights([tp["wq"], tp["wk"], tp["wv"]])
    out["w13"] = fuse_weights([tp["w1"], tp["w3"]])
    return out


class Int8Matmul(torch.autograd.Function):
    """``(x @ w8) * scale`` with a gradient for x only, saving the int8
    weight and its scales: autograd through ``w8.to(x.dtype)`` would keep a
    dequantized float copy of every frozen projection alive until the
    backward (QLoRA training over an int8 base).  The backward repeats the
    forward's rounding order: dx = (g · scale) @ w8ᵀ in x's dtype."""

    @staticmethod
    def forward(ctx, x, w8, scale):
        ctx.save_for_backward(w8, scale)
        return (x @ w8.to(x.dtype)) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        w8, scale = ctx.saved_tensors
        return (g * scale.to(g.dtype)) @ w8.to(g.dtype).T, None, None


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    if isinstance(w, dict) and "w4p" in w:  # grouped int4: fused-dequant kernel
        return int4_matmul(x, w)
    if isinstance(w, dict):  # int8 weight-only, per-out-channel scales
        if torch.is_grad_enabled() and x.requires_grad:
            return Int8Matmul.apply(x, w["w8"], w["scale"])
        return (x @ w["w8"].to(x.dtype)) * w["scale"].to(x.dtype)
    # weights cast to the activation dtype: params may be stored f32 while
    # the compute dtype is bf16
    return x @ w.to(x.dtype)


def _layers(w) -> list:
    """The per-layer views of a layer-stacked leaf (tensor or quantized
    dict).  One ``unbind`` per leaf: its backward stacks the L layer
    gradients in one pass, where L separate ``w[layer]`` slices would each
    add their gradient into a zero tensor the size of the whole stack."""
    if isinstance(w, dict):
        fields = {k: v.unbind(0) for k, v in w.items()}
        return [dict(zip(fields, views)) for views in zip(*fields.values())]
    return list(w.unbind(0))


def _layer_forward(
    h: torch.Tensor,
    lp: dict,
    cfg: TransformerConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask: Optional[torch.Tensor],
    kv_layer: Optional[Tuple[torch.Tensor, torch.Tensor]],
    cache_offset: Optional[Offset],
    flash_pos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    lora: Optional[dict] = None,
    lora_scale: float = 0.0,
    keep: Optional[dict] = None,
    keep_prob: float = 1.0,
    lora_ids: Optional[torch.Tensor] = None,
    shard=None,
    attn_impl=None,
) -> torch.Tensor:
    """One transformer block; writes this layer's K/V into ``kv_layer`` in
    place when given.

    ``lora`` — this layer's adapters {proj: {"a": (in, r), "b": (r, out)}},
    or a bank's {proj: {"a": (A+1, in, R), "b": (A+1, R, out)}} applied by
    the rows' ``lora_ids`` (B,); ``keep`` — {proj: bool mask of x's shape}
    for adapter-input dropout, kept entries scaled by 1/``keep_prob``.

    ``shard`` — the transformer's part of a mesh (parallel/sharding.TransformerShard):
    its FSDP weight slices are gathered here (so a recomputed layer gathers
    again), and under tensor parallelism the layer holds ``1/shard.tp`` of
    the heads and of the FFN, with Megatron's f before each block and the
    all-reduce of g after ``wo`` and ``w2`` (a whole adapter cut to match:
    ``TransformerShard.adapter``).  ``attn_impl(q, k, v)``
    replaces the attention (the ring of parallel/ring_attention.py)."""
    B, S, E = h.shape
    D = cfg.head_dim
    tp = 1
    if shard is not None:
        lp, tp = shard.weights(lp), shard.tp
    Hq, Hkv = cfg.num_heads // tp, cfg.num_kv_heads // tp
    qd, kvd = Hq * D, Hkv * D
    enter = (lambda x: x) if shard is None else shard.enter  # noqa: E731
    leave = (lambda y: y) if shard is None else shard.exit  # noqa: E731

    def proj(x, name):
        y = _proj(x, lp[name])
        ad = None if lora is None else lora.get(name)
        if ad is None:
            return y
        a, b, kp = ad["a"], ad["b"], None if keep is None else keep[name]
        if shard is not None:
            a, b, kp = shard.adapter(name, a, b, kp)
        xa = x if kp is None else torch.where(kp, x / keep_prob, 0.0).to(x.dtype)
        if a.dim() == 3:  # a bank: each row's own adapter, scale folded into b
            a = a.index_select(0, lora_ids).to(x.dtype)  # (B, in, R)
            b = b.index_select(0, lora_ids).to(x.dtype)  # (B, R, out)
            return y + torch.bmm(torch.bmm(xa, a), b) * lora_scale
        return y + ((xa @ a.to(x.dtype)) @ b.to(x.dtype)) * lora_scale

    x = enter(rms_norm(h, lp["sa_norm"], cfg.norm_eps))
    if "wqkv" in lp:
        qkv = proj(x, "wqkv")
        q, k, v = qkv[..., :qd], qkv[..., qd : qd + kvd], qkv[..., qd + kvd :]
    else:
        q, k, v = proj(x, "wq"), proj(x, "wk"), proj(x, "wv")
    q = apply_rope(q.reshape(B, S, Hq, D), cos, sin)
    k = apply_rope(k.reshape(B, S, Hkv, D), cos, sin)
    v = v.reshape(B, S, Hkv, D)

    decode = False
    if kv_layer is not None:
        k, v = update_layer(kv_layer[0], kv_layer[1], k, v, cache_offset)
        decode = S == 1 and flash_pos is None
        if not decode:  # the decode kernel reads an int8 cache as it is
            k, v = dequantize_kv(k, q.dtype), dequantize_kv(v, q.dtype)
    if attn_impl is not None:
        attn = attn_impl(q, k, v.contiguous())
    elif flash_pos is not None:  # q and k leave apply_rope contiguous; v may be a fused slice
        attn = flash_gqa_attention(q, k, v.contiguous(), *flash_pos)
    elif decode:
        attn = decode_gqa_attention(q, k, v, mask)
    else:
        attn = gqa_attention(q, k, v, mask)

    h = h + leave(proj(attn.reshape(B, S, qd), "wo"))

    x = enter(rms_norm(h, lp["mlp_norm"], cfg.norm_eps))
    if "w13" in lp:
        I = cfg.intermediate_dim
        g13 = proj(x, "w13")
        gate, up = F.silu(g13[..., :I]), g13[..., I:]
    else:
        gate, up = F.silu(proj(x, "w1")), proj(x, "w3")
    return h + leave(proj(gate * up, "w2"))


def transformer_apply(
    params: dict,
    cfg: TransformerConfig,
    h: torch.Tensor,
    positions: torch.Tensor,
    mask: Optional[torch.Tensor],
    cache: Optional[KVCache] = None,
    cache_offset: Optional[Offset] = None,
    flash_pos: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    remat: bool = False,
    lora: Optional[dict] = None,
    lora_scale: float = 0.0,
    lora_dropout_rate: float = 0.0,
    lora_generator: Optional[torch.Generator] = None,
    lora_ids: Optional[torch.Tensor] = None,
    shard=None,
    attn_impl=None,
    lora_uniform=None,
) -> Tuple[torch.Tensor, Optional[KVCache]]:
    """Run the transformer.

    Args:
        h: (B, S, E) hidden states.
        positions: (B, S) or (S,) int positions for RoPE.
        mask: (B, S, T) bool attention mask (T = cache length when cached);
            None when ``flash_pos`` is given.
        cache: optional KVCache; new K/V are written IN PLACE at
            ``cache_offset`` (the first column as a Python int, the S
            columns as an int64 device tensor, or each row's column of an
            S=1 step as ``RowOffsets``: ``update_layer``) and attention
            runs over the whole cache.
        flash_pos: optional (q_pos (B, S) int32, kv_pos (T,) | (B, T) int32):
            attend through the flash kernels, masked from positions: over
            the cache when there is one, else over this call's own K/V (the
            training pass gives ``(positions, positions[0])``).
        remat: recompute each layer's activations in the backward pass
            (``torch.utils.checkpoint`` per layer, the counterpart of
            ``jax.checkpoint`` over the JAX package's scanned layer body):
            only the layer inputs are kept between the passes.
        lora: layer-stacked adapters {proj: {"a": (L, in, r), "b": (L, r,
            out)}}, or a bank {proj: {"a": (L, A+1, in, R), "b": (L, A+1,
            R, out)}} with the rows' adapter ids ``lora_ids`` (B,) int64.
        lora_scale: alpha / r (1 for a bank).
        lora_dropout_rate: adapter-input dropout of the uncached (training)
            pass; its masks are drawn from ``lora_generator`` (None: the
            global generator) before each layer runs.
        shard: a mesh's hook of every layer (parallel/sharding.
            TransformerShard): FSDP gathers and tensor parallelism; the
            layer stacks are this rank's slices.
        attn_impl: ``attn_impl(q, k, v)`` in place of the attention
            (ring attention over a ``seq`` axis).
        lora_uniform: ``lora_uniform(layer, shape)`` → the uniforms of a
            dropout mask, in place of the draw from ``lora_generator``
            (a mesh draws the whole batch's and keeps its rows).

    Returns (normed h (B, S, E), the cache or None).
    """
    h = transformer_layers(params, cfg, h, positions, mask, cache, cache_offset, flash_pos,
                           remat, lora, lora_scale, lora_dropout_rate, lora_generator, lora_ids,
                           shard, attn_impl, lora_uniform)
    return rms_norm(h, params["norm"], cfg.norm_eps), cache


def transformer_layers(params, cfg, h, positions, mask, cache=None, cache_offset=None,
                       flash_pos=None, remat=False, lora=None, lora_scale=0.0,
                       lora_dropout_rate=0.0, lora_generator=None, lora_ids=None, shard=None,
                       attn_impl=None, lora_uniform=None, layer_ids=None) -> torch.Tensor:
    """``transformer_apply``'s layers without the final norm (a pipeline
    stage runs its block of layers with this); ``layer_ids`` — the global
    index of each layer, passed to ``lora_uniform`` (default 0..L-1).
    Returns h before the norm."""
    if "wqkv" in params and lora is not None and not set(lora) <= {"wqkv", "w13", "wo", "w2"}:
        raise ValueError(
            "fused projections (fuse_projections) require LoRA adapters to be merged first "
            "(training/lora.merge_lora) or fused into bank form (training/lora.fuse_lora_bank)")
    cos, sin = rope_at_positions(cfg, positions)
    fixed = ("wo", "w2", "sa_norm", "mlp_norm")
    names = (("wqkv",) if "wqkv" in params else ("wq", "wk", "wv")) + (
        ("w13",) if "w13" in params else ("w1", "w3")
    ) + fixed
    stacks = {n: _layers(params[n]) for n in names}
    lora_stacks = None if lora is None else {
        n: {ab: t.unbind(0) for ab, t in ad.items()} for n, ad in lora.items()}
    dropout = lora is not None and lora_dropout_rate > 0.0 and cache is None
    keep_prob = 1.0 - lora_dropout_rate
    n_layers = len(stacks["wo"])
    for layer in range(n_layers):
        lp = {n: stacks[n][layer] for n in names}
        kv_layer = None if cache is None else (layer_half(cache.k, layer), layer_half(cache.v, layer))
        lo = keep = None
        if lora_stacks is not None:
            lo = {n: {ab: v[layer] for ab, v in ad.items()} for n, ad in lora_stacks.items()}
        if dropout:  # drawn here, outside the recomputed layer
            lid = layer if layer_ids is None else layer_ids[layer]
            keep = {n: (torch.rand(shape, generator=lora_generator, device=h.device)
                        if lora_uniform is None else lora_uniform(lid, shape)) < keep_prob
                    for n, ad in lo.items()
                    for shape in [(*h.shape[:-1], ad["a"].shape[-2])]}
        layer_args = (h, lp, cfg, cos, sin, mask, kv_layer, cache_offset, flash_pos, lo,
                      lora_scale, keep, keep_prob, lora_ids,
                      shard, attn_impl)
        if remat and torch.is_grad_enabled():
            h = checkpoint(_layer_forward, *layer_args, use_reentrant=False)
        else:
            h = _layer_forward(*layer_args)
    return h
