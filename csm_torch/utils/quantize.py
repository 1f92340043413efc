"""Weight-only quantization for inference: int8 per out-channel and grouped
int4, in the JAX package's formats, byte for byte.

int8: each (..., in, out) projection becomes
``{"w8": int8 (..., in, out), "scale": bf16 (..., 1, out)}`` with symmetric
per-out-channel scales.

int4: ``{"w4p": uint8 (..., in/2, out), "scale4": bf16 (..., in/gs, out)}``.
Nibbles are two's-complement int4 (q in [-7, 7]) packed over ADJACENT INPUT
ROWS: byte row r holds input row 2r in the low nibble and input row 2r + 1
in the high nibble.  Scales are per (group of ``gs`` input rows,
out-channel), ``gs = min(128, in)``; the group size is not stored, it
follows from the shapes (``gs = 2 · w4p.rows / scale4.groups``).

Norms, embeddings, heads and the backbone→decoder projection keep their
dtype.  The layer forward (models/llama.py) consumes both formats: int8
through a matmul on the converted weights, int4 through
``ops/int4_matmul.int4_matmul`` (the fused-dequant CUDA kernel).
"""

from __future__ import annotations

import numpy as np
import torch

QUANTIZED_PROJS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
_ALL_PROJS = QUANTIZED_PROJS + ("wqkv", "w13")
INT4_GROUP_SIZE = 128


def host_tensor(x) -> torch.Tensor:
    """A numpy (or array-protocol) array → a CPU tensor holding a copy of
    it; bfloat16 arrays (ml_dtypes) keep their bits.  Tensors pass
    through."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------- int8


def quantize_weight(w: torch.Tensor) -> dict:
    """(..., in, out) float → {"w8", "scale"} with per-out-channel scales."""
    wf = w.float()
    amax = wf.abs().amax(dim=-2, keepdim=True)  # (..., 1, out)
    scale = amax.clamp_min(1e-8) / 127.0
    w8 = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"w8": w8, "scale": scale.to(torch.bfloat16)}


def dequantize_weight(q: dict, dtype=torch.float32) -> torch.Tensor:
    return (q["w8"].float() * q["scale"].float()).to(dtype)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "w8" in w


def quantize_transformer(tp: dict) -> dict:
    """int8 every projection of a layer-stacked transformer dict, fused
    names included (per-out-channel scales make quantize(fuse(w)) ==
    fuse(quantize(w))).  Idempotent: a quantized projection is kept."""
    out = dict(tp)
    for name in _ALL_PROJS:
        if name in tp:
            out[name] = tp[name] if is_quantized(tp[name]) else quantize_weight(tp[name])
    return out


def quantize_csm_params(params: dict, components=("backbone", "decoder")) -> dict:
    """int8 the transformer stacks of a CSM tree (embeddings, heads and
    norms keep their dtype)."""
    out = dict(params)
    for comp in components:
        out[comp] = quantize_transformer(params[comp])
    return out


# ---------------------------------------------------------------- int4


def quantize_weight_int4(w: torch.Tensor, group_size: int = INT4_GROUP_SIZE) -> dict:
    """(..., in, out) float → {"w4p", "scale4"} grouped int4."""
    wf = w.float()
    K, N = wf.shape[-2], wf.shape[-1]
    group_size = min(group_size, K)  # tiny test models: one group per column
    if K % group_size or group_size % 2:
        raise ValueError(f"in dim {K} must divide by even group_size {group_size}")
    G = K // group_size
    lead = wf.shape[:-2]
    grp = wf.reshape(*lead, G, group_size, N)
    amax = grp.abs().amax(dim=-2, keepdim=True)  # (..., G, 1, N)
    scale = amax.clamp_min(1e-8) / 7.0
    q = torch.round(grp / scale).clamp(-7, 7).to(torch.int32).reshape(*lead, K, N)
    lo = q[..., 0::2, :] & 0x0F  # two's-complement nibbles
    hi = q[..., 1::2, :] & 0x0F
    return {
        "w4p": (lo | (hi << 4)).to(torch.uint8),
        "scale4": scale[..., 0, :].to(torch.bfloat16),  # (..., G, N)
    }


def unpack_int4(w4p: torch.Tensor) -> torch.Tensor:
    """uint8 (..., K/2, N) → the sign-extended int32 nibbles (..., K, N) in
    input-row order."""
    p = w4p.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = ((p >> 4) ^ 8) - 8
    K2, N = w4p.shape[-2], w4p.shape[-1]
    return torch.stack([lo, hi], dim=-2).reshape(*w4p.shape[:-2], 2 * K2, N)


def dequantize_weight_int4(q: dict, dtype=torch.float32) -> torch.Tensor:
    """Exact inverse of ``quantize_weight_int4``'s packing, times the
    scales."""
    p, scale = q["w4p"], q["scale4"]
    K2, N = p.shape[-2], p.shape[-1]
    G = scale.shape[-2]
    gs = 2 * K2 // G
    lead = p.shape[:-2]
    grp = unpack_int4(p).float().reshape(*lead, G, gs, N)
    w = grp * scale[..., :, None, :].float()
    return w.reshape(*lead, 2 * K2, N).to(dtype)


def is_quantized_int4(w) -> bool:
    return isinstance(w, dict) and "w4p" in w


def quantize_transformer_int4(tp: dict, group_size: int = INT4_GROUP_SIZE) -> dict:
    out = dict(tp)
    for name in _ALL_PROJS:
        if name not in tp or is_quantized_int4(tp[name]):
            continue
        if is_quantized(tp[name]):
            raise ValueError(f"{name} is already int8-quantized; int4 must "
                             "quantize from the float weights")
        out[name] = quantize_weight_int4(tp[name], group_size)
    return out


def quantize_csm_params_int4(
    params: dict, components=("backbone", "decoder"), group_size: int = INT4_GROUP_SIZE
) -> dict:
    """Grouped-int4 the transformer stacks (inference only)."""
    out = dict(params)
    for comp in components:
        out[comp] = quantize_transformer_int4(params[comp], group_size)
    return out


# ------------------------------------------- trees too large for their float form

_QFN = {"int8": quantize_weight, "int4": quantize_weight_int4}


def _cat_parts(parts: list) -> dict:
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}


def init_transformer_quantized(
    generator: torch.Generator, cfg, mode: str = "int8", layers_per_chunk: int = 2, device="cpu"
) -> dict:
    """``models.llama.transformer_init``'s tree, made and quantized a few
    layers at a time on ``device``, so that the float form of a leaf never
    exists whole (the 8B flavor's float tree is over 16 GB).  Weights are
    bf16 normal / sqrt(fan_in), quantized from float32; norms bf16 ones."""
    qfn = _QFN[mode]
    E, I, L = cfg.embed_dim, cfg.intermediate_dim, cfg.num_layers
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    specs = {
        "wq": ((E, qd), E), "wk": ((E, kvd), E), "wv": ((E, kvd), E), "wo": ((qd, E), qd),
        "w1": ((E, I), E), "w3": ((E, I), E), "w2": ((I, E), I),
    }
    tp = {}
    for name, (shape, fan) in sorted(specs.items()):
        parts = []
        for j in range(0, L, layers_per_chunk):
            c = min(layers_per_chunk, L - j)
            w = torch.randn((c, *shape), generator=generator, device=device, dtype=torch.bfloat16)
            parts.append(qfn(w.float() / fan**0.5))
            del w
        tp[name] = _cat_parts(parts)
        del parts
    for name in ("sa_norm", "mlp_norm"):
        tp[name] = torch.ones((L, E), dtype=torch.bfloat16, device=device)
    tp["norm"] = torch.ones((E,), dtype=torch.bfloat16, device=device)
    return tp


def init_csm_params_quantized(
    generator: torch.Generator, args, mode: str = "int8", device="cpu"
) -> dict:
    """The whole CSM tree with its transformer projections quantized as
    they are made; embeddings, heads and norms bf16.  The tree of the JAX
    package's ``init_csm_params_quantized``; the values differ, since the
    two random generators do."""
    bb, dec = args.backbone, args.decoder
    K, V = args.audio_num_codebooks, args.audio_vocab_size

    def emb(shape, fan):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w / fan**0.5).to(torch.bfloat16)

    return {
        "backbone": init_transformer_quantized(generator, bb, mode, device=device),
        "decoder": init_transformer_quantized(generator, dec, mode, device=device),
        "text_embeddings": emb((args.text_vocab_size, bb.embed_dim), bb.embed_dim),
        "audio_embeddings": emb((V * K, bb.embed_dim), bb.embed_dim),
        "projection": emb((bb.embed_dim, dec.embed_dim), bb.embed_dim),
        "codebook0_head": emb((bb.embed_dim, V), bb.embed_dim),
        "audio_head": emb((K - 1, dec.embed_dim, V), dec.embed_dim),
    }


def _put(tree, device):
    if isinstance(tree, dict):
        return {k: _put(v, device) for k, v in tree.items()}
    return host_tensor(tree).to(device)


def quantize_csm_params_streaming(
    host_params: dict,
    mode: str = "int8",
    components=("backbone", "decoder"),
    layers_per_chunk: int = 2,
    device="cpu",
) -> dict:
    """A host CSM tree (numpy arrays or CPU tensors) → the quantized tree on
    ``device``, each layer-stacked projection uploaded and quantized a few
    layers at a time, so the float tree never exists on the device.
    Everything else is uploaded as it is."""
    qfn = _QFN[mode]
    out = {}
    for comp, tree in host_params.items():
        if comp not in components or not isinstance(tree, dict):
            out[comp] = _put(tree, device)
            continue
        ctree = {}
        for name, w in tree.items():
            if name not in _ALL_PROJS:
                ctree[name] = _put(w, device)
                continue
            if getattr(w, "ndim", 0) != 3:
                # another rank means the tree is not the layer-stacked layout
                # this path assumes; uploading it whole would defeat the point
                raise ValueError(
                    f"{comp}.{name}: expected layer-stacked (L, in, out) "
                    f"projection, got ndim={getattr(w, 'ndim', None)}"
                )
            parts = []
            for j in range(0, w.shape[0], layers_per_chunk):
                parts.append(qfn(host_tensor(w[j : j + layers_per_chunk]).to(device)))
            ctree[name] = _cat_parts(parts)
            del parts
        out[comp] = ctree
    return out
