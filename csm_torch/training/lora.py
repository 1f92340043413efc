"""LoRA: low-rank adaptation as a parameter-tree transform.

The counterpart of the JAX package's ``training/lora.py``:
  * adapters A ~ N(0, 1/sqrt(in)) of shape (in, r), B = 0 of shape (r, out),
    scaling alpha/r; default targets q_proj/v_proj, optional k/o and the
    gate/up/down MLP projections, optional layer subset;
  * the adapters are LAYER-STACKED like the base weights, (L, in, r) and
    (L, r, out); a layer outside ``target_layers`` has A = 0, so both its
    gradients vanish and it stays frozen while every layer runs the same
    code;
  * ``merge_lora`` folds W' = W + (A @ B) · scaling into a full tree for
    export; ``fuse_lora_bank`` stacks several adapters into the serving
    bank that ``BatchedServer(adapters=)`` applies per row.

Two differences by design (ROADMAP.md §C.2): ``init_lora_params`` draws A
from a ``torch.Generator`` (the JAX package's ``jax.random`` draws are not
reproduced; B starts at zero, so both start from the base model), and
``save_lora`` writes a ``.safetensors`` file of flat names beside the
JAX package's ``lora_metadata.json`` instead of an orbax directory, which
the port neither reads nor writes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Sequence, Tuple

import torch

from csm_torch.models.config import ModelArgs, TransformerConfig
from csm_torch.utils import safetensors
from csm_torch.utils.quantize import (dequantize_weight, dequantize_weight_int4, is_quantized,
                                      is_quantized_int4)

# Reference module names (torchtune convention) → projection names.
MODULE_NAME_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "output_proj": "wo",
    "gate_proj": "w1",
    "up_proj": "w3",
    "down_proj": "w2",
    # already-native names pass through
    "wq": "wq", "wk": "wk", "wv": "wv", "wo": "wo",
    "w1": "w1", "w2": "w2", "w3": "w3",
}

_PROJ_DIMS = {
    # name -> (in_dim, out_dim) as functions of the config
    "wq": lambda c: (c.embed_dim, c.num_heads * c.head_dim),
    "wk": lambda c: (c.embed_dim, c.num_kv_heads * c.head_dim),
    "wv": lambda c: (c.embed_dim, c.num_kv_heads * c.head_dim),
    "wo": lambda c: (c.num_heads * c.head_dim, c.embed_dim),
    "w1": lambda c: (c.embed_dim, c.intermediate_dim),
    "w3": lambda c: (c.embed_dim, c.intermediate_dim),
    "w2": lambda c: (c.intermediate_dim, c.embed_dim),
}

ADAPTER_FILE = "lora.safetensors"
METADATA_FILE = "lora_metadata.json"


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Reference defaults: r=8, alpha=16, q_proj+v_proj."""

    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: Tuple[str, ...] = ("q_proj", "v_proj")
    target_layers: Optional[Tuple[int, ...]] = None
    apply_to_backbone: bool = True
    apply_to_decoder: bool = True

    @property
    def scaling(self) -> float:
        return self.alpha / self.r

    @property
    def projections(self) -> Tuple[str, ...]:
        return tuple(MODULE_NAME_MAP[m] for m in self.target_modules)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "LoRAConfig":
        d = json.loads(s)
        for k in ("target_modules", "target_layers"):
            if d.get(k) is not None:
                d[k] = tuple(d[k])
        return LoRAConfig(**d)


def _init_transformer_lora(generator, cfg: TransformerConfig, lcfg: LoRAConfig, dtype,
                           device) -> dict:
    L = cfg.num_layers
    layer_on = torch.zeros((L,), dtype=torch.float32, device=device)
    for i in range(L) if lcfg.target_layers is None else lcfg.target_layers:
        if 0 <= i < L:
            layer_on[i] = 1.0
    out = {}
    for name in lcfg.projections:
        din, dout = _PROJ_DIMS[name](cfg)
        a = torch.randn((L, din, lcfg.r), generator=generator, device=device) / din**0.5
        a = a * layer_on[:, None, None]  # zero → a frozen layer
        out[name] = {"a": a.to(dtype),
                     "b": torch.zeros((L, lcfg.r, dout), dtype=dtype, device=device)}
    return out


def init_lora_params(generator: torch.Generator, args: ModelArgs, lcfg: LoRAConfig,
                     dtype=torch.float32, device="cpu") -> dict:
    """Adapter tree: {"backbone": {proj: {a, b}}, "decoder": {...}}; A drawn
    from ``generator`` (the backbone's first), B zero."""
    out = {}
    if lcfg.apply_to_backbone:
        out["backbone"] = _init_transformer_lora(generator, args.backbone, lcfg, dtype, device)
    if lcfg.apply_to_decoder:
        out["decoder"] = _init_transformer_lora(generator, args.decoder, lcfg, dtype, device)
    return out


def merge_lora(params: dict, lora: dict, lcfg: LoRAConfig) -> dict:
    """W' = W + (A @ B) · scaling, a full merged tree.  With a quantized
    base each TARGETED projection is dequantized to bf16 before its delta
    is added; untargeted projections keep their stored layout."""
    merged = dict(params)
    for comp in ("backbone", "decoder"):
        if comp not in lora:
            continue
        sub = dict(params[comp])
        for name, ad in lora[comp].items():
            delta = torch.einsum("lir,lro->lio", ad["a"], ad["b"]) * lcfg.scaling
            base = sub[name]
            if is_quantized(base):
                base = dequantize_weight(base, torch.bfloat16)
            elif is_quantized_int4(base):
                base = dequantize_weight_int4(base, torch.bfloat16)
            sub[name] = base + delta.to(base.dtype)
        merged[comp] = sub
    return merged


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def count_params(tree) -> int:
    return sum(t.numel() for t in _leaves(tree))


def parameter_efficiency(params: dict, lora: dict) -> float:
    """The trainable fraction."""
    return count_params(lora) / max(count_params(params), 1)


def interpolate_lora(loras: Sequence[dict], weights: Sequence[float]) -> dict:
    """Weighted interpolation of adapter trees (the multi-speaker merge),
    weights normalized to sum to one."""
    assert len(loras) == len(weights) and loras
    total = sum(weights)
    ws = [w / total for w in weights]

    def combine(nodes):
        if isinstance(nodes[0], dict):
            return {k: combine([n[k] for n in nodes]) for k in nodes[0]}
        out = nodes[0] * ws[0]
        for x, w in zip(nodes[1:], ws[1:]):
            out = out + x * w
        return out

    return combine(list(loras))


# ---- save / load ----


def flatten_lora(lora: dict) -> dict:
    """{"backbone.wq.a": tensor, ...}."""
    return {f"{comp}.{name}.{ab}": t for comp, sub in lora.items() for name, ad in sub.items()
            for ab, t in ad.items()}


def unflatten_lora(flat: dict) -> dict:
    out: dict = {}
    for key, t in flat.items():
        comp, name, ab = key.split(".")
        out.setdefault(comp, {}).setdefault(name, {})[ab] = t
    return out


def save_lora(path: str, lora: dict, lcfg: LoRAConfig, args: ModelArgs) -> str:
    """An adapter directory: ``lora_metadata.json`` (the JAX package's keys)
    and ``lora.safetensors`` of flat names."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    safetensors.write(os.path.join(path, ADAPTER_FILE),
                      {k: t.detach() for k, t in flatten_lora(lora).items()})
    meta = {
        "lora_config": json.loads(lcfg.to_json()),
        "model_args": json.loads(args.to_json()),
        "num_lora_params": count_params(lora),
    }
    with open(os.path.join(path, METADATA_FILE), "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_lora(path: str, device="cpu") -> Tuple[dict, LoRAConfig, ModelArgs]:
    """(adapter tree on ``device``, its LoRAConfig, the ModelArgs it was
    trained for) from a ``save_lora`` directory."""
    path = os.path.abspath(path)
    flat, _ = safetensors.read(os.path.join(path, ADAPTER_FILE))
    with open(os.path.join(path, METADATA_FILE)) as f:
        meta = json.load(f)
    lora = unflatten_lora({k: t.to(device) for k, t in flat.items()})
    return (lora, LoRAConfig.from_json(json.dumps(meta["lora_config"])),
            ModelArgs.from_json(json.dumps(meta["model_args"])))


# ---- adapter bank (multi-LoRA serving; csm_torch/serving.py) ----

# separate projection -> (fused name, out-column offset fn)
_FUSE_TARGET = {
    "wq": ("wqkv", lambda c: 0),
    "wk": ("wqkv", lambda c: c.num_heads * c.head_dim),
    "wv": ("wqkv", lambda c: (c.num_heads + c.num_kv_heads) * c.head_dim),
    "w1": ("w13", lambda c: 0),
    "w3": ("w13", lambda c: c.intermediate_dim),
    "wo": ("wo", lambda c: 0),
    "w2": ("w2", lambda c: 0),
}

_FUSED_OUT = {
    "wqkv": lambda c: (c.num_heads + 2 * c.num_kv_heads) * c.head_dim,
    "w13": lambda c: 2 * c.intermediate_dim,
    "wo": lambda c: c.embed_dim,
    "w2": lambda c: c.embed_dim,
}

_SEPARATE_OUT = {
    "wq": lambda c: c.num_heads * c.head_dim,
    "wk": lambda c: c.num_kv_heads * c.head_dim,
    "wv": lambda c: c.num_kv_heads * c.head_dim,
    "w1": lambda c: c.intermediate_dim,
    "w3": lambda c: c.intermediate_dim,
    "wo": lambda c: c.embed_dim,
    "w2": lambda c: c.embed_dim,
}


def fuse_lora_bank(adapters, args: ModelArgs, dtype=torch.bfloat16, layout: str = "fused",
                   device=None) -> dict:
    """Stack adapters into a serving BANK.

    ``adapters`` — a list of ``(lora_tree, LoRAConfig)``; they may differ in
    rank, alpha and targets.  Returns {"backbone": {name: {"a", "b"}} or
    None, "decoder": ...} with, per projection of the param layout,

        a: (L, A+1, in, R)    b: (L, A+1, R, out)

    where A = len(adapters), index 0 is the ZERO adapter (the base model),
    R = the largest total rank over adapters (at least 1), and each
    adapter's alpha/r is FOLDED INTO b (the forward uses scale 1).  In the
    ``fused`` layout wq/wk/wv → wqkv and w1/w3 → w13 are rank-CONCATENATED,
    each b block at its projection's out-column offset, so the fused
    adapter is the sum of the separate ones; ``separate`` keeps the
    separate names.  The bank's names must be the param tree's, or the
    forward would skip the adapter: the server checks them."""
    if layout == "separate":
        target = {n: (n, lambda c: 0) for n in _FUSE_TARGET}
        fused_out = _SEPARATE_OUT
    elif layout == "fused":
        target, fused_out = _FUSE_TARGET, _FUSED_OUT
    else:
        raise ValueError(f"layout must be fused|separate, got {layout!r}")
    comps = {"backbone": args.backbone, "decoder": args.decoder}
    touched = {c: set() for c in comps}
    for lora, _cfg in adapters:
        for comp in comps:
            for name in (lora.get(comp) or {}):
                touched[comp].add(target[name][0])

    def total_rank(lora, comp, fused):
        return sum(ad["a"].shape[-1] for name, ad in (lora.get(comp) or {}).items()
                   if target[name][0] == fused)

    bank = {}
    for comp, cfg in comps.items():
        sub = {}
        for fused in sorted(touched[comp]):
            R = max([total_rank(lora, comp, fused) for lora, _ in adapters] + [1])
            out_dim = fused_out[fused](cfg)
            in_dim = (cfg.num_heads * cfg.head_dim if fused == "wo"
                      else cfg.intermediate_dim if fused == "w2" else cfg.embed_dim)
            L = cfg.num_layers
            a_bank = torch.zeros((L, len(adapters) + 1, in_dim, R), dtype=dtype, device=device)
            b_bank = torch.zeros((L, len(adapters) + 1, R, out_dim), dtype=dtype, device=device)
            for i, (lora, lcfg) in enumerate(adapters, start=1):
                r0 = 0
                for name, ad in sorted((lora.get(comp) or {}).items()):
                    tgt, off_fn = target[name]
                    if tgt != fused:
                        continue
                    r, off = ad["a"].shape[-1], off_fn(cfg)
                    dout = ad["b"].shape[-1]
                    a_bank[:, i, :, r0 : r0 + r] = ad["a"].to(device=a_bank.device, dtype=dtype)
                    b = (ad["b"].to(a_bank.device) * lcfg.scaling).to(dtype)
                    b_bank[:, i, r0 : r0 + r, off : off + dout] = b
                    r0 += r
            sub[fused] = {"a": a_bank, "b": b_bank}
        bank[comp] = sub or None
    return bank


def bank_shapes(bank: dict) -> dict:
    """{(component, name, "a"|"b"): shape}: two banks of equal shapes can be
    copied into one another in place."""
    return {(comp, name, ab): tuple(t.shape) for comp, sub in bank.items() if sub
            for name, ad in sub.items() for ab, t in ad.items()}
