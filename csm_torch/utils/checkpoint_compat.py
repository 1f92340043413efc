"""CSM checkpoints in the reference's PyTorch/torchtune name space.

The reference distributes CSM-1B as a torch ``state_dict`` with torchtune
names:

    backbone.layers.{i}.attn.{q,k,v,output}_proj.weight
    backbone.layers.{i}.mlp.{w1,w2,w3}.weight
    backbone.layers.{i}.{sa_norm,mlp_norm}.scale
    backbone.norm.scale            (the same for decoder.*)
    text_embeddings.weight, audio_embeddings.weight,
    projection.weight, codebook0_head.weight, audio_head

Two changes of representation happen at import, as in the JAX package's
``utils/checkpoint_compat.py``:
  1. linear weights transpose (out, in) → (in, out), so forward is ``x @ W``;
  2. the q/k projections' output rows are permuted within each head from
     torchtune's interleaved RoPE pairs to the half-split layout of
     ``ops/rope.py``: [0, 2, 4, ..., D-2, 1, 3, ..., D-1].  Half-split pair
     (j, j + D/2) is then interleaved pair (2j, 2j+1), so attention scores
     are the same in exact arithmetic.

Export inverts both.  Trees here hold float32 tensors on the CPU; the
loaders that use them cast and place them.
"""

from __future__ import annotations

from typing import Dict

import torch

from csm_torch.models.config import ModelArgs, TransformerConfig
from csm_torch.utils import safetensors


def interleaved_to_half_perm(head_dim: int) -> torch.Tensor:
    """Head-dim permutation taking the interleaved RoPE layout to half-split."""
    return torch.cat([torch.arange(0, head_dim, 2), torch.arange(1, head_dim, 2)])


def half_to_interleaved_perm(head_dim: int) -> torch.Tensor:
    """The inverse permutation (export direction)."""
    return torch.argsort(interleaved_to_half_perm(head_dim))


def _permute_qk_rows(w: torch.Tensor, num_heads: int, head_dim: int, perm: torch.Tensor):
    """Permute the output rows of a (num_heads*head_dim, in) projection
    within each head."""
    out_dim, in_dim = w.shape
    return w.reshape(num_heads, head_dim, in_dim)[:, perm, :].reshape(out_dim, in_dim)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def convert_transformer(state: Dict, prefix: str, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """One transformer's torchtune tensors → the layer-stacked tree."""
    D = cfg.head_dim
    perm = interleaved_to_half_perm(D)

    def stack(name, fn=lambda w: w.T):
        return torch.stack([fn(_f32(state[f"{prefix}.layers.{i}.{name}"]))
                            for i in range(cfg.num_layers)])

    return {
        "wq": stack("attn.q_proj.weight", lambda w: _permute_qk_rows(w, cfg.num_heads, D, perm).T),
        "wk": stack("attn.k_proj.weight", lambda w: _permute_qk_rows(w, cfg.num_kv_heads, D, perm).T),
        "wv": stack("attn.v_proj.weight"),
        "wo": stack("attn.output_proj.weight"),
        "w1": stack("mlp.w1.weight"),
        "w2": stack("mlp.w2.weight"),
        "w3": stack("mlp.w3.weight"),
        "sa_norm": stack("sa_norm.scale", lambda w: w),
        "mlp_norm": stack("mlp_norm.scale", lambda w: w),
        "norm": _f32(state[f"{prefix}.norm.scale"]),
    }


def convert_torch_state_dict(state: Dict, args: ModelArgs) -> dict:
    """A reference ``state_dict`` → the port's parameter tree (float32 on
    the CPU)."""
    return {
        "backbone": convert_transformer(state, "backbone", args.backbone),
        "decoder": convert_transformer(state, "decoder", args.decoder),
        "text_embeddings": _f32(state["text_embeddings.weight"]),
        "audio_embeddings": _f32(state["audio_embeddings.weight"]),
        "projection": _f32(state["projection.weight"]).T.contiguous(),
        "codebook0_head": _f32(state["codebook0_head.weight"]).T.contiguous(),
        "audio_head": _f32(state["audio_head"]),
    }


def export_transformer(tree: Dict, prefix: str, cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """A layer-stacked tree → torchtune-named flat tensors."""
    D = cfg.head_dim
    perm = half_to_interleaved_perm(D)
    out: Dict[str, torch.Tensor] = {}
    for i in range(cfg.num_layers):
        def w(name):
            return _f32(tree[name][i]).T.contiguous()

        p = f"{prefix}.layers.{i}."
        out[p + "attn.q_proj.weight"] = _permute_qk_rows(w("wq"), cfg.num_heads, D, perm)
        out[p + "attn.k_proj.weight"] = _permute_qk_rows(w("wk"), cfg.num_kv_heads, D, perm)
        out[p + "attn.v_proj.weight"] = w("wv")
        out[p + "attn.output_proj.weight"] = w("wo")
        out[p + "mlp.w1.weight"] = w("w1")
        out[p + "mlp.w2.weight"] = w("w2")
        out[p + "mlp.w3.weight"] = w("w3")
        out[p + "sa_norm.scale"] = _f32(tree["sa_norm"][i])
        out[p + "mlp_norm.scale"] = _f32(tree["mlp_norm"][i])
    out[f"{prefix}.norm.scale"] = _f32(tree["norm"])
    return out


def export_to_torch_names(params: dict, args: ModelArgs) -> Dict[str, torch.Tensor]:
    """The port's (unfused, unquantized) parameter tree → reference-named
    float32 tensors on the CPU."""
    out = export_transformer(params["backbone"], "backbone", args.backbone)
    out.update(export_transformer(params["decoder"], "decoder", args.decoder))
    out["text_embeddings.weight"] = _f32(params["text_embeddings"])
    out["audio_embeddings.weight"] = _f32(params["audio_embeddings"])
    out["projection.weight"] = _f32(params["projection"]).T.contiguous()
    out["codebook0_head.weight"] = _f32(params["codebook0_head"]).T.contiguous()
    out["audio_head"] = _f32(params["audio_head"])
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A ``.safetensors`` file, or a ``torch.save``d dict (read with
    ``weights_only=True``), as a dict of CPU tensors."""
    if path.endswith(".safetensors"):
        return safetensors.read(path)[0]
    return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path: str, args: ModelArgs) -> dict:
    """A reference ``ckpt.pt`` or a ``.safetensors`` file under torchtune
    names → the port's parameter tree (float32 on the CPU)."""
    return convert_torch_state_dict(load_state_dict(path), args)
