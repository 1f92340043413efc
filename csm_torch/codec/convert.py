"""Mimi checkpoints (the Hugging Face ``MimiModel`` layout of the
``kyutai/mimi`` file) → the port's Mimi parameter tree.

The counterpart of the JAX package's ``codec/convert.py``, into the same
layout:
  * Conv1d (out, in, k) → 'WIO' (k, in, out);
  * ConvTranspose1d (in, out/g, k) → the equivalent forward conv's 'WIO'
    (k, in/g, out), its kernel flipped along time (``codec/convs.py``
    flips it back for ``conv_transpose1d``);
  * Linear (out, in) → (in, out).
Trees hold float32 tensors on the CPU; ``load_csm`` places them.
"""

from __future__ import annotations

from typing import Dict

import torch

from csm_torch.codec.convs import ConvParams
from csm_torch.codec.rvq import RVQParams, SplitRVQParams
from csm_torch.utils.checkpoint_compat import load_state_dict


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def _bias(state: Dict, name: str):
    return _f32(state[f"{name}.bias"]) if f"{name}.bias" in state else None


def _conv(state: Dict, name: str, bias: bool = True) -> ConvParams:
    w = _f32(state[f"{name}.weight"])  # (out, in, k)
    return ConvParams(w.permute(2, 1, 0).contiguous(), _bias(state, name) if bias else None)


def _conv_transpose(state: Dict, name: str, groups: int = 1) -> ConvParams:
    """ConvTranspose1d (in, out/g, k) → flipped forward-conv 'WIO'."""
    w = _f32(state[f"{name}.weight"])
    cin, out_pg, k = w.shape
    w = w.reshape(groups, cin // groups, out_pg, k).flip(-1)
    # rhs[t, i_pg, g*out_pg + o] = w[g, i_pg, o, t]
    rhs = w.permute(3, 1, 0, 2).reshape(k, cin // groups, groups * out_pg)
    return ConvParams(rhs.contiguous(), _bias(state, name))


def _seanet_encoder(state: Dict) -> dict:
    # HF MimiEncoder module indices: 0 the first conv; stage i: 3i+1 the
    # resnet block, 3i+3 the down conv; 14 the last conv
    return {
        "init": _conv(state, "encoder.layers.0.conv"),
        "blocks": [{"res_conv1": _conv(state, f"encoder.layers.{3 * i + 1}.block.1.conv"),
                    "res_conv2": _conv(state, f"encoder.layers.{3 * i + 1}.block.3.conv"),
                    "down": _conv(state, f"encoder.layers.{3 * i + 3}.conv")}
                   for i in range(4)],
        "final": _conv(state, "encoder.layers.14.conv"),
    }


def _seanet_decoder(state: Dict) -> dict:
    # 0 the first conv; stage i: 3i+2 the transposed conv, 3i+3 the resnet
    # block; 14 the last conv
    return {
        "init": _conv(state, "decoder.layers.0.conv"),
        "blocks": [{"up": _conv_transpose(state, f"decoder.layers.{3 * i + 2}.conv"),
                    "res_conv1": _conv(state, f"decoder.layers.{3 * i + 3}.block.1.conv"),
                    "res_conv2": _conv(state, f"decoder.layers.{3 * i + 3}.block.3.conv")}
                   for i in range(4)],
        "final": _conv(state, "decoder.layers.14.conv"),
    }


def _transformer(state: Dict, prefix: str, num_layers: int) -> dict:
    def stack(name, transpose=False):
        ws = torch.stack([_f32(state[f"{prefix}.layers.{i}.{name}"]) for i in range(num_layers)])
        return ws.transpose(1, 2).contiguous() if transpose else ws

    return {"layers": {
        "wq": stack("self_attn.q_proj.weight", True),
        "wk": stack("self_attn.k_proj.weight", True),
        "wv": stack("self_attn.v_proj.weight", True),
        "wo": stack("self_attn.o_proj.weight", True),
        "fc1": stack("mlp.fc1.weight", True),
        "fc2": stack("mlp.fc2.weight", True),
        "ln1_scale": stack("input_layernorm.weight"),
        "ln1_bias": stack("input_layernorm.bias"),
        "ln2_scale": stack("post_attention_layernorm.weight"),
        "ln2_bias": stack("post_attention_layernorm.bias"),
        "attn_scale": stack("self_attn_layer_scale.scale"),
        "mlp_scale": stack("mlp_layer_scale.scale"),
    }}


def _rvq(state: Dict, prefix: str, num_q: int) -> RVQParams:
    def stack(name):
        return torch.stack([_f32(state[f"{prefix}.layers.{i}.codebook.{name}"])
                            for i in range(num_q)])

    return RVQParams(
        input_proj=_f32(state[f"{prefix}.input_proj.weight"])[:, :, 0].T.contiguous(),
        output_proj=_f32(state[f"{prefix}.output_proj.weight"])[:, :, 0].T.contiguous(),
        embed_sum=stack("embed_sum"),
        cluster_usage=stack("cluster_usage"),
    )


def convert_mimi_state_dict(state: Dict, num_layers: int = 8, num_quantizers: int = 32) -> dict:
    """HF ``MimiModel`` state_dict → the port's Mimi tree (float32, CPU)."""
    return {
        "encoder": _seanet_encoder(state),
        "encoder_transformer": _transformer(state, "encoder_transformer", num_layers),
        "downsample": _conv(state, "downsample.conv", bias=False),
        "upsample": _conv_transpose(state, "upsample.conv", groups=512),
        "decoder_transformer": _transformer(state, "decoder_transformer", num_layers),
        "decoder": _seanet_decoder(state),
        "quantizer": SplitRVQParams(
            semantic=_rvq(state, "quantizer.semantic_residual_vector_quantizer", 1),
            acoustic=_rvq(state, "quantizer.acoustic_residual_vector_quantizer",
                          num_quantizers - 1),
        ),
    }


def load_mimi_checkpoint(path: str) -> dict:
    """A Mimi checkpoint file (``.safetensors`` in the HF layout, or a
    ``torch.save``d ``.pt``/``.bin``) → the port's Mimi tree."""
    return convert_mimi_state_dict(load_state_dict(path))
