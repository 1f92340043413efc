"""CSM parameters as ``.safetensors`` under the reference's torchtune names
(the RoPE row permutation included, ``utils/checkpoint_compat.py``), with
the model args in the file's metadata, as the JAX package's
``utils/safetensors_io.py`` writes them: a file from either package loads
in the other and in the reference."""

from __future__ import annotations

from typing import Optional

from csm_torch.models.config import ModelArgs, csm_1b_args
from csm_torch.utils import safetensors
from csm_torch.utils.checkpoint_compat import convert_torch_state_dict, export_to_torch_names
from csm_torch.utils.device import resolve_device
from csm_torch.utils.params import tree_map


def save_params_safetensors(path: str, params: dict, args: ModelArgs) -> str:
    """Write params (float32) with reference names and ``model_args``."""
    safetensors.write(path, export_to_torch_names(params, args),
                      metadata={"format": "csm-tpu", "model_args": args.to_json()})
    return path


def load_params_safetensors(path: str, args: Optional[ModelArgs] = None,
                            device="cuda") -> tuple[dict, ModelArgs]:
    """A reference-named ``.safetensors`` file → (float32 params on
    ``device``, args); ``args`` None reads them from the metadata, else
    CSM-1B's."""
    state, meta = safetensors.read(path)
    if args is None:
        args = ModelArgs.from_json(meta["model_args"]) if "model_args" in meta else csm_1b_args()
    device = resolve_device(device)
    params = tree_map(lambda t: t.to(device), convert_torch_state_dict(state, args))
    return params, args
