"""Checkpoint save / load / resume.

The JAX package's directory contract: a checkpoint is ``<dir>/<name>/``
holding the state and a ``meta.json`` (epoch, global step, step, loss, the
model args), and ``<dir>/latest.json`` names the newest one.  ``meta.json``
and ``latest.json`` are written through a temporary file and
``os.replace``, and only after the state file is complete, so ``latest``
never points at a partial checkpoint.

The state is the port's own format: ``state.pt``, a ``torch.save`` of
``{"params": ..., "opt_state": ...}`` (tensors, dicts and ints only, read
back with ``weights_only=True``).  The port does not read the JAX package's
orbax checkpoints, nor does it write them.  Saving in the background
(``AsyncCheckpointWriter``) waits (ROADMAP.md A.10b).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch

from csm_torch.models.config import ModelArgs
from csm_torch.training.optimizer import TrainState

LATEST_FILE = "latest.json"
STATE_FILE = "state.pt"


def _ckpt_path(ckpt_dir: str, name: str) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), name)


def _atomic_write_json(path: str, obj) -> None:
    """Temp file + os.replace: a crash mid-write never leaves a truncated
    meta.json or latest.json."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save_checkpoint(
    ckpt_dir: str,
    name: str,
    state: TrainState,
    args: ModelArgs,
    epoch: int = 0,
    global_step: int = 0,
    loss: float = 0.0,
) -> str:
    """Write a named checkpoint and advance the ``latest`` pointer."""
    path = _ckpt_path(ckpt_dir, name)
    os.makedirs(path, exist_ok=True)
    tree = {"params": state.params}
    if state.opt_state is not None:
        tree["opt_state"] = state.opt_state
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    meta = {
        "epoch": int(epoch),
        "global_step": int(global_step),
        "step": int(state.step),
        "loss": float(loss),
        "model_args": json.loads(args.to_json()),
    }
    _atomic_write_json(os.path.join(path, "meta.json"), meta)
    _atomic_write_json(os.path.join(os.path.abspath(ckpt_dir), LATEST_FILE), {"latest": name})
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    p = os.path.join(os.path.abspath(ckpt_dir), LATEST_FILE)
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return _ckpt_path(ckpt_dir, json.load(f)["latest"])


def load_checkpoint(path: str, device=None) -> tuple[TrainState, dict]:
    """Restore (TrainState, meta); tensors land on ``device`` (default:
    where they were saved from)."""
    path = os.path.abspath(path)
    tree = torch.load(os.path.join(path, STATE_FILE), map_location=device, weights_only=True)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    state = TrainState(params=tree["params"], opt_state=tree.get("opt_state"),
                       step=int(meta.get("step", 0)))
    return state, meta


def load_params(path: str, device=None) -> tuple[dict, ModelArgs]:
    """Restore params only, with the model args (for inference)."""
    state, meta = load_checkpoint(path, device)
    return state.params, ModelArgs.from_json(json.dumps(meta["model_args"]))
