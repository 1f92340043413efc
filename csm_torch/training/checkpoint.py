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
orbax checkpoints, nor does it write them.  ``AsyncCheckpointWriter``
saves in the background: it copies the state to host memory on the
caller's thread, then writes and commits it on a thread of its own.
"""

from __future__ import annotations

import json
import os
import threading
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


def _state_tree(state: TrainState) -> dict:
    tree = {"params": state.params}
    if state.opt_state is not None:
        tree["opt_state"] = state.opt_state
    return tree


def _write(ckpt_dir: str, name: str, tree: dict, step: int, args: ModelArgs, epoch: int,
           global_step: int, loss: float) -> str:
    """The state file through a temporary name, then ``meta.json``, then the
    ``latest`` pointer: each step only once the one before it is on disk."""
    path = _ckpt_path(ckpt_dir, name)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    meta = {
        "epoch": int(epoch),
        "global_step": int(global_step),
        "step": int(step),
        "loss": float(loss),
        "model_args": json.loads(args.to_json()),
    }
    _atomic_write_json(os.path.join(path, "meta.json"), meta)
    _atomic_write_json(os.path.join(os.path.abspath(ckpt_dir), LATEST_FILE), {"latest": name})
    return path


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
    return _write(ckpt_dir, name, _state_tree(state), int(state.step), args, epoch, global_step,
                  loss)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


class AsyncCheckpointWriter:
    """Checkpoint saves that do not hold up the training loop.

    ``save`` copies the state to host memory on the caller's thread (the
    training step that follows may then update the device tensors in
    place), and returns; a background thread writes the state file, then
    ``meta.json`` and the ``latest`` pointer, so ``latest`` never names a
    checkpoint whose state is not complete on disk.  One save is in flight
    at a time (a new ``save`` waits for the previous one), and a failure
    in the background re-raises at the next ``save`` or ``wait``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, ckpt_dir: str, name: str, state: TrainState, args: ModelArgs,
             epoch: int = 0, global_step: int = 0, loss: float = 0.0) -> str:
        self.wait()  # one in flight; surfaces a prior failure
        tree, step = _to_host(_state_tree(state)), int(state.step)

        def commit():
            try:
                _write(ckpt_dir, name, tree, step, args, epoch, global_step, loss)
            except BaseException as e:  # surfaced on the next save or wait
                self._error = e

        self._thread = threading.Thread(target=commit, daemon=True, name=f"ckpt-{name}")
        self._thread.start()
        return _ckpt_path(ckpt_dir, name)

    def wait(self) -> None:
        """Block until the save in flight, if any, is committed."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from e

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


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
