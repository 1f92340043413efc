"""Parameter trees: the bridge from the JAX package's trees, and the port's
own random initialisation.

Both packages share one layout (layer-stacked ``(L, in, out)`` weights,
half-split RoPE rows, the same dict keys and NamedTuple fields), so the
bridge is a plain copy: every array leaf becomes a tensor, and each
NamedTuple becomes the port's class of the same name.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from csm_torch.codec.convs import ConvParams
from csm_torch.codec.rvq import RVQParams, SplitRVQParams
from csm_torch.models.config import ModelArgs
from csm_torch.models.csm import init_csm_params

# NamedTuple classes of the parameter trees, by name
_TUPLES = {cls.__name__: cls for cls in (ConvParams, RVQParams, SplitRVQParams)}


def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts, lists, tuples and
    NamedTuples (None stays None).  A NamedTuple comes back as the port's
    class of the same name, so a JAX package tree maps into a port tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TUPLES.get(type(tree).__name__)
        if cls is None or cls._fields != tree._fields:
            raise TypeError(f"no port counterpart for parameter tuple {type(tree).__name__}")
        return cls(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def params_from_jax(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A tree of numpy (or array-protocol) leaves → the same tree of tensors
    on ``device``; floating leaves are cast to ``dtype`` when it is given."""

    def leaf(x):
        t = torch.from_numpy(np.array(x, copy=True))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)


def cast_params(tree, dtype: torch.dtype):
    """Every floating tensor of a tree cast to ``dtype`` (the JAX package's
    cast of the loaded tree to the compute dtype)."""
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t, tree)


def random_csm_params(
    args: ModelArgs, seed: int = 0, dtype=torch.float32, device="cpu"
) -> dict:
    """Random CSM weights made on ``device`` from ``seed`` (normal /
    sqrt(fan_in), unit norms): the shapes of ``init_csm_params``.  The
    values differ from the JAX package's random init, whose PRNG PyTorch
    does not reproduce; tests bridge JAX's tree with ``params_from_jax``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_csm_params(args, gen, dtype, device)
