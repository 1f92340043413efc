"""Parameter trees: the bridge from the JAX package's trees, and the port's
own random initialisation.

Both packages share one layout (layer-stacked ``(L, in, out)`` weights,
half-split RoPE rows, the same dict keys and NamedTuple fields, the same
quantized formats), so the bridge is a plain copy: every array leaf becomes
a tensor of the same dtype and bytes, and each NamedTuple becomes the
port's class of the same name.
"""

from __future__ import annotations

from typing import Optional

import torch

from csm_torch.codec.convs import ConvParams
from csm_torch.codec.rvq import RVQParams, SplitRVQParams
from csm_torch.models.config import ModelArgs
from csm_torch.models.csm import init_csm_params
from csm_torch.utils.quantize import host_tensor, is_quantized, is_quantized_int4
from csm_torch.watermarking.model import GatedConv

# NamedTuple classes of the parameter trees, by name
_TUPLES = {cls.__name__: cls for cls in (ConvParams, RVQParams, SplitRVQParams, GatedConv)}


def tree_map(fn, tree, is_leaf=None):
    """``fn`` applied to every leaf of nested dicts, lists, tuples and
    NamedTuples (None stays None); a node for which ``is_leaf`` is true is
    handed to ``fn`` whole.  A NamedTuple comes back as the port's class of
    the same name, so a JAX package tree maps into a port tree."""
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TUPLES.get(type(tree).__name__)
        if cls is None or cls._fields != tree._fields:
            raise TypeError(f"no port counterpart for parameter tuple {type(tree).__name__}")
        return cls(*(tree_map(fn, v, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _is_quantized_leaf(x) -> bool:
    return is_quantized(x) or is_quantized_int4(x)


def params_from_jax(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A tree of numpy (or array-protocol) leaves → the same tree of tensors
    on ``device``, bf16 included.  Floating leaves are cast to ``dtype`` when
    it is given, except inside a quantized projection: its integer codes and
    bf16 scales keep their bytes."""

    def leaf(x, cast=True):
        t = host_tensor(x)
        if cast and dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    def node(x):
        if _is_quantized_leaf(x):
            return {k: leaf(v, cast=False) for k, v in x.items()}
        return leaf(x)

    return tree_map(node, tree, is_leaf=_is_quantized_leaf)


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


def lora_from_jax(tree, device="cpu", dtype: Optional[torch.dtype] = None):
    """A JAX adapter tree or bank (numpy leaves; a bank's untouched component
    is None) → the port's tree of tensors on ``device``, floating leaves
    cast to ``dtype`` when it is given."""

    def leaf(x):
        t = host_tensor(x)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t.to(device)

    return tree_map(leaf, tree)
