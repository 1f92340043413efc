"""Pipeline parallelism over the layer-stacked backbone.

The counterpart of the JAX package's ``parallel/pipeline.py``: stage s of
a ``pipe`` axis of P ranks holds backbone layers s·L/P … (s+1)·L/P − 1 (a
slice of the stacks' leading axis), so a rank's weight and optimizer bytes
fall by P with no per-matmul traffic.

The schedule is the JAX one (GPipe as uniform dataflow): the local batch
splits into M microbatches and M + P − 1 steps run; at every step every
stage runs its layer block, then the activations go one stage on
(``ring_shift``, the JAX ``ppermute``; the last step's shift is skipped).
Stage 0 injects microbatch t at step t (bubble steps re-run the last one,
and those outputs are never used); stage P−1's output at step t is the
finished microbatch t − (P−1).  The backward needs no schedule of its own:
``ring_shift``'s backward sends each gradient back one stage, and since
every step's input depends on the previous step's shift, autograd runs the
shifts' backwards in reverse step order on every stage.

The JAX package broadcasts the finished outputs to every stage (a masked
psum) and computes the loss on all of them; here the last stage alone
computes it (training/losses.py), and the other stages hand autograd a zero
multiple of their last output, so their backward still runs every shift.
Gradients of the leaves outside the pipelined stacks (embeddings on stage
0, heads and decoder on the last) are summed over ``pipe``
(parallel/sharding.py).

Composes with data parallelism on a (data, pipe) mesh and with Megatron
tensor parallelism inside each stage on a (data, pipe, model) mesh.  LoRA
adapters on the backbone are split like the layers they ride; their
dropout masks are drawn per (global layer, microbatch) from a seed the
step's generator draws, so they differ from a single rank's masks (as the
JAX package's ``fold_in`` schedule's do; ROADMAP.md §C.2).
"""

from __future__ import annotations

from typing import Optional

import torch

from csm_torch.models.config import TransformerConfig
from csm_torch.models.llama import transformer_layers
from csm_torch.ops.attention import causal_mask_from_positions
from csm_torch.ops.flash_attention import FLASH_MIN_SEQ
from csm_torch.ops.norms import rms_norm
from csm_torch.parallel import distributed as D
from csm_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, Mesh, _world, build


def make_pp_mesh(world_size=None, rank=None, pipeline_parallel: int = 2,
                 model_parallel: int = 1) -> Mesh:
    """A (data, pipe) mesh, or (data, pipe, model) when ``model_parallel``
    > 1 (Megatron TP inside each stage)."""
    world_size, rank = _world(world_size, rank)
    group = pipeline_parallel * model_parallel
    if world_size % group != 0:
        raise ValueError(
            f"{world_size} devices not divisible by pipeline_parallel="
            f"{pipeline_parallel} x model_parallel={model_parallel}")
    shape = {DATA_AXIS: -1, PIPE_AXIS: pipeline_parallel}
    if model_parallel > 1:
        shape[MODEL_AXIS] = model_parallel
    return build(shape, world_size, rank)


def pp_param_specs(tp: bool = False) -> dict:
    """The layout tree on a (data, pipe[, model]) mesh: the layer stacks
    split their leading (layer) axis over ``pipe`` (the backbone's as the
    pipeline's stages, the decoder's for memory only: it is gathered before
    it runs), embeddings and heads their vocab dim; with ``tp`` each stage's
    block also splits heads / intermediate over ``model``."""
    m = MODEL_AXIS if tp else None
    stacked = {
        "wq": (PIPE_AXIS, None, m),
        "wk": (PIPE_AXIS, None, m),
        "wv": (PIPE_AXIS, None, m),
        "wo": (PIPE_AXIS, m, None),
        "w1": (PIPE_AXIS, None, m),
        "w3": (PIPE_AXIS, None, m),
        "w2": (PIPE_AXIS, m, None),
        "sa_norm": (PIPE_AXIS, None),
        "mlp_norm": (PIPE_AXIS, None),
        "norm": (None,),
    }
    return {
        "backbone": stacked,
        "decoder": dict(stacked),
        "text_embeddings": (PIPE_AXIS, None),
        "audio_embeddings": (PIPE_AXIS, None),
        "projection": (None, None),
        "codebook0_head": (None, PIPE_AXIS),
        "audio_head": (None, None, PIPE_AXIS),
    }


def check_stages(cfg: TransformerConfig, mesh: Mesh) -> None:
    P = mesh.axis_size(PIPE_AXIS)
    if cfg.num_layers % P:
        raise ValueError(f"{cfg.num_layers} layers not divisible by pipe={P}")


def shard_params_pp(params: dict, mesh: Mesh, args) -> dict:
    """This rank's slices of a CSM tree on a pipe mesh.  The backbone's
    layer axis must divide by the stage count (a stage is a layer block);
    the other splits fall back to replication where a dim does not divide."""
    from csm_torch.parallel.sharding import param_layouts, shard_tree

    check_stages(args.backbone, mesh)
    return shard_tree(params, param_layouts(params, args, mesh), mesh)


def lora_pp_layouts(lora: dict, mesh: Mesh) -> dict:
    """Adapters split their layer axis over ``pipe`` where it divides (the
    backbone's always, as its base; the decoder's 4 layers may not), else
    whole."""
    pipe = mesh.axis_size(PIPE_AXIS)

    def lay(t):
        if isinstance(t, dict):
            return {k: lay(v) for k, v in t.items()}
        return (PIPE_AXIS if t.shape[0] % pipe == 0 else None,) + (None,) * (t.dim() - 1)

    return lay(lora)


def shard_lora_pp(lora: dict, mesh: Mesh) -> dict:
    """This rank's slices of an adapter tree on a pipe mesh."""
    from csm_torch.parallel.sharding import shard_tree

    return shard_tree(lora, lora_pp_layouts(lora, mesh), mesh)


def pipelined_transformer(
    params: dict,
    cfg: TransformerConfig,
    h: torch.Tensor,
    positions: torch.Tensor,
    mesh: Mesh,
    n_microbatches: int,
    *,
    lora: Optional[dict] = None,
    lora_scale: float = 0.0,
    remat: bool = False,
    lora_dropout_rate: float = 0.0,
    lora_dropout_seed: Optional[int] = None,
    shard=None,
):
    """The pipeline-parallel backbone (full sequence, no cache).

    Args:
        params: this stage's layer-stacked block (L/P layers) and the final
            ``norm``; with ``shard`` (parallel/sharding.TransformerShard)
            each layer also holds its model slice.
        h: (B, T, E) this rank's rows (used on stage 0).
        positions: (T,) int positions (every row aligned, as in training).
        n_microbatches: M, dividing B; the bubble is (P−1)/(M+P−1).
        lora: this stage's adapter block.
        lora_dropout_seed: seeds a generator per (global layer,
            microbatch) for the adapters' dropout masks.

    Returns (out, last): on the last stage the (B, T, E) output after the
    final norm and True; elsewhere the last step's output (to anchor the
    backward) and False."""
    check_stages(cfg, mesh)
    P, s = mesh.axis_size(PIPE_AXIS), mesh.index(PIPE_AXIS)
    M = n_microbatches
    B, T, E = h.shape
    if B % M:
        raise ValueError(f"local batch {B} not divisible by microbatches {M}")
    mb = B // M
    h_mb = h.reshape(M, mb, T, E)
    n_local = params["wq"].shape[0] if not isinstance(params["wq"], dict) else \
        next(iter(params["wq"].values())).shape[0]
    layer_ids = [s * n_local + i for i in range(n_local)]
    pos = positions.to(torch.int32).reshape(1, T).expand(mb, T).contiguous()
    if T >= FLASH_MIN_SEQ:
        mask, flash_pos = None, (pos, pos[0].contiguous())
    else:
        mask, flash_pos = causal_mask_from_positions(pos, pos[0]), None
    drop_on = lora is not None and lora_dropout_rate > 0.0 and lora_dropout_seed is not None

    def uniforms(t):
        def draw(lid, shape):
            g = torch.Generator(device=h.device)
            g.manual_seed(((lora_dropout_seed * 1_000_003 + lid) * 65_537 + max(t - s, 0))
                          % (1 << 63))
            return torch.rand(shape, generator=g, device=h.device)
        return draw

    n_steps = M + P - 1
    first = torch.tensor(s == 0, device=h.device)
    carry = torch.zeros((mb, T, E), dtype=h.dtype, device=h.device)
    ys = []
    for t in range(n_steps):
        x_in = carry if s else torch.where(first, h_mb[min(t, M - 1)], carry)
        y = transformer_layers(
            params, cfg, x_in, pos, mask, flash_pos=flash_pos, remat=remat, lora=lora,
            lora_scale=lora_scale, lora_dropout_rate=lora_dropout_rate if drop_on else 0.0,
            lora_uniform=uniforms(t) if drop_on else None, layer_ids=layer_ids, shard=shard)
        ys.append(y)
        if t < n_steps - 1:
            (carry,) = D.ring_shift(mesh, PIPE_AXIS, y)
    if s != P - 1:
        return ys[-1], False
    out = torch.cat(ys[P - 1:], dim=0)  # (M·mb, T, E): microbatches in order
    return rms_norm(out, params["norm"], cfg.norm_eps), True
