"""The trainers: full-parameter and LoRA.

The counterparts of the JAX package's ``CSMTrainer`` and ``CSMLoRATrainer``
(``training/trainer.py``): an epoch loop over bucketed batches with
gradient accumulation and clipping, periodic validation with
best-checkpoint saving, periodic, epoch and final checkpoints (written in
the background with ``async_checkpointing``), resume from ``latest``, a
non-finite-loss abort that saves first, and sample generation through the
port's ``Generator``.  The LoRA trainer optimizes only an adapter tree over
a frozen base, which it may hold quantized (int8 or int4, QLoRA).

A step's loss and metrics stay on the device and are read one step later,
while the next step is already queued, so the host never waits for the
card on every step.  ``model_path`` loads a torchtune ``ckpt.pt`` or
``.safetensors`` file, or a checkpoint directory of this trainer (not the
JAX package's orbax ones).

``parallel=ParallelConfig(...)`` trains over a mesh of ranks
(parallel/mesh.py): each rank is a process (``python -m
torch.distributed.run``; the trainer joins the group from its
environment), holds its slices of the parameters and optimizer state in
the layout's ``layouts`` (parallel/sharding.py, parallel/pipeline.py),
and runs the same loop over the same global batches.  Checkpoints are the
single-process ``state.pt`` / ``meta.json`` / ``latest``: every rank
gathers the whole state and rank 0 writes it; a resume under any layout
slices it again.  Only rank 0 writes metrics and logs to
``training.log``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from csm_torch.models.config import ModelArgs, csm_1b_args, csm_param_count
from csm_torch.training import checkpoint as ckpt
from csm_torch.training import lora as lora_mod
from csm_torch.training.dataset_utils import as_batches, prefetch_batches
from csm_torch.training.losses import compute_loss
from csm_torch.training.optimizer import (TrainState, init_train_state, make_lora_optimizer,
                                          make_optimizer)
from csm_torch.training.train_step import make_eval_step, make_lora_train_step, make_train_step
from csm_torch.utils import quantize as qz
from csm_torch.utils.checkpoint_compat import load_torch_checkpoint
from csm_torch.utils.device import resolve_device
from csm_torch.utils.observability import MetricsLogger, device_memory_stats
from csm_torch.utils.params import random_csm_params, tree_map


def setup_logger(name: str, log_file: Optional[str] = None, level=logging.INFO):
    """Console + file logger."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(log_file) or ".", exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The random stream of one step (the amortized frame draw): a function
    of the seed and the step, so a resumed run draws what it would have."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


class CSMTrainer:
    """Full-parameter trainer (reference: src/csm/training/trainer.py:26).

    Args mirror the reference surface (model path, output dir, base LR,
    per-component multipliers, semantic/acoustic weights), plus
    ``device`` (``"cuda"`` unless the caller asks for the CPU),
    ``compute_dtype`` (activations; bf16 by default), ``param_dtype``
    (master weights: float32 or bfloat16; a quantized projection keeps its
    layout), ``remat`` (recompute each layer in the backward pass; on by
    default) and ``async_checkpointing`` (``checkpoint.AsyncCheckpointWriter``)."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        output_dir: str = "./output",
        learning_rate: float = 1e-5,
        backbone_lr_multiplier: float = 0.1,
        decoder_lr_multiplier: float = 1.0,
        embedding_lr_multiplier: float = 0.5,
        semantic_weight: float = 100.0,
        acoustic_weight: float = 1.0,
        weight_decay: float = 0.01,
        args: Optional[ModelArgs] = None,
        params: Optional[dict] = None,
        compute_dtype=torch.bfloat16,
        remat: bool = True,
        log_file: Optional[str] = None,
        parallel=None,
        param_dtype=torch.float32,
        async_checkpointing: bool = False,
        prefetch_depth: int = 2,
        device="cuda",
    ):
        if param_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype}")
        self.parallel, self.mesh, self.layouts = parallel, None, None
        if parallel is not None:
            from csm_torch.parallel.distributed import initialize, rank_device

            device = rank_device(device)  # raises before any group when no card is there
            initialize(device)
            self.mesh = parallel.build_mesh()
        self.is_main = self.mesh is None or self.mesh.rank == 0
        self.device = resolve_device(device)
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        if not self.is_main:  # one log file per rank
            log_file = os.path.join(output_dir, f"training.rank{self.mesh.rank}.log")
        self.logger = setup_logger(
            self.__class__.__name__, log_file or os.path.join(output_dir, "training.log")
        )
        self.learning_rate = learning_rate
        self.lr_multipliers = {
            "backbone": backbone_lr_multiplier,
            "decoder": decoder_lr_multiplier,
            "embeddings": embedding_lr_multiplier,
            "other": 1.0,
        }
        self.semantic_weight = semantic_weight
        self.acoustic_weight = acoustic_weight
        self.weight_decay = weight_decay
        self.compute_dtype = compute_dtype
        self.remat = remat
        self.param_dtype = param_dtype

        self.args, params = self._load_model(model_path, args, params)
        # Training updates these tensors in place: given params already on
        # the device in ``param_dtype`` are trained as they are, so a caller
        # that needs the old values passes a copy.
        self.params = tree_map(
            lambda t: ({k: v.detach().to(self.device) for k, v in t.items()} if isinstance(t, dict)
                       else t.detach().to(self.device, param_dtype)),
            params, is_leaf=lambda t: qz.is_quantized(t) or qz.is_quantized_int4(t))
        self.tx = None
        self.state = None
        self.epoch = 0
        self.global_step = 0
        self.best_val_loss = float("inf")
        self.prefetch_depth = prefetch_depth
        # the latest pointer commits only once a checkpoint is on disk
        self.async_checkpointing = async_checkpointing
        self._ckpt_writer = None
        self.metrics = MetricsLogger(os.path.join(output_dir, "metrics.jsonl"))

    # ---- model loading ----

    def _load_model(self, model_path, args, params):
        if params is not None:
            return args or csm_1b_args(), params
        if model_path is None:
            args = args or csm_1b_args()
            self.logger.info("random-initializing model (no model_path)")
            return args, random_csm_params(args, seed=0, device=self.device)
        if model_path.endswith((".pt", ".safetensors")):
            self.logger.info(f"loading torchtune checkpoint {model_path}")
            args = args or csm_1b_args()
            return args, load_torch_checkpoint(model_path, args)
        self.logger.info(f"loading training checkpoint {model_path}")
        params, args = ckpt.load_params(model_path, self.device)
        return args, params

    # ---- optimizer ----

    def prepare_optimizer(
        self,
        freeze_backbone: bool = False,
        freeze_decoder: bool = False,
        freeze_embeddings: bool = False,
        max_grad_norm: float = 1.0,
        accumulation_steps: int = 1,
        mu_dtype=None,
        nu_dtype=None,
        grad_microbatches: int = 1,
    ):
        self._place_params()
        self.tx = make_optimizer(
            self.params,
            learning_rate=self.learning_rate,
            weight_decay=self.weight_decay,
            max_grad_norm=max_grad_norm,
            lr_multipliers=self.lr_multipliers,
            freeze_backbone=freeze_backbone,
            freeze_decoder=freeze_decoder,
            freeze_embeddings=freeze_embeddings,
            accumulation_steps=accumulation_steps,
            mu_dtype=mu_dtype,
            nu_dtype=nu_dtype,
        )
        self.state = init_train_state(self.params, self.tx)
        self._step_fn = make_train_step(
            self.args, self.tx, semantic_weight=self.semantic_weight,
            acoustic_weight=self.acoustic_weight, compute_dtype=self.compute_dtype,
            remat=self.remat, grad_microbatches=grad_microbatches, layouts=self.layouts,
            **self._mesh_kwargs(),
        )
        self._eval_fn = make_eval_step(
            self.args, semantic_weight=self.semantic_weight,
            acoustic_weight=self.acoustic_weight, compute_dtype=self.compute_dtype,
            layouts=self.layouts, **self._mesh_kwargs(),
        )
        return self.tx

    # ---- mesh placement (no-ops without a ParallelConfig) ----

    def _mesh_kwargs(self) -> dict:
        if self.mesh is None:
            return {}
        from csm_torch.parallel.mesh import mesh_kwargs

        return mesh_kwargs(self.parallel, self.mesh)

    def _place_params(self) -> None:
        """Keep this rank's slices of the whole parameters (once)."""
        if self.mesh is None or self.layouts is not None:
            return
        from csm_torch.parallel.pipeline import check_stages
        from csm_torch.parallel.sharding import param_layouts, shard_tree

        if self.parallel.pipeline_parallel > 1:
            check_stages(self.args.backbone, self.mesh)
        self.layouts = param_layouts(self.params, self.args, self.mesh)
        self.params = shard_tree(self.params, self.layouts, self.mesh)

    def _state_layouts(self) -> dict:
        """The layouts of the train state's params (the adapters for LoRA)."""
        return self.layouts

    def gathered_state_params(self) -> dict:
        """The trained parameters put back together (collective on a mesh;
        every rank gets them)."""
        from csm_torch.parallel.sharding import unshard_tree

        params = self.state.params if self.state is not None else self.params
        if self.mesh is None:
            return params
        return unshard_tree(params, self._state_layouts(), self.mesh)

    def _whole_state(self) -> TrainState:
        """The train state with whole tensors (collective on a mesh)."""
        if self.mesh is None:
            return self.state
        from csm_torch.parallel.sharding import unshard_tree

        lay = self._state_layouts()
        flat = dict(self._flat_layouts())
        opt = dict(self.state.opt_state)
        for key in ("mu", "nu", "acc"):
            if key in opt:
                opt[key] = {p: unshard_tree({"t": t}, {"t": flat[p]}, self.mesh)["t"]
                            for p, t in opt[key].items()}
        return TrainState(unshard_tree(self.state.params, lay, self.mesh), opt, self.state.step)

    def _flat_layouts(self):
        from csm_torch.parallel.sharding import flat_layouts

        return flat_layouts(self.state.params, self._state_layouts())

    def _shard_state(self, state: TrainState) -> TrainState:
        """This rank's slices of a whole train state."""
        if self.mesh is None:
            return state
        from csm_torch.parallel.sharding import _slice, shard_tree

        flat = dict(self._flat_layouts())
        opt = dict(state.opt_state)
        for key in ("mu", "nu", "acc"):
            if key in opt:
                opt[key] = {p: _slice(t, flat[p], self.mesh).contiguous().clone()
                            for p, t in opt[key].items()}
        return TrainState(shard_tree(state.params, self._state_layouts(), self.mesh), opt,
                          state.step)

    def _run_step(self, generator, batch):
        """One optimizer step on ``batch`` (moved to the device); returns the
        step's metrics as device tensors."""
        self.state, metrics = self._step_fn(self.state, generator, batch.to(self.device))
        return metrics

    # ---- training loop ----

    def train(
        self,
        train_dataset,
        val_dataset=None,
        batch_size: int = 2,
        epochs: int = 1,
        val_every: int = 100,
        save_every: int = 500,
        max_grad_norm: float = 1.0,
        accumulation_steps: int = 1,
        resume_from: Optional[str] = None,
        seed: int = 0,
    ) -> float:
        if self.state is None:
            self.prepare_optimizer(
                max_grad_norm=max_grad_norm, accumulation_steps=accumulation_steps
            )
        if resume_from:
            self.load_checkpoint(resume_from)

        last_loss = float("nan")
        # Metrics are read one step late: step N's device scalars are read
        # after step N+1 is queued, so the card never idles on the host's
        # read (a per-step ``.item()`` would wait for each step to finish
        # before the next one is issued).
        pending = None  # (global_step, epoch, device metrics of that step)

        def drain(p):
            nonlocal last_loss
            gs, ep, m = p
            m = {k: v.item() for k, v in m.items()}
            last_loss = m["loss"]
            if not math.isfinite(last_loss):
                # a non-finite loss is a data or LR fault: save, then fail
                # loudly.  With the lagged read the saved state may be one
                # step past the first non-finite loss.
                self.save_checkpoint("nonfinite_abort")
                self.close()
                raise FloatingPointError(
                    f"non-finite loss {last_loss} at step {gs} "
                    f"(state saved; may include one later step)"
                )
            if self.is_main:
                self.metrics.log(gs, epoch=ep, loss=m["loss"], semantic_loss=m["semantic_loss"],
                                 acoustic_loss=m["acoustic_loss"], grad_norm=m["grad_norm"])
            if gs % 10 == 0:
                self.logger.info(
                    f"epoch {ep} step {gs} loss {last_loss:.4f} "
                    f"sem {m['semantic_loss']:.4f} ac {m['acoustic_loss']:.4f}"
                )

        for epoch in range(self.epoch, epochs):
            self.epoch = epoch
            t_epoch = time.time()
            n_batches = 0
            for batch in prefetch_batches(
                as_batches(train_dataset, batch_size, shuffle=True, seed=seed + epoch),
                depth=self.prefetch_depth,
            ):
                metrics = self._run_step(step_generator(self.device, seed, self.global_step), batch)
                self.global_step += 1
                n_batches += 1
                prev, pending = pending, (self.global_step, epoch, metrics)
                if prev is not None:
                    drain(prev)
                at_val = val_dataset is not None and self.global_step % val_every == 0
                at_save = self.global_step % save_every == 0
                if (at_val or at_save) and pending is not None:
                    p, pending = pending, None  # catch up before validating / saving
                    drain(p)
                if at_val:
                    val_loss = self.validate(val_dataset, batch_size, seed=seed)
                    if val_loss < self.best_val_loss:
                        self.best_val_loss = val_loss
                        self.save_checkpoint("best")
                if at_save:
                    self.save_checkpoint(f"step_{self.global_step}")
            if pending is not None:  # epoch boundary: catch up
                p, pending = pending, None
                drain(p)

            dt = time.time() - t_epoch
            self.logger.info(
                f"epoch {epoch} done: {n_batches} batches in {dt:.1f}s "
                f"({n_batches * batch_size / max(dt, 1e-9):.2f} samples/s) "
                f"{device_memory_stats(self.device)}"
            )
            self.save_checkpoint(f"epoch_{epoch}")

        self.save_checkpoint("final")
        self.close()
        return last_loss

    def validate(self, val_dataset, batch_size: int = 2, seed: int = 0) -> float:
        """Mean eval loss over ``val_dataset`` (reference:
        src/csm/training/trainer.py:359-394); one host read at the end."""
        losses = []
        for i, batch in enumerate(as_batches(val_dataset, batch_size, shuffle=False)):
            m = self._eval_fn(self.state.params, step_generator(self.device, seed, i),
                              batch.to(self.device))
            losses.append(m["loss"])
        val = float(torch.stack(losses).mean().item()) if losses else float("nan")
        self.logger.info(f"validation loss {val:.4f}")
        return val

    # ---- checkpointing ----

    def save_checkpoint(self, name: str) -> str:
        """A checkpoint of the train state (a LoRA trainer's ``params`` are
        its adapter tree)."""
        kw = dict(epoch=self.epoch, global_step=self.global_step, loss=self.best_val_loss)
        ckpt_dir = os.path.join(self.output_dir, "checkpoints")
        state = self._whole_state()  # on a mesh: gathered; rank 0 writes
        if not self.is_main:
            return os.path.join(os.path.abspath(ckpt_dir), name)
        if self.async_checkpointing:
            if self._ckpt_writer is None:
                self._ckpt_writer = ckpt.AsyncCheckpointWriter()
            path = self._ckpt_writer.save(ckpt_dir, name, state, self.args, **kw)
            self.logger.info(f"saving checkpoint {path} (async)")
        else:
            path = ckpt.save_checkpoint(ckpt_dir, name, state, self.args, **kw)
            self.logger.info(f"saved checkpoint {path}")
        return path

    def wait_for_checkpoints(self) -> None:
        """Block until the checkpoint in flight, if any, is committed."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()

    def close(self) -> None:
        """Commit the checkpoint in flight, flush and close the metrics file
        (reopened by the next log); idempotent."""
        w, self._ckpt_writer = self._ckpt_writer, None
        try:
            if w is not None:
                w.close()
        finally:
            self.metrics.close()

    def load_checkpoint(self, path: Optional[str] = None):
        self.wait_for_checkpoints()  # never restore under a save in flight
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier()  # rank 0's writes are on disk
        if path is None or path == "latest":
            path = ckpt.latest_checkpoint(os.path.join(self.output_dir, "checkpoints"))
            if path is None:
                raise FileNotFoundError("no latest checkpoint to resume from")
        state, meta = ckpt.load_checkpoint(path, self.device)
        if self.tx is None or state.opt_state is None:
            raise ValueError("resume needs prepare_optimizer() first and a checkpoint "
                             "with optimizer state")
        state = self._shard_state(state)
        self.state = state
        self._restored(state)
        self.epoch = meta.get("epoch", 0)
        self.global_step = meta.get("global_step", 0)
        self.best_val_loss = meta.get("loss", float("inf"))
        self.logger.info(f"resumed from {path} (epoch {self.epoch}, step {self.global_step})")

    def _restored(self, state: TrainState) -> None:
        self.params = state.params

    def _final_params(self) -> dict:
        return self.gathered_state_params()

    # ---- sample generation ----

    @torch.no_grad()
    def generate_sample(
        self, text: str, speaker_id: int = 0, output_path: Optional[str] = None,
        mimi=None, max_audio_length_ms: float = 5_000, text_tokenizer=None,
    ) -> np.ndarray:
        from csm_torch.data.audio import save_wav
        from csm_torch.generator import Generator

        params = self._final_params()  # on a mesh: gathered; rank 0 generates
        if not self.is_main:
            return None
        gen = Generator(
            params, self.args, mimi=mimi, text_tokenizer=text_tokenizer,
            compute_dtype=self.compute_dtype, device=self.device,
        )
        audio = gen.generate(text, speaker=speaker_id, max_audio_length_ms=max_audio_length_ms)
        if output_path:
            save_wav(output_path, audio, gen.sample_rate)
        return audio


class CSMLoRATrainer(CSMTrainer):
    """LoRA fine-tuning (reference: src/csm/training/lora_trainer.py): only
    the adapter tree is optimized; ``save_model`` writes the ``lora``,
    ``full`` (merged) or ``both`` artifacts.

    ``quant_base`` None | "int8" | "int4" (``int8_base=True`` is "int8")
    stores the FROZEN base's transformer stacks quantized (QLoRA): the
    forward dequantizes in the matmul, the backward saves only the
    quantized weights, and the adapters absorb the quantization error.  A
    base whose bf16 tree is over 8 GiB (the 8B flavor) is made quantized
    directly when there is no ``model_path``, and a ``.pt`` /
    ``.safetensors`` file is quantized a few layers at a time as it is
    loaded.  A's init draws from a generator seeded 42."""

    def __init__(
        self,
        model_path: Optional[str] = None,
        output_dir: str = "./output",
        learning_rate: float = 1e-4,
        lora_r: int = 8,
        lora_alpha: float = 16.0,
        lora_dropout: float = 0.0,
        target_modules=("q_proj", "v_proj"),
        target_layers=None,
        apply_to_backbone: bool = True,
        apply_to_decoder: bool = True,
        int8_base: bool = False,
        quant_base: Optional[str] = None,
        **kw,
    ):
        if int8_base and quant_base not in (None, "int8"):
            raise ValueError("pass either int8_base or quant_base, not both")
        quant_base = "int8" if int8_base else quant_base
        if quant_base not in (None, "int8", "int4"):
            raise ValueError(f"quant_base must be int8|int4, got {quant_base!r}")
        self.quant_base = quant_base  # before super().__init__: _load_model reads it
        self.int8_base = quant_base == "int8"
        par = kw.get("parallel")
        if quant_base is not None and par is not None and (
                par.model_parallel > 1 or par.fsdp or par.pipeline_parallel > 1):
            raise ValueError(
                "a quantized base (int8_base / quant_base) supports single-device, "
                "data-parallel and sequence-parallel layouts (the point is NOT needing model "
                "sharding); drop the quantized-base or the model-sharding flags")
        self.lora_layouts = None
        super().__init__(model_path=model_path, output_dir=output_dir,
                         learning_rate=learning_rate, **kw)
        # an already-quantized base (multi-speaker trainers share one) is kept
        probe = self.params["backbone"]["wq"]
        if quant_base == "int8" and not qz.is_quantized(probe):
            self.params = qz.quantize_csm_params(self.params)
        elif quant_base == "int4" and not qz.is_quantized_int4(probe):
            self.params = qz.quantize_csm_params_int4(self.params)
        self.lora_config = lora_mod.LoRAConfig(
            r=lora_r, alpha=lora_alpha, dropout=lora_dropout,
            target_modules=tuple(target_modules),
            target_layers=None if target_layers is None else tuple(target_layers),
            apply_to_backbone=apply_to_backbone, apply_to_decoder=apply_to_decoder,
        )
        self.lora_params = self.init_adapters(42)
        eff = lora_mod.parameter_efficiency(self.params, self.lora_params)
        self.logger.info(
            f"LoRA r={lora_r} alpha={lora_alpha} targets={target_modules}: "
            f"{lora_mod.count_params(self.lora_params):,} trainable params "
            f"({eff * 100:.3f}% of base)"
        )

    def init_adapters(self, seed: int) -> dict:
        """A fresh adapter tree of this trainer's config, A drawn from
        ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return lora_mod.init_lora_params(gen, self.args, self.lora_config, device=self.device)

    def _load_model(self, model_path, args, params):
        if self.quant_base is not None and model_path is None and params is None:
            a = args or csm_1b_args()
            if 2 * csm_param_count(a) > (8 << 30):
                # the float tree of a big flavor never exists on the card
                self.logger.info(f"random-initializing the quantized ({self.quant_base}) base")
                gen = torch.Generator(device=self.device).manual_seed(0)
                return a, qz.init_csm_params_quantized(gen, a, self.quant_base,
                                                       device=self.device)
        if (self.quant_base is not None and model_path is not None
                and model_path.endswith((".pt", ".safetensors"))):
            args = args or csm_1b_args()
            self.logger.info(f"loading torchtune checkpoint {model_path} "
                             f"(quantized to {self.quant_base} as it loads)")
            host = load_torch_checkpoint(model_path, args)
            return args, qz.quantize_csm_params_streaming(host, mode=self.quant_base,
                                                          device=self.device)
        return super()._load_model(model_path, args, params)

    def prepare_optimizer(self, max_grad_norm: float = 1.0, accumulation_steps: int = 1,
                          **_ignored):
        self._place_params()
        self._place_adapters()
        self.tx = make_lora_optimizer(learning_rate=self.learning_rate,
                                      max_grad_norm=max_grad_norm,
                                      accumulation_steps=accumulation_steps)
        self.state = init_train_state(self.lora_params, self.tx)
        mkw = self._mesh_kwargs()
        self._lora_step_fn = make_lora_train_step(
            self.args, self.tx, self.lora_config.scaling, semantic_weight=self.semantic_weight,
            acoustic_weight=self.acoustic_weight, compute_dtype=self.compute_dtype,
            remat=self.remat, lora_dropout=self.lora_config.dropout,
            base_layouts=self.layouts, layouts=self.lora_layouts, **mkw,
        )
        scaling, base = self.lora_config.scaling, self.params
        if self.mesh is not None:
            from csm_torch.training.train_step import _base_view

            base = _base_view(self.params, self.layouts, mkw)

        @torch.no_grad()
        def eval_step(lora, generator, batch):
            if self.mesh is not None:
                lora = _base_view(lora, self.lora_layouts, mkw)
            _, m = compute_loss(base, self.args, generator, batch,
                                semantic_weight=self.semantic_weight,
                                acoustic_weight=self.acoustic_weight,
                                compute_dtype=self.compute_dtype, lora=lora, lora_scale=scaling,
                                **mkw)
            return m

        self._eval_fn = eval_step
        return self.tx

    def _run_step(self, generator, batch):
        self.state, metrics = self._lora_step_fn(self.state, self.params, generator,
                                                 batch.to(self.device))
        return metrics

    def _restored(self, state: TrainState) -> None:
        self.lora_params = state.params

    def _state_layouts(self) -> dict:
        return self.lora_layouts

    def _place_adapters(self) -> None:
        """This rank's slices of the adapters: split over ``pipe`` like the
        layers they ride (parallel/pipeline.lora_pp_layouts), else whole."""
        if self.mesh is None or self.lora_layouts is not None:
            return
        from csm_torch.parallel.pipeline import lora_pp_layouts
        from csm_torch.parallel.sharding import shard_tree

        if self.parallel.pipeline_parallel > 1:
            self.lora_layouts = lora_pp_layouts(self.lora_params, self.mesh)
        else:
            self.lora_layouts = _whole_layouts(self.lora_params)
        self.lora_params = shard_tree(self.lora_params, self.lora_layouts, self.mesh)

    # ---- artifacts ----

    def save_model(self, path: str, save_mode: str = "lora") -> list:
        """``lora``: an adapter directory at ``path``; ``full``: a checkpoint
        of the merged params at ``path``; ``both``: ``path_lora`` and
        ``path_full``."""
        if save_mode not in ("lora", "full", "both"):
            raise ValueError(f"save_mode must be lora|full|both, got {save_mode!r}")
        self.wait_for_checkpoints()
        lora = self.state.params if self.state is not None else self.lora_params
        base = self.params
        if self.mesh is not None:  # gathered; rank 0 writes
            from csm_torch.parallel.sharding import unshard_tree

            lora = unshard_tree(lora, self.lora_layouts, self.mesh)
            if save_mode != "lora":
                base = unshard_tree(self.params, self.layouts, self.mesh)
            if not self.is_main:
                return []
        out = []
        if save_mode in ("lora", "both"):
            p = path + ("_lora" if save_mode == "both" else "")
            out.append(lora_mod.save_lora(p, lora, self.lora_config, self.args))
        if save_mode in ("full", "both"):
            merged = lora_mod.merge_lora(base, lora, self.lora_config)
            p = path + ("_full" if save_mode == "both" else "")
            out.append(ckpt.save_checkpoint(
                os.path.dirname(p) or ".", os.path.basename(p), TrainState(merged, None, 0),
                self.args, epoch=self.epoch, global_step=self.global_step))
        self.logger.info(f"saved model artifacts: {out}")
        return out

    def load_lora_weights(self, path: str):
        lora, lcfg, _ = lora_mod.load_lora(path, self.device)
        self.lora_config = lcfg
        if self.mesh is not None:
            from csm_torch.parallel.sharding import shard_tree

            lora = shard_tree(lora, self.lora_layouts, self.mesh)
        self.lora_params = lora
        if self.state is not None:
            self.state = init_train_state(lora, self.tx)

    def _final_params(self) -> dict:
        if self.state is None and self.mesh is None:
            return self.params
        lora = self.gathered_state_params()
        base = self.params
        if self.mesh is not None:
            from csm_torch.parallel.sharding import unshard_tree

            base = unshard_tree(self.params, self.layouts, self.mesh)
        return lora_mod.merge_lora(base, lora, self.lora_config)


def _whole_layouts(tree: dict) -> dict:
    return {k: _whole_layouts(v) if isinstance(v, dict) else (None,) * v.dim()
            for k, v in tree.items()}
