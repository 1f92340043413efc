"""``csm-torch-finetune-lora`` — LoRA fine-tuning on the card.

The port of the JAX package's ``csm-finetune-lora``: the LoRA flags (rank,
alpha, dropout, target modules and layers, backbone / decoder), a frozen
base held as it is, as int8 (``--int8-base``) or as grouped int4
(``--int4-base``), the training flags of ``csm-torch-train``, the save
modes ``lora`` (an adapter directory), ``full`` (a checkpoint of the merged
weights) and ``both``, and sample generation.  ``--flavor 8b`` needs a
quantized base.  ``--device`` picks the card (the default) or the CPU;
``--tiny-test`` trains adapters on a tiny random model.  The parallelism
flags train over a mesh of ranks (data, pipeline or sequence layouts; one
process a rank, ``python -m torch.distributed.run``).

    python -m csm_torch.cli.finetune_lora --audio-dir DATA --model-path ckpt.pt \\
        --lora-r 16 --target-modules q_proj k_proj v_proj o_proj --save-mode both
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from csm_torch.cli.common import (add_device_flag, add_parallel_args, add_tiny_test_flag,
                                   parallel_config)
from csm_torch.cli.train import build_tokenizers, prepare_datasets


def add_lora_args(p: argparse.ArgumentParser):
    g = p.add_argument_group("LoRA")
    g.add_argument("--lora-r", type=int, default=8)
    g.add_argument("--lora-alpha", type=float, default=16.0)
    g.add_argument("--lora-dropout", type=float, default=0.0)
    g.add_argument("--target-modules", type=str, nargs="*", default=["q_proj", "v_proj"],
                   choices=["q_proj", "k_proj", "v_proj", "o_proj",
                            "gate_proj", "up_proj", "down_proj"])
    g.add_argument("--target-layers", type=int, nargs="*", default=None)
    g.add_argument("--no-backbone-lora", action="store_true")
    g.add_argument("--no-decoder-lora", action="store_true")
    g.add_argument("--save-mode", choices=["lora", "full", "both"], default="lora")
    g.add_argument("--int8-base", action="store_true",
                   help="Store the frozen base's transformer weights as int8 (per-out-channel "
                        "scales, dequantized in the matmul): half the bf16 weight memory; the "
                        "adapters stay float and absorb the quantization error (QLoRA)")
    g.add_argument("--int4-base", action="store_true",
                   help="Store the frozen base as grouped int4: a quarter of the bf16 weight "
                        "memory, a larger quantization error for the adapters to absorb")
    return p


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="LoRA fine-tune CSM (PyTorch/CUDA)")
    p.add_argument("--audio-dir", type=str, required=True)
    p.add_argument("--transcript-dir", type=str, default=None)
    p.add_argument("--alignment-dir", type=str, default=None)
    p.add_argument("--speaker-id", type=int, default=0)
    p.add_argument("--val-split", type=float, default=0.1)
    p.add_argument("--context-turns", type=int, default=2)
    p.add_argument("--conversational", action="store_true",
                   help="group context windows by source recording (see csm-torch-train)")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--model-path", type=str, default=None,
                   help="CSM checkpoint: a torchtune ckpt.pt or .safetensors, or a "
                        "csm-torch-train checkpoint directory (files must be local)")
    p.add_argument("--flavor", choices=("1b", "8b"), default="1b",
                   help="Model shape: 1b (default) or 8b (needs --int8-base or --int4-base)")
    p.add_argument("--mimi-path", type=str, default=None)
    p.add_argument("--output-dir", type=str, default="./csm_lora_output")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--semantic-weight", type=float, default=100.0)
    p.add_argument("--acoustic-weight", type=float, default=1.0)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--accumulation-steps", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--val-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume-from", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--async-checkpointing", action="store_true",
                   help="Write checkpoints on a background thread (the latest pointer commits "
                        "once the checkpoint is on disk)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches collated ahead on a host thread (0 disables)")
    add_parallel_args(p)
    p.add_argument("--generate-samples", action="store_true")
    p.add_argument("--sample-prompt", type=str, default="Hello from CSM.")
    add_lora_args(p)
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def make_lora_trainer(args):
    """The ``CSMLoRATrainer`` of a command line (or of a speaker's view of
    one, ``finetune_lora_multi``)."""
    from csm_torch.training.trainer import CSMLoRATrainer
    from csm_torch.utils.device import resolve_device

    common = dict(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        lora_r=args.lora_r,
        lora_alpha=args.lora_alpha,
        lora_dropout=args.lora_dropout,
        target_modules=args.target_modules,
        target_layers=args.target_layers,
        apply_to_backbone=not args.no_backbone_lora,
        apply_to_decoder=not args.no_decoder_lora,
        quant_base="int4" if args.int4_base else "int8" if args.int8_base else None,
        semantic_weight=args.semantic_weight,
        acoustic_weight=args.acoustic_weight,
        async_checkpointing=getattr(args, "async_checkpointing", False),
        prefetch_depth=getattr(args, "prefetch", 2),
        device=resolve_device(args.device),
        parallel=parallel_config(args),
    )
    if args.tiny_test:
        from csm_torch.models.config import tiny_test_args
        from csm_torch.utils.params import random_csm_params

        margs = tiny_test_args()
        return CSMLoRATrainer(args=margs, params=random_csm_params(margs, seed=0),
                              compute_dtype=torch.float32, remat=False, **common)
    flavor_args = None
    if getattr(args, "flavor", "1b") == "8b":
        from csm_torch.models.config import csm_8b_args

        if common["quant_base"] is None:
            raise SystemExit("--flavor 8b needs a quantized frozen base to fit one card: "
                             "pass --int8-base or --int4-base")
        flavor_args = csm_8b_args()
    return CSMLoRATrainer(model_path=args.model_path, args=flavor_args, **common)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trainer = make_lora_trainer(args)
    text_tok, audio_tok = build_tokenizers(args, trainer.args, trainer.device)
    train_ds, val_ds = prepare_datasets(args, trainer.args, audio_tok, text_tok)
    trainer.logger.info(
        f"dataset: {len(train_ds)} train / {len(val_ds) if val_ds else 0} val examples")
    trainer.prepare_optimizer(max_grad_norm=args.max_grad_norm,
                              accumulation_steps=args.accumulation_steps)
    loss = trainer.train(
        train_ds, val_ds, batch_size=args.batch_size, epochs=args.epochs,
        val_every=args.val_every, save_every=args.save_every,
        resume_from=args.resume_from, seed=args.seed,
    )
    print(f"LoRA training done, final loss {loss:.4f}")
    paths = trainer.save_model(os.path.join(args.output_dir, "adapter"), save_mode=args.save_mode)
    print(f"saved: {paths}")
    if args.generate_samples:
        out = os.path.join(args.output_dir, "sample.wav")
        trainer.generate_sample(args.sample_prompt, args.speaker_id, out, mimi=audio_tok,
                                text_tokenizer=text_tok)
        print(f"wrote sample {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
