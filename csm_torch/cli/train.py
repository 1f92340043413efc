"""``csm-torch-train`` — full-parameter fine-tuning on the card.

The port of the JAX package's ``csm-train``: data directories of (wav, txt,
optional word-alignment json), a validation split, per-component learning
rate multipliers, semantic/acoustic loss weights, gradient accumulation and
in-step microbatches, freeze flags, Adam moment dtypes, checkpoints written
in the background, resume.  ``--device`` picks the card
(the default) or the CPU; ``--tiny-test`` trains a tiny random model with a
tiny random Mimi; ``--model-path`` and ``--mimi-path`` load CSM and Mimi
checkpoint files.  The parallelism flags train over a mesh of ranks, one
process each:

    python -m csm_torch.cli.train --audio-dir DATA --tiny-test --device cpu
    python -m torch.distributed.run --nproc-per-node 2 -m csm_torch.cli.train \
        --audio-dir DATA --seq-parallel 2
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np
import torch

from csm_torch.cli.common import (
    add_device_flag,
    add_parallel_args,
    add_tiny_test_flag,
    parallel_config,
    tiny_mimi,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fine-tune CSM (PyTorch/CUDA)")
    # Data
    p.add_argument("--audio-dir", type=str, required=True,
                   help="Directory of .wav files (recursively globbed)")
    p.add_argument("--transcript-dir", type=str, default=None,
                   help="Directory of matching .txt transcripts (default: alongside the wavs)")
    p.add_argument("--alignment-dir", type=str, default=None,
                   help="Optional directory of word-alignment .json files")
    p.add_argument("--speaker-id", type=int, default=0)
    p.add_argument("--val-split", type=float, default=0.1)
    p.add_argument("--context-turns", type=int, default=2)
    p.add_argument("--conversational", action="store_true",
                   help="group context windows by source recording")
    p.add_argument("--max-seq-len", type=int, default=2048)
    # Model
    p.add_argument("--model-path", type=str, default=None,
                   help="CSM checkpoint: a torchtune ckpt.pt or .safetensors, or a "
                        "csm-torch-train checkpoint directory (files must be local)")
    p.add_argument("--mimi-path", type=str, default=None,
                   help="Mimi codec checkpoint (safetensors/pt)")
    p.add_argument("--output-dir", type=str, default="./csm_train_output")
    # Optimization
    p.add_argument("--learning-rate", type=float, default=1e-5)
    p.add_argument("--backbone-lr-multiplier", type=float, default=0.1)
    p.add_argument("--decoder-lr-multiplier", type=float, default=1.0)
    p.add_argument("--embedding-lr-multiplier", type=float, default=0.5)
    p.add_argument("--semantic-weight", type=float, default=100.0)
    p.add_argument("--acoustic-weight", type=float, default=1.0)
    p.add_argument("--weight-decay", type=float, default=0.01)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--accumulation-steps", type=int, default=1)
    p.add_argument("--grad-microbatches", type=int, default=1,
                   help="Split each batch into M microbatches within a step")
    p.add_argument("--param-dtype", choices=["f32", "bf16"], default="f32",
                   help="Master-weight dtype")
    p.add_argument("--mu-dtype", choices=["f32", "bf16"], default=None,
                   help="Adam first-moment storage dtype (default: the param dtype)")
    p.add_argument("--nu-dtype", choices=["f32", "bf16"], default=None,
                   help="Adam second-moment storage dtype (default: the param dtype)")
    p.add_argument("--freeze-backbone", action="store_true")
    p.add_argument("--freeze-decoder", action="store_true")
    p.add_argument("--freeze-embeddings", action="store_true")
    # Schedule
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--val-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--resume-from", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--async-checkpointing", action="store_true",
                   help="Write checkpoints on a background thread (the latest pointer "
                        "commits once the checkpoint is on disk)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches collated ahead on a host thread (0 disables)")
    add_parallel_args(p)
    # Samples
    p.add_argument("--generate-samples", action="store_true")
    p.add_argument("--sample-prompt", type=str, default="Hello from CSM.")
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def discover_files(args):
    """(wav, transcript, alignment or None) triples
    (reference: src/csm/cli/train.py:228-276)."""
    wavs = sorted(glob.glob(os.path.join(args.audio_dir, "**", "*.wav"), recursive=True))
    triples = []
    for wav in wavs:
        stem = os.path.splitext(os.path.basename(wav))[0]
        tdir = args.transcript_dir or os.path.dirname(wav)
        txt = os.path.join(tdir, stem + ".txt")
        if not os.path.exists(txt):
            continue
        align = None
        if args.alignment_dir:
            cand = os.path.join(args.alignment_dir, stem + ".json")
            align = cand if os.path.exists(cand) else None
        triples.append((wav, txt, align))
    return triples


def prepare_datasets(args, model_args, audio_tokenizer, text_tokenizer):
    from csm_torch.data.dataset import CSMDataset
    from csm_torch.data.processor import ContextualExampleGenerator, CSMDataProcessor

    proc = CSMDataProcessor()
    examples = []
    for wav, txt, align in discover_files(args):
        examples.extend(proc.prepare_from_audio_file(wav, txt, args.speaker_id, align))
    if not examples:
        raise SystemExit(f"no (wav, txt) pairs found under {args.audio_dir}")
    ctx = ContextualExampleGenerator(args.context_turns)
    if args.conversational:
        contextual = ctx.create_conversational_examples(examples)
    else:
        contextual = ctx.create_contextual_examples(examples)

    rng = np.random.default_rng(args.seed)
    rng.shuffle(contextual)
    n_val = int(len(contextual) * args.val_split)
    val, train = contextual[:n_val], contextual[n_val:]

    def mk(exs):
        if not exs:
            return None
        return CSMDataset(exs, text_tokenizer, audio_tokenizer, args=model_args,
                          max_seq_len=args.max_seq_len)

    return mk(train), mk(val)


def build_tokenizers(args, model_args, device):
    from csm_torch.codec.convert import load_mimi_checkpoint
    from csm_torch.codec.mimi import CSM_MIMI_CONFIG, mimi_init
    from csm_torch.data.tokenizers import ByteTokenizer, MimiAudioTokenizer, load_text_tokenizer
    from csm_torch.utils.params import tree_map

    if args.tiny_test:
        return ByteTokenizer(), tiny_mimi(model_args, device)
    if args.mimi_path:
        mimi_params = tree_map(lambda t: t.to(device), load_mimi_checkpoint(args.mimi_path))
    else:
        print("WARNING: no --mimi-path; using random codec weights")
        mimi_params = mimi_init(torch.Generator(device=device).manual_seed(1), CSM_MIMI_CONFIG,
                                device=device)
    return (
        load_text_tokenizer(allow_byte_fallback=args.allow_byte_tokenizer or None),
        MimiAudioTokenizer(mimi_params),
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from csm_torch.training.trainer import CSMTrainer
    from csm_torch.utils.device import resolve_device

    parallel = parallel_config(args)
    device = resolve_device(args.device)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, None: None}
    common = dict(
        output_dir=args.output_dir,
        learning_rate=args.learning_rate,
        backbone_lr_multiplier=args.backbone_lr_multiplier,
        decoder_lr_multiplier=args.decoder_lr_multiplier,
        embedding_lr_multiplier=args.embedding_lr_multiplier,
        semantic_weight=args.semantic_weight,
        acoustic_weight=args.acoustic_weight,
        weight_decay=args.weight_decay,
        param_dtype=dt[args.param_dtype],
        async_checkpointing=args.async_checkpointing,
        prefetch_depth=args.prefetch,
        device=device,
        parallel=parallel,
    )
    if args.tiny_test:
        from csm_torch.models.config import tiny_test_args
        from csm_torch.utils.params import random_csm_params

        model_args = tiny_test_args()
        trainer = CSMTrainer(args=model_args, params=random_csm_params(model_args, seed=0),
                             compute_dtype=torch.float32, remat=False, **common)
    else:
        trainer = CSMTrainer(model_path=args.model_path, **common)

    text_tok, audio_tok = build_tokenizers(args, trainer.args, trainer.device)
    train_ds, val_ds = prepare_datasets(args, trainer.args, audio_tok, text_tok)
    trainer.logger.info(
        f"dataset: {len(train_ds)} train / {len(val_ds) if val_ds else 0} val examples"
    )
    trainer.prepare_optimizer(
        freeze_backbone=args.freeze_backbone,
        freeze_decoder=args.freeze_decoder,
        freeze_embeddings=args.freeze_embeddings,
        max_grad_norm=args.max_grad_norm,
        accumulation_steps=args.accumulation_steps,
        mu_dtype=dt[args.mu_dtype],
        nu_dtype=dt[args.nu_dtype],
        grad_microbatches=args.grad_microbatches,
    )
    loss = trainer.train(
        train_ds, val_ds, batch_size=args.batch_size, epochs=args.epochs,
        val_every=args.val_every, save_every=args.save_every,
        resume_from=args.resume_from, seed=args.seed,
    )
    print(f"training done, final loss {loss:.4f}")

    if args.generate_samples:
        out = os.path.join(args.output_dir, "sample.wav")
        trainer.generate_sample(args.sample_prompt, args.speaker_id, out, mimi=audio_tok,
                                text_tokenizer=text_tok)
        print(f"wrote sample {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
