"""``csm-torch-finetune-lora-multi`` — one LoRA adapter per speaker.

The port of the JAX package's ``csm-finetune-lora-multi``: a JSON speakers
config (a list of {name, speaker_id, audio_dir, transcript_dir, optional
alignment_dir and per-speaker overrides of the LoRA and schedule flags}),
one ``csm-torch-finetune-lora`` run a speaker into ``OUTPUT_DIR/NAME``,
and a ``summary.json``.  The flags are ``csm-torch-finetune-lora``'s.

    python -m csm_torch.cli.finetune_lora_multi --speakers-config speakers.json \\
        --model-path ckpt.pt --output-dir out/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

from csm_torch.cli.common import add_device_flag, add_parallel_args, add_tiny_test_flag
from csm_torch.cli.finetune_lora import add_lora_args, make_lora_trainer
from csm_torch.cli.train import build_tokenizers, prepare_datasets

REQUIRED_FIELDS = ("name", "speaker_id", "audio_dir", "transcript_dir")
OVERRIDABLE = (
    "lora_r", "lora_alpha", "lora_dropout", "learning_rate", "epochs",
    "batch_size", "sample_prompt", "target_modules", "target_layers",
)


def load_speaker_configs(path: str, sample_n=None):
    """The speakers config, each entry checked: its fields and directories."""
    with open(path) as f:
        configs = json.load(f)
    for i, cfg in enumerate(configs):
        for field in REQUIRED_FIELDS:
            if field not in cfg:
                raise ValueError(f"speaker config {i} missing field {field!r}")
        for d in ("audio_dir", "transcript_dir"):
            if not os.path.isdir(cfg[d]):
                raise ValueError(f"directory does not exist: {cfg[d]}")
        ad = cfg.get("alignment_dir")
        if ad and not os.path.isdir(ad):
            raise ValueError(f"alignment directory does not exist: {ad}")
    if sample_n is not None and sample_n < len(configs):
        import random

        configs = random.sample(configs, sample_n)
    return configs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Multi-speaker LoRA fine-tune (PyTorch/CUDA)")
    p.add_argument("--speakers-config", type=str, required=True,
                   help="JSON list of speaker configs (see examples/)")
    p.add_argument("--sample-speakers", type=int, default=None)
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--mimi-path", type=str, default=None)
    p.add_argument("--output-dir", type=str, default="./csm_multi_lora")
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--semantic-weight", type=float, default=100.0)
    p.add_argument("--acoustic-weight", type=float, default=1.0)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--accumulation-steps", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=2)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--val-split", type=float, default=0.1)
    p.add_argument("--val-every", type=int, default=100)
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--context-turns", type=int, default=2)
    p.add_argument("--conversational", action="store_true",
                   help="group context windows by source recording (see csm-torch-train)")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--async-checkpointing", action="store_true",
                   help="Write checkpoints on a background thread (see csm-torch-finetune-lora)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="batches collated ahead on a host thread (0 disables)")
    p.add_argument("--generate-samples", action="store_true")
    add_lora_args(p)
    add_parallel_args(p)
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    speakers = load_speaker_configs(args.speakers_config, args.sample_speakers)
    os.makedirs(args.output_dir, exist_ok=True)
    summary = []
    for cfg in speakers:
        name, sid = cfg["name"], cfg["speaker_id"]
        print(f"=== speaker {name} (id {sid}) ===")
        t0 = time.time()
        # the speaker's view of the command line, with its overrides
        sp = SimpleNamespace(**vars(args))
        sp.audio_dir = cfg["audio_dir"]
        sp.transcript_dir = cfg["transcript_dir"]
        sp.alignment_dir = cfg.get("alignment_dir")
        sp.speaker_id = sid
        sp.output_dir = os.path.join(args.output_dir, name)
        for k in OVERRIDABLE:
            if k in cfg:
                setattr(sp, k, cfg[k])
        trainer = make_lora_trainer(sp)
        text_tok, audio_tok = build_tokenizers(sp, trainer.args, trainer.device)
        train_ds, val_ds = prepare_datasets(sp, trainer.args, audio_tok, text_tok)
        trainer.prepare_optimizer(max_grad_norm=sp.max_grad_norm,
                                  accumulation_steps=sp.accumulation_steps)
        loss = trainer.train(train_ds, val_ds, batch_size=sp.batch_size, epochs=sp.epochs,
                             val_every=sp.val_every, save_every=sp.save_every, seed=sp.seed)
        paths = trainer.save_model(os.path.join(sp.output_dir, "adapter"),
                                   save_mode=sp.save_mode)
        entry = {
            "name": name,
            "speaker_id": sid,
            "final_loss": float(loss),
            "artifacts": paths,
            "train_examples": len(train_ds),
            "wall_s": round(time.time() - t0, 1),
        }
        if args.generate_samples:
            out = os.path.join(sp.output_dir, "sample.wav")
            trainer.generate_sample(getattr(sp, "sample_prompt", "Hello."), sid, out,
                                    mimi=audio_tok, text_tokenizer=text_tok)
            entry["sample"] = out
        summary.append(entry)
    summary_path = os.path.join(args.output_dir, "summary.json")
    with open(summary_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(f"wrote {summary_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
