"""Shared CLI helpers (what ``csm-torch-train`` needs): the parallelism,
tiny-test and device flags, and the tiny random Mimi codec."""

from __future__ import annotations

import argparse

import torch

from csm_torch.codec.mimi import MimiConfig, mimi_init
from csm_torch.codec.transformer import MimiTransformerConfig
from csm_torch.data.tokenizers import MimiAudioTokenizer
from csm_torch.models.config import ModelArgs


def add_parallel_args(parser: argparse.ArgumentParser):
    """The JAX package's parallelism flags; anything but their defaults
    waits for the port of parallel training (ROADMAP.md A.11)."""
    g = parser.add_argument_group("Parallelism (not ported yet: ROADMAP.md A.11)")
    g.add_argument("--model-parallel", type=int, default=1)
    g.add_argument("--fsdp", action="store_true")
    g.add_argument("--pipeline-parallel", type=int, default=1)
    g.add_argument("--seq-parallel", type=int, default=1)
    g.add_argument("--ring-layout", choices=("auto", "zigzag", "contiguous"), default="auto")
    g.add_argument("--pp-microbatches", type=int, default=1)
    g.add_argument("--distributed", action="store_true")
    return parser


def wants_parallel(args) -> bool:
    return (args.model_parallel > 1 or args.fsdp or args.pipeline_parallel > 1
            or args.seq_parallel > 1 or args.distributed)


def add_tiny_test_flag(parser: argparse.ArgumentParser):
    parser.add_argument(
        "--tiny-test",
        action="store_true",
        help="Use a tiny random-weight model + codec (no checkpoints needed; "
        "for smoke testing in offline environments)",
    )
    parser.add_argument(
        "--allow-byte-tokenizer",
        action="store_true",
        help="Permit the degraded byte-level text tokenizer when the HF "
        "Llama-3.2 tokenizer is not in the local cache (loud warning; "
        "real-weight generation will be garbage without the real tokenizer)",
    )
    return parser


def add_device_flag(parser: argparse.ArgumentParser):
    parser.add_argument("--device", type=str, default="cuda",
                        help="Where to run: cuda (the default) or cpu")
    return parser


def tiny_mimi(model_args: ModelArgs, device) -> MimiAudioTokenizer:
    """The ``--tiny-test`` codec: random Mimi weights from seed 1 with the
    tiny model's codebook count and size and a one-layer transformer."""
    cfg = MimiConfig(
        num_quantizers=model_args.audio_num_codebooks,
        codebook_size=model_args.audio_vocab_size - 3,
        transformer=MimiTransformerConfig(num_layers=1),
    )
    gen = torch.Generator(device=device).manual_seed(1)
    return MimiAudioTokenizer(mimi_init(gen, cfg, device=device), cfg=cfg)
