"""Shared CLI helpers: the voice presets, the parallelism, tiny-test and
device flags, the tiny random Mimi codec, and ``build_generator``, which
turns a command line into a ``Generator``."""

from __future__ import annotations

import argparse

import torch

from csm_torch.codec.mimi import MimiConfig, mimi_init
from csm_torch.codec.transformer import MimiTransformerConfig
from csm_torch.data.tokenizers import MimiAudioTokenizer
from csm_torch.models.config import ModelArgs


# Voice presets of the reference's user-facing API: named voices mapped to
# speaker IDs (the JAX package's ``cli/common.py``)
VOICE_PRESETS = {
    "neutral": 0,
    "warm": 1,
    "deep": 2,
    "bright": 3,
    "soft": 4,
    "energetic": 5,
    "calm": 6,
    "clear": 7,
    "resonant": 8,
    "authoritative": 9,
}


def add_voice_args(parser: argparse.ArgumentParser):
    g = parser.add_mutually_exclusive_group()
    g.add_argument("--speaker", type=int, default=0, help="Speaker ID (default: 0)")
    g.add_argument("--voice", type=str, choices=sorted(VOICE_PRESETS), help="Voice preset name")
    return parser


def resolve_speaker(args) -> int:
    if getattr(args, "voice", None):
        sid = VOICE_PRESETS[args.voice]
        print(f"Using voice preset '{args.voice}' (speaker ID: {sid})")
        return sid
    return args.speaker


def add_parallel_args(parser: argparse.ArgumentParser):
    """The JAX package's parallelism flags.  Start the ranks with
    ``python -m torch.distributed.run --nproc-per-node N -m
    csm_torch.cli.train ...``; each rank is a process on one device."""
    g = parser.add_argument_group("Parallelism (one process per rank: torch.distributed.run)")
    g.add_argument("--model-parallel", type=int, default=1,
                   help="Tensor-parallel axis size (Megatron-style TP)")
    g.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3-style weight sharding over the data axis")
    g.add_argument("--pipeline-parallel", type=int, default=1,
                   help="Pipeline stages over a pipe axis (exclusive with "
                        "--model-parallel/--fsdp)")
    g.add_argument("--seq-parallel", type=int, default=1,
                   help="Sequence-parallel (ring attention) axis size for long-context "
                        "training; the sequence length must be a multiple of it")
    g.add_argument("--ring-layout", choices=("auto", "zigzag", "contiguous"), default="auto",
                   help="Ring-attention sequence layout: zigzag balances causal work per rank "
                        "(auto = zigzag when the sequence divides by 2*seq-parallel); "
                        "identical results either way")
    g.add_argument("--pp-microbatches", type=int, default=1,
                   help="Microbatches per step in pipeline mode (bubble fraction = "
                        "(P-1)/(M+P-1))")
    g.add_argument("--distributed", action="store_true",
                   help="Join the process group torch.distributed.run set up; with no layout "
                        "flag the ranks form the data axis")
    return parser


def wants_parallel(args) -> bool:
    return (args.model_parallel > 1 or args.fsdp or args.pipeline_parallel > 1
            or args.seq_parallel > 1 or args.distributed)


def parallel_config(args):
    """The ``ParallelConfig`` of the parallelism flags (None without any):
    joins the process group on ``args.device``'s backend
    (``parallel/distributed.initialize``); with
    ``--distributed`` alone over more than one rank, data parallelism."""
    if not wants_parallel(args):
        return None
    from csm_torch.parallel.distributed import initialize
    from csm_torch.parallel.mesh import ParallelConfig

    rank, world = initialize(args.device)
    print(f"process {rank}/{world}")
    par = ParallelConfig(model_parallel=args.model_parallel, fsdp=args.fsdp,
                         pipeline_parallel=args.pipeline_parallel,
                         pp_microbatches=args.pp_microbatches, seq_parallel=args.seq_parallel,
                         ring_layout=args.ring_layout)
    return par if par.enabled or world > 1 else None


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


def build_generator(args):
    """A Generator from parsed CLI args on ``args.device``: the tiny random
    model and codec of ``--tiny-test`` (float32, byte tokenizer), or
    ``load_csm`` of ``--model-path``/``--mimi-path`` (random weights where
    a path is missing) at the ``--flavor``'s shape in bf16, quantized as
    ``--int4``/``--int8``/``--int8-decoder`` say, with ``--kv-int8``, and
    the ``--lora-path`` adapter merged in before the quantization."""
    from csm_torch.data.tokenizers import ByteTokenizer, load_text_tokenizer
    from csm_torch.generator import Generator, load_csm
    from csm_torch.models import config
    from csm_torch.utils.device import resolve_device
    from csm_torch.utils.params import random_csm_params

    device = resolve_device(args.device)
    lora_path = getattr(args, "lora_path", None)
    if args.tiny_test and lora_path is not None:
        raise SystemExit("--lora-path needs the model its adapter was trained for: "
                         "--flavor tiny (random weights or --model-path), not --tiny-test")
    if args.tiny_test:
        margs = config.tiny_test_args()
        return Generator(random_csm_params(margs, seed=0, device=device), margs,
                         mimi=tiny_mimi(margs, device), text_tokenizer=ByteTokenizer(),
                         compute_dtype=torch.float32, device=device)
    margs = {"1b": config.csm_1b_args, "8b": config.csm_8b_args,
             "tiny": config.tiny_file_args}[args.flavor]()
    qmode = ("int4" if args.int4 else "int8" if args.int8
             else "int8-decoder" if args.int8_decoder else "none")
    return load_csm(
        args.model_path, mimi_path=args.mimi_path, compute_dtype=torch.bfloat16,
        quantize=qmode, kv_int8=args.kv_int8, args=margs, device=device, lora_path=lora_path,
        text_tokenizer=load_text_tokenizer(allow_byte_fallback=args.allow_byte_tokenizer or None),
    )
