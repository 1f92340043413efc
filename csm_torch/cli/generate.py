"""``csm-torch-generate`` — speech generation on the card.

The port of the JAX package's ``csm-generate``: a CSM checkpoint and a Mimi
checkpoint from local files (random weights where a path is missing),
voice presets, context segments from audio/text/speaker triples, sampling
controls and seed, the quantized modes and the 8B flavor, the watermark
(on unless ``--no-watermark``), and a stats line with the real-time factor.
``--device`` picks the card (the default) or the CPU; ``--tiny-test`` runs
a tiny random model and codec.  ``--stream`` generates through
``Generator.generate_streaming``, prints each chunk as it arrives and
watermarks the whole clip at the end.  ``--lora-path`` merges a LoRA
adapter directory (``csm-torch-finetune-lora --save-mode lora``) into the
weights at load.

    python -m csm_torch.cli.generate --model-path ckpt.pt --mimi-path model.safetensors \\
        --text "Hello." --output audio.wav
"""

from __future__ import annotations

import argparse
import sys
import time

from csm_torch.cli.common import (
    add_device_flag,
    add_tiny_test_flag,
    add_voice_args,
    build_generator,
    resolve_speaker,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate speech with CSM (PyTorch/CUDA)")
    p.add_argument("--model-path", type=str, default=None,
                   help="CSM checkpoint: a torchtune ckpt.pt or .safetensors, or a "
                        "csm-torch-train checkpoint directory (files must be local)")
    p.add_argument("--lora-path", type=str, default=None,
                   help="LoRA adapter directory (csm-torch-finetune-lora --save-mode lora), "
                        "merged into the base at load")
    p.add_argument("--mimi-path", type=str, default=None,
                   help="Mimi codec checkpoint (safetensors/pt)")
    p.add_argument("--text", type=str, required=True)
    add_voice_args(p)
    p.add_argument("--output", type=str, default="audio.wav")
    p.add_argument("--context-audio", type=str, nargs="*")
    p.add_argument("--context-text", type=str, nargs="*")
    p.add_argument("--context-speaker", type=int, nargs="*")
    p.add_argument("--max-audio-length-ms", type=int, default=10_000)
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--seed", type=int, default=0, help="Sampling RNG seed")
    p.add_argument("--int8", action="store_true", help="int8 weight-only quantization")
    p.add_argument("--int8-decoder", action="store_true",
                   help="int8-quantize only the acoustic decoder (the backbone and "
                        "codebook-0 logits stay as in bf16)")
    p.add_argument("--int4", action="store_true",
                   help="grouped int4 weight-only quantization (the fused-dequant kernel)")
    p.add_argument("--flavor", choices=("1b", "8b", "tiny"), default="1b",
                   help="Model shape of --model-path: 1b (default), 8b (loads quantized "
                        "a few layers at a time: needs --int8 or --int4), or tiny (tiny "
                        "layers with the full 1B token geometry: the file-format fixture)")
    p.add_argument("--kv-int8", action="store_true", help="int8 KV cache")
    p.add_argument("--no-watermark", action="store_true",
                   help="Skip watermarking the generated audio")
    p.add_argument("--watermark-ckpt", type=str, default=None,
                   help="Directory with silentcipher torch checkpoints")
    p.add_argument("--stream", action="store_true",
                   help="Stream generation: audio chunks of --chunk-frames frames as they are "
                        "decoded (carried codec state), their arrival times printed; the "
                        "watermark goes on the whole clip at the end")
    p.add_argument("--chunk-frames", type=int, default=6, help="Frames per streamed chunk")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="Write a torch.profiler trace of the generation to DIR")
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def load_context(args, generator):
    from csm_torch.data.audio import load_audio
    from csm_torch.generator import Segment

    if not args.context_audio:
        return []
    if not (args.context_text and args.context_speaker) or not (
        len(args.context_audio) == len(args.context_text) == len(args.context_speaker)
    ):
        raise ValueError("--context-audio requires matching --context-text and "
                         "--context-speaker lists")
    return [Segment(speaker=s, text=t, audio=load_audio(a, generator.sample_rate))
            for a, t, s in zip(args.context_audio, args.context_text, args.context_speaker)]


def tiny_test_limit_ms(generator, tokens) -> int:
    """The audio the tiny model's short context leaves room for after a
    prompt of ``tokens`` (80 ms a frame), 0 when it leaves none."""
    from csm_torch.models.generation import PROMPT_BUCKETS, bucket_length

    try:
        bucket = bucket_length(
            tokens.shape[0], tuple(b for b in PROMPT_BUCKETS if b <= generator.max_seq_len))
    except ValueError:
        return 0
    return (generator.max_seq_len - bucket) * 80


def stream(args, generator, speaker, context):
    """``--stream``: the chunks of ``generate_streaming`` with their arrival
    times, then the watermark on their concatenation; fills
    ``generator.last_stats`` with wall s, RTF, frames/s and watermark s."""
    import numpy as np

    t0 = time.perf_counter()
    chunks = []
    for i, (chunk, _) in enumerate(generator.generate_streaming(
            args.text, speaker=speaker, context=context,
            max_audio_length_ms=args.max_audio_length_ms, temperature=args.temperature,
            topk=args.topk, seed=args.seed, chunk_frames=args.chunk_frames)):
        chunks.append(chunk)
        print(f"  {'first audio' if i == 0 else f'chunk {i}'}: "
              f"+{len(chunk) / generator.sample_rate * 1000:.0f} ms audio at "
              f"t={time.perf_counter() - t0:.3f}s", flush=True)
    audio = np.concatenate(chunks)
    watermark_s = 0.0
    if generator.watermarker is not None and audio.shape[0]:
        t_wm = time.perf_counter()
        audio, _ = generator.watermarker(audio, generator.sample_rate)
        watermark_s = time.perf_counter() - t_wm
    wall = time.perf_counter() - t0
    generator.last_stats = {
        "wall_s": wall, "watermark_s": watermark_s, "chunks": len(chunks),
        "rtf": len(audio) / generator.sample_rate / max(wall, 1e-9),
        "frames_per_s": sum(len(c) for c in chunks) / 1920 / max(wall, 1e-9),
    }
    return np.asarray(audio, np.float32)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    speaker = resolve_speaker(args)

    print("Loading model...")
    t0 = time.time()
    generator = build_generator(args)
    if not args.no_watermark:
        from csm_torch.watermarking import load_watermarker, watermark

        wmarker = load_watermarker(args.watermark_ckpt, device=generator.device)
        generator.watermarker = lambda audio, sr: watermark(wmarker, audio, sr)
    print(f"Model ready in {time.time() - t0:.1f}s")

    context = load_context(args, generator)
    if args.tiny_test:
        # the tiny model's context is short: clamp the default budget to
        # what the prompt's bucket leaves room for instead of failing
        tokens, _ = generator._build_prompt(args.text, speaker, context)
        limit_ms = tiny_test_limit_ms(generator, tokens)
        if limit_ms <= 0:
            print(f"--tiny-test: prompt ({tokens.shape[0]} frames) fills the "
                  f"tiny context; shorten --text", file=sys.stderr)
            return 1
        if args.max_audio_length_ms > limit_ms:
            print(f"--tiny-test: clamping --max-audio-length-ms to {limit_ms}")
            args.max_audio_length_ms = limit_ms
    print(f"Generating: {args.text!r} (speaker {speaker}, {len(context)} context segments)")
    from csm_torch.utils.observability import profile_trace

    with profile_trace(args.profile, enabled=args.profile is not None):
        if args.stream:
            audio = stream(args, generator, speaker, context)
        else:
            audio = generator.generate(
                args.text, speaker=speaker, context=context,
                max_audio_length_ms=args.max_audio_length_ms, temperature=args.temperature,
                topk=args.topk, seed=args.seed,
            )

    from csm_torch.data.audio import save_wav

    save_wav(args.output, audio, generator.sample_rate)
    s = generator.last_stats
    print(f"Wrote {args.output}: {len(audio) / generator.sample_rate:.2f}s audio "
          f"in {s['wall_s']:.2f}s (RTF {s['rtf']:.2f}, {s['frames_per_s']:.1f} frames/s, "
          f"watermark {1e3 * s['watermark_s']:.1f} ms)")
    if args.debug:
        print("timing_stats:", {k: round(v, 4) for k, v in s.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
