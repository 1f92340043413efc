"""``csm-torch-serve`` — batch serving over the continuous-batching server.

The port of the JAX package's ``csm-serve`` in its ``--requests FILE``
mode: a JSONL file of requests, served through one ``BatchedServer``
(csm_torch/serving.py), one wav per request (Mimi decode, then the
watermark unless ``--no-watermark``), and a stats line.  ``--device``
picks the card (the default) or the CPU; ``--tiny-test`` runs a tiny
random model and codec.  ``--http``, ``--follow``, ``--stream``,
``--prefix``, ``--window``, ``--adapter`` and ``--lora-path`` wait for
later slices and raise.

Request lines: {"id": str|int, "text": "...", "speaker": 0,
                "max_audio_length_ms": 10000,
                "context": [{"audio": "path.wav", "text": "...", "speaker": 1}, ...]}

    python -m csm_torch.cli.serve --requests reqs.jsonl --output-dir out/ \\
        --model-path ckpt.pt --mimi-path model.safetensors --n-slots 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from csm_torch.cli.common import add_device_flag, add_tiny_test_flag, build_generator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Serve CSM TTS requests (PyTorch/CUDA)")
    p.add_argument("--model-path", type=str, default=None)
    p.add_argument("--flavor", choices=("1b", "8b", "tiny"), default="1b",
                   help="Model shape of --model-path: 1b (default), 8b (loads quantized a "
                        "few layers at a time: needs --weight-dtype int8 or int4), or tiny")
    p.add_argument("--mimi-path", type=str, default=None)
    p.add_argument("--adapter", action="append", default=None, metavar="NAME=PATH",
                   help="multi-LoRA serving (not ported yet: ROADMAP.md A.10b)")
    p.add_argument("--lora-path", type=str, default=None,
                   help="LoRA adapter directory (not ported yet: ROADMAP.md A.10b)")
    p.add_argument("--prefix", action="append", default=None, metavar="NAME=FILE.json",
                   help="shared context prefix (not ported yet: ROADMAP.md A.9)")
    p.add_argument("--requests", type=str, default=None, help="JSONL file of requests")
    p.add_argument("--output-dir", type=str, default="served")
    p.add_argument("--n-slots", type=int, default=8, help="Concurrent decode slots")
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--window", type=int, default=None,
                   help="sliding-window KV (not ported yet: ROADMAP.md A.9)")
    p.add_argument("--chunk-size", type=int, default=8, help="Decode frames per host round trip")
    p.add_argument("--ramp-chunk", type=int, default=None,
                   help="Short decode chunk (< chunk-size) for the step right after an admission")
    p.add_argument("--pipelined", action=argparse.BooleanOptionalAction, default=True,
                   help="Keep one decode chunk in flight (on by default)")
    p.add_argument("--kv-dtype", choices=("bf16", "int8"), default="bf16")
    p.add_argument("--weight-dtype", choices=("bf16", "int8", "int8-decoder", "int4", "auto"),
                   default="bf16")
    p.add_argument("--temperature", type=float, default=0.9)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--seed", type=int, default=0, help="Sampling RNG seed")
    p.add_argument("--no-watermark", action="store_true")
    p.add_argument("--watermark-ckpt", type=str, default=None)
    p.add_argument("--follow", action="store_true",
                   help="stdin daemon (not ported yet: ROADMAP.md A.9)")
    p.add_argument("--http", type=str, default=None, metavar="[HOST:]PORT",
                   help="HTTP daemon (not ported yet: ROADMAP.md A.9)")
    p.add_argument("--warmup", action="store_true",
                   help="Run (on a card: capture) every serving function before the requests")
    p.add_argument("--stream", action="store_true",
                   help="per-request audio streaming (not ported yet: ROADMAP.md A.9 and A.14)")
    add_tiny_test_flag(p)
    add_device_flag(p)
    return p


def load_requests(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _refuse_unported(args) -> None:
    from csm_torch.generator import _waits

    for flag, what, item in (
        (args.http, "the HTTP daemon (--http)", "A.9, the next serving PR"),
        (args.follow, "the stdin daemon (--follow)", "A.9, the next serving PR"),
        (args.stream, "per-request audio streaming (--stream)", "A.9 and A.14"),
        (args.prefix, "shared-prefix serving (--prefix)", "A.9, the next serving PR"),
        (args.window is not None, "sliding-window serving (--window)", "A.9, the next serving PR"),
        (args.adapter, "multi-LoRA serving (--adapter)", "A.10b"),
        (args.lora_path is not None, "LoRA adapters (--lora-path)", "A.10b"),
    ):
        if flag:
            raise _waits(what, item)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    if args.requests is None:
        print("--requests is required", file=sys.stderr)
        return 2
    raw = load_requests(args.requests)
    if not raw:
        print("no requests", file=sys.stderr)
        return 1
    from csm_torch.data.audio import load_audio, save_wav
    from csm_torch.generator import MS_PER_FRAME, Segment
    from csm_torch.models.generation import PROMPT_BUCKETS, bucket_length
    from csm_torch.serving import BatchedServer, StreamRequest

    print(f"Loading model... ({len(raw)} requests)")
    t0 = time.time()
    # the weights load at the server's dtype (the 8B flavor can only load
    # quantized); the server keeps a tree that is quantized already
    wd = args.weight_dtype
    args.int4, args.int8, args.int8_decoder = wd == "int4", wd in ("int8", "auto"), wd == "int8-decoder"
    args.kv_int8 = False  # the server's own cache: --kv-dtype
    generator = build_generator(args)
    if args.tiny_test:
        args.max_seq_len = min(args.max_seq_len, generator.max_seq_len)
    wmark = None
    if not args.no_watermark:
        from csm_torch.watermarking import load_watermarker, watermark

        w = load_watermarker(args.watermark_ckpt, device=generator.device)
        wmark = lambda audio, sr: watermark(w, audio, sr)  # noqa: E731
    print(f"Model ready in {time.time() - t0:.1f}s")

    def to_stream_request(i, r):
        ctx = [Segment(speaker=int(c["speaker"]), text=c["text"],
                       audio=load_audio(c["audio"], generator.sample_rate))
               for c in r.get("context", [])]
        tokens, mask = generator._build_prompt(r["text"], int(r.get("speaker", 0)), ctx)
        try:  # the server's check: the prompt's bucket plus the frame budget must fit
            bucket = bucket_length(
                tokens.shape[0], tuple(b for b in PROMPT_BUCKETS if b <= args.max_seq_len))
        except ValueError:
            bucket = args.max_seq_len
        if bucket + 1 > args.max_seq_len:
            print(f"  skipping {r.get('id', i)}: prompt ({tokens.shape[0]} frames, bucket "
                  f"{bucket}) leaves no room in max_seq_len {args.max_seq_len}", file=sys.stderr)
            return None
        budget_ms = float(r.get("max_audio_length_ms", 10_000))
        max_frames = max(1, min(int(budget_ms / MS_PER_FRAME), args.max_seq_len - bucket))
        return StreamRequest(tokens, mask, max_frames=max_frames, request_id=r.get("id", i))

    server = BatchedServer(
        generator.params, generator.args, n_slots=args.n_slots, max_seq_len=args.max_seq_len,
        temperature=args.temperature, topk=args.topk, compute_dtype=generator.compute_dtype,
        chunk_size=args.chunk_size, ramp_chunk=args.ramp_chunk, weight_dtype=wd,
        kv_dtype=args.kv_dtype, pipelined=args.pipelined, device=generator.device,
    )
    server.reset(args.seed)
    if args.warmup:
        print("Warming serving functions...", flush=True)
        print(f"Warmup done in {server.warmup(verbose=True):.1f}s", flush=True)
        server.reset(args.seed)

    requests, seen = [], set()
    for i, r in enumerate(raw):
        sr = to_stream_request(i, r)
        if sr is None:
            continue
        if sr.request_id in seen:  # one wav path per id
            print(f"  duplicate id {sr.request_id!r} rejected", file=sys.stderr)
            continue
        seen.add(sr.request_id)
        requests.append(sr)
    if not requests:
        print("no servable requests", file=sys.stderr)
        return 1
    os.makedirs(args.output_dir, exist_ok=True)
    t0 = time.time()
    results, stats = server.run(requests)
    wall = time.time() - t0
    for res in results:
        out = os.path.join(args.output_dir, f"{res.request_id}.wav")
        n = res.frames.shape[0]
        audio = generator.mimi.decode(res.frames.T) if n else np.zeros(0, np.float32)
        if wmark is not None and audio.shape[0]:
            audio, _ = wmark(audio, generator.sample_rate)
        save_wav(out, audio, generator.sample_rate)
        print(f"  {out}: {n} frames ({n * MS_PER_FRAME / 1000:.2f}s)")
    print(f"Served {len(results)} requests in {wall:.2f}s: {stats['total_frames']} frames, "
          f"{stats['frames_per_s']:.1f} frames/s decode, "
          f"aggregate RTF {stats['aggregate_rtf']:.2f} "
          f"(weights {server.weight_dtype}, {args.n_slots} slots)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
