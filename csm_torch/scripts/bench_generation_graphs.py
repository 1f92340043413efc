"""Measurements of the graphed generation entry that ``chip_smoke.py`` does
not gate on.

``generate_audio_tokens_jit`` captures, per key (B, bucket, max_frames,
topk, dtypes), a CUDA graph of the prefill frame and one of the frame step,
and replays the step ``CHUNK`` times between host reads of ``done``.  This
script measures, on random weights from seed 0 (``ByteTokenizer``, topk 50):

  * ``chunk``: ``generate_short`` (CSM-1B bf16, bucket 64, 2000 ms) through
    the graphs at CHUNK 1, 4, 8 and 16, forward then back, with the card's
    SM and memory clocks, power draw and throttle reasons sampled by
    ``nvidia-smi`` every 50 ms during each run;
  * ``replay``: that key's step graph, the host's time to enqueue one replay
    and the device's time for one with 20 queued back to back behind a
    sleeping kernel (no host gap between them);
  * ``cache``: a full ``GraphCache`` (``GRAPH_CACHE_SIZE`` keys: B 1 and 2
    at buckets 64, 128, 256 and 512, each at ``Generator.generate``'s
    default 90 s, 1125 frames) at CSM-1B bf16 and at 8B int4: for each key
    the first call's prefill, capture included, and a second call's; then
    the peak allocated and reserved device memory with every key held,
    beside the weights' own.  The calls are the real entry's, stopped after
    the prefill frame (its read of ``done`` reports every row done), so no
    key runs its 1125 frames.

    python -m csm_torch.scripts.bench_generation_graphs [--skip-8b]

Needs a CUDA card and nvcc.  Prints the card's name and power limit, one
JSON line per part and a last JSON line with everything.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from csm_torch import csm_1b_args, load_csm
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models import generation
from csm_torch.models.config import csm_8b_args
from csm_torch.ops import decode_attention, flash_attention, int4_matmul
from csm_torch.utils.cuda_build import build_all

SHORT_TEXT = "Hello from the port."
CHUNKS = (1, 4, 8, 16)
REPLAYS = 20
CACHE_KEYS = tuple((B, bucket) for bucket in (64, 128, 256, 512) for B in (1, 2))
CACHE_FRAMES = 1125  # Generator.generate's default 90 s of 80 ms frames


def sampled(call):
    """``call()`` while one ``nvidia-smi`` process samples the card every
    50 ms: medians of the SM and memory clocks (MHz) and the power draw (W,
    as nvidia-smi averages it), and the throttle-reason bitmasks seen
    ("not measured" without samples); the process is stopped either way."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,clocks_throttle_reasons.active",
         "--format=csv,noheader,nounits", "-lms", "50"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        call()
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
    samples, reasons = [], set()
    for line in out.splitlines():
        fields = [f.strip() for f in line.split(",")]
        try:
            samples.append(tuple(float(x) for x in fields[:3]))
        except ValueError:
            continue
        reasons.update(fields[3:4])
    if not samples:
        return dict.fromkeys(("sm_mhz", "mem_mhz", "power_w", "throttle"), "not measured")
    return {"sm_mhz": statistics.median(x[0] for x in samples),
            "mem_mhz": statistics.median(x[1] for x in samples),
            "power_w": statistics.median(x[2] for x in samples), "throttle": sorted(reasons)}


def chunk_sweep(gen):
    """frames/s of ``generate_short`` through the graphs at each CHUNK, in
    turns forward and back, with the card's clocks beside each run."""
    keep = generation.CHUNK
    res = {c: [] for c in CHUNKS}
    gen.generate(SHORT_TEXT, max_audio_length_ms=2000)  # captures the key
    try:
        for order in (CHUNKS, CHUNKS[::-1]):
            for c in order:
                generation.CHUNK = c
                card = sampled(lambda: gen.generate(SHORT_TEXT, max_audio_length_ms=2000))
                res[c].append(dict(card, frames_per_s=gen.last_stats["frames_per_s"]))
    finally:
        generation.CHUNK = keep
    return res


def replay_times(gen):
    """The step graph of the last key used (``generate_short``'s): host
    enqueue time of one replay, and device time of one with ``REPLAYS``
    queued behind a sleeping kernel.  The replays follow a prefill replay,
    so the step's frame index stays inside the key's buffers."""
    fg = next(reversed(gen.graphs._items.values()))
    if REPLAYS >= fg.key.max_frames:
        raise ValueError(f"{REPLAYS} steps do not fit {fg.key.max_frames} frames")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fg.run_prefill()
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of the card's cycles: longer than the enqueue
    start.record()
    t0 = time.perf_counter()
    for _ in range(REPLAYS):
        fg.run_step()
    host_ms = (time.perf_counter() - t0) * 1e3 / REPLAYS
    end.record()
    torch.cuda.synchronize()
    return {"host_enqueue_ms": host_ms, "device_ms": start.elapsed_time(end) / REPLAYS,
            "n": REPLAYS}


@contextlib.contextmanager
def prefill_only():
    """``generate_audio_tokens_jit`` stops after its prefill frame: its read
    of ``done`` reports every row done."""
    keep = generation.FrameGraphs.all_done
    generation.FrameGraphs.all_done = lambda fg: keep(fg) or True
    try:
        yield
    finally:
        generation.FrameGraphs.all_done = keep


def full_cache(gen, seed=0):
    """Every key of ``CACHE_KEYS`` at ``CACHE_FRAMES`` through the
    Generator's own ``GraphCache``: the first call's capture and prefill,
    a second call's prefill, then the device memory with every key held."""
    args, dev = gen.args, gen.device
    K = args.audio_num_codebooks
    rng = np.random.default_rng(seed)
    gen.graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    weights = torch.cuda.memory_allocated() / 2**30
    keys = []
    with prefill_only():
        for B, bucket in CACHE_KEYS:
            lens = np.asarray([bucket - 10 - 7 * b for b in range(B)], np.int32)
            tokens = np.zeros((B, bucket, K + 1), np.int32)
            mask = np.zeros((B, bucket, K + 1), bool)
            for b, n in enumerate(lens):
                tokens[b, :n, -1] = rng.integers(1, args.text_vocab_size, n)
                mask[b, :n, -1] = True
            runs = [generation.generate_audio_tokens_jit(
                gen.params, args, tokens, mask, lens, max_frames=CACHE_FRAMES, temperature=0.9,
                topk=50, compute_dtype=gen.compute_dtype, device=dev, kv_dtype=gen.kv_dtype,
                generator=torch.Generator(dev).manual_seed(seed), graphs=gen.graphs)
                for _ in range(2)]
            keys.append({"B": B, "bucket": bucket, "capture_s": runs[0].capture_s,
                         "first_prefill_ms": 1e3 * (runs[0].capture_s + runs[0].prefill_s),
                         "warm_prefill_ms": 1e3 * runs[1].prefill_s})
    torch.cuda.synchronize()
    if len(gen.graphs) != len(CACHE_KEYS):
        raise AssertionError(f"{len(gen.graphs)} keys held, {len(CACHE_KEYS)} captured")
    out = {"keys": keys, "frames": CACHE_FRAMES, "weights_gib": weights,
           "held_allocated_gib": torch.cuda.memory_allocated() / 2**30,
           "held_reserved_gib": torch.cuda.memory_reserved() / 2**30,
           "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    gen.graphs.clear()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-8b", action="store_true", help="leave out the 8B int4 full cache")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    build_all([decode_attention.SOURCE, flash_attention.SOURCE, int4_matmul.SOURCE])
    result = {"card": card}
    tok = ByteTokenizer()
    gen = load_csm(args=csm_1b_args(), compute_dtype=torch.bfloat16, text_tokenizer=tok)
    result["chunk"] = chunk_sweep(gen)
    print(json.dumps({"chunk": result["chunk"]}), flush=True)
    result["replay"] = replay_times(gen)
    print(json.dumps({"replay": result["replay"]}), flush=True)
    result["cache_1b_bf16"] = full_cache(gen)
    print(json.dumps({"cache_1b_bf16": result["cache_1b_bf16"]}), flush=True)
    gen.close()
    del gen
    torch.cuda.empty_cache()
    if not opts.skip_8b:
        gen = load_csm(args=csm_8b_args(), quantize="int4", text_tokenizer=tok)
        result["cache_8b_int4"] = full_cache(gen)
        print(json.dumps({"cache_8b_int4": result["cache_8b_int4"]}), flush=True)
        gen.close()
    print(json.dumps(result))


if __name__ == "__main__":
    main()
