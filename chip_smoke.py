#!/usr/bin/env python3
"""Run the csm_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) if anything
is wrong:

  1. a CUDA card is required; its name and power limit are printed;
  2. the kernels build from csm_torch/csrc (one nvcc per source, in
     parallel) into build/kernels/;
  3. each kernel is held against its plain PyTorch version in bf16 at the
     shapes of the main path (decode at every cache length a generate
     attends, with few live keys in a long cache, and with one live key
     tile masked shown to fail its tolerance, its launch-weighted time of
     a frame and a launch floor beside it; the flash forward at the
     prefill's and at the training's, with a dropped key tile shown to fail
     its tolerance; the int4 matmul at every CSM-1B and 8B projection, and
     at serving's M = 8 and 64 (and 16, the decoder's S=2 call at 8 slots),
     with its launch-weighted time of a frame; decode at serving's batches:
     the backbone at 8 and 64 slots, the decoder at 8 and 64, the 8B
     backbone at 8, ragged live keys and dead rows, and 8 rows over a full
     sliding-window ring (positions out of column order, negative after a
     re-anchor, a dead row); the flash forward after a prefix (a 300-frame
     prefix in its 512 bucket, a 256-frame suffix from position 300 in a
     2048-column row); the matvec at the CSM-1B backbone's four
     projections; decode's int8 form over an int8-KV cache at T=89, at
     serving's 8 and 64 slots and over the full ring, its library figure
     ``dequantize_kv`` + SDPA, two calls), and timed beside that plain
     version, one PyTorch library call computing the same function, and its
     bound (for decode, from the live keys only);
  4. the main path runs at CSM-1B width on random weights: Generator.generate
     (prompt bucket 64), generate (bucket 256: prefill through the flash
     kernel) and generate_batch of two prompts, with the kernels' launch
     counts held to what the path must launch; then the quantized path:
     int4 weights at CSM-1B width (generate and generate_batch, int4 kernel
     launches counted) and at 8B width (peak device memory recorded), and
     short runs of int8, int8-decoder and the int8 KV cache (decode's int8
     form on every backbone step; its peak memory and frames/s beside a
     bf16 cache on the same weights, in turns).  The Generator
     runs through its CUDA graphs (the prefill frame and the frame step,
     replayed), and the launch counts hold under replay; beside each main
     run (generate_short, generate_long, generate_batch, int4_generate_short,
     the 8B and the int8-KV runs) the eager loop runs in the same call, in
     turns, with frames/s, RTF, prefill ms and peak memory of both, and at
     topk=1 and at topk=50 the two give equal codes;
  4b. the user's path from files at CSM-1B width: a 3.1 GB bf16 torchtune
     ``ckpt.pt`` of seed 0's weights and SilentCipher-layout files in a
     temporary directory; ``csm-torch-generate`` run in process from them
     (the loaded weights bit-equal to the written ones, codes equal to the
     in-memory model's at topk=1, decode launches held to phase 4's
     formula, load seconds and RTF with and without the watermark); the
     ``csm-torch-verify`` CLI on its wav (exit 0 or 1: random weights); on
     the port's random watermark weights the key recovered on the card with
     the CNN bypassed, ``encode_wav`` and the decoder's logits card against
     CPU, ``encode_wav`` ms and ``decode_wav`` (52 shifts) seconds, TFLOP/s
     and peak memory at 10 s and 60 s;
  4c. continuous-batching serving (``csm_torch.serving.BatchedServer``)
     at CSM-1B width on the JAX serving bench's protocol (48-frame prompts,
     63 frames a request, 2 x n_slots requests, a 1024-column cache, chunk
     8, temperature 0.9, topk 50) through the CUDA graphs ``warmup``
     captures: bf16 at 8 and 64 slots, synchronous and pipelined, the
     8-slot run also without graphs (8 requests) after it and a window
     of 256-bucket prompts (flash prefill); the int8 KV cache and int4
     weights at 8 slots; 8B int4 at 8 slots.  Every request completes with
     codes in range, every slot frees, the launches equal what the steps
     and prefills must launch, and a cancel frees its slot and leaves the
     other streams' codes equal; frames/s, RTF, first-frame times, chunk
     wall times, warmup seconds, peak memory and a profile's device-busy
     share are recorded.  At topk=1, 8 served streams against each one
     generated alone: in float32 (TF32 off) each agrees, or parts on a
     tie of its logits (margin under 1e-3 of their largest, held); in bf16
     the leading frames that agree and the margin where they part are
     recorded.  A tiny float32 server on
     the card (TF32 off), synchronous and pipelined, equals the CPU server
     and single-stream generation at topk=1, with rows that write past the
     cache's end;
  4d. shared-prefix and sliding-window serving at CSM-1B width: float32
     witnesses (TF32 off, topk=1; each stream equal, or parting on a tie
     under 1e-3 of the largest logit, held): 8 requests naming a 300-frame
     prefix (bucket 512) with their own text of 20 or 200 frames against
     each request with the context inlined, generated alone; 2 streams of
     1040 frames from 1020-frame prompts over a 1280-column window at the
     least re-anchor headroom, before their first wrap against single-stream
     generation and across their re-anchor against the same server with a
     headroom that never re-anchors; a capacity captured while windowed rows
     are live against a server warmed before traffic (bit-equal).  bf16 at 8
     slots in launch-count windows: a registration's ms, each admission's
     ms with the prefix and inlined, first frames; 8 windowed streams of
     1040 frames (each re-anchors once: its ms) with frames/s and the peak
     memory before the first wrap, before the first re-anchor and at the
     end; int4 weights over 320 frames.  Then ``csm-torch-serve --http
     127.0.0.1:0 --warmup --prefix`` and ``--follow`` as subprocesses: 8
     concurrent POST /generate (4 naming the preset), /health, /shutdown
     (exit 0), and JSONL over a pipe (8 wavs, exit 0 at EOF);
  4e. audio streaming at CSM-1B width: ``Generator.generate_streaming``
     against ``generate`` at topk=1 in float32 (TF32 off: samples within
     1e-4 of the largest up to any tie, and equal to the whole-clip decode
     of the stream's own codes); ``csm-torch-serve --http --stream`` as a
     subprocess answering 8 concurrent POSTs with PCM (first and last byte
     times); ``generate_streaming`` at chunk_frames 2, 6 and 13 over a bf16
     and an int8 KV cache (first audio, chunk arrivals, chunks late for
     playback, launches held); ``MimiStreamDecoder`` ms at 1, 2, 8 and 13
     frames; ``--stream`` serving (a streaming Mimi decoder a request on
     the serving thread) at 8 and 64 slots beside the same server without
     it (frames/s, first audio per stream);
  4f. multi-LoRA serving at CSM-1B width, 8 slots, phase 4c's protocol, a
     bank of four adapters (two r=8 on q/v, one r=16 on all seven
     projections, one decoder-only; requests over ids 0-4): in float32
     (TF32 off, topk=1) each stream against a single-stream generate on its
     adapter's merged weights (equal, or parting on a tie); in bf16 frames/s
     and peak memory beside the same server without a bank, launches held;
     during traffic a same-shape remove + add takes no capture and leaves
     the streams' codes, removing an adapter in use raises, a larger rank
     retakes the captures (counted, timed); the bank over int4 weights
     (``--adapter`` and ``POST /adapters`` run in phase 4d's daemon);
  5. a tiny float32 model, with float and with int4 weights, generates on
     the card and on the CPU (where the wrappers run the plain versions):
     codes equal, audio close;
  6. training at CSM-1B width (random weights, float32 master weights, bf16
     compute, remat, batch 2 in the 512 bucket from synthetic audio through
     Mimi): six steps through the trainer's own step call and one validate,
     with the flash kernels' launches held to 32 forward and 16 of each
     backward kernel per step (16 forward per eval step), finite losses that
     fall on the repeated batch, ms per step, trained frames/s, peak memory
     and one profiled step;
  6b. LoRA training at CSM-1B width on phase 6's setup: r=8 on q/v, r=16 on
     all seven projections, q/v over an int8 and over an int4 base, six
     steps and a validate each (flash launches held, the dequant route's
     over int4; the loss falls, the base stays), ms per step, trained
     frames/s, peak memory (the quantized bases' under the bf16 base's),
     trainable parameters; one float32 LoRA step of a tiny model card
     against CPU;
  7. ``CSMTrainer.train`` at tiny width on the card (epochs, validation,
     checkpoints, resume from ``latest``) and the ``csm-torch-train`` CLI
     (``python -m csm_torch.cli.train --tiny-test``) on two synthetic
     recordings;
  7b. the user's LoRA path: ``csm-torch-finetune-lora`` in process for two
     steps at CSM-1B (``--save-mode both --async-checkpointing``), then
     ``load_csm(lora_path=...)`` in float32 and ``csm-torch-generate
     --lora-path`` in bf16, codes equal to a Generator on the in-memory
     ``merge_lora`` at topk=1; a two-speaker ``csm-torch-finetune-lora-multi``
     at tiny width;
  8. one train step of a tiny float32 model at T=256 (through the backward
     kernels) on the card and on the CPU from the same weights, batch and
     frame scores: loss and gradients agree;
  9. the weight-streaming probe ``csm_torch.scripts.bench_matvec`` at CSM-1B
     width (16 layers, 1.95 GB of bf16 weights): every variant's parity and
     finite chain, 64 matvec kernel launches a pass, ms and GB/s of each;
  10. training over a mesh of ranks: the flash kernels on ring chunks
     against their plain versions (a zigzag chunk whose key tiles jump, and
     a chunk that sees no key: zeros, L_EMPTY and exactly zero gradients);
     then this process frees its memory and starts 2 and then 4 ranks as
     child processes sharing this card over a gloo group (collectives
     through host memory): float32 witnesses (TF32 off) at CSM-1B width
     with 2 layers, B=2, T=512 — DP, TP+FSDP, PP (2 microbatches), SP
     contiguous and zigzag on 2 ranks, SP zigzag on 4 — each held against
     the single-process step on the card (loss, gradients, parameters after
     two steps), and bf16 figures at full CSM-1B (remat, float32 master
     weights): DP (B=2 a rank), TP=2 + FSDP, PP=2 at T=512, SP=2 at T=2048
     zigzag, SP=4 with LoRA r=8 on q/v over a bf16 base at T=2048 — ms a
     step, trained frames/s, peak memory a rank, and flash launches a step
     held to the layout's count;
  11. the native audio loader built on this host, against the plain route
     on a 10 s and a 60 s 44.1 kHz stereo WAV, both timed.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM published peaks (dense): HBM3 bytes/s and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12

# bf16 comparisons: kernel and plain version both accumulate in float32 and
# round the output to bf16 once, so an element may differ by one bf16 ulp,
# which is at most 2**-7 of its magnitude; the atol covers outputs near 0.
# Attention over N(0, 1) scores and V is ~sqrt(e/T) in size (0.04 at
# T=2048), so a kernel that drops one 64-key tile (~5e-3) fails this.
BF16_ATOL, BF16_RTOL = 1e-4, 2**-7
LSE_ATOL = 1e-3  # float32 log-sum-exp of the same bf16 scores
# bf16 flash forward: on top of one bf16 ulp (BF16_ATOL + BF16_RTOL·|plain|),
# each O element has an allowance for p rounding apart in kernel and plain
# version (the kernel rounds against the running row max):
# csm_torch.ops.flash_attention.fwd_rounding_allowance, derived there.
# bf16 backward: dq sums ds·k over up to T keys, dk/dv over the group's G·S
# rows; kernel (tensor cores) and plain version both round p and ds to bf16
# before those products, accumulate in float32 in other orders and round
# once to bf16, so an element may differ by one bf16 ulp (rtol 2**-7);
# gradients near zero get an atol of 2**-8 of the gradient's RMS.  On top of
# that, the two compute s and dP in other orders (and p with exp2 against
# exp), so a p or ds within ~1e-6 of a bf16 rounding boundary rounds apart
# in the two (a few in 10^4 of the terms), and moves the element that sums
# it by one bf16 ulp of that term, up to 2**-7 of it: an early row's ds of
# ~5 moves a dq element by ~4e-3.  Each element is allowed BWD_FLIP_SHARE of
# the root-sum-square of the terms it sums (two such flips at its largest
# term).  Dropping one 64-key tile moves the gradients far above the whole
# tolerance, which every check shows.
BWD_REL_ATOL = 2**-8
BWD_FLIP_SHARE = 2**-6
# Training: the learning rate of the CSM-1B steps (the reference's default
# is 1e-5; 1e-4 moves random weights enough in 5 steps for the loss on a
# repeated batch to fall clearly), and the card-vs-CPU check of a tiny
# float32 step: loss to 1e-5 relative, every gradient entry to 1e-5 of the
# gradients' global norm (float32 sums in other orders, TF32 off).
TRAIN_LR = 1e-4
TRAIN_STEPS = 6
REF_LOSS_RTOL = 1e-5
REF_GRAD_SHARE = 1e-5


def log(msg: str = "") -> None:
    print(msg, flush=True)


def timed_ms(fn, flush: "torch.Tensor", n: int = 30) -> float:
    """Median device time of ``fn`` in ms over ``n`` runs, each after a
    write of 256 MB that evicts the 50 MB L2 (the main path meets its
    inputs cold: a bf16 CSM-1B frame streams ~8.8 GB of weights, the
    backbone once and the decoder 31 times; ~2.2 GB in int4)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(n)]
    for start, end in ev:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def check_close(name, got, want, atol, rtol) -> float:
    import torch

    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bad.any():
        raise AssertionError(f"{name}: max |kernel - plain| = {err.max().item():.3e} "
                             f"(tolerance {atol} + {rtol}·|plain|)")
    return err.max().item()


# ---------------------------------------------------------------- phase 3


def decode_case(B, Hq, Hkv, D, T, gen, dev, shared_mask=False, dead_row=False, live=None):
    """bf16 decode inputs; row b sees keys < its own length: live[b], or
    T - 7·b."""
    import torch

    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor(live or [T - 7 * b for b in range(B)], device=dev)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None])[:, None, :]
    if shared_mask:
        mask = mask[:1].contiguous()
    if dead_row:
        mask[-1] = False
    return q, k, v, mask


def flash_case(B, S, T, Hq, Hkv, D, gen, dev):
    """bf16 prefill inputs in the main path's layout: row b holds
    S - 37·b real tokens then PAD_POS rows; slots past S are unwritten."""
    import torch

    from csm_torch.models.csm import PAD_POS

    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    col = torch.arange(S, dtype=torch.int32, device=dev)
    lens = torch.tensor([S - 37 * b for b in range(B)], device=dev)
    q_pos = torch.where(col[None, :] < lens[:, None], col[None, :], PAD_POS).to(torch.int32)
    kv_pos = torch.full((B, T), PAD_POS, dtype=torch.int32, device=dev)
    kv_pos[:, :S] = q_pos
    return q, k, v, q_pos.contiguous(), kv_pos


# Sliding-window serving (phase 4d): 8 rows of a 1280-column cache, a
# 1024-column anchor (the prompt bucket) and a 256-column ring that every
# live row has wrapped, so positions are out of column order
RING = dict(B=8, Hq=32, Hkv=8, D=64, T=1280, anchor=1024)


def ring_case(B, Hq, Hkv, D, T, anchor, gen, dev):
    """bf16 decode inputs over a full ring, the mask from positions as the
    server makes it: row b's prompt of 1000 - 9·b frames at columns
    [0, prompt), PAD_POS to the anchor, its latest T - anchor frames wrapped
    over [anchor, T); rows 0, 2, 4 re-anchored by 1100 (their prompt's
    positions negative); the last row dead (a query at PAD_POS sees every
    column)."""
    import torch

    from csm_torch.models.csm import PAD_POS

    ring = T - anchor
    kv_pos = torch.full((B, T), PAD_POS, dtype=torch.int64)
    q_pos = torch.empty(B, dtype=torch.int64)
    for b in range(B):
        prompt, frames, delta = 1000 - 9 * b, 300 + 97 * b, 1100 if b in (0, 2, 4) else 0
        kv_pos[b, :prompt] = torch.arange(prompt) - delta
        t = torch.arange(frames - ring, frames)  # the frames the ring still holds
        kv_pos[b, anchor + t % ring] = prompt + t - delta
        q_pos[b] = prompt + frames - 1 - delta
    q_pos[-1] = PAD_POS
    mask = (kv_pos <= q_pos[:, None])[:, None].to(dev)
    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    return q, k, v, mask


# Flash after a prefix (phase 4d): one row of a 2048-column cache, a prefix
# of 300 frames in its 512 bucket (PAD_POS over 300-511), a 256-frame suffix
# at positions 300-555 in columns 512-767
PREFIXED = dict(B=1, S=256, T=2048, Hq=32, Hkv=8, D=64, prefix=300, prefix_bucket=512)


def prefixed_flash_case(B, S, T, Hq, Hkv, D, prefix, prefix_bucket, gen, dev):
    import torch

    from csm_torch.models.csm import PAD_POS

    q = torch.randn(B, S, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    q_pos = (prefix + torch.arange(S, dtype=torch.int32, device=dev)).expand(B, S).contiguous()
    kv_pos = torch.full((B, T), PAD_POS, dtype=torch.int32, device=dev)
    kv_pos[:, :prefix] = torch.arange(prefix, dtype=torch.int32, device=dev)
    kv_pos[:, prefix_bucket : prefix_bucket + S] = q_pos
    return q, k, v, q_pos, kv_pos


def decode_bound(q, k, mask):
    """Bytes and FLOPs of the live keys only (the work depends on the mask):
    q read and out written once, each live key's K and V rows once, the
    mask once."""
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    live = int(mask.expand(B, 1, T).sum())
    moved = 2 * (2 * B * Hq * D) + 2 * (2 * live * Hkv * D) + mask.numel()
    return bound_ms(moved, 4.0 * Hq * D * live)


def decode_int8_bound(q, kq, mask):
    """The int8 form's bound from the live keys only: q read and out
    written once in q's type, each live key's int8 K and V rows and their
    float32 scales once, the mask once."""
    B, _, Hq, D = q.shape
    T, Hkv = kq.shape[1], kq.shape[2]
    live = int(mask.expand(B, 1, T).sum())
    moved = 2 * (2 * B * Hq * D) + 2 * live * Hkv * (D + 4) + mask.numel()
    return bound_ms(moved, 4.0 * Hq * D * live)


def dropped_key_tile(mask):
    """The mask with one live key tile of every row masked: the middle
    whole 64 of the row's live keys (in column order: a ring's are not a
    prefix), or half of them when it has fewer than 128: what a kernel that
    skipped a live tile would compute."""
    out = mask.clone()
    for row in out[:, 0]:
        live = row.nonzero().squeeze(1)
        n = len(live)
        if n:
            width = min(64, max(1, n // 2))
            j0 = width * ((n // width) // 2)
            row[live[j0 : j0 + width]] = False
    return out


def flash_bound(q, k, q_pos, kv_pos):
    """FLOPs of the visible (query, key) pairs this input has."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    visible = int((kv_pos[:, None, :] <= q_pos[:, :, None]).sum())
    moved = 2 * (2 * B * S * Hq * D) + 2 * (2 * B * T * Hkv * D) + 4 * (B * S + B * T + B * Hq * S)
    return bound_ms(moved, 4.0 * Hq * D * visible)


def sdpa_decode(q, k, v, mask):
    """SDPA over the decode inputs in its (B, H, T, D) layout, set up once;
    the callable carries that q and mask (``.q``, ``.mask``)."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = mask[:, None]  # (B|1, 1, 1, T)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, enable_gqa=True)

    call.q, call.mask = qt, m
    return call


def sdpa_flash(q, k, v, q_pos, kv_pos):
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None]  # (B, 1, S, T)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, enable_gqa=True)


def fwd_check(name, o, lse, q, k, v, q_pos, kv_pos):
    """The forward kernel's O and L against the plain version in bf16, with
    the tolerance above; then the plain O with one 64-key tile hidden from
    every row (its kv_pos set to PAD_POS) must fail that tolerance.  Logs
    both factors; returns max |kernel - plain| of O."""
    import torch

    from csm_torch.models.csm import PAD_POS
    from csm_torch.ops import flash_attention as fa

    want, lse_p = fa.flash_attention_plain(q, k, v, q_pos, kv_pos)
    tol = fa.fwd_rounding_allowance(q, k, v, q_pos, kv_pos)
    tol.add_(BF16_ATOL + BF16_RTOL * want.float().abs())
    err = (o.float() - want.float()).abs()
    used = (err / tol).max().item()
    if not torch.isfinite(o.float()).all() or used > 1:
        raise AssertionError(f"{name} O: max |kernel - plain| = {err.max().item():.3e}, "
                             f"{used:.2f}x the tolerance")
    check_close(f"{name} L", lse, lse_p, LSE_ATOL, 0.0)
    kv = kv_pos.clone()
    j0 = 64 * (q.shape[1] // 128)  # the middle tile of the S written keys
    kv[..., j0 : j0 + 64] = PAD_POS
    drop = fa.flash_attention_plain(q, k, v, q_pos, kv)[0]
    moved = ((drop.float() - want.float()).abs() / tol).max().item()
    if not moved > 1:
        raise AssertionError(f"{name}: dropping a key tile stays within the tolerance "
                             f"({moved:.2f}x)")
    log(f"{name}: max |kernel - plain| O {err.max().item():.2e} ({used:.2f} of the tolerance); "
        f"dropping one 64-key tile moves O {moved:.0f}x the tolerance")
    return err.max().item()


def bwd_case(B, S, T, Hq, Hkv, D, gen, dev, kv_rows=1, with_lse=False):
    """bf16 backward inputs: the queries are the last S of T positions; with
    kv_rows = 2 each row's (B, T) kv_pos marks 7·(b+1) slots dead (PAD_POS),
    never slot 0, so every row sees a key.  out and lse come from the
    forward kernel, held here against the plain forward (the training path
    runs it at these shapes, with a broadcast (T,) kv_pos), delta from them
    and dO (minus an LSE cotangent).  Returns the backward's arguments and
    the forward's max |kernel - plain| of out."""
    import torch

    from csm_torch.models.csm import PAD_POS
    from csm_torch.ops import flash_attention as fa

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, g = r(B, S, Hq, D), r(B, T, Hkv, D), r(B, T, Hkv, D), r(B, S, Hq, D)
    q_pos = torch.arange(T - S, T, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    if kv_rows == 2:
        kv_pos = kv_pos.expand(B, T).contiguous()
        for b in range(B):
            dead = 1 + torch.randperm(T - 1, generator=gen, device=dev)[: 7 * (b + 1)]
            kv_pos[b, dead] = PAD_POS
    out, lse = fa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    torch.cuda.synchronize()
    name = f"flash fwd B={B} S={S} T={T} kv_pos {tuple(kv_pos.shape)}"
    fwd_err = fwd_check(name, out, lse, q, k, v, q_pos, kv_pos)
    g_lse = torch.randn(B, Hq, S, generator=gen, device=dev) if with_lse else None
    return (q, k, v, q_pos, kv_pos, g, lse, fa.bwd_delta(out, g, g_lse)), fwd_err


def bwd_bounds(q, k, q_pos, kv_pos):
    """(dq bound, dk/dv bound), each (ms, by): bytes of one read of its
    inputs (Q, K, V, dO, L, Dr, positions) and one write of its outputs;
    2·D flops per visible (query head, key) pair for each of its products:
    S, dP and dQ for the dq kernel, S, dP, dV and dK for the dk/dv kernel."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kv = kv_pos if kv_pos.dim() == 2 else kv_pos[None].expand(B, T)
    visible = int((kv[:, None, :] <= q_pos[:, :, None]).sum())
    q_bytes, kv_bytes = 2 * B * S * Hq * D, 2 * B * T * Hkv * D
    rows = 4 * 2 * B * Hq * S + 4 * (q_pos.numel() + kv_pos.numel())
    dq = bound_ms(3 * q_bytes + 2 * kv_bytes + rows, 3 * 2.0 * D * Hq * visible)
    dkv = bound_ms(2 * q_bytes + 4 * kv_bytes + rows, 4 * 2.0 * D * Hq * visible)
    return dq, dkv


def sdpa_bwd(q, k, v, g):
    """SDPA's backward (causal, GQA) on the same inputs: dq, dk and dv in one
    call, the yardstick of both backward kernels."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = g.transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True)


BWD_MAIN_SHAPE = dict(B=2, S=512, T=512, Hq=32, Hkv=8, D=64)


def bwd_flip_allowance(args):
    """Per gradient element, BWD_FLIP_SHARE of the root-sum-square of the
    terms it sums, with p and ds rounded as the plain version rounds them:
    scale·ds_ij·k_j for dq, scale·ds_ij·q_i for dk, p_ij·dO_i for dv (the
    GQA sum included).  Returns (dq, dk, dv) allowances, float32."""
    import torch

    from csm_torch.ops import flash_attention as fa

    q, k, v, q_pos, kv_pos, g, lse, delta = args
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    p, ds = fa._bwd_probs(*args)
    p2, ds2 = fa._rounded(p, q.dtype).pow(2), fa._rounded(ds, q.dtype).pow(2)
    del p, ds
    sq = lambda t, *shape: t.float().pow(2).reshape(*shape)  # noqa: E731
    a = BWD_FLIP_SHARE / math.sqrt(D)
    dq = torch.einsum("bskgt,btkd->bskgd", ds2, sq(k, B, -1, Hkv, D)).sqrt() * a
    dk = torch.einsum("bskgt,bskgd->btkd", ds2, sq(q, B, S, Hkv, G, D)).sqrt() * a
    dv = torch.einsum("bskgt,bskgd->btkd", p2, sq(g, B, S, Hkv, G, D)).sqrt() * BWD_FLIP_SHARE
    return dq.reshape(B, S, Hq, D), dk, dv


def dropped_tile(args):
    """The backward's arguments with the middle 64-key tile hidden from
    every row (its kv_pos set to PAD_POS): the plain gradients of a kernel
    that skipped that tile."""
    from csm_torch.models.csm import PAD_POS

    q, k, v, q_pos, kv_pos, g, lse, delta = args
    kv = kv_pos.clone()
    j0 = 64 * (k.shape[1] // 128)
    kv[..., j0 : j0 + 64] = PAD_POS
    return q, k, v, q_pos, kv, g, lse, delta


def bwd_rows(gen, dev, flush):
    """Both backward kernels against their plain versions in bf16: the
    training shape, a ragged one, S < T with a (B, T) kv_pos, and an LSE
    cotangent; then timed at S = T = 512 and 2048, with the forward kernel
    that feeds them (checked in ``bwd_case``) timed at the same shapes."""
    import torch

    from csm_torch.ops import flash_attention as fa

    rows = []
    checks = [(BWD_MAIN_SHAPE, 1, False), (dict(B=2, S=300, T=300, Hq=32, Hkv=8, D=64), 1, False),
              (dict(B=2, S=200, T=300, Hq=32, Hkv=8, D=64), 2, False), (BWD_MAIN_SHAPE, 1, True),
              (dict(B=2, S=2048, T=2048, Hq=32, Hkv=8, D=64), 1, False)]
    for shape, kv_rows, with_lse in checks:
        args, fwd_err = bwd_case(**shape, gen=gen, dev=dev, kv_rows=kv_rows, with_lse=with_lse)
        q, k, v, q_pos, kv_pos, g, lse, delta = args
        dq = fa.flash_attention_bwd_dq(*args)
        dk, dv = fa.flash_attention_bwd_dkv(*args)
        torch.cuda.synchronize()
        want = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkv_plain(*args))
        dropped = dropped_tile(args)
        drop = (fa.flash_bwd_dq_plain(*dropped), *fa.flash_bwd_dkv_plain(*dropped))
        del dropped
        name = f"flash bwd {shape} kv_pos {'(B, T)' if kv_rows == 2 else '(T,)'} g_lse {with_lse}"
        errs, used, moved = {}, {}, {}
        for what, got, ref, dr, flips in zip(("dq", "dk", "dv"), (dq, dk, dv), want, drop,
                                             bwd_flip_allowance(args)):
            rms = ref.float().pow(2).mean().sqrt().item()
            if not rms > 0:  # an all-zero gradient would pass any tolerance
                raise AssertionError(f"{name} {what}: the plain gradient is zero")
            tol = BWD_REL_ATOL * rms + flips + BF16_RTOL * ref.float().abs()
            err = (got.float() - ref.float()).abs()
            errs[what], used[what] = err.max().item(), (err / tol).max().item()
            moved[what] = ((dr.float() - ref.float()).abs() / tol).max().item()
            if not torch.isfinite(got.float()).all() or used[what] > 1:
                raise AssertionError(f"{name} {what}: max |kernel - plain| = {errs[what]:.3e}, "
                                     f"{used[what]:.2f}x the tolerance")
            if not moved[what] > 1:
                raise AssertionError(f"{name} {what}: dropping a key tile stays within the "
                                     f"tolerance ({moved[what]:.2f}x)")
        del want, drop
        log(f"{name}: max |kernel - plain| forward O {fwd_err:.2e}, dq {errs['dq']:.2e} "
            f"dk {errs['dk']:.2e} dv {errs['dv']:.2e} ({used['dq']:.2f}, {used['dk']:.2f}, "
            f"{used['dv']:.2f} of the tolerance); dropping one 64-key tile moves dq "
            f"{moved['dq']:.0f}x, dk {moved['dk']:.0f}x, dv {moved['dv']:.0f}x the tolerance")
        if kv_rows != 1 or with_lse or shape["S"] not in (512, 2048):
            continue
        (dq_b, dq_by), (dkv_b, dkv_by) = bwd_bounds(q, k, q_pos, kv_pos)
        kv2 = kv_pos[None].expand(q.shape[0], -1)
        f_ms, f_by = flash_bound(q, k, q_pos, kv2)
        rows.append(dict(kernel="flash_attention_fwd", shape=shape, max_abs_err=fwd_err,
                         ms=timed_ms(lambda: fa.flash_attention_fwd(q, k, v, q_pos, kv_pos), flush),
                         plain_ms=timed_ms(lambda: fa.flash_attention_plain(q, k, v, q_pos, kv_pos),
                                           flush),
                         library_ms=timed_ms(sdpa_flash(q, k, v, q_pos, kv2), flush),
                         bound_ms=f_ms, bound_by=f_by))
        lib = timed_ms(sdpa_bwd(q, k, v, g), flush)
        rows.append(dict(kernel="flash_attention_bwd_dq", shape=shape, max_abs_err=errs["dq"],
                         ms=timed_ms(lambda: fa.flash_attention_bwd_dq(*args), flush),
                         plain_ms=timed_ms(lambda: fa.flash_bwd_dq_plain(*args), flush),
                         library_ms=lib, bound_ms=dq_b, bound_by=dq_by))
        rows.append(dict(kernel="flash_attention_bwd_dkv", shape=shape,
                         max_abs_err=max(errs["dk"], errs["dv"]),
                         ms=timed_ms(lambda: fa.flash_attention_bwd_dkv(*args), flush),
                         plain_ms=timed_ms(lambda: fa.flash_bwd_dkv_plain(*args), flush),
                         library_ms=lib, bound_ms=dkv_b, bound_by=dkv_by))
        del args, q, k, v, g, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


def serving_live(B, T, seed, lo=48, hi=111):
    """Live keys of B rows of a serving batch, drawn from lo..hi for all
    rows but the last two, which are dead (T: a query at PAD_POS sees every
    column).  The backbone's default: a 48-frame prompt and 0-63 decoded
    frames."""
    import random

    rng = random.Random(seed)
    return tuple([rng.randint(lo, hi) for _ in range(B - 2)] + [T, T])


# decode: backbone (Hq=32, Hkv=8, D=64) and decoder (Hq=8, Hkv=2, D=128)
DECODE_SHAPES = [
    dict(B=1, Hq=32, Hkv=8, D=64, T=89),  # main path: bucket 64 + 25 frames
    dict(B=1, Hq=32, Hkv=8, D=64, T=89, shared_mask=True),
    dict(B=2, Hq=32, Hkv=8, D=64, T=89),
    dict(B=1, Hq=32, Hkv=8, D=64, T=281),  # bucket 256 + 25 frames
    dict(B=1, Hq=32, Hkv=8, D=64, T=1189),  # a default generate: bucket 64 + 1125 frames
    dict(B=2, Hq=32, Hkv=8, D=64, T=1189, dead_row=True),
    dict(B=1, Hq=32, Hkv=8, D=64, T=1189, live=(89,)),  # ... 25 frames into it
    dict(B=2, Hq=32, Hkv=8, D=64, T=1189, live=(89, 60)),
    dict(B=1, Hq=32, Hkv=8, D=64, T=2048),
    dict(B=2, Hq=32, Hkv=8, D=64, T=2048, dead_row=True),
    dict(B=1, Hq=8, Hkv=2, D=128, T=32),  # decoder: fresh 32-slot cache
    dict(B=2, Hq=8, Hkv=2, D=128, T=32),
    # serving at 8 and 64 slots (phase 4c): a 1024-column cache, 48-111 live
    # keys a row, two dead rows whose query at PAD_POS sees every column
    dict(B=8, Hq=32, Hkv=8, D=64, T=1024, live=serving_live(8, 1024, seed=8)),
    dict(B=64, Hq=32, Hkv=8, D=64, T=1024, live=serving_live(64, 1024, seed=64)),
    # the decoder's S=1 calls at B = capacity (its plan differs from B=1's):
    # ragged 2-31 live keys of its 32 slots, and two rows that see all 32
    dict(B=8, Hq=8, Hkv=2, D=128, T=32, live=serving_live(8, 32, seed=9, lo=2, hi=31)),
    dict(B=64, Hq=8, Hkv=2, D=128, T=32, live=serving_live(64, 32, seed=65, lo=2, hi=31)),
    # the 8B backbone (D=128) served at 8 slots
    dict(B=8, Hq=32, Hkv=8, D=128, T=1024, live=serving_live(8, 1024, seed=10)),
]
# the int8 form (an int8-KV backbone cache): generation at T=89, serving at
# 8 and 64 slots over ragged live keys, and the 8-row full ring (RING)
DECODE_INT8_SHAPES = [DECODE_SHAPES[0], DECODE_SHAPES[12], DECODE_SHAPES[13]]
# the backbone row a frame's decode time is weighted from: T=89 as in
# generate_short, and a default generate's 1189 slots with 89 live
DECODE_FRAME_ROWS = {"T89": dict(B=1, Hq=32, Hkv=8, D=64, T=89),
                     "T1189_live89": dict(B=1, Hq=32, Hkv=8, D=64, T=1189, live=(89,))}
DECODE_DECODER_ROW = dict(B=1, Hq=8, Hkv=2, D=128, T=32)


def decode_frame(rows, args, backbone_shape):
    """The decode kernel's launches and summed kernel ms in one CSM-1B
    frame at B=1, from the timed rows: one backbone launch a layer, and one
    a decoder layer in each of the decoder's S=1 steps (codebooks 2 to K-1)."""
    ms = {json.dumps(r["shape"], sort_keys=True): r["ms"] for r in rows}
    key = lambda shape: json.dumps(shape, sort_keys=True)  # noqa: E731
    n_bb = args.backbone.num_layers
    n_dec = args.decoder.num_layers * (args.audio_num_codebooks - 2)
    return n_bb + n_dec, n_bb * ms[key(backbone_shape)] + n_dec * ms[key(DECODE_DECODER_ROW)]


def phase_kernels(dev, flush, details):
    """Hold each kernel against its plain version; time both at the main
    path's shapes.  Returns the per-kernel records (launches filled later)."""
    import torch

    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    z = torch.zeros(1, device=dev)
    floor_ms = timed_ms(z.zero_, flush)
    details["launch_floor_ms"] = floor_ms
    log(f"launch floor (a one-element zero_()): {floor_ms:.5f} ms")

    def decode_row(shape, q, k, v, mask):
        got = dec.decode_gqa_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = dec.decode_attention_plain(q, k, v, mask)
        err = check_close(f"decode {shape}", got, want, BF16_ATOL, BF16_RTOL)
        if shape.get("dead_row") and got[-1].any():
            raise AssertionError("a fully masked row must give zeros")
        drop = dec.decode_attention_plain(q, k, v, dropped_key_tile(mask)).float()
        moved = ((drop - want.float()).abs() / (BF16_ATOL + BF16_RTOL * want.float().abs())).max().item()
        if not moved > 10:
            raise AssertionError(f"decode {shape}: masking one live key tile moves the plain "
                                 f"output only {moved:.1f}x the tolerance")
        b_ms, b_by = decode_bound(q, k, mask)
        rows.append(dict(kernel="decode_attention", shape=shape, max_abs_err=err,
                         drop_one_tile=moved,
                         ms=timed_ms(lambda: dec.decode_gqa_attention(q, k, v, mask), flush),
                         plain_ms=timed_ms(lambda: dec.decode_attention_plain(q, k, v, mask), flush),
                         library_ms=timed_ms(sdpa_decode(q, k, v, mask), flush),
                         bound_ms=b_ms, bound_by=b_by))
        log(f"decode {shape}: max |kernel - plain| {err:.3e}; masking one live key tile moves "
            f"the plain output {moved:.0f}x the tolerance")

    for shape in DECODE_SHAPES:
        decode_row(shape, *decode_case(**shape, gen=gen, dev=dev))
    decode_row(dict(RING, ring=True), *ring_case(**RING, gen=gen, dev=dev))

    def decode_int8_row(shape, q, k, v, mask):
        """The int8 form over the same inputs quantized as an int8-KV cache
        writes them (``quantize_kv_rows``), against its plain version."""
        from csm_torch.ops.kvcache import dequantize_kv, quantize_kv_rows

        kq, vq = quantize_kv_rows(k), quantize_kv_rows(v)
        got = dec.decode_gqa_attention(q, kq, vq, mask)
        torch.cuda.synchronize()
        want = dec.decode_attention_int8_plain(q, kq.q, kq.s, vq.q, vq.s, mask)
        err = check_close(f"decode int8 {shape}", got, want, BF16_ATOL, BF16_RTOL)
        dead = ~mask.expand(q.shape[0], 1, mask.shape[-1])[:, 0].any(-1)
        if got[dead].any():
            raise AssertionError("int8: a fully masked row must give zeros")
        drop = dec.decode_attention_int8_plain(q, kq.q, kq.s, vq.q, vq.s,
                                               dropped_key_tile(mask)).float()
        moved = ((drop - want.float()).abs() / (BF16_ATOL + BF16_RTOL * want.float().abs())).max().item()
        if not moved > 10:
            raise AssertionError(f"decode int8 {shape}: masking one live key tile moves the "
                                 f"plain output only {moved:.1f}x the tolerance")
        b_ms, b_by = decode_int8_bound(q, kq.q, mask)
        sdpa = sdpa_decode(q, k, v, mask)  # the transposes' layout, set up once

        def library():  # two calls: dequantize_kv, then SDPA
            kd, vd = dequantize_kv(kq, q.dtype), dequantize_kv(vq, q.dtype)
            return torch.nn.functional.scaled_dot_product_attention(
                sdpa.q, kd.transpose(1, 2), vd.transpose(1, 2), attn_mask=sdpa.mask,
                enable_gqa=True)

        rows.append(dict(kernel="decode_attention_int8", shape=shape, max_abs_err=err,
                         drop_one_tile=moved,
                         ms=timed_ms(lambda: dec.decode_gqa_attention(q, kq, vq, mask), flush),
                         plain_ms=timed_ms(lambda: dec.decode_attention_int8_plain(
                             q, kq.q, kq.s, vq.q, vq.s, mask), flush),
                         library_ms=timed_ms(library, flush),
                         library="dequantize_kv + scaled_dot_product_attention (two calls)",
                         bound_ms=b_ms, bound_by=b_by))
        log(f"decode int8 {shape}: max |kernel - plain| {err:.3e}; masking one live key tile "
            f"moves the plain output {moved:.0f}x the tolerance")

    for shape in DECODE_INT8_SHAPES:
        decode_int8_row(shape, *decode_case(**shape, gen=gen, dev=dev))
    decode_int8_row(dict(RING, ring=True), *ring_case(**RING, gen=gen, dev=dev))

    def flash_row(shape, q, k, v, q_pos, kv_pos):
        o, lse = fa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
        torch.cuda.synchronize()
        err = fwd_check(f"flash fwd {shape}", o, lse, q, k, v, q_pos, kv_pos)
        pad = q_pos == (1 << 28)
        if pad.any() and not o[pad].abs().amax() > 0:
            raise AssertionError("PAD_POS rows attend every slot: their output is not zero")
        b_ms, b_by = flash_bound(q, k, q_pos, kv_pos)
        rows.append(dict(kernel="flash_attention_fwd", shape=shape, max_abs_err=err,
                         ms=timed_ms(lambda: fa.flash_attention_fwd(q, k, v, q_pos, kv_pos), flush),
                         plain_ms=timed_ms(lambda: fa.flash_attention_plain(q, k, v, q_pos, kv_pos), flush),
                         library_ms=timed_ms(sdpa_flash(q, k, v, q_pos, kv_pos), flush),
                         bound_ms=b_ms, bound_by=b_by))

    # flash forward: prefill buckets 256 and 512, T = S + 25 frames; a
    # serving prefill (phase 4c): one row of the 1024-column cache; a suffix
    # after a prefix (phase 4d)
    for B, S, T in ((1, 256, 281), (2, 256, 281), (1, 512, 537), (2, 512, 537), (1, 256, 1024)):
        flash_row(dict(B=B, S=S, T=T, Hq=32, Hkv=8, D=64),
                  *flash_case(B, S, T, 32, 8, 64, gen, dev))
    flash_row(PREFIXED, *prefixed_flash_case(**PREFIXED, gen=gen, dev=dev))
    rows += int4_rows(gen, dev, flush, details)
    rows += matvec_rows(gen, dev, flush)
    rows += bwd_rows(gen, dev, flush)
    details["kernel_rows"] = rows
    log(f"{'kernel':<20} {'shape':<58} {'ms':>8} {'plain':>8} {'library':>8} {'bound':>8} err")
    for r in rows:
        log(f"{r['kernel']:<20} {json.dumps(r['shape']):<58} {r['ms']:8.4f} {r['plain_ms']:8.4f} "
            f"{r['library_ms']:8.4f} {r['bound_ms']:8.4f} {r['max_abs_err']:.2e}")

    def record(name, source, replaces, main_shape, **extra):
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == main_shape)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"], **extra}

    from csm_torch import csm_1b_args

    frame_launches, frame_ms = int4_frame([r for r in rows if r["kernel"] == "int4_matmul"],
                                          csm_1b_args())
    details["int4_frame"] = {"launches": frame_launches, "ms": frame_ms}
    log(f"int4 kernel time of one CSM-1B frame at B=1, launch-weighted from the rows above: "
        f"{frame_launches} launches, {frame_ms:.4f} ms")
    dec_rows = [r for r in rows if r["kernel"] == "decode_attention"]
    dec_frame = {name: decode_frame(dec_rows, csm_1b_args(), bb) for name, bb in DECODE_FRAME_ROWS.items()}
    details["decode_frame"] = dec_frame
    for name, (n, ms) in dec_frame.items():
        log(f"decode kernel time of one CSM-1B frame at B=1, backbone row {name}, "
            f"launch-weighted from the rows above: {n} launches, {ms:.4f} ms "
            f"(launch floor {floor_ms:.5f} ms)")
    return [
        record("decode_attention", "csm_torch/csrc/decode_attention.cu",
               "csm_tpu/ops/decode_attention.py:55", DECODE_SHAPES[0],
               bound_count="live keys only", launch_floor_ms=floor_ms,
               **{f"frame_ms_{name}": ms for name, (_, ms) in dec_frame.items()}),
        record("decode_attention_int8", "csm_torch/csrc/decode_attention.cu",
               "csm_tpu/ops/decode_attention.py:55", DECODE_SHAPES[0],
               bound_count="live keys only: int8 codes and float32 scales",
               library="dequantize_kv + scaled_dot_product_attention (two calls)",
               launch_floor_ms=floor_ms),
        record("flash_attention_fwd", "csm_torch/csrc/flash_attention.cu",
               "csm_tpu/ops/flash_attention.py:117",
               dict(B=1, S=256, T=281, Hq=32, Hkv=8, D=64)),
        record("int4_matmul", "csm_torch/csrc/int4_matmul.cu",
               "csm_tpu/ops/int4_matmul.py:57", INT4_MAIN_SHAPE,
               frame_ms=frame_ms, frame_launches=frame_launches),
        record("flash_attention_bwd_dq", "csm_torch/csrc/flash_attention_bwd.cu",
               "csm_tpu/ops/flash_attention.py:291", BWD_MAIN_SHAPE),
        record("flash_attention_bwd_dkv", "csm_torch/csrc/flash_attention_bwd.cu",
               "csm_tpu/ops/flash_attention.py:347", BWD_MAIN_SHAPE),
        record("matvec", "csm_torch/csrc/matvec.cu", "scripts/bench_matvec_pallas.py:54",
               MATVEC_MAIN_SHAPE),
    ]


# The int4 matmul's shapes on the main path: CSM-1B backbone projections at
# M = 1 (decode step), 2 (B=2) and 64 (bucket-64 prefill), the decoder's four
# at M = 1 and 2 (its S=2 call), and the 8B flavor's backbone projections at
# M = 1 and 64 (its prefill); serving (phase 4c) at M = 8 and 64 slots, the
# decoder's S=2 call at 8 (M=16), and the 8B backbone at 8 slots.  The 8B
# flavor's decoder (llama-300M) has the CSM-1B decoder's widths, so the
# decoder rows hold its shapes too.
INT4_SHAPES = [
    ("backbone wqkv", 2048, 3072, (1, 2, 8, 64)),
    ("backbone wo", 2048, 2048, (1, 2, 8, 64)),
    ("backbone w13", 2048, 16384, (1, 2, 8, 64)),
    ("backbone w2", 8192, 2048, (1, 2, 8, 64)),
    ("decoder wqkv", 1024, 1536, (1, 2, 8, 16, 64)),
    ("decoder wo", 1024, 1024, (1, 2, 8, 16, 64)),
    ("decoder w13", 1024, 16384, (1, 2, 8, 16, 64)),
    ("decoder w2", 8192, 1024, (1, 2, 8, 16, 64)),
    ("8B wqkv", 4096, 6144, (1, 8, 64)),
    ("8B wo", 4096, 4096, (1, 8, 64)),
    ("8B w13", 4096, 28672, (1, 8, 64)),
    ("8B w2", 14336, 4096, (1, 8, 64)),
]
INT4_MAIN_SHAPE = dict(proj="backbone w13", M=1, K=2048, N=16384)


def int4_frame(rows, args):
    """The int4 kernel's launches and summed kernel ms in one CSM-1B frame at
    B=1, from the timed rows: each backbone projection once per layer at
    M=1; each decoder projection once per layer in each of the 31 decoder
    calls, the first at M=2 (codebook-0 embedding and the backbone state),
    the other 30 at M=1."""
    ms = {(r["shape"]["proj"], r["shape"]["M"]): r["ms"] for r in rows}
    L_bb, L_dec, calls = args.backbone.num_layers, args.decoder.num_layers, args.audio_num_codebooks - 1
    launches, total = 0, 0.0
    for proj in ("wqkv", "wo", "w13", "w2"):
        for key, n in ((("backbone " + proj, 1), L_bb), (("decoder " + proj, 2), L_dec),
                       (("decoder " + proj, 1), L_dec * (calls - 1))):
            launches += n
            total += n * ms[key]
    return launches, total


def int4_library(x, q, want):
    """One PyTorch call computing x @ W for the same nibbles: the
    ``_weight_int4pack_mm`` int4 GEMM over the nibbles repacked as unsigned
    u = q + 8 with zero points 0 (so (u - 8)·s = q·s), where this torch has
    it and it agrees with the plain version; else dequant + ``torch.matmul``.
    Timed only, never on the path.  Returns (callable, its name)."""
    import torch

    from csm_torch.utils.quantize import dequantize_weight_int4, unpack_int4

    gs = x.shape[1] // q["scale4"].shape[0]
    u = (unpack_int4(q["w4p"]) + 8).t().contiguous()  # (N, K) in 1..15
    scales_zeros = torch.stack([q["scale4"], torch.zeros_like(q["scale4"])], dim=-1).contiguous()
    try:  # (N, K/2) uint8, even k in the high nibble
        wp = torch._convert_weight_to_int4pack(((u[:, ::2] << 4) | u[:, 1::2]).to(torch.uint8), 8)
        fn = lambda: torch._weight_int4pack_mm(x, wp, gs, scales_zeros)  # noqa: E731
        if (fn().float() - want.float()).abs().max() < 2e-2 * want.float().abs().max():
            return fn, "torch._weight_int4pack_mm"
        why = "it disagrees with the plain version"
    except (RuntimeError, AttributeError) as e:
        why = f"{type(e).__name__}: {str(e)[:120]}"
    w = dequantize_weight_int4(q, x.dtype)
    return (lambda: x @ w), f"dequant + torch.matmul (_weight_int4pack_mm not used: {why})"


def int4_rows(gen, dev, flush, details):
    """The int4 kernel against its plain version in bf16 at every main-path
    shape.  Tolerance: one bf16 ulp (rtol 2**-7) plus 2**-8 of the plain
    output's RMS for outputs near zero; dropping one group of K moves the
    output by far more, which the log shows."""
    import torch

    from csm_torch.ops import int4_matmul as i4
    from csm_torch.utils.quantize import quantize_weight_int4

    rows = []
    for proj, K, N, Ms in INT4_SHAPES:
        w = torch.randn(K, N, generator=gen, device=dev, dtype=torch.float32) / K**0.5
        q = quantize_weight_int4(w.to(torch.bfloat16))
        del w
        G = q["scale4"].shape[0]
        for M in Ms:
            x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
            got = i4.fused_int4_matmul(x, q)
            torch.cuda.synchronize()
            want = i4.int4_matmul_plain(x, q)
            rms = want.float().pow(2).mean().sqrt().item()
            atol = rms * 2**-8
            err = check_close(f"int4 {proj} M={M}", got, want, atol, BF16_RTOL)
            dropped = dict(q, scale4=q["scale4"].clone())
            dropped["scale4"][0] = 0
            drop = (i4.int4_matmul_plain(x, dropped).float() - want.float()).abs().max().item()
            if drop < 10 * atol:
                raise AssertionError(f"int4 {proj}: dropping a group moves y by only {drop:.3e}")
            lib, lib_name = int4_library(x, q, want)
            details.setdefault("int4_library", lib_name)
            moved = 2 * M * K + K * N // 2 + 2 * G * N + 2 * M * N
            b_ms, b_by = bound_ms(moved, 2.0 * M * K * N)
            rows.append(dict(kernel="int4_matmul", shape=dict(proj=proj, M=M, K=K, N=N),
                             max_abs_err=err, atol=atol, drop_one_group=drop,
                             ms=timed_ms(lambda: i4.fused_int4_matmul(x, q), flush),
                             plain_ms=timed_ms(lambda: i4.int4_matmul_plain(x, q), flush),
                             library_ms=timed_ms(lib, flush), bound_ms=b_ms, bound_by=b_by))
            log(f"int4 {proj} M={M}: max |kernel - plain| {err:.3e}, tolerance "
                f"{atol:.3e} + 2**-7·|plain|; dropping group 0 moves y by {drop:.3e} "
                f"({drop / atol:.0f}x the atol)")
        del q
    log(f"int4 library yardstick: {details['int4_library']}")
    return rows


# The matvec's shapes: the CSM-1B backbone's four decode projections as the
# probe runs them (w13 is the main shape), and a narrow N at the largest K.
MATVEC_SHAPES = [("wqkv", 2048, 3072), ("wo", 2048, 2048), ("w13", 2048, 16384),
                 ("w2", 8192, 2048), ("narrow", 8192, 384)]
MATVEC_MAIN_SHAPE = dict(proj="w13", K=2048, N=16384)


def matvec_rows(gen, dev, flush):
    """The matvec kernel against its plain version in bf16.  Tolerance: one
    bf16 ulp (rtol 2**-7) plus 2**-8 of the plain output's RMS for outputs
    near zero; zeroing one 256-row slice of w moves y by far more, which the
    log shows.  ``torch.matmul`` (cuBLAS) is the library yardstick."""
    import torch

    from csm_torch.ops import matvec as mv

    rows = []
    for proj, K, N in MATVEC_SHAPES:
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(K, N, generator=gen, device=dev) / K**0.5).to(torch.bfloat16)
        got = mv.matvec(x, w)
        torch.cuda.synchronize()
        want = mv.matvec_plain(x, w)
        atol = want.float().pow(2).mean().sqrt().item() * 2**-8
        err = check_close(f"matvec {proj}", got, want, atol, BF16_RTOL)
        w_drop = w.clone()
        w_drop[:256] = 0
        drop = (mv.matvec_plain(x, w_drop).float() - want.float()).abs().max().item()
        del w_drop
        if drop < 10 * atol:
            raise AssertionError(f"matvec {proj}: zeroing 256 rows of w moves y by only {drop:.3e}")
        b_ms, b_by = bound_ms(2 * K * N + 2 * K + 2 * N, 2.0 * K * N)
        rows.append(dict(kernel="matvec", shape=dict(proj=proj, K=K, N=N), max_abs_err=err,
                         atol=atol, drop_one_slice=drop,
                         ms=timed_ms(lambda: mv.matvec(x, w), flush),
                         plain_ms=timed_ms(lambda: mv.matvec_plain(x, w), flush),
                         library_ms=timed_ms(lambda: x @ w, flush), bound_ms=b_ms, bound_by=b_by))
        log(f"matvec {proj} K={K} N={N}: max |kernel - plain| {err:.3e}, tolerance {atol:.3e} + "
            f"2**-7·|plain|; zeroing rows 0-255 of w moves y by {drop:.3e} ({drop / atol:.0f}x "
            f"the atol)")
    return rows


# ---------------------------------------------------------------- phase 4


LONG_TEXT = (
    "This prompt is long enough that its byte tokens fill more than one "
    "hundred and twenty eight positions, so the prompt pads to the 256 "
    "bucket and the prefill attends through the flash kernel."
)


SHORT_TEXT = "Hello from the port."
BATCH_TEXTS = ["A first, short line.", "And a second line that is a little longer than it."]


def phase_main_path(details):
    """Generator.generate / generate_batch at CSM-1B width in bf16 through
    the CUDA graphs: graph against eager (times, memory, codes at topk=1
    and 50), then the launch-count window over replays; returns the launch
    counts of that window."""
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer

    args = csm_1b_args()
    t0 = time.perf_counter()
    gen = load_csm(args=args, compute_dtype=torch.bfloat16, text_tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    details["load_s"] = time.perf_counter() - t0
    runs = [  # (run name, callable, batch size)
        ("generate_short", lambda: [gen.generate(SHORT_TEXT, max_audio_length_ms=2000)], 1),
        ("generate_long", lambda: [gen.generate(LONG_TEXT, speaker=1, max_audio_length_ms=2000)], 1),
        ("generate_batch", lambda: gen.generate_batch(BATCH_TEXTS, [0, 1], max_audio_length_ms=2000), 2),
    ]
    compare_loops("bf16", gen, runs, details)  # also captures every key of the window
    check_codes_topk1(gen, details)
    torch.cuda.reset_peak_memory_stats()
    launches = drive("bf16", gen, runs, args, details, ("decode_attention", "flash_attention_fwd"))
    details["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    details["peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    profile_generate(gen, details, "profile")
    free(gen)
    return launches


@contextlib.contextmanager
def token_loop(name):
    """``Generator``'s frame loop for the body of the block: ``"graphs"``,
    what it always calls (``generate_audio_tokens_jit``), or ``"eager"``, the
    reference loop ``generate_audio_tokens`` put in its place at the
    generator module's name, for the comparisons of this script."""
    from csm_torch import generator
    from csm_torch.models import generation

    keep = generator.generate_audio_tokens_jit
    if name == "eager":
        generator.generate_audio_tokens_jit = (
            lambda *a, graphs=None, **kw: generation.generate_audio_tokens(*a, **kw))
    try:
        yield
    finally:
        generator.generate_audio_tokens_jit = keep


def compare_loops(name, gen, runs, details, reps=2):
    """The graphed entry against the eager loop in one call, on one
    generator.  First each run's peak device memory under each loop, from
    an empty graph cache: allocated, and reserved (a graph's pool is
    reserved memory that its replays use without allocating).  Then every
    key is captured, and each run is timed ``reps`` times under each loop,
    interleaved (graphs, eager, then eager, graphs, ...).  The first call
    under the graphs captures its key: its prefill with the capture
    (``first_prefill_s``) is what a new key costs.  The codes each loop
    hands to Mimi at topk 50 from one seed must be equal: the uniforms are
    drawn by the same call in both."""
    import torch

    rec = gen.mimi = Recording(gen.mimi)
    out = {}
    for run, call, _ in runs:
        out[run] = {"graphs": [], "eager": [], "memory_gib": {}}
        for loop in ("eager", "graphs"):
            gen.graphs.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with token_loop(loop):
                call()
            torch.cuda.synchronize()
            out[run]["memory_gib"][loop] = {
                "allocated": torch.cuda.max_memory_allocated() / 2**30,
                "reserved": torch.cuda.max_memory_reserved() / 2**30}
        st = gen.last_stats
        out[run]["capture_s"] = st["capture_s"]
        out[run]["first_prefill_s"] = st["capture_s"] + st["prefill_s"]
    for run, call, _ in runs:
        call()  # captures the keys the memory pass dropped
    for rep in range(reps):
        for run, call, _ in runs:
            codes = {}
            for loop in ("graphs", "eager")[:: 1 if rep % 2 == 0 else -1]:
                rec.decoded.clear()
                with token_loop(loop):
                    call()
                st = gen.last_stats
                out[run][loop].append({k: st[k] for k in (
                    "frames_per_s", "rtf", "prefill_s", "generate_s", "decode_s", "capture_s",
                    "steps", "frames")})
                codes[loop] = list(rec.decoded)
            if len(codes["graphs"]) != len(codes["eager"]) or not all(
                    a.shape == b.shape and (a == b).all()
                    for a, b in zip(codes["graphs"], codes["eager"])):
                gen.mimi = rec.inner
                raise AssertionError(f"{name} {run}: graph and eager codes differ at topk=50")
    gen.mimi = rec.inner
    details[f"{name}_graph_vs_eager"] = out
    log(f"{name}: graph against eager on {details['card']} ({reps} runs each, interleaved)")
    for run, r in out.items():
        for loop in ("graphs", "eager"):
            xs = r[loop]
            mem = r["memory_gib"][loop]
            log(f"  {run:>22} {loop:>6}: frames/s "
                + " ".join(f"{x['frames_per_s']:.2f}" for x in xs) + ", RTF "
                + " ".join(f"{x['rtf']:.3f}" for x in xs) + ", prefill ms "
                + " ".join(f"{1e3 * x['prefill_s']:.1f}" for x in xs) + ", mimi s "
                + " ".join(f"{x['decode_s']:.3f}" for x in xs)
                + f", peak {mem['allocated']:.3f} GiB allocated, {mem['reserved']:.3f} reserved")
        log(f"  {run:>22} first call: capture {r['capture_s']:.3f} s, prefill with it "
            f"{1e3 * r['first_prefill_s']:.1f} ms; codes equal at topk 50")


def check_codes_topk1(gen, details):
    """At topk=1 the graphed entry and the eager loop hand Mimi the same
    codes at CSM-1B width (bucket 64, 25 frames)."""
    rec = gen.mimi = Recording(gen.mimi)
    try:
        for loop in ("graphs", "eager"):
            with token_loop(loop):
                gen.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
    finally:
        gen.mimi = rec.inner
    a, b = rec.decoded
    if a.shape != b.shape or not (a == b).all():
        raise AssertionError(f"topk=1: graph codes {a.shape} differ from eager codes {b.shape}")
    details["topk1_codes_equal_frames"] = int(a.shape[1])
    log(f"topk=1 at CSM-1B width: graph and eager codes equal over {a.shape[1]} frames")


def profile_generate(gen, details, key):
    """Where one generate's time goes (bucket 64, 10 frames, Mimi decode
    included), under torch.profiler, through the eager loop: wall time,
    summed kernel time (the device's busy time: one stream, so kernels do
    not overlap) and the kernels that take the most of it.  Then the same
    generate through the graphs (captured first): wall time, and the
    kernel time and top kernels if the profiler sees the replays' kernels
    ("not measured" if it does not).  The profiler slows the host, so the wall times here
    are above the unprofiled runs'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(loop):
        with token_loop(loop), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            gen.generate("Profile one short line.", max_audio_length_ms=800)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.key_averages()
                   if "CUDA" in str(getattr(e, "device_type", ""))]
        return wall_ms, kernels, sum(e.self_device_time_total for e in kernels) / 1e3

    def top(kernels, n=10):
        kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:n]
        return [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in kernels]

    gen.generate("Profile one short line.", max_audio_length_ms=800)  # capture this key
    wall_g, kernels_g, busy_g = run("graphs")
    wall_ms, kernels, busy_ms = run("eager")
    int4 = [e for e in kernels if "int4" in e.key]
    int4_ms = sum(e.self_device_time_total for e in int4) / 1e3
    details[key] = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "top_kernels": top(kernels),
        "int4_kernel_ms": int4_ms, "int4_launches": sum(e.count for e in int4),
        "graphs_wall_ms": wall_g,
        "graphs_device_busy_ms": busy_g if busy_g else "not measured",
        "graphs_top_kernels": top(kernels_g, 5),
    }
    log(f"{key}: eager generate of 10 frames {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({len(kernels)} kinds); through the graphs {wall_g:.1f} ms wall, kernels "
        f"{details[key]['graphs_device_busy_ms']}")
    if int4:
        log(f"  the int4 kernel: {int4_ms:.2f} ms in {details[key]['int4_launches']} launches, "
            f"{100 * int4_ms / busy_ms:.1f} % of the kernel time")
    for name, count, ms in details[key]["top_kernels"]:
        log(f"  {ms:9.3f} ms {count:6d}x {name}")
    log("  through the graphs:")
    for name, count, ms in details[key]["graphs_top_kernels"]:
        log(f"  {ms:9.3f} ms {count:6d}x {name}")


def int4_expected(args, st, B):
    """int4 kernel launches and dequant-route calls one generate must make:
    4 projections per layer per transformer call, through the kernel when
    the call has B·S <= 64 rows, else dequant + matmul.  The backbone runs
    once per frame (the prefill frame at B·bucket rows), the decoder 31
    times (2B rows, then B)."""
    from csm_torch.ops.int4_matmul import MAX_KERNEL_ROWS

    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    frames = st["steps"] + 1
    prefill_kernel = B * st["prompt_bucket"] <= MAX_KERNEL_ROWS
    kernel = 4 * L_dec * (K - 1) * frames + 4 * L_bb * (st["steps"] + prefill_kernel)
    return kernel, 0 if prefill_kernel else 4 * L_bb


def decode_expected(args, st, kv_int8=False):
    """Decode-kernel launches of one generate, (float form, int8 form): the
    decoder's S=1 steps on the float form, the backbone's steps on the int8
    form when its cache is int8, else on the float form."""
    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    backbone = L_bb * st["steps"]
    decoder = (K - 2) * L_dec * (st["steps"] + 1)
    return (decoder, backbone) if kv_int8 else (decoder + backbone, 0)


def check_audio(name, outs, st):
    import numpy as np

    spf, total = 1920, 0
    for audio in outs:
        if not (audio.dtype == np.float32 and audio.ndim == 1 and np.isfinite(audio).all()):
            raise AssertionError(f"{name}: audio not finite float32 mono")
        if len(audio) % spf or not 0 < len(audio) <= 25 * spf:
            raise AssertionError(f"{name}: {len(audio)} samples is not 1..25 frames")
        total += len(audio) // spf
    if total != st["frames"]:
        raise AssertionError(f"{name}: {total} frames of audio, {st['frames']} generated")


def log_run(name, st, details):
    log(f"{name} on {details['card']}: graphs, bucket {st['prompt_bucket']}, "
        f"{st['frames']} frames, prefill {st['prefill_s'] * 1e3:.1f} ms, "
        f"{st['frames_per_s']:.2f} frames/s, generate {st['generate_s']:.3f} s (capture "
        f"{st['capture_s']:.3f}), mimi {st['decode_s']:.3f} s, RTF {st['rtf']:.3f}")
    details[name] = st


def reset_counts():
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa
    from csm_torch.ops import int4_matmul as i4
    from csm_torch.ops import matvec as mv

    dec.launches = dec.int8_launches = fa.launches = fa.dq_launches = fa.dkv_launches = 0
    i4.launches = i4.dequant_calls = mv.launches = 0


def read_counts():
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa
    from csm_torch.ops import int4_matmul as i4
    from csm_torch.ops import matvec as mv

    return {"decode_attention": dec.launches, "decode_attention_int8": dec.int8_launches,
            "flash_attention_fwd": fa.launches,
            "flash_attention_bwd_dq": fa.dq_launches, "flash_attention_bwd_dkv": fa.dkv_launches,
            "int4_matmul": i4.launches, "int4_dequant_route": i4.dequant_calls,
            "matvec": mv.launches}


def drive(name, gen, calls, args, details, needs, kv_int8=False):
    """Drive ``calls`` ((run name, callable, batch size), ...) inside one
    launch-count window: every count is set to 0 just before and read just
    after, then held to what the runs must launch; each kernel in ``needs``
    must have launched.  Under CUDA-graph replay the counters move by the
    launches each graph recorded at its capture, so the formulas hold with
    ``steps`` the step replays run; a call that captured its key (none
    should: the phases capture first) also ran one eager prefill frame and
    one eager step, counted as a generate of one step.  Returns the
    counts."""
    from csm_torch.ops.flash_attention import FLASH_MIN_SEQ

    quant = gen.params["backbone"]["w13"]
    int4 = isinstance(quant, dict) and "w4p" in quant
    want = dict.fromkeys(read_counts(), 0)
    results = []
    reset_counts()  # the window opens
    for sub, call, B in calls:
        outs = call()
        st = dict(gen.last_stats)
        for s in [st] + ([dict(st, steps=1)] if st["capture_s"] else []):
            fl, i8 = decode_expected(args, s, kv_int8)
            want["decode_attention"] += fl
            want["decode_attention_int8"] += i8
            want["flash_attention_fwd"] += (
                args.backbone.num_layers if s["prompt_bucket"] >= FLASH_MIN_SEQ else 0)
            if int4:
                k, d = int4_expected(args, s, B)
                want["int4_matmul"] += k
                want["int4_dequant_route"] += d
        results.append((sub, outs, st))
    got = read_counts()  # the window closes: checks below launch nothing
    if got != want or not all(got[k] for k in needs):
        raise AssertionError(f"{name}: launches {got}, the path needs {want}")
    for sub, outs, st in results:
        check_audio(sub, outs, st)
        log_run(sub, st, details)
    details[f"{name}_launches"] = got
    log(f"{name} launches: {got}")
    return got


def free(gen):
    """Drop a generator's graphs, their pools and buffers, and its weights
    from the card before the next load."""
    import gc

    import torch

    gen.close()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 4b


# the card's watermark against the CPU's, float32 with TF32 off on both, on
# the port's random weights (normal / sqrt(fan_in)) and speech-band audio
# over a noise floor: encode_wav within this share of the input's peak (the
# watermark is ~2e-2 of it), the message decoder's logits within this share
# of their largest (TF32 would give ~1e-3), with equal argmax.  The
# SilentCipher-layout test files (weights 0.1 * normal) are not used for
# this: their message decoder amplifies float32 rounding layer by layer
# until float32 and float64 logits part on the CPU alone.
WM_ENCODE_SHARE = 1e-5
WM_LOGIT_SHARE = 1e-5
WM_KEY = [212, 211, 146, 56, 201]  # the public CSM key


def write_silentcipher(ckpt_dir, seed=0):
    """Random SilentCipher checkpoints in its exact layout (``main.{i}``
    gated convs with BatchNorm and a linear; the message decoder's convs at
    odd indices, Dropout between them): enc_c.ckpt, dec_c.ckpt,
    dec_m_0.ckpt."""
    import os

    import torch

    g = torch.Generator().manual_seed(seed)

    def gated(prefix, out_ch, in_ch, k):
        return {f"{prefix}.{name}": t for name, t in (
            ("conv.weight", torch.randn(out_ch, in_ch, k, k, generator=g) * 0.1),
            ("conv.bias", torch.zeros(out_ch)),
            ("gate.weight", torch.randn(out_ch, in_ch, k, k, generator=g) * 0.1),
            ("gate.bias", torch.zeros(out_ch)),
            ("bn.weight", torch.ones(out_ch)), ("bn.bias", torch.zeros(out_ch)),
            ("bn.running_mean", torch.zeros(out_ch)), ("bn.running_var", torch.ones(out_ch)))}

    enc = {**gated("main.0", 32, 1, 3), **gated("main.1", 32, 32, 3), **gated("main.2", 32, 32, 3),
           "linear.weight": torch.randn(512, 5, generator=g) * 0.05, "linear.bias": torch.zeros(512)}
    dec_c = {**gated("main.0", 96, 96, 3), **gated("main.1", 96, 96, 3),
             **gated("main.2", 96, 96, 3), **gated("main.3", 1, 96, 1)}
    dec_m = gated("main.1", 128, 1, 3)
    for i in range(8):
        dec_m.update(gated(f"main.{3 + 2 * i}", 128, 128, 3))
    dec_m.update(gated("main.19", 5, 128, 3))
    dec_m.update({"linear.weight": torch.randn(1, 512, generator=g) * 0.05,
                  "linear.bias": torch.zeros(1)})
    os.makedirs(ckpt_dir, exist_ok=True)
    for name, state in (("enc_c.ckpt", enc), ("dec_c.ckpt", dec_c), ("dec_m_0.ckpt", dec_m)):
        torch.save(state, os.path.join(ckpt_dir, name))


def speech_band(seconds, sr=24_000, seed=0):
    """Tones in the speech band plus a little noise, float32."""
    import numpy as np

    t = np.arange(int(seconds * sr)) / sr
    x = sum(0.05 * np.sin(2 * np.pi * f * t) for f in (180, 420, 950, 2300))
    return (x + 0.005 * np.random.default_rng(seed).standard_normal(t.size)).astype(np.float32)


def no_shift_logits(w, audio, sr):
    """The message decoder's logits that ``decode_wav`` reads without the
    phase-shift search, through its ``_decode_frames`` seam."""
    keep = {}
    inner = w._decode_frames

    def record(params, y):
        keep["logits"] = out = inner(params, y)
        return out

    w._decode_frames = record
    try:
        w.decode_wav(audio, sr, phase_shift_decoding=False)
    finally:
        del w._decode_frames
    return keep["logits"].cpu().numpy()


def decode_flops(w, num_samples: int) -> float:
    """Multiply-adds × 2 of the message decoder's convolutions for one
    shift of ``num_samples`` at the model rate (both convs of each gated
    layer over the message band and every STFT frame)."""
    pixels = w.message_band_size * w._n_frames(num_samples)
    return sum(2 * 2 * g.w.numel() * pixels for g in w.params["dec_m"]["layers"])


def phase_files(details):
    """The user's path from files at CSM-1B width: a bf16 torchtune
    ``ckpt.pt`` (3.1 GB) written from the random weights of seed 0 and
    SilentCipher files, in a temporary directory; ``csm-torch-generate``
    run in process from them (weights bit-equal to the in-memory model's,
    codes equal to its at topk=1, decode launches held); the verify CLI on
    its wav; then on the port's random watermark weights, the protocol on
    the card with the CNN bypassed, the watermark card against CPU, and
    encode and decode times and peak memory at 10 s and 60 s."""
    import os
    import tempfile

    import numpy as np
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.cli import generate as cli
    from csm_torch.data.audio import load_wav
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.utils.checkpoint_compat import export_to_torch_names
    from csm_torch.utils.params import cast_params, random_csm_params
    from csm_torch.watermarking import model as wm
    from csm_torch.watermarking import watermarker as wmk

    args = csm_1b_args()
    rec = details["files"] = {}
    with tempfile.TemporaryDirectory(prefix="csm_files_") as tmp:
        ckpt, sc, wav = (os.path.join(tmp, n) for n in ("ckpt.pt", "silentcipher", "out.wav"))
        t0 = time.perf_counter()
        params = cast_params(random_csm_params(args, 0, device="cuda"), torch.bfloat16)
        state = {k: v.to(torch.bfloat16) for k, v in export_to_torch_names(params, args).items()}
        del params
        torch.save(state, ckpt)
        rec["ckpt_bytes"] = os.path.getsize(ckpt)
        rec["ckpt_params"] = sum(v.numel() for v in state.values())
        del state
        write_silentcipher(sc)
        rec["write_s"] = time.perf_counter() - t0
        log(f"files: ckpt.pt {rec['ckpt_bytes'] / 1e9:.3f} GB ({rec['ckpt_params'] / 1e9:.4f} B "
            f"bf16 parameters) and SilentCipher files written in {rec['write_s']:.1f} s")

        # csm-torch-generate in process, its generator kept and its codec recorded
        built = []
        real_build = cli.build_generator

        def build(a):
            t = time.perf_counter()
            g = real_build(a)
            torch.cuda.synchronize()
            built.append((g, time.perf_counter() - t))
            g.mimi = Recording(g.mimi)
            return g

        argv = ["--model-path", ckpt, "--watermark-ckpt", sc, "--allow-byte-tokenizer",
                "--topk", "1", "--text", SHORT_TEXT, "--max-audio-length-ms", "2000",
                "--output", wav]
        cli.build_generator = build
        reset_counts()  # the window opens: the CLI's load, generate, watermark
        try:
            if cli.main(argv) != 0:
                raise AssertionError("csm-torch-generate failed")
        finally:
            cli.build_generator = real_build
        got = read_counts()
        gen, rec["load_s"] = built[0]
        st = dict(gen.last_stats)
        want = dict.fromkeys(got, 0)
        for s in [st] + ([dict(st, steps=1)] if st["capture_s"] else []):
            want["decode_attention"] += decode_expected(args, s)[0]
        if got != want:
            raise AssertionError(f"csm-torch-generate: launches {got}, the path needs {want}")
        audio, sr = load_wav(wav)
        if sr != 24_000 or len(audio) != st["frames"] * 1920 or not np.isfinite(audio).all():
            raise AssertionError(f"csm-torch-generate wrote {len(audio)} samples at {sr} Hz "
                                 f"for {st['frames']} frames")
        rec["cli"] = {k: st[k] for k in ("rtf", "frames_per_s", "wall_s", "watermark_s",
                                         "capture_s", "prefill_s", "frames")}
        rec["cli_launches"] = got
        log(f"csm-torch-generate from files on {details['card']}: load {rec['load_s']:.2f} s, "
            f"{st['frames']} frames, first call (capture {st['capture_s']:.3f} s) RTF "
            f"{st['rtf']:.3f} with the watermark ({1e3 * st['watermark_s']:.1f} ms); "
            f"launches {got}")

        # the same weights made in memory: bit-equal trees, equal codes
        mem = load_csm(args=args, compute_dtype=torch.bfloat16, text_tokenizer=ByteTokenizer())
        mem.mimi = Recording(mem.mimi)
        mem.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
        for comp in ("backbone", "decoder"):
            for k, v in mem.params[comp].items():
                if not torch.equal(gen.params[comp][k], v):
                    raise AssertionError(f"{comp}.{k} from ckpt.pt differs from the written weights")
        for k in ("text_embeddings", "audio_embeddings", "projection", "codebook0_head",
                  "audio_head"):
            if not torch.equal(gen.params[k], mem.params[k]):
                raise AssertionError(f"{k} from ckpt.pt differs from the written weights")
        (a,), (b,) = gen.mimi.decoded, mem.mimi.decoded
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError("csm-torch-generate's codes differ from the in-memory model's")
        free(mem)
        log(f"  weights from ckpt.pt equal the written ones bit for bit; codes equal the "
            f"in-memory model's over {a.shape[1]} frames at topk=1")

        # warm: the CLI's generator with and without its watermark, in turns
        wm_fn, runs = gen.watermarker, {"watermark": [], "none": []}
        for rep in range(2):
            for name in ("watermark", "none")[:: 1 if rep == 0 else -1]:
                gen.watermarker = wm_fn if name == "watermark" else None
                gen.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
                runs[name].append({k: gen.last_stats[k] for k in ("rtf", "watermark_s",
                                                                  "frames_per_s")})
        rec["warm"] = runs
        log("  warm generate, RTF with the watermark "
            + " ".join(f"{x['rtf']:.3f}" for x in runs["watermark"]) + " (watermark ms "
            + " ".join(f"{1e3 * x['watermark_s']:.1f}" for x in runs["watermark"])
            + "), without " + " ".join(f"{x['rtf']:.3f}" for x in runs["none"]))
        free(gen)

        # csm-torch-verify on the wav, its own process
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "csm_torch.cli.verify", wav,
                            "--watermark-ckpt", sc], cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        rec["verify_cli"] = {"returncode": r.returncode, "s": time.perf_counter() - t0}
        if r.returncode not in (0, 1):
            raise AssertionError(f"csm-torch-verify exited {r.returncode}:\n{r.stdout}{r.stderr}")
        log(f"  csm-torch-verify on the wav: exit {r.returncode} (random CNN weights) in "
            f"{rec['verify_cli']['s']:.1f} s, process start included")

    # the protocol on the card with the CNN bypassed: the 52-shift search
    # over a tiling of the key that starts mid-period
    precision = torch.backends.cudnn.conv.fp32_precision, torch.backends.cuda.matmul.fp32_precision
    rec["process_fp32_precision"] = {"cudnn.conv": precision[0], "cuda.matmul": precision[1]}
    log(f"  the process's float32 precision: cuDNN convolutions {precision[0]!r}, matmuls "
        f"{precision[1]!r}; the watermarker runs 'ieee' inside its calls")
    weights = wm.init_watermark_params(torch.Generator().manual_seed(0))
    card = wmk.Watermarker(weights)
    host = wmk.Watermarker(weights, device="cpu")
    sym = wmk.bytes_to_symbols(WM_KEY)

    def tiled(params, y):
        n = card._n_frames(y.shape[1])
        t = wmk.tile_message(sym, card.message_dim, n + 7)[:, 7:]
        return torch.from_numpy(np.repeat(t[None], y.shape[0], axis=0)).to(y.device)

    card._decode_frames = tiled
    try:
        found = wmk.verify(card, speech_band(2.0), 24_000, WM_KEY)
    finally:
        del card._decode_frames
    if not found:
        raise AssertionError("the bypassed-CNN protocol did not recover the key on the card")

    # card against CPU
    audio = speech_band(2.0)
    enc_card = card.encode_wav(audio, 24_000, WM_KEY)
    enc_host = host.encode_wav(audio, 24_000, WM_KEY)
    enc_err = float(np.abs(enc_card - enc_host).max())
    if not enc_err <= WM_ENCODE_SHARE * np.abs(audio).max():
        raise AssertionError(f"encode_wav card against CPU: {enc_err:.3e}")
    lc, lh = no_shift_logits(card, enc_host, 24_000), no_shift_logits(host, enc_host, 24_000)
    logit_err = float(np.abs(lc - lh).max())
    if not (logit_err <= WM_LOGIT_SHARE * np.abs(lh).max()
            and (lc.argmax(1) == lh.argmax(1)).all()):
        raise AssertionError(f"decode logits card against CPU: {logit_err:.3e}")
    rec["card_vs_cpu"] = {"encode_max_abs_err": enc_err, "logits_max_abs_err": logit_err,
                          "frames": int(lc.shape[-1])}
    log(f"  watermark card against CPU (2 s): encode max |diff| {enc_err:.2e}, logits "
        f"{logit_err:.2e} over {lc.shape[-1]} frames, argmax equal; key recovered on the card "
        f"with the CNN bypassed")

    # times and memory
    ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        card.encode_wav(audio, 24_000, WM_KEY)
        ms.append(1e3 * (time.perf_counter() - t0))
    rec["encode_ms_2s"] = ms[1:]
    for seconds in (10, 60):
        clip = speech_band(seconds, seed=seconds)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card.decode_wav(clip, 24_000)
        dt = time.perf_counter() - t0
        shifts = len(range(0, card.hop, 10))
        flops = shifts * decode_flops(card, seconds * wmk.MODEL_SR - (shifts - 1) * 10)
        rec[f"decode_{seconds}s"] = {
            "s": dt, "shifts": shifts, "conv_tflop": flops / 1e12,
            "conv_tflop_per_s": flops / 1e12 / dt,
            "shifts_per_chunk": card.shifts_per_chunk(seconds * wmk.MODEL_SR),
            "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
            "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    del card, host
    torch.cuda.empty_cache()
    if (torch.backends.cudnn.conv.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision) != precision:
        raise AssertionError("the watermarker left the process's float32 precision changed")
    log(f"  encode_wav of 2 s on the card: ms " + " ".join(f"{x:.1f}" for x in ms[1:]))
    for seconds in (10, 60):
        d = rec[f"decode_{seconds}s"]
        log(f"  decode_wav of {seconds} s ({d['shifts']} shifts, {d['shifts_per_chunk']} a "
            f"chunk): {d['s']:.2f} s, {d['conv_tflop']:.1f} TFLOP of convolutions, "
            f"{d['conv_tflop_per_s']:.1f} TFLOP/s against 67 for float32 outside the tensor "
            f"cores; peak {d['peak_allocated_gib']:.2f} GiB allocated, "
            f"{d['peak_reserved_gib']:.2f} reserved")


def phase_quantized(details):
    """The quantized path through the CUDA graphs: int4 at CSM-1B width
    (graph against eager for generate; generate and generate_batch with
    launch counts held to what the path must launch) and at 8B width (graph
    against eager, peak device memory), then short runs of int8,
    int8-decoder and the int8 KV cache.  Returns the int4 kernel's launches
    in the CSM-1B int4 runs."""
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.models.config import csm_8b_args

    tok = ByteTokenizer()
    args = csm_1b_args()
    t0 = time.perf_counter()
    gen = load_csm(args=args, quantize="int4", text_tokenizer=tok)
    torch.cuda.synchronize()
    details["int4_load_s"] = time.perf_counter() - t0
    short = ("int4_generate_short", lambda: [gen.generate(SHORT_TEXT, max_audio_length_ms=2000)], 1)
    batch = ("int4_generate_batch",
             lambda: gen.generate_batch(BATCH_TEXTS, [0, 1], max_audio_length_ms=2000), 2)
    compare_loops("int4", gen, [short], details, reps=1)  # one pair: the time budget
    batch[1]()  # captures the batch key
    torch.cuda.reset_peak_memory_stats()
    got = drive("int4", gen, [short, batch], args, details, ("int4_matmul", "decode_attention"))
    int4_launches = got["int4_matmul"]
    details["int4_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    details["int4_peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    profile_generate(gen, details, "int4_profile")
    free(gen)

    args8 = csm_8b_args()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = load_csm(args=args8, quantize="int4", text_tokenizer=tok)
    torch.cuda.synchronize()
    details["int4_8b_load_s"] = time.perf_counter() - t0
    details["int4_8b_weights_gib"] = torch.cuda.memory_allocated() / 2**30
    details["int4_8b_load_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    run8 = ("int4_8b_generate",
            lambda: [gen.generate("The eight billion flavor speaks.", max_audio_length_ms=1000)], 1)
    compare_loops("int4_8b", gen, [run8], details, reps=1)
    torch.cuda.reset_peak_memory_stats()
    drive("int4_8b", gen, [run8], args8, details, ("int4_matmul", "decode_attention"))
    details["int4_8b_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    details["int4_8b_peak_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30
    log(f"8B int4: load {details['int4_8b_load_s']:.1f} s, weights and codec "
        f"{details['int4_8b_weights_gib']:.2f} GiB, peak while loading "
        f"{details['int4_8b_load_peak_gib']:.2f} GiB, while generating through the graphs "
        f"{details['int4_8b_peak_memory_gib']:.2f} GiB allocated, "
        f"{details['int4_8b_peak_reserved_gib']:.2f} reserved")
    free(gen)

    for mode, kw in (("int8", dict(quantize="int8")), ("int8_decoder", dict(quantize="int8-decoder"))):
        gen = load_csm(args=args, text_tokenizer=tok, **kw)
        run = (f"{mode}_generate",
               lambda: [gen.generate("A short quantized line.", max_audio_length_ms=800)], 1)
        run[1]()  # captures the key
        drive(mode, gen, [run], args, details, ("decode_attention",))
        free(gen)
    del gen, run  # the last one's codec too, before the next measures memory
    return {"int4_matmul": int4_launches,
            "decode_attention_int8": kv_int8_vs_bf16(args, tok, details)["decode_attention_int8"]}


def kv_int8_vs_bf16(args, tok, details):
    """The int8 KV cache beside the bf16 one on the same weights, in one
    call: ``generate_short`` (bucket 64, 25 frames) through the graphs.
    Each cache's peak allocated and reserved memory over its first call
    (its capture included), both generators' graphs dropped before it, with
    what the card held before the weights loaded; then frames/s in turns
    (bf16, int8, int8, bf16); the int8 graph against the eager loop
    (codes equal at topk 50); then the int8 run's launch-count window: the
    decode kernel's int8 form on every backbone step, the float form on the
    decoder's.  Returns the window's counts."""
    import gc

    import torch

    from csm_torch import load_csm
    from csm_torch.generator import Generator

    gc.collect()
    torch.cuda.empty_cache()
    before_gib = torch.cuda.memory_allocated() / 2**30
    gen8 = load_csm(args=args, text_tokenizer=tok, kv_int8=True)
    gen16 = Generator(gen8.params, args, mimi=gen8.mimi, text_tokenizer=tok, device="cuda")
    gens = {"bf16": gen16, "int8": gen8}
    rec = {name: {"frames_per_s": [], "allocated_before_load_gib": before_gib} for name in gens}
    for name, g in gens.items():
        for other in gens.values():
            other.graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        g.generate(SHORT_TEXT, max_audio_length_ms=2000)
        torch.cuda.synchronize()
        rec[name].update(peak_allocated_gib=torch.cuda.max_memory_allocated() / 2**30,
                         peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30,
                         first_call_prefill_s=g.last_stats["capture_s"] + g.last_stats["prefill_s"])
    for g in gens.values():  # the memory pass dropped the other's graphs: capture again
        g.generate(SHORT_TEXT, max_audio_length_ms=2000)
    for name in ("bf16", "int8", "int8", "bf16"):
        gens[name].generate(SHORT_TEXT, max_audio_length_ms=2000)
        rec[name]["frames_per_s"].append(gens[name].last_stats["frames_per_s"])
    details["kv_int8_vs_bf16"] = rec
    for name, r in rec.items():
        log(f"generate_short, {name} KV cache, on {details['card']}: peak "
            f"{r['peak_allocated_gib']:.4f} GiB allocated ({before_gib:.4f} held before the "
            f"weights loaded), {r['peak_reserved_gib']:.4f} reserved "
            f"(first call, capture included: prefill {1e3 * r['first_call_prefill_s']:.1f} ms); "
            f"frames/s " + " ".join(f"{x:.2f}" for x in r["frames_per_s"]))
    run = ("kv_int8_generate", lambda: [gen8.generate("A short quantized line.",
                                                      max_audio_length_ms=800)], 1)
    compare_loops("kv_int8", gen8, [run], details, reps=1)
    got = drive("kv_int8", gen8, [run], args, details,
                ("decode_attention", "decode_attention_int8"), kv_int8=True)
    free(gen16)
    free(gen8)
    return got


# ---------------------------------------------------------------- phase 4c


# The JAX package's serving protocol (scripts/bench_serving.py): prompts of
# 48 random text frames, 63 frames a request, 2 x n_slots requests, a
# 1024-column cache, chunk 8, temperature 0.9, topk 50.
SERVE_T, SERVE_FRAMES, SERVE_MAX_SEQ, SERVE_CHUNK = 48, 63, 1024, 8
SERVE_LONG_T = 150  # a prompt in the 256 bucket: its prefill takes the flash kernel


def serve_requests(args, n, T=SERVE_T, max_frames=SERVE_FRAMES, seed=0):
    import numpy as np

    from csm_torch.serving import StreamRequest

    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    reqs = []
    for i in range(n):
        tokens = np.zeros((T, K + 1), np.int32)
        mask = np.zeros((T, K + 1), bool)
        tokens[:, -1] = rng.integers(1, args.text_vocab_size, T)
        mask[:, -1] = True
        reqs.append(StreamRequest(tokens, mask, max_frames=max_frames, request_id=i))
    return reqs


def serving_expected(args, steps, prefills, kv_int8, int4):
    """Launches a server's run must make: ``steps`` S=1 steps by capacity
    c, ``prefills`` by bucket.  A step launches the decode kernel once a
    backbone layer (its int8 form over an int8 cache) and once a decoder
    layer in each of the decoder's
    K-2 S=1 calls; a prefill launches the decoder's, and the flash kernel
    once a backbone layer at buckets of FLASH_MIN_SEQ and more.  int4
    weights: each call's four projections a layer go through the kernel at
    M <= MAX_KERNEL_ROWS rows, else the dequant route; a step's backbone has
    c rows, the decoder's first call 2c, its others c; a prefill's backbone
    has the bucket's rows, its decoder 2 then 1."""
    from csm_torch.ops.flash_attention import FLASH_MIN_SEQ
    from csm_torch.ops.int4_matmul import MAX_KERNEL_ROWS

    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    want = dict.fromkeys(read_counts(), 0)

    def proj(rows, n):
        if int4:
            want["int4_matmul" if rows <= MAX_KERNEL_ROWS else "int4_dequant_route"] += n

    for c, n in steps.items():
        want["decode_attention"] += n * ((0 if kv_int8 else L_bb) + (K - 2) * L_dec)
        want["decode_attention_int8"] += n * (L_bb if kv_int8 else 0)
        proj(c, n * 4 * L_bb)
        proj(2 * c, n * 4 * L_dec)
        proj(c, n * 4 * L_dec * (K - 2))
    for b, n in prefills.items():
        want["decode_attention"] += n * (K - 2) * L_dec
        want["flash_attention_fwd"] += n * L_bb * (b >= FLASH_MIN_SEQ)
        proj(b, n * 4 * L_bb)
        proj(2, n * 4 * L_dec)
        proj(1, n * 4 * L_dec * (K - 2))
    return want


def served(name, server, reqs, args, needs):
    """One launch-count window around ``server.run(reqs)`` from a reset:
    every request completes with 1..max_frames frames and codes in range,
    every slot frees, and the launches equal what its steps and prefills
    must launch.  Returns (results by id, stats, counts)."""
    import torch

    server.reset(0)
    steps0, pre0 = dict(server.step_calls), dict(server.prefill_calls)
    reset_counts()  # the window opens
    results, stats = server.run(reqs)
    torch.cuda.synchronize()
    got = read_counts()  # the window closes
    steps = {c: n - steps0.get(c, 0) for c, n in server.step_calls.items()}
    pre = {b: n - pre0.get(b, 0) for b, n in server.prefill_calls.items()}
    int4 = server.weight_dtype == "int4"
    want = serving_expected(args, steps, pre, server.kv_dtype is not None, int4)
    if got != want or not all(got[k] for k in needs):
        raise AssertionError(f"{name}: launches {got}, the steps {steps} and prefills {pre} "
                             f"need {want}")
    by_id = {r.request_id: r.frames for r in results}
    limits = {r.request_id: r.max_frames for r in reqs}
    if set(by_id) != set(limits):
        raise AssertionError(f"{name}: {len(by_id)} of {len(limits)} requests came back")
    for rid, f in by_id.items():
        if not (1 <= f.shape[0] <= limits[rid] and f.shape[1] == args.audio_num_codebooks
                and f.min() >= 0 and f.max() < args.audio_vocab_size):
            raise AssertionError(f"{name}: request {rid} gave frames {f.shape} in "
                                 f"[{f.min()}, {f.max()}]")
    if server.active.any() or server._inflight is not None or bool(server.slots.live.any()):
        raise AssertionError(f"{name}: a slot did not free")
    return by_id, stats, got


def cancel_check(name, server, args, n_frames=24):
    """n_slots requests admitted at once, run to the end, then again with
    request 0 cancelled after the first step: its slot frees at once (on the
    host and on the device), and every other stream's codes equal the run
    without the cancel.  The batch keeps its capacity and the draws their
    order, so the sampled codes (the server's own topk) are equal too; each
    row's arithmetic reads its own row only."""
    import numpy as np

    runs = []
    for cancel in (False, True):
        server.reset(0)
        reqs = serve_requests(args, server.n_slots, max_frames=n_frames, seed=1)
        for r in reqs:
            assert server.submit(r) is not None
        done = server.step()
        if cancel:
            res = server.cancel(0)
            if res is None or not res.cancelled or server.active[0] or bool(server.slots.live[0]):
                raise AssertionError(f"{name}: cancel did not free slot 0")
        done += server.run([])[0]
        runs.append({r.request_id: r.frames for r in done})
    full, cut = runs
    same = [rid for rid in cut if rid != 0 and np.array_equal(cut[rid], full[rid])]
    if 0 in cut or len(same) != server.n_slots - 1:
        raise AssertionError(f"{name}: after a cancel {len(same)} of {server.n_slots - 1} "
                             f"other streams kept their codes")
    return len(same)


def serve_record(name, server, by_id, stats, warmup_s, details, **extra):
    """Record a run: aggregate frames/s and RTF, each stream's frames over
    its time from admission to finish, first-frame times from the start of
    the run (the second wave waits for slots), chunk wall times, warmup
    seconds, peak memory since the server was made."""
    import torch

    reqs = stats["requests"]
    first = sorted(r["first_frame_s"] for r in reqs.values())
    after_admit = sorted(r["first_frame_s"] - r["admit_s"] for r in reqs.values())
    per_stream = [len(by_id[rid]) / (r["done_s"] - r["admit_s"]) for rid, r in reqs.items()]
    rec = {
        "n_slots": server.n_slots, "weight_dtype": server.weight_dtype,
        "kv_dtype": "int8" if server.kv_dtype is not None else "bf16",
        "pipelined": server.pipelined, "graphs": server.graphs,
        "requests": len(reqs), "frames": stats["total_frames"], "wall_s": stats["wall_s"],
        "frames_per_s": stats["frames_per_s"], "aggregate_rtf": stats["aggregate_rtf"],
        "stream_frames_per_s_median": statistics.median(per_stream),
        "first_frame_s_median": statistics.median(first), "first_frame_s_max": first[-1],
        "first_frame_after_admit_s_median": statistics.median(after_admit),
        "first_frame_after_admit_s_max": after_admit[-1],
        "chunk_wall_s_median": statistics.median(stats["step_wall"]),
        "chunk_wall_s_max": max(stats["step_wall"]), "chunks": len(stats["step_wall"]),
        "read_wait_s": stats["read_wait_s"],
        "warmup_s": warmup_s,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30, **extra}
    details.setdefault("serving", {})[name] = rec
    log(f"serving {name} on {details['card']}: {rec['requests']} requests, {rec['frames']} "
        f"frames in {rec['wall_s']:.3f} s: {rec['frames_per_s']:.2f} frames/s, RTF "
        f"{rec['aggregate_rtf']:.3f}, {rec['stream_frames_per_s_median']:.2f} frames/s a "
        f"stream; first frame {1e3 * rec['first_frame_s_median']:.1f} ms median, "
        f"{1e3 * rec['first_frame_s_max']:.1f} max (after admission "
        f"{1e3 * rec['first_frame_after_admit_s_median']:.1f} / "
        f"{1e3 * rec['first_frame_after_admit_s_max']:.1f}); chunk "
        f"{1e3 * rec['chunk_wall_s_median']:.1f} "
        f"ms median, {1e3 * rec['chunk_wall_s_max']:.1f} max; host blocked on results "
        f"{rec['read_wait_s']:.3f} s; warmup {warmup_s:.2f} s; peak "
        f"{rec['peak_allocated_gib']:.2f} GiB allocated, {rec['peak_reserved_gib']:.2f} reserved"
        + "".join(f"; {k} {v}" for k, v in extra.items()))
    return rec


def admission_ms(server, args):
    """Host milliseconds an admission takes, device work included: n_slots
    requests submitted to an empty server (one prefill graph replay each,
    one after the other), then a synchronize."""
    import torch

    server.reset(0)
    reqs = serve_requests(args, server.n_slots, seed=5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in reqs:
        server.submit(r)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / len(reqs)
    server.reset(0)
    log(f"admission at {server.n_slots} slots: {ms:.3f} ms a request (its prefill included)")
    return ms


def profile_serving(name, server, args, details):
    """Device-busy share of a few chunks at full load: n_slots requests
    admitted, one chunk to warm, then three chunks under torch.profiler;
    busy is the kernels' summed time (one stream) over the wall time; the
    decode kernel's share of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    server.reset(0)
    for r in serve_requests(args, server.n_slots, seed=2):
        server.submit(r)
    server.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            server.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    dec = sum(e.self_device_time_total for e in kernels if "decode_attention" in e.key) / 1e3
    # the profiler slows the host between chunks, so the kernels' time a
    # chunk is also set against the unprofiled run's median chunk
    chunk_ms = 1e3 * details["serving"][name]["chunk_wall_s_median"]
    rec = {"wall_ms": wall_ms, "device_busy_ms": busy if busy else "not measured",
           "busy_share": busy / wall_ms if busy else "not measured",
           "busy_share_of_unprofiled_chunk": busy / 3 / chunk_ms if busy else "not measured",
           "decode_kernel_ms": dec, "decode_share": dec / busy if busy else "not measured",
           "top_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top]}
    details.setdefault("serving_profile", {})[name] = rec
    log(f"serving profile {name}, 3 chunks at {server.n_slots} slots: {wall_ms:.1f} ms wall, "
        f"kernels {rec['device_busy_ms']} ms (busy share {rec['busy_share']}; a chunk's kernels "
        f"over the unprofiled run's median chunk {rec['busy_share_of_unprofiled_chunk']}), the "
        f"decode kernel {dec:.3f} ms (share {rec['decode_share']})")
    for k, n, ms in rec["top_kernels"]:
        log(f"  {ms:9.3f} ms {n:6d}x {k}")


# At a first difference between a served stream and its single-stream run,
# the single-stream logits of the code the server picked may lie at most this
# share of their largest magnitude under its argmax (float32: a tie that
# rounding decides, far under a typical top-2 gap; a wrong row, offset or
# mask gives such a gap).
TIE_SHARE = 1e-3


def single_stream_agreement(name, params, args, dtype, n_frames, details, hold):
    """CSM-1B at topk=1: 8 streams served together (an 8-slot server,
    graphs captured on first use) against each generated alone
    (``generate_audio_tokens_jit``, B=1): each stream's leading frames that
    agree and, where they part, the tie that parted them: the single-stream
    logits at the first differing code, recorded by the eager loop with
    ``csm.sample_topk`` wrapped (its codes equal the graph run's), and the
    margin of its argmax over the served code, against the median top-2 gap
    of every recorded call.  ``hold``: each first difference must be a tie
    (margin <= TIE_SHARE of the logits' largest magnitude)."""
    from csm_torch.serving import BatchedServer

    server = BatchedServer(params, args, n_slots=8, max_seq_len=SERVE_MAX_SEQ, temperature=0.9,
                           topk=1, chunk_size=SERVE_CHUNK, compute_dtype=dtype)
    reqs = serve_requests(args, server.n_slots, max_frames=n_frames, seed=3)
    results, _ = server.run(reqs)
    server.close()
    agree_with_single_stream(name, {r.request_id: r.frames for r in results},
                             {r.request_id: (r.tokens, r.mask) for r in reqs},
                             params, args, dtype, n_frames, details, hold)


def agree_with_single_stream(name, got, prompts, params, args, dtype, n_frames, details, hold):
    """Served frames ``got`` (by request id) against the first ``n_frames``
    that each prompt ((T, K+1) tokens and mask) generates alone, as
    ``single_stream_agreement`` holds them."""
    import numpy as np
    import torch

    from csm_torch.models import csm
    from csm_torch.models.generation import (GraphCache, bucket_length, generate_audio_tokens,
                                             generate_audio_tokens_jit)

    K = args.audio_num_codebooks
    cache, agree, ties = GraphCache(), [], []

    def prompt(rid):
        tokens, mask = prompts[rid]
        T = tokens.shape[0]
        toks = np.zeros((1, bucket_length(T), K + 1), np.int32)
        msk = np.zeros(toks.shape, bool)
        toks[0, :T], msk[0, :T] = tokens, mask
        return toks, msk, np.array([T], np.int32)

    for rid in prompts:
        res = generate_audio_tokens_jit(params, args, *prompt(rid), max_frames=n_frames, topk=1,
                                        compute_dtype=dtype, device="cuda", graphs=cache)
        solo = res.frames[0, : int(res.num_frames[0])].cpu().numpy()
        mine = got[rid][:n_frames]
        n = min(len(solo), len(mine))
        diff = np.nonzero((solo[:n] != mine[:n]).any(axis=1))[0]
        if not len(diff):
            if len(solo) != len(mine):
                raise AssertionError(f"{name}: request {rid} ends after {len(mine)} "
                                     f"frames served and {len(solo)} alone")
            agree.append(n)
            continue
        f = int(diff[0])
        k = int(np.nonzero(solo[f] != mine[f])[0][0])
        agree.append(f)
        seen, sample = [], csm.sample_topk

        def recording(logits, *a, **kw):
            seen.append(logits.detach().float().clone())
            return sample(logits, *a, **kw)

        csm.sample_topk = recording
        try:
            eager = generate_audio_tokens(params, args, *prompt(rid), max_frames=f + 1, topk=1,
                                          compute_dtype=dtype, device="cuda")
        finally:
            csm.sample_topk = sample
        if not np.array_equal(eager.frames[0, : f + 1].cpu().numpy(), solo[: f + 1]):
            raise AssertionError(f"{name}: the eager loop's codes differ from the graph run's")
        logits = torch.cat(seen)  # (frames * K, V): frame f's codebook k at f * K + k
        top2 = logits.topk(2, dim=-1).values
        L = logits[f * K + k]
        margin = float(L[int(solo[f, k])] - L[int(mine[f, k])])
        ties.append({"request": rid, "frame": f, "codebook": k, "margin": margin,
                     "margin_share_of_max": margin / float(L.abs().max()),
                     "median_top2_gap": float((top2[:, 0] - top2[:, 1]).median()),
                     "logit_std": float(L.std())})
    cache.clear()
    torch.cuda.synchronize()
    details.setdefault("serving_single_stream", {})[name] = {
        "frames": n_frames, "leading_frames_equal": agree, "ties": ties}
    log(f"{name} topk=1, {len(prompts)} served streams against each alone: leading frames equal "
        f"{agree} of {n_frames}")
    for t in ties:
        log(f"  request {t['request']} parts at frame {t['frame']} codebook {t['codebook']}: "
            f"margin {t['margin']:.3e} ({t['margin_share_of_max']:.2e} of the largest logit; "
            f"median top-2 gap {t['median_top2_gap']:.3e}, logit std {t['logit_std']:.3e})")
    if hold:
        wide = [t for t in ties if t["margin_share_of_max"] > TIE_SHARE]
        if wide:
            raise AssertionError(f"{name}: served streams part from single-stream where the "
                                 f"logits are not tied: {wide}")


def serving_reference(details):
    """The tiny float32 server on the card (TF32 off) against the same server
    on the CPU and against the port's single-stream ``generate_audio_tokens``
    on the card per request, at topk=1: equal codes.  Six requests over
    three slots, chunk 8; three of them at bucket + max_frames =
    max_seq_len, so dead rows write past the cache's end (dropped);
    synchronous and pipelined, through the graphs; a cancel on the card
    frees its slot."""
    import numpy as np
    import torch

    from csm_torch.models.config import tiny_test_args
    from csm_torch.models.generation import generate_audio_tokens
    from csm_torch.serving import BatchedServer, StreamRequest
    from csm_torch.utils.params import random_csm_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = tiny_test_args()
    K = args.audio_num_codebooks
    params = random_csm_params(args, seed=0)
    specs = [(20, 58), (30, 58), (9, 17), (40, 5), (12, 30), (50, 58)]  # (prompt, max_frames)

    def requests():
        rng = np.random.default_rng(4)
        reqs = []
        for i, (T, mf) in enumerate(specs):
            tokens = np.zeros((T, K + 1), np.int32)
            tokens[:, -1] = rng.integers(1, args.text_vocab_size, T)
            mask = np.zeros((T, K + 1), bool)
            mask[:, -1] = True
            reqs.append(StreamRequest(tokens, mask, max_frames=mf, request_id=i))
        return reqs

    out = {}
    for name, dev, pipelined in (("cpu", "cpu", False), ("card", "cuda", False),
                                 ("card_pipelined", "cuda", True)):
        server = BatchedServer(tree_map(lambda t: t.to(dev), params), args, n_slots=3,
                               max_seq_len=122, temperature=1.0, topk=1, chunk_size=8,
                               compute_dtype=torch.float32, pipelined=pipelined, device=dev)
        if dev == "cuda":
            server.warmup()
        results, _ = server.run(requests())
        out[name] = {r.request_id: r.frames for r in results}
        if name == "card":
            if int(server.offsets.max()) <= 122:
                raise AssertionError("serving reference: no row ran past the cache's end")
            server.reset(0)
            for r in requests()[:3]:
                server.submit(r)
            server.step()
            if server.cancel(1) is None or server.active[1] or bool(server.slots.live[1]):
                raise AssertionError("serving reference: cancel did not free its slot")
        server.close()
    card_params = tree_map(lambda t: t.to("cuda"), params)
    out["single_stream"] = {}
    for r in requests():
        T = r.tokens.shape[0]
        toks = np.zeros((1, 64, K + 1), np.int32)
        msk = np.zeros(toks.shape, bool)
        toks[0, :T], msk[0, :T] = r.tokens, r.mask
        res = generate_audio_tokens(card_params, args, toks, msk, np.array([T], np.int32),
                                    max_frames=r.max_frames, temperature=1.0, topk=1,
                                    compute_dtype=torch.float32, device="cuda")
        out["single_stream"][r.request_id] = res.frames[0, : int(res.num_frames[0])].cpu().numpy()
    for name in ("card", "card_pipelined", "single_stream"):
        for rid, f in out["cpu"].items():
            if not np.array_equal(out[name][rid], f):
                raise AssertionError(f"serving reference: {name} request {rid} differs from "
                                     f"the CPU server")
    frames = sum(len(f) for f in out["cpu"].values())
    details["serving_reference"] = {"frames": frames, "requests": len(specs)}
    log(f"serving reference (tiny float32): the card server, synchronous and pipelined, and "
        f"single-stream generation on the card equal the CPU server over {frames} frames of "
        f"{len(specs)} requests; a row ran past the cache's end; cancel freed its slot")


def phase_serving(details):
    """Continuous-batching serving at CSM-1B width on random weights from
    seed 0, through the CUDA graphs that ``warmup`` captures, on the JAX
    serving protocol: bf16 at 8 and 64 slots, synchronous and pipelined in
    turns on one server (at 8 slots the same server without graphs runs
    between them, and a window of 256-bucket prompts drives the flash
    kernel), each with an admission's time and a profile; the int8 KV cache
    and int4 weights at 8 slots; 8B int4 at 8 slots (8 requests of 24
    frames).  Each window's launches are held to what its steps and
    prefills must launch, and each configuration cancels a stream and keeps
    the others' codes.  Returns the launches summed over the windows."""
    import gc

    import torch

    from csm_torch import csm_1b_args
    from csm_torch.models.config import csm_8b_args
    from csm_torch.serving import BatchedServer
    from csm_torch.utils import quantize as qz
    from csm_torch.utils.params import cast_params, random_csm_params

    serving_reference(details)
    total = dict.fromkeys(read_counts(), 0)

    def make(params, args, n_slots, topk=50, graphs=True, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(params, args, n_slots=n_slots, max_seq_len=SERVE_MAX_SEQ,
                               temperature=0.9, topk=topk, chunk_size=SERVE_CHUNK, **kw)
        if not graphs:  # the same functions without capture (the eager run)
            server.graphs = False
        warmup_s = server.warmup()
        details.setdefault("serving_allocated_after_warmup_gib", {})[
            f"{n_slots}_{kw}"] = torch.cuda.memory_allocated() / 2**30
        return server, warmup_s

    def window(name, server, warmup_s, args, reqs, needs=("decode_attention",), **extra):
        by_id, stats, got = served(name, server, reqs, args, needs)
        for k, v in got.items():
            total[k] += v
        return serve_record(name, server, by_id, stats, warmup_s, details, **extra)

    def config(name, params, args, n_slots, n_req=None, max_frames=SERVE_FRAMES, needs=None,
               **kw):
        server, warmup_s = make(params, args, n_slots, **kw)
        reqs = serve_requests(args, n_req or 2 * n_slots, max_frames=max_frames)
        window(name, server, warmup_s, args, reqs, needs or ("decode_attention",),
               cancel_kept=cancel_check(name, server, args))
        server.close()

    def in_turns(name, server, warmup_s, args, between=None):
        """One server (its graphs shared by both modes), the protocol's
        requests synchronous, then pipelined; ``between`` runs after them;
        then each mode's cancel check.  (Each mode runs once: the
        script's time budget.)"""
        reqs = serve_requests(args, 2 * server.n_slots)
        for pipelined in (False, True):
            server.pipelined = pipelined
            window(name + ("_pipelined" if pipelined else ""), server, warmup_s, args, reqs)
        if between is not None:
            between()
        for pipelined in (False, True):
            server.pipelined = pipelined
            details["serving"][name + ("_pipelined" if pipelined else "")]["cancel_kept"] = (
                cancel_check(name, server, args))
        server.pipelined = False
        details["serving"][name]["admission_ms"] = admission_ms(server, args)

    args = csm_1b_args()
    params = random_csm_params(args, seed=0, device="cuda")
    # float32 with TF32 off (serving_reference set it): each stream equals
    # its single-stream run, or parts from it on a tie
    single_stream_agreement("float32", params, args, torch.float32, 4 * SERVE_CHUNK, details,
                            hold=True)
    params = cast_params(params, torch.bfloat16)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()

    # bf16, 8 slots: synchronous and pipelined in turns, the same server
    # without graphs between them; 256-bucket prompts (flash); a profile
    graphs, warmup_g = make(params, args, 8)

    def eager_run():  # one batch of 8 requests: the script's time budget
        eager, warmup_e = make(params, args, 8, graphs=False)
        window("bf16_8_eager", eager, warmup_e, args, serve_requests(args, 8))
        eager.close()

    in_turns("bf16_8", graphs, warmup_g, args, between=eager_run)
    window("bf16_8_long_prompts", graphs, warmup_g, args,
           serve_requests(args, 8, T=SERVE_LONG_T, max_frames=16),
           needs=("decode_attention", "flash_attention_fwd"))
    profile_serving("bf16_8", graphs, args, details)
    graphs.close()
    del graphs
    single_stream_agreement("bf16", params, args, torch.bfloat16, SERVE_FRAMES, details,
                            hold=False)

    server, warmup_s = make(params, args, 64)
    in_turns("bf16_64", server, warmup_s, args)
    profile_serving("bf16_64", server, args, details)
    server.close()
    del server
    config("kv_int8_8", params, args, 8, kv_dtype="int8",
           needs=("decode_attention", "decode_attention_int8"))
    config("int4_8", params, args, 8, weight_dtype="int4", needs=("decode_attention", "int4_matmul"))
    del params

    args8 = csm_8b_args()
    gc.collect()
    torch.cuda.empty_cache()
    params8 = qz.init_csm_params_quantized(torch.Generator("cuda").manual_seed(0), args8, "int4",
                                           device="cuda")
    config("int4_8b_8", params8, args8, 8, n_req=8, max_frames=24, weight_dtype="int4",
           needs=("decode_attention", "int4_matmul"))
    del params8
    gc.collect()
    torch.cuda.empty_cache()
    details["serving_launches"] = total
    log(f"serving launches over the windows: {total}")
    return total


# ---------------------------------------------------------------- phase 4f


# The bank of phase 4f: two r=8 adapters on q/v (the defaults), one r=16 on
# all seven projections, one on the decoder only; requests spread over ids
# 0 (the base model) to 4.  B is drawn N(0, BANK_B_STD^2): a trained
# adapter's B is not zero, and at this size its delta moves the codes.
ALL7 = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
BANK = {"qv_a": dict(r=8), "qv_b": dict(r=8), "all7": dict(r=16, target_modules=ALL7),
        "dec": dict(r=8, apply_to_backbone=False)}
BANK_B_STD = 0.02


def random_adapter(args, seed, device="cuda", **cfg):
    """(adapter tree, LoRAConfig): A from the init, B ~ N(0, BANK_B_STD^2)."""
    import torch

    from csm_torch.training import lora as lora_mod

    lcfg = lora_mod.LoRAConfig(**cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    lo = lora_mod.init_lora_params(gen, args, lcfg, device=device)
    for comp in lo.values():
        for ad in comp.values():
            ad["b"].normal_(0.0, BANK_B_STD, generator=gen)
    return lo, lcfg


def spread(reqs, names):
    """Each request's adapter, round the names (None: the base model)."""
    for i, r in enumerate(reqs):
        r.adapter = names[i % len(names)]
    return reqs


def phase_bank(details):
    """Multi-LoRA serving at CSM-1B width on random weights of seed 0, 8
    slots, phase 4c's protocol, a bank of four adapters (``BANK``).
    Float32 (TF32 off, topk=1): 10 streams over ids 0-4 served together,
    each against a single-stream generate on its adapter's merged weights
    (equal, or parting on a tie, held as phase 4c holds them).  bf16: the
    server without a bank, then with it (requests over ids 0-4), each run
    twice in a launch-count window, frames/s, per stream and peak memory.
    Then, during traffic on the pipelined bank server: ``remove_adapter`` of
    an unused adapter and an ``add_adapter`` into its id keep the bank's
    shapes (no capture, the streams in flight keep their codes), removing
    an adapter in use raises, and an adapter of a larger rank retakes the
    captures (counted and timed) and serves.  Last, the bank over int4
    weights, where the int4 kernel and decode run under it.  Returns the
    launches summed over the windows."""
    import gc

    import numpy as np
    import torch

    from csm_torch import csm_1b_args
    from csm_torch.serving import BatchedServer
    from csm_torch.training import lora as lora_mod
    from csm_torch.utils.params import cast_params, random_csm_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = csm_1b_args()
    names = [None] + list(BANK)
    adapters = {n: random_adapter(args, 100 + i, **c) for i, (n, c) in enumerate(BANK.items())}
    bank = {n: (lo, c, None) for n, (lo, c) in adapters.items()}
    rec = details["bank"] = {}
    total = dict.fromkeys(read_counts(), 0)

    # float32 witnesses
    params = random_csm_params(args, seed=0, device="cuda")
    server = BatchedServer(params, args, n_slots=8, max_seq_len=SERVE_MAX_SEQ, temperature=0.9,
                           topk=1, chunk_size=SERVE_CHUNK, compute_dtype=torch.float32,
                           adapters=bank)
    n_frames = 4 * SERVE_CHUNK
    reqs = spread(serve_requests(args, 10, max_frames=n_frames, seed=3), names)
    results, _ = server.run(reqs)
    server.close()
    del server
    got = {r.request_id: r.frames for r in results}
    for name in names:
        mine = [r for r in reqs if r.adapter == name]
        p = params if name is None else lora_mod.merge_lora(params, *adapters[name])
        agree_with_single_stream(f"bank_float32_{name or 'base'}",
                                 {r.request_id: got[r.request_id] for r in mine},
                                 {r.request_id: (r.tokens, r.mask) for r in mine}, p, args,
                                 torch.float32, n_frames, details, hold=True)
        del p
    params = cast_params(params, torch.bfloat16)

    def make(with_bank, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(params, args, n_slots=8, max_seq_len=SERVE_MAX_SEQ,
                               temperature=0.9, topk=50, chunk_size=SERVE_CHUNK,
                               adapters=bank if with_bank else None, **kw)
        return server, server.warmup()

    def window(name, server, warmup_s, reqs, needs=("decode_attention",)):
        by_id, stats, got = served(name, server, reqs, args, needs)
        for k, v in got.items():
            total[k] += v
        return serve_record(name, server, by_id, stats, warmup_s, details,
                            adapters=sorted(server._adapter_id))

    for name, with_bank in (("bank_none_8", False), ("bank_8", True)):
        server, warmup_s = make(with_bank)
        for again in ("", "_again"):
            r = window(name + again, server, warmup_s,
                       spread(serve_requests(args, 16), names if with_bank else [None]))
        rec[name] = {"frames_per_s": [details["serving"][name + a]["frames_per_s"]
                                      for a in ("", "_again")],
                     "stream_frames_per_s_median": r["stream_frames_per_s_median"],
                     "peak_allocated_gib": r["peak_allocated_gib"],
                     "warmup_s": warmup_s, "captures": server.captures}
        if with_bank:
            rec["bank_bytes"] = sum(t.numel() * t.element_size() for sub in server.bank.values()
                                    if sub for ad in sub.values() for t in ad.values())
            hot_swap(server, args, rec)
        server.close()
        del server
    none, banked = rec["bank_none_8"], rec["bank_8"]
    log(f"bank on {details['card']}: frames/s without a bank {none['frames_per_s']}, with the "
        f"4-adapter bank {banked['frames_per_s']} (bank {rec['bank_bytes'] / 2**20:.1f} MiB); "
        f"peak {none['peak_allocated_gib']:.2f} / {banked['peak_allocated_gib']:.2f} GiB")

    server, warmup_s = make(True, weight_dtype="int4")
    r = window("bank_int4_8", server, warmup_s, spread(serve_requests(args, 16), names),
               needs=("decode_attention", "int4_matmul"))
    rec["bank_int4_8"] = {"frames_per_s": r["frames_per_s"],
                          "peak_allocated_gib": r["peak_allocated_gib"]}
    server.close()
    del server, params
    gc.collect()
    torch.cuda.empty_cache()
    details["bank_launches"] = total
    return total


def hot_swap(server, args, rec):
    """Hot adapter changes during traffic on the bf16 bank server, pipelined:
    8 streams (ids 0, 1, 3, 4) admitted and a chunk in flight, then the same
    again with ``qv_b`` (id 2, unused) removed and ``qv_c`` added into its
    id: no capture, and every stream's codes equal the run without the
    swap.  Removing ``qv_a`` (in use) raises.  Then ``wide`` (r=64 on q/v: a
    larger rank, a new id) retakes the captures at their next use; it
    serves a stream."""
    import numpy as np

    server.pipelined = True
    use = [None, "qv_a", "all7", "dec"]
    runs = []
    for swap in (False, True):
        server.reset(0)
        reqs = spread(serve_requests(args, 8, seed=7), use)
        for r in reqs:
            server.submit(r)
        done = server.step()  # a chunk in flight
        c0, s0 = server.captures, server.capture_s
        if swap:
            server.remove_adapter("qv_b")
            server.add_adapter("qv_c", (*random_adapter(args, 200, **BANK["qv_b"]), None))
            try:
                server.remove_adapter("qv_a")
            except ValueError as e:
                if "in use" not in str(e):
                    raise
            else:
                raise AssertionError("remove_adapter of an adapter in use did not raise")
        done += server.run([])[0]
        runs.append({r.request_id: r.frames for r in done})
        if swap and server.captures != c0:
            raise AssertionError(f"a same-shape swap took {server.captures - c0} captures")
    for rid, f in runs[0].items():
        if not np.array_equal(runs[1][rid], f):
            raise AssertionError(f"request {rid}'s codes changed under the in-place swap")
    c0, s0 = server.captures, server.capture_s
    wide = random_adapter(args, 201, r=64)
    server.add_adapter("wide", (*wide, None))
    server.reset(0)
    res, _ = server.run(spread(serve_requests(args, 8, seed=8), ["wide", None, "qv_c", "all7"]))
    if len(res) != 8 or not all(len(r.frames) for r in res):
        raise AssertionError("the bank after the reshape did not serve")
    rec["hot_swap"] = {"same_shape_captures": 0, "streams_equal": len(runs[0]),
                       "reshape_captures": server.captures - c0,
                       "reshape_capture_s": server.capture_s - s0,
                       "wide_rank_wqkv": int(server.bank["backbone"]["wqkv"]["a"].shape[-1])}
    log(f"  hot swap during traffic: remove + add of the same shape took 0 captures, the 8 "
        f"streams in flight kept their codes; removing an adapter in use raised; a rank-64 "
        f"adapter retook {rec['hot_swap']['reshape_captures']} captures in "
        f"{rec['hot_swap']['reshape_capture_s']:.2f} s and served")
    server.pipelined = False


# ---------------------------------------------------------------- phase 4d


# Shared prefix: a 300-frame voice preset (280 frames of context audio codes,
# then 20 of its transcript), bucket 512: its registration runs the flash
# kernel at S = T = 512.  Requests name it with 20 frames of their own text
# (bucket 64) or 200 (bucket 256: flash after the prefix).
PREFIX_T, PREFIX_AUDIO, PREFIX_OWN = 300, 280, (20, 20, 20, 20, 200, 200, 200, 200)
PREFIX_FRAMES, PREFIX_MAX_SEQ = 24, 1024
# Sliding window: prompts of 1020 frames (bucket 1024, flash at S = 1024), a
# 1280-column window (a 256-column ring) and the least re-anchor headroom the
# server takes, so the RoPE horizon is CSM-1B's 2048 and every stream
# re-anchors once, from position 2030 to 1288, in 1040 frames.
WINDOW, WINDOW_T, WINDOW_FRAMES = 1280, 1020, 1040
WINDOW_HEADROOM = 3 * SERVE_CHUNK + 4
WINDOW_RING_FRAMES = WINDOW - 1024  # frames a stream makes before its ring wraps


def prefix_context(args, seed=0):
    """The voice preset's (T, K+1) frames: context audio codes, then text."""
    import numpy as np

    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    tokens = np.zeros((PREFIX_T, K + 1), np.int32)
    mask = np.zeros((PREFIX_T, K + 1), bool)
    tokens[:PREFIX_AUDIO, :K] = rng.integers(1, args.audio_vocab_size - 3, (PREFIX_AUDIO, K))
    mask[:PREFIX_AUDIO, :K] = True
    tokens[PREFIX_AUDIO:, K] = rng.integers(1, args.text_vocab_size, PREFIX_T - PREFIX_AUDIO)
    mask[PREFIX_AUDIO:, K] = True
    return tokens, mask


def prefix_requests(args, ctx, inline, max_frames=PREFIX_FRAMES, seed=1):
    """The 8 requests of their own text, naming the prefix, or (``inline``)
    with the preset's frames before their own."""
    import numpy as np

    from csm_torch.serving import StreamRequest

    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    reqs = []
    for i, T in enumerate(PREFIX_OWN):
        tokens = np.zeros((T, K + 1), np.int32)
        mask = np.zeros((T, K + 1), bool)
        tokens[:, K] = rng.integers(1, args.text_vocab_size, T)
        mask[:, K] = True
        if inline:
            reqs.append(StreamRequest(np.concatenate([ctx[0], tokens]), np.concatenate([ctx[1], mask]),
                                      max_frames=max_frames, request_id=i))
        else:
            reqs.append(StreamRequest(tokens, mask, max_frames=max_frames, request_id=i,
                                      prefix="voice"))
    return reqs


def server_logits(server, reqs, rid, frame):
    """The logits (K, V) of request ``rid``'s frame ``frame`` (>= 1) on a
    synchronous ``server`` without a ramp: ``reqs`` admitted at once from
    ``reset(0)``, the chunks before the frame's replayed through the graphs,
    its chunk run without them and with ``csm.sample_topk`` recording."""
    import numpy as np
    import torch

    from csm_torch.models import csm

    server.reset(0)
    for r in reqs:
        server.submit(r)
    slot = next(s for s, r in enumerate(server.slot_request) if r is not None and r.request_id == rid)
    for _ in range((frame - 1) // server.chunk_size):
        server.step()
    live_idx = list(np.nonzero(server.active)[0])
    c = server._decode_capacity(len(live_idx))
    row = slot if c == server.n_slots else live_idx.index(slot)
    ds = server._decode_step(c)
    graph, ds.graph = ds.graph, None
    seen, sample = [], csm.sample_topk

    def recording(logits, *a, **kw):
        seen.append(logits.detach().float().clone())
        return sample(logits, *a, **kw)

    csm.sample_topk = recording
    try:
        server.step()
    finally:
        csm.sample_topk, ds.graph = sample, graph
    K = server.args.audio_num_codebooks
    j = (frame - 1) % server.chunk_size
    return torch.stack([seen[j * K + k][row] for k in range(K)])


def agree_with_server(name, got, want, server, reqs, details):
    """Streams ``got`` against ``want``, which ``server`` makes from
    ``reqs``: equal, or each first difference a tie of ``server``'s logits
    (margin under TIE_SHARE of their largest magnitude); held."""
    import numpy as np

    ties, agree = [], []
    for rid, w in want.items():
        g = got[rid]
        n = min(len(g), len(w))
        diff = np.nonzero((g[:n] != w[:n]).any(axis=1))[0]
        if not len(diff):
            if len(g) != len(w):
                raise AssertionError(f"{name}: request {rid}: {len(g)} frames against {len(w)}")
            agree.append(n)
            continue
        f = int(diff[0])
        k = int(np.nonzero(g[f] != w[f])[0][0])
        agree.append(f)
        if f == 0:
            raise AssertionError(f"{name}: request {rid} differs in frame 0, which both runs "
                                 f"prefill alike")
        L = server_logits(server, reqs, rid, f)[k]
        margin = float(L[int(w[f, k])] - L[int(g[f, k])])
        ties.append({"request": rid, "frame": f, "codebook": k, "margin": margin,
                     "margin_share_of_max": margin / float(L.abs().max())})
    details.setdefault("serving_server_agreement", {})[name] = {"leading_frames_equal": agree,
                                                                "ties": ties}
    log(f"{name}: leading frames equal {agree}; ties {ties}")
    wide = [t for t in ties if t["margin_share_of_max"] > TIE_SHARE]
    if wide:
        raise AssertionError(f"{name}: streams part where the logits are not tied: {wide}")


def window_requests(args, n, max_frames=WINDOW_FRAMES, seed=6):
    return serve_requests(args, n, T=WINDOW_T, max_frames=max_frames, seed=seed)


def reanchor_log(server):
    """Wrap ``server._reanchor`` to record each row's re-anchor: (row,
    delta, ms), the device work included."""
    import torch

    rows, real = [], server._reanchor

    def timed(row, delta):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real(row, delta)
        torch.cuda.synchronize()
        rows.append((row, delta, 1e3 * (time.perf_counter() - t0)))

    server._reanchor = timed
    return rows


def prefix_float32(params, args, details):
    """The prefix witness in float32 (TF32 off), topk=1: 8 requests naming
    a 300-frame prefix, served together, each against its request with the
    context inlined, generated alone."""
    from csm_torch.serving import BatchedServer

    ctx = prefix_context(args)
    server = BatchedServer(params, args, n_slots=8, max_seq_len=PREFIX_MAX_SEQ, temperature=0.9,
                           topk=1, chunk_size=SERVE_CHUNK, compute_dtype=params["codebook0_head"].dtype)
    server.register_prefix("voice", *ctx)
    results, _ = server.run(prefix_requests(args, ctx, inline=False))
    if set(server._prefix_prefills) != {(512, 64), (512, 256)}:
        raise AssertionError(f"prefix admissions {set(server._prefix_prefills)}")
    server.close()
    agree_with_single_stream("prefix_float32", {r.request_id: r.frames for r in results},
                             {r.request_id: (r.tokens, r.mask)
                              for r in prefix_requests(args, ctx, inline=True)},
                             params, args, params["codebook0_head"].dtype, PREFIX_FRAMES, details,
                             hold=True)


def prefix_bf16(params, args, details, total):
    """bf16 at 8 slots: a registration's ms (its first, with the capture, and
    again); each admission's ms with the prefix and with the context inlined
    (host time around a submit, device work included); then the 8 prefix
    requests served in one launch-count window, with their first frames."""
    import torch

    from csm_torch.serving import BatchedServer

    ctx = prefix_context(args)
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(params, args, n_slots=8, max_seq_len=PREFIX_MAX_SEQ, temperature=0.9,
                           topk=50, chunk_size=SERVE_CHUNK)
    reg_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.register_prefix("voice", *ctx)
        torch.cuda.synchronize()
        reg_ms.append(1e3 * (time.perf_counter() - t0))
    warmup_s = server.warmup()
    own, inline = prefix_requests(args, ctx, inline=False), prefix_requests(args, ctx, inline=True)
    admit = {"prefix": [], "inline": []}
    for rep in range(2):  # the first pass captures the (512, 256) admission
        for kind, reqs in (("prefix", own), ("inline", inline)):
            for r in reqs:
                server.reset(0)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                server.submit(r)
                torch.cuda.synchronize()
                if rep:
                    admit[kind].append(1e3 * (time.perf_counter() - t0))
    by_id, stats, got = served("prefix_bf16_8", server, own, args, ("decode_attention",
                                                                    "flash_attention_fwd"))
    for k, v in got.items():
        total[k] += v
    rec = serve_record("prefix_bf16_8", server, by_id, stats, warmup_s, details,
                       register_ms=reg_ms, admission_ms_prefix=admit["prefix"],
                       admission_ms_inline=admit["inline"])
    rec["first_frame_after_admit_s"] = {rid: r["first_frame_s"] - r["admit_s"]
                                        for rid, r in stats["requests"].items()}
    server.close()


def window_float32(params, args, details):
    """The window witnesses in float32 (TF32 off), topk=1, 2 slots: the
    frames before the first wrap against single-stream generation of the
    same prompt; the stream across its re-anchor against the same windowed
    server with a headroom that never re-anchors."""
    from csm_torch.serving import BatchedServer

    dtype = params["codebook0_head"].dtype
    reqs = window_requests(args, 2)
    runs = {}
    for name, headroom in (("reanchored", WINDOW_HEADROOM), ("never", 1024)):
        server = BatchedServer(params, args, n_slots=2, max_seq_len=2048, temperature=0.9, topk=1,
                               chunk_size=SERVE_CHUNK, compute_dtype=dtype, window=WINDOW,
                               reanchor_headroom=headroom)
        rows = reanchor_log(server)
        results, _ = server.run(reqs)
        runs[name] = ({r.request_id: r.frames for r in results}, server, rows)
    (got, fast, rows), (want, slow, never) = runs["reanchored"], runs["never"]
    fast.close()
    if sorted({r for r, _, _ in rows}) != [0, 1] or never:
        raise AssertionError(f"window float32: re-anchors {rows} (each slot once), {never} (none)")
    agree_with_server("window_float32_across_reanchor", got, want, slow, reqs, details)
    slow.close()
    agree_with_single_stream("window_float32_before_wrap", got,
                             {r.request_id: (r.tokens, r.mask) for r in reqs},
                             params, args, dtype, WINDOW_RING_FRAMES, details, hold=True)
    details["window_float32_reanchors"] = rows


def window_bf16(params, args, details, total):
    """bf16 at 8 slots, 8 streams of 1040 frames over the 1280-column window
    in one launch-count window: frames/s, each re-anchor's ms, and the peak
    memory before the first wrap, before the first re-anchor and at the
    end; then int4 weights over 320 frames (past the first wrap)."""
    import torch

    from csm_torch.serving import BatchedServer

    for name, kw, frames in (("window_bf16_8", {}, WINDOW_FRAMES),
                             ("window_int4_8", dict(weight_dtype="int4"), 320)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        server = BatchedServer(params, args, n_slots=8, max_seq_len=2048, temperature=0.9, topk=50,
                               chunk_size=SERVE_CHUNK, window=WINDOW,
                               reanchor_headroom=WINDOW_HEADROOM, **kw)
        warmup_s = server.warmup()
        rows = reanchor_log(server)
        peaks, real_step = [], server.step

        def step():
            done = real_step()
            peaks.append((int(server._pos_host.max()), torch.cuda.max_memory_allocated()))
            return done

        server.step = step
        needs = ("decode_attention", "flash_attention_fwd") + (("int4_matmul",) if kw else ())
        by_id, stats, got = served(name, server, window_requests(args, 8, frames), args, needs)
        for k, v in got.items():
            total[k] += v
        # the steps before the rings start to wrap, and before the first re-anchor
        wrap = next((i for i, (p, _) in enumerate(peaks) if p > WINDOW_T + WINDOW_RING_FRAMES),
                    len(peaks))
        re = next((i for i, (p, _) in enumerate(peaks) if p >= server._reanchor_at), len(peaks))
        memory = {"before_wrap": max(m for _, m in peaks[: max(wrap, 1)]),
                  "before_reanchor": max(m for _, m in peaks[: max(re, 1)]),
                  "end": peaks[-1][1]}
        serve_record(name, server, by_id, stats, warmup_s, details,
                     reanchors=len(rows), reanchor_ms=[ms for _, _, ms in rows],
                     peak_allocated_bytes=memory)
        if name == "window_bf16_8" and sorted({r for r, _, _ in rows}) != list(range(8)):
            raise AssertionError(f"{name}: re-anchored rows {rows}")
        server.close()


def lazy_capture(params, args, details):
    """A capacity captured for the first time while windowed rows are live
    (float32, TF32 off, topk=1): one stream decodes 24 frames, three more
    join and the full batch of 4 is captured then; every stream's codes
    equal a run whose capacities ``warmup`` captured before any traffic."""
    import numpy as np

    from csm_torch.serving import BatchedServer

    runs = {}
    for warm in (False, True):
        server = BatchedServer(params, args, n_slots=4, max_seq_len=256, temperature=0.9, topk=1,
                               chunk_size=SERVE_CHUNK, compute_dtype=params["codebook0_head"].dtype,
                               window=256)
        if warm:
            server.warmup()
        server.reset(0)
        first, *later = serve_requests(args, 4, max_frames=64, seed=7)
        server.submit(first)
        done = []
        for _ in range(3):
            done += server.step()
        if not warm and 4 in server._decodes:
            raise AssertionError("lazy capture: the full batch was captured before traffic")
        for r in later:
            server.submit(r)
        done += server.run([])[0]
        if 4 not in server._decodes or server._decodes[4].graph is None:
            raise AssertionError("lazy capture: the full batch ran without its graph")
        runs[warm] = {r.request_id: r.frames for r in done}
        server.close()
    same = [rid for rid in runs[True] if np.array_equal(runs[True][rid], runs[False][rid])]
    details["lazy_capture_streams_equal"] = len(same)
    log(f"lazy capture: {len(same)} of 4 windowed streams equal a warmed server's")
    if len(same) != 4:
        raise AssertionError("lazy capture: a capture mid-traffic changed live streams' codes")


def write_preset(d):
    """A voice preset for the daemons: 2 s of speech-band audio and its
    transcript, in a directory of the caller's."""
    from csm_torch.data.audio import save_wav

    wav = Path(d) / "preset.wav"
    save_wav(str(wav), speech_band(2.0), 24_000)
    preset = Path(d) / "preset.json"
    preset.write_text(json.dumps({"context": [{"audio": str(wav), "text": "A preset voice.",
                                               "speaker": 1}]}))
    return str(preset)


def serve_cmd(*argv):
    return [sys.executable, "-m", "csm_torch.cli.serve", "--n-slots", "8", "--allow-byte-tokenizer",
            *argv]


def daemons(details, meanwhile=None):
    """``csm-torch-serve`` at CSM-1B width (random weights) as two
    subprocesses started together.  ``meanwhile(idle)`` runs in this
    process while they start; ``idle()`` waits until both are up and idle
    (``--http`` serving, ``--follow`` past its model load with nothing fed
    yet), so that work timed after it shares the card with neither; the
    daemons get their first request after ``meanwhile`` returns.
    ``--http 127.0.0.1:0 --warmup`` with a
    preset and a LoRA adapter (``--adapter spk=DIR``), answering 8
    concurrent POST /generate (4 naming the preset), each a watermarked wav
    of its 20 frames, then POST /adapters loading a second adapter, one POST
    /generate under each adapter, GET /health (both adapters listed), POST
    /adapters unloading the second and POST /shutdown (exit 0); and
    ``--follow`` fed JSONL over a pipe in two writes, each wav written as
    its request ends, exit 0 at EOF."""
    import io
    import os
    import re
    import tempfile
    import threading
    import urllib.request
    import wave

    from csm_torch import csm_1b_args
    from csm_torch.training import lora as lora_mod

    frames = 20
    with tempfile.TemporaryDirectory() as d:
        preset = write_preset(d)
        args = csm_1b_args()
        spk = [lora_mod.save_lora(str(Path(d) / f"spk{i}"), *random_adapter(args, 300 + i, r=8),
                                  args) for i in range(2)]
        t0 = time.perf_counter()
        http = subprocess.Popen(serve_cmd("--http", "127.0.0.1:0", "--warmup", "--max-seq-len", "512",
                                          "--prefix", f"voice={preset}", "--adapter",
                                          f"spk={spk[0]}"),
                                cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        follow = subprocess.Popen(serve_cmd("--requests", "-", "--follow", "--output-dir", d,
                                            "--max-seq-len", "256", "--no-watermark"),
                                  cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=dict(os.environ, PYTHONUNBUFFERED="1"))
        try:
            out, follow_out0, port = [], [], {}

            def read(proc, lines, pattern, key):
                for line in proc.stdout:
                    lines.append(line)
                    m = re.search(pattern, line)
                    if m:
                        port[key], port[key + "_s"] = m.group(1), time.perf_counter() - t0
                        return

            readers = [threading.Thread(target=read, daemon=True, args=a) for a in (
                (http, out, r"Serving on http://127\.0\.0\.1:(\d+)", "http"),
                (follow, follow_out0, r"(Model ready)", "follow"))]
            for r in readers:
                r.start()

            def idle():
                if "idle_at_s" in port:
                    return
                t_wait = time.perf_counter()
                for r in readers:
                    r.join(timeout=300)
                if "http" not in port or "follow" not in port:
                    raise AssertionError("daemon: not up:\n" + "".join(out + follow_out0))
                port["idle_at_s"] = time.perf_counter() - t0
                port["waited_s"] = time.perf_counter() - t_wait

            if meanwhile is not None:
                meanwhile(idle)
            idle()
            up_s = port["http_s"]
            lines = [json.dumps({"id": f"f{i}", "text": f"Line {i} from the pipe.",
                                 "max_audio_length_ms": 80 * (10 + i)}) for i in range(8)]
            follow.stdin.write("\n".join(lines[:4]) + "\n")
            follow.stdin.flush()
            base = f"http://127.0.0.1:{port['http']}"
            answers = {}

            def post(i, adapter=None):
                body = {"text": f"Request {i} to the card.", "max_audio_length_ms": 80 * frames}
                if i % 2:
                    body["prefix"] = "voice"
                if adapter is not None:
                    body["adapter"] = adapter
                req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=300) as r:
                    answers[i] = (r.status, r.headers["Content-Type"], int(r.headers["X-Frames"]),
                                  r.read())

            t1 = time.perf_counter()
            posts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
            for t in posts:
                t.start()
            for t in posts:
                t.join(timeout=300)
            answer_s = time.perf_counter() - t1
            for i in range(8):
                status, ctype, n, wav = answers.get(i, (None,) * 4)
                if (status, ctype, n) != (200, "audio/wav", frames):
                    raise AssertionError(f"daemon: POST {i} answered {status} {ctype} {n} frames")
                with wave.open(io.BytesIO(wav)) as w:
                    if w.getframerate() != 24_000 or round(w.getnframes() / 1920) != frames:
                        raise AssertionError(f"daemon: POST {i} gave {w.getnframes()} samples")
            def adapters(body):
                req = urllib.request.Request(base + "/adapters", data=json.dumps(body).encode())
                with urllib.request.urlopen(req, timeout=300) as r:
                    return json.loads(r.read())

            loaded = adapters({"name": "spk2", "path": spk[1]})
            if loaded != {"status": "loaded", "name": "spk2", "id": 2}:
                raise AssertionError(f"daemon: POST /adapters answered {loaded}")
            for i, name in ((8, "spk"), (10, "spk2")):
                post(i, name)
                if answers[i][:3] != (200, "audio/wav", frames):
                    raise AssertionError(f"daemon: POST under adapter {name} answered "
                                         f"{answers[i][:3]}")
            health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
            if (health["served"] != 10 or health["prefixes"] != ["voice"]
                    or health["adapters"] != ["spk", "spk2"]):
                raise AssertionError(f"daemon: health {health}")
            unloaded = adapters({"name": "spk2", "unload": True})
            if unloaded != {"status": "unloaded", "name": "spk2"}:
                raise AssertionError(f"daemon: POST /adapters unload answered {unloaded}")
            urllib.request.urlopen(urllib.request.Request(base + "/shutdown", data=b""), timeout=60)
            http_out = "".join(out) + http.communicate(timeout=300)[0]
            follow.stdin.write("\n".join(lines[4:]) + "\n")
            follow_out = "".join(follow_out0) + follow.communicate(timeout=300)[0]
        finally:
            for p in (http, follow):
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if http.returncode != 0 or "HTTP served 10 requests" not in http_out:
            raise AssertionError(f"daemon: --http exited {http.returncode}:\n{http_out}")
        if follow.returncode != 0 or "Served 8 requests" not in follow_out:
            raise AssertionError(f"daemon: --follow exited {follow.returncode}:\n{follow_out}")
        from csm_torch.data.audio import load_wav

        for i in range(8):
            audio, sr = load_wav(str(Path(d) / f"f{i}.wav"))
            if sr != 24_000 or len(audio) != (10 + i) * 1920:
                raise AssertionError(f"daemon: --follow wrote {len(audio)} samples for f{i}")
    details["daemons"] = {"http_up_s": up_s, "follow_ready_s": port["follow_s"],
                          "idle_at_s": port["idle_at_s"], "waited_s": port["waited_s"],
                          "http_answer_8_s": answer_s, "health": health}
    log(f"daemons: --follow ready in {port['follow_s']:.1f} s, both idle at "
        f"{port['idle_at_s']:.1f} s (waited {port['waited_s']:.1f} s before the timed windows); "
        f"--http --adapter up (weights, warmup, captures) in {up_s:.1f} s, 8 concurrent "
        f"POSTs answered in {answer_s:.2f} s, POST /adapters loaded and unloaded a second "
        f"adapter, a POST under each adapter answered, /health {health}; --follow wrote 8 wavs, "
        f"both exited 0")


def phase_prefix_window(details):
    """Shared-prefix and sliding-window serving at CSM-1B width on random
    weights from seed 0, and the two daemons.  Float32 witnesses (TF32 off,
    topk=1) for the prefix, the window before its first wrap, the re-anchor
    and a capture mid-traffic; bf16 runs at 8 slots, each in a launch-count
    window held to what its steps, admissions and registrations launch.
    Returns the launches summed over those windows."""
    import gc

    import torch

    from csm_torch import csm_1b_args
    from csm_torch.utils.params import cast_params, random_csm_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = dict.fromkeys(read_counts(), 0)
    args = csm_1b_args()
    params = random_csm_params(args, seed=0, device="cuda")
    t = {}
    t0 = time.perf_counter()

    def serving_runs(idle):  # while the daemons start: their start-up overlaps only the
        nonlocal params  # float32 witnesses, which are not timed
        prefix_float32(params, args, details)
        t["prefix_float32"] = time.perf_counter() - t0
        window_float32(params, args, details)
        t["window_float32"] = time.perf_counter() - t0 - sum(t.values())
        lazy_capture(params, args, details)
        t["lazy_capture"] = time.perf_counter() - t0 - sum(t.values())
        params = cast_params(params, torch.bfloat16)
        gc.collect()
        torch.cuda.empty_cache()
        t["cast"] = time.perf_counter() - t0 - sum(t.values())
        idle()  # both daemons up and idle before the first timed window
        t["daemons_idle_wait"] = time.perf_counter() - t0 - sum(t.values())
        prefix_bf16(params, args, details, total)
        t["prefix_bf16"] = time.perf_counter() - t0 - sum(t.values())
        window_bf16(params, args, details, total)
        t["window_bf16"] = time.perf_counter() - t0 - sum(t.values())
        del params
        gc.collect()
        torch.cuda.empty_cache()

    daemons(details, meanwhile=serving_runs)
    t["daemons"] = time.perf_counter() - t0 - sum(t.values())
    details["prefix_window_s"] = t
    details["prefix_window_launches"] = total
    log(f"prefix and window launches over the windows: {total}; seconds {t}")
    return total


# ---------------------------------------------------------------- phase 4e


# generate_streaming's chunk sizes (frames), the streams' budget (50 frames),
# and the codec step's chunk lengths that are timed
STREAM_CHUNK_FRAMES = (2, 6, 13)
STREAM_MS = 4000
CODEC_TC = (1, 2, 8, 13)
# streamed against whole-clip audio in float32 (TF32 off): the codec's float
# sums in other orders, the CPU tests' 1e-4 of the largest magnitude
STREAM_AUDIO_SHARE = 1e-4


def stream_once(gen, chunk_frames, args, kv_int8, hold=True, topk=50, text=SHORT_TEXT,
                ms=STREAM_MS):
    """One ``generate_streaming`` call in a launch-count window: the host
    time of each chunk's arrival from the call (the first is first audio:
    prompt, submit, prefill, the first chunk's steps and one codec step),
    whether each chunk arrives before the audio before it has played (from
    the first arrival on), and (``hold``) the launches held to what the
    one-slot server's steps and prefills must launch (the codec launches
    none of the port's kernels; a call that captures a graph also ran its
    eager warm-up pass, so the first call on a key is not held).  Returns
    (record, chunks)."""
    import numpy as np

    server = gen._streaming_server(chunk_frames, topk, None)
    steps0, pre0 = dict(server.step_calls), dict(server.prefill_calls)
    reset_counts()  # the window opens
    t0 = time.perf_counter()
    chunks, arrivals = [], []
    for chunk, _ in gen.generate_streaming(text, max_audio_length_ms=ms, topk=topk,
                                           chunk_frames=chunk_frames):
        arrivals.append(time.perf_counter() - t0)
        chunks.append(chunk)
    wall = time.perf_counter() - t0
    got = read_counts()  # the window closes
    steps = {c: n - steps0.get(c, 0) for c, n in server.step_calls.items()}
    pre = {b: n - pre0.get(b, 0) for b, n in server.prefill_calls.items()}
    want = serving_expected(args, steps, pre, kv_int8, int4=False)
    needs = ("decode_attention", "decode_attention_int8") if kv_int8 else ("decode_attention",)
    if hold and (got != want or not all(got[k] for k in needs)):
        raise AssertionError(f"stream chunk {chunk_frames}: launches {got}, the steps {steps} and "
                             f"prefills {pre} need {want}")
    for c in chunks:
        if c.dtype != np.float32 or c.ndim != 1 or len(c) % 1920 or not np.isfinite(c).all():
            raise AssertionError(f"stream chunk {chunk_frames}: a chunk of {c.shape} {c.dtype}")
    played, late = 0.0, []
    for i in range(1, len(chunks)):
        played += len(chunks[i - 1]) / 24_000
        if len(chunks[i]) and arrivals[i] > arrivals[0] + played:
            late.append(i)
    frames = sum(len(c) for c in chunks) // 1920
    if not 0 < frames <= ms // 80:
        raise AssertionError(f"stream chunk {chunk_frames}: {frames} frames")
    return {"first_audio_s": arrivals[0], "arrivals_s": arrivals, "frames": frames,
            "chunk_frames_out": [len(c) // 1920 for c in chunks], "wall_s": wall,
            "late_chunks": late, "launches": got}, chunks


def codec_step_ms(gen, details):
    """``MimiStreamDecoder`` at Tc = 1, 2, 8 and 13 frames: the host ms of
    ``decode_chunk`` (its samples on the host, the work ends in the copy),
    and CUDA events around ``decode_chunk_async`` (the device's span,
    launch gaps included); medians of 10 after 3 warm-up calls, beside the
    chunk's audio."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    dec = gen.mimi.stream_decoder()
    rec = {}
    for tc in CODEC_TC:
        codes = rng.integers(0, 2048, (gen.args.audio_num_codebooks, tc))
        for _ in range(3):
            dec.decode_chunk(codes)
        host, span = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            t = time.perf_counter()
            dec.decode_chunk(codes)
            host.append(1e3 * (time.perf_counter() - t))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dec.decode_chunk_async(codes)
            end.record()
            torch.cuda.synchronize()
            span.append(start.elapsed_time(end))
        rec[tc] = {"host_ms": statistics.median(host), "event_ms": statistics.median(span),
                   "audio_ms": 80.0 * tc}
        log(f"codec step, {tc} frames ({80 * tc} ms of audio) on {details['card']}: decode_chunk "
            f"{rec[tc]['host_ms']:.3f} ms on the host, {rec[tc]['event_ms']:.3f} ms between events")
    return rec


def stream_vs_generate(details):
    """At topk=1 in float32 (TF32 off), CSM-1B width: the streamed chunks
    (chunk_frames 6) against ``generate``'s waveform.  Mimi is causal, so up
    to the first frame whose codes differ (two runs of other decode splits
    may part on a tie of logits) the samples must agree to
    STREAM_AUDIO_SHARE of the largest; the paths must agree on at least
    the first half of the frames; and the stream's samples equal the
    whole-clip decode of its own codes over every frame."""
    import numpy as np
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = load_csm(args=csm_1b_args(), compute_dtype=torch.float32, text_tokenizer=ByteTokenizer())
    rec = gen.mimi = Recording(gen.mimi)
    kw = dict(max_audio_length_ms=2000, topk=1)
    full = gen.generate(SHORT_TEXT, **kw)
    codes = rec.decoded[-1]
    chunks = [c for c, _ in gen.generate_streaming(SHORT_TEXT, chunk_frames=6, **kw)]
    audio = np.concatenate(chunks)
    n = len(audio) // 1920
    streamed = np.concatenate(rec.streamed, axis=1)[:, :n]
    gen.mimi = rec.inner
    own = gen.mimi.decode(streamed)
    scale = float(np.abs(own).max())
    own_err = float(np.abs(audio - own).max()) / scale
    if audio.shape != own.shape or not own_err <= STREAM_AUDIO_SHARE:
        raise AssertionError(f"stream: its samples against the whole-clip decode of its codes: "
                             f"{own_err:.3e} of the largest")
    same = 0
    while same < min(n, codes.shape[1]) and (streamed[:, same] == codes[:, same]).all():
        same += 1
    if same < codes.shape[1] // 2:
        raise AssertionError(f"stream: codes part from generate's at frame {same} of "
                             f"{codes.shape[1]}")
    err = float(np.abs(audio[: 1920 * same] - full[: 1920 * same]).max()) / scale
    if not err <= STREAM_AUDIO_SHARE:
        raise AssertionError(f"stream: {err:.3e} of the largest sample from generate's audio")
    out = {"frames": n, "generate_frames": int(codes.shape[1]), "frames_equal": same,
           "rel_err_vs_generate": err, "rel_err_vs_own_whole_clip": own_err,
           "tolerance_share": STREAM_AUDIO_SHARE}
    details["stream_vs_generate"] = out
    log(f"stream against generate, float32 topk=1, CSM-1B: codes equal over {same} of "
        f"{codes.shape[1]} frames ({n} streamed); audio within {err:.3e} of the largest sample "
        f"(tolerance {STREAM_AUDIO_SHARE}); against the whole-clip decode of its own codes "
        f"{own_err:.3e}")
    free(gen)


def stream_serving(params, args, mimi, n_slots, order, details, total):
    """``csm-torch-serve --stream``'s serving, in process: one server
    (phase 4c's protocol, ramp chunk 2 as ``--stream`` sets it, graphs
    captured by ``warmup``) runs the requests without sinks (``plain``) and
    with a ``_StreamSink`` a request (``stream``: each request's frames
    stream-decoded on the serving thread, its wav written when it ends), in
    the given order; launch counts held per run (``served``); per-stream
    first audio from the run's start and after admission."""
    import gc
    import tempfile

    import torch

    from csm_torch.cli.serve import _StreamSink
    from csm_torch.serving import BatchedServer

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    server = BatchedServer(params, args, n_slots=n_slots, max_seq_len=SERVE_MAX_SEQ,
                           temperature=0.9, topk=50, chunk_size=SERVE_CHUNK, ramp_chunk=2)
    warmup_s = server.warmup()
    reqs = serve_requests(args, 2 * n_slots)
    seen = {}
    for mode in order:
        name = f"stream_{mode}_{n_slots}" + ("_again" if mode in seen else "")
        seen[mode] = True
        with tempfile.TemporaryDirectory() as d:
            sinks = {}
            if mode == "stream":
                t_ref = time.perf_counter()
                for r in reqs:
                    r.on_frames = sinks[r.request_id] = _StreamSink(
                        mimi.stream_decoder(), SERVE_CHUNK, str(Path(d) / f"{r.request_id}.wav"),
                        24_000, t_ref)
            by_id, stats, got = served(name, server, reqs, args, ("decode_attention",))
            for r in reqs:
                r.on_frames = None
            extra = {}
            if sinks:
                first = sorted(sk.first_audio_s for sk in sinks.values())
                after = sorted(sk.first_audio_s - stats["requests"][rid]["admit_s"]
                               for rid, sk in sinks.items())
                written = sum(Path(sk.out_path).stat().st_size > 44 for sk in sinks.values())
                if written != len(reqs):
                    raise AssertionError(f"{name}: {written} of {len(reqs)} wavs written")
                extra = {"first_audio_s_median": statistics.median(first),
                         "first_audio_s_max": first[-1],
                         "first_audio_after_admit_s_median": statistics.median(after),
                         "first_audio_after_admit_s_max": after[-1]}
        for k, v in got.items():
            total[k] += v
        serve_record(name, server, by_id, stats, warmup_s, details, **extra)
    server.close()


def http_stream_start():
    """``csm-torch-serve --http 127.0.0.1:0 --warmup --stream`` at CSM-1B
    width (random weights, 8 slots), started; ``http_stream_posts`` talks to
    it."""
    return subprocess.Popen(serve_cmd("--http", "127.0.0.1:0", "--warmup", "--stream",
                                      "--max-seq-len", "256", "--no-watermark"),
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def http_stream_posts(proc, t_start, details, frames=20):
    """8 concurrent POST /generate to the ``--stream`` daemon, each read as
    it comes: the seconds from the POSTs' start to its first PCM byte and to
    its last; each answer is audio/L16 of its 20 frames; /health counts 8;
    /shutdown drains and the daemon exits 0."""
    import re
    import threading
    import urllib.request

    out, port = [], {}

    def read():
        for line in proc.stdout:
            out.append(line)
            m = re.search(r"Serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port["n"] = int(m.group(1))
                return

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    reader.join(timeout=300)
    if "n" not in port:
        raise AssertionError("--http --stream never served:\n" + "".join(out))
    up_s = time.perf_counter() - t_start
    base = f"http://127.0.0.1:{port['n']}"
    answers = {}
    t0 = time.perf_counter()

    def post(i):
        body = {"text": f"Request {i} to the card.", "max_audio_length_ms": 80 * frames}
        req = urllib.request.Request(base + "/generate", data=json.dumps(body).encode())
        with urllib.request.urlopen(req, timeout=300) as r:
            first = r.read(1)
            t_first = time.perf_counter() - t0
            rest = r.read()
            answers[i] = (r.status, r.headers["Content-Type"], first + rest, t_first,
                          time.perf_counter() - t0)

    posts = [threading.Thread(target=post, args=(i,)) for i in range(8)]
    for t in posts:
        t.start()
    for t in posts:
        t.join(timeout=300)
    for i in range(8):
        status, ctype, pcm, *_ = answers.get(i, (None,) * 5)
        if (status, ctype) != (200, "audio/L16;rate=24000;channels=1") or len(pcm) != 2 * 1920 * frames:
            raise AssertionError(f"--http --stream: POST {i} answered {status} {ctype}, "
                                 f"{None if pcm is None else len(pcm)} bytes")
    health = json.loads(urllib.request.urlopen(base + "/health", timeout=60).read())
    if health["served"] != 8:
        raise AssertionError(f"--http --stream: health {health}")
    urllib.request.urlopen(urllib.request.Request(base + "/shutdown", data=b""), timeout=60)
    log_out = "".join(out) + proc.communicate(timeout=300)[0]
    if proc.returncode != 0 or "HTTP served 8 requests" not in log_out:
        raise AssertionError(f"--http --stream exited {proc.returncode}:\n{log_out}")
    first = sorted(a[3] for a in answers.values())
    last = sorted(a[4] for a in answers.values())
    rec = {"up_s": up_s, "first_byte_s": first, "last_byte_s": last,
           "first_byte_s_median": statistics.median(first), "last_byte_s_max": last[-1]}
    details["http_stream"] = rec
    log(f"--http --stream: up in {up_s:.1f} s; 8 concurrent POSTs of {frames} frames: first PCM "
        f"byte after {first[0]:.3f}-{first[-1]:.3f} s (median {rec['first_byte_s_median']:.3f}), "
        f"last byte after {last[0]:.3f}-{last[-1]:.3f} s")


def phase_streaming(details):
    """Audio streaming at CSM-1B width on random weights: the ``--http
    --stream`` daemon started first (its load and warmup overlap the
    float32 check); the stream against ``generate`` in float32 at topk=1;
    the daemon's 8 concurrent POSTs; ``generate_streaming`` at chunk_frames
    2, 6 and 13 over a bf16 and an int8 KV cache on the same weights (a
    warm-up call per key, then a timed call in a launch-count window);
    the codec step's ms at Tc = 1, 2, 8, 13; then ``--stream`` serving at 8
    slots (plain, stream, stream, plain) and 64 (plain, stream).  Returns
    the launches summed over the windows."""
    import gc

    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.generator import Generator

    total = dict.fromkeys(read_counts(), 0)
    t = {}
    t0 = time.perf_counter()
    proc = http_stream_start()
    try:
        stream_vs_generate(details)
        t["stream_vs_generate"] = time.perf_counter() - t0
        http_stream_posts(proc, t0, details)
        t["http_stream"] = time.perf_counter() - t0 - sum(t.values())
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    args = csm_1b_args()
    tok = ByteTokenizer()
    gen = load_csm(args=args, text_tokenizer=tok)
    gen8 = Generator(gen.params, args, mimi=gen.mimi, text_tokenizer=tok, device="cuda",
                     kv_dtype=torch.int8)
    streams = details["streams"] = {}
    for cf in STREAM_CHUNK_FRAMES:
        for name, g in (("bf16", gen), ("int8", gen8)):
            stream_once(g, cf, args, name == "int8", hold=False)  # its server, captures
            rec, _ = stream_once(g, cf, args, name == "int8")
            for k, v in rec["launches"].items():
                total[k] += v
            streams[f"{name}_{cf}"] = rec
            log(f"generate_streaming, {name} KV, chunk_frames {cf}, on {details['card']}: first "
                f"audio {1e3 * rec['first_audio_s']:.1f} ms, {rec['frames']} frames in "
                f"{rec['wall_s']:.3f} s, arrivals (s) "
                + " ".join(f"{a:.3f}" for a in rec["arrivals_s"])
                + f"; chunks late for playback: {rec['late_chunks'] or 'none'}")
    t["generate_streaming"] = time.perf_counter() - t0 - sum(t.values())
    details["codec_step_ms"] = codec_step_ms(gen, details)
    t["codec"] = time.perf_counter() - t0 - sum(t.values())
    mimi, params = gen.mimi, gen.params
    free(gen8)
    free(gen)  # its graphs and streaming servers; the weights stay for serving
    stream_serving(params, args, mimi, 8, ("plain", "stream", "stream", "plain"), details, total)
    stream_serving(params, args, mimi, 64, ("plain", "stream"), details, total)
    t["stream_serving"] = time.perf_counter() - t0 - sum(t.values())
    del params
    gc.collect()
    torch.cuda.empty_cache()
    details["streaming_s"] = t
    details["streaming_launches"] = total
    log(f"streaming launches over the windows: {total}; seconds {t}")
    return total


# ---------------------------------------------------------------- phase 5


class Recording:
    """A codec that keeps the codes it decodes: whole clips in ``decoded``,
    its stream decoders' chunks in ``streamed``."""

    def __init__(self, inner):
        self.inner, self.decoded, self.streamed = inner, [], []

    def encode(self, audio):
        return self.inner.encode(audio)

    def decode(self, codes):
        self.decoded.append(codes.copy())
        return self.inner.decode(codes)

    def stream_decoder(self):
        dec, seen = self.inner.stream_decoder(), self.streamed

        class Stream:
            cfg = dec.cfg

            def decode_chunk(self, codes):
                seen.append(codes.copy())
                return dec.decode_chunk(codes)

        return Stream()


def phase_reference(details):
    """A tiny float32 CSM (2-layer Mimi) on the card and on the CPU from the
    same weights, float and then int4 (group 32): the card runs the
    kernels, the CPU their plain versions.  At topk=1 the codes are equal;
    audio agrees to 1e-4 (float32 with TF32 off on the card; measured
    differences are float32 rounding)."""
    import dataclasses

    import numpy as np
    import torch

    from csm_torch.codec.mimi import CSM_MIMI_CONFIG, mimi_init
    from csm_torch.codec.transformer import MimiTransformerConfig
    from csm_torch.data.tokenizers import ByteTokenizer, MimiAudioTokenizer
    from csm_torch.generator import Generator
    from csm_torch.models.config import tiny_test_args
    from csm_torch.ops import int4_matmul as i4
    from csm_torch.utils.params import random_csm_params, tree_map
    from csm_torch.utils.quantize import quantize_csm_params_int4

    # float32 on the card in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = tiny_test_args()
    cfg = dataclasses.replace(CSM_MIMI_CONFIG, transformer=MimiTransformerConfig(num_layers=2))
    params = random_csm_params(args, seed=0)
    mimi = mimi_init(torch.Generator().manual_seed(1), cfg)

    def to(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    for name, tree in (("reference", params),
                       ("reference_int4", quantize_csm_params_int4(params, group_size=32))):
        outs = {}
        for dev in ("cpu", "cuda"):
            g = Generator(to(tree, dev), args,
                          mimi=Recording(MimiAudioTokenizer(to(mimi, dev), cfg)),
                          text_tokenizer=ByteTokenizer(), compute_dtype=torch.float32, device=dev)
            texts = ["tiny reference", "and a second, longer reference line"]
            i4.launches = 0
            audio = g.generate_batch(texts, [0, 1], max_audio_length_ms=800, topk=1)
            outs[dev] = (audio, g.mimi.decoded, i4.launches)
        (a_cpu, c_cpu, _), (a_gpu, c_gpu, n_int4) = outs["cpu"], outs["cuda"]
        if (n_int4 > 0) != (name == "reference_int4"):
            raise AssertionError(f"{name}: {n_int4} int4 kernel launches on the card")
        for x, y in zip(c_cpu, c_gpu):
            np.testing.assert_array_equal(y, x)
        err = 0.0
        for x, y in zip(a_cpu, a_gpu):
            np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-3)
            err = max(err, float(np.abs(y - x).max()))
        details[name] = {"frames": [c.shape[1] for c in c_gpu], "audio_max_abs_err": err,
                         "int4_launches": n_int4}
        log(f"{name}: codes equal over {sum(c.shape[1] for c in c_gpu)} frames, "
            f"audio max |card - cpu| = {err:.2e}, int4 kernel launches on the card {n_int4}")


# ---------------------------------------------------------------- phase 6


def synthetic_examples(n, seconds, seed):
    """``n`` TrainingExamples of synthetic speech-band audio made with numpy
    from ``seed`` (tones plus noise) and short texts."""
    import numpy as np

    from csm_torch.data.processor import TrainingExample

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 24_000)) / 24_000
    out = []
    for i in range(n):
        audio = 0.3 * np.sin(2 * np.pi * (180 + 40 * i) * t) + 0.05 * rng.standard_normal(t.size)
        out.append(TrainingExample(f"Synthetic training utterance number {i}.",
                                   audio.astype(np.float32), i % 2))
    return out


def expected_train_launches(L: int, steps: int = 1, eval_steps: int = 0) -> dict:
    """Flash launches of remat training steps over an L-layer backbone at
    T >= 256: the forward once per layer and once more in the recompute,
    each backward kernel once per layer; an eval step, the forward once."""
    return {"flash_attention_fwd": 2 * L * steps + L * eval_steps,
            "flash_attention_bwd_dq": L * steps, "flash_attention_bwd_dkv": L * steps}


def check_launches(name, got, want):
    zero = {k: 0 for k in got}
    if got != {**zero, **want}:
        raise AssertionError(f"{name}: launches {got}, the path needs {want}")


def profile_step(trainer, generator, batch, details):
    """Kernel time of one training step by name, under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer._run_step(generator, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    flash = [e for e in kernels if any(n in e.key for n in ("flash", "dq_kernel", "dkv_kernel"))]
    details["train_1b_profile"] = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "top_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top],
        "flash_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in flash],
    }
    log(f"train_1b_profile: one step {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({len(kernels)} kinds)")
    for name, count, ms in details["train_1b_profile"]["top_kernels"]:
        log(f"  {ms:9.3f} ms {count:6d}x {name}")
    log("  the flash kernels of the step:")
    for name, count, ms in details["train_1b_profile"]["flash_kernels"]:
        log(f"  {ms:9.3f} ms {count:6d}x {name}")


def phase_training(details, dev):
    """CSM-1B training on the card: six steps on a repeated batch in the
    512 bucket through the trainer's own step call, one validate, a profiled
    step.  Returns the backward kernels' launches over the six steps (the
    forward kernel's row keeps the generation path's count)."""
    import gc
    import tempfile

    import torch

    from csm_torch import csm_1b_args
    from csm_torch.training.trainer import CSMTrainer, step_generator

    args = csm_1b_args()
    L = args.backbone.num_layers
    batches = train_batches(dev, args, details)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        trainer = CSMTrainer(args=args, output_dir=out, learning_rate=TRAIN_LR, device=dev)
        trainer.prepare_optimizer()
        torch.cuda.synchronize()
        details["train_init_s"] = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        batch, held_out = batches
        steps, total = [], dict.fromkeys(expected_train_launches(L), 0)
        for i in range(TRAIN_STEPS):
            gen = step_generator(dev, 0, i)
            torch.cuda.synchronize()
            reset_counts()  # the window opens
            t0 = time.perf_counter()
            metrics = trainer._run_step(gen, batch)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = read_counts()  # the window closes
            check_launches(f"train step {i}", got, expected_train_launches(L))
            for k in total:
                total[k] += got[k]
            m = {k: v.item() for k, v in metrics.items()}
            if not all(map(math.isfinite, m.values())):
                raise AssertionError(f"train step {i}: non-finite metrics {m}")
            steps.append(dict(m, ms=ms, frames_per_s=m["num_target_frames"] / (ms / 1e3)))
            log(f"train step {i}: loss {m['loss']:.4f} (semantic {m['semantic_loss']:.4f}, "
                f"acoustic {m['acoustic_loss']:.4f}), grad norm {m['grad_norm']:.3f}, "
                f"{ms:.1f} ms, {steps[-1]['frames_per_s']:.1f} trained frames/s")
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not steps[-1]["loss"] < steps[0]["loss"]:
            raise AssertionError(f"the loss did not fall on the repeated batch: "
                                 f"{[s['loss'] for s in steps]}")
        reset_counts()
        val = trainer.validate([held_out])
        got = read_counts()
        check_launches("validate", got, expected_train_launches(L, steps=0, eval_steps=1))
        if not math.isfinite(val):
            raise AssertionError(f"validation loss {val}")
        profile_step(trainer, step_generator(dev, 0, TRAIN_STEPS), batch, details)
        tail = steps[1:]  # the first step pays for cuBLAS and allocator set-up
        details["train_1b"] = {
            "steps": steps, "validation_loss": val, "peak_memory_gib": peak,
            "ms_per_step_median": statistics.median(s["ms"] for s in tail),
            "frames_per_s_median": statistics.median(s["frames_per_s"] for s in tail),
            "launches": total, "learning_rate": TRAIN_LR,
        }
        log(f"train_1b on {details['card']}: {TRAIN_STEPS} steps, median "
            f"{details['train_1b']['ms_per_step_median']:.1f} ms/step, "
            f"{details['train_1b']['frames_per_s_median']:.1f} trained frames/s, peak "
            f"{peak:.2f} GiB, loss {steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f}, "
            f"validation {val:.4f}, launches {total}")
        trainer.close()
        del trainer, batches, batch, held_out
    gc.collect()
    torch.cuda.empty_cache()
    return {k: total[k] for k in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")}


# ---------------------------------------------------------------- phase 6b


# LoRA runs of phase 6b: r=8 on q/v (the defaults), r=16 on all seven
# projections, and the q/v run over an int8 and over an int4 base; each base
# is bf16 (a frozen base keeps no float32 master copy)
LORA_RUNS = (("lora_qv_r8", {}), ("lora_all7_r16", dict(lora_r=16, target_modules=ALL7)),
             ("qlora_int8_qv_r8", dict(quant_base="int8")),
             ("qlora_int4_qv_r8", dict(quant_base="int4")))
LORA_LR = 1e-3


def train_batches(dev, args, details):
    """Phase 6's two (2, 512) batches: synthetic speech through a random Mimi."""
    import torch

    from csm_torch.codec.mimi import CSM_MIMI_CONFIG, mimi_init
    from csm_torch.data.dataset import CSMDataset, batch_iterator
    from csm_torch.data.tokenizers import ByteTokenizer, MimiAudioTokenizer

    mimi = MimiAudioTokenizer(mimi_init(torch.Generator(device=dev).manual_seed(1),
                                        CSM_MIMI_CONFIG, device=dev))
    t0 = time.perf_counter()
    ds = CSMDataset(synthetic_examples(4, 28.0, seed=0), ByteTokenizer(), mimi, args=args)
    batches = list(batch_iterator(ds, 2, shuffle=False))
    details["train_data_s"] = time.perf_counter() - t0
    if [b.tokens.shape[:2] for b in batches] != [(2, 512)] * 2:
        raise AssertionError(f"batches {[tuple(b.tokens.shape) for b in batches]}: not (2, 512)")
    return batches


def expected_lora_launches(args, quant, steps=1, eval_steps=0) -> dict:
    """``expected_train_launches`` of the backbone, and over an int4 base
    the dequant route of every projection call: B·T and the decoder's
    n_sub·K rows are over MAX_KERNEL_ROWS; remat runs each layer's forward
    twice in a step."""
    L_bb, L_dec = args.backbone.num_layers, args.decoder.num_layers
    want = expected_train_launches(L_bb, steps, eval_steps)
    if quant == "int4":
        want["int4_dequant_route"] = 7 * (L_bb + L_dec) * (2 * steps + eval_steps)
    return want


def phase_lora_training(details, dev):
    """LoRA training at CSM-1B width on phase 6's setup (B=2 in the 512
    bucket, bf16 compute, remat, six steps on the repeated batch and a
    validate): r=8 on q/v, r=16 on all seven projections, then q/v over an
    int8 and over an int4 base, each through ``CSMLoRATrainer``'s own step
    call.  Every step's flash launches are held (32 forward, 16 of each
    backward kernel: the gradient flows through every frozen layer's
    attention), the loss falls, the base is bit-unchanged.  ms per step,
    trained frames/s, peak allocated memory over the steps, trainable
    parameters; the full fine-tune's phase 6 figures beside.  Then one
    float32 LoRA step of a tiny model on the card against the CPU.  Returns
    the launches summed over the runs."""
    import gc
    import tempfile

    import torch

    from csm_torch import csm_1b_args
    from csm_torch.training import lora as lora_mod
    from csm_torch.training.trainer import CSMLoRATrainer, step_generator

    args = csm_1b_args()
    batch, held_out = train_batches(dev, args, details)
    runs, total = {}, dict.fromkeys(read_counts(), 0)
    for name, kw in LORA_RUNS:
        quant = kw.get("quant_base")
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as out:
            tr = CSMLoRATrainer(args=args, output_dir=out, learning_rate=LORA_LR, device=dev,
                                param_dtype=torch.bfloat16, **kw)
            tr.prepare_optimizer()
            probe = tr.params["backbone"]["wq"]
            probe = probe["w8"] if quant == "int8" else probe["w4p"] if quant else probe
            probe0 = probe.clone()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            steps = []
            for i in range(TRAIN_STEPS):
                gen = step_generator(dev, 0, i)
                torch.cuda.synchronize()
                reset_counts()  # the window opens
                t0 = time.perf_counter()
                metrics = tr._run_step(gen, batch)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                got = read_counts()  # the window closes
                check_launches(f"{name} step {i}", got, expected_lora_launches(args, quant))
                for k in total:
                    total[k] += got[k]
                m = {k: v.item() for k, v in metrics.items()}
                if not all(map(math.isfinite, m.values())):
                    raise AssertionError(f"{name} step {i}: non-finite metrics {m}")
                steps.append(dict(m, ms=ms, frames_per_s=m["num_target_frames"] / (ms / 1e3)))
            peak = torch.cuda.max_memory_allocated() / 2**30
            if not steps[-1]["loss"] < steps[0]["loss"]:
                raise AssertionError(f"{name}: the loss did not fall on the repeated batch: "
                                     f"{[s['loss'] for s in steps]}")
            if not torch.equal(probe, probe0):
                raise AssertionError(f"{name}: the frozen base moved")
            reset_counts()
            val = tr.validate([held_out])
            check_launches(f"{name} validate", read_counts(),
                           expected_lora_launches(args, quant, steps=0, eval_steps=1))
            tail = steps[1:]
            runs[name] = {
                "steps": steps, "validation_loss": val, "peak_memory_gib": peak,
                "trainable_params": lora_mod.count_params(tr.state.params),
                "base_params": lora_mod.count_params(tr.params),
                "ms_per_step_median": statistics.median(s["ms"] for s in tail),
                "frames_per_s_median": statistics.median(s["frames_per_s"] for s in tail),
                "launches_per_step": expected_lora_launches(args, quant)}
            r = runs[name]
            log(f"{name} on {details['card']}: {TRAIN_STEPS} steps, median "
                f"{r['ms_per_step_median']:.1f} ms/step, {r['frames_per_s_median']:.1f} trained "
                f"frames/s, peak {peak:.2f} GiB allocated, {r['trainable_params']:,} trainable "
                f"parameters, loss {steps[0]['loss']:.4f} -> {steps[-1]['loss']:.4f}, validation "
                f"{val:.4f}, launches a step {r['launches_per_step']}")
            tr.close()
            del tr, probe, probe0
    full = details.get("train_1b", {})
    log(f"  beside them, the full fine-tune of phase 6: "
        f"{full.get('ms_per_step_median', float('nan')):.1f} ms/step, "
        f"{full.get('frames_per_s_median', float('nan')):.1f} trained frames/s, peak "
        f"{full.get('peak_memory_gib', float('nan')):.2f} GiB")
    base_peak = runs["lora_qv_r8"]["peak_memory_gib"]
    for name in ("qlora_int8_qv_r8", "qlora_int4_qv_r8"):
        if not runs[name]["peak_memory_gib"] < base_peak:
            raise AssertionError(f"{name} peaks at {runs[name]['peak_memory_gib']:.3f} GiB, not "
                                 f"under the bf16 base's {base_peak:.3f}")
    details["lora_train_1b"] = runs
    lora_train_reference(details, dev)
    gc.collect()
    torch.cuda.empty_cache()
    return total


def lora_train_reference(details, dev):
    """One float32 LoRA step of a tiny model at T=256 (r=4 on all seven
    projections, dropout 0) on the card and on the CPU from the same
    weights, adapters, batch and frame scores: the card runs the flash
    kernels forward and backward through the frozen layers, the CPU their
    plain versions.  The loss and the adapter gradients agree as phase 8's
    do; the optimizer update leaves finite adapters."""
    import dataclasses

    import numpy as np
    import torch

    from csm_torch.models.config import tiny_test_args
    from csm_torch.training import lora as lora_mod
    from csm_torch.training.losses import Batch, compute_loss
    from csm_torch.training.optimizer import global_norm, make_lora_optimizer, named_leaves
    from csm_torch.training.train_step import _accumulated_grads
    from csm_torch.utils.params import random_csm_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = tiny_test_args()
    args = dataclasses.replace(args, backbone_config=dataclasses.replace(
        args.backbone_config, max_seq_len=512))
    B, T, K = 2, 256, args.audio_num_codebooks
    rng = np.random.default_rng(1)
    tokens = np.zeros((B, T, K + 1), np.int32)
    mask = np.zeros((B, T, K + 1), bool)
    tokens[:, :40, K] = rng.integers(1, args.text_vocab_size, (B, 40))
    mask[:, :40, K] = True
    audio = rng.integers(0, args.audio_vocab_size, (B, T - 40, K))
    tokens[:, 40:, :K], mask[:, 40:, :K] = audio, True
    targets = np.zeros((B, T, K), np.int32)
    targets[:, 39 : T - 1] = audio
    tmask = np.zeros((B, T), bool)
    tmask[:, 39 : T - 1] = True
    batch = Batch(*map(torch.from_numpy, (tokens, mask, targets, tmask)))
    scores = torch.from_numpy(rng.random(B * T).astype(np.float32))
    base0 = random_csm_params(args, seed=0)
    lcfg = lora_mod.LoRAConfig(r=4, target_modules=ALL7)
    gen = torch.Generator().manual_seed(2)
    lora0 = lora_mod.init_lora_params(gen, args, lcfg)
    for comp in lora0.values():
        for ad in comp.values():
            ad["b"].normal_(0.0, 0.05, generator=gen)
    res = {}
    for where in ("cpu", dev):
        base = tree_map(lambda t: t.clone().to(where), base0)
        lora = tree_map(lambda t: t.clone().to(where), lora0)

        def loss_fn(lo, g, b, s, base=base):
            return compute_loss(base, args, g, b, compute_dtype=torch.float32, remat=True,
                                lora=lo, lora_scale=lcfg.scaling, frame_scores=s)

        reset_counts()
        metrics, grads = _accumulated_grads(loss_fn, lora, None, batch.to(where), 1,
                                            [scores.to(where)])
        raw = [g.to("cpu", copy=True) for g in grads]
        tx = make_lora_optimizer(learning_rate=1e-3)
        tx.update(lora, grads, tx.init(lora))
        torch.cuda.synchronize()
        res[str(where)] = (metrics["loss"].item(), raw, read_counts(),
                           [t.detach().cpu() for _, t in named_leaves(lora)])
        if any(t.grad is not None or t.requires_grad for _, t in named_leaves(base)):
            raise AssertionError("card-vs-CPU LoRA step: the base took a gradient")
    (l_cpu, g_cpu, _, _), (l_gpu, g_gpu, counts, p_gpu) = res["cpu"], res[str(dev)]
    check_launches("card-vs-CPU LoRA step", counts, expected_train_launches(2))
    norm = global_norm(g_cpu).item()
    err = max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu))
    if abs(l_gpu - l_cpu) > REF_LOSS_RTOL * abs(l_cpu) or err > REF_GRAD_SHARE * norm:
        raise AssertionError(f"card-vs-CPU LoRA step: loss {l_gpu} vs {l_cpu}, max gradient "
                             f"difference {err:.3e} against {REF_GRAD_SHARE} x norm {norm:.3e}")
    if not all(torch.isfinite(t).all() for t in p_gpu):
        raise AssertionError("card-vs-CPU LoRA step: the update gave non-finite adapters")
    details["lora_train_reference"] = {"loss_cpu": l_cpu, "loss_card": l_gpu, "grad_norm": norm,
                                       "grad_max_abs_err": err, "launches": counts}
    log(f"lora_train_reference: loss card {l_gpu:.7f} cpu {l_cpu:.7f}, max adapter gradient "
        f"difference {err:.3e} ({err / norm:.2e} of the global norm {norm:.3e}), card launches "
        f"{counts}")


# ---------------------------------------------------------------- phase 7


def phase_train_tiny(details, dev):
    """CSMTrainer.train at tiny width on the card (epochs, validation, the
    epoch / best / final checkpoints, resume from latest), then the training
    CLI with --tiny-test on two synthetic recordings."""
    import json as _json
    import os
    import tempfile

    import torch

    from csm_torch.cli.common import tiny_mimi
    from csm_torch.data.audio import save_wav
    from csm_torch.data.dataset import CSMDataset
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.models.config import tiny_test_args
    from csm_torch.training.checkpoint import latest_checkpoint
    from csm_torch.training.trainer import CSMTrainer
    from csm_torch.utils.params import random_csm_params

    args = tiny_test_args()
    ds = CSMDataset(synthetic_examples(4, 2.0, seed=1), ByteTokenizer(), tiny_mimi(args, dev),
                    args=args)

    def trainer(out):
        return CSMTrainer(args=args, params=random_csm_params(args, seed=0, device=dev),
                          output_dir=out, learning_rate=1e-3, compute_dtype=torch.float32,
                          remat=False, device=dev)

    with tempfile.TemporaryDirectory() as out:
        loss = trainer(out).train(ds, val_dataset=ds, batch_size=2, epochs=2, val_every=2,
                                  save_every=100)
        ckpt_dir = os.path.join(out, "checkpoints")
        for name in ("epoch_0", "epoch_1", "best", "final"):
            if not os.path.exists(os.path.join(ckpt_dir, name, "meta.json")):
                raise AssertionError(f"train(): no {name} checkpoint")
        if not (math.isfinite(loss) and latest_checkpoint(ckpt_dir).endswith("final")):
            raise AssertionError(f"train(): loss {loss}, latest {latest_checkpoint(ckpt_dir)}")
        tr = trainer(out)
        resumed = tr.train(ds, batch_size=2, epochs=3, resume_from="latest")
        if not (math.isfinite(resumed) and tr.global_step == 8):
            raise AssertionError(f"resume: loss {resumed}, global step {tr.global_step} (want 8)")
        details["train_tiny"] = {"loss": loss, "resumed_loss": resumed}
        log(f"train_tiny: train() 2 epochs loss {loss:.4f}, resumed from latest to step "
            f"{tr.global_step}, loss {resumed:.4f}")

    with tempfile.TemporaryDirectory() as d:
        for i, ex in enumerate(synthetic_examples(2, 1.5, seed=2)):
            save_wav(os.path.join(d, f"utt{i}.wav"), ex.audio, 24_000)
            with open(os.path.join(d, f"utt{i}.txt"), "w") as f:
                f.write(ex.text)
        out = os.path.join(d, "out")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "csm_torch.cli.train", "--audio-dir", d, "--tiny-test",
             "--output-dir", out, "--val-split", "0", "--epochs", "2"],
            cwd=ROOT, capture_output=True, text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT)},
        )
        if res.returncode != 0:
            raise AssertionError(f"csm_torch.cli.train failed:\n{res.stdout}\n{res.stderr}")
        with open(os.path.join(out, "checkpoints", "final", "meta.json")) as f:
            meta = _json.load(f)
        if meta["global_step"] != 2:
            raise AssertionError(f"CLI: final checkpoint at step {meta['global_step']}, want 2")
        details["train_cli_s"] = time.perf_counter() - t0
        log(f"train_cli: python -m csm_torch.cli.train --tiny-test ran to its end in "
            f"{details['train_cli_s']:.1f} s ({res.stdout.strip().splitlines()[-1]})")


# ---------------------------------------------------------------- phase 7b


def write_recordings(d, n, seconds, seed):
    """``n`` synthetic (wav, txt) pairs in ``d`` for the training CLIs."""
    import os

    from csm_torch.data.audio import save_wav

    os.makedirs(d, exist_ok=True)
    for i, ex in enumerate(synthetic_examples(n, seconds, seed=seed)):
        save_wav(os.path.join(d, f"utt{i}.wav"), ex.audio, 24_000)
        with open(os.path.join(d, f"utt{i}.txt"), "w") as f:
            f.write(ex.text)
    return d


def phase_lora_files(details, dev):
    """The user's LoRA path at CSM-1B width (random base weights of seed 0):
    ``csm-torch-finetune-lora`` in process for two steps with ``--save-mode
    both --async-checkpointing``; ``load_csm(lora_path=...)`` in float32
    (TF32 off), whose codes at topk=1 equal a Generator's on the
    ``merge_lora``'d weights made in memory; ``csm-torch-generate
    --lora-path`` in process, in bf16, its codes equal to the in-memory
    bf16 merge's; then a two-speaker ``csm-torch-finetune-lora-multi`` at
    tiny width."""
    import os
    import tempfile

    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.cli import finetune_lora, finetune_lora_multi
    from csm_torch.cli import generate as cli
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.generator import Generator
    from csm_torch.training import lora as lora_mod
    from csm_torch.utils.params import cast_params, random_csm_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = csm_1b_args()
    rec = details["lora_files"] = {}
    with tempfile.TemporaryDirectory(prefix="csm_lora_") as tmp:
        data = write_recordings(os.path.join(tmp, "data"), 4, 6.0, seed=3)
        out = os.path.join(tmp, "out")
        t0 = time.perf_counter()
        code = finetune_lora.main(["--audio-dir", data, "--output-dir", out, "--val-split", "0",
                                   "--epochs", "1", "--batch-size", "2", "--save-mode", "both",
                                   "--async-checkpointing", "--allow-byte-tokenizer",
                                   "--learning-rate", str(LORA_LR)])
        rec["finetune_s"] = time.perf_counter() - t0
        if code != 0:
            raise AssertionError(f"csm-torch-finetune-lora exited {code}")
        with open(os.path.join(out, "checkpoints", "latest.json")) as f:
            latest = json.load(f)["latest"]
        with open(os.path.join(out, "checkpoints", latest, "meta.json")) as f:
            steps = json.load(f)["global_step"]
        adapter = os.path.join(out, "adapter_lora")
        full = os.path.join(out, "adapter_full")
        if latest != "final" or steps != 2 or not os.path.exists(os.path.join(full, "state.pt")):
            raise AssertionError(f"finetune: latest {latest!r} at step {steps}, full artifact "
                                 f"{os.listdir(out)}")
        rec["full_bytes"] = os.path.getsize(os.path.join(full, "state.pt"))
        lo, lcfg, largs = lora_mod.load_lora(adapter, "cuda")
        if largs != args or not any(bool(ad["b"].any()) for c in lo.values() for ad in c.values()):
            raise AssertionError("finetune: the adapter is not trained or not CSM-1B's")
        log(f"csm-torch-finetune-lora on {details['card']}: 2 steps at CSM-1B, --save-mode both "
            f"--async-checkpointing, in {rec['finetune_s']:.1f} s (the merged float32 artifact "
            f"{rec['full_bytes'] / 1e9:.2f} GB); {lora_mod.count_params(lo):,} adapter "
            f"parameters")

        def recorded(g):
            g.mimi = Recording(g.mimi)
            return g

        # load_csm(lora_path) against the merge made in memory, float32
        got = recorded(load_csm(args=args, compute_dtype=torch.float32, lora_path=adapter,
                                text_tokenizer=ByteTokenizer()))
        got.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
        merged = lora_mod.merge_lora(cast_params(random_csm_params(args, 0, device="cuda"),
                                                 torch.float32), lo, lcfg)
        free(got)
        mem = recorded(Generator(merged, args, mimi=got.mimi.inner,
                                 text_tokenizer=ByteTokenizer(), compute_dtype=torch.float32))
        del merged
        mem.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
        (a,), (b,) = got.mimi.decoded, mem.mimi.decoded
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError("load_csm(lora_path) codes differ from the in-memory merge's")
        free(mem)
        rec["load_csm_frames"] = int(a.shape[1])
        log(f"  load_csm(lora_path) float32: codes equal the in-memory merge_lora Generator's "
            f"over {a.shape[1]} frames at topk=1")

        # csm-torch-generate --lora-path, bf16, against the bf16 merge in memory
        built, real_build = [], cli.build_generator
        cli.build_generator = lambda a: built.append(recorded(real_build(a))) or built[-1]
        wav = os.path.join(tmp, "o.wav")
        try:
            if cli.main(["--lora-path", adapter, "--allow-byte-tokenizer", "--no-watermark",
                         "--topk", "1", "--text", SHORT_TEXT, "--max-audio-length-ms", "2000",
                         "--output", wav]) != 0:
                raise AssertionError("csm-torch-generate --lora-path failed")
        finally:
            cli.build_generator = real_build
        (a,) = built[0].mimi.decoded
        free(built[0])
        merged = cast_params(lora_mod.merge_lora(
            cast_params(random_csm_params(args, 0, device="cuda"), torch.bfloat16), lo, lcfg),
            torch.bfloat16)
        mem = recorded(Generator(merged, args, mimi=built[0].mimi.inner,
                                 text_tokenizer=ByteTokenizer(), compute_dtype=torch.bfloat16))
        del merged
        mem.generate(SHORT_TEXT, max_audio_length_ms=2000, topk=1)
        (b,) = mem.mimi.decoded
        free(mem)
        if a.shape != b.shape or not (a == b).all():
            raise AssertionError("csm-torch-generate --lora-path codes differ from the "
                                 "in-memory bf16 merge's")
        rec["generate_cli_frames"] = int(a.shape[1])
        log(f"  csm-torch-generate --lora-path bf16: codes equal the in-memory merge's over "
            f"{a.shape[1]} frames at topk=1")

        # two speakers at tiny width
        speakers = [{"name": f"s{i}", "speaker_id": i,
                     "audio_dir": write_recordings(os.path.join(tmp, f"spk{i}"), 2, 1.5, 10 + i),
                     "transcript_dir": os.path.join(tmp, f"spk{i}")} for i in range(2)]
        cfg = os.path.join(tmp, "speakers.json")
        with open(cfg, "w") as f:
            json.dump(speakers, f)
        multi = os.path.join(tmp, "multi")
        t0 = time.perf_counter()
        if finetune_lora_multi.main(["--speakers-config", cfg, "--tiny-test", "--output-dir",
                                     multi, "--val-split", "0"]) != 0:
            raise AssertionError("csm-torch-finetune-lora-multi failed")
        with open(os.path.join(multi, "summary.json")) as f:
            summary = json.load(f)
        if [e["name"] for e in summary] != ["s0", "s1"] or not all(
                math.isfinite(e["final_loss"]) for e in summary):
            raise AssertionError(f"finetune-lora-multi summary {summary}")
        rec["multi_s"] = time.perf_counter() - t0
        log(f"  csm-torch-finetune-lora-multi --tiny-test: 2 speakers in {rec['multi_s']:.1f} s, "
            f"final losses {[round(e['final_loss'], 4) for e in summary]}")


# ---------------------------------------------------------------- phase 8


def phase_train_reference(details, dev):
    """One train step of a tiny float32 model at T=256 (max_seq_len raised)
    on the card and on the CPU from the same weights, batch and frame
    scores: the card runs the flash kernels forward and backward, the CPU
    their plain versions.  The step's gradient function and its optimizer
    update, as ``make_train_step`` runs them."""
    import dataclasses

    import numpy as np
    import torch

    from csm_torch.models.config import tiny_test_args
    from csm_torch.training.losses import Batch, compute_loss
    from csm_torch.training.optimizer import global_norm, make_optimizer, named_leaves
    from csm_torch.training.train_step import _accumulated_grads
    from csm_torch.utils.params import random_csm_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = tiny_test_args()
    args = dataclasses.replace(args, backbone_config=dataclasses.replace(
        args.backbone_config, max_seq_len=512))
    B, T, K = 2, 256, args.audio_num_codebooks
    rng = np.random.default_rng(0)
    tokens = np.zeros((B, T, K + 1), np.int32)
    mask = np.zeros((B, T, K + 1), bool)
    tokens[:, :40, K] = rng.integers(1, args.text_vocab_size, (B, 40))
    mask[:, :40, K] = True
    audio = rng.integers(0, args.audio_vocab_size, (B, T - 40, K))
    tokens[:, 40:, :K], mask[:, 40:, :K] = audio, True
    targets = np.zeros((B, T, K), np.int32)
    targets[:, 39 : T - 1] = audio
    tmask = np.zeros((B, T), bool)
    tmask[:, 39 : T - 1] = True
    batch = Batch(*map(torch.from_numpy, (tokens, mask, targets, tmask)))
    scores = torch.from_numpy(rng.random(B * T).astype(np.float32))
    params0 = random_csm_params(args, seed=0)

    def loss_fn(p, g, b, s):
        return compute_loss(p, args, g, b, compute_dtype=torch.float32, remat=True,
                            frame_scores=s)

    res = {}
    for where in ("cpu", dev):
        params = tree_map(lambda t: t.clone().to(where), params0)
        reset_counts()
        metrics, grads = _accumulated_grads(loss_fn, params, None, batch.to(where), 1,
                                            [scores.to(where)])
        raw = [g.to("cpu", copy=True) for g in grads]  # the update clips grads in place
        tx = make_optimizer(params, learning_rate=1e-3)
        tx.update(params, grads, tx.init(params))
        torch.cuda.synchronize()
        res[str(where)] = (metrics["loss"].item(), raw, read_counts(),
                           [t.detach().cpu() for _, t in named_leaves(params)])
    (l_cpu, g_cpu, _, _), (l_gpu, g_gpu, counts, p_gpu) = res["cpu"], res[str(dev)]
    check_launches("card-vs-CPU train step", counts, expected_train_launches(2))
    norm = global_norm(g_cpu).item()
    err = max((a - b).abs().max().item() for a, b in zip(g_gpu, g_cpu))
    if abs(l_gpu - l_cpu) > REF_LOSS_RTOL * abs(l_cpu) or err > REF_GRAD_SHARE * norm:
        raise AssertionError(f"card-vs-CPU step: loss {l_gpu} vs {l_cpu}, max gradient "
                             f"difference {err:.3e} against {REF_GRAD_SHARE} x norm {norm:.3e}")
    if not all(torch.isfinite(t).all() for t in p_gpu):
        raise AssertionError("card-vs-CPU step: the update gave non-finite params")
    details["train_reference"] = {"loss_cpu": l_cpu, "loss_card": l_gpu, "grad_norm": norm,
                                  "grad_max_abs_err": err, "launches": counts}
    log(f"train_reference: loss card {l_gpu:.7f} cpu {l_cpu:.7f}, max gradient difference "
        f"{err:.3e} ({err / norm:.2e} of the global norm {norm:.3e}), card launches {counts}")


# ---------------------------------------------------------------- phase 9


def phase_matvec_probe(details):
    """``bench_matvec.run`` at CSM-1B width: 16 layers, 1.95 GB of bf16
    weights.  Every variant agrees with ``stacked`` and stays finite over the
    chained timing; the kernel variant launches 64 times a pass.  The
    window counts every launch through the wrapper in the run: the parity
    pass, the two warm-up passes and the pass captured into the CUDA graph
    (whose replays, the timed passes, run the kernels without the wrapper).
    Returns that count."""
    from csm_torch.scripts import bench_matvec

    L = 16
    reset_counts()  # the window opens
    res = bench_matvec.run("cuda", L=L, n=50)
    got = read_counts()  # the window closes
    if res["launches_per_pass"] != 4 * L:
        raise AssertionError(f"matvec probe: {res['launches_per_pass']} launches a pass")
    check_launches("matvec probe", got, {"matvec": max(got["matvec"], 4 * L)})
    details["matvec_probe"] = dict(res, launches=got["matvec"])
    log(f"matvec probe on {details['card']}: {L} layers, {res['weight_bytes'] / 1e9:.3f} GB of "
        f"bf16 weights a pass, bound {res['bound_ms']:.4f} ms at 3.35 TB/s; "
        f"{res['launches_per_pass']} kernel launches a pass, {got['matvec']} in the run")
    for name, v in res["variants"].items():
        log(f"  {name:>9}: {v['ms']:.4f} ms a pass, {v['GBps']:.1f} GB/s "
            f"({100 * v['share_of_hbm']:.1f} % of 3.35 TB/s), parity {v['parity']:.2e}")
    return got["matvec"]


# ---------------------------------------------------------------- phase 10


# Training over a mesh of ranks.  One card: every rank is a process on
# cuda:0 and the group is gloo, so the collectives go through host memory
# (parallel/distributed.py); nothing here measures NVLink or scaling.
# Float32 witnesses (TF32 off) at CSM-1B width with two layers, B=2, T=512,
# against the single-process step on the card (rank 0 alone, first, through
# make_train_step with no mesh): the JAX package's parallel-test tolerances
# for the loss and gradients; each parameter after two AdamW steps within
# 2e-5, or within what the measured gradient noise lets its two updates
# move where that is more (parallel/witness.compare; the counts held to
# 2e-5 and to 2·lr or more printed).
MESH_T = 512
MESH_LR = 1e-3
MESH_TOL = dict(loss_rtol=2e-4, grad_atol=5e-4, grad_rtol=1e-3, param_atol=2e-5, lr=MESH_LR)
MESH_STEPS = 2  # bf16 figures: the first step pays for set-up, the second is timed
MESH_TIMEOUT_S = 420


def mesh_args(layers=None):
    """CSM-1B, its backbone and decoder cut to ``layers`` layers."""
    import dataclasses

    from csm_torch import csm_1b_args

    a = csm_1b_args()
    if layers is None:
        return a
    cut = lambda c: dataclasses.replace(c, num_layers=layers)  # noqa: E731
    return dataclasses.replace(a, backbone_config=cut(a.backbone), decoder_config=cut(a.decoder))


def mesh_batch(args, B, T, seed):
    """A (B, T) batch in the training layout (half text, half audio frames;
    position t predicts the frame at t+1), random tokens from ``seed``."""
    import numpy as np
    import torch

    from csm_torch.training.losses import Batch

    rng = np.random.default_rng(seed)
    K = args.audio_num_codebooks
    tokens = np.zeros((B, T, K + 1), np.int32)
    tokens_mask = np.zeros((B, T, K + 1), bool)
    targets = np.zeros((B, T, K), np.int32)
    target_mask = np.zeros((B, T), bool)
    h = T // 2
    tokens[:, :h, -1] = rng.integers(1, args.text_vocab_size, (B, h))
    tokens_mask[:, :h, -1] = True
    audio = rng.integers(0, args.audio_vocab_size - 3, (B, T - h, K))
    tokens[:, h:, :K], tokens_mask[:, h:, :K] = audio, True
    targets[:, h - 1:T - 1], target_mask[:, h - 1:T - 1] = audio, True
    return Batch(*map(torch.from_numpy, (tokens, tokens_mask, targets, target_mask)))


def mesh_scores(B, T, seed):
    import numpy as np
    import torch

    return torch.from_numpy(np.random.default_rng(seed).random(B * T).astype(np.float32))


def expected_mesh_launches(kind, L, n=2, M=2, P=2) -> dict:
    """A rank's flash launches in one remat step at T >= 256: DP and TP run
    every layer (TP on its heads): ``expected_train_launches``; a pipeline
    stage runs its L/P layers at every one of the M + P - 1 schedule steps;
    the ring runs n chunk attentions a layer."""
    if kind == "pp":
        runs = (L // P) * (M + P - 1)
        return {"flash_attention_fwd": 2 * runs, "flash_attention_bwd_dq": runs,
                "flash_attention_bwd_dkv": runs}
    if kind == "sp":
        return {"flash_attention_fwd": 2 * L * n, "flash_attention_bwd_dq": L * n,
                "flash_attention_bwd_dkv": L * n}
    return expected_train_launches(L)


def bwd_check(name, args, drop_check=True):
    """Both backward kernels against their plain versions in bf16 on the
    backward's ``args`` (phase 3's tolerance; a dropped key tile must fail
    it).  Returns {"dq", "dk", "dv"}: max |kernel - plain|."""
    import torch

    from csm_torch.ops import flash_attention as fa

    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    want = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkv_plain(*args))
    dropped = dropped_tile(args)
    drop = (fa.flash_bwd_dq_plain(*dropped), *fa.flash_bwd_dkv_plain(*dropped))
    errs = {}
    for what, got, ref, dr, flips in zip(("dq", "dk", "dv"), (dq, dk, dv), want, drop,
                                         bwd_flip_allowance(args)):
        rms = ref.float().pow(2).mean().sqrt().item()
        if not rms > 0:
            raise AssertionError(f"{name} {what}: the plain gradient is zero")
        tol = BWD_REL_ATOL * rms + flips + BF16_RTOL * ref.float().abs()
        err = (got.float() - ref.float()).abs()
        used, moved = (err / tol).max().item(), ((dr.float() - ref.float()).abs() / tol).max().item()
        if not torch.isfinite(got.float()).all() or used > 1:
            raise AssertionError(f"{name} {what}: max |kernel - plain| = {err.max().item():.3e}, "
                                 f"{used:.2f}x the tolerance")
        if drop_check and not moved > 1:
            raise AssertionError(f"{name} {what}: dropping a key tile stays within the tolerance")
        errs[what] = err.max().item()
    return errs


def ring_chunk_checks(dev, details):
    """The flash kernels on ring chunks at CSM-1B heads in bf16, against
    their plain versions: a zigzag chunk (T=320 over 2 ranks: rank 0 holds
    positions 0-79 and 240-319, so a 64-key tile jumps) against itself and
    against rank 1's chunk, with an lse cotangent as the ring's merge gives;
    a contiguous chunk that sees no key (rank 0's queries 0-127 against rank
    3's keys 384-511 of T=512): O zero and L = L_EMPTY exactly, and with
    g_lse = 0 (what the merge passes for it) dq, dk and dv exactly zero."""
    import torch

    from csm_torch.ops import flash_attention as fa
    from csm_torch.parallel.ring_attention import zigzag_perm

    gen = torch.Generator(device=dev).manual_seed(10)
    Hq, Hkv, D = 32, 8, 64

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    def pos(cols):
        return torch.as_tensor(cols, dtype=torch.int32, device=dev)[None].contiguous()

    perm = zigzag_perm(320, 2)
    out = {}
    for name, qc, kc in (("zigzag_diagonal", perm[:160], perm[:160]),
                         ("zigzag_off_diagonal", perm[:160], perm[160:])):
        q, k, v, g = r(1, 160, Hq, D), r(1, 160, Hkv, D), r(1, 160, Hkv, D), r(1, 160, Hq, D)
        q_pos, kv_pos = pos(qc), pos(kc)
        o, lse = fa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
        torch.cuda.synchronize()
        f_err = fwd_check(f"ring chunk {name}", o, lse, q, k, v, q_pos, kv_pos)
        g_lse = torch.randn(1, Hq, 160, generator=gen, device=dev)
        seen = torch.isfinite(lse) & (lse < fa.L_EMPTY / 2)
        g_lse = torch.where(seen, g_lse, torch.zeros_like(g_lse))
        errs = bwd_check(f"ring chunk {name}", (q, k, v, q_pos, kv_pos, g, lse,
                                                fa.bwd_delta(o, g, g_lse)))
        out[name] = dict(fwd=f_err, **errs)
        log(f"ring chunk {name}: max |kernel - plain| O {f_err:.2e}, dq {errs['dq']:.2e}, "
            f"dk {errs['dk']:.2e}, dv {errs['dv']:.2e}")
    q, k, v, g = r(1, 128, Hq, D), r(1, 128, Hkv, D), r(1, 128, Hkv, D), r(1, 128, Hq, D)
    q_pos, kv_pos = pos(range(0, 128)), pos(range(384, 512))
    o, lse = fa.flash_attention_fwd(q, k, v, q_pos, kv_pos)
    args = (q, k, v, q_pos, kv_pos, g, lse, fa.bwd_delta(o, g, None))
    dq = fa.flash_attention_bwd_dq(*args)
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    torch.cuda.synchronize()
    if not (torch.count_nonzero(o) == 0 and bool((lse == fa.L_EMPTY).all())):
        raise AssertionError("ring chunk with no visible key: O or L not empty")
    for what, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        if not (torch.isfinite(t.float()).all() and torch.count_nonzero(t) == 0):
            raise AssertionError(f"ring chunk with no visible key: {what} not exactly zero")
    out["empty"] = "O = 0, L = L_EMPTY, dq = dk = dv = 0 exactly"
    log("ring chunk with no visible key: O zero, L = L_EMPTY, dq, dk, dv exactly zero")
    details["ring_chunks"] = out


def mesh_witness_spec(args2, bf16, device="cuda"):
    """The 2-rank launch: float32 witnesses against rank 0's single-process
    step, then the bf16 figures at full CSM-1B (remat, float32 master
    weights, ``MESH_STEPS`` steps, no gather)."""
    full = mesh_args()
    b2 = [mesh_batch(args2, 2, MESH_T, s) for s in (1, 2)]
    f32 = dict(ratio=16, dtype="f32", remat=False, steps=2, lr=MESH_LR)
    cases = [dict(name=n, parallel=p, **f32) for n, p in (
        ("dp", {}), ("tp_fsdp", dict(model_parallel=2, fsdp=True)),
        ("pp", dict(pipeline_parallel=2, pp_microbatches=2)),
        ("sp_contiguous", dict(seq_parallel=2, ring_layout="contiguous")),
        ("sp_zigzag", dict(seq_parallel=2, ring_layout="zigzag")))]
    if bf16:
        figures = dict(args=full, dtype="bf16", param_dtype="f32", remat=True, steps=MESH_STEPS,
                       grads=False, params_out=False, compare=False)
        for name, par, B, T in (("bf16_dp", {}, 4, 512),
                                ("bf16_tp_fsdp", dict(model_parallel=2, fsdp=True), 2, 512),
                                ("bf16_pp", dict(pipeline_parallel=2, pp_microbatches=2), 2, 512),
                                ("bf16_sp_zigzag", dict(seq_parallel=2, ring_layout="zigzag"),
                                 1, 2048)):
            cases.append(dict(figures, name=name, parallel=par, batches=[mesh_batch(full, B, T, 3)],
                              scores=[mesh_scores(B, T, 4)], B=B, T=T))
    return dict(device=device, args=args2, params={"seed": 0}, batches=b2,
                scores=[mesh_scores(2, MESH_T, 5)] * 2, host_results=False,
                reference=dict(name="single", parallel={}, lr=MESH_LR),
                tolerances=MESH_TOL, cases=cases)


def mesh_four_spec(args2, bf16, device="cuda"):
    """The 4-rank launch: a float32 SP=4 witness at T=512 (128-query
    chunks), and LoRA r=8 on q/v over a bf16 base at T=2048 with SP=4."""
    full = mesh_args()
    cases = [dict(name="sp4_zigzag", parallel=dict(seq_parallel=4, ring_layout="zigzag"),
                  ratio=16, dtype="f32", remat=False, steps=2, lr=MESH_LR)]
    if bf16:
        cases.append(dict(name="bf16_sp4_lora_qv_r8", args=full,
                          parallel=dict(seq_parallel=4, ring_layout="zigzag"),
                          lora=dict(r=8, alpha=16.0, target_modules=("q_proj", "v_proj")),
                          dtype="bf16", remat=True, steps=MESH_STEPS, grads=False,
                          params_out=False, compare=False,
                          batches=[mesh_batch(full, 1, 2048, 6)], scores=[mesh_scores(1, 2048, 7)],
                          B=1, T=2048))
    return dict(device=device, args=args2, params={"seed": 0},
                batches=[mesh_batch(args2, 2, MESH_T, s) for s in (1, 2)],
                scores=[mesh_scores(2, MESH_T, 5)] * 2, host_results=False,
                reference=dict(name="single", parallel={}, lr=MESH_LR),
                tolerances=MESH_TOL, cases=cases)


def mesh_results(outs, spec, details, total):
    """Hold a launch's results: every float32 witness within its
    tolerances, every rank's global losses equal, the bf16 figures' flash
    launches a step as the layout implies; log and record them."""
    L = mesh_args().backbone.num_layers
    world = len(outs)
    faults = []
    for case in spec["cases"]:
        name = case["name"]
        got = [o[name] for o in outs]
        losses = {tuple(g["losses"]) for g in got}
        if len(losses) != 1 or not all(map(math.isfinite, got[0]["losses"])):
            raise AssertionError(f"mesh {name}: ranks' losses {[g['losses'] for g in got]}")
        rec = dict(ranks=world, shape=got[0]["shape"], losses=got[0]["losses"],
                   ms=got[0]["ms"], peak_gib_per_rank=[g["peak_bytes"] / 2**30 for g in got])
        rec["wall_s"] = got[0]["wall_s"]
        if "vs_reference" in got[0]:
            vs = rec["vs_reference"] = got[0]["vs_reference"]
            if not vs["ok"]:
                faults.append(f"mesh {name} (float32) against the single-process step: {vs}")
            log(f"mesh {name} {got[0]['shape']} float32 ({rec['wall_s']:.1f} s): loss within "
                f"{vs['loss_rel']:.1e} (rel), gradients {vs['grad_share']:.3f} of the tolerance "
                f"(max abs {vs['grad_max_abs']:.1e}), params after 2 steps "
                f"{vs['param_share']:.3f} of their bound: within {vs['param_strict_max_abs']:.1e} "
                f"over the {vs['strict_elements']} held to 2e-5, "
                f"{vs['param_free_max_abs']:.1e} over the {vs['free_elements']} whose "
                f"gradients lie within the noise (bound 2·lr or more), of {vs['elements']}")
        else:
            par = case["parallel"]
            kind = ("pp" if par.get("pipeline_parallel", 1) > 1
                    else "sp" if par.get("seq_parallel", 1) > 1 else "dp")
            want = expected_mesh_launches(kind, L, n=par.get("seq_parallel", 2))
            want = {k: v * case["steps"] for k, v in want.items()}
            for g in got:
                if g["launches"] != want:
                    faults.append(f"mesh {name} rank {g['rank']}: launches {g['launches']}, "
                                  f"the layout needs {want}")
            for k in total:
                total[k] += got[0]["launches"][k]
            ms = got[0]["ms"][-1]
            frames = case["B"] * (case["T"] // 2)  # the target frames of a global batch
            rec.update(ms_per_step=ms, trained_frames_per_s=frames / (ms / 1e3),
                       launches_per_step={k: v // case["steps"] for k, v in want.items()})
            log(f"mesh {name} {got[0]['shape']} bf16 B={case['B']} T={case['T']} "
                f"({rec['wall_s']:.1f} s): {ms:.1f} ms/step (steps {got[0]['ms']}), "
                f"{rec['trained_frames_per_s']:.1f} trained frames/s, peak "
                f"{max(rec['peak_gib_per_rank']):.2f} GiB a rank, flash launches a step "
                f"{rec['launches_per_step']}")
        details["mesh"][name] = rec
    if faults:
        raise AssertionError("; ".join(faults))


def phase_mesh_training(details, dev, bf16=True):
    """Phase 10: ring-chunk kernel checks in this process, then 2 and 4
    ranks as child processes on this card over gloo (after this process has
    freed its memory).  Returns the flash launches of the bf16 figures."""
    import gc

    import torch

    from csm_torch.parallel.launch import launch

    ring_chunk_checks(dev, details)
    gc.collect()
    torch.cuda.empty_cache()
    details["mesh"] = {"card": details.get("card"),
                       "collectives": "gloo through host memory, ranks sharing one card"}
    args2 = mesh_args(2)
    total = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0}
    for world, spec in ((2, mesh_witness_spec(args2, bf16)), (4, mesh_four_spec(args2, bf16))):
        t0 = time.perf_counter()  # the ranks' logs land in chiprun_out/mesh<world>/
        outs = launch("csm_torch.parallel.witness:run", world, OUT / f"mesh{world}", spec,
                      timeout_s=MESH_TIMEOUT_S, init_timeout_s=MESH_TIMEOUT_S)
        details["mesh"][f"launch_{world}_s"] = time.perf_counter() - t0
        mesh_results(outs, spec, details, total)
    single = details.get("train_1b", {})
    if single:
        log(f"beside them, phase 6 single-process CSM-1B B=2 T=512: "
            f"{single['ms_per_step_median']:.1f} ms/step, "
            f"{single['frames_per_s_median']:.1f} trained frames/s, peak "
            f"{single['peak_memory_gib']:.2f} GiB")
    return total


# ---------------------------------------------------------------- phase 11


def phase_native_loader(details):
    """The native audio loader (csm_torch/native), built on this host with
    g++, against the plain numpy/scipy route on a 10 s and a 60 s 44.1 kHz
    stereo 16-bit WAV: decode within 2e-3 of it, the 24 kHz resample within
    40 dB SNR of scipy's on the interior; both routes timed."""
    import tempfile
    import wave

    import numpy as np

    from csm_torch import native
    from csm_torch.data import audio as A

    t0 = time.perf_counter()
    native.load_library()
    details["native_build_s"] = time.perf_counter() - t0
    rows = {}
    with tempfile.TemporaryDirectory() as tmp:
        for seconds in (10, 60):
            sr = 44_100
            x = speech_band(seconds, sr=sr, seed=seconds)
            inter = np.stack([x, 0.5 * x], axis=1).reshape(-1)
            path = str(Path(tmp) / f"s{seconds}.wav")
            with wave.open(path, "wb") as w:
                w.setnchannels(2)
                w.setsampwidth(2)
                w.setframerate(sr)
                w.writeframes(np.clip(inter * 32767, -32768, 32767).astype("<i2").tobytes())
            t0 = time.perf_counter()
            got = A.load_audio(path, 24_000)
            nat_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            plain = A.resample_plain(A.load_wav_plain(path)[0], sr, 24_000)
            plain_s = time.perf_counter() - t0
            dec, dec_p = A.load_wav(path)[0], A.load_wav_plain(path)[0]
            dec_err = float(np.abs(dec - dec_p).max())
            n = min(len(got), len(plain))
            core = slice(n // 10, -n // 10)
            err = got[:n][core] - plain[:n][core]
            snr = 10 * np.log10(np.mean(plain[:n][core] ** 2) / max(np.mean(err**2), 1e-20))
            if abs(len(got) - len(plain)) > 1 or dec_err > 2e-3 or not snr > 40:
                raise AssertionError(f"native loader {seconds} s: decode {dec_err:.2e}, "
                                     f"resample SNR {snr:.1f} dB, lengths {len(got)} {len(plain)}")
            rows[f"{seconds}s"] = dict(native_s=nat_s, plain_s=plain_s, decode_max_abs=dec_err,
                                       resample_snr_db=float(snr))
            log(f"native loader {seconds} s 44.1 kHz stereo -> 24 kHz mono: native "
                f"{nat_s * 1e3:.1f} ms, plain {plain_s * 1e3:.1f} ms; decode within "
                f"{dec_err:.1e}, resample {snr:.1f} dB SNR against scipy")
    details["native_loader"] = rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA card", file=sys.stderr)
        return 1
    try:
        import csm_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the csm_torch package is not here ({e})", file=sys.stderr)
        return 1
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa
    from csm_torch.ops import int4_matmul as i4
    from csm_torch.ops import matvec as mv
    from csm_torch.utils.cuda_build import build_all

    details = {}
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        log(card)
        details["card"] = card
        details["torch"] = f"{torch.__version__} CUDA {torch.version.cuda}"
        log(f"torch {details['torch']}, {torch.cuda.get_device_name(0)}")

        t0 = time.perf_counter()
        logs = build_all([dec.SOURCE, fa.SOURCE, fa.BWD_SOURCE, i4.SOURCE, mv.SOURCE])
        details["build_s"] = time.perf_counter() - t0
        ptxas = [ln.strip() for out in logs.values() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        details["ptxas"] = ptxas
        log(f"kernels built in {details['build_s']:.1f} s; ptxas:")
        for ln in ptxas:
            log("  " + ln)

        dev = torch.device("cuda")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        phase_s = details["phase_s"] = {}

        held = details["allocated_after_phase_gib"] = {}

        def timed(name, fn, *a):
            t0 = time.perf_counter()
            out = fn(*a)
            phase_s[name] = time.perf_counter() - t0
            held[name] = torch.cuda.memory_allocated() / 2**30
            log(f"phase {name}: {phase_s[name]:.1f} s; the card holds {held[name]:.3f} GiB after it")
            return out

        kernels = timed("3", phase_kernels, dev, flush, details)
        del flush
        launches = timed("4", phase_main_path, details)
        timed("4b", phase_files, details)
        serving = timed("4c", phase_serving, details)
        windowed = timed("4d", phase_prefix_window, details)
        streaming = timed("4e", phase_streaming, details)
        bank = timed("4f", phase_bank, details)
        launches.update(timed("4q", phase_quantized, details))
        timed("5", phase_reference, details)
        launches.update(timed("6", phase_training, details, dev))
        lora = timed("6b", phase_lora_training, details, dev)
        timed("7", phase_train_tiny, details, dev)
        timed("7b", phase_lora_files, details, dev)
        timed("8", phase_train_reference, details, dev)
        launches["matvec"] = timed("9", phase_matvec_probe, details)
        mesh = timed("10", phase_mesh_training, details, dev)
        timed("11", phase_native_loader, details)
        for k in kernels:
            k["launches"] = launches[k["name"]]
            k["serving_launches"] = serving[k["name"]]
            k["prefix_window_launches"] = windowed[k["name"]]
            k["streaming_launches"] = streaming[k["name"]]
            k["bank_launches"] = bank[k["name"]]
            k["lora_train_launches"] = lora[k["name"]]
            k["mesh_train_launches"] = mesh.get(k["name"], 0)
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke.json").write_text(json.dumps(details, indent=1, default=str))

    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
