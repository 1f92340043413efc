#!/usr/bin/env python3
"""Run the csm_torch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) if anything
is wrong:

  1. a CUDA card is required; its name and power limit are printed;
  2. the kernels build from csm_torch/csrc (one nvcc per source, in
     parallel) into build/kernels/;
  3. each kernel is held against its plain PyTorch version in bf16 at the
     shapes of the main path, and timed beside that plain version, one
     PyTorch library call computing the same function, and its bound;
  4. the main path runs at CSM-1B width on random weights: Generator.generate
     (prompt bucket 64), generate (bucket 256: prefill through the flash
     kernel) and generate_batch of two prompts, with the kernels' launch
     counts held to what the path must launch; then the quantized path:
     int4 weights at CSM-1B width (generate and generate_batch, int4 kernel
     launches counted) and at 8B width (peak device memory recorded), and
     short runs of int8, int8-decoder and the int8 KV cache;
  5. a tiny float32 model, with float and with int4 weights, generates on
     the card and on the CPU (where the wrappers run the plain versions):
     codes equal, audio close.

The second-to-last line is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Details go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
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


def decode_case(B, Hq, Hkv, D, T, gen, dev, shared_mask=False, dead_row=False):
    """bf16 decode inputs; row b sees keys < its own length."""
    import torch

    q = torch.randn(B, 1, Hq, D, generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn(B, T, Hkv, D, generator=gen, device=dev).to(torch.bfloat16)
    lens = torch.tensor([T - 7 * b for b in range(B)], device=dev)
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


def decode_bound(q, k, mask):
    B, _, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    moved = 2 * (2 * B * Hq * D) + 2 * (2 * B * T * Hkv * D) + mask.numel()
    return bound_ms(moved, 4.0 * B * Hq * D * T)


def flash_bound(q, k, q_pos, kv_pos):
    """FLOPs of the visible (query, key) pairs this input has."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    visible = int((kv_pos[:, None, :] <= q_pos[:, :, None]).sum())
    moved = 2 * (2 * B * S * Hq * D) + 2 * (2 * B * T * Hkv * D) + 4 * (B * S + B * T + B * Hq * S)
    return bound_ms(moved, 4.0 * Hq * D * visible)


def sdpa_decode(q, k, v, mask):
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = mask[:, None]  # (B|1, 1, 1, T)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, enable_gqa=True)


def sdpa_flash(q, k, v, q_pos, kv_pos):
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    m = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, None]  # (B, 1, S, T)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=m, enable_gqa=True)


def phase_kernels(dev, flush, details):
    """Hold each kernel against its plain version; time both at the main
    path's shapes.  Returns the per-kernel records (launches filled later)."""
    import torch

    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    # decode: backbone (Hq=32, Hkv=8, D=64) and decoder (Hq=8, Hkv=2, D=128)
    decode_shapes = [
        dict(B=1, Hq=32, Hkv=8, D=64, T=89),  # main path: bucket 64 + 25 frames
        dict(B=1, Hq=32, Hkv=8, D=64, T=89, shared_mask=True),
        dict(B=2, Hq=32, Hkv=8, D=64, T=89),
        dict(B=1, Hq=32, Hkv=8, D=64, T=281),  # bucket 256 + 25 frames
        dict(B=1, Hq=32, Hkv=8, D=64, T=1189),
        dict(B=2, Hq=32, Hkv=8, D=64, T=1189, dead_row=True),
        dict(B=1, Hq=32, Hkv=8, D=64, T=2048),
        dict(B=2, Hq=32, Hkv=8, D=64, T=2048, dead_row=True),
        dict(B=1, Hq=8, Hkv=2, D=128, T=32),  # decoder: fresh 32-slot cache
        dict(B=2, Hq=8, Hkv=2, D=128, T=32),
    ]
    for shape in decode_shapes:
        q, k, v, mask = decode_case(**shape, gen=gen, dev=dev)
        got = dec.decode_gqa_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = dec.decode_attention_plain(q, k, v, mask)
        err = check_close(f"decode {shape}", got, want, BF16_ATOL, BF16_RTOL)
        if shape.get("dead_row") and got[-1].any():
            raise AssertionError("a fully masked row must give zeros")
        b_ms, b_by = decode_bound(q, k, mask)
        rows.append(dict(kernel="decode_attention", shape=shape, max_abs_err=err,
                         ms=timed_ms(lambda: dec.decode_gqa_attention(q, k, v, mask), flush),
                         plain_ms=timed_ms(lambda: dec.decode_attention_plain(q, k, v, mask), flush),
                         library_ms=timed_ms(sdpa_decode(q, k, v, mask), flush),
                         bound_ms=b_ms, bound_by=b_by))
    # flash forward: prefill buckets 256 and 512, T = S + 25 frames
    for B, S in ((1, 256), (2, 256), (1, 512), (2, 512)):
        q, k, v, q_pos, kv_pos = flash_case(B, S, S + 25, 32, 8, 64, gen, dev)
        o, lse = fa.flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_attention_plain(q, k, v, q_pos, kv_pos)
        err = check_close(f"flash O B={B} S={S}", o, o_p, BF16_ATOL, BF16_RTOL)
        check_close(f"flash L B={B} S={S}", lse, lse_p, LSE_ATOL, 0.0)
        pad = q_pos == (1 << 28)
        if pad.any() and not o[pad].abs().amax() > 0:
            raise AssertionError("PAD_POS rows attend every slot: their output is not zero")
        b_ms, b_by = flash_bound(q, k, q_pos, kv_pos)
        rows.append(dict(kernel="flash_attention_fwd", shape=dict(B=B, S=S, T=S + 25, Hq=32, Hkv=8, D=64),
                         max_abs_err=err,
                         ms=timed_ms(lambda: fa.flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos), flush),
                         plain_ms=timed_ms(lambda: fa.flash_attention_plain(q, k, v, q_pos, kv_pos), flush),
                         library_ms=timed_ms(sdpa_flash(q, k, v, q_pos, kv_pos), flush),
                         bound_ms=b_ms, bound_by=b_by))
    rows += int4_rows(gen, dev, flush, details)
    details["kernel_rows"] = rows
    log(f"{'kernel':<20} {'shape':<58} {'ms':>8} {'plain':>8} {'library':>8} {'bound':>8} err")
    for r in rows:
        log(f"{r['kernel']:<20} {json.dumps(r['shape']):<58} {r['ms']:8.4f} {r['plain_ms']:8.4f} "
            f"{r['library_ms']:8.4f} {r['bound_ms']:8.4f} {r['max_abs_err']:.2e}")

    def record(name, source, replaces, main_shape):
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["shape"] == main_shape)
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": 0, "max_abs_err": max(r["max_abs_err"] for r in mine),
                "ms": main["ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
                "bound_by": main["bound_by"], "library_ms": main["library_ms"]}

    return [
        record("decode_attention", "csm_torch/csrc/decode_attention.cu",
               "csm_tpu/ops/decode_attention.py:55", decode_shapes[0]),
        record("flash_attention_fwd", "csm_torch/csrc/flash_attention.cu",
               "csm_tpu/ops/flash_attention.py:117",
               dict(B=1, S=256, T=281, Hq=32, Hkv=8, D=64)),
        record("int4_matmul", "csm_torch/csrc/int4_matmul.cu",
               "csm_tpu/ops/int4_matmul.py:57", INT4_MAIN_SHAPE),
    ]


# The int4 matmul's shapes on the main path: CSM-1B backbone projections at
# M = 1 (decode step), 2 (B=2, or the decoder's S=2 call) and 64 (bucket-64
# prefill), the decoder's gate-up at M = 1, and the 8B flavor's MLP at M = 1.
INT4_SHAPES = [
    ("backbone wqkv", 2048, 3072, (1, 2, 64)),
    ("backbone wo", 2048, 2048, (1, 2, 64)),
    ("backbone w13", 2048, 16384, (1, 2, 64)),
    ("backbone w2", 8192, 2048, (1, 2, 64)),
    ("decoder w13", 1024, 16384, (1,)),
    ("8B w13", 4096, 28672, (1,)),
    ("8B w2", 14336, 4096, (1,)),
]
INT4_MAIN_SHAPE = dict(proj="backbone w13", M=1, K=2048, N=16384)


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


# ---------------------------------------------------------------- phase 4


LONG_TEXT = (
    "This prompt is long enough that its byte tokens fill more than one "
    "hundred and twenty eight positions, so the prompt pads to the 256 "
    "bucket and the prefill attends through the flash kernel."
)


def phase_main_path(details):
    """Generator.generate / generate_batch at CSM-1B width in bf16; returns
    the launch counts of the run."""
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer

    args = csm_1b_args()
    t0 = time.perf_counter()
    gen = load_csm(args=args, compute_dtype=torch.bfloat16, text_tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    details["load_s"] = time.perf_counter() - t0
    gen.generate("Warm up.", max_audio_length_ms=160)  # first-call set-up, outside the count
    launches = drive("bf16", gen, [
        ("generate_short", lambda: [gen.generate("Hello from the port.", max_audio_length_ms=2000)], 1),
        ("generate_long", lambda: [gen.generate(LONG_TEXT, speaker=1, max_audio_length_ms=2000)], 1),
        ("generate_batch", lambda: gen.generate_batch(
            ["A first, short line.", "And a second line that is a little longer than it."],
            [0, 1], max_audio_length_ms=2000), 2),
    ], args, details, ("decode_attention", "flash_attention_fwd"))
    details["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    profile_generate(gen, details, "profile")
    free(gen)
    return launches


def profile_generate(gen, details, key):
    """Where one generate's time goes (bucket 64, 10 frames, Mimi decode
    included), under torch.profiler: wall time, summed kernel time (the
    device's busy time: one stream, so kernels do not overlap) and the
    kernels that take the most of it.  The profiler slows the host, so the
    wall time here is above the unprofiled runs'."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        gen.generate("Profile one short line.", max_audio_length_ms=800)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if "CUDA" in str(getattr(e, "device_type", ""))]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    details[key] = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "top_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top],
    }
    log(f"{key}: generate of 10 frames {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({len(kernels)} kinds)")
    for name, count, ms in details[key]["top_kernels"]:
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
    """Decode-kernel launches of one generate: the decoder's S=1 steps, and
    the backbone's unless its cache is int8 (those take plain attention over
    the dequantized cache)."""
    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    return (K - 2) * L_dec * (st["steps"] + 1) + (0 if kv_int8 else L_bb * st["steps"])


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
    log(f"{name} on {details['card']}: bucket {st['prompt_bucket']}, {st['frames']} frames, prefill "
        f"{st['prefill_s'] * 1e3:.1f} ms, {st['frames_per_s']:.2f} frames/s, "
        f"generate {st['generate_s']:.3f} s, mimi {st['decode_s']:.3f} s, RTF {st['rtf']:.3f}")
    details[name] = st


def reset_counts():
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa
    from csm_torch.ops import int4_matmul as i4

    dec.launches = fa.launches = i4.launches = i4.dequant_calls = 0


def read_counts():
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa
    from csm_torch.ops import int4_matmul as i4

    return {"decode_attention": dec.launches, "flash_attention_fwd": fa.launches,
            "int4_matmul": i4.launches, "int4_dequant_route": i4.dequant_calls}


def drive(name, gen, calls, args, details, needs, kv_int8=False):
    """Drive ``calls`` ((run name, callable, batch size), ...) inside one
    launch-count window: every count is set to 0 just before and read just
    after, then held to what the runs must launch; each kernel in ``needs``
    must have launched.  Returns the counts."""
    from csm_torch.ops.flash_attention import FLASH_MIN_SEQ

    quant = gen.params["backbone"]["w13"]
    int4 = isinstance(quant, dict) and "w4p" in quant
    want = dict.fromkeys(("decode_attention", "flash_attention_fwd", "int4_matmul",
                          "int4_dequant_route"), 0)
    results = []
    reset_counts()  # the window opens
    for sub, call, B in calls:
        outs = call()
        st = dict(gen.last_stats)
        want["decode_attention"] += decode_expected(args, st, kv_int8)
        want["flash_attention_fwd"] += (
            args.backbone.num_layers if st["prompt_bucket"] >= FLASH_MIN_SEQ else 0)
        if int4:
            k, d = int4_expected(args, st, B)
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
    """Drop a generator's weights from the card before the next load."""
    import gc

    import torch

    gen.params = None
    gc.collect()
    torch.cuda.empty_cache()


def phase_quantized(details):
    """The quantized path: int4 at CSM-1B width (generate and generate_batch,
    with launch counts held to what the path must launch) and at 8B width,
    then short runs of int8, int8-decoder and the int8 KV cache.  Returns
    the int4 kernel's launches in the CSM-1B int4 runs."""
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
    gen.generate("Warm up.", max_audio_length_ms=160)
    torch.cuda.reset_peak_memory_stats()
    got = drive("int4", gen, [
        ("int4_generate_short", lambda: [gen.generate("Hello from the port.",
                                                      max_audio_length_ms=2000)], 1),
        ("int4_generate_batch", lambda: gen.generate_batch(
            ["A first, short line.", "And a second line that is a little longer than it."],
            [0, 1], max_audio_length_ms=2000), 2),
    ], args, details, ("int4_matmul", "decode_attention"))
    int4_launches = got["int4_matmul"]
    details["int4_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
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
    gen.generate("Warm up.", max_audio_length_ms=160)
    torch.cuda.reset_peak_memory_stats()
    drive("int4_8b", gen, [("int4_8b_generate", lambda: [gen.generate(
        "The eight billion flavor speaks.", max_audio_length_ms=1000)], 1)], args8, details,
        ("int4_matmul", "decode_attention"))
    details["int4_8b_peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"8B int4: load {details['int4_8b_load_s']:.1f} s, weights and codec "
        f"{details['int4_8b_weights_gib']:.2f} GiB, peak while loading "
        f"{details['int4_8b_load_peak_gib']:.2f} GiB, while generating "
        f"{details['int4_8b_peak_memory_gib']:.2f} GiB")
    free(gen)

    for mode, kw in (("int8", dict(quantize="int8")), ("int8_decoder", dict(quantize="int8-decoder")),
                     ("kv_int8", dict(kv_int8=True))):
        gen = load_csm(args=args, text_tokenizer=tok, **kw)
        gen.generate("Warm up.", max_audio_length_ms=160)
        drive(mode, gen, [(f"{mode}_generate", lambda: [gen.generate(
            "A short quantized line.", max_audio_length_ms=800)], 1)], args, details,
            ("decode_attention",), kv_int8=kw.get("kv_int8", False))
        free(gen)
    return int4_launches


# ---------------------------------------------------------------- phase 5


class Recording:
    def __init__(self, inner):
        self.inner, self.decoded = inner, []

    def encode(self, audio):
        return self.inner.encode(audio)

    def decode(self, codes):
        self.decoded.append(codes.copy())
        return self.inner.decode(codes)


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
        logs = build_all([dec.SOURCE, fa.SOURCE, i4.SOURCE])
        details["build_s"] = time.perf_counter() - t0
        ptxas = [ln.strip() for out in logs.values() for ln in out.splitlines()
                 if "registers" in ln or "spill" in ln]
        details["ptxas"] = ptxas
        log(f"kernels built in {details['build_s']:.1f} s; ptxas:")
        for ln in ptxas:
            log("  " + ln)

        dev = torch.device("cuda")
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        kernels = phase_kernels(dev, flush, details)
        del flush
        launches = phase_main_path(details)
        launches["int4_matmul"] = phase_quantized(details)
        for k in kernels:
            k["launches"] = launches[k["name"]]
        phase_reference(details)
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
