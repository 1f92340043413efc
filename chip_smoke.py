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
     counts held to what the path must launch;
  5. a tiny float32 model generates on the card and on the CPU (where the
     wrappers run the plain versions): codes equal, audio close.

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
    attention inputs cold: each frame streams ~3 GB of weights)."""
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
    details["kernel_rows"] = rows
    log(f"{'kernel':<20} {'shape':<58} {'ms':>8} {'plain':>8} {'sdpa':>8} {'bound':>8} err")
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
    ]


# ---------------------------------------------------------------- phase 4


LONG_TEXT = (
    "This prompt is long enough that its byte tokens fill more than one "
    "hundred and twenty eight positions, so the prompt pads to the 256 "
    "bucket and the prefill attends through the flash kernel."
)


def phase_main_path(details):
    """Generator.generate / generate_batch at CSM-1B width; returns the
    launch counts of the run."""
    import numpy as np
    import torch

    from csm_torch import csm_1b_args, load_csm
    from csm_torch.data.tokenizers import ByteTokenizer
    from csm_torch.ops import decode_attention as dec
    from csm_torch.ops import flash_attention as fa

    args = csm_1b_args()
    t0 = time.perf_counter()
    gen = load_csm(args=args, compute_dtype=torch.bfloat16, text_tokenizer=ByteTokenizer())
    torch.cuda.synchronize()
    details["load_s"] = time.perf_counter() - t0
    gen.generate("Warm up.", max_audio_length_ms=160)  # first-call set-up, outside the count

    K, L_bb, L_dec = args.audio_num_codebooks, args.backbone.num_layers, args.decoder.num_layers
    calls = [
        ("generate_short", lambda: [gen.generate("Hello from the port.", max_audio_length_ms=2000)]),
        ("generate_long", lambda: [gen.generate(LONG_TEXT, speaker=1, max_audio_length_ms=2000)]),
        ("generate_batch", lambda: gen.generate_batch(
            ["A first, short line.", "And a second line that is a little longer than it."],
            [0, 1], max_audio_length_ms=2000)),
    ]
    expect_dec = expect_flash = 0
    runs = {}
    dec.launches = fa.launches = 0  # the main path's window opens
    for name, call in calls:
        outs = call()
        st = dict(gen.last_stats)
        expect_dec += (K - 2) * L_dec * (st["steps"] + 1) + L_bb * st["steps"]
        expect_flash += L_bb if st["prompt_bucket"] >= 256 else 0
        runs[name] = (outs, st)
    launches = {"decode_attention": dec.launches, "flash_attention_fwd": fa.launches}
    # the window closes: checks below launch nothing
    want = {"decode_attention": expect_dec, "flash_attention_fwd": expect_flash}
    if launches != want or not all(launches.values()):
        raise AssertionError(f"kernel launches {launches}, the path needs {want}")

    spf = 1920
    for name, (outs, st) in runs.items():
        total = 0
        for audio in outs:
            if not (audio.dtype == np.float32 and audio.ndim == 1 and np.isfinite(audio).all()):
                raise AssertionError(f"{name}: audio not finite float32 mono")
            if len(audio) % spf or not 0 < len(audio) <= 25 * spf:
                raise AssertionError(f"{name}: {len(audio)} samples is not 1..25 frames")
            total += len(audio) // spf
        if total != st["frames"]:
            raise AssertionError(f"{name}: {total} frames of audio, {st['frames']} generated")
        log(f"{name} on {details['card']}: bucket {st['prompt_bucket']}, {st['frames']} frames, prefill "
            f"{st['prefill_s'] * 1e3:.1f} ms, {st['frames_per_s']:.2f} frames/s, "
            f"generate {st['generate_s']:.3f} s, mimi {st['decode_s']:.3f} s, RTF {st['rtf']:.3f}")
        details[name] = st
    details["launches"] = launches
    details["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    profile_generate(gen, details)
    return launches


def profile_generate(gen, details):
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
    details["profile"] = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if busy_ms else "not measured",
        "top_kernels": [(e.key[:90], e.count, e.self_device_time_total / 1e3) for e in top],
    }
    log(f"profile: generate of 10 frames {wall_ms:.1f} ms wall, kernels {busy_ms:.1f} ms "
        f"({len(kernels)} kinds)")
    for name, count, ms in details["profile"]["top_kernels"]:
        log(f"  {ms:9.3f} ms {count:6d}x {name}")


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
    same weights: the card runs the kernels, the CPU their plain versions.
    At topk=1 the codes are equal; audio agrees to 1e-4 (float32 with TF32
    off on the card; measured differences are float32 rounding)."""
    import dataclasses

    import numpy as np
    import torch

    from csm_torch.codec.mimi import CSM_MIMI_CONFIG, mimi_init
    from csm_torch.codec.transformer import MimiTransformerConfig
    from csm_torch.data.tokenizers import ByteTokenizer, MimiAudioTokenizer
    from csm_torch.generator import Generator
    from csm_torch.models.config import tiny_test_args
    from csm_torch.utils.params import random_csm_params, tree_map

    # float32 on the card in full float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = tiny_test_args()
    cfg = dataclasses.replace(CSM_MIMI_CONFIG, transformer=MimiTransformerConfig(num_layers=2))
    params = random_csm_params(args, seed=0)
    mimi = mimi_init(torch.Generator().manual_seed(1), cfg)

    def to(tree, dev):
        return tree_map(lambda t: t.to(dev), tree)

    outs = {}
    for dev in ("cpu", "cuda"):
        g = Generator(to(params, dev), args,
                      mimi=Recording(MimiAudioTokenizer(to(mimi, dev), cfg)),
                      text_tokenizer=ByteTokenizer(), compute_dtype=torch.float32, device=dev)
        texts = ["tiny reference", "and a second, longer reference line"]
        audio = g.generate_batch(texts, [0, 1], max_audio_length_ms=800, topk=1)
        outs[dev] = (audio, g.mimi.decoded)
    (a_cpu, c_cpu), (a_gpu, c_gpu) = outs["cpu"], outs["cuda"]
    for x, y in zip(c_cpu, c_gpu):
        np.testing.assert_array_equal(y, x)
    err = 0.0
    for x, y in zip(a_cpu, a_gpu):
        np.testing.assert_allclose(y, x, atol=1e-4, rtol=1e-3)
        err = max(err, float(np.abs(y - x).max()))
    details["reference"] = {"frames": [c.shape[1] for c in c_gpu], "audio_max_abs_err": err}
    log(f"reference: codes equal over {sum(c.shape[1] for c in c_gpu)} frames, "
        f"audio max |card - cpu| = {err:.2e}")


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
        logs = build_all([dec.SOURCE, fa.SOURCE])
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
