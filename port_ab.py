#!/usr/bin/env python3
"""Frames/s of the port's ``Generator.generate``, or its kernels, from two
source trees, in turns.

    python3 port_ab.py --other DIR [--modes none,int4] [--repeats 3]
    python3 port_ab.py --other DIR --kernels

``DIR`` is another checkout of this repository (e.g. an unpacked
``git archive`` of a parent commit).  Each run is a fresh process on the
card that loads CSM-1B on random weights (seed 0) in one weight mode, warms
up with a generate of the timed shape (which captures its CUDA graphs in a
tree that has them), then times ``repeats`` generates of 2000 ms of audio
(prompt bucket 64, B=1, topk 50).  The order is other, this, this, other for bf16 and, for the
other modes (this tree only), mode, bf16, bf16, mode in the middle, so drift
of the host's speed cancels in the comparison.  Each run prints one JSON
line; the card's name and power limit come first, a summary of medians
last, and everything goes to chiprun_out/port_ab.json.

With ``--kernels`` each run instead times, in bf16 at the main path's
shapes (median of 30 launches, each after a 256 MB write that evicts the
L2): decode attention at every shape of ``chip_smoke.py``'s phase 3
(``DECODE_SHAPES``, inputs from ``chip_smoke.decode_case`` of this tree
in both runs) beside a launch floor (a one-element ``zero_()``), the flash
forward, the flash backward pair, the int4 matmul, and the matvec at
``chip_smoke.MATVEC_SHAPES`` plus the 16-layer probe pass
(``csm_torch.scripts.bench_matvec.run``: kernel and ``torch.matmul``
passes).  It saves the backward's gradients and the int4 outputs from
fixed numpy inputs; the order is other, this, this, other.  The summary
gives each tree's median ms per kernel and shape, and whether the two
trees' backward gradients and int4 outputs are equal bit for bit
(chiprun_out/port_ab_kernels.json); it exits 1 if they are not.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

WORKER = r"""
import json, sys, torch
from csm_torch import csm_1b_args, load_csm
from csm_torch.data.tokenizers import ByteTokenizer
mode, repeats = sys.argv[1], int(sys.argv[2])
kw = {} if mode == "none" else {"quantize": mode}
gen = load_csm(args=csm_1b_args(), text_tokenizer=ByteTokenizer(), **kw)
gen.generate("Warm up.", max_audio_length_ms=2000)  # the timed key: captures its graphs
runs = []
for _ in range(repeats):
    gen.generate("Hello from the port.", max_audio_length_ms=2000)
    runs.append({k: gen.last_stats[k] for k in ("frames_per_s", "prefill_s", "generate_s", "frames")})
print(json.dumps({"mode": mode, "runs": runs}))
"""


KERNEL_WORKER = r"""
import hashlib, importlib.util, json, statistics, sys, numpy as np, torch
from csm_torch.ops import decode_attention as dec, flash_attention as fa, int4_matmul as i4
from csm_torch.ops import matvec as mv
from csm_torch.scripts import bench_matvec
from csm_torch.utils.quantize import quantize_weight_int4
spec = importlib.util.spec_from_file_location("chip_smoke_shapes", sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)  # this tree's shapes and inputs, whichever tree runs
dev = torch.device("cuda")
flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
def timed(fn, n=30):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in ev:
        flush.zero_(); a.record(); fn(); b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)
sha = lambda t: hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
rng = np.random.default_rng(0)
bf = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev, torch.bfloat16)
times, grads, int4_out = {}, {}, {}
z = torch.zeros(1, device=dev)
times["launch floor"] = timed(z.zero_)
gen = torch.Generator(device=dev).manual_seed(0)
for shape in cs.DECODE_SHAPES:
    q, k, v, mask = cs.decode_case(**shape, gen=gen, dev=dev)
    times[f"decode {json.dumps(shape)}"] = timed(lambda: dec.decode_gqa_attention(q, k, v, mask))
for B, S, T in ((1, 256, 281), (2, 512, 512), (2, 2048, 2048)):
    q, k, v, g = bf(B, S, 32, 64), bf(B, T, 8, 64), bf(B, T, 8, 64), bf(B, S, 32, 64)
    q_pos = torch.arange(T - S, T, dtype=torch.int32, device=dev).expand(B, S).contiguous()
    kv_pos = torch.arange(T, dtype=torch.int32, device=dev)
    times[f"flash_fwd B={B} S={S} T={T}"] = timed(lambda: fa.flash_attention_fwd(q, k, v, q_pos, kv_pos))
    out, lse = fa.flash_attention_plain(q.float(), k.float(), v.float(), q_pos, kv_pos)
    out = out.to(torch.bfloat16)  # float32 plain: the same bytes in either tree
    delta = fa.bwd_delta(out, g)
    args = (q, k, v, q_pos, kv_pos, g, lse, delta)
    got = [fa.flash_attention_bwd_dq(*args), *fa.flash_attention_bwd_dkv(*args)]
    grads[f"B={B} S={S} T={T}"] = [sha(t) for t in got]
    if S == T:
        times[f"flash_bwd_dq B={B} S={S}"] = timed(lambda: fa.flash_attention_bwd_dq(*args))
        times[f"flash_bwd_dkv B={B} S={S}"] = timed(lambda: fa.flash_attention_bwd_dkv(*args))
for name, K, N, M in (("backbone w13", 2048, 16384, 1), ("backbone w13", 2048, 16384, 64),
                      ("backbone wo", 2048, 2048, 1), ("decoder wqkv", 1024, 1536, 1),
                      ("decoder wo", 1024, 1024, 1), ("decoder w2", 8192, 1024, 1),
                      ("decoder w13", 1024, 16384, 1)):
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32) / K**0.5).to(dev)
    qw = quantize_weight_int4(w.to(torch.bfloat16))
    x = bf(M, K)
    int4_out[f"{name} M={M}"] = sha(i4.fused_int4_matmul(x, qw))
    times[f"int4 {name} M={M}"] = timed(lambda: i4.fused_int4_matmul(x, qw))
for proj, K, N in cs.MATVEC_SHAPES:
    x, w = bf(1, K), bf(K, N)
    times[f"matvec {proj} K={K} N={N}"] = timed(lambda: mv.matvec(x, w))
    times[f"torch.matmul {proj} K={K} N={N}"] = timed(lambda: x @ w)
del x, w
probe = bench_matvec.run("cuda", L=16, n=50)
times["matvec probe pass (16 layers)"] = probe["variants"]["kernel"]["ms"]
times["torch.matmul probe pass (16 layers)"] = probe["variants"]["unrolled"]["ms"]
torch.cuda.synchronize()
print(json.dumps({"ms": times, "grads_sha256": grads, "int4_sha256": int4_out}))
"""


def run_kernels(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", KERNEL_WORKER, str(ROOT / "chip_smoke.py")],
                         cwd=root, env=env,
                         capture_output=True, text=True, timeout=1200)
    if res.returncode:
        raise RuntimeError(f"{root} kernels failed:\n{res.stdout}\n{res.stderr}")
    out = {"tree": "this" if root == ROOT else "other",
           **json.loads(res.stdout.strip().splitlines()[-1])}
    print(json.dumps(out), flush=True)
    return out


def main_kernels(other: Path, card: str) -> int:
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    results = [run_kernels(root) for root in (other, ROOT, ROOT, other)]
    summary = {}
    for r in results:
        for key, ms in r["ms"].items():
            summary.setdefault(key, {}).setdefault(r["tree"], []).append(ms)
    summary = {k: {t: statistics.median(v) for t, v in d.items()} for k, d in summary.items()}
    same = {}
    for what in ("grads_sha256", "int4_sha256"):
        a, b = (results[i].get(what, {}) for i in (0, 1))
        same.update({f"{what} {k}": a.get(k) == b[k] for k in b})
    report = {"card": card, "results": results, "median_ms": summary, "bit_equal": same}
    (out_dir / "port_ab_kernels.json").write_text(json.dumps(report, indent=1))
    for key, d in summary.items():
        print(f"{key:<72} other {d['other']:.5f} ms   this {d['this']:.5f} ms", flush=True)
    print(json.dumps({"card": card, "bit_equal": same}))
    return 0 if all(same.values()) else 1


def run(root: Path, mode: str, repeats: int) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    res = subprocess.run([sys.executable, "-c", WORKER, mode, str(repeats)], cwd=root, env=env,
                         capture_output=True, text=True, timeout=900)
    if res.returncode:
        raise RuntimeError(f"{root} {mode} failed:\n{res.stdout}\n{res.stderr}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["tree"] = "this" if root == ROOT else "other"
    out["median_frames_per_s"] = statistics.median(r["frames_per_s"] for r in out["runs"])
    print(json.dumps(out), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--modes", default="none,int4")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--kernels", action="store_true", help="time the kernels, not generate")
    a = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = a.other.resolve()
    if a.kernels:
        return main_kernels(other, card)
    extra = [m for m in a.modes.split(",") if m != "none"]
    order = [(other, "none")] + [(ROOT, m) for m in extra] + [(ROOT, "none"), (ROOT, "none")]
    order += [(ROOT, m) for m in extra] + [(other, "none")]
    results = [run(root, mode, a.repeats) for root, mode in order]
    summary = {}
    for r in results:
        summary.setdefault(f"{r['tree']} {r['mode']}", []).append(r["median_frames_per_s"])
    summary = {k: statistics.median(v) for k, v in summary.items()}
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "port_ab.json").write_text(
        json.dumps({"card": card, "results": results, "summary": summary}, indent=1))
    print(json.dumps({"card": card, "median_frames_per_s": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
