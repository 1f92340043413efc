#!/usr/bin/env python3
"""Frames/s of the port's ``Generator.generate`` from two source trees, in turns.

    python3 port_ab.py --other DIR [--modes none,int4] [--repeats 3]

``DIR`` is another checkout of this repository (e.g. an unpacked
``git archive`` of a parent commit).  Each run is a fresh process on the
card that loads CSM-1B on random weights (seed 0) in one weight mode, warms
up, then times ``repeats`` generates of 2000 ms of audio (prompt bucket 64,
B=1, topk 50).  The order is other, this, this, other for bf16 and, for the
other modes (this tree only), mode, bf16, bf16, mode in the middle, so drift
of the host's speed cancels in the comparison.  Each run prints one JSON
line; the card's name and power limit come first, a summary of medians
last, and everything goes to chiprun_out/port_ab.json.
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
gen.generate("Warm up.", max_audio_length_ms=160)
runs = []
for _ in range(repeats):
    gen.generate("Hello from the port.", max_audio_length_ms=2000)
    runs.append({k: gen.last_stats[k] for k in ("frames_per_s", "prefill_s", "generate_s", "frames")})
print(json.dumps({"mode": mode, "runs": runs}))
"""


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
    a = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    other = a.other.resolve()
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
