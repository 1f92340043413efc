"""Probe: does a hand-written M=1 matvec stream the CSM-1B backbone's decode
weights faster than ``torch.matmul`` (cuBLAS) at M=1?

The port of ``scripts/bench_matvec_pallas.py``.  Every variant runs the same
L-layer body (the fused qkv and gate-up projections of one backbone decode
step at B=1, attention stood in by a cheap reduction: the probe times weight
streaming, not attention):

  stacked   ``torch.matmul`` over views of (L, K, N) stacked weights
            (the JAX script's ``scan_xla``);
  unrolled  ``torch.matmul`` over per-layer weight buffers;
  kernel    per-layer buffers through ``ops.matvec.matvec``
            (``csrc/matvec.cu``): 4·L launches per pass.

At CSM-1B width, L=16 layers read 1.95 GB of bf16 weights a pass: 0.58 ms at
3.35 TB/s.  A pass is timed in device time (CUDA events) as one CUDA graph
replayed ``n`` times, each replay reading the previous one's output, so that
Python's dispatch of the ~20 small launches of a layer does not enter the
time.  On the CPU the probe checks parity and the chain and times nothing.

Repairs over the JAX script, whose chain reaches inf/NaN by layer ~5 and
fails its parity check before timing anything: the carried h is
RMS-normalised back to the input's scale after every layer (outside
``body``, so the weight stream is unchanged), which keeps a pass and the
chain of passes finite; parity is relative, max|got − ref| / max|ref|, and
taken layer by layer from the reference chain's input to each layer; one
variant list serves the parity check and the timing.  Layer by layer,
because the sum stand-in adds one scalar, a 1024-term sum that lies near
zero in some layers, to every attention output: its sign sets the
direction of the next h, so one-ulp differences in the projections can
turn a whole pass while every layer agrees.

    python -m csm_torch.scripts.bench_matvec [--layers 16] [--iters 50]
"""

from __future__ import annotations

import argparse
import json

import torch
import torch.nn.functional as F

from csm_torch.ops import matvec as mv_op
from csm_torch.utils.device import resolve_device

CSM_1B = dict(E=2048, I=8192, QD=2048, KVD=512)
I, QD = CSM_1B["I"], CSM_1B["QD"]
NAMES = ("wqkv", "wo", "w13", "w2")
VARIANTS = ("stacked", "unrolled", "kernel")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# Parity of one layer, relative to max|ref|.  bf16: every projection's output
# is rounded to bf16 (2**-9 relative), and cuBLAS and the kernel sum in other
# orders, so an output that lies near a rounding boundary differs by one
# ulp; through the sum stand-in and the layer's three other projections
# those differences reached 3.3e-3 of the largest output on the CPU
# (torch.matmul against the plain matvec) and 5.2e-3 on an H100 (cuBLAS
# against the kernel).  float32: one rounding of each sum.
PARITY_RTOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def body(h, wqkv, wo, w13, w2, mv, qd=QD, i=I):
    """One layer: the JAX script's ``_body`` with the ``jnp.sum`` stand-in
    for attention kept."""
    qkv = mv(h, wqkv)
    a = qkv[:, :qd] + qkv[:, qd:].sum()
    h = h + mv(a, wo)
    g13 = mv(h, w13)
    g = F.silu(g13[:, :i]) * g13[:, i:]
    return h + mv(g, w2)


def _rms(h):
    return h.float().pow(2).mean().sqrt().clamp_min(1e-30)


def _renorm(h, scale):
    return (h.float() * (scale / _rms(h))).to(h.dtype)


def forward(x, layers, mv, qd=QD, i=I):
    """L layers of ``body``, h brought back to x's RMS after each."""
    scale = _rms(x)
    h = x
    for lp in layers:
        h = _renorm(body(h, *lp, mv, qd, i), scale)
    return h


def shapes(widths: dict) -> dict:
    E_, I_, QD_, KVD = (widths[k] for k in ("E", "I", "QD", "KVD"))
    return {"wqkv": (E_, QD_ + 2 * KVD), "wo": (QD_, E_), "w13": (E_, 2 * I_), "w2": (I_, E_)}


def _graph_ms(x0, layers, mv, qd, i, n):
    """Device ms of one pass: the pass captured as a CUDA graph that reads
    and overwrites one buffer, replayed ``n`` times between two events.
    Returns (ms, the chain's last output)."""
    buf = x0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up outside the capture, as CUDA graphs need
        for _ in range(2):
            buf.copy_(forward(buf, layers, mv, qd, i))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        buf.copy_(forward(buf, layers, mv, qd, i))
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, buf


def run(device="cuda", widths=CSM_1B, L=16, n=50, dtype=torch.bfloat16, seed=0) -> dict:
    """Parity of every variant against ``stacked`` layer by layer, the
    kernel's launches in one pass, then each variant's chained device time
    (CUDA only) with its output finite."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shp = shapes(widths)
    qd, i = widths["QD"], widths["I"]
    stacked = {k: (torch.randn((L, *s), generator=gen, device=dev, dtype=dtype) * 0.02)
               for k, s in shp.items()}
    per_layer = [tuple(stacked[k][l].clone() for k in NAMES) for l in range(L)]
    runs = {"stacked": ([tuple(stacked[k][l] for k in NAMES) for l in range(L)], torch.matmul),
            "unrolled": (per_layer, torch.matmul),
            "kernel": (per_layer, mv_op.matvec)}
    x0 = torch.randn(1, widths["E"], generator=gen, device=dev, dtype=dtype) * 0.02
    weight_bytes = L * sum(a * b for a, b in shp.values()) * x0.element_size()
    res = {"device": str(dev), "layers": L, "dtype": str(dtype), "weight_bytes": weight_bytes,
           "bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3, "variants": {}}

    # the reference pass: each layer's input and output
    inputs, ref = [], []
    h, scale = x0, _rms(x0)
    for lp in runs["stacked"][0]:
        inputs.append(h)
        ref.append(body(h, *lp, torch.matmul, qd, i).float())
        h = _renorm(ref[-1].to(dtype), scale)
    for name in VARIANTS:  # every layer of a variant from the reference's input
        layers, mv = runs[name]
        before = mv_op.launches
        got = [body(h, *lp, mv, qd, i).float() for h, lp in zip(inputs, layers)]
        launched = mv_op.launches - before
        err = max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))
        if not (all(torch.isfinite(g).all() for g in got) and err <= PARITY_RTOL[dtype]):
            raise AssertionError(f"bench_matvec {name}: parity {err:.3e} against stacked "
                                 f"(tolerance {PARITY_RTOL[dtype]})")
        res["variants"][name] = {"parity": err}
        if name == "kernel":
            res["launches_per_pass"] = launched
    if dev.type == "cuda" and res["launches_per_pass"] != 4 * L:
        raise AssertionError(f"bench_matvec: {res['launches_per_pass']} kernel launches in a "
                             f"pass, want {4 * L}")

    for name in VARIANTS:
        layers, mv = runs[name]
        if dev.type == "cuda":
            ms, out = _graph_ms(x0, layers, mv, qd, i, n)
            gbs = weight_bytes / (ms / 1e3) / 1e9
            res["variants"][name].update(ms=ms, GBps=gbs, share_of_hbm=gbs * 1e9 / HBM_BYTES_PER_S)
        else:  # the chain on the host: finite, not timed
            out = x0
            for _ in range(n):
                out = forward(out, layers, mv, qd, i)
        if not torch.isfinite(out.float()).all():
            raise AssertionError(f"bench_matvec {name}: the chain of {n} passes is not finite")
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layers", type=int, default=16)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    res = run(a.device, L=a.layers, n=a.iters)
    if res["device"].startswith("cuda"):
        res["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(res, indent=1))
    for name, v in res["variants"].items():
        if "ms" in v:
            print(f"{name:>9}: {v['ms']:.4f} ms, {v['GBps']:.1f} GB/s "
                  f"({100 * v['share_of_hbm']:.1f} % of 3.35 TB/s), parity {v['parity']:.2e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
