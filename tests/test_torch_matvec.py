"""The M=1 matvec and its probe: the port's ``ops/matvec.py`` (plain version
and wrapper on CPU tensors) and ``csm_torch/scripts/bench_matvec.py`` held
against ``scripts/bench_matvec_pallas.py``, whose Pallas kernel
``_matvec_kernel`` runs in interpret mode on the CPU.  The CUDA kernel itself
is held against the plain version on a card (tests/test_torch_cuda.py).

The JAX script reads ``CSM_PROBE_INTERPRET`` when ``matvec_pallas`` is
traced and passes ``interpret=`` itself, so the variable is set before the
first trace; the script sets ``jax_compilation_cache_dir`` when imported,
which is restored afterwards.  Tolerances: float32 1e-5, relative and of
the output's RMS for outputs near zero (float32 sums of up to 1024 terms in
another order); bf16 one bf16 ulp (rtol 2**-7) and the same atol, since both
sides accumulate in float32 and round the output once.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_torch.ops import matvec as tmv
from csm_torch.scripts import bench_matvec as tprobe

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(E=128, I=128, QD=128, KVD=64)  # every N a multiple of the Pallas 128-column block


@pytest.fixture(scope="module")
def probe():
    """scripts/bench_matvec_pallas.py as a module, its kernel interpreted."""
    old = jax.config.jax_compilation_cache_dir
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CSM_PROBE_INTERPRET", "1")
        spec = importlib.util.spec_from_file_location(
            "bench_matvec_pallas", ROOT / "scripts" / "bench_matvec_pallas.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        try:
            yield mod
        finally:
            jax.config.update("jax_compilation_cache_dir", old)


def _inputs(K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5), ("bfloat16", 2**-7)])
@pytest.mark.parametrize("K,N", [(256, 384), (512, 128), (1024, 256)])
def test_matvec_matches_pallas_kernel(probe, dtype, rtol, K, N):
    x, w = _inputs(K, N)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(probe.matvec_pallas(jnp.asarray(x, jdt), jnp.asarray(w, jdt)), np.float32)
    atol = 1e-5 * np.sqrt(np.mean(want**2))
    tx, tw = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    for got in (tmv.matvec_plain(tx, tw), tmv.matvec(tx, tw)):
        assert got.dtype == tdt and got.shape == (1, N)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol, atol=atol)


def _layer(seed=0):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal(s) * 0.02).astype(np.float32)
          for s in tprobe.shapes(TINY).values()]
    h = (rng.standard_normal((1, TINY["E"])) * 0.02).astype(np.float32)
    return h, ws


@pytest.mark.parametrize("mv", ["matmul", "matvec"])
def test_body_matches_jax_body(probe, monkeypatch, mv):
    """One layer of the port's body against the JAX ``_body`` at small
    widths (the module's QD and I patched), float32, through the library
    matmul on each side or through the matvec on each side."""
    monkeypatch.setattr(probe, "QD", TINY["QD"])
    monkeypatch.setattr(probe, "I", TINY["I"])
    h, ws = _layer()
    jmv = jnp.matmul if mv == "matmul" else probe.matvec_pallas
    tmv_fn = torch.matmul if mv == "matmul" else tmv.matvec
    want = np.asarray(probe._body(jnp.asarray(h), *map(jnp.asarray, ws), jmv))
    got = tprobe.body(torch.from_numpy(h), *map(torch.from_numpy, ws), tmv_fn,
                      TINY["QD"], TINY["I"])
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_probe_runs_on_cpu_at_tiny_width(dtype):
    """Every variant agrees with ``stacked``, the chain stays finite, and
    the CPU launches nothing and times nothing."""
    res = tprobe.run("cpu", widths=TINY, L=4, n=20, dtype=dtype)
    assert set(res["variants"]) == set(tprobe.VARIANTS)
    for v in res["variants"].values():
        assert v["parity"] <= tprobe.PARITY_RTOL[dtype] and "ms" not in v
    assert res["launches_per_pass"] == 0
    assert res["weight_bytes"] == 4 * sum(a * b for a, b in tprobe.shapes(TINY).values()) \
        * torch.empty((), dtype=dtype).element_size()


def test_forward_keeps_the_input_scale():
    """The renormalised chain: every pass returns h at the input's RMS,
    where the unnormalised body grows layer by layer."""
    h, ws = _layer()
    x = torch.from_numpy(h)
    layers = [tuple(map(torch.from_numpy, ws))] * 8
    out = tprobe.forward(x, layers, torch.matmul, TINY["QD"], TINY["I"])
    rms = lambda t: t.pow(2).mean().sqrt().item()  # noqa: E731
    assert rms(out) == pytest.approx(rms(x), rel=1e-5)
    raw = x
    for lp in layers:
        raw = tprobe.body(raw, *lp, torch.matmul, TINY["QD"], TINY["I"])
    assert rms(raw) > 10 * rms(x)


def _matvec_plan_shapes():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)  # stdlib only at import: its shape tables
    shapes = [(K, N) for _, K, N in chip_smoke.MATVEC_SHAPES]
    return shapes + [(37, 1000), (300, 8), (2080, 2048), (4000, 3072), (1000, 16384), (8288, 384)]


@pytest.mark.parametrize("elem_bytes", [2, 4])
@pytest.mark.parametrize("K,N", _matvec_plan_shapes())
def test_matvec_plan_covers_K(K, N, elem_bytes):
    """At phase 3's shapes and the card tests' uneven ones, on the H100's
    132 SMs: a block's span is 512 bytes of a row; the cluster's ranks take
    whole stages that cover K exactly, in order, none empty; at most 16
    ranks; one wave of blocks at most, the card filled where K and the
    cluster limit allow; and the plan reads shapes only."""
    plan = tmv.matvec_plan(K, N, elem_bytes, 132)
    assert plan.span * elem_bytes == tmv.SPAN_BYTES and 1 <= plan.cluster <= tmv.MAX_CLUSTER
    shares = tmv.matvec_shares(K, plan)
    assert len(shares) == plan.cluster and shares[0][0] == 0 and shares[-1][1] == K
    assert all(a < b and a % plan.stage_rows == 0 for a, b in shares)
    assert all(shares[i][1] == shares[i + 1][0] for i in range(len(shares) - 1))
    spans, stages = -(-N // plan.span), -(-K // plan.stage_rows)
    assert spans * plan.cluster <= 132 or plan.cluster == 1
    assert spans * (plan.cluster + 1) > 132 or plan.cluster == min(tmv.MAX_CLUSTER, stages)
    assert tmv.matvec_plan(K, N, elem_bytes, 132) == plan


def test_matvec_wrapper_checks_inputs_and_counts_only_launches():
    x, w = map(torch.from_numpy, _inputs(64, 32))
    n = tmv.launches
    assert torch.equal(tmv.matvec(x, w), tmv.matvec_plain(x, w))  # CPU: the plain version
    assert tmv.launches == n
    for bad_x, bad_w, match in (
        (x.expand(2, 64), w, r"\(1, K\)"),
        (x, w[:32], r"\(1, K\)"),
        (x.half(), w.half(), "float32 or bfloat16"),
        (x, w.bfloat16(), "float32 or bfloat16"),
        (x, w[:, :20].contiguous(), "multiple of 8"),
        (x, w.t().contiguous().t(), "contiguous"),
        (x, w.to("meta"), "is on"),
    ):
        with pytest.raises(ValueError, match=match):
            tmv.matvec(bad_x, bad_w)
    long_x = torch.zeros(1, tmv.MAX_X_BYTES // 4 + 8)
    with pytest.raises(ValueError, match="too long"):
        tmv.matvec(long_x, torch.zeros(long_x.shape[1], 8))
    with pytest.raises(ValueError, match="unsupported device"):
        tmv.matvec(x.to("meta"), w.to("meta"))
    assert tmv.launches == n
