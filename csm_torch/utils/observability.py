"""Observability: a JSONL metrics sink, a card-memory snapshot and a
profiler trace.

``MetricsLogger`` is the JAX package's (one JSON line per step, any
dashboard can tail it); ``device_memory_stats`` takes the place of its
``hbm_stats``, from PyTorch's caching allocator; ``profile_trace`` takes
the place of its ``jax.profiler`` trace, with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict

import torch


def device_memory_stats(device=None) -> Dict[str, float]:
    """Card memory in MiB: ``allocated_mib``, ``peak_allocated_mib``
    (``torch.cuda.max_memory_allocated``) and ``reserved_mib``
    (``memory_reserved``).  ``{}`` for a CPU device."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type != "cuda":
        return {}
    if not torch.cuda.is_available():
        return {}
    mib = float(1 << 20)
    return {
        "allocated_mib": torch.cuda.memory_allocated(dev) / mib,
        "peak_allocated_mib": torch.cuda.max_memory_allocated(dev) / mib,
        "reserved_mib": torch.cuda.memory_reserved(dev) / mib,
    }


class MetricsLogger:
    """Append-only JSONL metrics (step, wall time, arbitrary scalars).  The
    file opens at the first ``log`` after construction or ``close``."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._t0 = time.time()
        self._f = None

    def log(self, step: int, **scalars):
        if self._f is None:
            self._f = open(self.path, "a", buffering=1)
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def profile_trace(log_dir: str, enabled: bool = True):
    """A ``torch.profiler`` trace of the body of the block (host and, where
    there is a card, its kernels), written to ``log_dir`` as a Chrome
    trace (open in Perfetto or TensorBoard):

        with profile_trace("csm_profile"):
            generator.generate(...)
    """
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
