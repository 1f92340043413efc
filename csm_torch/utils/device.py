"""Device selection for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device`` defaults to ``"cuda"``, and a machine without a card raises
instead of falling back silently (the CPU tests pass ``device="cpu"``).
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device) -> torch.device:
    """``device`` (str or torch.device) → torch.device; raises when CUDA is
    asked for and no card is visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch sees no CUDA card; pass "
            "device='cpu' to run on the CPU"
        )
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device: the kernels' launch plans
    are sized from it."""
    return torch.cuda.get_device_properties(device).multi_processor_count
