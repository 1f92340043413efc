"""Start N ranks as child processes and collect what each returns.

The tests and ``chip_smoke.py`` run mesh programs through ``launch``: the
calling process starts every rank with ``subprocess`` and never joins a
process group itself, so it keeps no group, no changed environment and no
changed thread count.  Each rank gets an environment of its own (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``OMP_NUM_THREADS=1``),
sets ``torch.set_num_threads(1)``, meets the others through a file store in
the work directory (no TCP port), runs ``target(spec)`` and writes its
return value to ``out<rank>.pt``; the group is destroyed in a ``finally``.
If one rank fails, or the wall limit passes, every rank is killed and
``launch`` raises with the tails of their logs.

    outs = launch("csm_torch.parallel.witness:run", 2, tmp_dir, spec)

or, as a rank program's entry: ``python -m csm_torch.parallel.launch
TARGET STORE WORK_DIR INIT_TIMEOUT_S`` (what ``launch`` starts).
"""

from __future__ import annotations

import datetime
import importlib
import os
import sys
import time
import uuid
from pathlib import Path
from typing import Any, List

REPO = Path(__file__).resolve().parent.parent.parent


def launch(target: str, world_size: int, work_dir, spec: Any = None, timeout_s: float = 240.0,
           init_timeout_s: float = 120.0) -> List[Any]:
    """Run ``target`` ("module:function", called with ``spec``) on
    ``world_size`` ranks; returns each rank's return value, in rank order."""
    return start(target, world_size, work_dir, spec, timeout_s, init_timeout_s).wait()


class Ranks:
    """Ranks started by ``start``; ``wait()`` collects their results."""

    def __init__(self, procs, logs, work: Path, store: Path, deadline: float, timeout_s: float):
        self.procs, self.logs, self.work, self.store = procs, logs, work, store
        self.deadline, self.timeout_s = deadline, timeout_s

    def wait(self) -> List[Any]:
        import torch

        procs, work = self.procs, self.work
        try:
            while True:
                rcs = [p.poll() for p in procs]
                if any(rc not in (None, 0) for rc in rcs):
                    raise RuntimeError(f"a rank failed (exit codes {rcs})")
                if all(rc == 0 for rc in rcs):
                    break
                if time.monotonic() > self.deadline:
                    raise TimeoutError(
                        f"ranks still running after {self.timeout_s:.0f} s (exit codes {rcs})")
                time.sleep(0.05)
        except (RuntimeError, TimeoutError) as e:
            self.kill()
            tails = "\n".join(f"--- rank {r} ---\n" + _tail(work / f"rank{r}.log")
                              for r in range(len(procs)))
            raise type(e)(f"{e}\n{tails}") from None
        finally:
            self.kill()
        return [torch.load(work / f"out{r}.pt", weights_only=False) for r in range(len(procs))]

    def kill(self) -> None:
        """Stop every rank still running and release the logs and store."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        for log in self.logs:
            log.close()
        if self.store.exists():
            self.store.unlink()


def start(target: str, world_size: int, work_dir, spec: Any = None, timeout_s: float = 240.0,
          init_timeout_s: float = 120.0) -> Ranks:
    """``launch`` without waiting: the ranks run while the caller works;
    ``.wait()`` (which raises as ``launch`` does) collects them."""
    import subprocess

    import torch

    work = Path(work_dir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    torch.save(spec, work / "spec.pt")
    store = work / f"store-{uuid.uuid4().hex}"
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK",
                         "LOCAL_WORLD_SIZE")}
    path = os.pathsep.join(p for p in (str(REPO), base.get("PYTHONPATH", "")) if p)
    procs, logs = [], []
    ranks = Ranks(procs, logs, work, store, time.monotonic() + timeout_s, timeout_s)
    try:
        for r in range(world_size):
            renv = dict(base, RANK=str(r), WORLD_SIZE=str(world_size),
                        LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world_size),
                        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=path)
            log = open(work / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "csm_torch.parallel.launch", target, str(store),
                 str(work), str(init_timeout_s)],
                env=renv, cwd=str(REPO), stdout=log, stderr=subprocess.STDOUT))
    except BaseException:
        ranks.kill()
        raise
    return ranks


def _tail(path: Path, n: int = 4000) -> str:
    try:
        return path.read_text(errors="replace")[-n:]
    except OSError:
        return ""


def _rank_main(target: str, store: str, work_dir: str, init_timeout_s: float) -> None:
    import torch
    import torch.distributed as dist

    from csm_torch.parallel.distributed import backend_for, rank_device

    torch.set_num_threads(1)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    spec = torch.load(Path(work_dir) / "spec.pt", weights_only=False)
    device = rank_device((spec or {}).get("device", "cpu") if isinstance(spec, dict) else "cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend=backend_for(device), init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=init_timeout_s))
    try:
        mod, fn = target.split(":")
        out = getattr(importlib.import_module(mod), fn)(spec)
        tmp = Path(work_dir) / f"out{rank}.pt.tmp"
        torch.save(out, tmp)
        os.replace(tmp, Path(work_dir) / f"out{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4]))
