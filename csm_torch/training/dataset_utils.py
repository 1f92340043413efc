"""Dataset → batch-stream adaptation for the trainers (pure Python, as in
the JAX package)."""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

from csm_torch.training.losses import Batch


def as_batches(dataset, batch_size: int, shuffle: bool = True, seed: int = 0) -> Iterable[Batch]:
    """Accepts a CSMDataset, a list of prebuilt ``Batch``es, a callable
    returning an iterable, or any iterable of Batches."""
    if dataset is None:
        return []
    if isinstance(dataset, (list, tuple)):
        return dataset
    from csm_torch.data.dataset import CSMDataset, batch_iterator

    if isinstance(dataset, CSMDataset):
        return batch_iterator(dataset, batch_size, shuffle=shuffle, seed=seed)
    if callable(dataset):
        return dataset()
    return dataset


def prefetch_batches(batches: Iterable[Batch], depth: int = 2) -> Iterator[Batch]:
    """Run the batch source on a background thread, keeping up to
    ``depth`` collated batches ready ahead of the consumer.

    Host-side batch construction (shuffle, pad-to-bucket, stack) overlaps
    device compute.  Order and content are identical to iterating
    ``batches`` directly; source exceptions re-raise at the consuming site.
    Abandoning the iterator early (e.g. ``break``) releases the feeder
    thread."""
    if depth <= 0:
        yield from batches
        return
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END = object()
    err: list[BaseException] = []

    def feed():
        try:
            for b in batches:
                while not stop.is_set():
                    try:
                        q.put(b, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:
            err.append(e)
        finally:
            # the sentinel must land even through a momentarily full queue;
            # give up once the consumer has signalled it is gone
            while not stop.is_set():
                try:
                    q.put(_END, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=feed, daemon=True, name="batch-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
