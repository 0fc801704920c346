"""Background prefetch of host batches: the single-device part of the JAX
package's ``parallel/mesh.py`` (``prefetch_to_device``). Its mesh, sharding
and multi-host functions are not ported yet.

``prefetch_to_device`` runs a host iterator (PNG decode, augmentation,
stacking) on a daemon thread, ``DEPTH`` batches ahead of the consumer, so
the host's work overlaps the train step's dispatch. With a CUDA ``device``
the thread also pins the batch's arrays. The host-to-device copy stays on the
consuming thread (``engine/trainer.py:to_device``), so no CUDA stream is
shared across threads.

Surplus pulls. The JAX package's worker pulls a batch, checks its stop flag,
then blocks putting the batch into a full queue. When the consumer stops
after N batches, the host iterator has been pulled up to N + DEPTH + 1 = N + 3
times: that many when the loader keeps ahead of the step, as few as N + 1
when the loader is the bottleneck. Each pull moves the loaders on (their
augmentation draw counter, the sampler's shuffles), so the next epoch's data
depends on that count. Here it
is always N + 3, the JAX count when its loader keeps ahead: closing the
generator waits until the worker has pulled its N + DEPTH + 1 batches, and the
worker checks the stop flag before each pull, so it never pulls once more
after the stop. ``DEPTH`` is fixed, not a parameter, because that count (and
so every later epoch's augmentations) holds only at the JAX package's depth.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterable, Iterator, Optional

import numpy as np
import torch

DEPTH = 2  # the JAX package's queue depth; the surplus is DEPTH + 1 pulls

_END = object()  # the worker's last item: the host iterator ended or was stopped


class _Failed:
    """The worker's last item when the host iterator raised."""

    def __init__(self, error: BaseException) -> None:
        self.error = error


def _pin_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """The batch with every numpy array as a pinned CPU tensor; other values
    (group names, file names) pass through."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            if isinstance(v, np.ndarray) else v for k, v in batch.items()}


def prefetch_to_device(host_iter: Iterable[Dict[str, Any]],
                       device: Optional[torch.device] = None) -> Iterator[Dict[str, Any]]:
    """The batches of ``host_iter``, pulled on a background thread up to
    ``DEPTH`` ahead; pinned (``_pin_batch``) when ``device`` is a CUDA device.

    Close the generator (``contextlib.closing``) when the epoch is done: that
    waits until the host iterator has been pulled N + DEPTH + 1 times for the
    N batches consumed (the JAX package's count when its loader keeps ahead
    of the step), stops the thread and joins
    it. An exception of the host iterator is raised in the consumer, at the
    batch where it happened or, for a surplus pull, at the close."""
    pin = device is not None and torch.device(device).type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=DEPTH)
    stop = threading.Event()
    cond = threading.Condition()
    pulls = {"n": 0, "done": False}

    def finish(marker) -> None:
        with cond:  # before the put, which may block until the consumer drains
            pulls["done"] = True
            cond.notify_all()
        q.put(marker)

    def worker() -> None:
        try:
            if pin and torch.device(device).index is not None:
                torch.cuda.set_device(device)  # pin on the consumer's card, not card 0
            it = iter(host_iter)
            while not stop.is_set():
                try:
                    item = next(it)
                except StopIteration:
                    break
                with cond:
                    pulls["n"] += 1
                    cond.notify_all()
                q.put(_pin_batch(item) if pin else item)
        except BaseException as error:  # handed to the consumer, raised there
            finish(_Failed(error))
        else:
            finish(_END)

    thread = threading.Thread(target=worker, name="prefetch", daemon=True)
    thread.start()
    consumed, ended = 0, False
    try:
        while True:
            item = q.get()
            if item is _END or isinstance(item, _Failed):
                ended = True
                if item is _END:
                    return
                raise item.error
            consumed += 1
            yield item
    finally:
        if not ended:
            with cond:
                cond.wait_for(lambda: pulls["done"] or pulls["n"] >= consumed + DEPTH + 1)
            stop.set()
            item = q.get()
            while item is not _END and not isinstance(item, _Failed):
                item = q.get()
        thread.join()
        if not ended and isinstance(item, _Failed):
            raise item.error
