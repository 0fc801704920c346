"""The prefetch's staging ring (``parallel/mesh.py:PinnedRing``): DEPTH + 1
slots of host buffers, made once and reused, each rewritten only after the
copies that read it have landed.

On the CPU the ring's copies are made lazy (``LazyRing``): a copy reads its
slot's buffers only when its event completes, either where the ring waits
before rewriting the slot or where the consumer takes the batch, the latest
a copy engine could read them. A slot rewritten before its copy completed
would hand the consumer a later batch. On the card (marked ``cuda``; this
file needs no JAX, so the card's run takes it with ``pytest --noconftest -m
cuda``), the ring itself, with the consumer's stream held busy before each
read.
"""

import sys
import threading
from contextlib import closing

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    PinnedRing,
    prefetch_to_device,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.mesh import DEPTH
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)


class LazyEvent:
    """A copy that has not happened yet: it reads its buffers when it
    completes, once, whichever thread waits for it first."""

    def __init__(self, buffers, out):
        self.buffers, self.out, self.done = buffers, out, False
        self.lock = threading.Lock()

    def synchronize(self):
        with self.lock:
            if not self.done:
                for k, b in self.buffers.items():
                    self.out[k].copy_(b)
                self.done = True


class LazyRing(PinnedRing):
    """``PinnedRing``'s slots and their reuse rule, with plain host buffers
    and lazy copies (the "device" is the CPU); ``allocs`` counts the buffers
    made."""

    def __init__(self, slots: int = DEPTH + 1):
        super().__init__("cpu", slots)
        self.allocs = 0

    def _alloc(self, arr):
        self.allocs += 1
        return torch.from_numpy(np.empty_like(arr))

    def _copy(self, buffers):
        out = {k: torch.empty_like(b) for k, b in buffers.items()}
        return out, LazyEvent(buffers, out)

    def ready(self, staged):
        batch, event = staged
        event.synchronize()
        return batch


def _source(count: int, shape=(3, 5, 5, 1)):
    """``count`` distinct host batches: an image and int32 labels whose
    values name the batch, and a list."""
    rng = np.random.default_rng(0)
    return [{"image": rng.random(shape, dtype=np.float32) + i,
             "labels": np.full(6, i, np.int32), "group": [f"g{i}"]} for i in range(count)]


def _same(got, want):
    assert got["group"] == want["group"]
    for k in ("image", "labels"):
        assert isinstance(got[k], torch.Tensor)
        np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])


def test_held_batches_survive_the_slots_reuse():
    """12 batches through 3 slots, every batch held by the consumer to the
    end: each equal to its source, and only DEPTH + 1 sets of buffers made."""
    source = _source(12)
    ring = LazyRing()
    with closing(prefetch_to_device(iter(source), ring=ring)) as it:
        held = [next(it) for _ in range(len(source) - DEPTH - 1)]
    for got, want in zip(held, source):
        _same(got, want)
    assert ring.allocs == (DEPTH + 1) * 2


@pytest.mark.parametrize("slots", [1, 2, DEPTH + 1])
def test_a_slot_waits_for_its_last_copy(slots):
    """Fewer slots than batches in flight: the ring waits for a slot's last
    copy before rewriting it, so every batch is still its own (a ring that
    did not wait would hand out a later batch here)."""
    source = _source(9)
    with closing(prefetch_to_device(iter(source), ring=LazyRing(slots))) as it:
        held = [next(it) for _ in range(5)]
    for got, want in zip(held, source):
        _same(got, want)


def test_a_ring_serves_epochs_and_new_shapes():
    """One ring across epochs (a phase's), its buffers made again only for a
    key whose shape changed."""
    ring = LazyRing()
    first, second = _source(6), _source(6, shape=(2, 5, 5, 1))
    for source in (first, second):
        with closing(prefetch_to_device(iter(source), ring=ring)) as it:
            held = [next(it) for _ in range(2)]
        for got, want in zip(held, source):
            _same(got, want)
    assert ring.allocs == (DEPTH + 1) * 2 + DEPTH + 1  # only the images' buffers again


def test_ring_under_a_short_switch_interval():
    """The slots' reuse with the interpreter switching threads every
    microsecond and fewer slots than batches in flight: 40 batches through
    1 and 2 slots, every one its own."""
    source = _source(40)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for slots in (1, 2):
            with closing(prefetch_to_device(iter(source), ring=LazyRing(slots))) as it:
                held = [next(it) for _ in range(len(source) - DEPTH - 1)]
            for got, want in zip(held, source):
                _same(got, want)
    finally:
        sys.setswitchinterval(interval)


def test_ring_errors_reach_the_consumer():
    def failing():
        yield from _source(2)
        raise ValueError("loader broke")

    with closing(prefetch_to_device(failing(), ring=LazyRing())) as it:
        assert [b["group"] for b in (next(it), next(it))] == [["g0"], ["g1"]]
        with pytest.raises(ValueError, match="loader broke"):
            next(it)


@pytest.mark.cuda
def test_ring_on_the_card():
    """The ring on the card: 24 batches of 4 x 224^2 through 3 slots, the
    consumer's stream kept busy (``torch.cuda._sleep``) before each batch is
    read, all held to the end: each equal to its source; the tensors on the
    card, the buffers pinned and made once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    source = _source(24, shape=(4, 224, 224, 1))
    ring = PinnedRing("cuda")
    sums = []
    with closing(prefetch_to_device(iter(source), "cuda", ring=ring)) as it:
        held = []
        for _ in range(len(source) - DEPTH - 1):
            torch.cuda._sleep(5_000_000)
            batch = next(it)
            sums.append(batch["image"].double().sum())
            held.append(batch)
    torch.cuda.synchronize()
    for got, want, total in zip(held, source, sums):
        assert got["image"].is_cuda and got["labels"].is_cuda
        _same(got, want)
        assert float(total) == float(want["image"].astype(np.float64).sum())
    buffers = [b for slot in ring._buffers for b in slot.values()]
    assert len(buffers) == (DEPTH + 1) * 2 and all(b.is_pinned() for b in buffers)
