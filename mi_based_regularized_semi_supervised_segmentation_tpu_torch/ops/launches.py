"""The kernel wrappers' launch counts under a CUDA graph.

Each ctypes wrapper module (``mi_joint``, ``mi_fused``, ``rotate``) keeps a
``LAUNCHES`` counter made by ``counter()`` and adds one to it where it
launches its kernel. A CUDA graph capture runs the wrappers once, but
launches nothing: ``captured()`` takes what the capture counted back out of
every counter and keeps it, and the graph's owner calls ``replayed()`` after
each replay, so that a counter always holds the launches the card ran.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Iterator, List, Tuple

_COUNTERS: List[collections.Counter] = []


def counter() -> collections.Counter:
    """A wrapper module's launch counter, seen by every capture."""
    launches: collections.Counter = collections.Counter()
    _COUNTERS.append(launches)
    return launches


class CapturedLaunches:
    """What a capture counted, counter by counter; ``replayed`` adds it
    once a replay."""

    def __init__(self) -> None:
        self.deltas: List[Tuple[collections.Counter, collections.Counter]] = []

    def replayed(self) -> None:
        for launches, delta in self.deltas:
            launches.update(delta)


@contextlib.contextmanager
def captured() -> Iterator[CapturedLaunches]:
    """The counts made inside the block go back out of their counters and
    into the yielded record."""
    before = [collections.Counter(c) for c in _COUNTERS]
    record = CapturedLaunches()
    try:
        yield record
    finally:
        for launches, old in zip(_COUNTERS, before):
            record.deltas.append((launches, launches - old))
            launches.clear()
            launches.update(old)
