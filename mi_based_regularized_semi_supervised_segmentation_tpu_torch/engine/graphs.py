"""CUDA graphs of the JAX package's compiled programs: the train step and
the epoch scan's chunks (``jax.jit``, ``lax.scan``), the eval step and eval
scan, and the four pretrain steps, built by ``engine/steps.py`` and
``engine/pretrain.py`` with ``jit=True`` on a card.

``Graphed`` runs a body with no arguments: its first ``warmup`` calls
eagerly on the capture's stream (real steps of the run: cuDNN, cuBLAS and
the kernels' one-time set-up happen there; cuBLAS keeps workspaces for each
stream it runs on, 64 MiB on the card, so a warm-up stream of its own would
hold as much again for good), then it captures the body once
(the step's generators registered, so each replay draws what the eager step
would draw from the generator's state; any host sync raises) and replays
it, once a call from then on. The kernel wrappers' launch counts are taken
out of the capture and added once a replay (``ops/launches.py``).

The bodies read static buffers:
- ``GraphStep`` (one step a call): the batch is copied into static
  tensors, one replay runs the step, the metrics are cloned out of the
  graph's outputs. It keeps one graph for each batch layout (keys, shapes,
  dtypes) and each set of static keyword values (a pretrain step's
  ``n_valid``), the counterpart of ``jax.jit``'s trace per shape, all of
  them drawing on one memory pool: outputs are cloned right after each
  replay, so no graph reads what another's replay overwrote. ``calls``
  makes one of a function of tensors (the eval step, one graph per padded
  patient length; the eval scan, one a split);
- ``epoch_scan``, ``epoch_scan_preaug`` and ``epoch_scan_pipelined`` (a
  chunk of up to ``capacity`` steps a call): the chunk's [n, B] index rows
  are copied into static [capacity, B] buffers, a device counter is set to
  0, and the chunk is n replays of one body that reads its row at the
  counter, runs the step, writes its metrics into that row of static
  [capacity, ...] buffers and advances the counter; a shorter chunk (the
  epoch's last) uses the same body. Preaug augments the whole stores
  eagerly at the top of each call, into static buffers the body gathers
  from. The pipelined body augments the next batch, then runs the step on
  the current one, in that order on the step's stream (a second stream
  for the augmentation hid none of it on the card), from a generator the
  host seeds with ``_fold_in(seed, i + 1)`` before replay i, then copies
  the next batch over the current one.
The host advances the global step (``step_counter``) once a step; the mean
teacher's EMA reads a device copy of it that its body advances.

Off a card every call runs the body eagerly: the tests' view of what is
captured.
"""

from __future__ import annotations

import contextlib
import gc
from functools import partial
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from ..ops import launches

WARMUP = 2  # eager steps on the capture's stream before the capture
EVAL_WARMUP = 1  # eager eval calls before the capture (no optimizer state to set up)

_STREAMS: Dict[Tuple[torch.device, str], "torch.cuda.Stream"] = {}


def own_stream(device: torch.device, role: str) -> "torch.cuda.Stream":
    """The stream of ``role`` on ``device``, made once a process at high
    priority. torch hands out its pooled streams round-robin, 32 to a
    priority, so a stream made anew could be the very stream a capture
    runs on: the prefetch thread's copies (``PinnedRing``, low priority)
    would then land in the graph. Nothing else in the program takes a
    high-priority stream, so the roles' streams alias no other."""
    key = (torch.device(device), role)
    if key not in _STREAMS:
        _STREAMS[key] = torch.cuda.Stream(key[0], priority=-1)
    return _STREAMS[key]


@contextlib.contextmanager
def _no_collection():
    """Python's collector off: a collection inside a capture could destroy
    an unreachable graph of an earlier step, whose cudaFree would
    invalidate the capture; the garbage is collected first."""
    gc.collect()
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


@contextlib.contextmanager
def _host_syncs_raise():
    """Any op that syncs with the host raises, naming itself."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class Graphed:
    """``body()`` as one CUDA graph on ``device`` (see the module
    docstring); off a card the body itself. ``out`` holds the captured
    body's outputs, rewritten by each replay. ``pool``: the memory pool of
    the capture (``torch.cuda.graph_pool_handle()``; None: its own)."""

    def __init__(self, body: Callable[[], Any], device: torch.device,
                 generators: Sequence[torch.Generator] = (), warmup: int = WARMUP,
                 pool=None) -> None:
        self._body, self.device = body, torch.device(device)
        self._generators, self._warm, self._pool = tuple(generators), int(warmup), pool
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._launches: Optional[launches.CapturedLaunches] = None
        self.out: Any = None

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self) -> Any:
        if self.device.type != "cuda":
            return self._body()
        if self._graph is None:
            if self._warm > 0:
                self._warm -= 1
                main = torch.cuda.current_stream(self.device)
                side = own_stream(self.device, "capture")
                side.wait_stream(main)
                with torch.cuda.stream(side):
                    out = self._body()
                main.wait_stream(side)
                return out
            self._capture()
        self._graph.replay()
        self._launches.replayed()
        return self.out

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        # thread-local: the prefetch thread goes on copying batches meanwhile
        with launches.captured() as counted, _no_collection(), \
                torch.cuda.graph(graph, pool=self._pool, stream=own_stream(self.device, "capture"),
                                 capture_error_mode="thread_local"), _host_syncs_raise():
            self.out = self._body()
        self._graph, self._launches = graph, counted


def chunk_len(batches: Dict[str, torch.Tensor], num_batches: int) -> int:
    """The steps of a chunk of [n, B] index rows, 1 <= n <= ``num_batches``
    (the epoch's last chunk may be shorter)."""
    n = len(next(iter(batches.values())))
    if not 1 <= n <= num_batches:
        raise ValueError(f"a chunk of {n} steps; this scan takes 1 to {num_batches}")
    return n


def _take(rows: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Row ``i`` (a [1] int64 device tensor) of ``rows``, with no host sync."""
    return rows.index_select(0, i)[0]


class GraphStep:
    """``build_*_step(jit=True)`` on a card: step(batch, **static) ->
    metrics, the eager step's ``body(batch, **static)`` (``steps.TrainStep``)
    captured on static copies of the batch: one graph for each batch layout
    and each set of ``static`` keyword values (module docstring), the first
    ``warmup`` calls of each eager; the step's generator registered with
    each and its ``step_counter`` (when it has one) advanced once a call.
    ``pool``: the graphs' memory pool (None: one of their own)."""

    def __init__(self, step, warmup: int = WARMUP, pool=None) -> None:
        self.eager, self._warmup = step, int(warmup)
        if pool is None and step.device.type == "cuda":
            pool = torch.cuda.graph_pool_handle()
        self._pool = pool
        self._generators = tuple(g for g in (getattr(step, "generator", None),) if g is not None)
        self.graphs: Dict[tuple, Tuple[Dict[str, torch.Tensor], Graphed]] = {}

    @property
    def captured(self) -> bool:
        return any(graph.captured for _, graph in self.graphs.values())

    def __call__(self, batch: Dict[str, torch.Tensor], **static) -> Dict[str, torch.Tensor]:
        if any(isinstance(v, torch.Tensor) for v in static.values()):
            raise TypeError(f"a captured step takes its tensors in the batch, not as "
                            f"{sorted(static)} (an injected draw needs jit=False)")
        key = (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())),
               tuple(sorted(static.items())))
        entry = self.graphs.get(key)
        if entry is None:
            dev = self.eager.device
            inputs = {k: v.to(dev, copy=True) for k, v in batch.items()}
            entry = self.graphs[key] = (inputs, Graphed(
                partial(self.eager.body, inputs, **static), dev, self._generators,
                self._warmup, self._pool))
        else:
            _copy_rows(entry[0], batch)
        metrics = entry[1]()
        counter = getattr(self.eager, "step_counter", None)
        if counter is not None:
            counter.add_(1)
        return {k: v.clone() for k, v in metrics.items()}

    def release(self) -> None:
        """Drops every graph, its static buffers and outputs (their pool
        goes once nothing else holds its memory)."""
        self.graphs.clear()


def release(*programs) -> None:
    """Drops the graphs of each program that has any (a ``GraphStep``, or a
    ``calls`` function); an eager one, or None, has none."""
    for program in programs:
        step = program if isinstance(program, GraphStep) else getattr(program, "graphs", None)
        if step is not None:
            step.release()


def calls(fn: Callable[..., Dict[str, torch.Tensor]], names: Sequence[str],
          device: torch.device, pool=None):
    """``fn(*tensors) -> {name: tensor}`` as a ``GraphStep`` (the tensors its
    batch under ``names``), ``EVAL_WARMUP`` eager calls a layout: call(*tensors)
    -> the outputs, cloned; ``call.graphs`` the ``GraphStep``."""
    names = tuple(names)
    step = GraphStep(SimpleNamespace(body=lambda batch: fn(*(batch[n] for n in names)),
                                     device=torch.device(device)), EVAL_WARMUP, pool)

    def call(*tensors: torch.Tensor) -> Dict[str, torch.Tensor]:
        return step(dict(zip(names, tensors)))

    call.graphs = step
    return call


def _copy_rows(static: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
               leading: bool = False) -> None:
    """Each of ``batch``'s tensors into ``static``'s of the same shape and
    dtype (``leading``: into its leading rows)."""
    if set(batch) != set(static):
        raise ValueError(f"a graph's batch has keys {sorted(batch)}, its first had "
                         f"{sorted(static)}")
    for k, v in batch.items():
        dst = static[k][:v.shape[0]] if leading else static[k]
        if dst.shape != v.shape or dst.dtype != v.dtype:
            raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype} does not fit the graph's "
                             f"{tuple(static[k].shape)} {static[k].dtype}")
        dst.copy_(v)


class _Chunks:
    """The static state of a scan: index rows, the device counter, metric
    rows; ``run`` makes one chunk of n steps n calls of the graphed body."""

    def __init__(self, step, capacity: int, body: Callable[[], Dict[str, torch.Tensor]],
                 generators: Sequence[torch.Generator]) -> None:
        self.step, self.capacity = step, int(capacity)
        self.index: Optional[Dict[str, torch.Tensor]] = None
        self.counter = torch.zeros(1, dtype=torch.int64, device=step.device)
        self.rows: Dict[str, torch.Tensor] = {}
        self._body = body
        self.graph = Graphed(self._step_body, step.device, generators)

    def row(self, key: str) -> torch.Tensor:
        return _take(self.index[key], self.counter)

    def _step_body(self) -> Dict[str, torch.Tensor]:
        metrics = self._body()
        if not self.rows:  # made by the first (eager) run
            self.rows = {k: v.new_empty((self.capacity,) + v.shape) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.rows[k].index_copy_(0, self.counter, v[None])
        self.counter.add_(1)
        return self.rows

    def load(self, batches: Dict[str, torch.Tensor]) -> int:
        """The chunk's index rows into the static buffers; returns n."""
        n = chunk_len(batches, self.capacity)
        if self.index is None:
            self.index = {k: v.new_zeros((self.capacity,) + tuple(v.shape[1:]),
                                         device=self.step.device) for k, v in batches.items()}
        _copy_rows(self.index, batches, leading=True)
        self.counter.zero_()
        return n

    def run(self, n: int, before: Optional[Callable[[int], None]] = None
            ) -> Dict[str, torch.Tensor]:
        for i in range(n):
            if before is not None:
                before(i)
            self.graph()
            self.step.step_counter.add_(1)
        return {k: v[:n].clone() for k, v in self.rows.items()}


def epoch_scan(step, capacity: int):
    """``build_epoch_scan(jit=True)``: epoch(batches) -> stacked metrics for
    a chunk of [n, B] index rows, n <= ``capacity``; ``step`` a store step
    (``steps.TrainStep``)."""
    chunks: _Chunks = None  # type: ignore[assignment]

    def body() -> Dict[str, torch.Tensor]:
        return step.body({k: chunks.row(k) for k in chunks.index})

    chunks = _Chunks(step, capacity, body, (step.generator,))

    def epoch(batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return chunks.run(chunks.load(batches))

    epoch.chunks = chunks
    return epoch


def epoch_scan_preaug(step, capacity: int, augment: Callable[[], Dict[str, torch.Tensor]]):
    """``build_epoch_scan_preaug(jit=True)``: ``augment()`` (eager, once a
    call) gives {"labeled_image", "labeled_target", "unlabeled_image"} for
    every stored slice; each replay gathers its rows of them."""
    stores: Dict[str, torch.Tensor] = {}
    chunks: _Chunks = None  # type: ignore[assignment]
    keys = {"labeled_image": "labeled_indices", "labeled_target": "labeled_indices",
            "unlabeled_image": "unlabeled_indices"}

    def body() -> Dict[str, torch.Tensor]:
        idx = {k: chunks.row(k).long() for k in set(keys.values())}
        return step.body({k: stores[k].index_select(0, idx[i]) for k, i in keys.items()})

    chunks = _Chunks(step, capacity, body, (step.generator,))

    def epoch(batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        fresh = augment()
        if stores:
            _copy_rows(stores, fresh)
        else:
            stores.update(fresh)
        return chunks.run(chunks.load(batches))

    epoch.chunks = chunks
    return epoch


def epoch_scan_pipelined(step, capacity: int,
                         augment: Callable[[torch.Generator, Dict[str, torch.Tensor]],
                                           Dict[str, torch.Tensor]],
                         seed_of: Callable[[int, int], int]):
    """``build_epoch_scan_pipelined(jit=True)``: epoch(batches, seed). The
    static index rows hold the chunk's rows shifted by one (row i is batch
    i + 1's, the last the first's again: one wasted augmentation a call, as
    in the JAX package); ``augment(generator, index_batch)`` draws from
    ``generator``, seeded ``seed_of(seed, i)`` for batch i."""
    gen = torch.Generator(device=step.device)
    cur: Dict[str, torch.Tensor] = {}
    chunks: _Chunks = None  # type: ignore[assignment]

    def body() -> Dict[str, torch.Tensor]:
        nxt = augment(gen, {k: chunks.row(k) for k in chunks.index})
        metrics = step.body(cur)
        _copy_rows(cur, nxt)
        return metrics

    chunks = _Chunks(step, capacity, body, (step.generator, gen))

    def epoch(batches: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
        gen.manual_seed(seed_of(seed, 0))
        first = augment(gen, {k: v[0] for k, v in batches.items()})
        if cur:
            _copy_rows(cur, first)
        else:
            cur.update({k: v.clone() for k, v in first.items()})
        n = chunks.load({k: torch.roll(v, -1, 0) for k, v in batches.items()})
        return chunks.run(n, before=lambda i: gen.manual_seed(seed_of(seed, i + 1)))

    epoch.chunks = chunks
    return epoch
