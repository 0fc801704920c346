"""Data parallelism on ``torch.distributed`` and the background prefetch of
host batches (counterpart of the JAX package's ``parallel/mesh.py``).

One process per device. The JAX package jits one program over a device mesh
and lets XLA insert the cross-device sums; here each rank runs the same step
on its rows of the global batch and the step sums over the ranks itself:

- ``init_distributed`` joins the process group (``torchrun``'s environment,
  ``Parallel.multihost``'s coordinator, or an explicit ``init_method``) and
  returns a ``DistContext``: world, rank, local rank, device, and the
  data-axis group. With ``space_size`` > 1 the ranks form a
  [world / space_size, space_size] grid (the JAX mesh's (data, space) axes,
  process-major); the batch is split over the data axis only, so the
  ``space_size`` ranks of a column take the same rows, and the collectives
  run over the data group (the ranks with the same space index).
- ``local_batch_slice`` / ``shard_batch`` keep a rank's rows
  ``[data_rank * per, (data_rank + 1) * per)`` of the global batch.
- ``all_reduce_sum`` sums a tensor over the data group with a gradient:
  its backward sums the incoming gradients over the group too (SyncBN's
  rule: each rank's output depends on every rank's rows).
- ``all_gather_rows`` puts the data ranks' rows together into the global
  batch with a gradient: its backward gives each rank the gradient of its
  own rows, summed over the ranks' losses (the contrastive loss's contrast
  set, ``ops/losses.py:supcon_loss``). ``gather_rows`` does the same for
  metrics, with no gradient.
- ``reduce_grads_`` sums the parameter gradients (and any riders) over the
  group in one flat ``all_reduce``. Summed, not averaged: every loss term
  enters a rank's loss as its share of the global value, so the objective
  is the sum of the ranks' losses.
- ``replicate_state`` broadcasts parameters, buffers and optimizer state
  from rank 0.

``prefetch_to_device`` runs a host iterator (PNG decode, augmentation,
stacking) on a daemon thread, ``DEPTH`` batches ahead of the consumer, so
the host's work overlaps the train step's dispatch. With a context it keeps
the rank's rows of each batch; with a CUDA ``device`` the thread also pins
the batch's arrays. The host-to-device copy stays on the consuming thread
(``engine/trainer.py:to_device``), so no CUDA stream is shared across
threads.

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

import os
import queue
import threading
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class DistContext:
    """Where a process stands in the run. ``group`` is its data-axis process
    group, None when the data world is 1 (no collective is made)."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    space_size: int = 1
    group: Optional[Any] = None
    owns_group: bool = False  # init_distributed joined the group: close() leaves it

    @property
    def data_world(self) -> int:
        return self.world // self.space_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_size

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (``local_batch_slice``)."""
        return local_batch_slice(global_batch, self.data_rank, self.data_world)

    def barrier(self) -> None:
        """Waits for every rank of the world (nothing to wait for at a world
        of 1, which then makes no collective at all)."""
        if self.world > 1 and dist.is_initialized():
            dist.barrier()

    def close(self) -> None:
        """Leaves the process group when ``init_distributed`` joined it (a
        group joined before is left to its owner)."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group, self.group = False, None


def single_context(device="cpu") -> DistContext:
    """The context of a process that runs alone on ``device``."""
    return DistContext(device=torch.device(device))


def launcher_world(multihost: bool = False, num_processes: Optional[int] = None) -> int:
    """The world size the launcher set up: ``num_processes`` under
    ``Parallel.multihost``, else the joined group's, else ``torchrun``'s
    ``WORLD_SIZE``, else 1."""
    if multihost and num_processes is not None:
        return int(num_processes)
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _data_group(world: int, rank: int, space_size: int):
    """The data-axis group of ``rank``: the ranks with its space index. Every
    rank creates every group (``new_group`` is collective). None when the
    data world is 1: a rank that holds the whole batch runs the one-process
    step (cuDNN BN, no collective)."""
    if world // space_size == 1:
        return None
    if space_size == 1:
        return dist.group.WORLD
    mine = None
    for s in range(space_size):
        ranks = list(range(s, world, space_size))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return mine


def init_distributed(device="cuda", backend: Optional[str] = None, space_size: int = 1, *,
                     multihost: bool = False, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None, process_id: Optional[int] = None,
                     init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[timedelta] = None) -> DistContext:
    """Joins the process group and returns the context (idempotent: a joined
    group is taken as it is). The group comes from, in order: an existing
    group; ``multihost`` (``tcp://<coordinator_address>``, ``num_processes``,
    ``process_id``: the JAX package's ``initialize_multihost``);
    ``init_method`` with ``world_size`` and ``rank``; ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` / ``MASTER_PORT``). With none of them the process runs
    alone (no group). ``backend``: nccl on cuda, gloo on cpu unless given
    (gloo also takes CUDA tensors: several ranks may share one card).
    ``device``: a device with an index is taken as it is; ``cuda`` becomes
    ``cuda:<local rank>``. ``world % space_size != 0`` raises ``ValueError``
    (the JAX ``make_mesh`` asserts it)."""
    dev = torch.device(device)
    owns = False
    if not dist.is_initialized():
        if multihost:
            missing = [k for k, v in (("coordinator_address", coordinator_address),
                                      ("num_processes", num_processes),
                                      ("process_id", process_id)) if v is None]
            if missing:
                raise ValueError("Parallel.multihost=true needs Parallel." + ", Parallel.".join(
                    missing) + " (nothing detects them here)")
            init_method = f"tcp://{coordinator_address}"
            world_size, rank = int(num_processes), int(process_id)
        elif init_method is None and "WORLD_SIZE" in os.environ:
            init_method = "env://"
            world_size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if init_method is None:
            if space_size != 1:
                raise ValueError(f"Parallel.space_size={space_size} does not divide the world "
                                 "size 1")
            return single_context(dev)
        if world_size is None or rank is None:
            raise ValueError(f"init_method={init_method!r} needs world_size and rank")
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                                init_method=init_method, world_size=int(world_size),
                                rank=int(rank), **kw)
        owns = True
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % space_size:
        if owns:
            dist.destroy_process_group()
        raise ValueError(f"Parallel.space_size={space_size} does not divide the world size "
                         f"{world}")
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(dev)
    return DistContext(world=world, rank=rank, local_rank=local_rank, device=dev,
                       space_size=space_size, group=_data_group(world, rank, space_size),
                       owns_group=owns)


def local_batch_slice(global_batch: int, process_id: int = 0, process_count: int = 1) -> slice:
    """The half-open row range of the global batch that data rank
    ``process_id`` of ``process_count`` takes. ``ValueError`` when the batch
    does not divide."""
    if global_batch % process_count:
        raise ValueError(f"a global batch of {global_batch} does not divide over "
                         f"{process_count} data ranks")
    if not 0 <= process_id < process_count:
        raise ValueError(f"data rank {process_id} outside [0, {process_count})")
    per = global_batch // process_count
    return slice(process_id * per, (process_id + 1) * per)


_REPLICATION_WARNED: set = set()  # keys shard_batch kept whole, warned once each


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1


def local_rows(batch: Dict[str, Any], context: Optional[DistContext],
               whole: Sequence[str] = ()) -> Dict[str, Any]:
    """The batch with each array (numpy or tensor, rank >= 1) cut to the
    rank's rows; other values, and the arrays named in ``whole``, pass
    through (a batch-level array whose rows are not the batch's slices, such
    as the pretrain phases' contrastive labels, which every rank needs
    whole). An array whose leading dim does not divide the data world is kept
    whole, with one warning per key (the JAX ``shard_batch``'s replication
    fallback)."""
    if context is None or context.data_world == 1:
        return batch
    out: Dict[str, Any] = {}
    for k, v in batch.items():
        if not _is_array(v) or k in whole:
            out[k] = v
        elif v.shape[0] % context.data_world:
            if k not in _REPLICATION_WARNED:
                _REPLICATION_WARNED.add(k)
                print(f"WARNING: '{k}' batch dim {v.shape[0]} does not divide the "
                      f"{context.data_world} data ranks; every rank keeps the whole array "
                      "(warned once per key).", flush=True)
            out[k] = v
        else:
            out[k] = v[context.rows(v.shape[0])]
    return out


def shard_batch(batch: Dict[str, Any], context: Optional[DistContext],
                device=None) -> Dict[str, Any]:
    """``local_rows`` of a host batch, each array moved to ``device`` (the
    context's by default); non-arrays pass through."""
    dev = torch.device(device) if device is not None else (
        context.device if context is not None else torch.device("cpu"))
    out = {}
    for k, v in local_rows(batch, context).items():
        if isinstance(v, np.ndarray) and v.ndim >= 1:
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(dev) if isinstance(v, torch.Tensor) else v
    return out


def _broadcast_(t: torch.Tensor, device: torch.device) -> None:
    """``t`` from rank 0, in place; a CPU tensor travels through ``device``
    when the backend needs it there (nccl)."""
    if t.device.type == "cpu" and device.type == "cuda" and dist.get_backend() == "nccl":
        buf = t.to(device)
        dist.broadcast(buf, src=0)
        t.copy_(buf.cpu())
    else:
        dist.broadcast(t, src=0)


def replicate_state(modules: Sequence[Optional[torch.nn.Module]],
                    optimizer: Optional[torch.optim.Optimizer],
                    context: Optional[DistContext]) -> None:
    """Every rank takes rank 0's parameters, buffers and optimizer state
    (the JAX ``replicate_state``), over the whole world: the ``space_size``
    ranks of a data rank too."""
    if context is None or context.world == 1 or not dist.is_initialized():
        return
    with torch.no_grad():
        for module in modules:
            if module is None:
                continue
            for t in _state_tensors(module):
                _broadcast_(t, context.device)
        if optimizer is not None:
            for state in optimizer.state.values():
                for v in state.values():
                    if isinstance(v, torch.Tensor):
                        _broadcast_(v, context.device)


def _state_tensors(module: torch.nn.Module) -> List[torch.Tensor]:
    return [p.data for p in module.parameters()] + list(module.buffers())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group`` (``x`` itself when
    ``group`` is None), with the gradient summed over the group as well."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def reduce_sum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` in place, no gradient (metrics)."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def reduce_grads_(params: Sequence[torch.nn.Parameter], group,
                  riders: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """Sums the gradients of ``params`` (those that have one) over ``group``
    in one flat ``all_reduce``; ``riders``, a flat fp32 tensor, is summed in
    the same call and returned summed. Nothing happens without a group."""
    if group is None:
        return riders
    grads = [p.grad for p in params if p.grad is not None]
    parts = [g.reshape(-1).float() for g in grads]
    if riders is not None:
        parts.append(riders.reshape(-1).float())
    if not parts:
        return riders
    flat = torch.cat(parts)
    dist.all_reduce(flat, group=group)
    at = 0
    for g in grads:
        g.copy_(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return None if riders is None else flat[at:]


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local: torch.Tensor, context: DistContext) -> torch.Tensor:
        ctx.context = context
        return gather_rows(local.detach(), context)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        context = ctx.context
        grad = reduce_sum_(grad.contiguous().clone(), context.group)
        return grad[context.rows(grad.shape[0])], None


def all_gather_rows(local: torch.Tensor, context: Optional[DistContext]) -> torch.Tensor:
    """The global batch of ``local`` (each data rank's rows of it, the same
    count on every rank), in global row order, with a gradient: every rank's
    loss may depend on every row, so the backward sums the incoming
    gradients over the group and gives each rank those of its own rows. At a
    data world of 1 (or no context) it is ``local`` itself."""
    if context is None or context.group is None or context.data_world == 1:
        return local
    return _AllGatherRows.apply(local, context)


def gather_rows(local: torch.Tensor, context: Optional[DistContext]) -> torch.Tensor:
    """The global batch from each data rank's rows of it: each rank writes
    its rows into zeros and the group sums them (any backend that sums)."""
    if context is None or context.group is None or context.data_world == 1:
        return local
    n = local.shape[0]
    full = local.new_zeros((n * context.data_world,) + tuple(local.shape[1:]))
    full[context.rows(full.shape[0])] = local
    return reduce_sum_(full, context.group)


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
                       device: Optional[torch.device] = None,
                       context: Optional[DistContext] = None,
                       whole: Sequence[str] = ()) -> Iterator[Dict[str, Any]]:
    """The batches of ``host_iter``, pulled on a background thread up to
    ``DEPTH`` ahead, cut to the rank's rows (``local_rows``, the keys in
    ``whole`` kept whole) under a ``context``; pinned (``_pin_batch``) when
    ``device`` is a CUDA device.

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
                item = local_rows(item, context, whole)
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
