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
  from rank 0 over the whole world (the counterpart of the JAX
  ``replicate_sharding``: every rank, data and space, holds the state).

The spatial H split (the JAX ``batch_sharding(mesh, space_axis="space")``,
``P(data, space)``): ``split_context`` lays the world out as the
[world / S, S] grid with the split on. Data rank d's S space ranks
(``[d * S, (d + 1) * S)``, the ``space_group``) share its rows, and space rank
s holds the band ``[s * H / S, (s + 1) * H / S)`` of H of every per-pixel
array (``batch_sharding``, ``local_band``). The train step then exchanges
halos and sums over the world (``parallel/halo.py``,
``models/unet.py``, ``engine/steps.py``). Without the split (every context
``init_distributed`` returns) the space ranks of a column take the same
whole rows, as the trainers of both packages do.

``prefetch_to_device`` runs a host iterator (PNG decode, augmentation,
stacking) on a daemon thread, ``DEPTH`` batches ahead of the consumer, so
the host's work overlaps the train step's dispatch. With a context it keeps
the rank's rows of each batch; with a CUDA ``device`` the thread also puts
the batch on the card (``PinnedRing``: numpy copies into pinned buffers made
once and reused, the host-to-device copy on the ring's own stream), as the
JAX worker puts its batches on the devices, so the step receives
device-resident batches and its thread does no copy. The pinned copies are
numpy's, on the prefetch thread alone: ``Tensor.pin_memory`` copied through
torch's intra-op pool, whose threads then took the host's cores from the
step's dispatch (``chip_smoke.py`` pretrain_wall).

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
from typing import Any, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass
class DistContext:
    """Where a process stands in the run. ``group`` is its data-axis process
    group, None when the data world is 1 (no collective is made). Under the
    H split (``split_h``, made by ``split_context``): ``space_group``, the
    space ranks of its data rank (the sums over data x space use the default
    group, every rank)."""

    world: int = 1
    rank: int = 0
    local_rank: int = 0
    device: torch.device = torch.device("cpu")
    space_size: int = 1
    group: Optional[Any] = None
    owns_group: bool = False  # init_distributed joined the group: close() leaves it
    space_group: Optional[Any] = None
    split_h: bool = False

    @property
    def data_world(self) -> int:
        return self.world // self.space_size

    @property
    def data_rank(self) -> int:
        return self.rank // self.space_size

    @property
    def space_rank(self) -> int:
        return self.rank % self.space_size

    def band(self, height: int) -> slice:
        """This rank's band of ``height`` rows under the split (all of them
        without it). ``ValueError`` when the bands cannot split ``height``."""
        if not self.split_h:
            return slice(0, height)
        if height % self.space_size:
            raise ValueError(f"H = {height} does not split into {self.space_size} equal bands")
        rows = height // self.space_size
        return slice(self.space_rank * rows, (self.space_rank + 1) * rows)

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


def split_context(context: DistContext, space_size: int) -> DistContext:
    """The context of ``context``'s world laid out as the [world /
    ``space_size``, ``space_size``] grid with the H split on (the JAX
    ``batch_sharding(mesh, space_axis="space")``). Collective: every rank of
    the world calls it, in the same order, since every rank creates every
    group. The data group is ``_data_group``'s; each data rank's space group
    holds ranks ``[d * S, (d + 1) * S)``. ``ValueError`` when ``space_size``
    is below 2 or does not divide the world."""
    world, rank = context.world, context.rank
    if space_size < 2 or world % space_size:
        raise ValueError(f"the H split needs a space size of 2 or more that divides the world "
                         f"size {world}, not {space_size}")
    mine = None
    for d in range(world // space_size):
        ranks = list(range(d * space_size, (d + 1) * space_size))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return DistContext(world=world, rank=rank, local_rank=context.local_rank,
                       device=context.device, space_size=space_size,
                       group=_data_group(world, rank, space_size), space_group=mine,
                       split_h=True)


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


def local_band(x, context: Optional[DistContext], dim: int = 1):
    """``x`` (numpy or tensor) cut to the rank's band of H along ``dim``
    (all of it without the split)."""
    if context is None or not context.split_h:
        return x
    band = context.band(x.shape[dim])
    index = (slice(None),) * dim + (band,)
    return x[index]


def batch_sharding(batch: Dict[str, Any], context: Optional[DistContext],
                   device=None) -> Dict[str, Any]:
    """The counterpart of the JAX ``batch_sharding(mesh, space_axis=...)``
    applied to a host batch: under the split, the rank's band of H (axis 1)
    of every array of rank 3 or more (the images [B, H, W, 1], the targets
    [B, H, W] and any per-pixel mask), then ``shard_batch``: the rank's rows,
    on ``device``."""
    banded = {k: local_band(v, context) if _is_array(v) and v.ndim >= 3 else v
              for k, v in batch.items()}
    return shard_batch(banded, context, device)


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
    """``x`` summed over ``group`` in place, no gradient. A bf16 or fp16
    ``x`` is summed in fp32 (gloo sums neither; exact for a gather's sum with
    zeros)."""
    if group is None:
        return x
    if x.dtype in (torch.bfloat16, torch.float16):
        wire = x.float()
        dist.all_reduce(wire, group=group)
        return x.copy_(wire)
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


def gather_parts(part: torch.Tensor, group, parts: int, index: int,
                 dim: int = 0) -> torch.Tensor:
    """The whole of a tensor cut into ``parts`` equal parts along ``dim``
    over the ranks of ``group``, ``part`` being the ``index``-th: each rank
    writes its part into zeros and the group sums them (exact, and any
    backend sums)."""
    size = part.shape[dim]
    shape = list(part.shape)
    shape[dim] = size * parts
    whole = part.new_zeros(shape)
    whole.narrow(dim, index * size, size).copy_(part)
    return reduce_sum_(whole, group)


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part: torch.Tensor, group, parts: int, index: int, dim: int):
        ctx.group, ctx.dim, ctx.size, ctx.index = group, dim, part.shape[dim], index
        return gather_parts(part.detach(), group, parts, index, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = reduce_sum_(grad.contiguous().clone(), ctx.group)
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None, None, None


def all_gather_parts(part: torch.Tensor, group, parts: int, index: int,
                     dim: int = 0) -> torch.Tensor:
    """``gather_parts`` with a gradient: every rank's loss may depend on
    every part, so the backward sums the incoming gradients over ``group``
    and gives each rank those of its own part."""
    return _GatherParts.apply(part, group, parts, index, dim)


def all_gather_rows(local: torch.Tensor, context: Optional[DistContext]) -> torch.Tensor:
    """The global batch of ``local`` (each data rank's rows of it, the same
    count on every rank), in global row order, with a gradient
    (``all_gather_parts`` over the data group). At a data world of 1 (or no
    context) it is ``local`` itself."""
    if context is None or context.group is None or context.data_world == 1:
        return local
    return all_gather_parts(local, context.group, context.data_world, context.data_rank)


def gather_rows(local: torch.Tensor, context: Optional[DistContext]) -> torch.Tensor:
    """The global batch from each data rank's rows of it (``gather_parts``
    over the data group)."""
    if context is None or context.group is None or context.data_world == 1:
        return local
    return gather_parts(local, context.group, context.data_world, context.data_rank)


DEPTH = 2  # the JAX package's queue depth; the surplus is DEPTH + 1 pulls

_END = object()  # the worker's last item: the host iterator ended or was stopped


class _Failed:
    """The worker's last item when the host iterator raised."""

    def __init__(self, error: BaseException) -> None:
        self.error = error


class PinnedRing:
    """``slots`` (DEPTH + 1) sets of host buffers on the way to ``device``,
    pinned, made at first use for each key, shape and dtype and reused for
    the ring's life (a trainer keeps one a phase). ``stage`` (the prefetch
    thread) copies a batch's numpy arrays into the next slot with numpy,
    then onto the card on the ring's own stream, and records an event on
    those copies; a slot is rewritten only after the event of its last
    copies has completed, so a copy in flight never reads a later batch.
    ``ready`` (the consumer) makes its stream wait for that event and marks
    the batch's tensors as used there, so their memory outlives the step's
    kernels."""

    def __init__(self, device, slots: int = DEPTH + 1) -> None:
        self.device = torch.device(device)
        self._buffers: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
        self._copied: List[Any] = [None] * slots
        self._turn = 0
        self._stream = None

    def _alloc(self, arr: np.ndarray) -> torch.Tensor:
        dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
        return torch.empty(arr.shape, dtype=dtype, pin_memory=True)

    def _copy(self, buffers: Dict[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], Any]:
        """The buffers on the card, copied on the ring's stream, and the event
        recorded after the copies."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            out = {k: b.to(self.device, non_blocking=True) for k, b in buffers.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def stage(self, batch: Dict[str, Any]) -> Tuple[Dict[str, Any], Any]:
        """(The batch with each numpy array on the card, the event of its
        copies); other values pass through."""
        i = self._turn
        self._turn = (i + 1) % len(self._buffers)
        if self._copied[i] is not None:
            self._copied[i].synchronize()  # the slot's last copies have landed
        slot, staged = self._buffers[i], {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                buf = slot.get(k)
                if buf is None or tuple(buf.shape) != v.shape or buf.numpy().dtype != v.dtype:
                    buf = slot[k] = self._alloc(v)
                np.copyto(buf.numpy(), v)
                staged[k] = buf
        on_device, self._copied[i] = self._copy(staged)
        return {k: on_device.get(k, v) for k, v in batch.items()}, self._copied[i]

    def ready(self, staged: Tuple[Dict[str, Any], Any]) -> Dict[str, Any]:
        """The batch, safe to use on the consumer's current stream."""
        batch, event = staged
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(stream)
        return batch


def prefetch_to_device(host_iter: Iterable[Dict[str, Any]],
                       device: Optional[torch.device] = None,
                       context: Optional[DistContext] = None,
                       whole: Sequence[str] = (),
                       ring: Optional[PinnedRing] = None) -> Iterator[Dict[str, Any]]:
    """The batches of ``host_iter``, pulled on a background thread up to
    ``DEPTH`` ahead, cut to the rank's rows (``local_rows``, the keys in
    ``whole`` kept whole) under a ``context``; through ``ring`` (made here
    when ``device`` is a CUDA device and none is given) the thread puts each
    batch's arrays on the card, so the consumer gets device-resident tensors.

    Close the generator (``contextlib.closing``) when the epoch is done: that
    waits until the host iterator has been pulled N + DEPTH + 1 times for the
    N batches consumed (the JAX package's count when its loader keeps ahead
    of the step), stops the thread and joins
    it. An exception of the host iterator is raised in the consumer, at the
    batch where it happened or, for a surplus pull, at the close."""
    if ring is None and device is not None and torch.device(device).type == "cuda":
        ring = PinnedRing(device)
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
            if ring is not None and ring.device.type == "cuda" and ring.device.index is not None:
                torch.cuda.set_device(ring.device)  # stage on the consumer's card, not card 0
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
                q.put(item if ring is None else ring.stage(item))
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
            yield item if ring is None else ring.ready(item)
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
