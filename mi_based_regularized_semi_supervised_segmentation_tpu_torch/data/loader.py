"""Host data loaders: infinite augmented train batches + patient-grouped
padded eval batches.

Replaces the reference's 4-process torch DataLoader stack
(semi_seg/dataloader_helper.py:23-109, WHEEL::deepclustering2/dataloader/)
with a RAM-cached, thread-pooled, deterministic pipeline producing fixed-shape
numpy batches ready for a single host->device transfer:

- Train batches have STATIC shape [B, 224, 224, 1] / [B, 224, 224] — XLA
  compiles the train step exactly once.
- Eval batches are patient-grouped and PADDED to one static max-slice count
  with a validity mask, so per-patient (volume) dice runs fully on device
  with one compiled shape (the reference re-ran a Python dice reduction per
  batch — SURVEY §3.2 hotspot).

A copy of the JAX package's module for the PyTorch port.
"""

from __future__ import annotations

import concurrent.futures as cf
import mmap
import multiprocessing as mp
import os
import threading
import weakref
from multiprocessing import reduction
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from . import native
from .acdc import ACDCDataset, ACDCSemiInterface, create_val_split
from .augment import ACDCStrongTransforms, PairedTransform
from .sampler import InfiniteRandomSampler, PatientSampler

# what a loader leaves behind when it is sent to its own process: the batch
# order (the samplers, the draw counter) and the pools stay with the caller
_LOCAL = ("_pool", "_lock", "_process", "_sampler", "_batch_sampler")


class _Region:
    """A shared mapping (a memfd) a loader's process writes its batches'
    arrays into and the caller copies them out of: one pipe message a batch
    then carries only their layout (a batch through the pipe itself crossed
    in 64 KB reads, each a GIL hand-over in the caller)."""

    def __init__(self, size: int, fd: Optional[int] = None) -> None:
        if fd is None:
            fd = os.memfd_create("loader-batches")
            os.ftruncate(fd, size)
        self.fd, self.size = fd, os.fstat(fd).st_size
        self.map = mmap.mmap(fd, self.size)

    def view(self, offset: int, shape, dtype) -> np.ndarray:
        return np.ndarray(shape, np.dtype(dtype), buffer=self.map, offset=offset)

    def close(self) -> None:
        self.map.close()
        os.close(self.fd)


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 64) * 64


def _stack(columns: Dict[str, Tuple[Sequence[np.ndarray], Any]], alloc=None
           ) -> Dict[str, np.ndarray]:
    """Each column's per-sample arrays stacked into one array of its dtype
    (``np.stack(parts).astype(dtype)``'s values), written where ``alloc``
    (shapes and dtypes by key -> arrays) puts them, else into new ones."""
    shapes = {k: ((len(parts),) + np.shape(parts[0]), np.dtype(dtype))
              for k, (parts, dtype) in columns.items()}
    out = (alloc or _new_arrays)(shapes)
    for k, (parts, _) in columns.items():
        np.stack(parts, out=out[k])
    return out


def _new_arrays(shapes) -> Dict[str, np.ndarray]:
    return {k: np.empty(shape, dtype) for k, (shape, dtype) in shapes.items()}


class _RegionArrays:
    """A loader process's ``alloc`` for ``_stack``: the arrays laid out in
    its shared region, made anew (``grown``) when they outgrow it."""

    def __init__(self) -> None:
        self.region: Optional[_Region] = None
        self.grown = False
        self.layout: Dict[str, Tuple[int, Tuple[int, ...], str]] = {}

    def __call__(self, shapes) -> Dict[str, np.ndarray]:
        need = sum(_aligned(int(np.prod(shape)) * dtype.itemsize)
                   for shape, dtype in shapes.values())
        if self.region is None or self.region.size < need:
            if self.region is not None:
                self.region.close()
            self.region, self.grown = _Region(need + need // 4), True
        self.layout, offset = {}, 0
        for k, (shape, dtype) in shapes.items():
            self.layout[k] = (offset, shape, dtype.str)
            offset += _aligned(int(np.prod(shape)) * dtype.itemsize)
        return {k: self.region.view(*self.layout[k]) for k in shapes}


LOADER_NICE = 5  # a loader's own process yields the host's cores to its caller's threads


def _serve(conn, loader, native_library: Optional[str], nice: int) -> None:
    """A loader's own process, on its caller's native library (or none, as
    there), at ``nice`` (LOADER_NICE: its threads, 4 by default, then leave
    the cores to the caller's step dispatch when the host is short of them):
    each ``("batch", request)`` (a batch's sample indices and draw ids)
    answered with the batch ``loader._make_batch`` makes on the loader's
    thread pool, its arrays stacked into the shared region (a new one, its
    descriptor sent after the answer, when they outgrow it), and the native
    calls it took; ``("ping",)`` with nothing. An error goes back as the
    answer."""
    try:
        os.nice(nice)
    except OSError:  # not allowed here: the default priority
        pass
    native.use_library(native_library)
    loader._pool = (cf.ThreadPoolExecutor(max_workers=loader._num_workers)
                    if loader._num_workers > 0 else None)
    arrays = _RegionArrays()
    while True:
        try:
            message = conn.recv()
        except EOFError:
            return
        if message is None:
            return
        before, arrays.grown = dict(native.CALLS), False
        try:
            value = None
            if message[0] == "batch":  # the arrays stacked straight into the region
                batch = loader._make_batch(*message[1], alloc=arrays)
                value = (list(batch), arrays.layout,
                         {k: v for k, v in batch.items() if k not in arrays.layout})
            reply = (True, value)
        except Exception as error:  # raised in the caller
            reply = (False, error)
        calls = {k: native.CALLS[k] - before[k] for k in before}
        try:
            conn.send(reply + (calls, arrays.grown))
        except Exception as error:  # an error that does not pickle
            conn.send((False, RuntimeError(repr(reply[1])) if not reply[0] else error, calls,
                       arrays.grown))
        if arrays.grown:
            reduction.send_handle(conn, arrays.region.fd, os.getppid())


class _OwnProcess:
    """A loader's batches made in a process of its own (spawned: the
    caller's CUDA state and threads stay out of it), one request at a time.
    The loader's threads run there, so their Python work never waits for,
    nor holds, the caller's GIL, which a train step's dispatch takes
    between any two kernels (``chip_smoke.py`` pretrain_wall: a loader's
    threads beside the step cost it 2-4x its own time). The arrays cross in
    a shared region (``_Region``), copied out before the next request. The
    batch order and the draw ids stay with the caller, so the batches are
    the same, bit for bit; the native calls made there are added to
    ``native.CALLS``."""

    def __init__(self, loader) -> None:
        context = mp.get_context("spawn")
        self._conn, child = context.Pipe()
        self._lock = threading.Lock()
        self._region: Optional[_Region] = None
        self._process = context.Process(target=_serve,
                                        args=(child, loader, native.library_path(),
                                              LOADER_NICE),
                                        daemon=True, name=f"{type(loader).__name__}-batches")
        self._process.start()
        child.close()
        self._finalizer = weakref.finalize(self, _OwnProcess._stop, self._conn, self._process)

    def _ask(self, *message):
        with self._lock:
            try:
                self._conn.send(message)
                ok, value, calls, grown = self._conn.recv()
                if grown:
                    fd = reduction.recv_handle(self._conn)
                    if self._region is not None:
                        self._region.close()
                    self._region = _Region(0, fd)
            except (EOFError, OSError):
                self._process.join(timeout=10)
                raise RuntimeError(f"the loader's process {self._process.name} ended "
                                   f"(exit code {self._process.exitcode})") from None
            native.add_calls(calls)
            if not ok:
                raise value
            if value is None:
                return None
            order, layout, others = value
            return {k: self._region.view(*layout[k]).copy() if k in layout else others[k]
                    for k in order}

    def __call__(self, *request) -> Dict[str, Any]:
        return self._ask("batch", request)

    def wait_ready(self) -> None:
        self._ask("ping")

    @staticmethod
    def _stop(conn, process) -> None:
        try:
            conn.send(None)
        except (OSError, ValueError):
            pass
        process.join(timeout=10)
        if process.is_alive():
            process.terminate()
            process.join()
        conn.close()

    def close(self) -> None:
        self._finalizer()
        if self._region is not None:
            self._region.close()
            self._region = None


class _Batches:
    """What the two train loaders share: a pool of ``num_workers`` sample
    threads, in the caller's process or, with ``own_process``, in one of the
    loader's own (``_OwnProcess``, started here, so its start overlaps the
    caller's set-up; not from a daemonic process, which may have no
    children: there the threads stay in the caller's). ``_start`` comes
    last in a loader's ``__init__`` but for the batch order's state."""

    def _start(self, num_workers: int, own_process: bool) -> None:
        self._num_workers = num_workers
        self._own_process = own_process and not mp.current_process().daemon
        self._pool = (cf.ThreadPoolExecutor(max_workers=num_workers)
                      if num_workers > 0 and not self._own_process else None)
        self._process = _OwnProcess(self) if self._own_process else None

    def __getstate__(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items() if k not in _LOCAL}

    def _samples(self, make, indices: Sequence[int], base: int) -> list:
        draws = range(base, base + len(indices))
        if self._pool is not None:
            return list(self._pool.map(make, indices, draws))
        return [make(i, d) for i, d in zip(indices, draws)]

    def _batch(self, *request) -> Dict[str, Any]:
        if not self._own_process:
            return self._make_batch(*request)
        if self._process is None:
            self._process = _OwnProcess(self)
        return self._process(*request)

    def wait_ready(self) -> None:
        """Return when the loader's own process, if it has one, is up (its
        first batch would wait for that)."""
        if self._process is not None:
            self._process.wait_ready()

    def close(self) -> None:
        """Stop the loader's own process, if it has one (it stops with the
        loader, or at exit, otherwise)."""
        if self._process is not None:
            self._process.close()
            self._process = None


class SegmentationLoader(_Batches):
    """Infinite loader of augmented, fixed-shape train batches.
    ``own_process``: make them in a process of the loader's own
    (``_OwnProcess``), the same batches."""

    def __init__(
        self,
        dataset: ACDCDataset,
        transform: PairedTransform,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        own_process: bool = False,
    ) -> None:
        self._dataset = dataset
        self._transform = transform
        self._batch_size = batch_size
        self._sampler = InfiniteRandomSampler(len(dataset), shuffle=shuffle, seed=seed)
        self._seed = seed
        self._start(num_workers, own_process)
        self._draw = 0
        self._lock = threading.Lock()

    @property
    def dataset(self) -> ACDCDataset:
        return self._dataset

    @property
    def batch_size(self) -> int:
        return self._batch_size

    def _make_sample(self, index: int, draw_id: int):
        img, gt, stem = self._dataset.load_raw(index)
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, draw_id]))
        out_img, out_tgt = self._transform(img, gt, rng)
        return (
            out_img,
            out_tgt,
            stem,
            self._dataset.get_partition(stem),
            self._dataset.get_group(stem),
        )

    def _make_batch(self, indices: Sequence[int], draw_base: int,
                    alloc=None) -> Dict[str, Any]:
        samples = self._samples(self._make_sample, indices, draw_base)
        imgs, tgts, stems, partitions, groups = zip(*samples)
        return {
            **_stack({"image": (imgs, np.float32), "target": (tgts, np.int32)}, alloc),
            "filename": list(stems),
            "partition": list(partitions),
            "group": list(groups),
        }

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        index_iter = iter(self._sampler)
        while True:
            with self._lock:
                draw_base = self._draw
                self._draw += self._batch_size
                indices = [next(index_iter) for _ in range(self._batch_size)]
            yield self._batch(indices, draw_base)


class TwiceLoader(_Batches):
    """Infinite loader of twice-augmented view pairs for contrastive
    pretraining (SequentialWrapperTwice semantics). ``total_freedom=True``
    draws independent geometry per view; False shares geometry
    (contrastyou/augment/sequential_wrapper.py:73-100). Batches come from a
    ContrastBatchSampler (patient x partition structured) or an
    InfiniteRandomSampler. ``own_process``: make them in a process of the
    loader's own (``_OwnProcess``), the same batches."""

    def __init__(
        self,
        dataset: ACDCDataset,
        transform: PairedTransform,
        batch_sampler=None,
        batch_size: Optional[int] = None,
        total_freedom: bool = True,
        seed: int = 0,
        num_workers: int = 4,
        own_process: bool = False,
    ) -> None:
        from .augment import TwiceTransform
        from .sampler import ContrastBatchSampler

        self._dataset = dataset
        if batch_sampler is None:
            assert batch_size is not None
            batch_sampler = _InfiniteBatcher(
                InfiniteRandomSampler(len(dataset), seed=seed), batch_size
            )
        self._batch_sampler = batch_sampler
        self._twice = TwiceTransform(transform, total_freedom=total_freedom)
        self._seed = seed
        self._start(num_workers, own_process)
        self._draw = 0

    @property
    def dataset(self) -> ACDCDataset:
        return self._dataset

    def set_total_freedom(self, value: bool) -> None:
        self._twice.total_freedom = value

    def _make_sample(self, index: int, draw_id: int):
        img, gt, stem = self._dataset.load_raw(index)
        rng = np.random.default_rng(np.random.SeedSequence([self._seed, 7, draw_id]))
        (img1, tgt1), (img2, tgt2) = self._twice(img, gt, rng)
        return (
            img1, tgt1, img2, tgt2, stem,
            self._dataset.get_partition(stem),
            self._dataset.get_group(stem),
        )

    def _make_batch(self, indices: Sequence[int], base: int, total_freedom: bool,
                    alloc=None) -> Dict[str, Any]:
        self._twice.total_freedom = total_freedom
        samples = self._samples(self._make_sample, indices, base)
        img1, tgt1, img2, tgt2, stems, partitions, groups = zip(*samples)
        return {
            **_stack({"image": (img1, np.float32), "target": (tgt1, np.int32),
                      "image_tf": (img2, np.float32), "target_tf": (tgt2, np.int32)}, alloc),
            "filename": list(stems),
            "partition": list(partitions),
            "group": list(groups),
        }

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for indices in self._batch_sampler:
            base = self._draw
            self._draw += len(indices)
            yield self._batch(list(indices), base, self._twice.total_freedom)


class _InfiniteBatcher:
    def __init__(self, sampler: InfiniteRandomSampler, batch_size: int) -> None:
        self._sampler = sampler
        self._batch_size = batch_size

    def __iter__(self):
        it = iter(self._sampler)
        while True:
            yield [next(it) for _ in range(self._batch_size)]


class PatientEvalLoader:
    """Patient-grouped eval batches, padded to a single static shape."""

    def __init__(
        self,
        dataset: ACDCDataset,
        transform: PairedTransform,
        pad_multiple: int = 8,
    ) -> None:
        self._dataset = dataset
        self._transform = transform
        self._sampler = PatientSampler(dataset.stems, dataset.get_group)
        counts = [len(idx) for idx in self._sampler]
        max_slices = max(counts) if counts else 1
        self._padded = ((max_slices + pad_multiple - 1) // pad_multiple) * pad_multiple

    @property
    def dataset(self) -> ACDCDataset:
        return self._dataset

    @property
    def padded_size(self) -> int:
        return self._padded

    def __len__(self) -> int:
        return len(self._sampler)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        rng = np.random.default_rng(0)  # eval transform is deterministic (center crop)
        for patient, indices in zip(self._sampler.patients, self._sampler):
            imgs, tgts, stems = [], [], []
            for i in indices:
                img, gt, stem = self._dataset.load_raw(i)
                out_img, out_tgt = self._transform(img, gt, rng)
                imgs.append(out_img)
                tgts.append(out_tgt)
                stems.append(stem)
            n = len(imgs)
            pad = self._padded - n
            image = np.stack(imgs).astype(np.float32)
            target = np.stack(tgts).astype(np.int32)
            if pad > 0:
                image = np.concatenate([image, np.zeros((pad,) + image.shape[1:], image.dtype)])
                target = np.concatenate([target, np.zeros((pad,) + target.shape[1:], target.dtype)])
            mask = np.zeros(self._padded, np.bool_)
            mask[:n] = True
            yield {
                "image": image,
                "target": target,
                "mask": mask,
                "group": patient,
                "filename": stems,
            }


def get_dataloaders(config: Dict[str, Any], data_root: Optional[str] = None,
                    eval_pad_multiple: int = 8, own_process: bool = False):
    """Reference surface (semi_seg/dataloader_helper.py:23-68): returns
    (labeled_loader, unlabeled_loader, test_loader). ``eval_pad_multiple``:
    the test loader pads each patient to a multiple of it (the data world
    under data parallelism, so each rank takes an equal share of slices).
    ``own_process``: each train loader makes its batches in a process of its
    own (``_OwnProcess``)."""
    from .. import DATA_PATH

    root = data_root or config.get("Data", {}).get("root_dir") or DATA_PATH
    data_cfg = config["Data"]
    assert data_cfg.get("name", "acdc") == "acdc", data_cfg
    interface = ACDCSemiInterface(
        root_dir=root,
        labeled_data_ratio=data_cfg["labeled_data_ratio"],
        unlabeled_data_ratio=data_cfg["unlabeled_data_ratio"],
    )
    labeled_set, unlabeled_set, test_set = interface.create_semi_supervised_datasets()
    seed = int(config.get("RandomSeed", 10))
    labeled_loader = SegmentationLoader(
        labeled_set,
        ACDCStrongTransforms.pretrain,
        batch_size=config["LabeledData"]["batch_size"],
        shuffle=config["LabeledData"]["shuffle"],
        seed=seed,
        num_workers=config["LabeledData"].get("num_workers", 4),
        own_process=own_process,
    )
    unlabeled_loader = SegmentationLoader(
        unlabeled_set,
        ACDCStrongTransforms.pretrain,
        batch_size=config["UnlabeledData"]["batch_size"],
        shuffle=config["UnlabeledData"]["shuffle"],
        seed=seed + 1,
        num_workers=config["UnlabeledData"].get("num_workers", 4),
        own_process=own_process,
    )
    test_loader = PatientEvalLoader(test_set, ACDCStrongTransforms.val,
                                    pad_multiple=eval_pad_multiple)
    return labeled_loader, unlabeled_loader, test_loader


def create_val_loader(unlabeled_loader: SegmentationLoader, test_loader: PatientEvalLoader,
                      pad_multiple: int = 8):
    """Reference surface (dataloader_helper.py:79-109): 5 patients carved from
    the unlabeled split, eval transform, patient-grouped, each padded to a
    multiple of ``pad_multiple``."""
    val_set = create_val_split(unlabeled_loader.dataset)
    return PatientEvalLoader(val_set, ACDCStrongTransforms.val, pad_multiple=pad_multiple)
