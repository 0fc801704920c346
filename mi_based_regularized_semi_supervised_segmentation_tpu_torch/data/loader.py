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
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .acdc import ACDCDataset, ACDCSemiInterface, create_val_split
from .augment import ACDCStrongTransforms, PairedTransform
from .sampler import InfiniteRandomSampler, PatientSampler


class SegmentationLoader:
    """Infinite loader of augmented, fixed-shape train batches."""

    def __init__(
        self,
        dataset: ACDCDataset,
        transform: PairedTransform,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 4,
    ) -> None:
        self._dataset = dataset
        self._transform = transform
        self._batch_size = batch_size
        self._sampler = InfiniteRandomSampler(len(dataset), shuffle=shuffle, seed=seed)
        self._seed = seed
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
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

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        index_iter = iter(self._sampler)
        while True:
            with self._lock:
                draw_base = self._draw
                self._draw += self._batch_size
                indices = [next(index_iter) for _ in range(self._batch_size)]
            if self._pool is not None:
                samples = list(
                    self._pool.map(self._make_sample, indices,
                                   range(draw_base, draw_base + len(indices)))
                )
            else:
                samples = [self._make_sample(i, draw_base + k) for k, i in enumerate(indices)]
            imgs, tgts, stems, partitions, groups = zip(*samples)
            yield {
                "image": np.stack(imgs).astype(np.float32),
                "target": np.stack(tgts).astype(np.int32),
                "filename": list(stems),
                "partition": list(partitions),
                "group": list(groups),
            }


class TwiceLoader:
    """Infinite loader of twice-augmented view pairs for contrastive
    pretraining (SequentialWrapperTwice semantics). ``total_freedom=True``
    draws independent geometry per view; False shares geometry
    (contrastyou/augment/sequential_wrapper.py:73-100). Batches come from a
    ContrastBatchSampler (patient x partition structured) or an
    InfiniteRandomSampler."""

    def __init__(
        self,
        dataset: ACDCDataset,
        transform: PairedTransform,
        batch_sampler=None,
        batch_size: Optional[int] = None,
        total_freedom: bool = True,
        seed: int = 0,
        num_workers: int = 4,
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
        self._pool = cf.ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
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

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        for indices in self._batch_sampler:
            base = self._draw
            self._draw += len(indices)
            if self._pool is not None:
                samples = list(self._pool.map(
                    self._make_sample, indices, range(base, base + len(indices))))
            else:
                samples = [self._make_sample(i, base + k) for k, i in enumerate(indices)]
            img1, tgt1, img2, tgt2, stems, partitions, groups = zip(*samples)
            yield {
                "image": np.stack(img1).astype(np.float32),
                "target": np.stack(tgt1).astype(np.int32),
                "image_tf": np.stack(img2).astype(np.float32),
                "target_tf": np.stack(tgt2).astype(np.int32),
                "filename": list(stems),
                "partition": list(partitions),
                "group": list(groups),
            }


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
                    eval_pad_multiple: int = 8):
    """Reference surface (semi_seg/dataloader_helper.py:23-68): returns
    (labeled_loader, unlabeled_loader, test_loader). ``eval_pad_multiple``:
    the test loader pads each patient to a multiple of it (the data world
    under data parallelism, so each rank takes an equal share of slices)."""
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
    )
    unlabeled_loader = SegmentationLoader(
        unlabeled_set,
        ACDCStrongTransforms.pretrain,
        batch_size=config["UnlabeledData"]["batch_size"],
        shuffle=config["UnlabeledData"]["shuffle"],
        seed=seed + 1,
        num_workers=config["UnlabeledData"].get("num_workers", 4),
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
