"""Device-resident data: the whole dataset on the card, augmentation in the
step (counterpart of the JAX package's ``data/device_pipeline.py``).

The preprocessed ACDC slices are a few hundred MB as uint8, small enough to
stage into device memory once. Each train step then takes only its slice
indices (a handful of integers) and gathers and augments its batch on the card
(``ops/augment_device.py``), with no per-batch host traffic.

Slices of different sizes are centred on one common [Hmax, Wmax] canvas; each
slice's valid window (size and offset) is kept beside it, so the random crop
samples inside the window (pad-if-needed when the slice is narrower than the
crop), as the original project's RandomCrop does.

The JAX package's ``mesh`` argument replicates the store over a device
mesh. Here each rank of a data-parallel run builds its own store on its
device (``device``), whole, and the steps gather the rank's rows of each
global index batch. ``DevicePatientEvalLoader``'s ``pad_multiple`` is the
data world there, so each rank takes an equal share of a patient's slices.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .acdc import ACDCDataset
from .sampler import InfiniteRandomSampler, PatientSampler


class DeviceDataStore:
    """Staged dataset: ``images`` and ``labels`` [N, H, W] uint8 on ``device``,
    the ``packed`` uint16 img<<8|label plane when ``pack``, the per-slice
    valid windows on the host (``valid_hw``, ``offsets`` [N, 2] int32) and on
    the device (``valid_hw_dev``, ``offsets_dev``), and the host metadata
    (``stems``, ``groups``, ``partitions``, ``shape``)."""

    def __init__(self, dataset: ACDCDataset, pad_to: Optional[Tuple[int, int]] = None,
                 device="cpu", pack: bool = False) -> None:
        n = len(dataset)
        if n == 0:
            raise ValueError("empty dataset")
        raws = [dataset.load_raw(i) for i in range(n)]
        hmax = max(img.shape[0] for img, _, _ in raws)
        wmax = max(img.shape[1] for img, _, _ in raws)
        if pad_to is not None:
            hmax, wmax = max(hmax, pad_to[0]), max(wmax, pad_to[1])
        images = np.zeros((n, hmax, wmax), np.uint8)
        labels = np.zeros((n, hmax, wmax), np.uint8)
        self.stems: List[str] = []
        self.valid_hw = np.zeros((n, 2), np.int32)
        self.offsets = np.zeros((n, 2), np.int32)
        for i, (img, gt, stem) in enumerate(raws):
            h, w = img.shape
            top, left = (hmax - h) // 2, (wmax - w) // 2
            images[i, top:top + h, left:left + w] = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            labels[i, top:top + h, left:left + w] = gt.astype(np.uint8)
            self.stems.append(stem)
            self.valid_hw[i] = (h, w)
            self.offsets[i] = (top, left)
        device = torch.device(device)
        self.images = torch.from_numpy(images).to(device)
        self.labels = torch.from_numpy(labels).to(device)
        # pack=True (labeled train stores): image and label in ONE uint16
        # plane, so the fused augmentation gathers the pair with one gather
        self.packed = (torch.from_numpy((images.astype(np.uint16) << 8) | labels).to(device)
                       if pack else None)
        self.valid_hw_dev = torch.from_numpy(self.valid_hw).to(device)
        self.offsets_dev = torch.from_numpy(self.offsets).to(device)
        self.groups = [dataset.get_group(s) for s in self.stems]
        self.partitions = [dataset.get_partition(s) for s in self.stems]
        self.shape = (hmax, wmax)
        self.device = device

    def __len__(self) -> int:
        return self.images.shape[0]


class DeviceIndexLoader:
    """Endless per-step int32 index arrays over a store, reshuffled per pass
    (``InfiniteRandomSampler``), with the slices' group names for the dice
    meter."""

    def __init__(self, store: DeviceDataStore, batch_size: int, shuffle: bool = True,
                 seed: int = 0) -> None:
        self._store = store
        self._batch = batch_size
        self._sampler = InfiniteRandomSampler(len(store), shuffle=shuffle, seed=seed)

    @property
    def store(self) -> DeviceDataStore:
        return self._store

    def __iter__(self) -> Iterator[Dict[str, object]]:
        it = iter(self._sampler)
        while True:
            idx = [next(it) for _ in range(self._batch)]
            yield {"indices": np.asarray(idx, np.int32),
                   "group": [self._store.groups[i] for i in idx]}


class DevicePatientEvalLoader:
    """One padded index array and mask per patient of a store; the slices
    stay on the card (the eval step gathers and centre-crops them)."""

    def __init__(self, store: DeviceDataStore, pad_multiple: int = 8) -> None:
        self._store = store
        group_of = dict(zip(store.stems, store.groups))
        self._sampler = PatientSampler(store.stems, group_of.__getitem__)
        maxn = max((len(v) for v in self._sampler), default=1)
        self._padded = ((maxn + pad_multiple - 1) // pad_multiple) * pad_multiple

    @property
    def store(self) -> DeviceDataStore:
        return self._store

    @property
    def padded_size(self) -> int:
        return self._padded

    def __len__(self) -> int:
        return len(self._sampler)

    def __iter__(self):
        for patient, indices in zip(self._sampler.patients, self._sampler):
            n = len(indices)
            idx = np.zeros(self._padded, np.int32)
            idx[:n] = indices
            mask = np.zeros(self._padded, np.bool_)
            mask[:n] = True
            yield {"indices": idx, "mask": mask, "group": patient,
                   "filename": [self._store.stems[i] for i in indices]}
