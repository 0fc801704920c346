"""Samplers: infinite shuffled index stream + patient-grouped batches.

Parity: InfiniteRandomSampler (WHEEL::deepclustering2/dataloader/
sampler.py:224-234 — train loaders iterate it forever; an epoch is
num_batches steps, not a data pass) and PatientSampler
(WHEEL::…/_patient_sampler.py:17-99 — one patient's slices per batch for
volume dice).
A copy of the JAX package's module for the PyTorch port.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class InfiniteRandomSampler:
    """Endless reshuffled index stream, seeded."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0) -> None:
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[int]:
        while True:
            idx = np.arange(self._size)
            if self._shuffle:
                self._rng.shuffle(idx)
            yield from idx.tolist()


class ContrastBatchSampler:
    """Contrastive pretraining batches: sample m patients, then one slice per
    partition per patient -> m * n_partitions slices per batch
    (reference: contrastyou/dataloader/_seg_datset.py:46-108)."""

    def __init__(
        self,
        stems: Sequence[str],
        get_group,
        get_partition,
        group_sample_num: int = 4,
        partition_sample_num: int = 1,
        shuffle: bool = False,
        seed: int = 0,
    ) -> None:
        self._group2index: Dict[str, List[int]] = {}
        self._partition2index: Dict[str, List[int]] = {}
        for i, stem in enumerate(stems):
            self._group2index.setdefault(get_group(stem), []).append(i)
            self._partition2index.setdefault(get_partition(stem), []).append(i)
        assert group_sample_num <= len(self._group2index), (
            group_sample_num, len(self._group2index))
        self._group_sample_num = group_sample_num
        self._partition_sample_num = partition_sample_num
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    @property
    def batch_size(self) -> int:
        return self._group_sample_num * len(self._partition2index) * self._partition_sample_num

    def __iter__(self) -> Iterator[List[int]]:
        groups = list(self._group2index.keys())
        while True:
            batch: List[int] = []
            chosen = self._rng.choice(len(groups), self._group_sample_num, replace=False)
            for gi in chosen:
                available = set(self._group2index[groups[gi]])
                for part_indices in self._partition2index.values():
                    pool = sorted(available & set(part_indices))
                    if not pool:
                        continue
                    picks = self._rng.choice(
                        len(pool), min(self._partition_sample_num, len(pool)), replace=False
                    )
                    batch.extend(pool[p] for p in picks)
            if self._shuffle:
                self._rng.shuffle(batch)
            yield batch


class PatientSampler:
    """Yields one batch of slice indices per patient, in sorted-patient order."""

    def __init__(self, stems: Sequence[str], get_group, shuffle: bool = False, seed: int = 0) -> None:
        groups: Dict[str, List[int]] = {}
        for i, stem in enumerate(stems):
            groups.setdefault(get_group(stem), []).append(i)
        self._groups = {k: groups[k] for k in sorted(groups)}
        self._shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._groups)

    @property
    def patients(self) -> List[str]:
        return list(self._groups.keys())

    def __iter__(self) -> Iterator[List[int]]:
        values = list(self._groups.values())
        if self._shuffle:
            order = self._rng.permutation(len(values))
            values = [values[i] for i in order]
        yield from values
