"""ACDC PNG-slice dataset, patient metadata, and semi-supervised splits.

A copy of the JAX package's ``data/acdc.py`` for the PyTorch port. PNGs are
decoded by the native host library (``data/native.py``) where it is there,
else with PIL, as in the JAX package. Change: the patient split reproduces
sklearn's ``train_test_split`` with numpy, so the port does not need sklearn.

Capability parity:
- ACDCDataset: the original project's contrastyou/dataloader/acdc_dataset.py:14-52
  (img/gt PNG subfolders, acdc_info.npy patient->slice-count dict, group =
  ``patient\\d+_\\d+`` regex, partition = apical/mid/basal third of the volume)
  over the folder-scan base WHEEL::deepclustering2/dataset/segmentation/
  _medicalSegmentationDataset.py:30-210.
- ACDCSemiInterface: patient-level labeled/unlabeled split via sklearn
  train_test_split(random_state=0) (WHEEL::…/acdc_dataset.py:116-122), with
  the ratio==1 whole-train short-circuit.
- create_val_split: 5 validation patients carved from the unlabeled split
  under numpy seed 1 (the original project's semi_seg/dataloader_helper.py:79-109).

Images are decoded once to float32 [0, 1] and cached in RAM (the whole
preprocessed ACDC is ~100 MB — the reference re-decoded PNGs in 4 worker
processes every epoch; host RAM caching removes that entirely).
"""

from __future__ import annotations

import math
import os
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PATIENT_PATTERN = r"patient\d+_\d+"
_patient_re = re.compile(PATIENT_PATTERN)
_index_re = re.compile(r"\d+")


def _load_png(path: str) -> np.ndarray:
    from . import native

    if native.available():
        with open(path, "rb") as f:
            decoded = native.decode_png_gray8(f.read())
        if decoded is not None:
            return decoded
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


class ACDCDataset:
    """PNG-slice dataset with train/val modes, patient groups, partitions."""

    folder_name = "ACDC_contrast"
    subfolders = ("img", "gt")

    def __init__(
        self,
        root_dir: str,
        mode: str,
        verbose: bool = False,
        cache: bool = True,
    ) -> None:
        assert mode in ("train", "val"), mode
        self._root_dir = os.path.join(root_dir, self.folder_name)
        self._mode = mode
        base = Path(self._root_dir) / mode
        for sub in self.subfolders:
            assert (base / sub).is_dir(), str(base / sub)
        stems_per_sub = []
        for sub in self.subfolders:
            stems = sorted(
                p.stem for p in (base / sub).iterdir() if p.suffix in (".png", ".jpg")
            )
            stems_per_sub.append(stems)
        assert stems_per_sub[0] == stems_per_sub[1], "img/gt filename mismatch"
        self._stems: List[str] = stems_per_sub[0]
        if os.environ.get("PYDEBUG", "0") == "1":  # reference debug shrink
            self._stems = self._stems[: max(len(self._stems) // 10, 1)]

        info_path = os.path.join(self._root_dir, "acdc_info.npy")
        self._acdc_info: Dict[str, int] = np.load(info_path, allow_pickle=True).item()
        assert isinstance(self._acdc_info, dict)

        self._cache_enabled = cache
        self._cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        if verbose:
            print(f"->> {mode}_dataset: {len(self._stems)} slices, "
                  f"{len(self.get_group_list())} patients")

    # --- filename metadata ------------------------------------------------
    @staticmethod
    def get_group(stem: str) -> str:
        m = _patient_re.search(stem)
        assert m is not None, stem
        return m.group(0)

    def get_partition(self, stem: str) -> str:
        """Apical/mid/basal third from slice index vs patient slice count
        (acdc_dataset.py:37-46)."""
        max_len = self._acdc_info[self.get_group(stem)]
        cutting = max_len // 3
        cur_index = int(_index_re.findall(stem)[-1])
        if cur_index <= cutting - 1:
            return "0"
        if cur_index <= 2 * cutting:
            return "1"
        return "2"

    @property
    def stems(self) -> List[str]:
        return list(self._stems)

    def get_filenames(self) -> List[str]:
        return list(self._stems)

    def get_group_list(self) -> List[str]:
        return sorted({self.get_group(s) for s in self._stems})

    def show_group_set(self) -> set:
        return {self.get_group(s) for s in self._stems}

    # --- raw access -------------------------------------------------------
    def __len__(self) -> int:
        return len(self._stems)

    def load_raw(self, index: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """Returns (image float32 [H,W] scaled to [0,1], label int32 [H,W], stem)."""
        stem = self._stems[index]
        if stem in self._cache:
            img, gt = self._cache[stem]
        else:
            base = Path(self._root_dir) / self._mode
            img = _load_png(str(base / "img" / f"{stem}.png")).astype(np.float32) / 255.0
            gt = _load_png(str(base / "gt" / f"{stem}.png")).astype(np.int32)
            if self._cache_enabled:
                self._cache[stem] = (img, gt)
        return img, gt, stem

    def restrict_to(self, stems: Sequence[str]) -> "ACDCDataset":
        """A shallow copy restricted to the given filename stems."""
        import copy

        out = copy.copy(self)
        keep = set(stems)
        out._stems = [s for s in self._stems if s in keep]
        out._cache = {}
        return out

    def restrict_to_patients(self, patients: Sequence[str]) -> "ACDCDataset":
        keep = set(patients)
        return self.restrict_to([s for s in self._stems if self.get_group(s) in keep])


def train_test_split(items: Sequence[str], test_size: float, seed: int = 0):
    """sklearn ``train_test_split(items, test_size=..., random_state=seed)``
    for a list and a float ``test_size``: a RandomState(seed) permutation,
    the first ceil(test_size * n) items form the test split. Returns
    (train, test) lists."""
    n = len(items)
    if not 0.0 < test_size < 1.0:
        raise ValueError(f"test_size={test_size} should be a float in the (0, 1) range")
    n_test = math.ceil(test_size * n)
    if n - n_test == 0:
        raise ValueError(f"With n_samples={n} and test_size={test_size} the resulting "
                         "train set will be empty.")
    perm = np.random.RandomState(seed).permutation(n)
    return [items[i] for i in perm[n_test:]], [items[i] for i in perm[:n_test]]


class ACDCSemiInterface:
    """Patient-level labeled/unlabeled/val split."""

    def __init__(
        self,
        root_dir: str,
        labeled_data_ratio: float = 0.05,
        unlabeled_data_ratio: float = 0.95,
        seed: int = 0,
        verbose: bool = False,
    ) -> None:
        assert labeled_data_ratio + unlabeled_data_ratio == 1.0 or (
            labeled_data_ratio == 1 or unlabeled_data_ratio == 1
        )
        self.root_dir = root_dir
        self.labeled_ratio = labeled_data_ratio
        self.unlabeled_ratio = unlabeled_data_ratio
        self.seed = seed
        self.verbose = verbose

    def create_semi_supervised_datasets(
        self,
    ) -> Tuple[ACDCDataset, ACDCDataset, ACDCDataset]:
        """Returns (labeled, unlabeled, test) datasets (test = 'val' mode on
        disk, as in the reference)."""
        train_set = ACDCDataset(self.root_dir, "train", verbose=self.verbose)
        test_set = ACDCDataset(self.root_dir, "val", verbose=self.verbose)
        if self.labeled_ratio == 1 or self.unlabeled_ratio == 1:
            # fs baseline: whole train set serves as both splits
            return train_set, train_set.restrict_to(train_set.stems), test_set

        labeled_patients, unlabeled_patients = train_test_split(
            train_set.get_group_list(),
            test_size=self.unlabeled_ratio,
            seed=self.seed,
        )
        labeled = train_set.restrict_to_patients(labeled_patients)
        unlabeled = train_set.restrict_to_patients(unlabeled_patients)
        assert len(labeled) + len(unlabeled) == len(train_set)
        return labeled, unlabeled, test_set

    # reference-compatible alias
    _create_semi_supervised_datasets = create_semi_supervised_datasets


def create_val_split(unlabeled: ACDCDataset, num_patients: int = 5, seed: int = 1) -> ACDCDataset:
    """Carve validation patients out of the unlabeled split: numpy
    permutation of the sorted patient list under a fixed seed, first 5
    (dataloader_helper.py:79-109). The val set keeps the unlabeled data (it
    remains visible to training as unlabeled) but uses eval transforms."""
    patients = sorted(unlabeled.show_group_set())
    rng_state = np.random.get_state()
    np.random.seed(seed)
    chosen = list(np.random.permutation(patients)[:num_patients])
    np.random.set_state(rng_state)
    return unlabeled.restrict_to_patients(chosen)
