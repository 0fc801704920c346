"""Host-side meters fed by per-step device summaries.

The parts of the JAX package's ``utils/meters.py`` that the trainer uses:
AverageValueMeter, MultipleAverageValueMeter, UniversalDice, SurfaceMeter
(Hausdorff, for inference), MeterInterface, StorageIncomeDict and Storage.
Storage writes its CSV with the ``csv`` module, so the port does not need
pandas.
"""

from __future__ import annotations

import csv
import math
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np


class _Metric:
    def reset(self) -> None:
        raise NotImplementedError

    def add(self, *args, **kwargs) -> None:
        raise NotImplementedError

    def summary(self) -> Dict[str, float]:
        raise NotImplementedError

    def detailed_summary(self) -> Dict[str, float]:
        return self.summary()


class AverageValueMeter(_Metric):
    """Running mean/std (Welford)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def add(self, value: float, n: int = 1) -> None:
        value = float(value)
        for _ in range(n):
            self._n += 1
            delta = value - self._mean
            self._mean += delta / self._n
            self._m2 += delta * (value - self._mean)

    @property
    def mean(self) -> float:
        return self._mean if self._n else float("nan")

    @property
    def std(self) -> float:
        if self._n < 2:
            return 0.0 if self._n else float("nan")
        return math.sqrt(self._m2 / (self._n - 1))

    def summary(self) -> Dict[str, float]:
        return {"mean": self.mean}

    def detailed_summary(self) -> Dict[str, float]:
        return {"mean": self.mean, "std": self.std}


class MultipleAverageValueMeter(_Metric):
    """Keyed collection of AverageValueMeters."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._meters: Dict[str, AverageValueMeter] = defaultdict(AverageValueMeter)

    def add(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self._meters[k].add(v)

    def summary(self) -> Dict[str, float]:
        return {k: m.mean for k, m in self._meters.items()}


class UniversalDice(_Metric):
    """Per-class dice averaged over groups (patient-grouped => volume dice).

    ``add_stats`` takes device-computed per-sample [B, C] intersection /
    union sums (I = sum(pred*target), U = sum(pred+target)) plus group names;
    ``add`` takes raw label maps for host-side use (tests, small evals).
    """

    def __init__(self, C: int = 4, report_axises: Optional[Sequence[int]] = None) -> None:
        self._C = C
        self._report_axis = list(report_axises) if report_axises is not None else list(range(C))
        assert max(self._report_axis) <= C
        self.reset()

    def reset(self) -> None:
        self._intersections: List[np.ndarray] = []
        self._unions: List[np.ndarray] = []
        self._group_names: List[str] = []
        self._n = 0

    def add_stats(
        self,
        intersection: np.ndarray,
        union: np.ndarray,
        group_name: Union[str, Sequence[str], None] = None,
    ) -> None:
        intersection = np.asarray(intersection, dtype=np.float64)
        union = np.asarray(union, dtype=np.float64)
        assert intersection.shape == union.shape and intersection.ndim == 2
        B = intersection.shape[0]
        if group_name is None:
            names = [f"{self._n}_{i:03d}" for i in range(B)]
        elif isinstance(group_name, str):
            names = [group_name] * B
        else:
            names = [str(g) for g in group_name]
            assert len(names) == B, (len(names), B)
        self._intersections.append(intersection)
        self._unions.append(union)
        self._group_names.extend(names)
        self._n += 1

    def add(
        self,
        pred: np.ndarray,
        target: np.ndarray,
        group_name: Union[str, Sequence[str], None] = None,
    ) -> None:
        """pred/target: integer label maps [B, *spatial]."""
        pred = np.asarray(pred)
        target = np.asarray(target)
        assert pred.shape == target.shape, (pred.shape, target.shape)
        B = pred.shape[0]
        inter = np.zeros((B, self._C))
        union = np.zeros((B, self._C))
        for c in range(self._C):
            p = pred == c
            t = target == c
            axes = tuple(range(1, pred.ndim))
            inter[:, c] = np.sum(p & t, axis=axes)
            union[:, c] = np.sum(p, axis=axes) + np.sum(t, axis=axes)
        self.add_stats(inter, union, group_name)

    @property
    def group_names(self) -> List[str]:
        return sorted(set(self._group_names))

    def _group_dice(self) -> Optional[np.ndarray]:
        if self._n == 0:
            return None
        inter = np.concatenate(self._intersections, axis=0)
        union = np.concatenate(self._unions, axis=0)
        names = np.asarray(self._group_names)
        dices = []
        for g in self.group_names:
            idx = names == g
            dices.append((2 * inter[idx].sum(0) + 1e-6) / (union[idx].sum(0) + 1e-6))
        return np.stack(dices, axis=0)

    def value(self):
        gd = self._group_dice()
        if gd is None:
            return [float("nan")] * self._C, [float("nan")] * self._C
        return gd.mean(0), gd.std(0)

    def summary(self) -> Dict[str, float]:
        means, _ = self.value()
        report = {f"DSC{i}": float(means[i]) for i in self._report_axis}
        report["DSC_mean"] = float(np.mean(list(report.values())))
        return report

    def detailed_summary(self) -> Dict[str, float]:
        means, stds = self.value()
        out = self.summary()
        out.update({f"DSC_std{i}": float(stds[i]) for i in self._report_axis})
        return out


def _surface_distances(a: np.ndarray, b: np.ndarray, spacing=None) -> np.ndarray:
    """Distances from the surface voxels of ``a`` to the surface of ``b``;
    raises ``RuntimeError`` when either mask is empty."""
    from scipy import ndimage

    a = np.atleast_1d(a.astype(bool))
    b = np.atleast_1d(b.astype(bool))
    if not a.any() or not b.any():
        raise RuntimeError("empty mask in surface distance computation")
    conn = ndimage.generate_binary_structure(a.ndim, 1)
    a_border = a ^ ndimage.binary_erosion(a, conn, border_value=0)
    b_border = b ^ ndimage.binary_erosion(b, conn, border_value=0)
    dt = ndimage.distance_transform_edt(~b_border, sampling=spacing)
    return dt[a_border]


class SurfaceMeter(_Metric):
    """Hausdorff / 95-percentile HD / average symmetric surface distance per
    class, over the whole [B, H, W] volume of each ``add``.

    ``add`` appends the classes one after another, so when a class's mask is
    empty (``RuntimeError``) the classes before it keep their new values and
    the ones after it get none for that volume, as in the JAX package."""

    METHODS = ("hausdorff", "hd95", "assd")

    def __init__(self, C: int = 4, report_axises: Optional[Sequence[int]] = None,
                 metername: str = "hausdorff") -> None:
        if metername not in self.METHODS:
            raise ValueError(f"metername={metername!r}: expected one of {self.METHODS}")
        self._C = C
        self._report_axis = list(report_axises) if report_axises is not None else list(range(1, C))
        self._method = metername
        self.reset()

    def reset(self) -> None:
        self._values: Dict[int, List[float]] = defaultdict(list)

    def _compute(self, p: np.ndarray, t: np.ndarray) -> float:
        d_pt = _surface_distances(p, t)
        d_tp = _surface_distances(t, p)
        if self._method == "hausdorff":
            return float(max(d_pt.max(), d_tp.max()))
        if self._method == "hd95":
            return float(max(np.percentile(d_pt, 95), np.percentile(d_tp, 95)))
        return float((d_pt.sum() + d_tp.sum()) / (len(d_pt) + len(d_tp)))

    def add(self, pred: np.ndarray, target: np.ndarray) -> None:
        pred = np.asarray(pred)
        target = np.asarray(target)
        if pred.shape != target.shape:
            raise ValueError(f"pred {pred.shape} and target {target.shape} differ in shape")
        for c in self._report_axis:
            self._values[c].append(self._compute(pred == c, target == c))

    def summary(self) -> Dict[str, float]:
        report = {
            f"{self._method}{c}": float(np.mean(v)) if v else float("nan")
            for c, v in sorted(self._values.items())
        }
        if report:
            report[f"{self._method}_mean"] = float(np.mean(list(report.values())))
        return report


class MeterInterface:
    """Per-epoch registry of named meters."""

    def __init__(self) -> None:
        self._meters: Dict[str, _Metric] = {}

    def register_meter(self, name: str, meter: _Metric) -> None:
        self._meters[name] = meter

    def __getitem__(self, name: str) -> _Metric:
        return self._meters[name]

    def __contains__(self, name: str) -> bool:
        return name in self._meters

    def reset(self) -> None:
        for m in self._meters.values():
            m.reset()

    def tracking_status(self) -> Dict[str, Dict[str, float]]:
        return {name: m.summary() for name, m in self._meters.items()}

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *exc):
        return False


class StorageIncomeDict(dict):
    """Named epoch results, e.g. StorageIncomeDict(tra=…, val=…, test=…)."""

    def __init__(self, **kwargs: Mapping[str, Any]) -> None:
        super().__init__(**kwargs)


class Storage:
    """Epoch-indexed history of flattened metric dicts -> storage.csv.

    Participates in trainer state (resume-safe history).
    """

    def __init__(self) -> None:
        self._rows: Dict[int, Dict[str, float]] = {}

    @staticmethod
    def _flatten(prefix: str, d: Mapping[str, Any], out: Dict[str, float]) -> None:
        for k, v in d.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, Mapping):
                Storage._flatten(key, v, out)
            else:
                try:
                    out[key] = float(v)
                except (TypeError, ValueError):
                    pass

    def put_from_dict(self, income: Mapping[str, Mapping[str, Any]], epoch: int) -> None:
        row = self._rows.setdefault(int(epoch), {})
        for section, result in income.items():
            if result is None:
                continue
            self._flatten(section, result, row)

    def columns(self) -> List[str]:
        """Metric names in order of first appearance."""
        seen: Dict[str, None] = {}
        for epoch in sorted(self._rows):
            seen.update(dict.fromkeys(self._rows[epoch]))
        return list(seen)

    def to_csv(self, save_dir: str, name: str = "storage.csv") -> None:
        """One row per epoch, an ``epoch`` column first, blanks where an epoch
        lacks a metric."""
        Path(save_dir).mkdir(parents=True, exist_ok=True)
        cols = self.columns()
        with open(Path(save_dir) / name, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["epoch"] + cols)
            for epoch in sorted(self._rows):
                row = self._rows[epoch]
                writer.writerow([epoch] + [row.get(c, "") for c in cols])

    # --- resume support -------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {"rows": {str(k): v for k, v in self._rows.items()}}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        self._rows = {int(k): dict(v) for k, v in state.get("rows", {}).items()}
