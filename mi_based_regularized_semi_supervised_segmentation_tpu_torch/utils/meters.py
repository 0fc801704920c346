"""Host-side meters fed by per-step device summaries.

A copy of the JAX package's ``utils/meters.py``: the trainer's meters
(AverageValueMeter, MultipleAverageValueMeter, UniversalDice, SurfaceMeter
for inference's Hausdorff, MeterInterface, StorageIncomeDict, Storage) and
the rest of its zoo (ConfusionMeter, TimeMeter, AUCMeter, APMeter, mAPMeter,
ClassErrorMeter, MovingAverageValueMeter, MSEMeter, IoUMeter, KappaMetrics,
Kappa2Annotator, InstanceValue, cohen_kappa). Changes: Storage writes its
CSV with the ``csv`` module, so the port does not need pandas; cohen_kappa
of empty input is NaN (the JAX package raises ``ValueError``).
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


class ConfusionMeter(_Metric):
    """K x K confusion matrix over int predictions/targets (the reusable
    member of the reference's vendored torchnet meter zoo,
    WHEEL::deepclustering2/meters2/individual_meters/torchnet). With
    ``normalized``, rows are divided by their sums."""

    def __init__(self, k: int, normalized: bool = False) -> None:
        self._k = int(k)
        self._normalized = bool(normalized)
        self.reset()

    def reset(self) -> None:
        self._conf = np.zeros((self._k, self._k), np.int64)

    def add(self, pred, target) -> None:
        pred = np.asarray(pred).reshape(-1)
        target = np.asarray(target).reshape(-1)
        assert pred.shape == target.shape, (pred.shape, target.shape)
        idx = target * self._k + pred
        self._conf += np.bincount(idx, minlength=self._k * self._k).reshape(
            self._k, self._k)

    def value(self) -> np.ndarray:
        if self._normalized:
            sums = np.maximum(self._conf.sum(axis=1, keepdims=True), 1)
            return self._conf / sums
        return self._conf.copy()

    def summary(self) -> Dict[str, float]:
        total = max(self._conf.sum(), 1)
        return {"acc": float(np.trace(self._conf) / total)}

    def detailed_summary(self) -> Dict[str, float]:
        out = self.summary()
        sums = np.maximum(self._conf.sum(axis=1), 1)
        for c in range(self._k):
            out[f"recall{c}"] = float(self._conf[c, c] / sums[c])
        return out


class TimeMeter(_Metric):
    """Wall-clock rate meter (torchnet TimeMeter): units processed per
    second since reset."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        import time

        self._t0 = time.perf_counter()
        self._n = 0

    def add(self, n: int = 1) -> None:
        self._n += int(n)

    def summary(self) -> Dict[str, float]:
        import time

        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"rate": self._n / dt, "elapsed": dt}

    def detailed_summary(self) -> Dict[str, float]:
        return self.summary()


class AUCMeter(_Metric):
    """Binary ROC area (torchnet AUCMeter semantics,
    WHEEL::…/torchnet/meter/aucmeter.py): accumulate 1-D scores + {0,1}
    targets; value() returns (auc, tpr, fpr) with the stepwise ROC the
    reference builds (scores sorted descending, trapezoid-free sum)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def add(self, output, target) -> None:
        output = np.asarray(output, np.float64).reshape(-1)
        target = np.asarray(target).reshape(-1)
        assert output.shape == target.shape, (output.shape, target.shape)
        assert np.all((target == 0) | (target == 1)), "targets must be 0/1"
        self._scores.append(output)
        self._targets.append(target.astype(np.int64))

    def value(self):
        if not self._scores:
            return 0.5, np.zeros(1), np.zeros(1)
        scores = np.concatenate(self._scores)
        targets = np.concatenate(self._targets)
        order = np.argsort(-scores, kind="stable")
        t = targets[order]
        n = scores.size
        tpr = np.zeros(n + 1)
        fpr = np.zeros(n + 1)
        tpr[1:] = np.cumsum(t == 1)
        fpr[1:] = np.cumsum(t == 0)
        n_pos, n_neg = max(tpr[-1], 1.0), max(fpr[-1], 1.0)
        tpr /= n_pos
        fpr /= n_neg
        # stepwise area: each FPR step contributes the TPR at that point
        area = float(np.sum((fpr[1:] - fpr[:-1]) * tpr[1:]))
        return area, tpr, fpr

    def summary(self) -> Dict[str, float]:
        return {"auc": self.value()[0]}


class APMeter(_Metric):
    """Per-class average precision over NxK score/binary-target pairs with
    optional per-sample weights (torchnet APMeter semantics,
    WHEEL::…/torchnet/meter/apmeter.py). value() -> [K] array."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._scores: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []
        self._weights: List[np.ndarray] = []

    def add(self, output, target, weight=None) -> None:
        output = np.atleast_2d(np.asarray(output, np.float64))
        target = np.atleast_2d(np.asarray(target, np.float64))
        assert output.shape == target.shape, (output.shape, target.shape)
        assert np.all((target == 0) | (target == 1)), "targets must be 0/1"
        if weight is not None:
            weight = np.asarray(weight, np.float64).reshape(-1)
            assert weight.shape[0] == output.shape[0]
            assert np.all(weight >= 0)
        else:
            weight = np.ones(output.shape[0])
        self._scores.append(output)
        self._targets.append(target)
        self._weights.append(weight)

    def value(self) -> np.ndarray:
        if not self._scores:
            return np.zeros(0)
        scores = np.concatenate(self._scores)       # [N, K]
        targets = np.concatenate(self._targets)     # [N, K]
        weights = np.concatenate(self._weights)     # [N]
        K = scores.shape[1]
        ap = np.zeros(K)
        for k in range(K):
            order = np.argsort(-scores[:, k], kind="stable")
            truth = targets[order, k]
            w = weights[order]
            tp = np.cumsum(w * truth)
            rank = np.cumsum(w)
            precision = np.divide(tp, rank, out=np.zeros_like(tp),
                                  where=rank > 0)
            pos_weight = np.sum(w * truth)
            if pos_weight > 0:
                ap[k] = float(np.sum(precision * w * truth) / pos_weight)
        return ap

    def summary(self) -> Dict[str, float]:
        v = self.value()
        return {f"ap{k}": float(x) for k, x in enumerate(v)}


class mAPMeter(_Metric):
    """Mean of APMeter over classes (torchnet mAPMeter)."""

    def __init__(self) -> None:
        self._ap = APMeter()

    def reset(self) -> None:
        self._ap.reset()

    def add(self, output, target, weight=None) -> None:
        self._ap.add(output, target, weight)

    def value(self) -> float:
        v = self._ap.value()
        return float(np.mean(v)) if v.size else 0.0

    def summary(self) -> Dict[str, float]:
        return {"mAP": self.value()}


class ClassErrorMeter(_Metric):
    """Top-k classification error (or accuracy) percentages over [N, C]
    score rows + int targets (torchnet ClassErrorMeter semantics,
    WHEEL::…/torchnet/meter/classerrormeter.py)."""

    def __init__(self, topk: Sequence[int] = (1,), accuracy: bool = False) -> None:
        self._topk = sorted(int(k) for k in topk)
        self._accuracy = bool(accuracy)
        self.reset()

    def reset(self) -> None:
        self._wrong = {k: 0 for k in self._topk}
        self._n = 0

    def add(self, output, target) -> None:
        output = np.atleast_2d(np.asarray(output, np.float64))
        target = np.asarray(target).reshape(-1)
        assert output.shape[0] == target.shape[0], (output.shape, target.shape)
        maxk = self._topk[-1]
        # top-maxk class ids per row, best first
        pred = np.argsort(-output, axis=1, kind="stable")[:, :maxk]
        correct = pred == target[:, None]
        for k in self._topk:
            self._wrong[k] += int(output.shape[0] - correct[:, :k].sum())
        self._n += output.shape[0]

    def value(self, k: int = -1):
        if k != -1:
            assert k in self._wrong, f"invalid k {k}"
            err = 100.0 * self._wrong[k] / max(self._n, 1)
            return 100.0 - err if self._accuracy else err
        return [self.value(k_) for k_ in self._topk]

    def summary(self) -> Dict[str, float]:
        name = "acc" if self._accuracy else "err"
        return {f"{name}@{k}": self.value(k) for k in self._topk}


class MovingAverageValueMeter(_Metric):
    """Windowed mean/std (torchnet MovingAverageValueMeter)."""

    def __init__(self, windowsize: int) -> None:
        self._window = int(windowsize)
        self.reset()

    def reset(self) -> None:
        self._queue = np.zeros(self._window)
        self._n = 0

    def add(self, value: float) -> None:
        self._queue[self._n % self._window] = float(value)
        self._n += 1

    def value(self):
        n = min(self._n, self._window)
        vals = self._queue[:n]
        if n == 0:
            return 0.0, 0.0
        mean = float(np.mean(vals))
        std = float(np.std(vals, ddof=1)) if n > 1 else 0.0
        return mean, std

    def summary(self) -> Dict[str, float]:
        mean, std = self.value()
        return {"mean": mean, "std": std}


class MSEMeter(_Metric):
    """Accumulated (root) mean squared error (torchnet MSEMeter)."""

    def __init__(self, root: bool = False) -> None:
        self._root = bool(root)
        self.reset()

    def reset(self) -> None:
        self._n = 0
        self._sesum = 0.0

    def add(self, output, target) -> None:
        output = np.asarray(output, np.float64)
        target = np.asarray(target, np.float64)
        self._n += output.size
        self._sesum += float(np.sum((output - target) ** 2))

    def value(self) -> float:
        mse = self._sesum / max(self._n, 1)
        return math.sqrt(mse) if self._root else mse

    def summary(self) -> Dict[str, float]:
        return {"rmse" if self._root else "mse": self.value()}


class IoUMeter(_Metric):
    """Confusion-matrix-driven IoU family (the wheel's leftover ``IoU`` meter,
    WHEEL::deepclustering2/meters2/individual_meters/iou.py:9-134): per-class
    IoU plus Overall_Acc / Mean_Acc / FreqW_Acc / Mean_IoU /
    Validated_Mean_IoU (mean over classes that appear in the ground truth).
    ``add`` accepts [N, H, W] int labels or [N, K, H, W] class scores for the
    prediction (argmax over axis 1), matching the wheel's input contract."""

    def __init__(self, num_classes: int, normalized: bool = False,
                 ignore_index=255, report_axis=None) -> None:
        self._k = int(num_classes)
        if ignore_index is None:
            self._ignore = ()
        elif isinstance(ignore_index, int):
            self._ignore = (ignore_index,)
        else:
            self._ignore = tuple(ignore_index)
        self._report_axis = (list(range(self._k)) if report_axis is None
                             else list(report_axis))
        self._conf = ConfusionMeter(self._k, normalized=normalized)

    def reset(self) -> None:
        self._conf.reset()

    def add(self, predicted, target) -> None:
        predicted = np.asarray(predicted)
        target = np.asarray(target)
        assert predicted.ndim in (3, 4), predicted.shape
        if predicted.ndim == 4:
            predicted = predicted.argmax(axis=1)
        assert predicted.shape == target.shape, (predicted.shape, target.shape)
        p = predicted.reshape(-1)
        t = target.reshape(-1).astype(np.int64)
        keep = (t >= 0) & (t < self._k)
        for ig in self._ignore:
            keep &= t != ig
        self._conf.add(p[keep], t[keep])

    def value(self) -> Dict[str, Any]:
        hist = self._conf._conf.astype(np.float64)
        total = max(hist.sum(), 1.0)
        acc = float(np.trace(hist) / total)
        with np.errstate(divide="ignore", invalid="ignore"):
            acc_cls = float(np.nanmean(np.diag(hist) / hist.sum(axis=1)))
        iu = (np.diag(hist) + 1e-16) / (
            hist.sum(axis=1) + hist.sum(axis=0) - np.diag(hist) + 1e-16)
        valid = hist.sum(axis=1) > 0
        freq = hist.sum(axis=1) / total
        return {
            "Overall_Acc": acc,
            "Mean_Acc": acc_cls,
            "FreqW_Acc": float((freq[freq > 0] * iu[freq > 0]).sum()),
            "Validated_Mean_IoU": float(np.nanmean(iu[valid])) if valid.any()
            else float("nan"),
            "Mean_IoU": float(np.nanmean(iu)),
            "Class_IoU": iu.astype(np.float32),
        }

    def summary(self) -> Dict[str, float]:
        values = self.value()["Class_IoU"]
        return {f"{k}": float(values[k]) for k in self._report_axis}


def cohen_kappa(y1, y2) -> float:
    """Cohen's kappa from two label sequences: (p_o - p_e) / (1 - p_e)
    computed on their joint confusion matrix (replaces the wheel's
    sklearn.metrics.cohen_kappa_score dependency, kappa.py:28). NaN for
    empty input (deviation: the JAX package raises ``ValueError`` there)."""
    y1 = np.asarray(y1).reshape(-1).astype(np.int64)
    y2 = np.asarray(y2).reshape(-1).astype(np.int64)
    assert y1.shape == y2.shape, (y1.shape, y2.shape)
    if y1.size == 0:  # the JAX package raises here, at labels.max() of nothing
        return float("nan")
    labels = np.unique(np.concatenate([y1, y2]))
    lut = np.zeros(int(labels.max()) + 1, np.int64)
    lut[labels] = np.arange(len(labels))
    k = len(labels)
    conf = np.bincount(lut[y1] * k + lut[y2], minlength=k * k).reshape(k, k)
    n = conf.sum()
    if n == 0:
        return float("nan")
    po = np.trace(conf) / n
    pe = float((conf.sum(0) * conf.sum(1)).sum()) / (n * n)
    if pe == 1.0:
        return 0.0
    return float((po - pe) / (1.0 - pe))


class KappaMetrics(_Metric):
    """Cohen kappa of each predictor against the target, restricted to
    pixels whose ground truth is in ``considered_classes``
    (WHEEL::deepclustering2/meters2/individual_meters/kappa.py:10-41)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._kappas: List[List[float]] = []

    def add(self, predicts, target, considered_classes) -> None:
        target = np.asarray(target).reshape(-1)
        mask = np.isin(target, list(considered_classes))
        self._kappas.append([
            cohen_kappa(np.asarray(p).reshape(-1)[mask], target[mask])
            for p in predicts])

    def value(self) -> np.ndarray:
        return np.asarray(self._kappas, np.float64).mean(axis=0)

    def summary(self) -> Dict[str, float]:
        v = self.value()
        return {f"kappa{i}": float(v[i]) for i in range(len(v))}


class Kappa2Annotator(KappaMetrics):
    """Inter-annotator kappa between two predictions on gt-masked pixels
    (WHEEL kappa.py:44-69)."""

    def add(self, predict1, predict2, gt=None, considered_classes=(1, 2, 3)):
        p1 = np.asarray(predict1).reshape(-1)
        p2 = np.asarray(predict2).reshape(-1)
        assert p1.shape == p2.shape
        if considered_classes is not None and gt is not None:
            mask = np.isin(np.asarray(gt).reshape(-1), list(considered_classes))
            p1, p2 = p1[mask], p2[mask]
        self._kappas.append([cohen_kappa(p1, p2)])

    def value(self) -> float:
        return float(np.asarray(self._kappas, np.float64).mean())

    def summary(self) -> Dict[str, float]:
        return {"kappa": self.value()}


class InstanceValue(_Metric):
    """Pass-through holder for a single instance value
    (WHEEL::deepclustering2/meters2/individual_meters/instance.py:7-25)."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.instance_value = None

    def add(self, value) -> None:
        self.instance_value = value

    def value(self):
        return self.instance_value

    def summary(self) -> Dict[str, float]:
        return {"value": self.instance_value}


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
