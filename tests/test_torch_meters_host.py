"""The port's meter zoo (``utils/meters.py``: the meters the trainers do not
use) against the JAX package's: each meter fed the same numpy-seeded
sequences on both sides, every summary, detailed summary and value equal
(tolerance 0: the same numpy arithmetic; NaN equal to NaN). ``TimeMeter``
runs under a patched ``time.perf_counter``. ``cohen_kappa`` of empty input
is pinned: the JAX package raises ``ValueError``, the port returns NaN."""

import math
import time

import numpy as np
import pytest

from mi_based_regularized_semi_supervised_segmentation_tpu.utils import meters as jm
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import meters as pm
import mi_based_regularized_semi_supervised_segmentation_tpu.utils as jutils
import mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils as putils


def _same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif a is None:
        assert b is None, where
    else:
        assert type(a) is type(b), (where, type(a), type(b))
        np.testing.assert_array_equal(a, b, err_msg=where)


def _both(name, *args, **kwargs):
    return getattr(pm, name)(*args, **kwargs), getattr(jm, name)(*args, **kwargs)


def _feed(meters, calls):
    for args, kwargs in calls:
        for m in meters:
            m.add(*args, **kwargs)


def _reports(meter):
    out = {"summary": meter.summary(), "detailed": meter.detailed_summary()}
    if hasattr(meter, "value"):
        out["value"] = meter.value()
    return out


def _check(ours, theirs):
    _same(_reports(ours), _reports(theirs))
    ours.reset()
    theirs.reset()


def _calls(seed, n, make):
    rng = np.random.default_rng(seed)
    return [make(rng) for _ in range(n)]


@pytest.mark.parametrize("normalized", [False, True])
def test_confusion_meter(normalized):
    ours, theirs = _both("ConfusionMeter", 5, normalized=normalized)
    _feed((ours, theirs), _calls(0, 6, lambda r: ((r.integers(0, 5, 40), r.integers(0, 5, 40)),
                                                  {})))
    _check(ours, theirs)
    _same(_reports(ours), _reports(theirs))  # after reset: all zero


def test_time_meter(monkeypatch):
    clock = iter([10.0, 10.0, 12.5, 12.5, 14.0, 14.0, 20.0, 20.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    ours, theirs = pm.TimeMeter(), jm.TimeMeter()  # reset at 10.0
    for n in (3, 4):
        ours.add(n)
        theirs.add(n)
    _same(ours.summary(), theirs.summary())  # at 12.5
    assert ours.summary() == {"rate": 7 / 4.0, "elapsed": 4.0}  # at 14.0
    theirs.summary()
    _same(ours.detailed_summary(), theirs.detailed_summary())  # at 20.0


@pytest.mark.parametrize("seed", [0, 1])
def test_auc_meter(seed):
    ours, theirs = _both("AUCMeter")
    _same(ours.value(), theirs.value())  # empty: 0.5
    _feed((ours, theirs), _calls(seed, 5, lambda r: ((r.random(30), r.integers(0, 2, 30)), {})))
    ties = (np.round(np.linspace(0, 1, 30), 1), np.arange(30) % 2)  # tied scores, stable order
    _feed((ours, theirs), [(ties, {})])
    _check(ours, theirs)


@pytest.mark.parametrize("meter", ["APMeter", "mAPMeter"])
def test_ap_meters(meter):
    ours, theirs = _both(meter)
    _same(ours.value(), theirs.value())  # empty
    _feed((ours, theirs), _calls(2, 4, lambda r: ((r.random((12, 4)), r.integers(0, 2, (12, 4))),
                                                  {})))
    _feed((ours, theirs), _calls(3, 2, lambda r: ((r.random((6, 4)), r.integers(0, 2, (6, 4))),
                                                  {"weight": r.random(6)})))
    _feed((ours, theirs), [((np.random.default_rng(4).random((5, 4)), np.zeros((5, 4))), {})])
    _check(ours, theirs)


@pytest.mark.parametrize("accuracy", [False, True])
def test_class_error_meter(accuracy):
    ours, theirs = _both("ClassErrorMeter", topk=(3, 1, 2), accuracy=accuracy)
    _feed((ours, theirs), _calls(5, 5, lambda r: ((r.random((10, 6)), r.integers(0, 6, 10)), {})))
    for k in (1, 2, 3):
        assert ours.value(k) == theirs.value(k)
    _check(ours, theirs)


def test_moving_average_value_meter():
    ours, theirs = _both("MovingAverageValueMeter", 4)
    _same(ours.value(), theirs.value())  # empty
    for i, v in enumerate(np.random.default_rng(6).normal(size=11)):
        ours.add(v)
        theirs.add(v)
        _same(_reports(ours), _reports(theirs), f"after {i + 1}")
    _check(ours, theirs)


@pytest.mark.parametrize("root", [False, True])
def test_mse_meter(root):
    ours, theirs = _both("MSEMeter", root=root)
    _feed((ours, theirs), _calls(7, 4, lambda r: ((r.random((3, 5)), r.random((3, 5))), {})))
    _check(ours, theirs)


@pytest.mark.parametrize("kwargs", [{}, {"ignore_index": None, "normalized": True},
                                    {"ignore_index": (0, 4), "report_axis": [1, 3]}])
def test_iou_meter(kwargs):
    ours, theirs = _both("IoUMeter", 5, **kwargs)
    rng = np.random.default_rng(8)
    labels = rng.integers(0, 5, (2, 6, 6))
    labels[0, 0, :3] = 255  # ignored by default
    _feed((ours, theirs), [((rng.integers(0, 5, (2, 6, 6)), labels), {}),
                           ((rng.random((2, 5, 6, 6)), rng.integers(0, 4, (2, 6, 6))), {})])
    _check(ours, theirs)


def test_cohen_kappa():
    rng = np.random.default_rng(9)
    cases = [(rng.integers(0, 4, 50), rng.integers(0, 4, 50)),
             (np.arange(20) % 3, np.arange(20) % 3),         # perfect agreement
             (np.full(10, 2), np.full(10, 2)),                # p_e == 1: 0.0
             (np.array([7, 9, 7, 9]), np.array([9, 7, 7, 9]))]  # sparse labels
    for y1, y2 in cases:
        assert pm.cohen_kappa(y1, y2) == jm.cohen_kappa(y1, y2)


def test_cohen_kappa_of_empty_input_is_nan_where_jax_raises():
    """Deviation: the JAX package raises at ``labels.max()`` of no labels,
    before its own ``n == 0 -> nan`` branch; the port returns NaN."""
    empty = np.zeros(0, np.int64)
    with pytest.raises(ValueError):
        jm.cohen_kappa(empty, empty)
    assert math.isnan(pm.cohen_kappa(empty, empty))
    # and so a kappa meter whose mask keeps no pixel
    target = np.zeros((4, 4), np.int64)
    with pytest.raises(ValueError):
        jm.KappaMetrics().add([target], target, considered_classes=(1, 2))
    meter = pm.KappaMetrics()
    meter.add([target], target, considered_classes=(1, 2))
    assert math.isnan(meter.summary()["kappa0"])


def test_kappa_meters():
    rng = np.random.default_rng(10)
    ours, theirs = _both("KappaMetrics")
    for _ in range(3):
        target = rng.integers(0, 4, (2, 8, 8))
        preds = [rng.integers(0, 4, (2, 8, 8)) for _ in range(3)]
        for m in (ours, theirs):
            m.add(preds, target, considered_classes=(1, 2, 3))
    _check(ours, theirs)
    ours, theirs = _both("Kappa2Annotator")
    for gt in (None, rng.integers(0, 4, (8, 8))):
        p1, p2 = rng.integers(0, 4, (8, 8)), rng.integers(0, 4, (8, 8))
        for m in (ours, theirs):
            m.add(p1, p2, gt=gt)
    _check(ours, theirs)


def test_instance_value():
    ours, theirs = _both("InstanceValue")
    _same(_reports(ours), _reports(theirs))
    for v in (3, np.arange(4.0), "text"):
        ours.add(v)
        theirs.add(v)
        _same(_reports(ours), _reports(theirs))
    _check(ours, theirs)


def test_every_meter_and_export_has_a_counterpart():
    """Every class and function of the JAX meters module, and every name the
    JAX ``utils`` package exports, exists in the port."""
    names = {n for n, v in vars(jm).items()
             if not n.startswith("_") and callable(v) and getattr(v, "__module__", "") == jm.__name__}
    assert names and all(hasattr(pm, n) for n in names), sorted(n for n in names
                                                                  if not hasattr(pm, n))
    assert set(jutils.__all__) <= set(putils.__all__)
    for n in jutils.__all__:
        assert getattr(putils, n) is not None
