"""Tensor and dict helpers (counterpart of the JAX package's ``utils/general.py``)."""

from __future__ import annotations

import random
import subprocess
from typing import Any, Dict, Iterable, Mapping, Sequence

import numpy as np
import torch


def simplex(probs: torch.Tensor, axis: int = 1, atol: float = 1e-4) -> bool:
    """True if ``probs`` sums to 1 along ``axis`` within ``atol``."""
    s = torch.as_tensor(probs).sum(dim=axis).double()
    return bool(torch.allclose(s, torch.ones_like(s), rtol=1e-5, atol=atol))


def one_hot(t: torch.Tensor, axis: int = 1, atol: float = 1e-4) -> bool:
    """True if ``t`` is a simplex along ``axis`` whose entries are 0 or 1."""
    t = torch.as_tensor(t)
    return simplex(t, axis, atol) and bool(((t == 0) | (t == 1)).all())


def class2one_hot(labels: torch.Tensor, num_classes: int, class_axis: int = 1) -> torch.Tensor:
    """Integer label map -> int one-hot with the class axis at ``class_axis``:
    [B, H, W] -> [B, C, H, W] (class_axis=1) or [B, H, W, C] (class_axis=-1)."""
    oh = torch.nn.functional.one_hot(labels.long(), num_classes).to(torch.int32)
    if class_axis in (-1, oh.dim() - 1):
        return oh
    return oh.movedim(-1, class_axis)


def probs2one_hot(probs: torch.Tensor, class_axis: int = 1) -> torch.Tensor:
    """The argmax along ``class_axis`` as an int32 one-hot along that axis."""
    return class2one_hot(probs.argmax(dim=class_axis), probs.shape[class_axis],
                         class_axis=class_axis)


def logit2one_hot(logits: torch.Tensor, class_axis: int = 1) -> torch.Tensor:
    return probs2one_hot(logits, class_axis=class_axis)


def average_iter(values: Iterable[Any]):
    values = list(values)
    return sum(values) / float(len(values))


def weighted_average_iter(values: Sequence[Any], weights: Sequence[float]):
    if len(values) != len(weights):
        raise ValueError(f"{len(values)} values, {len(weights)} weights")
    return sum(v * w for v, w in zip(values, weights)) / float(sum(weights))


def flatten_dict(d: Mapping[str, Any], parent_key: str = "", sep: str = "/") -> Dict[str, Any]:
    items: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{parent_key}{sep}{k}" if parent_key else str(k)
        if isinstance(v, Mapping):
            items.update(flatten_dict(v, key, sep=sep))
        else:
            items[key] = v
    return items


def set_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def gethash(cwd: str = ".") -> str:
    """Current git hash for the run config snapshot, or "unknown"."""
    try:
        out = subprocess.check_output(["git", "rev-parse", "HEAD"], cwd=cwd,
                                      stderr=subprocess.DEVNULL)
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return out.decode().strip()


class ExceptionIgnorer:
    """Context manager that swallows the listed exception types (inference
    guards the Hausdorff meter's empty-mask ``RuntimeError`` with it, as the
    JAX package does)."""

    def __init__(self, *exceptions):
        self._exceptions = exceptions or (Exception,)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return exc_type is not None and issubclass(exc_type, self._exceptions)
