"""Class-based transform zoo — the full surface of the reference wheel's
``WHEEL::deepclustering2/augment/pil_augment.py:1-596``, re-expressed on
numpy arrays (images are ``[H, W]`` / ``[H, W, C]`` float or uint8, labels
integer ``[H, W]``). A copy of the JAX package's ``data/pil_augment.py`` for
the PyTorch port, on the port's ``_rotate_nearest`` / ``resize`` / ``sobel``.

Design deltas from the wheel, as in the JAX package:

- No PIL objects in the pipeline: transforms consume/produce numpy arrays.
- Stochastic transforms take an EXPLICIT ``rng`` (``numpy.random.Generator``)
  keyword instead of mutating the global ``random`` state. When ``rng`` is
  omitted a module-level generator is used (the wheel's implicit-global
  ergonomics for one-off use).
- ``ToTensor`` returns float32 numpy in [0, 1] (channels-last) and
  ``ToLabel`` int64 numpy.

Deviation from the JAX package: ``Compose``, ``RandomApplyList`` and
``RandomChoiceList`` pass ``rng`` only to a transform whose ``__call__``
takes it (a parameter named ``rng`` or ``**kwargs``). The JAX package calls
every transform with ``rng=`` and, on any ``TypeError``, calls it again
without: a ``TypeError`` raised inside a transform is swallowed and the
transform rerun on the unseeded module generator. Here it propagates.

Every class keeps the wheel's name, constructor signature, and semantics;
parity targets are cited per class.
"""

from __future__ import annotations

import inspect
import numbers
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .augment import _rotate_nearest, resize as _resize_hw, sobel as _sobel_hw

_DEFAULT_RNG = np.random.default_rng()


def _rng_of(rng: Optional[np.random.Generator]) -> np.random.Generator:
    return rng if rng is not None else _DEFAULT_RNG


def _pair(size) -> Tuple[int, int]:
    if isinstance(size, numbers.Number):
        return int(size), int(size)
    assert len(size) == 2, size
    return int(size[0]), int(size[1])


def _split_channels(arr: np.ndarray):
    """-> (list of [H, W] planes, had_channel_axis)."""
    if arr.ndim == 2:
        return [arr], False
    assert arr.ndim == 3, arr.shape
    return [arr[..., c] for c in range(arr.shape[-1])], True


def _join_channels(planes, had_axis: bool) -> np.ndarray:
    if not had_axis:
        return planes[0]
    return np.stack(planes, axis=-1)


def _takes_rng(transform) -> bool:
    """Whether ``transform(arr, rng=...)`` is a valid call: its ``__call__``
    has a parameter ``rng`` or ``**kwargs``."""
    try:
        params = inspect.signature(transform).parameters.values()
    except (TypeError, ValueError):  # no signature to read: call it without rng
        return False
    return any(p.name == "rng" or p.kind is inspect.Parameter.VAR_KEYWORD for p in params)


def _apply(transform, arr, rng: Optional[np.random.Generator]):
    """``transform`` on ``arr``, given ``rng`` only if it takes one."""
    return transform(arr, rng=rng) if _takes_rng(transform) else transform(arr)


def _np_pad(arr: np.ndarray, padding, fill, padding_mode: str) -> np.ndarray:
    """torchvision-style pad on [H, W](xC): padding int | (lr, tb) |
    (l, t, r, b) — WHEEL pil_augment.py:133-159 doc contract."""
    if isinstance(padding, numbers.Number):
        l = t = r = b = int(padding)
    elif len(padding) == 2:
        l = r = int(padding[0])
        t = b = int(padding[1])
    else:
        l, t, r, b = (int(x) for x in padding)
    spec = [(t, b), (l, r)] + ([(0, 0)] if arr.ndim == 3 else [])
    if padding_mode == "constant":
        return np.pad(arr, spec, mode="constant", constant_values=fill)
    mode = {"edge": "edge", "reflect": "reflect", "symmetric": "symmetric"}[padding_mode]
    return np.pad(arr, spec, mode=mode)


class Identity:
    """WHEEL pil_augment.py:37-42."""

    def __call__(self, arr, *_a, **_k):
        return arr

    def __repr__(self):
        return "Identity"


class Compose:
    """Sequential application; rng (if given) is threaded to transforms that
    accept it (torchvision Compose re-export in the wheel)."""

    def __init__(self, transforms: Sequence) -> None:
        self.transforms = list(transforms)

    def __call__(self, arr, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            arr = _apply(t, arr, rng)
        return arr

    def __repr__(self):
        return "Compose(" + ", ".join(repr(t) for t in self.transforms) + ")"


class Img2Tensor:
    """Grey/color image -> float32 array with include_rgb / include_grey
    channel selection (WHEEL pil_augment.py:45-90). Greyscale conversion
    uses the ITU-R 601 luma weights PIL's convert("L") applies."""

    def __init__(self, include_rgb: bool = False, include_grey: bool = True) -> None:
        assert include_rgb or include_grey, (include_rgb, include_grey)
        self.include_rgb = include_rgb
        self.include_grey = include_grey

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        a = np.asarray(arr)
        assert a.ndim in (2, 3), a.shape
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        else:
            a = a.astype(np.float32)
        if a.ndim == 2:
            assert self.include_grey, "grey input needs include_grey=True"
            return a[..., None]
        assert a.shape[-1] == 3, a.shape
        grey = (0.299 * a[..., 0] + 0.587 * a[..., 1] + 0.114 * a[..., 2])[..., None]
        if self.include_rgb and self.include_grey:
            return np.concatenate([grey, a], axis=-1)
        return grey if self.include_grey else a

    def __repr__(self):
        return (f"Img2Tensor(include_rgb={self.include_rgb}, "
                f"include_grey={self.include_grey})")


class PILCutout:
    """Zero (pad_value) a random square box, box size uniform in
    [min_box, max_box], center at least half a box from the border
    (WHEEL pil_augment.py:93-123)."""

    def __init__(self, min_box: int, max_box: int, pad_value: int = 0) -> None:
        self.min_box = int(min_box)
        self.max_box = int(max_box)
        self.pad_value = int(pad_value)

    def __call__(self, arr: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        out = np.array(arr, copy=True)
        h, w = out.shape[:2]
        box_sz = int(rng.integers(self.min_box, self.max_box + 1))
        half = box_sz // 2
        x_c = int(rng.integers(half, w - half))
        y_c = int(rng.integers(half, h - half))
        out[y_c - half:y_c + half, x_c - half:x_c + half, ...] = self.pad_value
        return out

    def __repr__(self):
        return f"PILCutout({self.min_box}, {self.max_box})"


class RandomCrop:
    """Random (th, tw) crop with optional pre-pad / pad_if_needed / fill /
    padding_mode (WHEEL pil_augment.py:126-229)."""

    def __init__(self, size, padding=None, pad_if_needed: bool = False,
                 fill: Union[int, float] = 0, padding_mode: str = "constant"):
        self.size = _pair(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode

    def __call__(self, arr: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        th, tw = self.size
        if self.padding is not None:
            arr = _np_pad(arr, self.padding, self.fill, self.padding_mode)
        h, w = arr.shape[:2]
        if self.pad_if_needed and w < tw:
            arr = _np_pad(arr, (tw - w, 0), self.fill, self.padding_mode)
        if self.pad_if_needed and arr.shape[0] < th:
            arr = _np_pad(arr, (0, th - arr.shape[0]), self.fill, self.padding_mode)
        h, w = arr.shape[:2]
        if (h, w) == (th, tw):
            return arr
        i = int(rng.integers(0, h - th + 1))
        j = int(rng.integers(0, w - tw + 1))
        return np.ascontiguousarray(arr[i:i + th, j:j + tw, ...])

    def __repr__(self):
        return f"RandomCrop(size={self.size}, padding={self.padding})"


class CenterCrop:
    """WHEEL pil_augment.py:273-298."""

    def __init__(self, size):
        self.size = _pair(size)

    def __call__(self, arr: np.ndarray, rng=None):
        th, tw = self.size
        h, w = arr.shape[:2]
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return np.ascontiguousarray(arr[i:i + th, j:j + tw, ...])

    def __repr__(self):
        return f"CenterCrop(size={self.size})"


class Resize:
    """Resize to (h, w), or match the SMALLER edge when size is an int
    (torchvision semantics, WHEEL pil_augment.py:231-270).
    interpolation: 'bilinear' | 'nearest'."""

    def __init__(self, size, interpolation: str = "bilinear"):
        assert isinstance(size, int) or len(size) == 2
        assert interpolation in ("bilinear", "nearest"), interpolation
        self.size = size
        self.interpolation = interpolation

    def __call__(self, arr: np.ndarray, rng=None):
        h, w = arr.shape[:2]
        if isinstance(self.size, int):
            s = self.size
            if h <= w:
                th, tw = s, max(1, int(round(w * s / h)))
            else:
                th, tw = max(1, int(round(h * s / w))), s
        else:
            th, tw = _pair(self.size)
        planes, had = _split_channels(np.asarray(arr))
        out = [_resize_hw(p, (th, tw), order=self.interpolation) for p in planes]
        return _join_channels(out, had)

    def __repr__(self):
        return f"Resize(size={self.size}, interpolation={self.interpolation})"


class RandomRotation:
    """Rotate by a uniform angle in ``degrees`` (scalar -> (-d, +d)); nearest
    resample, same output size (expand unsupported — the reference config
    never sets it; raises if asked) (WHEEL pil_augment.py:301-375)."""

    def __init__(self, degrees, resample=False, expand=False, center=None):
        if isinstance(degrees, numbers.Number):
            if degrees < 0:
                raise ValueError("single-number degrees must be positive")
            self.degrees = (-float(degrees), float(degrees))
        else:
            if len(degrees) != 2:
                raise ValueError("degrees sequence must have length 2")
            self.degrees = (float(degrees[0]), float(degrees[1]))
        if expand or center is not None:
            raise NotImplementedError(
                "expand/center are not used by any reference config")
        self.resample = resample

    def __call__(self, arr: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        angle = float(rng.uniform(self.degrees[0], self.degrees[1]))
        planes, had = _split_channels(np.asarray(arr))
        out = [_rotate_nearest(p, angle) for p in planes]
        return _join_channels(out, had)

    def __repr__(self):
        return f"RandomRotation(degrees={self.degrees})"


class RandomHorizontalFlip:
    """WHEEL pil_augment.py:378-401 (flip axis 1 w.p. p)."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def __call__(self, arr: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        if rng.random() < self.p:
            return np.ascontiguousarray(arr[:, ::-1, ...])
        return arr

    def __repr__(self):
        return f"RandomHorizontalFlip(p={self.p})"


class RandomVerticalFlip:
    """WHEEL pil_augment.py:404-427 (flip axis 0 w.p. p)."""

    def __init__(self, p: float = 0.5):
        self.p = float(p)

    def __call__(self, arr: np.ndarray, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        if rng.random() < self.p:
            return np.ascontiguousarray(arr[::-1, ...])
        return arr

    def __repr__(self):
        return f"RandomVerticalFlip(p={self.p})"


class SobelProcess:
    """Sobel dx/dy channels, optionally stacked on the input
    (WHEEL pil_augment.py:430-487: returns cat([dx, dy]) — NOT magnitude —
    with include_origin prepending the original)."""

    _KX = np.array([[1, 0, -1], [2, 0, -2], [1, 0, -1]], np.float32)
    _KY = np.array([[1, 2, 1], [0, 0, 0], [-1, -2, -1]], np.float32)

    def __init__(self, include_origin: bool = False) -> None:
        self.include_origin = include_origin

    @classmethod
    def _conv(cls, p: np.ndarray, k: np.ndarray) -> np.ndarray:
        a = np.pad(p.astype(np.float32), 1, mode="constant")
        win = np.lib.stride_tricks.sliding_window_view(a, (3, 3))
        return np.einsum("hwij,ij->hw", win, k)

    def __call__(self, arr: np.ndarray, rng=None) -> np.ndarray:
        a = np.asarray(arr, np.float32)
        planes, _ = _split_channels(a)
        grey = planes[0] if len(planes) == 1 else np.mean(np.stack(planes), 0)
        dx = self._conv(grey, self._KX)[..., None]
        dy = self._conv(grey, self._KY)[..., None]
        parts = ([a if a.ndim == 3 else a[..., None]] if self.include_origin else [])
        return np.concatenate(parts + [dx, dy], axis=-1)

    def __repr__(self):
        return f"SobelProcess(include_origin={self.include_origin})"


class RandomTransforms:
    """Base holding a transform list (WHEEL pil_augment.py:490-509)."""

    def __init__(self, transforms: Sequence) -> None:
        assert isinstance(transforms, (list, tuple))
        self.transforms = list(transforms)

    def __call__(self, *a, **k):
        raise NotImplementedError

    def __repr__(self):
        return (self.__class__.__name__ + "("
                + ", ".join(repr(t) for t in self.transforms) + ")")


class RandomApplyList(RandomTransforms):
    """Apply the whole transform LIST with probability p
    (WHEEL pil_augment.py:512-540; named *List to coexist with the
    functional single-callable RandomApply in data/augment.py)."""

    def __init__(self, transforms: Sequence, p: float = 0.5):
        super().__init__(transforms)
        self.p = float(p)

    def __call__(self, arr, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        if self.p < rng.random():
            return arr
        for t in self.transforms:
            arr = _apply(t, arr, rng)
        return arr


class RandomChoiceList(RandomTransforms):
    """Apply ONE uniformly chosen transform from the list
    (WHEEL pil_augment.py:543-549)."""

    def __call__(self, arr, rng: Optional[np.random.Generator] = None):
        rng = _rng_of(rng)
        t = self.transforms[int(rng.integers(0, len(self.transforms)))]
        return _apply(t, arr, rng)


class ToTensor:
    """uint8 [0,255] -> float32 [0,1]; float arrays pass through; always
    channels-last with an explicit channel axis
    (WHEEL pil_augment.py:552-576, minus the torch dependency)."""

    def __call__(self, arr, rng=None) -> np.ndarray:
        a = np.asarray(arr)
        if a.dtype == np.uint8:
            a = a.astype(np.float32) / 255.0
        else:
            a = a.astype(np.float32)
        if a.ndim == 2:
            a = a[..., None]
        return a

    def __repr__(self):
        return "ToTensor()"


class ToLabel:
    """Integer label map with optional value remapping
    (WHEEL pil_augment.py:579-596)."""

    def __init__(self, mapping: Optional[Dict[int, int]] = None) -> None:
        self.mapping = dict(mapping) if mapping else None

    def __call__(self, arr, rng=None) -> np.ndarray:
        a = np.asarray(arr)
        if self.mapping is not None:
            lut_size = max(int(a.max(initial=0)) + 1,
                           max(self.mapping) + 1)
            lut = np.arange(lut_size, dtype=np.int64)
            for k, v in self.mapping.items():
                lut[k] = v
            a = lut[a.astype(np.int64)]
        return a.astype(np.int64)

    def __repr__(self):
        return f"ToLabel(mapping={self.mapping})"


__all__ = [
    "CenterCrop", "Compose", "Identity", "Img2Tensor", "PILCutout",
    "RandomApplyList", "RandomChoiceList", "RandomCrop",
    "RandomHorizontalFlip", "RandomRotation", "RandomTransforms",
    "RandomVerticalFlip", "Resize", "SobelProcess", "ToLabel", "ToTensor",
]
