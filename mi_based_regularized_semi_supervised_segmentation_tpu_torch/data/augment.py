"""Host-side paired augmentation — keyed, deterministic, numpy-native.

A copy of the JAX package's ``data/augment.py`` for the PyTorch port, with
its native fused fast path (``data/native.py``): ``PairedTransform`` with a
crop augments in one pass of the native host library where it is there. That
path is not bit-compatible with the numpy one, in the JAX package either: the
jitter differs by up to ~1.2e-7 and a nearest-neighbour tie of the rotation
now and then lands on the neighbouring pixel (``csrc/host_pipeline.cpp``).
Each path equals its JAX counterpart bit for bit.

Capability parity with the reference's PIL pipeline
(the original project's semi_seg/augment.py:7-53 ACDCStrongTransforms;
contrastyou/augment/sequential_wrapper.py:11-100 SequentialWrapper[Twice];
WHEEL::deepclustering2/augment/pil_augment.py RandomRotation/RandomCrop/
flips/ToLabel). The reference synchronized image/target geometry by replaying
a shared python-RNG seed; here every sample draw gets an explicit
``np.random.Generator`` derived from (epoch_seed, sample_index), and geometry
parameters are sampled ONCE then applied to both image and label — determinism
by construction, and trivially parallel across worker threads.

Geometry: rotation (uniform +/- degrees, nearest resample, like PIL's
default), vertical/horizontal flips (p=0.5), random crop to 224 (padding if
needed). Intensity: brightness/contrast jitter in [0.5, 1.5] (the
ColorJitter surface on grayscale; saturation/hue are no-ops on 1-channel
data). Output: image float32 [H, W, 1] in [0, 1]-ish, label int32 [H, W].
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


def _rotation_map(shape: Tuple[int, int], angle_deg: float) -> Optional[np.ndarray]:
    """Where ``_rotate_nearest`` reads each output pixel of an [H, W] canvas
    rotated by ``angle_deg``: its flat source index, H * W (the fill) where
    it lands outside; None below 1e-6 degrees (the identity). A function of
    the shape and the angle alone, so an image and its label map share one.
    The same float64 operations, in the same order, as the JAX package's
    pixel-by-pixel form, each product taken once a row or a column."""
    if abs(angle_deg) < 1e-6:
        return None
    h, w = shape
    theta = np.deg2rad(angle_deg)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    xc = np.arange(w, dtype=np.float64) - cx
    yc = (np.arange(h, dtype=np.float64) - cy)[:, None]
    # inverse mapping: output <- input rotated by -theta
    cos_t, sin_t = np.cos(theta), np.sin(theta)
    sx = np.rint((cos_t * xc - sin_t * yc) + cx)
    sy = np.rint((sin_t * xc + cos_t * yc) + cy)
    valid = (sx >= 0) & (sx < w) & (sy >= 0) & (sy < h)
    source = sy * w + sx  # integral float64 values: exact
    source[~valid] = h * w
    return source.astype(np.int64)


def _apply_rotation(arr: np.ndarray, rotation: Optional[np.ndarray],
                    fill: float = 0.0) -> np.ndarray:
    """``arr`` [H, W] read through a ``_rotation_map`` of its shape."""
    if rotation is None:
        return arr
    return np.concatenate([arr.reshape(-1), np.full(1, fill, arr.dtype)])[rotation]


def _rotate_nearest(arr: np.ndarray, angle_deg: float, fill: float = 0.0) -> np.ndarray:
    """Rotate [H, W] array by angle (counter-clockwise, like PIL) with
    nearest-neighbor sampling, keeping the original canvas size."""
    return _apply_rotation(arr, _rotation_map(arr.shape, angle_deg), fill)


def _pad_to(arr: np.ndarray, th: int, tw: int, fill: float = 0.0) -> np.ndarray:
    h, w = arr.shape
    if h >= th and w >= tw:
        return arr
    ph, pw = max(th - h, 0), max(tw - w, 0)
    top, left = ph // 2, pw // 2
    return np.pad(arr, ((top, ph - top), (left, pw - left)), constant_values=fill)


@dataclasses.dataclass
class GeometryParams:
    angle: float = 0.0
    vflip: bool = False
    hflip: bool = False
    crop_y: int = 0
    crop_x: int = 0


class PairedTransform:
    """One synchronized geometric + separate intensity transform.

    Mirrors SequentialWrapper: the *same* geometry is applied to image and
    target; intensity jitter touches the image only; the target becomes an
    integer label map (ToLabel)."""

    def __init__(
        self,
        rotation: float = 45.0,
        vflip: bool = True,
        hflip: bool = True,
        crop: Optional[int] = 224,
        center_crop: bool = False,
        jitter: Optional[Tuple[float, float]] = (0.5, 1.5),
    ) -> None:
        self.rotation = rotation
        self.vflip = vflip
        self.hflip = hflip
        self.crop = crop
        self.center_crop = center_crop
        self.jitter = jitter

    def sample_params(self, rng: np.random.Generator, shape: Tuple[int, int]) -> GeometryParams:
        h, w = shape
        p = GeometryParams()
        if self.rotation:
            p.angle = float(rng.uniform(-self.rotation, self.rotation))
        if self.vflip:
            p.vflip = bool(rng.random() < 0.5)
        if self.hflip:
            p.hflip = bool(rng.random() < 0.5)
        if self.crop:
            th = tw = self.crop
            if self.center_crop:
                p.crop_y = max((h - th) // 2, 0)
                p.crop_x = max((w - tw) // 2, 0)
            else:
                p.crop_y = int(rng.integers(0, max(h - th, 0) + 1))
                p.crop_x = int(rng.integers(0, max(w - tw, 0) + 1))
        return p

    def apply_geometry(self, arr: np.ndarray, p: GeometryParams,
                       rotation: Optional[np.ndarray] = None) -> np.ndarray:
        """``rotation``: the ``_rotation_map`` of ``arr``'s shape and
        ``p.angle``, made here when None."""
        if self.rotation:
            arr = _apply_rotation(arr, rotation if rotation is not None
                                  else _rotation_map(arr.shape, p.angle))
        if p.vflip:
            arr = arr[::-1, :]
        if p.hflip:
            arr = arr[:, ::-1]
        if self.crop:
            arr = _pad_to(arr, self.crop, self.crop)
            arr = arr[p.crop_y:p.crop_y + self.crop, p.crop_x:p.crop_x + self.crop]
        return np.ascontiguousarray(arr)

    def apply_geometry_pair(self, img: np.ndarray, target: Optional[np.ndarray],
                            p: GeometryParams) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``apply_geometry`` of the image (as float32) and of the target (as
        int32; None passes), through one rotation map where their shapes
        agree."""
        rotation = _rotation_map(img.shape, p.angle) if self.rotation else None
        out_img = self.apply_geometry(img.astype(np.float32), p, rotation)
        if target is None:
            return out_img, None
        same = target.shape == img.shape
        return out_img, self.apply_geometry(target, p, rotation if same else None).astype(np.int32)

    def __call__(
        self, img: np.ndarray, target: Optional[np.ndarray], rng: np.random.Generator
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """img: [H, W] float32 in [0,1]; target: [H, W] int or None."""
        p = self.sample_params(rng, img.shape)

        # the native fused path; the draws in the numpy path's order
        # (geometry, brightness, contrast)
        if self.crop is not None:
            from . import native

            if native.available():
                if self.jitter is not None:
                    lo, hi = self.jitter
                    brightness = float(rng.uniform(lo, hi))
                    contrast = float(rng.uniform(lo, hi))
                else:
                    brightness, contrast = -1.0, 1.0
                out = native.augment_pair(
                    img, target, p.angle, p.vflip, p.hflip, p.crop_y, p.crop_x,
                    self.crop, brightness, contrast,
                )
                if out is not None:
                    n_img, n_gt = out
                    return n_img[..., None], n_gt

        out_img, out_tgt = self.apply_geometry_pair(img, target, p)
        if self.jitter is not None:
            lo, hi = self.jitter
            brightness = rng.uniform(lo, hi)
            contrast = rng.uniform(lo, hi)
            out_img = out_img * brightness
            mean = out_img.mean()
            out_img = (out_img - mean) * contrast + mean
            out_img = np.clip(out_img, 0.0, None)
        return out_img[..., None], out_tgt


class TwiceTransform:
    """Two views per draw (SequentialWrapperTwice). total_freedom=True means
    independent geometry per view; False shares geometry, independent
    intensity."""

    def __init__(self, base: PairedTransform, total_freedom: bool = True) -> None:
        self.base = base
        self.total_freedom = total_freedom

    def __call__(self, img, target, rng: np.random.Generator):
        if self.total_freedom:
            return [self.base(img, target, rng), self.base(img, target, rng)]
        p = self.base.sample_params(rng, img.shape)
        # the geometry is a function of the slice and p alone: applied once, each
        # view a copy of it before its own jitter (the draws in the same order)
        geo_img, geo_tgt = self.base.apply_geometry_pair(img, target, p)
        views = []
        for _ in range(2):
            out_img = geo_img.copy()
            out_tgt = None if geo_tgt is None else geo_tgt.copy()
            if self.base.jitter is not None:
                lo, hi = self.base.jitter
                out_img = out_img * rng.uniform(lo, hi)
                mean = out_img.mean()
                out_img = (out_img - mean) * rng.uniform(lo, hi) + mean
                out_img = np.clip(out_img, 0.0, None)
            views.append((out_img[..., None], out_tgt))
        return views


class ACDCStrongTransforms:
    """The reference's preset surface (semi_seg/augment.py:7-53)."""

    pretrain = PairedTransform(rotation=45, vflip=True, hflip=True, crop=224,
                               jitter=(0.5, 1.5))
    label = PairedTransform(rotation=30, vflip=False, hflip=False, crop=224, jitter=None)
    val = PairedTransform(rotation=0, vflip=False, hflip=False, crop=224,
                          center_crop=True, jitter=None)
    trainval = PairedTransform(rotation=0, vflip=False, hflip=False, crop=224, jitter=None)


# ---------------------------------------------------------------------------
# Functional transform zoo — the remaining pil_augment / tensor_augment
# members (WHEEL::deepclustering2/augment/pil_augment.py:Identity/Resize/
# SobelProcess/RandomApply/RandomChoice, tensor_augment.py:GaussianNoise),
# as pure numpy ops on [H, W] arrays.
# ---------------------------------------------------------------------------

def resize(arr: np.ndarray, size: Tuple[int, int], order: str = "bilinear") -> np.ndarray:
    """Resize [H, W] to (th, tw); 'nearest' keeps label maps integral."""
    th, tw = size
    h, w = arr.shape
    if order == "nearest":
        ys = np.clip(np.round(np.linspace(0, h - 1, th)).astype(int), 0, h - 1)
        xs = np.clip(np.round(np.linspace(0, w - 1, tw)).astype(int), 0, w - 1)
        return np.ascontiguousarray(arr[np.ix_(ys, xs)])
    ys = np.linspace(0, h - 1, th)
    xs = np.linspace(0, w - 1, tw)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None]
    wx = (xs - x0)[None, :]
    a = arr.astype(np.float32)
    top = a[np.ix_(y0, x0)] * (1 - wx) + a[np.ix_(y0, x1)] * wx
    bot = a[np.ix_(y1, x0)] * (1 - wx) + a[np.ix_(y1, x1)] * wx
    return top * (1 - wy) + bot * wy


def sobel(arr: np.ndarray) -> np.ndarray:
    """Sobel gradient magnitude (SobelProcess) of an [H, W] image."""
    kx = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
    ky = kx.T
    a = np.pad(arr.astype(np.float32), 1, mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(a, (3, 3))
    gx = np.einsum("hwij,ij->hw", win, kx)
    gy = np.einsum("hwij,ij->hw", win, ky)
    return np.sqrt(gx * gx + gy * gy)


def gaussian_noise(arr: np.ndarray, rng: np.random.Generator, std: float = 0.1) -> np.ndarray:
    """Additive gaussian noise (tensor_augment GaussianNoise)."""
    return arr.astype(np.float32) + rng.normal(0.0, std, arr.shape).astype(np.float32)


class Identity:
    def __call__(self, arr, *_args, **_kw):
        return arr


class RandomApply:
    """Apply ``fn`` with probability p (pil_augment RandomApply)."""

    def __init__(self, fn, p: float = 0.5) -> None:
        self.fn = fn
        self.p = float(p)

    def __call__(self, arr, rng: np.random.Generator):
        return self.fn(arr) if rng.random() < self.p else arr


class RandomChoice:
    """Apply one uniformly-chosen member (pil_augment RandomChoice)."""

    def __init__(self, fns) -> None:
        self.fns = list(fns)

    def __call__(self, arr, rng: np.random.Generator):
        return self.fns[int(rng.integers(len(self.fns)))](arr)
