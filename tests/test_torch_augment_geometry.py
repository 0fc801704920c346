"""The port's host geometry (``data/augment.py``) against the JAX package's,
bit for bit: the rotation through one map a slice (``_rotation_map``: each
output pixel's flat source index, shared by the image and its label map), the numpy path of ``PairedTransform``, and
``TwiceTransform`` whose views share a geometry (the pretrain decoder's
loader), which applies it once and jitters each view, with the generator's
draws in the JAX order; then ``TwiceLoader`` batches of both packages on one
synthetic set."""

import numpy as np
import pytest

from mi_based_regularized_semi_supervised_segmentation_tpu.data import augment as jax_augment
from mi_based_regularized_semi_supervised_segmentation_tpu.data import native as jax_native
from mi_based_regularized_semi_supervised_segmentation_tpu.data.acdc import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.loader import (
    TwiceLoader as JTwiceLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    TwiceLoader,
    augment,
    generate_synthetic_acdc,
    native,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

ANGLES = (0.0, 5e-7, 1e-6, 90.0, -90.0, 180.0, 45.0, -45.0, 30.5, 0.25)
SHAPES = ((256, 256), (217, 190), (7, 9))


def _jax_native_loads() -> bool:
    jax_native._lib, jax_native._tried = None, False
    return jax_native.available()


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Both packages on the native host path, or both on numpy."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    if request.param == "numpy":
        monkeypatch.setenv("MISST_DISABLE_NATIVE", "1")
    native.reset()
    if request.param == "native":
        assert native.available() and _jax_native_loads()
    else:
        assert not native.available() and not jax_native.available()
    yield request.param
    native.reset()


@pytest.mark.parametrize("shape", SHAPES)
def test_rotation_map_equals_the_jax_rotation(shape):
    """Every angle of ANGLES and 20 drawn in [-45, 45]: float32 images and
    int32 labels, contiguous and not, equal to the JAX ``_rotate_nearest``;
    one map serves both arrays."""
    rng = np.random.default_rng(1)
    img = rng.random(shape, dtype=np.float32)
    lab = rng.integers(0, 4, shape).astype(np.int32)
    for angle in ANGLES + tuple(rng.uniform(-45, 45, 20)):
        rotation = augment._rotation_map(shape, angle)
        assert (rotation is None) == (abs(angle) < 1e-6)
        for arr in (img, lab, np.asfortranarray(img), img[::-1, ::-1]):
            want = jax_augment._rotate_nearest(arr, angle)
            for got in (augment._rotate_nearest(arr, angle),
                        augment._apply_rotation(arr, rotation)):
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jitter", [(0.5, 1.5), None])
def test_twice_transform_equals_the_jax_one(host_path, jitter):
    """Shared and independent geometry, with and without the jitter, on each
    host path: both views equal to the JAX package's and the generator left
    where the JAX transform leaves it; the views' arrays are their own."""
    rng = np.random.default_rng(2)
    img = rng.random((256, 256), dtype=np.float32)
    gt = rng.integers(0, 4, (256, 256)).astype(np.int32)
    kw = dict(rotation=45, vflip=True, hflip=True, crop=224, jitter=jitter)
    for free in (False, True):
        ours = augment.TwiceTransform(augment.PairedTransform(**kw), total_freedom=free)
        theirs = jax_augment.TwiceTransform(jax_augment.PairedTransform(**kw),
                                            total_freedom=free)
        for seed in range(6):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = ours(img, gt, r1), theirs(img, gt, r2)
            for (gi, gl), (wi, wl) in zip(got, want):
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
            assert r1.random() == r2.random()
            (i0, l0), (i1, l1) = got
            assert not np.shares_memory(i0, i1) and not np.shares_memory(l0, l1)


def test_paired_transform_numpy_path_equals_the_jax_one(monkeypatch):
    monkeypatch.setenv("MISST_DISABLE_NATIVE", "1")
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    native.reset()
    try:
        rng = np.random.default_rng(3)
        img = rng.random((240, 250), dtype=np.float32)
        gt = rng.integers(0, 4, (240, 250)).astype(np.int32)
        for kw in (dict(rotation=45, crop=224), dict(rotation=30, crop=None, jitter=None),
                   dict(rotation=0, crop=224, center_crop=True, jitter=None)):
            ours, theirs = augment.PairedTransform(**kw), jax_augment.PairedTransform(**kw)
            for seed in range(6):
                (gi, gl), (wi, wl) = (t(img, gt, np.random.default_rng(seed))
                                      for t in (ours, theirs))
                np.testing.assert_array_equal(gi, wi)
                np.testing.assert_array_equal(gl, wl)
    finally:
        native.reset()


def test_twice_loader_shared_geometry_batches_equal_the_jax_ones(tmp_path, host_path):
    """The pretrain decoder's loader (shared geometry) and the encoder's
    (independent): 3 batches of 4 slices from each package, bit-equal."""
    generate_synthetic_acdc(str(tmp_path), num_train_patients=2, num_val_patients=1,
                            slices_per_patient=4, size=64)
    tf = dict(rotation=45, vflip=True, hflip=True, crop=48, jitter=(0.5, 1.5))
    for free in (False, True):
        ours = TwiceLoader(ACDCDataset(str(tmp_path), "train"),
                           augment.PairedTransform(**tf), batch_size=4,
                           total_freedom=free, seed=4, num_workers=2)
        theirs = JTwiceLoader(JACDCDataset(str(tmp_path), "train"),
                              jax_augment.PairedTransform(**tf), batch_size=4,
                              total_freedom=free, seed=4, num_workers=2)
        for a, b, _ in zip(ours, theirs, range(3)):
            for key in ("image", "target", "image_tf", "target_tf"):
                np.testing.assert_array_equal(a[key], b[key])
            assert a["filename"] == b["filename"]
