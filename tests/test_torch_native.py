"""The port's native host pipeline (``data/native.py`` over
``csrc/host_pipeline.cpp``, built by ``ops/build.py:build_host``) against the
JAX package's (``data/native.py`` over ``native/src/host_pipeline.cpp``).

Like with like: the port's native path equals the JAX native path bit for
bit, and the port's numpy path the JAX numpy path. Native against numpy is
not bit-equal in either package; that gap is pinned here on both sides, on a
uniform random 256^2 image with random labels in 0..3, cropped to 224 by
``ACDCStrongTransforms.pretrain`` under ``default_rng(seed)``, seeds 0..49:
- the geometry (jitter off) differs on seed 27 alone (angle 17.796 degrees,
  both flips, crop at (19, 10)): 4 image pixels, 2 of them label pixels,
  where a nearest-neighbour tie lands on the other source pixel;
- with jitter, the other 49 seeds differ by at most 2.4e-7 (1.19e-7 seen:
  the library's jitter runs in double from float32 factors, numpy's in
  float32).
"""

import ctypes
import io

import numpy as np
import pytest
from PIL import Image

from mi_based_regularized_semi_supervised_segmentation_tpu.data import native as jax_native
from mi_based_regularized_semi_supervised_segmentation_tpu.data.acdc import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.augment import (
    ACDCStrongTransforms as JACDCStrongTransforms,
    PairedTransform as JPairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    ACDCStrongTransforms,
    PairedTransform,
    generate_synthetic_acdc,
    native,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import build

from test_torch_prefetch import _jax_native_loads

JITTER_GAP = 2.4e-7  # native vs numpy jitter, either package (1.19e-7 seen)
TIE_SEED, TIE_IMAGE_PIXELS, TIE_LABEL_PIXELS = 27, 4, 2


@pytest.fixture(autouse=True)
def _both_native(monkeypatch):
    """Each test starts with both bindings loaded afresh (and the port's
    counts at 0); the JAX binding's state is put back after it."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    monkeypatch.delenv("MISST_DISABLE_NATIVE", raising=False)
    native.reset()
    assert native.available() and _jax_native_loads()
    native.reset_call_counts()
    yield
    native.reset()


def _numpy_only(monkeypatch):
    """Both packages on their numpy path from here on."""
    monkeypatch.setenv("MISST_DISABLE_NATIVE", "1")
    native.reset()
    jax_native._lib, jax_native._tried = None, False
    assert not native.available() and not jax_native.available()


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_native")
    generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                            slices_per_patient=3, size=64)
    return root


def _pair(shape=(256, 256), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random(shape, dtype=np.float32),
            rng.integers(0, 4, shape).astype(np.int32))


def test_the_binding_builds_into_build_torch_host():
    path = build.host_library_path("host_pipeline")
    assert path.parent == build.HOST_BUILD_DIR and path.is_file()
    assert path.name.startswith("libhost_pipeline_") and path.suffix == ".so"
    assert isinstance(native._lib, ctypes.CDLL)
    assert build.HOST_FLAGS == ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def test_the_library_name_hashes_the_host_cpu(monkeypatch):
    """A ``-march=native`` library built on one CPU is never loaded on another."""
    here = build.host_library_path("host_pipeline")
    monkeypatch.setattr(build, "host_cpu", lambda: build.platform.machine() + "\nflags : sse2")
    elsewhere = build.host_library_path("host_pipeline")
    assert elsewhere.parent == here.parent and elsewhere != here


def test_decode_equals_pil_and_the_jax_decoder(data_root):
    pngs = sorted((data_root / "ACDC_contrast").rglob("*.png"))
    assert len(pngs) >= 20
    for path in pngs:
        data = path.read_bytes()
        ours = native.decode_png_gray8(data)
        with Image.open(path) as im:
            np.testing.assert_array_equal(ours, np.asarray(im), err_msg=str(path))
        np.testing.assert_array_equal(ours, jax_native.decode_png_gray8(data))
    assert native.CALLS["decode_png_gray8"] == len(pngs)


@pytest.mark.parametrize("mode", ["RGB", "I;16"])
def test_decode_refuses_what_it_does_not_decode(mode):
    buf = io.BytesIO()
    arr = np.arange(48, dtype=np.uint16 if mode == "I;16" else np.uint8)
    if mode == "RGB":
        Image.fromarray(arr.reshape(4, 4, 3)).save(buf, format="PNG")
    else:
        Image.fromarray(arr.reshape(6, 8) * 1000).save(buf, format="PNG")  # uint16: I;16
    assert native.decode_png_gray8(buf.getvalue()) is None
    assert jax_native.decode_png_gray8(buf.getvalue()) is None


def test_dataset_loads_through_the_native_decoder(data_root):
    ours, theirs = ACDCDataset(str(data_root), "train"), JACDCDataset(str(data_root), "train")
    for i in range(len(ours)):
        for a, b in zip(ours.load_raw(i), theirs.load_raw(i)):
            np.testing.assert_array_equal(a, b)
    assert native.CALLS["decode_png_gray8"] == 2 * len(ours)  # image and label


@pytest.mark.parametrize("shape", [(256, 256), (200, 180)], ids=["256", "smaller_than_crop"])
def test_augment_pair_is_bit_exact_with_the_jax_library(shape):
    """200 random draws (angle, flips, crop corner, jitter on or off, labels
    or none) at ``shape`` -> 224: both outputs bit-equal."""
    img, gt = _pair(shape, seed=1)
    rng = np.random.default_rng(2)
    for i in range(200):
        angle = float(rng.uniform(-45, 45)) if i % 5 else 0.0
        vflip, hflip = bool(rng.random() < 0.5), bool(rng.random() < 0.5)
        cy = int(rng.integers(0, max(shape[0] - 224, 0) + 1))
        cx = int(rng.integers(0, max(shape[1] - 224, 0) + 1))
        brightness, contrast = ((float(rng.uniform(0.5, 1.5)), float(rng.uniform(0.5, 1.5)))
                                if i % 3 else (-1.0, 1.0))
        labels = gt if i % 7 else None
        args = (img, labels, angle, vflip, hflip, cy, cx, 224, brightness, contrast)
        (a_img, a_gt), (b_img, b_gt) = native.augment_pair(*args), jax_native.augment_pair(*args)
        np.testing.assert_array_equal(a_img, b_img)
        assert (a_gt is None) == (labels is None)
        if labels is not None:
            np.testing.assert_array_equal(a_gt, b_gt)
    assert native.CALLS["augment_pair"] == 200


PRESETS = ("pretrain", "label", "val", "trainval")


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_paired_transform_is_bit_exact_with_the_jax_one(path, monkeypatch):
    """Every ``ACDCStrongTransforms`` preset and an uncropped transform, 20
    seeds each, at 256^2 and at 200 x 180 (padded): image and labels
    bit-equal to the JAX transform on the same path."""
    if path == "numpy":
        _numpy_only(monkeypatch)
    extra = ((PairedTransform(crop=None), JPairedTransform(crop=None)),)
    pairs = [(getattr(ACDCStrongTransforms, p), getattr(JACDCStrongTransforms, p))
             for p in PRESETS] + list(extra)
    for shape in ((256, 256), (200, 180)):
        img, gt = _pair(shape, seed=3)
        for ours, theirs in pairs:
            for seed in range(20):
                a = ours(img, gt, np.random.default_rng(seed))
                b = theirs(img, gt, np.random.default_rng(seed))
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
    cropped_calls = 2 * len(PRESETS) * 20
    assert native.CALLS["augment_pair"] == (cropped_calls if path == "native" else 0)


def _native_vs_numpy(transform, module, seed, img, gt):
    """(native output, numpy output) of ``transform`` under one seed, with
    ``module`` (the port's binding or the JAX one) switched off for the
    second call."""
    a = transform(img, gt, np.random.default_rng(seed))
    lib = module._lib
    module._lib, module._tried = None, True
    try:
        b = transform(img, gt, np.random.default_rng(seed))
    finally:
        module._lib = lib
    return a, b


@pytest.mark.parametrize("side", ["port", "jax"])
def test_native_vs_numpy_gap_is_pinned(side):
    """The gap of the module docstring, on each package alone."""
    module, paired = ((native, PairedTransform) if side == "port"
                      else (jax_native, JPairedTransform))
    strong = paired(rotation=45, vflip=True, hflip=True, crop=224, jitter=(0.5, 1.5))
    geometry = paired(rotation=45, vflip=True, hflip=True, crop=224, jitter=None)
    img, gt = _pair()
    worst = 0.0
    for seed in range(50):
        (g_nat, g_np) = _native_vs_numpy(geometry, module, seed, img, gt)
        img_px = int((g_nat[0] != g_np[0]).sum())
        lab_px = int((g_nat[1] != g_np[1]).sum())
        if seed == TIE_SEED:
            assert (img_px, lab_px) == (TIE_IMAGE_PIXELS, TIE_LABEL_PIXELS)
            p = geometry.sample_params(np.random.default_rng(seed), img.shape)
            assert (round(p.angle, 3), p.vflip, p.hflip, p.crop_y, p.crop_x) == (
                17.796, True, True, 19, 10)
            continue
        assert img_px == lab_px == 0, seed
        (s_nat, s_np) = _native_vs_numpy(strong, module, seed, img, gt)
        np.testing.assert_array_equal(s_nat[1], s_np[1])
        worst = max(worst, float(np.abs(s_nat[0] - s_np[0]).max()))
    assert 0.0 < worst <= JITTER_GAP


def test_disable_native_is_honoured(monkeypatch):
    monkeypatch.setenv("MISST_DISABLE_NATIVE", "1")
    native.reset()
    assert not native.available()
    img, gt = _pair()
    assert native.augment_pair(img, gt, 10.0, False, False, 0, 0, 224) is None
    out = ACDCStrongTransforms.pretrain(img, gt, np.random.default_rng(0))
    assert native.CALLS == {"decode_png_gray8": 0, "augment_pair": 0}
    _numpy_only(monkeypatch)
    ref = JACDCStrongTransforms.pretrain(img, gt, np.random.default_rng(0))
    np.testing.assert_array_equal(out[0], ref[0])


def test_a_failed_build_warns_once_and_falls_back(monkeypatch, capsys):
    """``CXX=false``: a compiler that fails (its name is part of the
    library's hash, so no built library is reused). One ``[data] WARNING``
    naming the command, then numpy; the JAX package falls back silently."""
    monkeypatch.setenv("CXX", "false")
    native.reset()
    assert not native.available() and not native.available()
    out = capsys.readouterr().out
    assert out.count("[data] WARNING") == 1
    assert "false -O3 -march=native" in out and "exited with 1" in out
    assert not build.host_library_path("host_pipeline").exists()
    img, gt = _pair()
    a = ACDCStrongTransforms.pretrain(img, gt, np.random.default_rng(4))
    monkeypatch.delenv("CXX")
    _numpy_only(monkeypatch)
    b = JACDCStrongTransforms.pretrain(img, gt, np.random.default_rng(4))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
