"""The port's 3-shear rotation (plain versions of ``csrc/rotate.cu``) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

Inputs are integer-valued fp32 images and angles from a numpy seed in
[-45, 45], plus the angle 0. Held bit-exact: the shift tables (both sides
compute them in fp32 with round-half-to-even and floor-mod), and the images
of ``rotate_shear_plain`` against ``rotate_shear_pallas`` (also for int32
labels rotated beside the images, through fp32 on the JAX side) and of
``rotate_shear_lanes`` against ``rotate_shear_pallas_lanes``. A rotation by
shears is a pixel permutation, so there is no rounding in the images
themselves; only a 1-ulp difference of tan/sin between the two libraries
could move a shift, and no seed here shows one.
"""

import math

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import rotate
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

try:  # the JAX side; a card's machine without JAX runs only the cuda-marked test
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.rotate import (
        rotate_shear_pallas,
        rotate_shear_pallas_lanes,
    )
except ImportError:
    jnp = rotate_shear_pallas = rotate_shear_pallas_lanes = None

SHAPES = [(64, 64), (256, 256), (154, 212)]
# on the card also a width that is no multiple of 4: the kernel's scalar stores
CARD_SHAPES = SHAPES + [(61, 70)]


def _inputs(seed, b, h, w):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (b, h, w)).astype(np.float32)
    ang = rng.uniform(-45, 45, b).astype(np.float32)
    ang[0] = 0.0
    return img, ang


def _jax_tables(ang, h, w, lane_aligned_rows):
    """The shift tables as ops/pallas/rotate.py:117-125 and :196-202 compute
    them, on the port's canvas (whose bounds the test checks separately)."""
    py, px, hc, wc = rotate.canvas(h, w, 45.0, lane_aligned_rows)
    theta = -jnp.deg2rad(jnp.asarray(ang).astype(jnp.float32))
    a = -jnp.tan(theta / 2.0)
    b = jnp.sin(theta)
    rows = jnp.arange(hc, dtype=jnp.float32) - (py + (h - 1) / 2.0)
    cols = jnp.arange(wc, dtype=jnp.float32) - (px + (w - 1) / 2.0)
    s_x = jnp.mod(jnp.rint(a[:, None] * rows[None, :]).astype(jnp.int32), wc)
    s_y = jnp.mod(jnp.rint(b[:, None] * cols[None, :]).astype(jnp.int32), hc)
    return np.asarray(s_x), np.asarray(s_y)


def test_canvas_matches_the_pallas_bounds():
    """py, px, Hc, Wc as rotate_shear_pallas (:101-115) and the lanes
    variant (:183-194) derive them; spelled out here for 256^2 at 45 deg."""
    assert rotate.canvas(256, 256, 45.0, False) == (55, 55, 368, 384)
    assert rotate.canvas(256, 256, 45.0, True) == (55, 55, 384, 384)
    for h, w in SHAPES:
        for aligned in (False, True):
            py, px, hc, wc = rotate.canvas(h, w, 45.0, aligned)
            assert hc % (128 if aligned else 8) == 0 and wc % 128 == 0
            assert hc >= h + 2 * py and wc >= w + 2 * px


@pytest.mark.parametrize("lane_aligned_rows", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_shear_tables_equal_jax(shape, lane_aligned_rows):
    h, w = shape
    _, ang = _inputs(1, 6, h, w)
    s_x, s_y, _ = rotate.shear_tables(torch.from_numpy(ang), h, w, 45.0, lane_aligned_rows)
    j_x, j_y = _jax_tables(ang, h, w, lane_aligned_rows)
    assert s_x.dtype == torch.int32 and s_y.dtype == torch.int32
    np.testing.assert_array_equal(s_x.numpy(), j_x)
    np.testing.assert_array_equal(s_y.numpy(), j_y)


@pytest.mark.parametrize("shape", SHAPES)
def test_rotate_shear_bit_exact_with_pallas(shape):
    h, w = shape
    img, ang = _inputs(2, 4, h, w)
    want = np.asarray(rotate_shear_pallas(jnp.asarray(img), jnp.asarray(ang)))
    got = rotate.rotate_shear_plain(torch.from_numpy(img), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, want)
    # the dispatching wrapper takes the plain version for CPU tensors
    rotate.reset_launch_counts()
    np.testing.assert_array_equal(
        rotate.rotate_shear(torch.from_numpy(img), torch.from_numpy(ang)).numpy(), want)
    assert sum(rotate.LAUNCHES.values()) == 0


@pytest.mark.parametrize("shape", SHAPES)
def test_rotate_shear_lanes_bit_exact_with_pallas_lanes(shape):
    h, w = shape
    img, ang = _inputs(3, 4, h, w)
    want = np.asarray(rotate_shear_pallas_lanes(jnp.asarray(img), jnp.asarray(ang)))
    got = rotate.rotate_shear_lanes(torch.from_numpy(img), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, want)
    # the two canvases give the same rotation
    single = rotate.rotate_shear_plain(torch.from_numpy(img), torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(got, single)


def test_lane_roll_rows_plain_is_a_row_roll(rng):
    x = torch.from_numpy(rng.random((2, 5, 128)).astype(np.float32))
    shifts = torch.from_numpy(rng.integers(-300, 300, (2, 5)).astype(np.int32))
    got = rotate.lane_roll_rows(x, shifts)
    for b in range(2):
        for r in range(5):
            torch.testing.assert_close(got[b, r], torch.roll(x[b, r], int(shifts[b, r])),
                                       rtol=0, atol=0)


def test_identity_mass_and_integral_labels():
    h, w = 96, 80
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (3, h, w)).astype(np.float32)
    zero = torch.zeros(3)
    np.testing.assert_array_equal(rotate.rotate_shear(torch.from_numpy(img), zero).numpy(), img)
    np.testing.assert_array_equal(rotate.rotate_shear_lanes(torch.from_numpy(img), zero).numpy(),
                                  img)
    # content inside the inscribed circle stays on the canvas at any angle:
    # the permutation keeps every value
    yy, xx = np.mgrid[0:h, 0:w]
    disc = ((yy - (h - 1) / 2) ** 2 + (xx - (w - 1) / 2) ** 2) < (min(h, w) / 2 - 4) ** 2
    labels = (rng.integers(0, 4, (3, h, w)) * disc).astype(np.float32)
    ang = torch.tensor([33.3, -45.0, 12.5])
    out = rotate.rotate_shear(torch.from_numpy(labels), ang).numpy()
    assert np.all(out == np.round(out)) and set(np.unique(out)) <= {0.0, 1.0, 2.0, 3.0}
    for b in range(3):
        np.testing.assert_array_equal(np.bincount(out[b].astype(np.int64).ravel(), minlength=4),
                                      np.bincount(labels[b].astype(np.int64).ravel(),
                                                  minlength=4))
    assert math.isclose(float(out.sum()), float(labels.sum()))


@pytest.mark.parametrize("shape", SHAPES)
def test_rotate_shear_pair_bit_exact_with_pallas(shape):
    """Images and int32 labels in one call: each equal to rotate_shear_pallas
    on the same angles, the labels rotated through fp32 as the JAX path
    rotates them (ops/augment_device.py of the JAX package)."""
    h, w = shape
    img, ang = _inputs(6, 4, h, w)
    lab = np.random.default_rng(7).integers(0, 4, (4, h, w)).astype(np.int32)
    want_img = np.asarray(rotate_shear_pallas(jnp.asarray(img), jnp.asarray(ang)))
    want_lab = np.asarray(rotate_shear_pallas(jnp.asarray(lab, jnp.float32), jnp.asarray(ang)))
    rotate.reset_launch_counts()
    got_img, got_lab = rotate.rotate_shear(torch.from_numpy(img), torch.from_numpy(ang),
                                           labels=torch.from_numpy(lab))
    assert sum(rotate.LAUNCHES.values()) == 0
    assert got_lab.dtype == torch.int32
    np.testing.assert_array_equal(got_img.numpy(), want_img)
    np.testing.assert_array_equal(got_lab.numpy(), want_lab.astype(np.int32))
    np.testing.assert_array_equal(want_lab, np.round(want_lab))


def test_kernel_wrappers_refuse_cpu_operands():
    """The launch wrappers take only CUDA tensors; they check before touching
    the library, so this runs without a card."""
    x = torch.zeros((1, 8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        rotate._lane_roll_rows_cuda(x, torch.zeros((1, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        rotate._rotate_shear_cuda(torch.zeros((1, 8, 8)), torch.zeros(1), None,
                                  rotate.canvas(8, 8, 45.0, False))
    with pytest.raises(TypeError, match="float"):
        rotate.rotate_shear(torch.zeros((1, 8, 8), dtype=torch.int32), torch.zeros(1))


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the wrapper
    sees when it is handed a card's tensor."""

    @property
    def is_cuda(self):
        return True


def _cuda_looking(t: torch.Tensor) -> torch.Tensor:
    return t.as_subclass(_CudaLooking)


REFUSALS = {
    # the kernel derives its own shifts: tables are for the plain version
    "tables_with_cuda_operands": (ValueError, "tables", lambda img, ang, lab: dict(
        images=img, angles=ang, tables=rotate.shear_tables(torch.zeros(2), 16, 16))),
    "labels_not_int32": (TypeError, "int32", lambda img, ang, lab: dict(
        images=img, angles=ang, labels=_cuda_looking(torch.zeros((2, 16, 16))))),
    "labels_of_another_shape": (ValueError, "shape", lambda img, ang, lab: dict(
        images=img, angles=ang, labels=lab[:, :8])),
    "angles_on_the_cpu": (ValueError, "mixed", lambda img, ang, lab: dict(
        images=img, angles=torch.zeros(2))),
    "labels_on_the_cpu": (ValueError, "mixed", lambda img, ang, lab: dict(
        images=img, angles=ang, labels=torch.zeros((2, 16, 16), dtype=torch.int32))),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_rotate_shear_refuses_before_the_library_loads(case, monkeypatch):
    """What the CUDA route does not take raises before the library is built or
    loaded, so each refusal shows without a card."""
    def no_library():
        raise AssertionError("the library was reached")

    monkeypatch.setattr(rotate, "_library", no_library)
    exc, match, kwargs = REFUSALS[case]
    img = _cuda_looking(torch.zeros((2, 16, 16)))
    ang = _cuda_looking(torch.zeros(2))
    lab = _cuda_looking(torch.zeros((2, 16, 16), dtype=torch.int32))
    with pytest.raises(exc, match=match):
        rotate.rotate_shear(max_angle=45.0, **kwargs(img, ang, lab))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """Both kernels bit-exact against their plain versions on the card: the
    rotation of images alone and of images with labels (the plain version on
    torch's shift tables, which the kernel's own shifts must equal), the
    rotation against rotate_shear_lanes, and the roll; each at a width that
    is no multiple of 4 too, and the roll also on a row wider than its
    staging buffer and on rows whose base is 4 bytes off 16 (the scalar
    kernel)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    for shape in [(4, 16, 384), (3, 50, 130), (2, 8, 1280)]:
        x = torch.rand(shape, generator=gen, device="cuda")
        s = torch.randint(-3000, 3000, shape[:2], generator=gen, device="cuda",
                          dtype=torch.int32)
        torch.testing.assert_close(rotate.lane_roll_rows(x, s),
                                   rotate.lane_roll_rows_plain(x, s), rtol=0, atol=0)
        off = torch.empty(x.numel() + 1, device="cuda")[1:].view(shape)
        off.copy_(x)
        assert off.data_ptr() % 16 == 4
        torch.testing.assert_close(rotate.lane_roll_rows(off, s),
                                   rotate.lane_roll_rows_plain(x, s), rtol=0, atol=0)
    for h, w in CARD_SHAPES:
        img, ang = _inputs(5, 4, h, w)
        x, a = torch.from_numpy(img).cuda(), torch.from_numpy(ang).cuda()
        lab = torch.randint(0, 4, (4, h, w), dtype=torch.int32, device="cuda")
        s_x, s_y, _ = rotate.shear_tables(a, h, w)
        k_x, k_y = rotate.kernel_shifts(a, h, w)
        torch.testing.assert_close(k_x, s_x, rtol=0, atol=0)
        torch.testing.assert_close(k_y, s_y, rtol=0, atol=0)
        got = rotate.rotate_shear(x, a)
        torch.testing.assert_close(got, rotate.rotate_shear_plain(x, a), rtol=0, atol=0)
        got_img, got_lab = rotate.rotate_shear(x, a, labels=lab)
        torch.testing.assert_close(got_img, got, rtol=0, atol=0)
        torch.testing.assert_close(got_lab, rotate.rotate_shear_plain(lab.float(), a)
                                   .to(torch.int32), rtol=0, atol=0)
        torch.testing.assert_close(rotate.rotate_shear_lanes(x, a), got, rtol=0, atol=0)
        s_x, _, geom = rotate.shear_tables(a, h, w, lane_aligned_rows=True)
        canvas = rotate._pad_canvas(x, geom)
        torch.testing.assert_close(rotate.lane_roll_rows(canvas, s_x),
                                   rotate.lane_roll_rows_plain(canvas, s_x), rtol=0, atol=0)
