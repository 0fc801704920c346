"""The port's affine ops (``ops/affine.py``) and tensor helpers
(``utils/general.py``) against the JAX package's, on the same numpy inputs.
Random draws cannot match across RNGs, so the JAX side's draws are made here
with its own key splits and fed to the port's ``affine_matrix`` / ``cutout``;
the port's own draws are checked for range and reproducibility. Tolerances:
the warp within 3e-5 absolute on unit-normal images (grid_sample computes
the source pixel as (u + 1) / 2 (n - 1), the JAX gather-lerp as
(u + 1) (n - 1) / 2: the weights differ in their last bits; reading
1.01e-5), matrices within 1e-6, the rest exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.ops import affine as jaffine
from mi_based_regularized_semi_supervised_segmentation_tpu.utils import general as jgeneral
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import affine
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import general
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)


def _nchw(x):
    return torch.from_numpy(np.moveaxis(x, -1, 1).copy())


def _nhwc(t):
    return np.moveaxis(t.numpy(), 1, -1)


def test_affine_matrix_matches_jax_draws():
    key = jax.random.PRNGKey(3)
    want = np.asarray(jaffine.random_affine_matrix(key, 5, degrees=20.0, scale=(0.8, 1.2),
                                                   shear=0.2))
    k1, k2, k3 = jax.random.split(key, 3)  # the draws random_affine_matrix makes
    draws = [jax.random.uniform(k1, (5,), minval=-20.0, maxval=20.0),
             jax.random.uniform(k2, (5,), minval=0.8, maxval=1.2),
             jax.random.uniform(k3, (5,), minval=-0.2, maxval=0.2)]
    got = affine.affine_matrix(*(torch.from_numpy(np.array(d)) for d in draws))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_random_affine_matrix_draws_from_its_generator():
    g = [torch.Generator().manual_seed(7) for _ in range(2)]
    a, b = (affine.random_affine_matrix(64, degrees=15.0, generator=gen) for gen in g)
    assert torch.equal(a, b) and a.shape == (64, 2, 3)
    assert not torch.equal(a, affine.random_affine_matrix(64, degrees=15.0, generator=g[0]))
    # [[s cos, -s sin + sh, 0], [s sin + sh, s cos, 0]]
    s_cos, s_sin = a[:, 0, 0], (a[:, 1, 0] - a[:, 0, 1]) / 2
    shear = (a[:, 1, 0] + a[:, 0, 1]) / 2
    scale, theta = torch.hypot(s_cos, s_sin), torch.rad2deg(torch.atan2(s_sin, s_cos))
    assert torch.all(a[:, :, 2] == 0) and torch.allclose(a[:, 1, 1], s_cos)
    assert scale.min() >= 0.9 - 1e-6 and scale.max() <= 1.1 + 1e-6
    assert theta.abs().max() <= 15.0 + 1e-4 and shear.abs().max() <= 0.1 + 1e-6


def test_invert_affine_matrix_matches_jax(rng):
    m = rng.normal(size=(6, 2, 3)).astype(np.float32)
    m[:, :, :2] += np.eye(2, dtype=np.float32) * 2
    want = np.asarray(jaffine.invert_affine_matrix(jnp.asarray(m)))
    got = affine.invert_affine_matrix(torch.from_numpy(m))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    eye = torch.einsum("bij,bjk->bik", torch.from_numpy(m[:, :, :2]), got[:, :, :2])
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(2), (6, 2, 2)), atol=1e-5)


@pytest.mark.parametrize("shape", [(3, 17, 23, 2), (2, 32, 32, 1)])
def test_affine_transform_matches_jax(rng, shape):
    """Bilinear, zero padding, align-corners coordinates: rotations, shears,
    shifts that move part of the image out of the frame, and the identity."""
    images = rng.normal(size=shape).astype(np.float32)
    key = jax.random.PRNGKey(shape[0])
    m = np.array(jaffine.random_affine_matrix(key, shape[0], degrees=30.0, shear=0.2))
    m[:, :, 2] = rng.uniform(-0.4, 0.4, (shape[0], 2))
    m[0] = [[1, 0, 0], [0, 1, 0]]
    want = np.asarray(jaffine.affine_transform(jnp.asarray(images), jnp.asarray(m)))
    got = _nhwc(affine.affine_transform(_nchw(images), torch.from_numpy(m)))
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-5)
    np.testing.assert_allclose(got[0], images[0], rtol=0, atol=3e-5)  # the identity
    back = affine.affine_transform(affine.affine_transform(_nchw(images), torch.from_numpy(m)),
                                   affine.invert_affine_matrix(torch.from_numpy(m)))
    inner = np.abs(_nhwc(back) - images)[:, shape[1] // 3: -shape[1] // 3,
                                         shape[2] // 3: -shape[2] // 3]
    assert inner.mean() < 0.5 * np.abs(images).mean()  # resampling blur, not a wrong inverse


def test_cutout_matches_jax_draws(rng):
    images = rng.normal(size=(4, 20, 24, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = np.asarray(jaffine.random_cutout(key, jnp.asarray(images), 3, 9, pad_value=-1.5))
    k1, k2, k3 = jax.random.split(key, 3)  # the draws random_cutout makes
    sizes = np.asarray(jax.random.randint(k1, (4,), 3, 10))
    ys, xs = np.asarray(jax.random.randint(k2, (4,), 0, 20)), np.asarray(
        jax.random.randint(k3, (4,), 0, 24))
    draws = (torch.from_numpy(np.array(v)) for v in (sizes, ys, xs))
    got = affine.cutout(_nchw(images), *draws, pad_value=-1.5)
    np.testing.assert_array_equal(_nhwc(got), want)


def test_random_cutout_draws_one_box_a_sample():
    images = torch.ones(16, 2, 20, 24)
    gens = [torch.Generator().manual_seed(5) for _ in range(2)]
    a, b = (affine.random_cutout(images, 3, 9, pad_value=0.0, generator=g) for g in gens)
    assert torch.equal(a, b)
    for sample in a:
        rows, cols = torch.nonzero(sample[0] == 0, as_tuple=True)
        assert torch.equal(sample[0] == 0, sample[1] == 0)
        if rows.numel():
            h, w = int(rows.max() - rows.min() + 1), int(cols.max() - cols.min() + 1)
            assert rows.numel() == h * w and max(h, w) <= 9
            assert (h == w or rows.max() == 19 or cols.max() == 23) and min(h, w) >= 1


def test_one_hot_helpers_match_jax(rng):
    logits = rng.normal(size=(2, 4, 5, 6)).astype(np.float32)
    for axis in (1, -1):
        want = np.asarray(jgeneral.logit2one_hot(jnp.asarray(logits), class_axis=axis))
        got = general.logit2one_hot(torch.from_numpy(logits), class_axis=axis)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        probs = torch.softmax(torch.from_numpy(logits), dim=axis)
        assert torch.equal(general.probs2one_hot(probs, class_axis=axis), got)
        assert general.simplex(probs, axis) == jgeneral.simplex(probs.numpy(), axis) is True
        assert general.one_hot(got, axis) == jgeneral.one_hot(want, axis) is True
        assert general.one_hot(probs, axis) == jgeneral.one_hot(probs.numpy(), axis) is False
    off = torch.full((2, 3), 0.34)
    assert general.simplex(off) == jgeneral.simplex(off.numpy()) is False
    assert general.simplex(off, atol=0.05) == jgeneral.simplex(off.numpy(), atol=0.05) is True


def test_average_helpers_match_jax():
    values = [1.5, 2.0, 7.25]
    assert general.average_iter(iter(values)) == jgeneral.average_iter(iter(values))
    assert general.weighted_average_iter(values, [1, 2, 3]) == jgeneral.weighted_average_iter(
        values, [1, 2, 3])
    tensors = [torch.tensor([1.0, 2.0]), torch.tensor([3.0, 5.0])]
    assert torch.equal(general.average_iter(tensors), torch.tensor([2.0, 3.5]))
    with pytest.raises(ValueError):
        general.weighted_average_iter(values, [1, 2])
