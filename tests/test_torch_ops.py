"""The port's small ops and its eval step against the JAX package, on the same
numpy inputs: losses, flips, one-hot, the global joint, dice sums and one
patient-volume eval. fp32 both sides; tolerances allow summation order only
(rtol 1e-5 unless stated); integer results are held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
    build_eval_step as j_build_eval_step,
    dice_stats as j_dice_stats,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models.unet import UNet as JUNet
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
    apply_flips as j_apply_flips,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic import (
    compute_joint as j_compute_joint,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.losses import (
    kl_div as j_kl_div,
    mse_consistency as j_mse_consistency,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.utils.general import (
    class2one_hot as j_class2one_hot,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_eval_step,
    dice_stats,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import UNet
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.flips import (
    apply_flips,
    sample_flip_mask,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic import compute_joint
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.losses import (
    kl_div,
    mse_consistency,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import class2one_hot
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import unet_state_dict
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)


def _probs(rng, shape):
    z = rng.normal(size=shape)
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("reduction,weighted", [("mean", False), ("none", False),
                                                ("sum", True)])
def test_kl_div_matches_jax(rng, reduction, weighted):
    p = _probs(rng, (2, 6, 5, 4))
    t = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (2, 6, 5))]
    w = np.array([0.5, 1.0, 2.0, 1.5], np.float32) if weighted else None
    want = j_kl_div(jnp.asarray(p), jnp.asarray(t), None if w is None else jnp.asarray(w),
                    reduction=reduction)
    got = kl_div(torch.tensor(p), torch.tensor(t), None if w is None else torch.tensor(w),
                 reduction=reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-7)


def test_mse_consistency_matches_jax_and_detaches_target(rng):
    a, b = _probs(rng, (3, 4, 4, 5)), _probs(rng, (3, 4, 4, 5))
    want = j_mse_consistency(jnp.asarray(a), jnp.asarray(b))
    ta, tb = torch.tensor(a, requires_grad=True), torch.tensor(b, requires_grad=True)
    got = mse_consistency(ta, tb)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert tb.grad is None and ta.grad is not None


@pytest.mark.parametrize("trailing", [(), (3,)])
def test_apply_flips_matches_jax(rng, trailing):
    x = rng.normal(size=(4, 5, 6) + trailing).astype(np.float32)
    mask = np.array([[False, False], [True, False], [False, True], [True, True]])
    want = j_apply_flips(jnp.asarray(x), jnp.asarray(mask))
    got = apply_flips(torch.tensor(x), torch.tensor(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_flip_mask_draws_on_the_generator():
    gen = torch.Generator().manual_seed(3)
    first = sample_flip_mask(gen, 1000, 0.8)
    assert first.shape == (1000, 2) and first.dtype == torch.bool
    assert 0.75 < float(first.float().mean()) < 0.85
    assert torch.equal(first, sample_flip_mask(torch.Generator().manual_seed(3), 1000, 0.8))


@pytest.mark.parametrize("class_axis", [1, -1])
def test_class2one_hot_matches_jax(rng, class_axis):
    labels = rng.integers(0, 4, (2, 5, 6))
    want = j_class2one_hot(jnp.asarray(labels), 4, class_axis=class_axis)
    got = class2one_hot(torch.tensor(labels), 4, class_axis=class_axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_compute_joint_matches_jax(rng):
    a, b = _probs(rng, (9, 7)), _probs(rng, (9, 7))
    want = j_compute_joint(jnp.asarray(a), jnp.asarray(b))
    got = compute_joint(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-8)


def test_dice_stats_match_jax(rng):
    pred, tgt = rng.integers(0, 3, (4, 8, 8)), rng.integers(0, 3, (4, 8, 8))
    mask = np.array([1.0, 0.0, 1.0, 1.0], np.float32)
    want = j_dice_stats(jnp.asarray(pred), jnp.asarray(tgt), 3, mask=jnp.asarray(mask))
    got = dice_stats(torch.tensor(pred), torch.tensor(tgt), 3, mask=torch.tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_eval_step_matches_jax(rng):
    """One padded patient volume in eval-mode BN: loss at rtol 1e-5, dice sums
    and predictions exactly (logits agree to ~1e-6, far from an argmax tie on
    these inputs)."""
    jmodel = JUNet(input_dim=1, num_classes=3)
    variables = jax.device_get(jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 1)),
                                           train=False))
    image = rng.random((3, 32, 32, 1), dtype=np.float32)
    target = rng.integers(0, 3, (3, 32, 32))
    mask = np.array([True, True, False])
    jeval = j_build_eval_step(jmodel, num_classes=3)
    want = jeval({"model": variables["params"]}, variables["batch_stats"], jnp.asarray(image),
                 jnp.asarray(target), jnp.asarray(mask))
    model = UNet(1, 3)
    model.load_state_dict(unet_state_dict(variables["params"], variables["batch_stats"]))
    got = build_eval_step(model, num_classes=3)(torch.tensor(image), torch.tensor(target),
                                                torch.tensor(mask))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    for key in ("inter", "union", "pred"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
