"""The port's U-Net, cluster heads, group softmax and IIC losses against the
JAX package, with the same weights (mapped by the port's ``weights.py``) and
the same numpy inputs. fp32 on both sides; tolerances allow for summation
order only (rtol 1e-4, atol 1e-5 unless stated)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.models.heads import (
    ProjectorWrapper as JProjector,
    group_softmax_flat as j_group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models.unet import UNet as JUNet
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic import iid_loss as j_iid_loss
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
    mi_from_joint as j_mi_from_joint,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    TAP_NAMES,
    UNet,
    group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic import iid_loss
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic_local import (
    mi_from_joint,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    projector_state_dict,
    unet_state_dict,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

FEATS = ("Conv5", "Up_conv3", "Up_conv2")


@pytest.fixture(scope="module")
def unets():
    """A JAX U-Net with random BN affine and running statistics, and the
    port's U-Net loaded from it."""
    jmodel = JUNet(input_dim=1, num_classes=3)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)), train=False)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["params"]))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(variables["batch_stats"]))
    for block in stats.values():
        for bn in block.values():
            bn["mean"] = rng.normal(0, 0.1, bn["mean"].shape).astype(np.float32)
            bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    for block in params.values():
        for name, leaf in block.items():
            if name.startswith("bn"):
                leaf["scale"] = rng.uniform(0.5, 1.5, leaf["scale"].shape).astype(np.float32)
                leaf["bias"] = rng.normal(0, 0.1, leaf["bias"].shape).astype(np.float32)
    tmodel = UNet(1, 3)
    tmodel.load_state_dict(unet_state_dict(params, stats))
    return jmodel, params, stats, tmodel


@pytest.mark.parametrize("train", [False, True])
def test_unet_logits_and_taps_match_jax(unets, rng, train):
    jmodel, params, stats, tmodel = unets
    x = rng.normal(size=(3, 32, 32, 1)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (j_logits, j_feats), mutated = jmodel.apply(
            variables, jnp.asarray(x), train=True, return_features=True,
            mutable=["batch_stats"])
    else:
        j_logits, j_feats = jmodel.apply(variables, jnp.asarray(x), train=False,
                                         return_features=True)
    model = UNet(1, 3)
    model.load_state_dict(tmodel.state_dict())
    model.train(train)
    with torch.no_grad():
        logits, feats = model(torch.tensor(x), return_features=True)
    # train-mode BN divides by batch statistics (12 values per channel at
    # Conv5), which amplifies fp32 summation-order differences: ~1e-5 per
    # block, 1.2e-4 at the last tap on O(1) activations. A wrong variance
    # (unbiased: x sqrt(12/11) at Conv5) or momentum is orders above that.
    atol = 3e-4 if train else 1e-5
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=atol)
    assert set(feats) == set(TAP_NAMES)
    for name in TAP_NAMES:
        np.testing.assert_allclose(feats[name].numpy(), np.asarray(j_feats[name]),
                                   rtol=1e-4, atol=atol, err_msg=name)
    if train:
        # running statistics follow flax: momentum 0.9 and the biased variance
        new_sd = unet_state_dict(params, jax.device_get(mutated["batch_stats"]))
        for key, value in model.state_dict().items():
            if "running_" in key:
                np.testing.assert_allclose(value.numpy(), new_sd[key].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=key)


def test_group_softmax_flat_matches_jax_with_zero_dead_lanes(rng):
    S, K, C = 3, 5, 32
    z = rng.normal(size=(2, 4, 5, C)).astype(np.float32) * 3
    want = np.asarray(j_group_softmax_flat(jnp.asarray(z), S, K, T=0.7))
    tz = torch.tensor(z, requires_grad=True)
    got = group_softmax_flat(tz, S, K, T=0.7)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-7)
    assert torch.all(got[..., S * K:] == 0)
    np.testing.assert_allclose(got[..., :S * K].reshape(2, 4, 5, S, K).sum(-1).detach().numpy(),
                               1.0, rtol=1e-6)
    (got * torch.tensor(rng.normal(size=z.shape).astype(np.float32))).sum().backward()
    assert torch.all(tz.grad[..., S * K:] == 0)


def test_projector_heads_match_jax(rng):
    """Global head [B, S, K] at Conv5 and flat lane-padded local heads at
    Up_conv3 / Up_conv2, from the same features and weights."""
    S, K = 2, 5
    feats = {"Conv5": rng.normal(size=(3, 2, 2, 256)).astype(np.float32),
             "Up_conv3": rng.normal(size=(3, 10, 9, 32)).astype(np.float32),
             "Up_conv2": rng.normal(size=(3, 18, 17, 16)).astype(np.float32)}
    jproj = JProjector(feature_names=FEATS, num_clusters=K, num_subheads=S, local_flat=True)
    jparams = jproj.init(jax.random.PRNGKey(3), {k: jnp.asarray(v) for k, v in feats.items()})
    want = jproj.apply(jparams, {k: jnp.asarray(v) for k, v in feats.items()})
    proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S)
    proj.load_state_dict(projector_state_dict(jax.device_get(jparams["params"])))
    with torch.no_grad():
        got = proj({k: torch.tensor(v) for k, v in feats.items()})
    assert got["Conv5"].shape == (3, S, K)
    assert got["Up_conv2"].shape == (3, 18, 17, 128)
    for name in FEATS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_iid_loss_matches_jax_values_and_grads(rng):
    p1 = rng.dirichlet(np.ones(7), size=20).astype(np.float32)
    p2 = rng.dirichlet(np.ones(7), size=20).astype(np.float32)
    want = j_iid_loss(jnp.asarray(p1), jnp.asarray(p2), lamb=1.3)
    jg = jax.grad(lambda a, b: j_iid_loss(a, b, 1.3)[0], argnums=(0, 1))(
        jnp.asarray(p1), jnp.asarray(p2))
    t1 = torch.tensor(p1, requires_grad=True)
    t2 = torch.tensor(p2, requires_grad=True)
    got = iid_loss(t1, t2, lamb=1.3)
    got[0].backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t1.grad.numpy(), np.asarray(jg[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t2.grad.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-6)


def test_mi_from_joint_matches_jax_values_and_grads(rng):
    joint = rng.uniform(0.0, 5.0, size=(3, 3, 6, 6)).astype(np.float32)
    want, jg = jax.value_and_grad(j_mi_from_joint)(jnp.asarray(joint))
    tj = torch.tensor(joint, requires_grad=True)
    got = mi_from_joint(tj)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(tj.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-7)
