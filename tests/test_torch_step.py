"""One train step of the port against the JAX package's ``build_train_step``:
the same weights (mapped by the port's ``weights.py``), the same numpy batch
and the same flip mask (the one the JAX step draws from its state's rng).

Held (fp32 joint on both sides):
- sup / uda / mi / total losses at rtol 2e-4;
- post-Adam parameters with the two-tier bound of tests/test_torch_parity.py:
  Adam's first step is about -lr * sign(g), so where a gradient is at fp32
  noise the two sides may step opposite ways (|diff| <= 2 lr); more than
  0.05 lr apart for under 0.5% of the elements;
- BN running mean and variance at rtol 1e-4 (atol 1e-6 for entries near
  zero): the port updates the running variance with the biased batch
  variance, as flax does.
With the bf16-operand joint (the kernel's numerics; Pallas in interpret mode
on the JAX side) the losses are held at rtol 2e-4 as well: both sides round
the same operands.
"""

from itertools import chain

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    build_optimizer as j_build_optimizer,
    lr_at_epoch as j_lr_at_epoch,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import init_train_state
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
    build_train_step as j_build_train_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models import (
    ProjectorWrapper as JProjector,
    UNet as JUNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
    sample_flip_mask as j_sample_flip_mask,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    lr_at_epoch,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    projector_state_dict,
    unet_state_dict,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

FEATS = ("Conv5", "Up_conv3", "Up_conv2")
IMPORTANCE = (1.0, 0.5, 0.5)
CROP, BL, BU, C, S, K = 32, 2, 3, 3, 2, 5
LR, WD = 1e-3, 1e-4
MODE_KW = {
    "partial": dict(reg_weight=0.0),
    "uda": dict(uda_criterion="mse", reg_weight=5.0),
    "iic": dict(reg_weight=0.1, paddings=[1, 1], patch_sizes=1024),
    "udaiic": dict(uda_criterion="mse", uda_weight=10.0, iic_weight=0.1, reg_weight=1.0,
                   paddings=[1, 1], patch_sizes=1024),
}


def _np_tree(tree):
    """Host copies (the jitted JAX step donates its input state)."""
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), jax.device_get(tree))


def _port_state(params, stats):
    sd = unet_state_dict(params["model"], stats)
    if "projector" in params:
        sd.update({f"proj.{k}": v for k, v in projector_state_dict(params["projector"]).items()})
    return sd


def _run_both(mode, jax_backend, port_backend, seed=0, emit_logits=False, heads=None,
              jax_flat=True, port_flat=True, crop=CROP, clusters=K, optim=None, **mode_kw):
    """One step of each side from the same weights, batch and flip mask.
    ``optim``: both sides' ``Optim`` section (default Adam at LR, WD);
    ``heads``: head options of both projectors (head_types, normalize);
    ``clusters``: K of every head;
    ``jax_flat`` / ``port_flat``: each side's decoder-head layout (flat or
    [.., S, K]); ``mode_kw``: step options over MODE_KW's (patch_sizes)."""
    rng = np.random.default_rng(seed)
    batch = {"labeled_image": rng.random((BL, crop, crop, 1), dtype=np.float32),
             "labeled_target": rng.integers(0, C, (BL, crop, crop)).astype(np.int32),
             "unlabeled_image": rng.random((BU, crop, crop, 1), dtype=np.float32)}
    needs_iic = mode in ("iic", "udaiic")
    heads = heads or {}
    common = dict(num_classes=C, feature_names=FEATS, feature_importance=IMPORTANCE,
                  **dict(MODE_KW[mode], **mode_kw))

    # --- JAX: init, snapshot, one step ---------------------------------
    jmodel = JUNet(input_dim=1, num_classes=C)
    jproj = JProjector(feature_names=FEATS, num_clusters=clusters, num_subheads=S, **heads,
                       local_flat=jax_flat, local_emit_logits=emit_logits) if needs_iic else None
    optim = optim or {"name": "Adam", "lr": LR, "weight_decay": WD}
    tx = j_build_optimizer(optim)
    state = init_train_state(jmodel, tx, (1, crop, crop, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS if needs_iic else None)
    params0, stats0 = _np_tree(state.params), _np_tree(state.batch_stats)
    _, flip_key = jax.random.split(state.rng)  # the draw the JAX step makes
    flip_mask = np.asarray(j_sample_flip_mask(flip_key, BU, 0.8))
    jstep = j_build_train_step(jmodel, tx, mode, projector=jproj, backend=jax_backend,
                               **common)
    state1, jmetrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    before = _port_state(params0, stats0)
    after_jax = _port_state(_np_tree(state1.params), _np_tree(state1.batch_stats))

    # --- port: the same weights, batch and flip mask -------------------
    model = UNet(1, C)
    model.load_state_dict({k: v for k, v in before.items() if not k.startswith("proj.")})
    proj = None
    params = list(model.parameters())
    if needs_iic:
        proj = ProjectorWrapper(FEATS, num_clusters=clusters, num_subheads=S, **heads,
                                local_emit_logits=emit_logits, local_flat=port_flat)
        proj.load_state_dict({k[5:]: v for k, v in before.items() if k.startswith("proj.")})
        params = list(chain(params, proj.parameters()))
    opt = build_optimizer(params, optim)
    step = build_train_step(model, opt, mode, generator=torch.Generator(), projector=proj,
                            backend=port_backend, **common)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   flip_mask=torch.tensor(flip_mask))
    after = dict(model.state_dict())
    if proj is not None:
        after.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
    return jmetrics, metrics, before, after_jax, after


def _check_losses(jmetrics, metrics, rtol=2e-4):
    assert set(jmetrics) == set(metrics)
    for key in ("sup_loss", "uda", "mi", "reg_loss", "total_loss"):
        if key in jmetrics:
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=rtol,
                                       atol=1e-7, err_msg=key)
    for key in jmetrics:
        if key.startswith("individual_mis/"):
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=rtol,
                                       atol=1e-7, err_msg=key)
    for key in ("sup_dice_inter", "sup_dice_union"):
        np.testing.assert_array_equal(metrics[key].numpy(), np.asarray(jmetrics[key]))


def _check_params(before, after_jax, after):
    """Post-Adam parameters to the two-tier bound, BN running stats at rtol 1e-4."""
    n_tot = n_loose = 0
    for key, p0 in before.items():
        if "running_" in key or "num_batches" in key:
            continue
        d_port = (after[key] - p0).numpy()
        d_jax = (after_jax[key] - p0).numpy()
        diff = np.abs(d_port - d_jax)
        assert diff.max() <= 2.05 * LR, f"{key}: step differs by {diff.max():.2e}"
        n_tot += diff.size
        n_loose += int((diff > 0.05 * LR).sum())
    assert n_loose / n_tot < 0.005, f"{n_loose}/{n_tot} elements step differently"

    for key in before:
        if "running_" in key:
            np.testing.assert_allclose(after[key].numpy(), after_jax[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", ["partial", "uda", "iic", "udaiic"])
def test_train_step_matches_jax(mode):
    jmetrics, metrics, before, after_jax, after = _run_both(mode, "xla", "plain")
    _check_losses(jmetrics, metrics)
    _check_params(before, after_jax, after)


def test_udaiic_step_bf16_joint_matches_jax_pallas():
    """backend=auto on CPU tensors: the plain version of the kernel (bf16
    operands) against the JAX step's Pallas kernel in interpret mode."""
    jmetrics, metrics, *_ = _run_both("udaiic", "pallas", "auto", seed=1)
    _check_losses(jmetrics, metrics)


def test_lr_table_matches_jax():
    for epoch in range(100):
        for base, mult, warm in ((1e-7, 400.0, 10), (1e-3, 2.0, 1)):
            assert lr_at_epoch(epoch, base, mult, warm, 100) == j_lr_at_epoch(
                epoch, base, mult, warm, 100)
