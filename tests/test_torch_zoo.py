"""The rest of the trainer zoo against the JAX package's ``build_train_step``:
``entropy``, ``meanteacher``, and the UDA ``kl`` criterion in ``uda`` and
``udaiic``. The same weights (``weights.py``), the same numpy batches and the
flip masks the JAX step draws from its state's rng, injected into the port's
step; crop 32, 2 + 3 slices, 3 classes, 2 x 5 clusters.

Held, as in tests/test_torch_step.py:
- every loss at rtol 2e-4;
- post-Adam parameters after one step with its two-tier bound (|diff| <=
  2.05 lr; more than 0.05 lr apart for under 0.5% of the elements: Adam's
  first step is about -lr * sign(g));
- BN running statistics at rtol 1e-4 (atol 1e-6).
The mean teacher, over two steps:
- after step 0 (alpha = min(1 - 1/1, 0.999) = 0) teacher = student * (1 -
  wd) on each side, to fp32 rounding (rtol 1e-6); against the JAX teacher
  with the students' two-tier bound, as it is the student scaled;
- its own BN statistics against the JAX teacher's at rtol 1e-4 (atol 1e-6),
  moved from init and unlike the student's (tests/test_engine.py:308);
- step 1 starts on both sides from the JAX state after step 0 (the port's
  student and teacher are set to it; its Adam moments stay its own), so
  that step 0's Adam sign flips do not carry into step 1: its losses at rtol
  2e-4; after it (alpha = 1/2) teacher = (teacher * 1/2 + student / 2) *
  (1 - wd) on the port's side (rtol 1e-6); the teacher's BN statistics at
  rtol 1e-4; the moves from that common state, against JAX: the student's
  |diff| <= 2.05 lr and more than 0.05 lr apart for under 5% of the
  elements (Adam's second step divides a sum of two gradients, which cancel
  where they change sign, by their root mean square, so noise-level
  differences of either gradient reach more elements than on the first
  step: 2.3% measured), the teacher's half of that (it takes half the
  student's move): |diff| <= 1.05 lr, more than 0.05 lr apart for under 2%
  (0.7% measured);
- the step counter counts the steps.
The three trainers also run an epoch on the CPU on every data path: the host
loader and the device-data path with each of its loops (per step, epoch
scan, pipelined scan, ``Kernel.augment=epoch``).
"""

import copy
from itertools import chain

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoints import make_config, make_loaders
from test_torch_step import BL, BU, C, CROP, FEATS, IMPORTANCE, K, LR, S, WD, _check_params, \
    _np_tree, _port_state

from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    build_optimizer as j_build_optimizer,
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
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.losses import (
    entropy as j_entropy,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint, rotate
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.losses import entropy
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import unet_state_dict
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

EMA_WD = 1e-3  # large enough that the teacher's decay shows at rtol 1e-6
CASES = {
    "entropy": ("entropy", dict(reg_weight=1.0)),
    "meanteacher": ("meanteacher", dict(uda_criterion="mse", reg_weight=10.0, ema_alpha=0.999,
                                        ema_weight_decay=EMA_WD)),
    "uda_kl": ("uda", dict(uda_criterion="kl", reg_weight=5.0)),
    "udaiic_kl": ("udaiic", dict(uda_criterion="kl", uda_weight=10.0, iic_weight=0.1,
                                 reg_weight=1.0, paddings=[1, 1], patch_sizes=1024)),
}
LOSS_KEYS = ("sup_loss", "uda", "mi", "entropy", "reg_loss", "total_loss")


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"labeled_image": rng.random((BL, CROP, CROP, 1), dtype=np.float32),
            "labeled_target": rng.integers(0, C, (BL, CROP, CROP)).astype(np.int32),
            "unlabeled_image": rng.random((BU, CROP, CROP, 1), dtype=np.float32)}


def _run(case, steps):
    """``steps`` steps of both packages; per step: (JAX metrics, port
    metrics, JAX state, port state), states in the port's state_dict layout
    with the teacher under "teacher." keys. Each step after the first starts
    the port's model, projector and teacher from the JAX state."""
    mode, kw = CASES[case]
    needs_iic = mode in ("iic", "udaiic")
    common = dict(num_classes=C, feature_names=FEATS, feature_importance=IMPORTANCE, **kw)
    jmodel = JUNet(input_dim=1, num_classes=C)
    jproj = JProjector(feature_names=FEATS, num_clusters=K, num_subheads=S,
                       local_flat=True) if needs_iic else None
    tx = j_build_optimizer({"name": "Adam", "lr": LR, "weight_decay": WD})
    state = init_train_state(jmodel, tx, (1, CROP, CROP, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS if needs_iic else None,
                             with_ema=mode == "meanteacher")
    jstep = j_build_train_step(jmodel, tx, mode, projector=jproj, backend="xla", **common)

    def jax_state(st):
        out = _port_state(_np_tree(st.params), _np_tree(st.batch_stats))
        if st.ema_params is not None:
            ema = _np_tree(st.ema_params)
            out.update({f"teacher.{k}": v for k, v in
                        unet_state_dict(ema["params"], ema["batch_stats"]).items()})
        return out

    before = jax_state(state)
    model = UNet(1, C)
    proj, params = None, list(model.parameters())
    if needs_iic:
        proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S)
        params = list(chain(params, proj.parameters()))
    teacher = copy.deepcopy(model).requires_grad_(False) if mode == "meanteacher" else None

    def set_port(sd):
        model.load_state_dict({k: v for k, v in sd.items()
                               if not k.startswith(("proj.", "teacher."))})
        if proj is not None:
            proj.load_state_dict(_split(sd, "proj."))
        if teacher is not None:
            teacher.load_state_dict(_split(sd, "teacher."))

    set_port(before)
    opt = build_optimizer(params, {"name": "Adam", "lr": LR, "weight_decay": WD})
    counter = torch.zeros((), dtype=torch.int64)
    step = build_train_step(model, opt, mode, generator=torch.Generator(), projector=proj,
                            teacher=teacher, step_counter=counter, **common)

    def port_state():
        out = dict(model.state_dict())
        if proj is not None:
            out.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
        if teacher is not None:
            out.update({f"teacher.{k}": v.clone() for k, v in teacher.state_dict().items()})
        return {k: v.clone() for k, v in out.items()}

    out = [(None, None, before, port_state())]
    for i in range(steps):
        if i:
            set_port(out[-1][2])
        batch = _batch(i)
        _, flip_key = jax.random.split(state.rng)  # the draw the JAX step makes
        flip_mask = np.asarray(j_sample_flip_mask(flip_key, BU, 0.8))
        state, jmetrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                       flip_mask=torch.tensor(flip_mask))
        out.append((jmetrics, metrics, jax_state(state), port_state()))
    assert int(counter) == steps
    return out


def _check_losses(jmetrics, metrics, rtol=2e-4):
    assert set(jmetrics) == set(metrics)
    for key in [k for k in LOSS_KEYS if k in jmetrics] + [
            k for k in jmetrics if k.startswith("individual_mis/")]:
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=rtol,
                                   atol=1e-7, err_msg=key)
    for key in ("sup_dice_inter", "sup_dice_union"):
        np.testing.assert_array_equal(metrics[key].numpy(), np.asarray(jmetrics[key]))


def _split(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _students(sd):
    return {k: v for k, v in sd.items() if not k.startswith("teacher.")}


def _check_bound(before, after_jax, after, max_lr, loose_share):
    """Moves from ``before``: |port - JAX| <= max_lr * LR, and more than
    0.05 LR apart for under ``loose_share`` of the elements."""
    n_tot = n_loose = 0
    for key, p0 in before.items():
        if "running_" in key or "num_batches" in key:
            continue
        diff = np.abs((after[key] - p0).numpy() - (after_jax[key] - p0).numpy())
        assert diff.max() <= max_lr * LR, f"{key}: differs by {diff.max():.2e}"
        n_tot += diff.size
        n_loose += int((diff > 0.05 * LR).sum())
    assert n_loose / n_tot < loose_share, f"{n_loose}/{n_tot} elements differ"


def _check_stats(jax_sd, port_sd):
    for key in jax_sd:
        if "running_" in key:
            np.testing.assert_allclose(port_sd[key].numpy(), jax_sd[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("case", ["entropy", "uda_kl", "udaiic_kl"])
def test_zoo_step_matches_jax(case):
    (_, _, before, _), (jmetrics, metrics, after_jax, after) = _run(case, 1)
    _check_losses(jmetrics, metrics)
    _check_params(before, after_jax, after)
    if case == "entropy":
        assert float(metrics["entropy"]) > 0


def test_meanteacher_two_steps_match_jax():
    runs = _run("meanteacher", 2)
    (_, _, before, _), (jm1, m1, jax1, port1), (jm2, m2, jax2, port2) = runs
    decay = 1.0 - EMA_WD
    # step 0: the students as any mode's, the teacher = student * (1 - wd)
    _check_losses(jm1, m1)
    _check_params(_students(before), _students(jax1), _students(port1))
    for sd in (jax1, port1):
        for key, t in _split(sd, "teacher.").items():
            if "running_" not in key and "num_batches" not in key:
                np.testing.assert_allclose(t.numpy(), sd[key].numpy() * np.float32(decay),
                                           rtol=1e-6, err_msg=key)
    t0, tj1, tp1 = _split(before, "teacher."), _split(jax1, "teacher."), _split(port1, "teacher.")
    _check_params(t0, tj1, tp1)
    _check_stats(tj1, tp1)
    # the teacher's own BN statistics: moved from init, unlike the student's
    stats = [k for k in t0 if "running_mean" in k]
    assert any(not torch.allclose(tp1[k], t0[k]) for k in stats)
    assert any(not torch.allclose(tp1[k], port1[k]) for k in stats)

    # step 1, from the JAX state after step 0: alpha = 1/2
    _check_losses(jm2, m2)
    _check_bound(_students(jax1), _students(jax2), _students(port2), 2.05, 0.05)
    tp2, tj2 = _split(port2, "teacher."), _split(jax2, "teacher.")
    for key, t in tp2.items():
        if "running_" not in key and "num_batches" not in key:
            want = (tj1[key] * 0.5 + 0.5 * port2[key]) * np.float32(decay)
            np.testing.assert_allclose(t.numpy(), want.numpy(), rtol=1e-6, atol=1e-9,
                                       err_msg=key)
    _check_bound(tj1, tj2, tp2, 1.05, 0.02)
    _check_stats(tj2, tp2)


@pytest.mark.parametrize("shape", [(7, 4), (2, 5, 6, 3)])
def test_entropy_matches_jax(shape):
    logits = np.random.default_rng(3).normal(size=shape).astype(np.float32) * 4
    prob = torch.softmax(torch.from_numpy(logits), -1)
    for reduction in ("mean", "sum", "none"):
        np.testing.assert_allclose(entropy(prob, reduction=reduction).numpy(),
                                   np.asarray(j_entropy(jnp.asarray(prob.numpy()),
                                                        reduction=reduction)),
                                   rtol=1e-6, atol=1e-7)


# (Trainer keys, Kernel keys) of each data path
DATA_PATHS = {
    "host": ({}, {}),
    "device_steps": ({"device_data": True, "epoch_scan": False}, {"geometry": "shear"}),
    "device_scan": ({"device_data": True, "scan_chunk": 1}, {"geometry": "shear"}),
    "device_pipelined": ({"device_data": True, "scan_chunk": 1, "pipelined_scan": True},
                         {"geometry": "shear"}),
    "device_preaug": ({"device_data": True, "scan_chunk": 1}, {"geometry": "shear",
                                                               "augment": "epoch"}),
}


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_zoo_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return make_loaders(root)


@pytest.mark.parametrize("path", list(DATA_PATHS))
@pytest.mark.parametrize("case", ["entropy", "meanteacher", "uda_kl"])
def test_zoo_trainer_runs_on_every_data_path(loaders, tmp_path, case, path):
    mode = CASES[case][0]
    trainer_keys, kernel = DATA_PATHS[path]
    cfg = make_config(mode, **trainer_keys)
    cfg["Kernel"] = kernel
    if case == "uda_kl":
        cfg["UDARegCriterion"]["name"] = "kl"
    trainer = trainer_zoos[mode](configuration=cfg, save_dir="run", max_epoch=1, num_batches=2,
                                 device="cpu", crop_size=CROP, run_dir=str(tmp_path), **loaders)
    trainer.init()
    teacher0 = None if trainer._teacher is None else {
        k: v.clone() for k, v in trainer._teacher.state_dict().items()}
    mi_joint.reset_launch_counts()
    rotate.reset_launch_counts()
    best = trainer.start_training()
    assert np.isfinite(best) and 0.0 <= best <= 1.0
    assert sum(mi_joint.LAUNCHES.values()) == sum(rotate.LAUNCHES.values()) == 0
    assert int(trainer._step_counter) == 2
    row = trainer._storage._rows[0]
    term = "tra_entropy_mean" if mode == "entropy" else "tra_uda_mean"
    for key in ("tra_sup_loss_mean", "tra_reg_loss_mean", term, "val_dice_DSC_mean"):
        assert np.isfinite(row[key]), key
    assert row["tra_reg_loss_mean"] == row[term]
    if teacher0 is not None:
        teacher = trainer._teacher.state_dict()
        student = trainer._model.state_dict()
        for key in ("Conv1.conv.0.weight", "Conv1.conv.1.running_mean"):
            assert not torch.equal(teacher[key], teacher0[key]), key
            assert not torch.equal(teacher[key], student[key]), key
