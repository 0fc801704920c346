"""The port's device-data train step, epoch loops and trainer on the CPU.

- One device-data ``udaiic`` step (crop 32, 2 + 3 slices, paddings [1, 1])
  against the JAX package's step with ``data_store``, for the ``fused`` and
  ``shear`` geometries: the same weights (``weights.py``), the same store and
  indices, and the JAX step's own augmentation and flip draws (from its
  ``split(state.rng, 4)``) injected into the port's step. Held as in
  tests/test_torch_step.py: losses at rtol 2e-4, post-Adam parameters with the
  two-tier bound (|diff| <= 2.05 lr; more than 0.05 lr apart for under 0.5%
  of the elements: Adam's first step is about -lr * sign(g)), BN running
  statistics at rtol 1e-4. The augmented batches themselves are exact
  (tests/test_torch_device_data.py), so no rint-tie allowance is needed.
- The port's epoch loops (plain, pipelined, preaug) equal the same steps
  called one by one, exactly: the same operations in the same order.
- A CPU trainer run with ``Trainer.device_data: true`` (chunked epoch scan,
  and the per-step loop), and the ``Kernel`` option checks.
"""

import csv
from itertools import chain

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_device_data import jax_draws

from mi_based_regularized_semi_supervised_segmentation_tpu.data import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.device_pipeline import (
    DeviceDataStore as JStore,
)
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
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    ACDCSemiInterface,
    PatientEvalLoader,
    SegmentationLoader,
    create_val_split,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.augment import (
    PairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
    augment_from_store,
    build_augment_fn,
    build_epoch_scan,
    build_epoch_scan_pipelined,
    build_epoch_scan_preaug,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.trainer import (
    kernel_options,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint, rotate
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    projector_state_dict,
    unet_state_dict,
)

FEATS = ("Conv5", "Up_conv3", "Up_conv2")
IMPORTANCE = (1.0, 0.5, 0.5)
CROP, BL, BU, C, S, K = 32, 2, 3, 4, 2, 5
LR, WD = 1e-3, 1e-4
UDAIIC = dict(uda_criterion="mse", uda_weight=10.0, iic_weight=0.1, reg_weight=1.0,
              paddings=[1, 1], patch_sizes=1024)
COMMON = dict(num_classes=C, feature_names=FEATS, feature_importance=IMPORTANCE, **UDAIIC)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc_scan_torch"))
    generate_synthetic_acdc(root, num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def port_store(data_root):
    return DeviceDataStore(ACDCDataset(data_root, "train"), pack=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda x: np.array(x, copy=True), jax.device_get(tree))


def _port_state(params, stats):
    sd = unet_state_dict(params["model"], stats)
    sd.update({f"proj.{k}": v for k, v in projector_state_dict(params["projector"]).items()})
    return sd


@pytest.mark.parametrize("geometry", ["fused", "shear"])
def test_device_step_matches_jax(data_root, port_store, geometry):
    jstore = JStore(JACDCDataset(data_root, "train"), pack=True)
    lab_idx = np.array([1, 7], np.int32)
    unlab_idx = np.array([0, 5, 18], np.int32)

    # --- JAX: the step with the store, and the draws it makes ----------
    jmodel = JUNet(input_dim=1, num_classes=C)
    jproj = JProjector(feature_names=FEATS, num_clusters=K, num_subheads=S, local_flat=True)
    tx = j_build_optimizer({"name": "Adam", "lr": LR, "weight_decay": WD})
    state = init_train_state(jmodel, tx, (1, CROP, CROP, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS)
    before = _port_state(_np_tree(state.params), _np_tree(state.batch_stats))
    _, flip_key, aug_l, aug_u = jax.random.split(state.rng, 4)
    flip_mask = torch.from_numpy(np.array(j_sample_flip_mask(flip_key, BU, 0.8)))
    aug = {"labeled": jax_draws(aug_l, BL, jstore.shape, CROP, jstore.valid_hw_dev[lab_idx],
                                jstore.offsets_dev[lab_idx]),
           "unlabeled": jax_draws(aug_u, BU, jstore.shape, CROP, jstore.valid_hw_dev[unlab_idx],
                                  jstore.offsets_dev[unlab_idx])}
    jstep = j_build_train_step(jmodel, tx, "udaiic", projector=jproj, backend="xla",
                               data_store={"labeled": jstore, "unlabeled": jstore}, crop=CROP,
                               geometry=geometry, **COMMON)
    state1, jmetrics = jstep(state, {"labeled_indices": jnp.asarray(lab_idx),
                                     "unlabeled_indices": jnp.asarray(unlab_idx)})
    after_jax = _port_state(_np_tree(state1.params), _np_tree(state1.batch_stats))

    # --- port: the same weights, store, indices and draws --------------
    model = UNet(1, C)
    model.load_state_dict({k: v for k, v in before.items() if not k.startswith("proj.")})
    proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S)
    proj.load_state_dict({k[5:]: v for k, v in before.items() if k.startswith("proj.")})
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": LR, "weight_decay": WD})
    step = build_train_step(model, opt, "udaiic", generator=torch.Generator(), projector=proj,
                            backend="plain", data_store=port_store, crop=CROP,
                            geometry=geometry, **COMMON)
    rotate.reset_launch_counts()
    metrics = step({"labeled_indices": torch.from_numpy(lab_idx),
                    "unlabeled_indices": torch.from_numpy(unlab_idx)},
                   flip_mask=flip_mask, aug_params=aug)
    assert sum(rotate.LAUNCHES.values()) == 0  # CPU tensors: the plain rotation

    assert set(jmetrics) == set(metrics)
    for key in jmetrics:
        if key.startswith("sup_dice"):
            np.testing.assert_array_equal(metrics[key].numpy(), np.asarray(jmetrics[key]))
        else:
            np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=2e-4,
                                       atol=1e-7, err_msg=key)
    after = dict(model.state_dict())
    after.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
    n_tot = n_loose = 0
    for key, p0 in before.items():
        if "running_" in key or "num_batches" in key:
            continue
        diff = np.abs((after[key] - p0).numpy() - (after_jax[key] - p0).numpy())
        assert diff.max() <= 2.05 * LR, f"{key}: step differs by {diff.max():.2e}"
        n_tot += diff.size
        n_loose += int((diff > 0.05 * LR).sum())
    assert n_loose / n_tot < 0.005, f"{n_loose}/{n_tot} elements step differently"
    for key in before:
        if "running_" in key:
            np.testing.assert_allclose(after[key].numpy(), after_jax[key].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=key)


def _fresh(seed=0):
    torch.manual_seed(seed)
    model, proj = UNet(1, C), ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S)
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": LR, "weight_decay": WD})
    return model, proj, opt, torch.Generator().manual_seed(3)


def _step(model, proj, opt, gen, store):
    return build_train_step(model, opt, "udaiic", generator=gen, projector=proj,
                            backend="plain", data_store=store, crop=CROP, geometry="shear",
                            **COMMON)


@pytest.mark.parametrize("loop", ["plain", "pipelined", "preaug"])
def test_epoch_loop_equals_stepwise(port_store, loop):
    rng = np.random.default_rng(0)
    n = 3
    batches = {"labeled_indices": torch.from_numpy(rng.integers(0, 24, (n, BL))),
               "unlabeled_indices": torch.from_numpy(rng.integers(0, 24, (n, BU)))}
    rows = [{k: v[i] for k, v in batches.items()} for i in range(n)]

    model, proj, opt, gen = _fresh()
    if loop == "plain":
        out = build_epoch_scan(_step(model, proj, opt, gen, port_store), n)(batches)
    elif loop == "pipelined":
        aug = build_augment_fn(port_store, crop=CROP, geometry="shear")
        out = build_epoch_scan_pipelined(aug, _step(model, proj, opt, gen, None), n)(batches, 11)
    else:
        out = build_epoch_scan_preaug(_step(model, proj, opt, gen, None), port_store, n,
                                      crop=CROP, geometry="shear", generator=gen)(batches)

    model2, proj2, opt2, gen2 = _fresh()
    if loop == "plain":
        step = _step(model2, proj2, opt2, gen2, port_store)
        ref = [step(r) for r in rows]
    elif loop == "pipelined":
        step = _step(model2, proj2, opt2, gen2, None)
        aug = build_augment_fn(port_store, crop=CROP, geometry="shear")
        ref = [step(aug(11, i, r)) for i, r in enumerate(rows)]
    else:
        step = _step(model2, proj2, opt2, gen2, None)
        lab_img, lab_tgt = augment_from_store(port_store, None, CROP, "shear", gen2)
        unl_img, _ = augment_from_store(port_store, None, CROP, "shear", gen2, with_labels=False)
        ref = [step({"labeled_image": lab_img[r["labeled_indices"]],
                     "labeled_target": lab_tgt[r["labeled_indices"]],
                     "unlabeled_image": unl_img[r["unlabeled_indices"]]}) for r in rows]

    assert set(out) == set(ref[0])
    for key, stacked in out.items():
        assert stacked.shape[0] == n
        torch.testing.assert_close(stacked, torch.stack([m[key] for m in ref]), rtol=0, atol=0)
    for (name, p), p2 in zip(model.state_dict().items(), model2.state_dict().values()):
        torch.testing.assert_close(p, p2, rtol=0, atol=0, msg=name)


@pytest.fixture(scope="module")
def loaders(data_root):
    tf_train = PairedTransform(rotation=45, vflip=True, hflip=True, crop=CROP,
                               jitter=(0.5, 1.5))
    tf_val = PairedTransform(rotation=0, vflip=False, hflip=False, crop=CROP,
                             center_crop=True, jitter=None)
    lab, unlab, test = ACDCSemiInterface(data_root, 0.5, 0.5).create_semi_supervised_datasets()
    return dict(
        labeled_loader=SegmentationLoader(lab, tf_train, 2, seed=0, num_workers=0),
        unlabeled_loader=SegmentationLoader(unlab, tf_train, 3, seed=1, num_workers=0),
        val_loader=PatientEvalLoader(create_val_split(unlab, 2), tf_val),
        test_loader=PatientEvalLoader(test, tf_val),
    )


def _config(**trainer):
    return {
        "RandomSeed": 7,
        "Arch": {"input_dim": 1, "num_classes": 4},
        "Optim": {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 2, "warmup_max": 1},
        "Trainer": {"feature_names": list(FEATS), "feature_importance": [1, 0.5, 0.5],
                    "name": "udaiic", "num_batches": 3, "max_epoch": 2, **trainer},
        "Kernel": {"geometry": "shear"},
        "UDARegCriterion": {"name": "mse", "weight": 5.0},
        "IICRegParameters": {
            "EncoderParams": {"num_clusters": 5, "num_subheads": 2},
            "DecoderParams": {"num_clusters": 5, "num_subheads": 2},
            "LossParams": {"paddings": [1, 3], "patch_sizes": 1024},
            "weight": 0.1,
        },
    }


@pytest.mark.parametrize("epoch_scan", [True, False])
def test_device_data_trainer_runs_on_cpu(loaders, tmp_path, epoch_scan):
    cfg = _config(device_data=True, epoch_scan=epoch_scan, scan_chunk=2)
    trainer = trainer_zoos["udaiic"](configuration=cfg, save_dir="dev", max_epoch=2,
                                     num_batches=3, device="cpu", crop_size=CROP,
                                     run_dir=str(tmp_path), step_timing=True, **loaders)
    trainer.init()
    assert trainer._epoch_chunks == [2, 1] if epoch_scan else not trainer._epoch_scan
    mi_joint.reset_launch_counts()
    rotate.reset_launch_counts()
    best = trainer.start_training()
    assert np.isfinite(best) and 0.0 <= best <= 1.0
    assert sum(mi_joint.LAUNCHES.values()) == sum(rotate.LAUNCHES.values()) == 0
    assert len(trainer.step_times_ms) == 6 and all(t > 0 for t in trainer.step_times_ms)
    run = tmp_path / "dev"
    for name in ("storage.csv", "last.pth", "best.pth", "config.yaml", "events.jsonl"):
        assert (run / name).exists(), name
    with open(run / "storage.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    for key in ("tra_sup_loss_mean", "tra_mi_mean", "tra_uda_mean", "val_dice_DSC_mean",
                "test_dice_DSC_mean"):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    state = torch.load(run / "last.pth", weights_only=False)
    assert state["meta"]["cur_epoch"] == 1


def test_kernel_options_rejected_eagerly(tmp_path):
    common = dict(labeled_loader=None, unlabeled_loader=None, val_loader=None, test_loader=None,
                  device="cpu", run_dir=str(tmp_path))
    cfg = _config(device_data=True)
    cfg["Kernel"] = {"geometry": "bogus"}
    with pytest.raises(ValueError, match="Kernel.geometry='bogus'"):
        trainer_zoos["udaiic"](configuration=cfg, **common)
    cfg["Kernel"] = {"augment": "bogus"}
    with pytest.raises(ValueError, match="Kernel.augment='bogus'"):
        trainer_zoos["udaiic"](configuration=cfg, **common)
    cfg = _config(device_data=True, pipelined_scan=True)
    cfg["Kernel"] = {"augment": "epoch"}
    with pytest.raises(ValueError, match="mutually exclusive"):
        trainer_zoos["udaiic"](configuration=cfg, **common)


def test_kernel_options_warn_when_ignored(capsys):
    assert kernel_options(_config()) == ("auto", "shear", "draw")
    out = capsys.readouterr().out
    assert "Kernel.geometry='shear' only applies to on-device augmentation" in out
    cfg = _config(device_data=True, epoch_scan=False)
    cfg["Kernel"] = {"augment": "epoch"}
    assert kernel_options(cfg) == ("auto", "fused", "epoch")
    out = capsys.readouterr().out
    assert "Kernel.augment='epoch' only applies to the device-data epoch-scan path" in out
    assert "Kernel.geometry" not in out
    kernel_options(_config(device_data=True))  # every setting takes effect: silent
    assert capsys.readouterr().out == ""
