"""The port's trainer loop on the CPU at tiny shapes: config wiring, the
epoch loop with val/test eval, storage.csv and the torch checkpoints; and the
``main`` command line's config parsing."""

import csv

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.config import ConfigManager
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCSemiInterface,
    PatientEvalLoader,
    SegmentationLoader,
    create_val_split,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.augment import (
    PairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer as trainer_mod
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer_zoos
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP = 32


@pytest.fixture(scope="module")
def loaders(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    tf_train = PairedTransform(rotation=45, vflip=True, hflip=True, crop=CROP,
                               jitter=(0.5, 1.5))
    tf_val = PairedTransform(rotation=0, vflip=False, hflip=False, crop=CROP,
                             center_crop=True, jitter=None)
    lab, unlab, test = ACDCSemiInterface(str(root), 0.5, 0.5).create_semi_supervised_datasets()
    return dict(
        labeled_loader=SegmentationLoader(lab, tf_train, 2, seed=0, num_workers=0),
        unlabeled_loader=SegmentationLoader(unlab, tf_train, 3, seed=1, num_workers=0),
        val_loader=PatientEvalLoader(create_val_split(unlab, 2), tf_val),
        test_loader=PatientEvalLoader(test, tf_val),
    )


def _config(mode):
    return {
        "RandomSeed": 7,
        "Arch": {"input_dim": 1, "num_classes": 4},
        "Optim": {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 2, "warmup_max": 1},
        "Trainer": {"feature_names": ["Conv5", "Up_conv3", "Up_conv2"],
                    "feature_importance": [1, 0.5, 0.5], "name": mode,
                    "num_batches": 2, "max_epoch": 2},
        "UDARegCriterion": {"name": "mse", "weight": 5.0},
        "IICRegParameters": {
            "EncoderParams": {"num_clusters": 5, "num_subheads": 2},
            "DecoderParams": {"num_clusters": 5, "num_subheads": 2},
            "LossParams": {"paddings": [1, 3], "patch_sizes": 1024},
            "weight": 0.1,
        },
    }


@pytest.mark.parametrize("mode", ["partial", "udaiic"])
def test_trainer_runs_on_cpu(loaders, tmp_path, mode):
    trainer = trainer_zoos[mode](configuration=_config(mode), save_dir=f"t_{mode}",
                                 max_epoch=2, num_batches=2, device="cpu", crop_size=CROP,
                                 run_dir=str(tmp_path), **loaders)
    trainer.init()
    mi_joint.reset_launch_counts()
    best = trainer.start_training()
    assert np.isfinite(best) and 0.0 <= best <= 1.0
    assert sum(mi_joint.LAUNCHES.values()) == 0  # CPU tensors take the plain version

    run = tmp_path / f"t_{mode}"
    for name in ("storage.csv", "last.pth", "best.pth", "config.yaml", "events.jsonl"):
        assert (run / name).exists(), name
    with open(run / "storage.csv") as f:
        rows = list(csv.DictReader(f))
    assert [int(r["epoch"]) for r in rows] == [0, 1]
    for key in ("tra_sup_loss_mean", "val_dice_DSC_mean", "test_dice_DSC_mean"):
        assert all(np.isfinite(float(r[key])) for r in rows), key
    if mode == "udaiic":
        assert all(np.isfinite(float(r["tra_mi_mean"])) for r in rows)
        assert all(np.isfinite(float(r["tra_uda_mean"])) for r in rows)

    state = torch.load(run / "last.pth", weights_only=False)
    assert state["meta"]["cur_epoch"] == 1 and state["meta"]["mode"] == mode
    assert (state["projector"] is None) == (mode == "partial")
    assert "Conv1.conv.0.weight" in state["model"]


def test_main_cli_config_parses():
    config = ConfigManager(argv=[
        "Trainer.name=udaiic", "Trainer.device=cpu", "Trainer.num_batches=3",
        "Optim.lr=1e-5", "IICRegParameters.LossParams.paddings=[1,3]",
        "Trainer.feature_names=[Conv5,Up_conv2]"]).config
    assert config["Trainer"]["name"] == "udaiic"
    assert config["Trainer"]["device"] == "cpu"
    assert config["Trainer"]["num_batches"] == 3
    assert config["Optim"]["lr"] == 1e-5
    assert config["IICRegParameters"]["LossParams"]["paddings"] == [1, 3]
    assert config["Trainer"]["feature_names"] == ["Conv5", "Up_conv2"]
    # untouched defaults of the port's semi.yaml
    assert ConfigManager(argv=[]).config["Trainer"]["device"] == "cuda"
    assert config["Kernel"]["backend"] == "auto"
    assert config["Precision"]["matmul_precision"] == "highest"


class _Staged(Exception):
    """Raised by the stub that stands in for staging the data on the device."""


@pytest.mark.parametrize("mode", ["uda", "udaiic"])
@pytest.mark.parametrize("name,error", [("kl", _Staged), ("bogus", ValueError)])
def test_uda_criterion_is_checked_before_any_data_is_staged(tmp_path, monkeypatch, mode, name,
                                                            error):
    """UDARegCriterion.name is checked when the trainer is built, as the JAX
    trainer asserts mse | kl: 'kl' passes the check and the trainer goes on
    to stage its data; any other name but 'mse' is refused before that."""
    staged = []

    def stage(self, *args):
        staged.append(args)
        raise _Staged

    monkeypatch.setattr(trainer_mod.SemiTrainer, "_setup_device_data", stage)
    cfg = _config(mode)
    cfg["UDARegCriterion"]["name"] = name
    cfg["Trainer"]["device_data"] = True
    trainer = trainer_zoos[mode](labeled_loader=None, unlabeled_loader=None, val_loader=None,
                                 test_loader=None, configuration=cfg, device="cpu",
                                 crop_size=CROP, run_dir=str(tmp_path))
    with pytest.raises(error, match=None if error is _Staged else "UDARegCriterion.name"):
        trainer.init()
    assert len(staged) == (error is _Staged)
