"""Experiment entry point of the PyTorch port.

    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Trainer.name=udaiic Trainer.save_dir=udaiic_run Trainer.device=cuda \
        UDARegCriterion.weight=10.0 IICRegParameters.weight=0.1 \
        Trainer.device_data=true Kernel.geometry=shear   # data staged on the card
    # resume a run that died, then evaluate its best.pth on the test patients
    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Trainer.name=udaiic Trainer.save_dir=udaiic_run Checkpoint=runs/udaiic_run \
        Inference=true

Flow: config (YAML + dotted-key overrides; a ``Parallel`` key off its
default raises) -> seed -> matmul precision ->
loaders (labeled / unlabeled / test, val carved from unlabeled) -> trainer
from the registry -> init -> resume from ``Checkpoint`` (a checkpoint or a
run directory: its ``last.pth``; entries matched by name and shape) ->
start_training -> with ``Inference``, the test patients on ``best.pth`` with
Hausdorff and PNG dumps. Runs on ``Trainer.device`` (``cuda`` by default;
``cpu`` on request).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from . import PROJECT_PATH
from .config import ConfigManager
from .data import create_val_loader, generate_synthetic_acdc, get_dataloaders
from .engine import check_parallel, trainer_zoos
from .utils import gethash, set_seed


def set_matmul_precision(name: str) -> None:
    """``highest`` keeps fp32 matmuls and convolutions in full fp32 (TF32
    off), the meaning of the JAX package's default precision."""
    if name not in ("highest", "high", "medium"):
        raise ValueError(f"Precision.matmul_precision={name!r}")
    torch.set_float32_matmul_precision(name)
    torch.backends.cuda.matmul.allow_tf32 = name != "highest"
    torch.backends.cudnn.allow_tf32 = name != "highest"


def main(argv: Optional[List[str]] = None):
    config = ConfigManager(argv=argv if argv is not None else sys.argv[1:]).config
    check_parallel(config)
    set_seed(int(config.get("RandomSeed", 1)))
    set_matmul_precision(str((config.get("Precision") or {}).get("matmul_precision", "highest")))

    if (config.get("Data") or {}).get("synthetic"):
        from . import DATA_PATH

        generate_synthetic_acdc(DATA_PATH)
    labeled_loader, unlabeled_loader, test_loader = get_dataloaders(config)
    val_loader = create_val_loader(unlabeled_loader, test_loader)

    trainer_config = dict(config["Trainer"])
    name = trainer_config.pop("name")
    if name not in trainer_zoos:
        raise ValueError(f"Trainer.name={name!r}: expected one of {sorted(trainer_zoos)}")
    Trainer = trainer_zoos[name]
    trainer = Trainer(
        labeled_loader=labeled_loader,
        unlabeled_loader=unlabeled_loader,
        val_loader=val_loader,
        test_loader=test_loader,
        configuration={**config, "GITHASH": gethash(PROJECT_PATH)},
        **trainer_config,
    )
    trainer.init()
    checkpoint = config.get("Checkpoint")
    if checkpoint is not None:
        trainer.load_state_dict_from_path(checkpoint, strict=False)
    trainer.start_training()
    if config.get("Inference"):
        _, score = trainer.inference()
        print(f"inference DSC_mean={score:.4f}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
