"""Experiment entry point of the PyTorch port.

    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Trainer.name=udaiic Trainer.save_dir=udaiic_run Trainer.device=cuda \
        UDARegCriterion.weight=10.0 IICRegParameters.weight=0.1 \
        Trainer.device_data=true Kernel.geometry=shear   # data staged on the card
    # resume a run that died, then evaluate its best.pth on the test patients
    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Trainer.name=udaiic Trainer.save_dir=udaiic_run Checkpoint=runs/udaiic_run \
        Inference=true

Data parallel, one process per card (``Parallel.num_devices`` null takes
the world size; any other value must equal it):

    torchrun --nproc_per_node=8 -m \
        mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Trainer.name=udaiic Trainer.save_dir=udaiic_dp
    # several hosts without torchrun: one process per card, each given its id
    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.main \
        Parallel.multihost=true Parallel.coordinator_address=10.0.0.1:29500 \
        Parallel.num_processes=16 Parallel.process_id=$ID ...

Flow: config (YAML + dotted-key overrides; ``Parallel`` checked against the
launcher's world size, before any data: ``engine/trainer.py:check_parallel``;
an unknown ``Optim.name`` and ``Lookahead`` / ``Ranger`` raise) -> the
process group (``parallel.init_distributed``: nccl on cuda, gloo on cpu;
each rank on ``cuda:<LOCAL_RANK>``) -> seed -> matmul precision -> the
synthetic set (rank 0, then a barrier) -> loaders (labeled / unlabeled /
test, val carved from unlabeled; eval patients padded to the data world) ->
trainer from the registry -> init -> resume from ``Checkpoint`` (a
checkpoint or a run directory: its ``last.pth``; entries matched by name
and shape; every rank loads it) -> start_training -> with ``Inference``, the
test patients on ``best.pth`` with Hausdorff and PNG dumps -> the group is
left. Runs on ``Trainer.device`` (``cuda`` by default; ``cpu`` on request).
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from . import PROJECT_PATH
from .config import ConfigManager
from .data import create_val_loader, generate_synthetic_acdc, get_dataloaders
from .engine import check_optimizer, check_parallel, trainer_zoos
from .engine.trainer import eval_pad_multiple
from .parallel import init_distributed, launcher_world
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
    """Trains (and evaluates) as the config says; returns the trainer. A
    process group joined before the call is taken as it is (any backend)."""
    config = ConfigManager(argv=argv if argv is not None else sys.argv[1:]).config
    par = config.get("Parallel") or {}
    multihost = bool(par.get("multihost"))
    check_parallel(config, launcher_world(multihost, par.get("num_processes")))
    check_optimizer(config)
    trainer_config = dict(config["Trainer"])
    ctx = init_distributed(
        str(trainer_config.get("device", "cuda")), space_size=int(par.get("space_size", 1) or 1),
        multihost=multihost, coordinator_address=par.get("coordinator_address"),
        num_processes=par.get("num_processes"), process_id=par.get("process_id"))
    loaders = ()
    try:
        set_seed(int(config.get("RandomSeed", 1)))
        set_matmul_precision(str((config.get("Precision") or {}).get("matmul_precision",
                                                                     "highest")))
        if (config.get("Data") or {}).get("synthetic"):
            from . import DATA_PATH

            if ctx.is_main:
                generate_synthetic_acdc(DATA_PATH)
            ctx.barrier()
        multiple = eval_pad_multiple(ctx.data_world)
        # on a card the host path's loaders make their batches in processes of
        # their own, so their threads leave the step's dispatch alone
        own_process = (ctx.device.type == "cuda"
                       and not bool(trainer_config.get("device_data", False)))
        labeled_loader, unlabeled_loader, test_loader = get_dataloaders(
            config, eval_pad_multiple=multiple, own_process=own_process)
        loaders = (labeled_loader, unlabeled_loader)
        val_loader = create_val_loader(unlabeled_loader, test_loader, pad_multiple=multiple)

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
            context=ctx,
            **trainer_config,
        )
        trainer.init()
        checkpoint = config.get("Checkpoint")
        if checkpoint is not None:
            trainer.load_state_dict_from_path(checkpoint, strict=False)
        for loader in loaders:  # set-up: their processes started with the loaders
            loader.wait_ready()
        trainer.start_training()
        if config.get("Inference"):
            _, score = trainer.inference()
            if ctx.is_main:
                print(f"inference DSC_mean={score:.4f}", flush=True)
    finally:
        for loader in loaders:
            loader.close()
        ctx.close()
    return trainer


if __name__ == "__main__":
    main()
