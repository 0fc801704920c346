"""Contrastive pretrain entry point of the PyTorch port (``config/pretrain.yaml``
+ dotted-key overrides, as ``main.py``):

    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.pretrain_main \
        Trainer.name=iiccontrast Trainer.save_dir=iic_run Trainer.device=cuda
    # resume each phase from runs/iic_run/<phase>/last.pth
    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.pretrain_main \
        Trainer.name=iiccontrast Trainer.save_dir=iic_run Checkpoint=runs/iic_run

Data parallel, one process per card, as ``main.py`` (``Parallel.num_devices``
null takes the world size; any other value must equal it):

    torchrun --nproc_per_node=8 -m \
        mi_based_regularized_semi_supervised_segmentation_tpu_torch.pretrain_main \
        Trainer.name=iiccontrast Trainer.save_dir=iic_dp

Flow: config (``Parallel`` checked against the launcher's world size, before
any data: ``engine/trainer.py:check_parallel``; cuda without a card raises)
-> the process group (``parallel.init_distributed``) -> seed -> matmul
precision -> the synthetic set (rank 0, then a barrier) -> the labeled /
unlabeled / test split -> the contrastive loader
(``ContrastBatchSampler``: ``PretrainData.group_sample_num`` patients x one
slice of each partition, two views each), the finetune loader and the val
loader (the test patients) -> the trainer of ``pretrain_zoos`` ->
start_training with the phase options: ``PretrainEncoder``,
``PretrainDecoder`` (``iiccontrast``: with ``IICHead.Encoder`` /
``IICHead.Decoder`` merged in) and ``FinetuneNetwork`` (its mean-teacher
keys for ``contrastMT`` only) -> the group is left. Every rank runs the same
loaders and keeps its rows of each batch; each phase's step sums over the
data group (``engine/pretrain.py``); only rank 0 writes. A data world of 1
has no group and runs the one-process steps. Runs on ``Trainer.device``
(``cuda`` by default; ``cpu`` on request).
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List, Optional

from . import DATA_PATH, PROJECT_PATH
from .config import ConfigManager
from .data import (
    ACDCSemiInterface,
    ACDCStrongTransforms,
    ContrastBatchSampler,
    PatientEvalLoader,
    SegmentationLoader,
    TwiceLoader,
    generate_synthetic_acdc,
)
from .engine import check_parallel, pretrain_zoos, resolve_device
from .engine.trainer import eval_pad_multiple
from .main import set_matmul_precision
from .parallel import init_distributed, launcher_world
from .utils import gethash, set_seed

PRETRAIN_CONFIG_PATH = str(Path(__file__).resolve().parent / "config" / "pretrain.yaml")
FINETUNE_KEYS = ("lr", "weight_decay", "multiplier", "warmup_max")  # all but contrastMT's


def main(argv: Optional[List[str]] = None):
    """Runs the three phases as the config says; returns the trainer. A
    process group joined before the call is taken as it is (any backend)."""
    config = ConfigManager(default_path=PRETRAIN_CONFIG_PATH,
                           argv=argv if argv is not None else sys.argv[1:]).config
    par = config.get("Parallel") or {}
    multihost = bool(par.get("multihost"))
    check_parallel(config, launcher_world(multihost, par.get("num_processes")), "pretrain_main")
    trainer_cfg = dict(config["Trainer"])
    name = trainer_cfg.pop("name")
    if name not in pretrain_zoos:
        raise ValueError(f"Trainer.name={name!r}: expected one of {sorted(pretrain_zoos)}")
    device = str(trainer_cfg.get("device", "cuda"))
    resolve_device(device)  # before any data is made
    ctx = init_distributed(
        device, space_size=int(par.get("space_size", 1) or 1), multihost=multihost,
        coordinator_address=par.get("coordinator_address"),
        num_processes=par.get("num_processes"), process_id=par.get("process_id"))
    try:
        set_seed(int(config.get("RandomSeed", 1)))
        set_matmul_precision(str((config.get("Precision") or {}).get("matmul_precision",
                                                                     "highest")))
        data_cfg = config.get("Data") or {}
        if data_cfg.get("synthetic"):
            if ctx.is_main:
                generate_synthetic_acdc(DATA_PATH)
            ctx.barrier()
        labeled_set, unlabeled_set, test_set = ACDCSemiInterface(
            root_dir=data_cfg.get("root_dir") or DATA_PATH,
            labeled_data_ratio=data_cfg["labeled_data_ratio"],
            unlabeled_data_ratio=data_cfg["unlabeled_data_ratio"],
        ).create_semi_supervised_datasets()

        seed = int(config.get("RandomSeed", 10))
        pcfg = config.get("PretrainData") or {}
        sampler = ContrastBatchSampler(
            unlabeled_set.stems, unlabeled_set.get_group, unlabeled_set.get_partition,
            group_sample_num=int(pcfg.get("group_sample_num", 4)),
            partition_sample_num=int(pcfg.get("partition_sample_num", 1)), seed=seed)
        pretrain_loader = TwiceLoader(unlabeled_set, ACDCStrongTransforms.pretrain,
                                      batch_sampler=sampler, seed=seed,
                                      num_workers=int(pcfg.get("num_workers", 4)))
        fcfg = config.get("FineTuneData") or {}
        fine_tune_loader = SegmentationLoader(labeled_set, ACDCStrongTransforms.pretrain,
                                              batch_size=int(fcfg.get("batch_size", 4)),
                                              seed=seed + 1,
                                              num_workers=int(fcfg.get("num_workers", 4)))
        val_loader = PatientEvalLoader(test_set, ACDCStrongTransforms.val,
                                       pad_multiple=eval_pad_multiple(ctx.data_world))

        trainer = pretrain_zoos[name](
            pretrain_loader=pretrain_loader,
            fine_tune_loader=fine_tune_loader,
            val_loader=val_loader,
            configuration={**config, "GITHASH": gethash(PROJECT_PATH)},
            context=ctx,
            **trainer_cfg,
        )
        enc_opt = dict(config.get("PretrainEncoder") or {})
        dec_opt = dict(config.get("PretrainDecoder") or {})
        fin_opt = dict(config.get("FinetuneNetwork") or {})
        if name != "contrastMT":
            fin_opt = {k: fin_opt[k] for k in FINETUNE_KEYS if k in fin_opt}
        if name == "iiccontrast":
            iic_cfg = config.get("IICHead") or {}
            enc_opt.update(iic_cfg.get("Encoder") or {})
            dec_opt.update(iic_cfg.get("Decoder") or {})
        trainer.start_training(
            checkpoint=config.get("Checkpoint"),
            pretrain_encoder_init_options=enc_opt,
            pretrain_decoder_init_options=dec_opt,
            finetune_network_init_options=fin_opt,
        )
    finally:
        ctx.close()
    return trainer


if __name__ == "__main__":
    main()
