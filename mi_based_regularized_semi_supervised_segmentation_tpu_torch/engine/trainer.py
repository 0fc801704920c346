"""Trainers: init -> epoch loop -> val/test eval -> checkpoints, for the
partial / uda / iic / udaiic modes (counterpart of the JAX package's
``engine/trainer.py``).

Per epoch: set the epoch's learning rate, run ``num_batches`` train steps,
read the metrics back, evaluate the val and test patients (volume dice),
append to ``storage.csv`` and the event log, and save ``last.pth`` (and
``best.pth`` when val DSC improves).

Two data paths:
- host loader (default): numpy augmentation in loader threads, one batch
  upload per step, one metrics readback per epoch;
- ``Trainer.device_data: true``: the datasets are staged on the card once
  (``data/device_pipeline.py``), each step takes slice indices and augments
  on the card (``Kernel.geometry``). With ``Trainer.epoch_scan`` (default)
  the epoch runs in chunks of at most ``scan_chunk`` steps, each given its
  indices in one upload and read back once.
"""

from __future__ import annotations

import time
from itertools import chain
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import yaml

from .. import PROJECT_PATH
from ..data.device_pipeline import DeviceDataStore, DeviceIndexLoader, DevicePatientEvalLoader
from ..models import ProjectorWrapper, UNet
from ..models.unet import ENCODER_NAMES
from ..ops.augment_device import GEOMETRIES
from ..utils import (
    AverageValueMeter,
    MeterInterface,
    MultipleAverageValueMeter,
    Storage,
    StorageIncomeDict,
    SummaryWriter,
    UniversalDice,
)
from .optim import build_optimizer, lr_at_epoch, set_learning_rate
from .steps import (
    build_augment_fn,
    build_epoch_scan,
    build_epoch_scan_pipelined,
    build_epoch_scan_preaug,
    build_eval_scan,
    build_eval_step,
    build_train_step,
)

LAST_NAME = "last.pth"
BEST_NAME = "best.pth"
_ROADMAP = "is not ported yet; see ROADMAP.md"


def resolve_device(device: str) -> torch.device:
    """``cuda`` (or ``cuda:N``) or ``cpu``; asking for CUDA where none is
    visible raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"Trainer.device={device!r} but torch.cuda.is_available() is false; "
                           "pass Trainer.device=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Trainer.device={device!r}: expected 'cuda' or 'cpu'")
    return dev


def _check_defaults(cfg: Dict[str, Any]) -> None:
    """Keys the port does not implement yet must keep their defaults."""
    arch = cfg.get("Arch") or {}
    precision = cfg.get("Precision") or {}
    parallel = cfg.get("Parallel") or {}
    unported = {
        "Arch.stem": (arch.get("stem", "conv"), "conv"),
        "Arch.remat": (bool(arch.get("remat", False)), False),
        "Precision.compute_dtype": (precision.get("compute_dtype", "float32"), "float32"),
        "Precision.bn_dtype": (precision.get("bn_dtype", "float32"), "float32"),
        "Parallel.num_devices": (parallel.get("num_devices") in (None, 1), True),
    }
    for key, (value, default) in unported.items():
        if value != default:
            raise NotImplementedError(f"{key}={value!r} {_ROADMAP}")


def _warn(msg: str) -> None:
    print(f"[trainer] WARNING: {msg}", flush=True)


def kernel_options(cfg: Dict[str, Any]) -> Tuple[str, str, str]:
    """(backend, geometry, augment) of the ``Kernel`` section, validated, with
    a warning for each setting the configured data path ignores."""
    kernel = cfg.get("Kernel") or {}
    trainer = cfg.get("Trainer") or {}
    backend = kernel.get("backend", "auto")
    geometry = kernel.get("geometry", "fused")
    augment = kernel.get("augment", "draw")
    if geometry not in GEOMETRIES:
        raise ValueError(f"Kernel.geometry={geometry!r}: expected one of "
                         + " | ".join(repr(g) for g in GEOMETRIES))
    if augment not in ("draw", "epoch"):
        raise ValueError(f"Kernel.augment={augment!r}: expected 'draw' | 'epoch'")
    device_data = bool(trainer.get("device_data", False))
    epoch_scan = device_data and bool(trainer.get("epoch_scan", True))
    if epoch_scan and augment == "epoch" and bool(trainer.get("pipelined_scan", False)):
        raise ValueError("Kernel.augment=epoch and Trainer.pipelined_scan are mutually "
                         "exclusive (preaug already removes the per-step augmentation the "
                         "pipeline would overlap)")
    if geometry != "fused" and not device_data:
        _warn(f"Kernel.geometry={geometry!r} only applies to on-device augmentation "
              "(Trainer.device_data: true); the host data path ignores it.")
    if augment != "draw" and not epoch_scan:
        _warn(f"Kernel.augment={augment!r} only applies to the device-data epoch-scan path "
              "(Trainer.device_data: true, epoch_scan: true); other paths ignore it.")
    return backend, geometry, augment


class SemiTrainer:
    """'partial' mode: supervised-only on the labeled loader."""

    RUN_DIR = str(Path(PROJECT_PATH) / "runs")
    mode = "partial"

    def __init__(
        self,
        *,
        labeled_loader,
        unlabeled_loader,
        val_loader,
        test_loader,
        configuration: Dict[str, Any],
        save_dir: str = "base",
        max_epoch: int = 100,
        num_batches: int = 100,
        device: str = "cuda",
        crop_size: int = 224,
        run_dir: Optional[str] = None,
        step_timing: bool = False,
        **kwargs,
    ) -> None:
        _check_defaults(configuration)
        self._kernel_options = kernel_options(configuration)
        self._config = configuration
        self._device = resolve_device(device)
        self._labeled_loader = labeled_loader
        self._unlabeled_loader = unlabeled_loader
        self._val_loader = val_loader
        self._test_loader = test_loader
        self._max_epoch = int(max_epoch)
        self._num_batches = int(num_batches)
        self._crop_size = crop_size
        # step_timing: synchronize after every train step (on the epoch-scan
        # path, after every chunk: each of its steps gets the chunk's wall
        # time / its size) and keep the times (ms) in step_times_ms; off by
        # default, as it stalls the queue
        self._step_timing = bool(step_timing)
        self.step_times_ms: list = []
        self.epoch_times_s: list = []  # wall time of each epoch, eval and saving included
        self._save_dir = str(Path(run_dir or self.RUN_DIR) / save_dir)
        Path(self._save_dir).mkdir(parents=True, exist_ok=True)
        with open(Path(self._save_dir) / "config.yaml", "w") as f:
            yaml.safe_dump(configuration, f, default_flow_style=False, sort_keys=False)
        self._storage = Storage()
        self._start_epoch = 0
        self._cur_epoch = 0
        self._best_score = -1.0

    # --- init -----------------------------------------------------------
    def init(self) -> None:
        cfg = self._config
        seed = int(cfg.get("RandomSeed", 10))
        arch = cfg.get("Arch", {"input_dim": 1, "num_classes": 4})
        self._num_classes = int(arch.get("num_classes", 4))
        self._input_dim = int(arch.get("input_dim", 1))
        trainer_cfg = cfg.get("Trainer", {})
        self._feature_names = list(trainer_cfg.get("feature_names", []))
        importance = [float(x) for x in trainer_cfg.get(
            "feature_importance", [1.0] * len(self._feature_names))]
        total = sum(importance) or 1.0
        self._feature_importance = [x / total for x in importance]
        if len(self._feature_importance) != len(self._feature_names):
            raise ValueError("Trainer.feature_importance and feature_names differ in length")

        torch.manual_seed(seed)  # weights are a function of RandomSeed
        self._model = UNet(self._input_dim, self._num_classes).to(self._device)
        self._projector = None
        self._step_kwargs: Dict[str, Any] = {}
        self._build_components()
        params = self._model.parameters()
        if self._projector is not None:
            self._projector.to(self._device)
            params = chain(params, self._projector.parameters())
        self._optimizer = build_optimizer(params, cfg["Optim"])
        self._base_lr = float(cfg["Optim"].get("lr", 1e-3))
        scheduler = cfg.get("Scheduler") or {}
        self._sched_multiplier = float(scheduler.get("multiplier", 1.0)) if scheduler else None
        self._sched_warmup = int(scheduler.get("warmup_max", 0)) if scheduler else None

        # one generator on the model's device: flip masks and (device-data
        # path) augmentation draws, with no host round trip
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        backend, geometry, augment = self._kernel_options
        self._device_data = bool(trainer_cfg.get("device_data", False))
        self._epoch_scan = self._device_data and bool(trainer_cfg.get("epoch_scan", True))
        self._pipelined = self._epoch_scan and bool(trainer_cfg.get("pipelined_scan", False))
        self._preaug = self._epoch_scan and augment == "epoch"
        self._progress = bool(trainer_cfg.get("progress", True))
        self._live_metrics = bool(trainer_cfg.get("live_metrics", False))
        stores = None
        if self._device_data:
            self._setup_device_data(cfg, seed)
            stores = self._data_stores
        step_stores = None if (self._pipelined or self._preaug) else stores
        self._train_step = build_train_step(
            self._model, self._optimizer, self.mode,
            num_classes=self._num_classes,
            generator=self._generator,
            feature_names=self._feature_names,
            feature_importance=self._feature_importance,
            projector=self._projector,
            backend=backend,
            data_store=step_stores,
            crop=self._crop_size,
            geometry=geometry,
            **self._step_kwargs,
        )
        self._eval_step = build_eval_step(self._model, num_classes=self._num_classes)
        if self._device_data:
            self._eval_steps_dev = {
                "val": build_eval_step(self._model, num_classes=self._num_classes,
                                       data_store=self._val_store, crop=self._crop_size),
                "test": build_eval_step(self._model, num_classes=self._num_classes,
                                        data_store=self._test_store, crop=self._crop_size)}
        if self._epoch_scan:
            self._scan_chunk = max(int(trainer_cfg.get("scan_chunk", 100)), 1)
            self._epoch_chunks = self._chunk_sizes(self._num_batches, self._scan_chunk)
            aug_fn = (build_augment_fn(stores, crop=self._crop_size, geometry=geometry)
                      if self._pipelined else None)
            # host seeds of the pipelined loop's augmentation, one per chunk
            self._aug_seeds = np.random.default_rng(seed + 2)

            def make_epoch_fn(size: int):
                if self._preaug:
                    return build_epoch_scan_preaug(self._train_step, stores, size,
                                                   crop=self._crop_size, geometry=geometry,
                                                   generator=self._generator)
                if self._pipelined:
                    return build_epoch_scan_pipelined(aug_fn, self._train_step, size)
                return build_epoch_scan(self._train_step, size)

            self._epoch_fns = {size: make_epoch_fn(size) for size in set(self._epoch_chunks)}
            self._eval_scans = {
                "val": build_eval_scan(self._model, num_classes=self._num_classes,
                                       data_store=self._val_store, crop=self._crop_size),
                "test": build_eval_scan(self._model, num_classes=self._num_classes,
                                        data_store=self._test_store, crop=self._crop_size)}

    def _setup_device_data(self, cfg: Dict[str, Any], seed: int) -> None:
        """Stage the four datasets on the device (the labeled one as the
        packed uint16 plane) and build their index loaders."""
        dev = self._device
        lab_store = DeviceDataStore(self._labeled_loader.dataset, device=dev, pack=True)
        unlab_store = DeviceDataStore(self._unlabeled_loader.dataset, device=dev)
        self._data_stores = {"labeled": lab_store, "unlabeled": unlab_store}
        lab_bs = int((cfg.get("LabeledData") or {}).get("batch_size", 4))
        unlab_bs = int((cfg.get("UnlabeledData") or {}).get("batch_size", 10))
        self._labeled_index_loader = DeviceIndexLoader(lab_store, lab_bs, seed=seed)
        self._unlabeled_index_loader = DeviceIndexLoader(unlab_store, unlab_bs, seed=seed + 1)
        self._val_store = DeviceDataStore(self._val_loader.dataset, device=dev)
        self._test_store = DeviceDataStore(self._test_loader.dataset, device=dev)
        self._eval_index_loaders = {"val": DevicePatientEvalLoader(self._val_store),
                                    "test": DevicePatientEvalLoader(self._test_store)}

    @staticmethod
    def _chunk_sizes(total: int, chunk: int) -> list:
        sizes = [chunk] * (total // chunk)
        if total % chunk:
            sizes.append(total % chunk)
        return sizes

    def _build_components(self) -> None:
        """Mode-specific wiring; the base has no regularizer."""
        self._step_kwargs = dict(reg_weight=0.0)

    def _lr_for_epoch(self, epoch: int) -> float:
        if self._sched_multiplier is None:
            return self._base_lr
        return lr_at_epoch(epoch, self._base_lr, multiplier=self._sched_multiplier,
                           warmup_max=self._sched_warmup, max_epoch=self._max_epoch)

    # --- meters ---------------------------------------------------------
    def _configure_train_meters(self) -> MeterInterface:
        meters = MeterInterface()
        meters.register_meter("lr", AverageValueMeter())
        meters.register_meter("sup_loss", AverageValueMeter())
        meters.register_meter("reg_loss", AverageValueMeter())
        meters.register_meter(
            "sup_dice", UniversalDice(self._num_classes, list(range(1, self._num_classes))))
        if self.mode in ("uda", "udaiic"):
            meters.register_meter("uda", AverageValueMeter())
        if self.mode in ("iic", "udaiic"):
            meters.register_meter("mi", AverageValueMeter())
            meters.register_meter("individual_mis", MultipleAverageValueMeter())
        return meters

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type == "cuda":
            t = t.pin_memory()
        return t.to(self._device, non_blocking=True)

    # --- epoch loops ----------------------------------------------------
    def _run_epoch(self, epoch: int) -> Dict[str, Dict[str, float]]:
        meters = self._configure_train_meters()
        lr = self._lr_for_epoch(epoch)
        set_learning_rate(self._optimizer, lr)
        meters["lr"].add(lr)
        if self._epoch_scan:
            return self._run_epoch_scan(epoch, meters)
        if self._device_data:
            batches = ({"labeled_indices": self._to_device(lab["indices"]),
                        "unlabeled_indices": self._to_device(unlab["indices"]),
                        "group": lab["group"]}
                       for lab, unlab in zip(self._labeled_index_loader,
                                             self._unlabeled_index_loader))
        else:
            batches = ({"labeled_image": self._to_device(lab["image"]),
                        "labeled_target": self._to_device(lab["target"]),
                        "unlabeled_image": self._to_device(unlab["image"]),
                        "group": lab["group"]}
                       for lab, unlab in zip(self._labeled_loader, self._unlabeled_loader))
        pending = []
        progress_every = max(self._num_batches // 5, 1)
        for i in range(self._num_batches):
            batch = next(batches)
            groups = batch.pop("group")
            t0 = time.perf_counter()
            metrics = self._train_step(batch)
            if self._step_timing:
                if self._device.type == "cuda":
                    torch.cuda.synchronize(self._device)
                self.step_times_ms.append((time.perf_counter() - t0) * 1e3)
            pending.append((metrics, groups))
            if self._progress and self._device_data and (i + 1) % progress_every == 0:
                live = ""
                if self._live_metrics:  # opt-in: reads the newest step back
                    live = (f"  sup_loss={float(metrics['sup_loss']):.4f}"
                            f" reg_loss={float(metrics['reg_loss']):.4f}")
                print(f"\r[{self.mode}] epoch {epoch:03d}: {i + 1}/{self._num_batches} steps "
                      f"dispatched{live}", end="" if i + 1 < self._num_batches else "\n",
                      flush=True)

        for metrics, groups in pending:  # one device sync per epoch
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            if not np.isfinite(float(metrics["total_loss"])):
                raise RuntimeError(
                    f"non-finite loss at epoch {epoch}: {float(metrics['total_loss'])}")
            self._add_step_metrics(meters, metrics, groups)
        return meters.tracking_status()

    def _add_step_metrics(self, meters, metrics: Dict[str, np.ndarray], groups) -> None:
        meters["sup_loss"].add(float(metrics["sup_loss"]))
        meters["reg_loss"].add(float(metrics["reg_loss"]))
        meters["sup_dice"].add_stats(metrics["sup_dice_inter"], metrics["sup_dice_union"],
                                     group_name=groups)
        if "uda" in meters:
            meters["uda"].add(float(metrics["uda"]))
        if "mi" in meters:
            meters["mi"].add(float(metrics["mi"]))
            meters["individual_mis"].add(**{
                k.split("/", 1)[1]: float(v) for k, v in metrics.items()
                if k.startswith("individual_mis/")})

    @staticmethod
    def _readback(stacked: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        """Device tensors -> numpy with ONE device-to-host copy."""
        flat = torch.cat([v.reshape(-1).float() for v in stacked.values()]).cpu().numpy()
        out, at = {}, 0
        for k, v in stacked.items():
            out[k] = flat[at:at + v.numel()].reshape(tuple(v.shape))
            at += v.numel()
        return out

    def _run_epoch_scan(self, epoch: int, meters) -> Dict[str, Dict[str, float]]:
        """The epoch in chunks of <= scan_chunk steps: one index upload and
        one metrics readback per chunk, a progress line between chunks."""
        lab_it = iter(self._labeled_index_loader)
        unlab_it = iter(self._unlabeled_index_loader)
        lab_idx, unlab_idx, group_lists = [], [], []
        for _ in range(self._num_batches):
            lab, unlab = next(lab_it), next(unlab_it)
            lab_idx.append(lab["indices"])
            unlab_idx.append(unlab["indices"])
            group_lists.append(lab["group"])
        lab_all, unlab_all = np.stack(lab_idx), np.stack(unlab_idx)
        chunks, done = [], 0
        for size in self._epoch_chunks:
            if self._progress:
                print(f"\r[{self.mode}] epoch {epoch:03d}: scan {done}/{self._num_batches} "
                      "steps …", end="", flush=True)
            t0 = time.perf_counter()
            batches = {"labeled_indices": self._to_device(lab_all[done:done + size]),
                       "unlabeled_indices": self._to_device(unlab_all[done:done + size])}
            fn = self._epoch_fns[size]
            part = (fn(batches, int(self._aug_seeds.integers(1 << 62))) if self._pipelined
                    else fn(batches))
            chunks.append(self._readback(part))  # syncs
            if self._step_timing:
                self.step_times_ms.extend([(time.perf_counter() - t0) * 1e3 / size] * size)
            done += size
            if self._progress and self._live_metrics:  # free: the readback synced
                sl = np.mean(np.concatenate([c["sup_loss"] for c in chunks]))
                rl = np.mean(np.concatenate([c["reg_loss"] for c in chunks]))
                print(f"\r[{self.mode}] epoch {epoch:03d}: scan {done}/{self._num_batches}  "
                      f"sup_loss={sl:.4f} reg_loss={rl:.4f}", end="", flush=True)
        stacked = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        total = stacked["total_loss"]
        if not np.all(np.isfinite(total)):
            bad = int(np.argmax(~np.isfinite(total)))
            raise RuntimeError(f"non-finite loss at epoch {epoch} step {bad}")
        for i, groups in enumerate(group_lists):
            self._add_step_metrics(meters, {k: v[i] for k, v in stacked.items()}, groups)
        return meters.tracking_status()

    def _eval_meters(self) -> MeterInterface:
        meters = MeterInterface()
        meters.register_meter("loss", AverageValueMeter())
        meters.register_meter(
            "dice", UniversalDice(self._num_classes, list(range(1, self._num_classes))))
        return meters

    def _eval_epoch_scan(self, which: str):
        meters = self._eval_meters()
        batches = list(self._eval_index_loaders[which])
        out = self._readback(self._eval_scans[which](
            self._to_device(np.stack([b["indices"] for b in batches])),
            self._to_device(np.stack([b["mask"] for b in batches]))))
        for i, b in enumerate(batches):
            meters["loss"].add(float(out["loss"][i]))
            meters["dice"].add_stats(out["inter"][i:i + 1], out["union"][i:i + 1],
                                     group_name=b["group"])
        report = meters.tracking_status()
        return report, report["dice"]["DSC_mean"]

    def _eval_epoch(self, loader) -> Tuple[Dict[str, Dict[str, float]], float]:
        which = "val" if loader is self._val_loader else "test"
        if self._epoch_scan:
            return self._eval_epoch_scan(which)
        meters = self._eval_meters()
        pending = []
        if self._device_data:
            for batch in self._eval_index_loaders[which]:
                out = self._eval_steps_dev[which](self._to_device(batch["indices"]),
                                                  self._to_device(batch["mask"]))
                pending.append((out, batch["group"]))
        else:
            for batch in loader:
                out = self._eval_step(self._to_device(batch["image"]),
                                      self._to_device(batch["target"]),
                                      self._to_device(batch["mask"]))
                pending.append((out, batch["group"]))
        for out, group in pending:
            meters["loss"].add(float(out["loss"]))
            meters["dice"].add_stats(out["inter"].cpu().numpy(), out["union"].cpu().numpy(),
                                     group_name=group)
        report = meters.tracking_status()
        return report, report["dice"]["DSC_mean"]

    # --- training loop --------------------------------------------------
    def start_training(self) -> float:
        with SummaryWriter(self._save_dir) as writer:
            for self._cur_epoch in range(self._start_epoch, self._max_epoch):
                t0 = time.perf_counter()
                train_result = self._run_epoch(self._cur_epoch)
                val_result, cur_score = self._eval_epoch(self._val_loader)
                test_result, _ = self._eval_epoch(self._test_loader)
                income = StorageIncomeDict(tra=train_result, val=val_result, test=test_result)
                self._storage.put_from_dict(income, self._cur_epoch)
                writer.add_scalars_from_income_dict(income, self._cur_epoch)
                self.save(cur_score)
                self._storage.to_csv(self._save_dir)
                self.epoch_times_s.append(time.perf_counter() - t0)
                print(f"\r[{self.mode}] epoch {self._cur_epoch:03d} "
                      f"({self.epoch_times_s[-1]:.1f}s): "
                      f"sup_loss={train_result['sup_loss']['mean']:.4f} "
                      f"reg_loss={train_result['reg_loss']['mean']:.4f} "
                      f"val_DSC={cur_score:.4f} best={self._best_score:.4f} "
                      f"lr={train_result['lr']['mean']:.2e}", flush=True)
        return self._best_score

    # --- checkpointing --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        return {
            "model": self._model.state_dict(),
            "projector": None if self._projector is None else self._projector.state_dict(),
            "optimizer": self._optimizer.state_dict(),
            "meta": {"cur_epoch": self._cur_epoch, "best_score": self._best_score,
                     "storage": self._storage.state_dict(), "mode": self.mode},
        }

    def save(self, cur_score: float) -> None:
        is_best = cur_score > self._best_score
        if is_best:
            self._best_score = float(cur_score)
        state = self.state_dict()
        torch.save(state, Path(self._save_dir) / LAST_NAME)
        if is_best:
            torch.save(state, Path(self._save_dir) / BEST_NAME)


class UDATrainer(SemiTrainer):
    mode = "uda"

    def _build_components(self) -> None:
        cfg = self._config["UDARegCriterion"]
        self._step_kwargs = dict(uda_criterion=cfg["name"], reg_weight=float(cfg["weight"]))


def _make_projector(config: Dict[str, Any], feature_names) -> ProjectorWrapper:
    enc, dec = config["EncoderParams"], config["DecoderParams"]

    def per_position(key, default):
        return [(enc if name in ENCODER_NAMES else dec).get(key, default)
                for name in feature_names]

    return ProjectorWrapper(
        feature_names=tuple(feature_names),
        num_clusters=per_position("num_clusters", 10),
        num_subheads=per_position("num_subheads", 5),
        head_types=per_position("head_types", "linear"),
        normalize=per_position("normalize", False),
    )


class IICTrainer(SemiTrainer):
    mode = "iic"

    def _build_components(self) -> None:
        cfg = self._config["IICRegParameters"]
        loss_cfg = cfg.get("LossParams", {})
        self._projector = _make_projector(cfg, self._feature_names)
        self._step_kwargs = dict(
            reg_weight=float(cfg["weight"]),
            paddings=loss_cfg.get("paddings", 1),
            patch_sizes=loss_cfg.get("patch_sizes", 1024),
        )


class UDAIICTrainer(IICTrainer):
    mode = "udaiic"

    def _build_components(self) -> None:
        super()._build_components()
        iic_weight = self._step_kwargs.pop("reg_weight")
        uda_cfg = self._config["UDARegCriterion"]
        self._step_kwargs.update(
            uda_criterion=uda_cfg["name"],
            uda_weight=float(uda_cfg["weight"]),
            iic_weight=iic_weight,
            reg_weight=1.0,
        )


trainer_zoos = {
    "partial": SemiTrainer,
    "uda": UDATrainer,
    "iic": IICTrainer,
    "udaiic": UDAIICTrainer,
}
