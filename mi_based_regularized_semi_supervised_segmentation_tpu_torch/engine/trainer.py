"""Trainers: init -> (resume) -> epoch loop -> val/test eval -> checkpoints
-> (inference), for the partial / uda / iic / udaiic / entropy / meanteacher
modes (counterpart of the JAX package's ``engine/trainer.py``).

Per epoch: set the epoch's learning rate, run ``num_batches`` train steps,
read the metrics back, evaluate the val and test patients (volume dice),
append to ``storage.csv`` and the event log, and save ``last.pth`` (and
``best.pth`` when val DSC improves; ``engine/checkpoints.py``). A resume
(``load_state_dict_from_path``) restores the model, projector, optimizer
state (the configured ``Optim.name``'s), step counter, step generator, mean
teacher, best score, ``Storage`` and epoch; the data samplers start afresh,
as in the JAX package. ``inference``
evaluates ``best.pth`` on the test patients with dice and Hausdorff and
writes PNG dumps.

Two data paths:
- host loader (default): PNG decode and augmentation in the native host
  library (``data/native.py``; numpy where it is missing) in loader threads,
  run one to three batches ahead of the step on a background thread
  (``parallel/mesh.py:prefetch_to_device``), one batch upload per step, one
  metrics readback per epoch;
- ``Trainer.device_data: true``: the datasets are staged on the card once
  (``data/device_pipeline.py``), each step takes slice indices and augments
  on the card (``Kernel.geometry``). With ``Trainer.epoch_scan`` (default)
  the epoch runs in chunks of at most ``scan_chunk`` steps, each given its
  indices in one upload and read back once; without it the index loaders
  go through the same prefetch as the host loaders.
On either path ``Trainer.profile`` (true, or an epoch number) writes a
``torch.profiler`` trace of that epoch's first steps under
``<save_dir>/profile`` (``EpochTrace``).

On a card the step (host path, per-step device path) and each scan chunk
(``epoch_scan``, ``Kernel.augment=epoch``, ``pipelined_scan``) run as CUDA
graphs (``engine/graphs.py``), as the JAX trainer runs its jitted step and
scan; so do the eval steps (one graph for each padded patient length, all
of the trainer's eval graphs in one memory pool) and the eval scans (one a
split). ``graph_unmet`` picks, before the first step, the configurations
that stay eager, and the trainer prints the reason.

Data parallelism (``context``, a ``parallel.DistContext``; ``main.py`` makes
it from the launcher): one process per device, each running the same
loaders with the same seeds. Each sub-batch is rounded up to a multiple of
the data world with pad rows that repeat the last real one (pad-and-mask,
``engine/steps.py``); the host path keeps the rank's rows of each batch,
the device-data path hands the step the global indices (each rank stages
the whole store) and the step keeps its rows. Eval batches are padded to a
multiple of the data world and split the same way. Every rank computes the
same global metrics; only rank 0 writes ``config.yaml``, ``storage.csv``,
the event log, checkpoints (then a barrier), traces, PNG dumps and
progress lines. Every rank loads the same checkpoint.
"""

from __future__ import annotations

import copy
import json
import time
from contextlib import closing
from itertools import chain
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import yaml

from .. import PROJECT_PATH
from ..data.device_pipeline import DeviceDataStore, DeviceIndexLoader, DevicePatientEvalLoader
from ..models import ProjectorWrapper, UNet
from ..models.unet import ENCODER_NAMES
from ..ops.augment_device import GEOMETRIES
from ..ops import mi_fused
from ..ops.iic_local import BACKENDS as IIC_LOCAL_BACKENDS
from ..parallel import (
    DistContext,
    PinnedRing,
    gather_rows,
    local_rows,
    prefetch_to_device,
    replicate_state,
    single_context,
)
from ..utils import (
    AverageValueMeter,
    ExceptionIgnorer,
    MeterInterface,
    MultipleAverageValueMeter,
    Storage,
    StorageIncomeDict,
    SummaryWriter,
    SurfaceMeter,
    UniversalDice,
)
from ..utils.imageio import write_img_target, write_predict
from .checkpoints import (
    BEST_NAME,
    LAST_NAME,
    lenient_load_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from .optim import (
    LOOKAHEAD_NAMES,
    OPTIMIZERS,
    build_optimizer,
    init_optimizer_state,
    load_optimizer_state,
    lr_at_epoch,
    optimizer_state_dict,
    set_learning_rate,
)
from .steps import (
    build_augment_fn,
    build_epoch_scan,
    build_epoch_scan_pipelined,
    build_epoch_scan_preaug,
    build_eval_scan,
    build_eval_step,
    build_train_step,
    capture_unmet,
    UDA_CRITERIA,
)

INFERENCE_NAME = "inference.json"
# the joint's backends (ops/iic_local.py) and the fused path
BACKENDS = IIC_LOCAL_BACKENDS + ("pallas_fused",)


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


# the JAX package's Parallel section
PARALLEL_KEYS = ("data_axis", "num_devices", "space_size", "multihost", "coordinator_address",
                 "num_processes", "process_id")
LAUNCH = ("torchrun --nproc_per_node={n} -m "
          "mi_based_regularized_semi_supervised_segmentation_tpu_torch.{entry} ...")


def check_parallel(cfg: Dict[str, Any], world: int = 1, entry: str = "main") -> None:
    """The ``Parallel`` section against the launcher's ``world`` size (one
    process per device): ``ValueError`` for an unknown key, a
    ``num_devices`` other than null or the world size (naming both and the
    ``torchrun`` line of the ``entry`` module), a ``space_size`` that does
    not divide the world, or ``multihost`` without its coordinator, process
    count and id. ``data_axis`` names the data axis (any string);
    ``coordinator_address``, ``num_processes`` and ``process_id`` are read
    under ``multihost`` only, as the JAX package reads them. ``main.py``,
    ``pretrain_main.py`` and the trainers call it."""
    section = cfg.get("Parallel") or {}
    for key in section:
        if key not in PARALLEL_KEYS:
            raise ValueError(f"Parallel.{key}: expected one of {sorted(PARALLEL_KEYS)}")
    n = section.get("num_devices")
    if n is not None and int(n) != world:
        raise ValueError(
            f"Parallel.num_devices={n} but the world size is {world}: the port runs one "
            f"process per device; launch {LAUNCH.format(n=n, entry=entry)} (or set "
            "Parallel.num_devices=null to take the world size)")
    space = int(section.get("space_size", 1) or 1)
    if space < 1 or world % space:
        raise ValueError(f"Parallel.space_size={space} does not divide the world size {world}")
    if section.get("multihost"):
        missing = [k for k in ("coordinator_address", "num_processes", "process_id")
                   if section.get(k) is None]
        if missing:
            raise ValueError("Parallel.multihost=true needs Parallel."
                             + ", Parallel.".join(missing))


def check_optimizer(cfg: Dict[str, Any]) -> None:
    """``Optim.name`` must be one of the optimizer names (``KeyError``, as
    ``build_optimizer`` raises) and not ``Lookahead`` / ``Ranger``
    (``ValueError``): optax's lookahead needs ``LookaheadParams``, so the JAX
    trainers cannot step them either. ``main.py`` and the trainers call it
    before any data is staged."""
    name = (cfg.get("Optim") or {}).get("name", "Adam")
    if name not in OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; available: {sorted(OPTIMIZERS)}")
    if name in LOOKAHEAD_NAMES:
        raise ValueError(f"Optim.name={name!r}: the trainers step a flat parameter tree, and "
                         "optax's lookahead needs LookaheadParams (the JAX trainers cannot "
                         "step it either); build it with engine.optim.build_optimizer")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def precision_dtypes(cfg: Dict[str, Any]) -> Tuple[torch.dtype, torch.dtype]:
    """(compute dtype, BN dtype) of the ``Precision`` section; parameters,
    optimizer state and checkpoints stay fp32 whatever they are. An unknown
    name raises ``ValueError`` (the JAX package: ``KeyError``)."""
    precision = cfg.get("Precision") or {}
    out = []
    for key in ("compute_dtype", "bn_dtype"):
        name = precision.get(key, "float32")
        if name not in DTYPES:
            raise ValueError(f"Precision.{key}={name!r}: expected "
                             + " | ".join(repr(d) for d in DTYPES))
        out.append(DTYPES[name])
    return out[0], out[1]


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
    if backend not in BACKENDS:
        raise ValueError(f"Kernel.backend={backend!r}: expected one of "
                         + " | ".join(repr(b) for b in BACKENDS))
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


def to_device(arr, device: torch.device) -> torch.Tensor:
    """A host array or tensor on ``device``, through pinned memory to a card;
    a tensor already there (``prefetch_to_device`` puts its batches on the
    card) as it is."""
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda" and t.device.type == "cpu" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def pad_rows(arr: np.ndarray, target: int, repeat: bool = True) -> np.ndarray:
    """``arr`` with rows appended up to ``target``: copies of its last row
    (pad-and-mask: the step masks them out of every statistic), or zeros
    with ``repeat`` off (eval: the mask row of a pad is False)."""
    n = arr.shape[0]
    if n >= target:
        return arr
    fill = np.repeat(arr[-1:], target - n, axis=0) if repeat else np.zeros(
        (target - n,) + arr.shape[1:], arr.dtype)
    return np.concatenate([arr, fill])


def eval_rows(batch: Dict[str, Any], context: DistContext,
              device: torch.device) -> Tuple[torch.Tensor, ...]:
    """A host eval batch's image, target and mask: the rank's rows, on
    ``device`` (padded to a multiple of the data world first when the loader
    did not; a pad row's mask is False)."""
    arrays = {k: batch[k] for k in ("image", "target", "mask")}
    padded = -(-len(arrays["mask"]) // context.data_world) * context.data_world
    arrays = {k: pad_rows(v, padded, repeat=False) for k, v in arrays.items()}
    return tuple(to_device(v, device) for v in local_rows(arrays, context).values())


def eval_pad_multiple(data_world: int) -> int:
    """The multiple each patient's eval batch is padded to: the data world
    (8, the loaders' default, for one process)."""
    return data_world if data_world > 1 else 8


class _NullWriter:
    """The event log of a rank other than 0: writes nothing."""

    def add_scalars_from_income_dict(self, *args) -> None:
        pass

    def __enter__(self) -> "_NullWriter":
        return self

    def __exit__(self, *exc) -> bool:
        return False


PROFILE_STEPS = 11  # Trainer.profile traces an epoch's steps 0..10, as the JAX trainer


class EpochTrace:
    """``Trainer.profile``: true (every epoch) or an epoch number. When it
    selects ``epoch``, a ``torch.profiler`` trace (host activity, and the
    card's on cuda) runs from the epoch's first step until ``steps_done``
    reports ``steps`` steps (or the block ends), then is written as a Chrome
    trace to ``<save_dir>/profile/epoch_<epoch>.json``; a trace that cannot
    be written raises. Otherwise it does nothing."""

    def __init__(self, setting, epoch: int, save_dir: str, device: torch.device,
                 steps: int) -> None:
        self.path = Path(save_dir) / "profile" / f"epoch_{epoch:03d}.json"
        self._device, self._steps, self._prof = device, steps, None
        on = setting if isinstance(setting, bool) else (
            setting is not None and int(setting) == epoch)
        if on:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def steps_done(self, n: int) -> None:
        if self._prof is not None and n >= self._steps:
            self._write()

    def _write(self) -> None:
        prof, self._prof = self._prof, None
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        prof.stop()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(self.path))
        if not self.path.is_file() or self.path.stat().st_size == 0:
            raise RuntimeError(f"Trainer.profile: no trace written to {self.path}")

    def __enter__(self) -> "EpochTrace":
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if self._prof is not None:
            if exc_type is None:
                self._write()
            else:
                self._prof.stop()
        return False


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
        profile=None,
        context: Optional[DistContext] = None,
        **kwargs,
    ) -> None:
        ctx = context or single_context(device)
        check_parallel(configuration, ctx.world)
        check_optimizer(configuration)
        self._dtypes = precision_dtypes(configuration)
        self._kernel_options = kernel_options(configuration)
        self._config = configuration
        self._device = resolve_device(device)
        if ctx.world > 1 and ctx.device.type == self._device.type:
            self._device = ctx.device  # the rank's card
        # the pinned buffers the epochs' batches take to the card, made once
        self._ring = PinnedRing(self._device) if self._device.type == "cuda" else None
        self._ctx = ctx
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
        # default, as it stalls the queue. On the per-step path it also keeps
        # step_walls_ms: from the previous step's end (the epoch's first: the
        # loop's start) to this step's end, the batch's fetch and upload included
        self._step_timing = bool(step_timing)
        self._profile = profile if ctx.is_main else None  # Trainer.profile (EpochTrace)
        self.step_times_ms: list = []
        self.step_walls_ms: list = []
        self.epoch_times_s: list = []  # wall time of each epoch, eval and saving included
        self._save_dir = str(Path(run_dir or self.RUN_DIR) / save_dir)
        Path(self._save_dir).mkdir(parents=True, exist_ok=True)
        if ctx.is_main:
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

        self._device_data = bool(trainer_cfg.get("device_data", False))
        self._batch_sizes(cfg)
        torch.manual_seed(seed)  # weights are a function of RandomSeed
        dtype, bn_dtype = self._dtypes
        self._model = UNet(self._input_dim, self._num_classes, dtype=dtype, bn_dtype=bn_dtype,
                           stem=str(arch.get("stem", "conv")),
                           remat=bool(arch.get("remat", False))).to(self._device)
        self._projector = None
        self._step_kwargs: Dict[str, Any] = {}
        self._with_ema = False
        self._build_components()
        # the mean teacher: the model's copy at init, BN buffers included
        self._teacher = copy.deepcopy(self._model).requires_grad_(False) if self._with_ema else None
        # decided before the optimizer, which is built for a graph only where one is captured
        eager = graph_unmet(cfg, self._device, self._ctx)
        if eager and self._ctx.is_main:
            print(f"[trainer] the step runs eagerly: {eager}", flush=True)
        jit = eager is None
        # the eval programs have no optimizer: off a card and under a group they stay eager
        eval_jit = capture_unmet(self._device, None, self._ctx) is None
        eval_pool = torch.cuda.graph_pool_handle() if eval_jit else None
        params = self._model.parameters()
        if self._projector is not None:
            self._projector.to(self._device)
            params = chain(params, self._projector.parameters())
        self._optimizer = build_optimizer(params, cfg["Optim"], graph=jit)
        init_optimizer_state(self._optimizer)  # so a checkpoint holds every entry from init
        replicate_state([self._model, self._projector, self._teacher], self._optimizer, self._ctx)
        self._step_counter = torch.zeros((), dtype=torch.int64)  # global step
        # its copy on the card, which the mean teacher's EMA schedule reads and its step advances
        self._ema_count = (torch.zeros((), dtype=torch.int64, device=self._device)
                           if self._teacher is not None else None)
        self._base_lr = float(cfg["Optim"].get("lr", 1e-3))
        scheduler = cfg.get("Scheduler") or {}
        self._sched_multiplier = float(scheduler.get("multiplier", 1.0)) if scheduler else None
        self._sched_warmup = int(scheduler.get("warmup_max", 0)) if scheduler else None

        # one generator on the model's device: flip masks and (device-data
        # path) augmentation draws, with no host round trip
        self._generator = torch.Generator(device=self._device)
        self._generator.manual_seed(seed)
        backend, geometry, augment = self._kernel_options
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
            # pallas_fused is selected on the projector (local_emit_logits);
            # a decoder tap that gets probabilities takes the joint kernel,
            # as the JAX trainer's unfused tier takes pallas
            backend="pallas" if backend == "pallas_fused" else backend,
            data_store=step_stores,
            crop=self._crop_size,
            geometry=geometry,
            teacher=self._teacher,
            step_counter=self._step_counter,
            ema_count=self._ema_count,
            n_labeled_valid=self._lab_bs if self._batch_padded else None,
            n_unlabeled_valid=self._unlab_bs if self._batch_padded else None,
            context=self._ctx,
            jit=jit and not self._epoch_scan,  # a scan captures its own body
            **self._step_kwargs,
        )
        ctx = self._ctx
        evals = dict(num_classes=self._num_classes, context=ctx, jit=eval_jit, pool=eval_pool)
        self._eval_step = build_eval_step(self._model, **evals)
        if self._device_data:
            self._eval_steps_dev = {
                "val": build_eval_step(self._model, data_store=self._val_store,
                                       crop=self._crop_size, **evals),
                "test": build_eval_step(self._model, data_store=self._test_store,
                                        crop=self._crop_size, **evals)}
        if self._epoch_scan:
            self._scan_chunk = max(int(trainer_cfg.get("scan_chunk", 100)), 1)
            self._epoch_chunks = self._chunk_sizes(self._num_batches, self._scan_chunk)
            aug_fn = (build_augment_fn(stores, crop=self._crop_size, geometry=geometry,
                                       context=ctx) if self._pipelined else None)
            # host seeds of the pipelined loop's augmentation, one per chunk
            self._aug_seeds = np.random.default_rng(seed + 2)

            # one function (with jit on a card one captured body) for every
            # chunk, the shorter last one too
            size = max(self._epoch_chunks)
            if self._preaug:
                self._epoch_fn = build_epoch_scan_preaug(
                    self._train_step, stores, size, crop=self._crop_size, geometry=geometry,
                    generator=self._generator, context=ctx, jit=jit)
            elif self._pipelined:
                self._epoch_fn = build_epoch_scan_pipelined(aug_fn, self._train_step, size,
                                                            jit=jit)
            else:
                self._epoch_fn = build_epoch_scan(self._train_step, size, jit=jit)
            self._eval_scans = {
                "val": build_eval_scan(self._model, data_store=self._val_store,
                                       crop=self._crop_size, **evals),
                "test": build_eval_scan(self._model, data_store=self._test_store,
                                        crop=self._crop_size, **evals)}

    def _batch_sizes(self, cfg: Dict[str, Any]) -> None:
        """The global sub-batch sizes (the host loaders' own, else the
        config's; the index loaders are built from the config's), each
        rounded up to a multiple of the data world (pad-and-mask)."""
        sizes = []
        for section, loader, default in (("LabeledData", self._labeled_loader, 4),
                                         ("UnlabeledData", self._unlabeled_loader, 10)):
            size = int((cfg.get(section) or {}).get("batch_size", default))
            if not self._device_data:
                size = int(getattr(loader, "batch_size", size))
            sizes.append(size)
        dw = self._ctx.data_world
        self._lab_bs, self._unlab_bs = sizes
        self._lab_bs_padded, self._unlab_bs_padded = (-(-b // dw) * dw for b in sizes)
        self._batch_padded = (self._lab_bs_padded, self._unlab_bs_padded) != tuple(sizes)

    def _setup_device_data(self, cfg: Dict[str, Any], seed: int) -> None:
        """Stage the four datasets on the device (the labeled one as the
        packed uint16 plane; each rank stages them whole) and build their
        index loaders."""
        dev = self._device
        lab_store = DeviceDataStore(self._labeled_loader.dataset, device=dev, pack=True)
        unlab_store = DeviceDataStore(self._unlabeled_loader.dataset, device=dev)
        self._data_stores = {"labeled": lab_store, "unlabeled": unlab_store}
        self._labeled_index_loader = DeviceIndexLoader(lab_store, self._lab_bs, seed=seed)
        self._unlabeled_index_loader = DeviceIndexLoader(unlab_store, self._unlab_bs,
                                                         seed=seed + 1)
        self._val_store = DeviceDataStore(self._val_loader.dataset, device=dev)
        self._test_store = DeviceDataStore(self._test_loader.dataset, device=dev)
        multiple = eval_pad_multiple(self._ctx.data_world)
        self._eval_index_loaders = {
            "val": DevicePatientEvalLoader(self._val_store, pad_multiple=multiple),
            "test": DevicePatientEvalLoader(self._test_store, pad_multiple=multiple)}

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
        if self.mode in ("uda", "udaiic", "meanteacher"):
            meters.register_meter("uda", AverageValueMeter())
        if self.mode == "entropy":
            meters.register_meter("entropy", AverageValueMeter())
        if self.mode in ("iic", "udaiic"):
            meters.register_meter("mi", AverageValueMeter())
            meters.register_meter("individual_mis", MultipleAverageValueMeter())
        return meters

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return to_device(arr, self._device)

    # --- epoch loops ----------------------------------------------------
    def _run_epoch(self, epoch: int) -> Dict[str, Dict[str, float]]:
        meters = self._configure_train_meters()
        lr = self._lr_for_epoch(epoch)
        set_learning_rate(self._optimizer, lr)
        meters["lr"].add(lr)
        if self._epoch_scan:
            return self._run_epoch_scan(epoch, meters)
        lab_p, unlab_p = self._lab_bs_padded, self._unlab_bs_padded
        if self._device_data:  # the global indices: the step keeps the rank's rows
            host_batches = ({"labeled_indices": pad_rows(lab["indices"], lab_p),
                             "unlabeled_indices": pad_rows(unlab["indices"], unlab_p),
                             "group": lab["group"]}
                            for lab, unlab in zip(self._labeled_index_loader,
                                                  self._unlabeled_index_loader))
            rows_of = None
        else:
            host_batches = ({"labeled_image": pad_rows(lab["image"], lab_p),
                             "labeled_target": pad_rows(lab["target"], lab_p),
                             "unlabeled_image": pad_rows(unlab["image"], unlab_p),
                             "group": lab["group"]}
                            for lab, unlab in zip(self._labeled_loader, self._unlabeled_loader))
            rows_of = self._ctx
        pending = []
        progress_every = max(self._num_batches // 5, 1)
        progress = self._progress and self._device_data and self._ctx.is_main
        # the loaders run on a background thread, as the JAX package's epoch
        # does, and are left N + 3 batches on for the epoch's N steps
        with closing(prefetch_to_device(host_batches, self._device, rows_of,
                                        ring=self._ring)) as batches, \
                self._trace(epoch) as trace:
            t_end = time.perf_counter()
            for i in range(self._num_batches):
                batch = next(batches)
                groups = batch.pop("group")
                batch = {k: self._to_device(v) for k, v in batch.items()}
                t0 = time.perf_counter()
                metrics = self._train_step(batch)
                if self._step_timing:
                    if self._device.type == "cuda":
                        torch.cuda.synchronize(self._device)
                    t_prev, t_end = t_end, time.perf_counter()
                    self.step_times_ms.append((t_end - t0) * 1e3)
                    self.step_walls_ms.append((t_end - t_prev) * 1e3)
                pending.append((metrics, groups))
                trace.steps_done(i + 1)
                if progress and (i + 1) % progress_every == 0:
                    live = ""
                    if self._live_metrics:  # opt-in: reads the newest step back
                        live = (f"  sup_loss={float(metrics['sup_loss']):.4f}"
                                f" reg_loss={float(metrics['reg_loss']):.4f}")
                    print(f"\r[{self.mode}] epoch {epoch:03d}: {i + 1}/{self._num_batches} "
                          f"steps dispatched{live}",
                          end="" if i + 1 < self._num_batches else "\n", flush=True)

        for metrics, groups in pending:  # one device sync per epoch
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            if not np.isfinite(float(metrics["total_loss"])):
                raise RuntimeError(
                    f"non-finite loss at epoch {epoch}: {float(metrics['total_loss'])}")
            self._add_step_metrics(meters, metrics, groups)
        return meters.tracking_status()

    def _trace(self, epoch: int) -> EpochTrace:
        return EpochTrace(self._profile, epoch, self._save_dir, self._device,
                          min(PROFILE_STEPS, self._num_batches))

    def _add_step_metrics(self, meters, metrics: Dict[str, np.ndarray], groups) -> None:
        meters["sup_loss"].add(float(metrics["sup_loss"]))
        meters["reg_loss"].add(float(metrics["reg_loss"]))
        n = len(groups)  # the real rows; pad rows' sums are 0
        meters["sup_dice"].add_stats(metrics["sup_dice_inter"][:n], metrics["sup_dice_union"][:n],
                                     group_name=groups)
        if "uda" in meters:
            meters["uda"].add(float(metrics["uda"]))
        if "entropy" in meters:
            meters["entropy"].add(float(metrics["entropy"]))
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
        lab_all = np.stack([pad_rows(i, self._lab_bs_padded) for i in lab_idx])
        unlab_all = np.stack([pad_rows(i, self._unlab_bs_padded) for i in unlab_idx])
        chunks, done = [], 0
        progress = self._progress and self._ctx.is_main
        with self._trace(epoch) as trace:  # whole chunks: up to the one with step 10
            for size in self._epoch_chunks:
                if progress:
                    print(f"\r[{self.mode}] epoch {epoch:03d}: scan {done}/{self._num_batches} "
                          "steps …", end="", flush=True)
                t0 = time.perf_counter()
                batches = {"labeled_indices": self._to_device(lab_all[done:done + size]),
                           "unlabeled_indices": self._to_device(unlab_all[done:done + size])}
                fn = self._epoch_fn  # the chunk's steps, with any n up to scan_chunk
                part = (fn(batches, int(self._aug_seeds.integers(1 << 62))) if self._pipelined
                        else fn(batches))
                chunks.append(self._readback(part))  # syncs
                if self._step_timing:
                    self.step_times_ms.extend([(time.perf_counter() - t0) * 1e3 / size] * size)
                done += size
                trace.steps_done(done)
                if progress and self._live_metrics:  # free: the readback synced
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
                out = self._eval_step(*eval_rows(batch, self._ctx, self._device))
                pending.append((out, batch["group"]))
        for out, group in pending:
            meters["loss"].add(float(out["loss"]))
            meters["dice"].add_stats(out["inter"].cpu().numpy(), out["union"].cpu().numpy(),
                                     group_name=group)
        report = meters.tracking_status()
        return report, report["dice"]["DSC_mean"]

    # --- training loop --------------------------------------------------
    def start_training(self) -> float:
        main = self._ctx.is_main
        with (SummaryWriter(self._save_dir) if main else _NullWriter()) as writer:
            for self._cur_epoch in range(self._start_epoch, self._max_epoch):
                t0 = time.perf_counter()
                train_result = self._run_epoch(self._cur_epoch)
                val_result, cur_score = self._eval_epoch(self._val_loader)
                test_result, _ = self._eval_epoch(self._test_loader)
                income = StorageIncomeDict(tra=train_result, val=val_result, test=test_result)
                self._storage.put_from_dict(income, self._cur_epoch)
                writer.add_scalars_from_income_dict(income, self._cur_epoch)
                self.save(cur_score)
                if main:
                    self._storage.to_csv(self._save_dir)
                self.epoch_times_s.append(time.perf_counter() - t0)
                if not main:
                    continue
                print(f"\r[{self.mode}] epoch {self._cur_epoch:03d} "
                      f"({self.epoch_times_s[-1]:.1f}s): "
                      f"sup_loss={train_result['sup_loss']['mean']:.4f} "
                      f"reg_loss={train_result['reg_loss']['mean']:.4f} "
                      f"val_DSC={cur_score:.4f} best={self._best_score:.4f} "
                      f"lr={train_result['lr']['mean']:.2e}", flush=True)
        return self._best_score

    # --- checkpointing --------------------------------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The tensors a resume restores (the JAX package's ``TrainState``):
        model (BN statistics included), projector, optimizer state, the global
        step, the step generator's state and the mean teacher."""
        return {
            "model": self._model.state_dict(),
            "projector": None if self._projector is None else self._projector.state_dict(),
            "optimizer": optimizer_state_dict(self._optimizer),
            "step": self._step_counter,
            "generator": self._generator.get_state(),
            "teacher": None if self._teacher is None else self._teacher.state_dict(),
        }

    def _meta(self) -> Dict[str, Any]:
        return {"cur_epoch": self._cur_epoch, "best_score": self._best_score,
                "storage": self._storage.state_dict(), "mode": self.mode}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Copies ``state`` (as ``state_dict`` returns it) into the trainer's
        modules, optimizer, step counter (and its card copy) and generator,
        each tensor in place, where a captured graph reads it."""
        self._model.load_state_dict(state["model"])
        if self._projector is not None:
            self._projector.load_state_dict(state["projector"])
        if self._teacher is not None:
            self._teacher.load_state_dict(state["teacher"])
        load_optimizer_state(self._optimizer, state["optimizer"])
        self._step_counter.copy_(state["step"])
        if self._ema_count is not None:
            self._ema_count.copy_(state["step"])
        self._generator.set_state(state["generator"])

    def save(self, cur_score: float) -> None:
        is_best = cur_score > self._best_score
        if is_best:
            self._best_score = float(cur_score)
        if self._ctx.is_main:  # every rank holds the same state
            state, meta = self.state_dict(), self._meta()
            save_checkpoint(Path(self._save_dir) / LAST_NAME, state, meta)
            if is_best:
                save_checkpoint(Path(self._save_dir) / BEST_NAME, state, meta)
        self._ctx.barrier()  # no rank reads a checkpoint before it is whole

    def load_state_dict_from_path(self, path: str, strict: bool = True) -> None:
        """Resume from ``path`` (a checkpoint, or a run directory: its
        ``last.pth``). ``strict=False`` takes each entry whose name and shape
        match and keeps the others at their initial values (warning with
        their count); ``strict`` raises on any mismatch. The next epoch is
        the checkpoint's + 1."""
        template = self.state_dict()
        if strict:
            state, meta = load_checkpoint(path, template, LAST_NAME)
        else:
            state, meta, kept = lenient_load_checkpoint(path, template, LAST_NAME)
            if kept:
                _warn(f"lenient load of {path}: {kept} entries missing from the checkpoint or "
                      "of another shape keep their initial values")
        self.load_state_dict(state)
        self._best_score = float(meta.get("best_score", -1.0))
        self._cur_epoch = int(meta.get("cur_epoch", 0))
        self._start_epoch = self._cur_epoch + 1
        if "storage" in meta:
            self._storage.load_state_dict(meta["storage"])

    # --- inference ------------------------------------------------------
    def inference(self, checkpoint: Optional[str] = None) -> Tuple[Dict[str, Any], float]:
        """Strict load of ``best.pth`` (``checkpoint``: a file or a run
        directory; default: this run's), then the test patients with loss,
        dice and Hausdorff meters, PNG dumps of image, ground truth and
        prediction under ``img/``, ``gt/`` and ``pred/``, and the report in
        ``inference.json``. On ``Trainer.device_data`` the forward runs from
        the device store; the host test loader supplies the pixels and names
        for the dumps and the Hausdorff targets, and the predictions are
        realigned to its slices by filename. Under a context every rank
        evaluates its rows and holds the gathered predictions; rank 0 writes
        the dumps and the report."""
        state, _ = load_checkpoint(checkpoint or self._save_dir, self.state_dict(), BEST_NAME)
        self.load_state_dict(state)
        meters = self._eval_meters()
        meters.register_meter(
            "hd", SurfaceMeter(self._num_classes, list(range(1, self._num_classes))))
        index_batches = ({b["group"]: b for b in self._eval_index_loaders["test"]}
                         if self._device_data else {})
        for batch in self._test_loader:
            n_valid = int(np.sum(batch["mask"]))
            ib = index_batches.get(batch["group"])
            if ib is not None:
                out = self._eval_steps_dev["test"](self._to_device(ib["indices"]),
                                                   self._to_device(ib["mask"]))
                preds = gather_rows(out["pred"], self._ctx).cpu().numpy()
                rows = dict(zip(ib["filename"], preds))
                pred = np.stack([rows[fn] for fn in batch["filename"][:n_valid]])
            else:
                out = self._eval_step(*eval_rows(batch, self._ctx, self._device))
                pred = gather_rows(out["pred"], self._ctx).cpu().numpy()[:n_valid]
            meters["loss"].add(float(out["loss"]))
            meters["dice"].add_stats(out["inter"].cpu().numpy(), out["union"].cpu().numpy(),
                                     group_name=batch["group"])
            target = batch["target"][:n_valid]
            with ExceptionIgnorer(RuntimeError):  # a class absent from pred or target
                meters["hd"].add(pred, target)
            if self._ctx.is_main:
                write_img_target(batch["image"][:n_valid], target, self._save_dir,
                                 batch["filename"])
                write_predict(pred, self._save_dir, batch["filename"])
        report = meters.tracking_status()
        if self._ctx.is_main:
            with open(Path(self._save_dir) / INFERENCE_NAME, "w") as f:
                json.dump(report, f, indent=1)
        self._ctx.barrier()
        return report, report["dice"]["DSC_mean"]


def uda_criterion(cfg: Dict[str, Any], section: str = "UDARegCriterion") -> str:
    """``<section>.name``, checked when the trainer is built (the JAX trainer
    asserts ``mse | kl``)."""
    name = cfg.get("name", "mse")
    if name not in UDA_CRITERIA:
        raise ValueError(f"{section}.name={name!r}: expected "
                         + " | ".join(repr(c) for c in UDA_CRITERIA))
    return name


class UDATrainer(SemiTrainer):
    mode = "uda"

    def _build_components(self) -> None:
        cfg = self._config["UDARegCriterion"]
        self._step_kwargs = dict(uda_criterion=uda_criterion(cfg), reg_weight=float(cfg["weight"]))


class EntropyMinTrainer(SemiTrainer):
    """Entropy minimisation on the unlabeled views (the
    ``EntropyMinParameters`` config section)."""

    mode = "entropy"

    def _build_components(self) -> None:
        cfg = self._config.get("EntropyMinParameters") or {"weight": 1e-5}
        self._step_kwargs = dict(reg_weight=float(cfg["weight"]))


class MeanTeacherTrainer(SemiTrainer):
    """Mean-teacher consistency (the ``MeanTeacherParameters`` config
    section): the student trains on [labeled, unlabeled, unlabeled_tf]; an
    EMA teacher with its own BN running statistics gives the flipped target;
    evaluation and inference use the student."""

    mode = "meanteacher"

    def _build_components(self) -> None:
        cfg = self._config.get("MeanTeacherParameters") or {}
        self._step_kwargs = dict(
            uda_criterion=uda_criterion(cfg, "MeanTeacherParameters"),
            reg_weight=float(cfg.get("weight", 10.0)),
            ema_alpha=float(cfg.get("alpha", 0.999)),
            ema_weight_decay=float(cfg.get("weight_decay", 1e-6)),
        )
        self._with_ema = True


def fused_path_unmet(device: torch.device, patch_sizes, crop_size: int,
                     decoder_heads: Sequence[tuple],
                     padded: bool = False) -> Optional[str]:
    """None when ``Kernel.backend=pallas_fused`` can take the fused path,
    else the first unmet condition: the JAX gate's conditions, and each
    head's logits at most ``ops/mi_fused.py:MAX_LANES`` lanes wide, the
    widest rows the fused kernels take (the JAX kernel takes any multiple of
    128). ``decoder_heads``: (head_type, normalize[, lanes]) of each decoder
    position, lanes its S*K rounded up to 128. ``padded``: the batch needs
    pad rows to divide the data ranks (the JAX gate's condition): the fused
    kernels take logits, which the row mask cannot reach."""
    if device.type != "cuda":
        # the counterpart of the JAX gate's jax.default_backend() == "tpu"
        return (f"the fused kernels run on cuda, not {device.type} (the JAX package trains "
                "the unfused path off the TPU)")
    min_patch = min(patch_sizes) if isinstance(patch_sizes, (list, tuple)) else patch_sizes
    if min_patch < crop_size:
        return (f"min(patch_sizes)={min_patch} < crop_size={crop_size} (the fused path covers "
                "one full-map tile)")
    if any(head[0] != "linear" or head[1] for head in decoder_heads):
        return f"decoder heads {list(decoder_heads)} are not all linear and unnormalized"
    lanes = max((head[2] for head in decoder_heads if len(head) > 2), default=0)
    if lanes > mi_fused.MAX_LANES:
        return (f"the decoder heads' logits take {lanes} lanes (S*K rounded up to "
                f"{mi_fused.LANES}), above the fused kernels' {mi_fused.MAX_LANES}")
    if padded:
        return ("the batch needs pad rows to divide the data ranks (the fused kernels take "
                "logits, which the pad-and-mask row mask cannot reach)")
    return None


def graph_unmet(cfg: Dict[str, Any], device: torch.device,
                context: Optional[DistContext] = None) -> Optional[str]:
    """None when the trainer's step runs as a CUDA graph on ``device``, else
    why it stays eager (``steps.capture_unmet``'s list: off a card, a
    process group, ``Lookahead`` / ``Ranger``, which ``check_optimizer``
    refuses first). Asked before the optimizer is
    built, which it names by ``cfg``'s ``Optim.name``."""
    return capture_unmet(device, (cfg.get("Optim") or {}).get("name", "Adam"), context)


def _per_position(config: Dict[str, Any], feature_names, key: str, default) -> list:
    """A head option at each feature position, from EncoderParams or
    DecoderParams by the position's name."""
    enc, dec = config["EncoderParams"], config["DecoderParams"]
    return [(enc if name in ENCODER_NAMES else dec).get(key, default) for name in feature_names]


def _make_projector(config: Dict[str, Any], feature_names, fused_ok: bool = False,
                    local_dtype: torch.dtype = torch.float32) -> ProjectorWrapper:
    """The cluster heads, linear or mlp, normalized or not; the decoder
    heads emit the flat layout (as the JAX trainer's) and compute in
    ``local_dtype`` (the compute dtype), the encoder heads in fp32."""
    per_position = lambda key, default: _per_position(config, feature_names, key, default)
    return ProjectorWrapper(
        feature_names=tuple(feature_names),
        num_clusters=per_position("num_clusters", 10),
        num_subheads=per_position("num_subheads", 5),
        head_types=per_position("head_types", "linear"),
        normalize=per_position("normalize", False),
        local_emit_logits=fused_ok,
        local_dtype=local_dtype,
    )


class IICTrainer(SemiTrainer):
    mode = "iic"

    def _build_components(self) -> None:
        cfg = self._config["IICRegParameters"]
        loss_cfg = cfg.get("LossParams", {})
        patch_sizes = loss_cfg.get("patch_sizes", 1024)
        fused_ok = False
        if self._kernel_options[0] == "pallas_fused":
            positions = [name for name in self._feature_names if name not in ENCODER_NAMES]
            per_position = lambda key, default: _per_position(cfg, positions, key, default)
            block = mi_fused.LANES
            heads = [(head_type, bool(normalize), -(-int(s) * int(k) // block) * block)
                     for head_type, normalize, s, k in zip(
                         per_position("head_types", "linear"), per_position("normalize", False),
                         per_position("num_subheads", 5), per_position("num_clusters", 10))]
            unmet = fused_path_unmet(self._device, patch_sizes, self._crop_size, heads,
                                     self._batch_padded)
            fused_ok = unmet is None
            if unmet:
                _warn(f"Kernel.backend=pallas_fused: {unmet}; training the unfused path.")
        self._projector = _make_projector(cfg, self._feature_names, fused_ok,
                                          local_dtype=self._dtypes[0])
        self._step_kwargs = dict(
            reg_weight=float(cfg["weight"]),
            paddings=loss_cfg.get("paddings", 1),
            patch_sizes=patch_sizes,
        )


class UDAIICTrainer(IICTrainer):
    mode = "udaiic"

    def _build_components(self) -> None:
        uda_cfg = self._config["UDARegCriterion"]
        criterion = uda_criterion(uda_cfg)
        super()._build_components()
        iic_weight = self._step_kwargs.pop("reg_weight")
        self._step_kwargs.update(
            uda_criterion=criterion,
            uda_weight=float(uda_cfg["weight"]),
            iic_weight=iic_weight,
            reg_weight=1.0,
        )


trainer_zoos = {
    "partial": SemiTrainer,
    "uda": UDATrainer,
    "iic": IICTrainer,
    "udaiic": UDAIICTrainer,
    "entropy": EntropyMinTrainer,
    "meanteacher": MeanTeacherTrainer,
}
