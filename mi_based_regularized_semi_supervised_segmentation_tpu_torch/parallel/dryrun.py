"""Entry points of the data-parallel path: the headline step and a dry run
over several ranks (counterpart of the JAX package's ``__graft_entry__.py``).

    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun 4
    python -m mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun 2 cpu

- ``entry(device)``: (step, example arguments) of the headline udaiic train
  step at full width (U-Net 1 -> 4 at 224^2, 4 + 10 slices, Conv5 / Up_conv3
  / Up_conv2 heads of 5 x 20 clusters, the CUDA joint on a card, Adam).
- ``dryrun_multichip(n, device)``: ``n`` ranks joined by gloo over a
  ``file://`` store (``run_ranks``), all on ``device`` (``cuda``, the
  current card, unless the caller asks for ``cpu``; several ranks may share
  one card), each running ``dryrun_rank``: the udaiic step at the
  flagship 4 + 10 batch padded to a multiple of n, the device-data epoch
  loop, ``Kernel.augment=epoch``, the eval scan over the ranks' slices, and
  a checkpoint saved by rank 0 and reloaded leniently by every rank, with
  the state equal and the eval reproduced.
- ``run_ranks(fn, world, *args)``: the spawn harness the dry run and the
  tests use: ``fn(context, *args)`` on each rank, results back through
  files, every join under a timeout; a rank that fails or hangs raises.
"""

from __future__ import annotations

import multiprocessing
import tempfile
import time
import traceback
from datetime import timedelta
from itertools import chain
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .mesh import DistContext, init_distributed

FEATURES = ("Conv5", "Up_conv3", "Up_conv2")
FLAGSHIP = (4, 10)  # labeled + unlabeled slices of the headline batch


def _rank_entry(rank: int, world: int, workdir: str, device: str, backend: str,
                timeout: float, threads: int) -> None:
    torch.set_num_threads(threads)
    ctx = init_distributed(device, backend, init_method=f"file://{workdir}/store",
                           world_size=world, rank=rank, timeout=timedelta(seconds=timeout))
    try:
        fn, args = torch.load(Path(workdir) / "job.pt", weights_only=False)
        torch.save(fn(ctx, *args), Path(workdir) / f"rank{rank}.pt")
    except BaseException:
        (Path(workdir) / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        ctx.close()


def run_ranks(fn: Callable[..., Any], world: int, *args, device: str = "cpu",
              backend: str = "gloo", timeout: float = 120.0, threads: int = 1,
              workdir: Optional[str] = None) -> List[Any]:
    """``fn(context, *args)`` on ``world`` spawned processes (``fn`` and
    ``args`` picklable), joined by ``backend`` through a ``file://`` store in
    ``workdir`` (a temporary directory by default). Returns each rank's
    result (saved with ``torch.save``). A rank that raises, or any rank still
    running ``timeout`` seconds after the start, fails the call with the
    ranks' tracebacks; every process is stopped first. ``fn`` and ``args``
    reach the ranks through a file: a spawned process reads what its start
    hands it before that start returns, so a large argument there would
    start the ranks one after another."""
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        torch.save((fn, args), Path(tmp) / "job.pt")
        mp = multiprocessing.get_context("spawn")
        procs = [mp.Process(target=_rank_entry, daemon=True,
                            args=(r, world, tmp, device, backend, timeout, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        errors = "".join(f"--- rank {r} ---\n{(Path(tmp) / f'rank{r}.err').read_text()}"
                         for r in range(world) if (Path(tmp) / f"rank{r}.err").exists())
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} still ran after {timeout} s\n{errors}")
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"ranks {failed} of {world} failed\n{errors}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False) for r in range(world)]


def _headline(device, crop: int, seed: int = 0, lr: float = 1e-7, data_store=None,
              n_valid=None, context: Optional[DistContext] = None, jit: bool = False):
    """(model, projector, optimizer, step) of the headline udaiic config:
    the eager step, or with ``jit`` on a card the step as a CUDA graph and
    its optimizer built for one (no process group: ``context`` None)."""
    from ..engine.optim import build_optimizer
    from ..engine.steps import build_train_step
    from ..models import ProjectorWrapper, UNet

    torch.manual_seed(seed)
    model = UNet(1, 4).to(device)
    proj = ProjectorWrapper(FEATURES, num_clusters=20, num_subheads=5).to(device)
    graph = jit and torch.device(device).type == "cuda"
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": lr, "weight_decay": 1e-5}, graph=graph)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    n_lab, n_unlab = n_valid or (None, None)
    step = build_train_step(
        model, opt, "udaiic", num_classes=4, generator=gen, feature_names=FEATURES,
        feature_importance=[1.0, 0.5, 0.5], projector=proj, uda_criterion="mse",
        uda_weight=10.0, iic_weight=0.1, reg_weight=1.0, paddings=[1, 3], patch_sizes=1024,
        data_store=data_store, crop=crop, n_labeled_valid=n_lab, n_unlabeled_valid=n_unlab,
        context=context, jit=graph)
    return model, proj, opt, step


def entry(device: str = "cuda"):
    """(step, (batch,)): the headline udaiic train step at full width on
    ``device`` with a random batch of 4 + 10 slices at 224^2 (weights from
    seed 0), on a card as a CUDA graph; ``step(batch)`` trains once and
    returns the metrics."""
    crop = 224
    *_, step = _headline(device, crop, jit=True)
    rng = np.random.default_rng(0)
    batch = {"labeled_image": rng.random((FLAGSHIP[0], crop, crop, 1), dtype=np.float32),
             "labeled_target": rng.integers(0, 4, (FLAGSHIP[0], crop, crop)).astype(np.int32),
             "unlabeled_image": rng.random((FLAGSHIP[1], crop, crop, 1), dtype=np.float32)}
    return step, ({k: torch.from_numpy(v).to(device) for k, v in batch.items()},)


def _pad(n: int, world: int) -> int:
    return -(-n // world) * world


def _padded_indices(rng, n_store: int, n_real: int, n_padded: int, steps: int) -> np.ndarray:
    idx = rng.integers(0, n_store, (steps, n_real)).astype(np.int32)
    return np.pad(idx, ((0, 0), (0, n_padded - n_real)), mode="edge")


def _finite(name: str, values) -> List[float]:
    out = [float(v) for v in torch.as_tensor(values).flatten()]
    if not all(np.isfinite(out)):
        raise RuntimeError(f"{name}: non-finite {out}")
    return out


def dryrun_rank(ctx: DistContext, root: str, crop: int = 32) -> Dict[str, Any]:
    """The dry run on one rank (see the module docstring); ``root`` holds
    (or gets, from rank 0) a small synthetic set. Returns what it checked."""
    from ..data import ACDCDataset, generate_synthetic_acdc
    from ..data.device_pipeline import DeviceDataStore, DevicePatientEvalLoader
    from ..engine.checkpoints import lenient_load_checkpoint, save_checkpoint
    from ..engine.steps import build_epoch_scan, build_epoch_scan_preaug, build_eval_scan

    dev, n = ctx.device, ctx.data_world
    lab, unlab = FLAGSHIP
    lab_p, unlab_p = _pad(lab, n), _pad(unlab, n)
    rng = np.random.default_rng(0)
    out: Dict[str, Any] = {"rank": ctx.rank, "world": ctx.world, "padded": [lab_p, unlab_p]}

    # the udaiic step at the flagship batch, pad rows repeating the last real one
    *_, step = _headline(dev, crop, n_valid=FLAGSHIP, context=ctx)
    images = rng.random((unlab + lab, crop, crop, 1), dtype=np.float32)
    target = rng.integers(0, 4, (lab, crop, crop)).astype(np.int32)
    pad = lambda a, m: np.concatenate([a, np.repeat(a[-1:], m - len(a), 0)])
    full = {"labeled_image": pad(images[:lab], lab_p), "labeled_target": pad(target, lab_p),
            "unlabeled_image": pad(images[lab:], unlab_p)}
    rows = {k: torch.from_numpy(v[ctx.rows(len(v))]).to(dev) for k, v in full.items()}
    out["step_total_loss"] = _finite("step", step(rows)["total_loss"])

    if ctx.is_main:
        generate_synthetic_acdc(root, num_train_patients=4, num_val_patients=2,
                                slices_per_patient=4, size=2 * crop)
    ctx.barrier()
    store = DeviceDataStore(ACDCDataset(root, "train"), device=dev)
    stores = {"labeled": store, "unlabeled": store}
    batches = {"labeled_indices": torch.from_numpy(_padded_indices(rng, len(store), lab, lab_p, 2)),
               "unlabeled_indices": torch.from_numpy(
                   _padded_indices(rng, len(store), unlab, unlab_p, 2))}
    batches = {k: v.to(dev) for k, v in batches.items()}

    # the device-data epoch loop: every rank the global indices, its rows augmented
    model, proj, opt, raw = _headline(dev, crop, data_store=stores, n_valid=FLAGSHIP,
                                      context=ctx)
    out["scan_losses"] = _finite("epoch scan",
                                 build_epoch_scan(raw, 2, jit=False)(batches)["total_loss"])

    # Kernel.augment=epoch: the whole store augmented alike on every rank
    *_, tensor_step = _headline(dev, crop, n_valid=FLAGSHIP, context=ctx)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    preaug = build_epoch_scan_preaug(tensor_step, stores, 2, crop=crop, generator=gen,
                                     context=ctx, jit=False)
    out["preaug_losses"] = _finite("preaug", preaug(batches)["total_loss"])

    # the eval scan: each rank forwards its slices of every patient, the sums summed
    val_store = DeviceDataStore(ACDCDataset(root, "val"), device=dev)
    loader = DevicePatientEvalLoader(val_store, pad_multiple=n)
    eval_scan = build_eval_scan(model, num_classes=4, data_store=val_store, crop=crop,
                                context=ctx, jit=False)
    indices = torch.from_numpy(np.stack([b["indices"] for b in loader])).to(dev)
    masks = torch.from_numpy(np.stack([b["mask"] for b in loader])).to(dev)
    ev = eval_scan(indices, masks)
    dsc = 2.0 * ev["inter"][:, 1:] / ev["union"][:, 1:].clamp_min(1e-8)
    out["eval_dsc_mean"] = _finite("eval", dsc.mean())[0]

    # checkpoint: rank 0 writes, every rank reloads into a template of another init
    state = {"model": model.state_dict(), "projector": proj.state_dict(),
             "optimizer": opt.state_dict()}
    path = Path(root) / "dryrun_last.pth"
    if ctx.is_main:
        save_checkpoint(path, state, {"cur_epoch": 1, "best_score": out["eval_dsc_mean"]})
    ctx.barrier()
    model2, proj2, opt2, _ = _headline(dev, crop, seed=1)
    template = {"model": model2.state_dict(), "projector": proj2.state_dict(),
                "optimizer": opt2.state_dict()}
    loaded, meta, kept = lenient_load_checkpoint(path, template)
    model2.load_state_dict(loaded["model"])
    proj2.load_state_dict(loaded["projector"])
    opt2.load_state_dict(loaded["optimizer"])
    same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(
        chain(model.state_dict().values(), proj.state_dict().values()),
        chain(model2.state_dict().values(), proj2.state_dict().values())))
    ev2 = build_eval_scan(model2, num_classes=4, data_store=val_store, crop=crop,
                          context=ctx, jit=False)(indices, masks)
    reproduced = all(torch.equal(ev[k], ev2[k]) for k in ("inter", "union"))
    if not (same and reproduced and kept == 0 and meta["cur_epoch"] == 1):
        raise RuntimeError(f"checkpoint round trip: state equal {same}, eval reproduced "
                           f"{reproduced}, entries kept at init {kept}")
    out["checkpoint_leaves"] = len(model.state_dict()) + len(proj.state_dict())
    ctx.barrier()  # rank 0 keeps the file until every rank has read it
    return out


DRYRUN_TIMEOUT = 300.0  # seconds until a rank still running fails the dry run


def dryrun_multichip(n_devices: int, device: str = "cuda") -> List[Dict[str, Any]]:
    """``dryrun_rank`` on ``n_devices`` gloo ranks, all on ``device``;
    returns each rank's findings and prints rank 0's."""
    with tempfile.TemporaryDirectory() as root:
        results = run_ranks(dryrun_rank, n_devices, str(Path(root) / "acdc"), device=device,
                            timeout=DRYRUN_TIMEOUT, workdir=root)
    print(f"dryrun_multichip({n_devices}, {device!r}): {results[0]} OK", flush=True)
    return results


if __name__ == "__main__":
    import sys

    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
