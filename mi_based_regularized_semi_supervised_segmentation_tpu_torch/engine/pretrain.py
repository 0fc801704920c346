"""The contrastive pretrain pipeline (counterpart of the JAX package's
``engine/pretrain.py``).

Three phases over one U-Net, each with its own Adam and its own generator
(seeded ``RandomSeed + 1``):
- ``pretrain_encoder``: twin views of each slice (independent geometry),
  the ``ProjectionHead`` at ``extract_position`` (Conv5), a supervised
  contrastive loss whose positives share a partition (and/or a patient:
  ``group_option``); Conv1..extract_position train;
- ``pretrain_decoder``: twin views with a shared geometry; view 1 is flipped
  by a mask from the phase's generator, and the same flips are applied to
  view 2's features at ``extract_position`` (Up_conv3); the
  ``LocalProjectionHead`` max-pools each to 4 x 4, whose 2 x 2 blocks are
  the contrastive samples (positives: the same patient, partition and
  block); enable_grad_from (Up5)..extract_position train;
- ``finetune``: the supervised loss on the labeled slices, every component
  training; ``ContrastTrainerMT`` adds a mean teacher (MSE between the
  student's softmax on the flipped unlabeled slices and the teacher's,
  flipped; the EMA schedule reads the phase's step count on the device,
  ``_Phase.ema_count``) and evaluates the teacher.
``IICContrastTrainer`` adds IIC cluster heads to both pretrain phases: a
``ClusterHead`` on the encoder features (``iid_loss`` per subhead, then the
mean) and a 5-D ``LocalClusterHead`` on the decoder features, whose
displaced-MI loss (padding 0, one tile: ``patch_size`` 512 covers the map)
runs the CUDA joint on the card (``ops/mi_joint.py``: at padding 0 one
launch a product over all S * K = 200 lanes).

The freeze: the JAX package masks the Adam updates of frozen components; the
port gives their parameters ``requires_grad=False`` and leaves them out of
the phase's Adam, which keeps them bit-equal the same way. They still run
their forward in train mode, so their BN running statistics move, as in the
JAX package. A parameter of the phase's Adam that the loss does not reach
(the projector under ``disable_contrastive``) gets a zero gradient, as
``jax.grad`` gives it, so its coupled weight decay still moves it.

On a card (``jit``, the JAX builders' parameter) each step is a CUDA graph
(``engine/graphs.py:GraphStep``): one for each batch shape and real-row
count ``n_valid`` (a full batch and an epoch's short last one), replayed
every step, the phase's Adam built for it (``build_optimizer(...,
graph=True)``: a tensor lr, capturable); the val eval of finetune too, built
once a phase. A phase drops its graphs when it ends, before the next phase
captures its own. Under a process group, and off a card, the steps run
eagerly (``steps.capture_unmet``; the trainer prints why).

Each epoch: the learning rate of ``lr_at_epoch`` (eta_min 0 in the pretrain
phases, 5e-7 in finetune), ``num_batches`` steps on batches prefetched by a
background thread (``parallel/mesh.py``; one loader iterator a phase, left 3
batches past the epoch's last, as in the JAX package), the meters, the phase's
CSV under ``<save_dir>/<phase>/`` and its ``last.pth``; finetune also
evaluates the val patients and keeps ``best.pth`` by their DSC.
``Checkpoint=<run dir>`` resumes each phase from ``<dir>/<phase>/last.pth``
(strict: the epoch, the state, and in finetune the best score).

Data parallelism (``context``, a ``parallel.DistContext``; ``pretrain_main``
makes it from the launcher), as the semi trainers run it
(``engine/steps.py``): one process per device, each running the same
loaders with the same seeds. Every batch is rounded up to a multiple of the
data world with pad rows that repeat the last real one, and each rank keeps
its rows; the contrastive labels stay whole on every rank (the decoder's
[4B] are block-major over the global batch). Each step holds the rank's rows
and the global batch's real count (``n_valid``): BN statistics over the
data group (``models/unet.py``), ``supcon_loss`` of the rank's anchors
against the gathered contrast set over the global count of real anchors
(``ops/losses.py``), the IIC joints summed over the group with the pad rows
zeroed, each mean a masked sum over the global count; a term every rank
computes alike from global sums (the MI) enters each rank's loss times
1 / W, and the gradients are summed over the group in one flat
``all_reduce`` with the metrics riding along, so each rank's step is the
one-process step on the global batch. The flip masks are drawn over the real
rows, as one process draws them, pad rows ``False``. Each phase's state is
broadcast from rank 0 at its start; the val patients are padded to a
multiple of the data world and their sums taken over the ranks; only rank 0
writes ``config.yaml``, the CSVs, the checkpoints (then a barrier), the
event log and the progress lines, and every rank resumes from the same
file. A data world of 1 has no group and runs the one-process steps.
"""

from __future__ import annotations

import copy
import time
from contextlib import closing
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import yaml

from .. import PROJECT_PATH
from ..models import ClusterHead, LocalClusterHead, LocalProjectionHead, ProjectionHead, UNet
from ..models.heads import _l2_normalize
from ..models.unet import COMPONENT_NAMES, UNET_DIMENSIONS, component_param_filter
from ..ops.flips import apply_flips, sample_flip_mask
from ..ops.iic import iid_loss
from ..ops.iic_local import iid_segmentation_small_patch_loss_subheads
from ..ops.losses import kl_div, supcon_loss
from ..parallel import PinnedRing, prefetch_to_device
from ..parallel.mesh import DistContext, reduce_grads_, replicate_state, single_context
from ..utils import AverageValueMeter, MeterInterface, Storage, StorageIncomeDict, SummaryWriter, \
    UniversalDice
from ..utils.general import class2one_hot
from . import graphs
from .checkpoints import BEST_NAME, LAST_NAME, load_checkpoint, save_checkpoint
from .optim import (
    build_optimizer,
    init_optimizer_state,
    load_optimizer_state,
    lr_at_epoch,
    optimizer_state_dict,
    set_learning_rate,
)
from .steps import TrainStep, _ema_update, _graphed, build_eval_step, capture_unmet, dice_stats
from .trainer import _NullWriter, check_parallel, eval_rows, pad_rows, resolve_device, to_device

__all__ = [
    "global_labels",
    "local_labels",
    "group_option_flags",
    "unfold_blocks",
    "unfold_locations",
    "component_range",
    "freeze_mask",
    "build_pretrain_encoder_step",
    "build_pretrain_decoder_step",
    "build_finetune_step",
    "build_finetune_mt_step",
    "ContrastTrainer",
    "ContrastTrainerMT",
    "IICContrastTrainer",
    "pretrain_zoos",
]

PHASES = ("pretrain_encoder", "pretrain_decoder", "finetune")


# ---------------------------------------------------------------------------
# labels and layout (host side)
# ---------------------------------------------------------------------------

def _unique_mapping(names: Sequence[str]) -> np.ndarray:
    mapping = {u: i for i, u in enumerate(sorted(set(names)))}
    return np.asarray([mapping[n] for n in names], np.int32)


def global_labels(partitions: Sequence[str], groups: Sequence[str], on_patient: bool = False,
                  on_partition: bool = True) -> np.ndarray:
    """One int label per slice: slices of the same patient (``on_patient``)
    and/or partition (``on_partition``) share it, so they are positives."""
    keys = [(f"_{grp}" if on_patient else "") + (f"_{part}" if on_partition else "")
            for part, grp in zip(partitions, groups)]
    return _unique_mapping(keys)


def local_labels(partitions: Sequence[str], groups: Sequence[str],
                 locations: Sequence[str]) -> np.ndarray:
    """One int label per block: the same patient, partition and block
    location. ``locations`` has n_blocks * B entries, the batch repeated per
    block (``unfold_locations``)."""
    mul = len(locations) // len(partitions)
    keys = [f"_{g}_{p}_{loc}" for g, p, loc in zip([str(g) for g in groups] * mul,
                                                    [str(p) for p in partitions] * mul,
                                                    locations)]
    return _unique_mapping(keys)


def group_option_flags(group_option: str) -> Tuple[bool, bool]:
    """(on_patient, on_partition) of ``partition | patient | both``."""
    if group_option not in ("partition", "patient", "both"):
        raise ValueError(f"group_option={group_option!r}: expected 'partition' | 'patient' | "
                         "'both'")
    return group_option in ("patient", "both"), group_option in ("partition", "both")


def unfold_locations(shape_hw: Tuple[int, int], batch: int,
                     partition_num: Tuple[int, int] = (2, 2)) -> List[str]:
    """The location string of each block ``unfold_blocks`` makes of a
    [batch, H, W, C] map: blocks in raster order, all of the batch in each."""
    h, w = shape_hw
    bh, bw = h // partition_num[0], w // partition_num[1]
    return [f"({hi}, {wi})" for hi in range(0, h - bh + 1, bh)
            for wi in range(0, w - bw + 1, bw) for _ in range(batch)]


def unfold_blocks(x: torch.Tensor, partition_num: Tuple[int, int] = (2, 2)
                  ) -> Tuple[torch.Tensor, List[str]]:
    """[B, H, W, C] -> ([n_blocks * B, bh, bw, C], their locations): blocks
    in raster order, all B slices in each."""
    b, h, w, _ = x.shape
    bh, bw = h // partition_num[0], w // partition_num[1]
    blocks = [x[:, hi:hi + bh, wi:wi + bw] for hi in range(0, h - bh + 1, bh)
              for wi in range(0, w - bw + 1, bw)]
    return torch.cat(blocks), unfold_locations((h, w), b, partition_num)


# ---------------------------------------------------------------------------
# the freeze
# ---------------------------------------------------------------------------

def component_range(from_: str, util: str) -> List[str]:
    """The U-Net components from ``from_`` to ``util``, both included, in
    forward order."""
    i, j = COMPONENT_NAMES.index(from_), COMPONENT_NAMES.index(util)
    if i > j:
        raise ValueError(f"component {from_!r} comes after {util!r}")
    return COMPONENT_NAMES[i:j + 1]


def freeze_mask(model: nn.Module, trainable_components: Sequence[str]) -> Dict[str, bool]:
    """Whether each of the model's parameters (by name) trains: those of the
    ``trainable_components`` do."""
    keep = component_param_filter(trainable_components)
    return {name: keep(name) for name, _ in model.named_parameters()}


def _fill_grads(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """The optimizer's parameters, each the loss did not reach given a zero
    gradient (``jax.grad`` gives zeros there, and the coupled weight decay
    still moves them; every rank then sums the same set of gradients)."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return params


def _sum_over_ranks(optimizer: torch.optim.Optimizer, ctx: DistContext,
                    metrics: Dict[str, torch.Tensor],
                    dice: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    n_rows: int = 0) -> Dict[str, torch.Tensor]:
    """Before the optimizer step: the zero gradients (``_fill_grads``), then,
    with a data group, the gradients summed over it in one flat
    ``all_reduce`` with the metrics (each rank's share) and the rank's dice
    rows (``dice``: inter, union [rows, C], placed at its rows of the
    global [``n_rows``, C]) riding along. Returns the global metrics, the
    dice sums under ``sup_dice_inter`` / ``sup_dice_union``."""
    params = _fill_grads(optimizer)
    out = _detached(metrics)
    if ctx.group is not None:
        keys = list(out)
        parts = [torch.stack([out[k].float() for k in keys])]
        if dice is not None:
            rows = ctx.rows(n_rows)
            for t in dice:
                full = t.new_zeros((n_rows,) + tuple(t.shape[1:]))
                full[rows] = t
                parts.append(full.reshape(-1).float())
        riders = reduce_grads_(params, ctx.group, torch.cat(parts))
        out = dict(zip(keys, riders[:len(keys)].unbind()))
        if dice is not None:
            size = n_rows * dice[0].shape[1]
            dice = tuple(r.reshape(n_rows, -1).to(t.dtype) for r, t in zip(
                riders[len(keys):].split(size), dice))
    if dice is not None:
        out["sup_dice_inter"], out["sup_dice_union"] = dice
    return out


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def _counter(step_counter: Optional[torch.Tensor]) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64) if step_counter is None else step_counter


def _program(body: Callable[..., Dict[str, torch.Tensor]], step_counter: Optional[torch.Tensor],
             generator: Optional[torch.Generator], model: nn.Module,
             optimizer: torch.optim.Optimizer, ctx: DistContext, jit: bool):
    """The step of ``body``: the eager ``steps.TrainStep`` (which advances
    the counter after each call), or with ``jit`` on a card its
    ``graphs.GraphStep``, which raises where it cannot be captured."""
    step = TrainStep(body, _counter(step_counter), generator, next(model.parameters()).device,
                     (optimizer, ctx))
    return graphs.GraphStep(step) if _graphed(step, jit) else step


def _real_rows(n: int, n_valid: Optional[int], rows: slice,
               device) -> Tuple[int, Optional[torch.Tensor]]:
    """(The real rows of a global batch of ``n``: its leading ``n_valid``,
    all of them for None; this rank's ``rows`` of its real-row mask, float,
    or None when every row is real.)"""
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 < n_valid <= n:
        raise ValueError(f"n_valid={n_valid} for a global batch of {n} rows")
    if n_valid == n:
        return n, None
    return n_valid, (torch.arange(n, device=device) < n_valid)[rows].float()


def _flips(generator: torch.Generator, flip_mask: Optional[torch.Tensor], n: int, n_valid: int,
           threshold: float, rows: slice, device) -> torch.Tensor:
    """The rank's rows of the flip mask: drawn over the ``n_valid`` real rows
    of the global batch, as one process draws it (unless given, [n_valid,
    2]), then padded with ``False`` to the ``n`` global rows."""
    if flip_mask is None:
        flip_mask = sample_flip_mask(generator, n_valid, threshold)
    elif flip_mask.shape[0] != n_valid:
        raise ValueError(f"flip_mask has {flip_mask.shape[0]} rows for {n_valid} real rows")
    flip_mask = flip_mask.to(device)
    if n_valid < n:
        flip_mask = torch.cat([flip_mask, flip_mask.new_zeros((n - n_valid, 2))])
    return flip_mask[rows]


def _mean(per_row: torch.Tensor, mask: Optional[torch.Tensor], n_valid: int) -> torch.Tensor:
    """The mean over the real rows of the global batch: this rank's masked
    sum over the global element count (in one process without pad rows, the
    plain mean)."""
    if mask is not None:
        per_row = per_row * mask.reshape((-1,) + (1,) * (per_row.dim() - 1))
    return per_row.sum() / (n_valid * per_row[0].numel())


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

def build_pretrain_encoder_step(
    model: nn.Module, projector: nn.Module, optimizer: torch.optim.Optimizer, *,
    extract_position: str = "Conv5", iic_head: Optional[nn.Module] = None,
    iic_weight: float = 1.0, disable_contrastive: bool = False,
    step_counter: Optional[torch.Tensor] = None, context: Optional[DistContext] = None,
    jit: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step({image, image_tf [B, H, W, 1], labels [B]}, n_valid=None) ->
    metrics: one train-mode U-Net forward over both views, the
    L2-normalized projections of ``extract_position``'s features into
    ``supcon_loss``; with ``iic_head``, ``iid_loss`` per subhead between the
    views, averaged (``disable_contrastive``: that alone is the loss).
    ``n_valid``: the real rows of the global batch (its leading ones; None:
    all). Under ``context`` the images are the rank's rows and ``labels``
    the global batch's, whole (see the module docstring). ``jit``: on a
    card a CUDA graph (see the module docstring), else eager."""
    ctx = context or single_context()
    group, world = ctx.group, ctx.data_world

    def body(batch: Dict[str, torch.Tensor], n_valid: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        img = batch["image"]
        n = img.shape[0] * world
        _, mask = _real_rows(n, n_valid, ctx.rows(n), img.device)
        model.train()
        projector.train()
        optimizer.zero_grad(set_to_none=True)
        _, feats = model(torch.cat([img, batch["image_tf"]]), return_features=True,
                         bn_mask=None if mask is None else torch.cat([mask, mask]),
                         bn_group=group)
        en = feats[extract_position]
        z1, z2 = _l2_normalize(projector(en)).chunk(2)
        closs = supcon_loss(torch.stack([z1, z2], dim=1), labels=batch["labels"],
                            row_mask=mask, context=ctx)
        metrics = {"contrastive_loss": closs}
        total = closs
        if iic_head is not None:
            p1, p2 = iic_head(en).chunk(2)  # [B, S, K] each
            # every rank holds the MI of the global joints: its share is 1 / W
            iic = torch.stack([iid_loss(p1[:, s], p2[:, s], mask=mask, group=group)[0]
                               for s in range(p1.shape[1])]).mean() / world
            metrics["iic_loss"] = iic
            total = iic if disable_contrastive else iic_weight * iic + closs
        metrics["total_loss"] = total
        total.backward()
        metrics = _sum_over_ranks(optimizer, ctx, metrics)
        optimizer.step()
        return metrics

    return _program(body, step_counter, None, model, optimizer, ctx, jit)


def build_pretrain_decoder_step(
    model: nn.Module, projector: nn.Module, optimizer: torch.optim.Optimizer, *,
    generator: torch.Generator, extract_position: str = "Up_conv3",
    iic_head: Optional[nn.Module] = None, iic_weight: float = 1.0,
    disable_contrastive: bool = False, iic_padding: int = 0, iic_patch_size: int = 512,
    flip_threshold: float = 0.5, step_counter: Optional[torch.Tensor] = None,
    context: Optional[DistContext] = None, jit: bool = True,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """step({image (view 1), image_tf (view 2, the same geometry), labels
    [4B]}, flip_mask=None, n_valid=None) -> metrics. View 1 is flipped by
    ``flip_mask`` ([n_valid, 2] bool over the real rows of the global batch;
    drawn from ``generator`` unless given); view 2 is not, and its
    ``extract_position`` features take the same flips. The projector sees
    both halves: [2B, 4, 4, C] -> 2 x 2 blocks (``unfold_blocks``), each
    flattened and L2-normalized, into ``supcon_loss``. With ``iic_head`` (a
    5-D ``LocalClusterHead``): the displaced-MI loss of the two halves'
    [B, h, w, S, K] maps at ``iic_padding`` / ``iic_patch_size`` (on the
    card, through the CUDA joint). Under ``context`` the images are the
    rank's rows and ``labels`` the global batch's, whole. ``jit``: on a card
    a CUDA graph with ``generator`` registered (no injected ``flip_mask``),
    else eager."""
    ctx = context or single_context()
    group, world = ctx.group, ctx.data_world

    def body(batch: Dict[str, torch.Tensor], flip_mask: Optional[torch.Tensor] = None,
             n_valid: Optional[int] = None) -> Dict[str, torch.Tensor]:
        img, img_ctf = batch["image"], batch["image_tf"]
        n = img.shape[0] * world
        rows = ctx.rows(n)
        n_valid, mask = _real_rows(n, n_valid, rows, img.device)
        flip_mask = _flips(generator, flip_mask, n, n_valid, flip_threshold, rows, img.device)
        model.train()
        projector.train()
        optimizer.zero_grad(set_to_none=True)
        _, feats = model(torch.cat([apply_flips(img, flip_mask), img_ctf]), return_features=True,
                         bn_mask=None if mask is None else torch.cat([mask, mask]),
                         bn_group=group)
        dn_gtf, dn_ctf = feats[extract_position].chunk(2)
        dn_tf = torch.cat([dn_gtf, apply_flips(dn_ctf, flip_mask)])
        u1, u2 = (unfold_blocks(p)[0] for p in projector(dn_tf).chunk(2))
        z1 = _l2_normalize(u1.reshape(u1.shape[0], -1))
        z2 = _l2_normalize(u2.reshape(u2.shape[0], -1))
        blocks = u1.shape[0] // img.shape[0]
        # Two traps of the sharded batch. (a) ``labels`` are the global
        # batch's [blocks * n], block-major, whole on every rank: cut to a
        # rank's share of rows they would name other samples. (b) The rank's
        # samples are its rows of each block ([blocks * b], block-major over
        # its rows): supcon_loss gathers them and puts the contrast set back
        # in the one-process block-major order (``blocks``).
        closs = supcon_loss(torch.stack([z1, z2], dim=1), labels=batch["labels"],
                            row_mask=None if mask is None else mask.repeat(blocks),
                            context=ctx, blocks=blocks)
        metrics = {"contrastive_loss": closs}
        total = closs
        if iic_head is not None:
            q1, q2 = iic_head(dn_tf).chunk(2)  # [B, h, w, S, K] each
            if mask is not None:  # pad rows enter no joint
                m = mask.detach().to(q1.dtype).reshape((-1,) + (1,) * (q1.dim() - 1))
                q1, q2 = q1 * m, q2 * m
            iic = iid_segmentation_small_patch_loss_subheads(
                q1, q2, padding=iic_padding, patch_size=iic_patch_size, group=group) / world
            metrics["iic_loss"] = iic
            total = iic if disable_contrastive else iic_weight * iic + closs
        metrics["total_loss"] = total
        total.backward()
        metrics = _sum_over_ranks(optimizer, ctx, metrics)
        optimizer.step()
        return metrics

    return _program(body, step_counter, generator, model, optimizer, ctx, jit)


def _supervised(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
                mask: Optional[torch.Tensor], n_valid: int):
    """(KL = cross-entropy of the softmax against the one-hot target, as the
    global mean over the real rows (``_mean``), dice intersection and union
    of the rank's rows, 0 on pad rows)."""
    sup = _mean(kl_div(torch.softmax(logits, -1), class2one_hot(target, num_classes, class_axis=-1),
                       reduction="none"), mask, n_valid)
    with torch.no_grad():
        inter, union = dice_stats(logits.argmax(-1), target, num_classes, mask=mask)
    return sup, inter, union


def build_finetune_step(model: nn.Module, optimizer: torch.optim.Optimizer, *, num_classes: int,
                        step_counter: Optional[torch.Tensor] = None,
                        context: Optional[DistContext] = None, jit: bool = True):
    """step({image [B, H, W, 1], target [B, H, W]}, n_valid=None) -> metrics:
    the supervised loss on the labeled slices (the dice sums [B, C] of the
    global batch, 0 on pad rows). Under ``context`` the batch holds the
    rank's rows. ``jit``: on a card a CUDA graph, else eager."""
    ctx = context or single_context()

    def body(batch: Dict[str, torch.Tensor], n_valid: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        image = batch["image"]
        n = image.shape[0] * ctx.data_world
        n_valid, mask = _real_rows(n, n_valid, ctx.rows(n), image.device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        sup, inter, union = _supervised(model(image, bn_mask=mask, bn_group=ctx.group),
                                        batch["target"], num_classes, mask, n_valid)
        sup.backward()
        metrics = _sum_over_ranks(optimizer, ctx, {"sup_loss": sup}, (inter, union), n)
        optimizer.step()
        return metrics

    return _program(body, step_counter, None, model, optimizer, ctx, jit)


def build_finetune_mt_step(
    model: nn.Module, teacher: nn.Module, optimizer: torch.optim.Optimizer, *,
    num_classes: int, generator: torch.Generator, reg_weight: float = 10.0,
    ema_alpha: float = 0.999, ema_weight_decay: float = 1e-6, flip_threshold: float = 0.5,
    step_counter: Optional[torch.Tensor] = None, ema_count: Optional[torch.Tensor] = None,
    context: Optional[DistContext] = None, jit: bool = True,
):
    """step({image, target, unlabeled_image}, flip_mask=None, n_valid=None,
    n_unlabeled_valid=None) -> metrics. The teacher's no-grad train-mode
    forward on the unflipped unlabeled slices (its own BN statistics move),
    its logits flipped; the student on [labeled, flipped unlabeled]:
    supervised loss + ``reg_weight`` * MSE of the softmaxes; after the Adam
    step the teacher's parameters move to (teacher * a + (1 - a) * student)
    * (1 - ``ema_weight_decay``), a = min(1 - 1 / (t + 1), ``ema_alpha``), t
    the phase's step before this one, alike on every rank, read from
    ``ema_count`` (a 0-d int64 tensor on the model's device that each step
    advances; default: made from ``step_counter``). ``flip_mask``:
    [n_unlabeled_valid, 2] over the real unlabeled rows of the global batch.
    Under ``context`` the batch holds the rank's rows. ``jit``: on a card a
    CUDA graph with ``generator`` registered, else eager."""
    counter = _counter(step_counter)
    if ema_count is None:
        ema_count = counter.to(next(model.parameters()).device, copy=True)
    ctx = context or single_context()
    group, world = ctx.group, ctx.data_world

    def body(batch: Dict[str, torch.Tensor], flip_mask: Optional[torch.Tensor] = None,
             n_valid: Optional[int] = None, n_unlabeled_valid: Optional[int] = None
             ) -> Dict[str, torch.Tensor]:
        image, unlabeled = batch["image"], batch["unlabeled_image"]
        dev = unlabeled.device
        n_lab, n_unlab = image.shape[0] * world, unlabeled.shape[0] * world
        unlab_rows = ctx.rows(n_unlab)
        lab_valid, lab_mask = _real_rows(n_lab, n_valid, ctx.rows(n_lab), dev)
        unlab_valid, unlab_mask = _real_rows(n_unlab, n_unlabeled_valid, unlab_rows, dev)
        flip_mask = _flips(generator, flip_mask, n_unlab, unlab_valid, flip_threshold,
                           unlab_rows, dev)
        bn_mask = None
        if lab_mask is not None or unlab_mask is not None:
            ones = lambda t: torch.ones(t.shape[0], device=dev)
            bn_mask = torch.cat([ones(image) if lab_mask is None else lab_mask,
                                 ones(unlabeled) if unlab_mask is None else unlab_mask])
        teacher.train()
        with torch.no_grad():
            teacher_logits_tf = apply_flips(teacher(unlabeled, bn_mask=unlab_mask,
                                                    bn_group=group), flip_mask)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        b_lab = image.shape[0]
        logits = model(torch.cat([image, apply_flips(unlabeled, flip_mask)]), bn_mask=bn_mask,
                       bn_group=group)
        sup, inter, union = _supervised(logits[:b_lab], batch["target"], num_classes, lab_mask,
                                        lab_valid)
        # the MSE of the softmaxes (``mse_consistency``) as a global mean
        diff = (torch.softmax(logits[b_lab:], -1).float()
                - torch.softmax(teacher_logits_tf, -1).float())
        reg = _mean(diff * diff, unlab_mask, unlab_valid)
        (sup + reg_weight * reg).backward()
        metrics = _sum_over_ranks(optimizer, ctx, {"sup_loss": sup, "reg_loss": reg},
                                  (inter, union), n_lab)
        optimizer.step()
        _ema_update(teacher, model, ema_count, ema_alpha, ema_weight_decay)
        return metrics

    return _program(body, counter, generator, model, optimizer, ctx, jit)


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

class _Phase:
    """One phase's trainable state: the heads, the Adam over the trainable
    parameters (``graph``: built for a CUDA graph), the generator (seeded
    ``seed``), the step counter and, in the mean-teacher finetune, the
    teacher and the counter's copy on the card (``ema_count``).
    ``state_dict`` / ``load_state_dict`` hold all of it with the model, for
    the phase's checkpoints; a load fills every tensor in place."""

    def __init__(self, model: nn.Module, heads: nn.ModuleDict, components: Sequence[str],
                 lr: float, weight_decay: float, device: torch.device, seed: int,
                 teacher: Optional[nn.Module] = None, graph: bool = False) -> None:
        self.model, self.heads, self.teacher = model, heads.to(device), teacher
        mask = freeze_mask(model, components)
        for name, p in model.named_parameters():
            p.requires_grad_(mask[name])
        params = [p for name, p in model.named_parameters() if mask[name]]
        self.optimizer = build_optimizer(params + list(self.heads.parameters()),
                                         {"name": "Adam", "lr": lr, "weight_decay": weight_decay},
                                         graph=graph)
        init_optimizer_state(self.optimizer)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(seed)
        self.counter = torch.zeros((), dtype=torch.int64)
        self.ema_count = (None if teacher is None
                          else torch.zeros((), dtype=torch.int64, device=device))

    def state_dict(self) -> Dict[str, Any]:
        return {"model": self.model.state_dict(), "heads": self.heads.state_dict(),
                "optimizer": optimizer_state_dict(self.optimizer), "step": self.counter,
                "generator": self.generator.get_state(),
                "teacher": None if self.teacher is None else self.teacher.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.heads.load_state_dict(state["heads"])
        load_optimizer_state(self.optimizer, state["optimizer"])
        self.counter.copy_(state["step"])
        self.generator.set_state(state["generator"])
        if self.teacher is not None:
            self.teacher.load_state_dict(state["teacher"])
            self.ema_count.copy_(state["step"])

    def close(self) -> None:
        """Every parameter trains again; the gradients go (a captured step's
        live in its graph's pool)."""
        self.optimizer.zero_grad(set_to_none=True)
        self.model.requires_grad_(True)


def _host_batches(loader, make: Callable[[Dict[str, Any]], Dict[str, Any]]
                  ) -> Iterator[Dict[str, Any]]:
    """The loader's batches through ``make`` (numpy): one iterator a phase,
    shared by its epochs, as in the JAX package."""
    for batch in loader:
        yield make(batch)


def _refuse(options: Dict[str, Any], why: str) -> None:
    if options:
        raise ValueError(f"{sorted(options)} {why}")


def _pad_list(values: Sequence[Any], n: int) -> List[Any]:
    """``values`` with its last entry repeated up to ``n`` (the pad rows'
    names, which ``pad_rows`` gives the arrays)."""
    values = list(values)
    return values + values[-1:] * (n - len(values))


class ContrastTrainer:
    """Pretrain the encoder, then the decoder, then finetune (see the module
    docstring). ``Trainer`` keys other than the named arguments raise
    ``TypeError``; ``device``: ``cuda`` (raises without a card) or ``cpu``;
    ``step_timing``: synchronize after each step and keep the times (ms) in
    ``step_times_ms[phase]``; ``loop_walls_ms[phase]`` keeps each epoch's
    step loop wall (ms: from the first batch's fetch to the last step's end,
    one synchronisation); ``context``: the data-parallel context
    (``pretrain_main`` makes it from the launcher; None: one process)."""

    RUN_DIR = str(Path(PROJECT_PATH) / "runs")
    name = "contrast"

    def __init__(
        self,
        *,
        pretrain_loader,
        fine_tune_loader,
        val_loader,
        configuration: Dict[str, Any],
        save_dir: str = "contrast",
        max_epoch_train_encoder: int = 100,
        max_epoch_train_decoder: int = 100,
        max_epoch_train_finetune: int = 100,
        num_batches: int = 256,
        train_encoder: bool = True,
        train_decoder: bool = True,
        device: str = "cuda",
        run_dir: Optional[str] = None,
        step_timing: bool = False,
        context: Optional[DistContext] = None,
    ) -> None:
        ctx = context or single_context(device)
        check_parallel(configuration, ctx.world)
        self._device = resolve_device(device)
        if ctx.world > 1 and ctx.device.type == self._device.type:
            self._device = ctx.device  # the rank's card
        self._ctx = ctx
        self._config = configuration
        self._pretrain_loader = pretrain_loader
        self._fine_tune_loader = fine_tune_loader
        self._val_loader = val_loader
        self._max_epochs = dict(zip(PHASES, (int(max_epoch_train_encoder),
                                             int(max_epoch_train_decoder),
                                             int(max_epoch_train_finetune))))
        self._num_batches = int(num_batches)
        self.train_encoder = bool(train_encoder)
        self.train_decoder = bool(train_decoder)
        self._step_timing = bool(step_timing)
        self.step_times_ms: Dict[str, List[float]] = {}
        self.loop_walls_ms: Dict[str, List[float]] = {}
        self._save_dir = str(Path(run_dir or self.RUN_DIR) / save_dir)
        Path(self._save_dir).mkdir(parents=True, exist_ok=True)
        if ctx.is_main:
            with open(Path(self._save_dir) / "config.yaml", "w") as f:
                yaml.safe_dump(configuration, f, default_flow_style=False, sort_keys=False)

        arch = configuration.get("Arch", {"input_dim": 1, "num_classes": 4})
        self._num_classes = int(arch.get("num_classes", 4))
        self._seed = int(configuration.get("RandomSeed", 10))
        torch.manual_seed(self._seed)  # weights are a function of RandomSeed
        self._model = UNet(int(arch.get("input_dim", 1)), self._num_classes).to(self._device)
        self._storages = {phase: Storage() for phase in PHASES}
        self._best_score = -1.0
        self._start_epoch = 0
        # the phases' steps and eval as CUDA graphs (each phase's Adam built for them)
        eager = capture_unmet(self._device, "Adam", ctx)
        if eager and ctx.is_main:
            print(f"[{self.name}] the steps run eagerly: {eager}", flush=True)
        self._jit = eager is None

    # --- phase helpers ---------------------------------------------------
    def _init_head(self, make: Callable[[], nn.Module], salt: int) -> nn.Module:
        """A head made with the weights of seed RandomSeed + ``salt``."""
        torch.manual_seed(self._seed + salt)
        return make()

    def _phase(self, heads: Dict[str, nn.Module], components: Sequence[str], lr: float,
               weight_decay: float, teacher: Optional[nn.Module] = None) -> _Phase:
        """The phase's state, every rank holding rank 0's (the JAX
        ``replicate_state`` of each phase's state)."""
        phase = _Phase(self._model, nn.ModuleDict(heads), components, lr, weight_decay,
                       self._device, self._seed + 1, teacher, graph=self._jit)
        replicate_state([self._model, phase.heads, teacher], phase.optimizer, self._ctx)
        return phase

    def _padded(self, n: int) -> int:
        """A global batch of ``n`` rows rounded up to the data world."""
        dw = self._ctx.data_world
        return -(-n // dw) * dw

    def _views(self, b: Dict[str, Any]) -> Dict[str, Any]:
        """A contrastive batch's two views padded to the data world, its
        group names (the real rows'), the padded names and partitions the
        labels are made of (pad rows repeat the last real one) and the real
        count (``valid``, the steps' keyword)."""
        n = len(b["group"])
        m = self._padded(n)
        return {"image": pad_rows(b["image"], m), "image_tf": pad_rows(b["image_tf"], m),
                "group": b["group"], "valid": {"n_valid": n},
                "names": (_pad_list(b["partition"], m), _pad_list(b["group"], m))}

    def _resume(self, phase: _Phase, name: str, checkpoint: Optional[str]) -> None:
        """From ``<checkpoint>/<name>/last.pth`` (strict): the state, the next
        epoch and, in finetune, the best score."""
        if checkpoint is None:
            return  # every rank loads the same file
        state, meta = load_checkpoint(Path(checkpoint) / name, phase.state_dict(), LAST_NAME)
        phase.load_state_dict(state)
        self._start_epoch = int(meta.get("cur_epoch", -1)) + 1
        if name == "finetune":
            self._best_score = float(meta.get("best_score", -1.0))

    def _run_phase(self, name: str, phase: _Phase, step, batches: Iterator[Dict[str, Any]],
                   lr: float, multiplier: float, warmup_max: int, eta_min: float,
                   meter_names: Sequence[str], income_key: str, writer,
                   eval_model: Optional[nn.Module] = None) -> None:
        """The phase's epochs from ``_start_epoch``; ``eval_model``: evaluate
        it on the val patients each epoch (one eval program a phase) and keep
        ``best.pth`` (finetune). The step's and the eval's graphs go when the
        phase ends.
        ``batches``: the phase's host batches, prefetched on a background
        thread each epoch, which leaves them N + 3 batches on for N steps (the
        3 surplus batches are lost, as in the JAX package); under a data group
        each rank keeps its rows of every array but the contrastive
        ``labels``. Only rank 0 writes the CSV, the checkpoints (then a
        barrier) and the progress line."""
        phase_dir = Path(self._save_dir) / name
        main = self._ctx.is_main
        max_epoch = self._max_epochs[name]
        storage = self._storages[name]
        times = self.step_times_ms.setdefault(name, [])
        walls = self.loop_walls_ms.setdefault(name, [])
        ring = PinnedRing(self._device) if self._device.type == "cuda" else None  # one a phase
        evaluate = None if eval_model is None else build_eval_step(
            eval_model, num_classes=self._num_classes, context=self._ctx, jit=self._jit)
        try:
            for epoch in range(self._start_epoch, max_epoch):
                t_epoch = time.perf_counter()
                meters = MeterInterface()
                for m in ("lr", *meter_names):
                    meters.register_meter(m, AverageValueMeter())
                if eval_model is not None:
                    meters.register_meter("ds", UniversalDice(
                        self._num_classes, list(range(1, self._num_classes))))
                epoch_lr = lr_at_epoch(epoch, lr, multiplier, warmup_max, max_epoch, eta_min)
                set_learning_rate(phase.optimizer, epoch_lr)
                meters["lr"].add(epoch_lr)
                pending = []
                t_loop = time.perf_counter()
                with closing(prefetch_to_device(batches, self._device, self._ctx,
                                                whole=("labels",), ring=ring)) as prefetched:
                    for _ in range(self._num_batches):
                        batch = next(prefetched)
                        groups, valid = batch.pop("group"), batch.pop("valid")
                        batch = {k: to_device(v, self._device) for k, v in batch.items()}
                        t0 = time.perf_counter()
                        metrics = step(batch, **valid)
                        if self._step_timing:
                            if self._device.type == "cuda":
                                torch.cuda.synchronize(self._device)
                            times.append((time.perf_counter() - t0) * 1e3)
                        pending.append((metrics, groups))
                    if self._device.type == "cuda":  # the loop ends with its last step
                        torch.cuda.synchronize(self._device)
                    walls.append((time.perf_counter() - t_loop) * 1e3)
                for metrics, groups in pending:  # one device sync per epoch
                    for m in meter_names:
                        meters[m].add(float(metrics[m]))
                    if eval_model is not None:  # the real rows: pad rows' sums are 0
                        n = len(groups)
                        meters["ds"].add_stats(metrics["sup_dice_inter"][:n].cpu().numpy(),
                                               metrics["sup_dice_union"][:n].cpu().numpy(),
                                               group_name=groups)
                income = {income_key: meters.tracking_status()}
                cur_score = None
                if evaluate is not None:
                    income["val"], cur_score = self._eval_phase(evaluate)
                storage.put_from_dict(StorageIncomeDict(**income), epoch)
                writer.add_scalars_from_income_dict(income, epoch)
                is_best = cur_score is not None and cur_score > self._best_score
                if is_best:
                    self._best_score = float(cur_score)
                if main:  # every rank holds the same state
                    storage.to_csv(str(phase_dir), f"{name}.csv")
                    state = phase.state_dict()
                    meta = {"cur_epoch": epoch, "best_score": self._best_score, "phase": name}
                    save_checkpoint(phase_dir / LAST_NAME, state, meta)
                    if is_best:
                        save_checkpoint(phase_dir / BEST_NAME, state, meta)
                self._ctx.barrier()  # no rank reads a checkpoint before it is whole
                if not main:
                    continue
                losses = " ".join(f"{m}={income[income_key][m]['mean']:.4f}"
                                  for m in meter_names)
                print(f"[{self.name}] {name} epoch {epoch:03d} "
                      f"({time.perf_counter() - t_epoch:.1f}s): {losses} lr={epoch_lr:.2e}"
                      + (f" val_DSC={cur_score:.4f}" if cur_score is not None else ""),
                      flush=True)
        finally:
            self._start_epoch = 0
            graphs.release(step, evaluate)
            phase.close()

    def _eval_phase(self, evaluate) -> Tuple[Dict[str, Dict[str, float]], float]:
        """The val patients through ``evaluate`` (a ``build_eval_step``):
        each patient's slices padded to a multiple of the data world, each
        rank forwarding its rows; the loss and I/U summed over the ranks."""
        meters = MeterInterface()
        meters.register_meter("sup_loss", AverageValueMeter())
        meters.register_meter(
            "ds", UniversalDice(self._num_classes, list(range(1, self._num_classes))))
        for batch in self._val_loader:
            out = evaluate(*eval_rows(batch, self._ctx, self._device))
            meters["sup_loss"].add(float(out["loss"]))
            meters["ds"].add_stats(out["inter"].cpu().numpy(), out["union"].cpu().numpy(),
                                   group_name=batch["group"])
        report = meters.tracking_status()
        return report, report["ds"]["DSC_mean"]

    def _encoder_iic_branch(self, extract_position: str, head_options: Dict[str, Any]):
        """(IIC head or None, its step options) from the phase's head options."""
        _refuse(head_options, "apply to Trainer.name=iiccontrast only")
        return None, {}

    def _decoder_iic_branch(self, extract_position: str, head_options: Dict[str, Any]):
        _refuse(head_options, "apply to Trainer.name=iiccontrast only")
        return None, {}

    # --- phases ----------------------------------------------------------
    def pretrain_encoder(self, writer, *, group_option: str = "partition", lr: float = 1e-6,
                         weight_decay: float = 1e-5, multiplier: float = 300,
                         warmup_max: int = 10, ptype: str = "mlp",
                         extract_position: str = "Conv5", checkpoint: Optional[str] = None,
                         **head_options) -> None:
        dim = UNET_DIMENSIONS[extract_position]
        heads = {"projector": self._init_head(
            lambda: ProjectionHead(dim, output_dim=256, head_type=ptype), 11)}
        iic_head, extra = self._encoder_iic_branch(extract_position, head_options)
        if iic_head is not None:
            heads["iic"] = iic_head
        on_patient, on_partition = group_option_flags(group_option)
        phase = self._phase(heads, component_range("Conv1", extract_position), lr, weight_decay)
        self._pretrain_loader.set_total_freedom(True)
        step = build_pretrain_encoder_step(
            self._model, phase.heads["projector"], phase.optimizer,
            extract_position=extract_position, iic_head=iic_head, step_counter=phase.counter,
            context=self._ctx, jit=self._jit, **extra)

        def make(b):
            out = self._views(b)
            out["labels"] = global_labels(*out.pop("names"), on_patient, on_partition)
            return out

        batches = _host_batches(self._pretrain_loader, make)
        self._resume(phase, "pretrain_encoder", checkpoint)
        self._run_phase("pretrain_encoder", phase, step, batches, lr, multiplier, warmup_max,
                        0.0, ["contrastive_loss"] + (["iic_loss"] if iic_head else []),
                        "PRETRAIN_ENCODER", writer)

    def pretrain_decoder(self, writer, *, lr: float = 1e-6, weight_decay: float = 0.0,
                         multiplier: float = 300, warmup_max: int = 10, ptype: str = "mlp",
                         extract_position: str = "Up_conv3", enable_grad_from: str = "Up5",
                         checkpoint: Optional[str] = None, **head_options) -> None:
        dim = UNET_DIMENSIONS[extract_position]
        heads = {"projector": self._init_head(
            lambda: LocalProjectionHead(dim, head_type=ptype, output_size=(4, 4)), 13)}
        iic_head, extra = self._decoder_iic_branch(extract_position, head_options)
        if iic_head is not None:
            heads["iic"] = iic_head
        phase = self._phase(heads, component_range(enable_grad_from, extract_position), lr,
                            weight_decay)
        self._pretrain_loader.set_total_freedom(False)
        step = build_pretrain_decoder_step(
            self._model, phase.heads["projector"], phase.optimizer, generator=phase.generator,
            extract_position=extract_position, iic_head=iic_head, step_counter=phase.counter,
            context=self._ctx, jit=self._jit, **extra)

        def make(b):
            out = self._views(b)
            parts, groups = out.pop("names")
            # block-major over the padded global batch, whole on every rank
            out["labels"] = local_labels(parts, groups, unfold_locations((4, 4), len(groups)))
            return out

        batches = _host_batches(self._pretrain_loader, make)
        self._resume(phase, "pretrain_decoder", checkpoint)
        self._run_phase("pretrain_decoder", phase, step, batches, lr, multiplier, warmup_max,
                        0.0, ["contrastive_loss"] + (["iic_loss"] if iic_head else []),
                        "PRETRAIN_DECODER", writer)

    def finetune(self, writer, *, lr: float = 1e-7, weight_decay: float = 1e-5,
                 multiplier: float = 200, warmup_max: int = 10,
                 checkpoint: Optional[str] = None, **kwargs) -> None:
        teacher = self._make_teacher()
        phase = self._phase({}, COMPONENT_NAMES, lr, weight_decay, teacher)
        step = self._build_finetune_step(phase, **kwargs)
        labeled = iter(self._fine_tune_loader)
        unlabeled = iter(self._pretrain_loader) if teacher is not None else None

        def make(lab):
            n = len(lab["group"])
            m = self._padded(n)
            out = {"image": pad_rows(lab["image"], m), "target": pad_rows(lab["target"], m),
                   "group": lab["group"], "valid": {"n_valid": n}}
            if unlabeled is not None:
                image = next(unlabeled)["image"]
                out["unlabeled_image"] = pad_rows(image, self._padded(len(image)))
                out["valid"]["n_unlabeled_valid"] = len(image)
            return out

        self._resume(phase, "finetune", checkpoint)
        self._run_phase("finetune", phase, step, _host_batches(labeled, make), lr,
                        multiplier, warmup_max, 5e-7,
                        ["sup_loss"] + (["reg_loss"] if teacher is not None else []),
                        "finetune", writer,
                        eval_model=self._model if teacher is None else teacher)

    def _make_teacher(self) -> Optional[nn.Module]:
        return None

    def _build_finetune_step(self, phase: _Phase):
        return build_finetune_step(self._model, phase.optimizer, num_classes=self._num_classes,
                                   step_counter=phase.counter, context=self._ctx, jit=self._jit)

    # --- orchestration ---------------------------------------------------
    def start_training(self, checkpoint: Optional[str] = None,
                       pretrain_encoder_init_options: Optional[Dict[str, Any]] = None,
                       pretrain_decoder_init_options: Optional[Dict[str, Any]] = None,
                       finetune_network_init_options: Optional[Dict[str, Any]] = None) -> float:
        """The phases in order (the pretrain ones as ``train_encoder`` /
        ``train_decoder`` say), each resumed from ``checkpoint`` when given;
        returns the best val DSC of finetune."""
        enc_opt = dict(pretrain_encoder_init_options or {"group_option": "partition"})
        dec_opt = dict(pretrain_decoder_init_options or {})
        fin_opt = dict(finetune_network_init_options or {})
        writer = SummaryWriter(self._save_dir) if self._ctx.is_main else _NullWriter()
        with writer:
            if self.train_encoder:
                self.pretrain_encoder(writer, checkpoint=checkpoint, **enc_opt)
            if self.train_decoder:
                self.pretrain_decoder(writer, checkpoint=checkpoint, **dec_opt)
            self.finetune(writer, checkpoint=checkpoint, **fin_opt)
        return self._best_score


class ContrastTrainerMT(ContrastTrainer):
    """Finetune with a mean teacher (a copy of the pretrained model, its own
    BN statistics); the teacher is evaluated and picks ``best.pth``."""

    name = "contrastMT"

    def _make_teacher(self) -> nn.Module:
        return copy.deepcopy(self._model).requires_grad_(False)

    def _build_finetune_step(self, phase: _Phase, *, reg_weight: float = 10.0,
                             alpha: float = 0.999, ema_weight_decay: float = 1e-6):
        return build_finetune_mt_step(
            self._model, phase.teacher, phase.optimizer, num_classes=self._num_classes,
            generator=phase.generator, reg_weight=reg_weight, ema_alpha=alpha,
            ema_weight_decay=ema_weight_decay, step_counter=phase.counter,
            ema_count=phase.ema_count, context=self._ctx, jit=self._jit)


class IICContrastTrainer(ContrastTrainer):
    """Both pretrain phases add an IIC cluster-head branch (``IICHead``)."""

    name = "iiccontrast"

    @staticmethod
    def _iic_options(opts: Dict[str, Any]) -> Dict[str, Any]:
        return dict(iic_weight=float(opts.pop("iic_weight", 1.0)),
                    disable_contrastive=bool(opts.pop("disable_contrastive", False)))

    @staticmethod
    def _head_kwargs(opts: Dict[str, Any], clusters: int, subheads: int,
                     ctype: str) -> Dict[str, Any]:
        return dict(num_clusters=int(opts.pop("num_clusters", clusters)),
                    num_subheads=int(opts.pop("num_subheads", subheads)),
                    head_type=opts.pop("ctype", ctype), T=float(opts.pop("ctemperature", 1.0)))

    def _encoder_iic_branch(self, extract_position: str, head_options: Dict[str, Any]):
        opts = dict(head_options)
        kw = self._head_kwargs(opts, 10, 10, "linear")
        extra = self._iic_options(opts)
        _refuse(opts, "are no IICHead.Encoder options")
        head = self._init_head(
            lambda: ClusterHead(UNET_DIMENSIONS[extract_position], **kw), 17)
        return head.to(self._device), extra

    def _decoder_iic_branch(self, extract_position: str, head_options: Dict[str, Any]):
        opts = dict(head_options)
        kw = self._head_kwargs(opts, 20, 10, "mlp")
        extra = self._iic_options(opts)
        extra.update(iic_padding=int(opts.pop("padding", 0)),
                     iic_patch_size=int(opts.pop("patch_size", 512)))
        _refuse(opts, "are no IICHead.Decoder options")
        head = self._init_head(
            lambda: LocalClusterHead(UNET_DIMENSIONS[extract_position], flat_output=False, **kw),
            19)
        return head.to(self._device), extra


pretrain_zoos = {
    "contrast": ContrastTrainer,
    "contrastMT": ContrastTrainerMT,
    "iiccontrast": IICContrastTrainer,
}
