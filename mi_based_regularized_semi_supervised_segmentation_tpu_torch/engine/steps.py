"""Train and eval steps (counterpart of the JAX package's ``engine/steps.py``).

One train step: draw the flip mask, build the twin view, ONE U-Net forward
over [labeled, unlabeled, unlabeled_tf] (BN statistics over the mixed batch),
supervised KL (= cross-entropy), the mode's regularizer, backward and an
optimizer step (``Optim.name``). Modes:
- partial: reg = 0
- uda:     reg_weight * consistency(softmax(f(Tx)), softmax(T f(x)).detach()),
           consistency = mse or kl (``uda_criterion``)
- iic:     reg_weight * importance-weighted IIC losses (global IID loss at
           encoder taps, displaced local MI at decoder taps, with the same
           flips re-applied to the plain decoder features)
- udaiic:  uda_weight * uda + iic_weight * iic
- entropy: reg_weight * mean entropy of softmax([f(x), f(Tx)])
- meanteacher: reg_weight * consistency(softmax(f(Tx)), softmax(T g(x))),
           g the EMA teacher: a no-grad train-mode forward on its own BN
           running statistics; after the optimizer step its parameters move to
           (g * a + (1 - a) * f) * (1 - weight_decay),
           a = min(1 - 1 / (t + 1), alpha), t the global step

The step updates the model, projector, optimizer, teacher and step counter
in place and returns its metrics as detached tensors, so the caller syncs
with the device only when it reads them.

With a ``DeviceDataStore`` the batch is slice indices only and the step
gathers and augments on the card. The JAX package's epoch programs
(``lax.scan`` over the step) become Python loops over the step that keep the
metrics on the device, stacked, for one readback per chunk of steps.

Pad-and-mask (``n_labeled_valid`` / ``n_unlabeled_valid``, the JAX step's):
the global sub-batches carry pad rows at their ends, and only the leading
rows are real. The BN mask covers the whole forward ([lab, unlab, unlab];
the teacher's forward gets the unlabeled one), every loss mean is a masked
sum over the real count, the IIC probabilities are zeroed on pad rows
(detached) before every joint, and the dice sums are masked: the numerics
are the unpadded batch's.

Data parallelism (``context``, a ``parallel.DistContext``): a tensor batch
holds the rank's rows of the global batch; an index batch holds the global
indices, and the step keeps its rows after drawing. Flip masks and
augmentation parameters are drawn for the whole padded global batch from
the step generator (seeded alike on every rank), then each rank keeps its
rows, so the draws are the same on every rank. Every reduction over the
batch is global: BN statistics (``models/unet.py``), the joints
(``ops/iic.py``, ``ops/iic_local.py``), and each mean, whose rank's masked
sum is divided by the global count. A term that every rank computes alike
from global sums (the MI) enters each rank's loss times 1 / W, so the
objective is the sum of the ranks' losses; the parameter gradients are
summed over the data group in one flat ``all_reduce`` (the metrics ride in
it), never averaged. Reported losses and dice sums are the global values.
The eval steps sum each patient's masked loss and I/U over the ranks'
slices.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.unet import ENCODER_NAMES
from ..ops.augment_device import apply_augment, center_crop_batch, sample_augment_params
from ..ops.flips import apply_flips, sample_flip_mask
from ..ops.iic import iid_loss
from ..ops.iic_local import (
    iid_segmentation_loss_fused_logits,
    iid_segmentation_small_patch_loss_flat,
    iid_segmentation_small_patch_loss_subheads,
)
from ..ops.losses import entropy, kl_div
from ..parallel.mesh import DistContext, reduce_grads_, reduce_sum_, single_context
from ..utils.general import class2one_hot

MODES = ("partial", "uda", "iic", "udaiic", "entropy", "meanteacher")
UDA_CRITERIA = ("mse", "kl")


def _as_list(value, n: int) -> List:
    if isinstance(value, (list, tuple)):
        if len(value) != n:
            raise ValueError(f"{value} should have {n} entries")
        return list(value)
    return [value] * n


def dice_stats(pred_labels: torch.Tensor, target: torch.Tensor, num_classes: int,
               mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample per-class intersection and union sums ([B, C] each) of
    [B, H, W] integer maps; ``mask`` [B] weights the samples."""
    pred_oh = class2one_hot(pred_labels, num_classes, class_axis=-1)
    tgt_oh = class2one_hot(target, num_classes, class_axis=-1)
    inter = (pred_oh * tgt_oh).sum(dim=(1, 2))
    union = pred_oh.sum(dim=(1, 2)) + tgt_oh.sum(dim=(1, 2))
    if mask is not None:
        inter = inter * mask[:, None]
        union = union * mask[:, None]
    return inter, union


def iic_regularization(projector, features: Dict[str, torch.Tensor], flip_mask: torch.Tensor,
                       n_labeled: int, n_unlabeled: int, feature_names: Sequence[str],
                       paddings: Sequence[int], patch_sizes: Sequence[int],
                       backend: str, row_mask: Optional[torch.Tensor] = None,
                       group=None) -> Dict[str, torch.Tensor]:
    """Per-position subhead-mean MI losses, {name: loss}.

    Each position's last 2*B_u feature rows split into (plain, tf). Encoder
    positions pair them directly (pooling is flip-invariant); decoder
    positions re-apply the flips to the plain half and pad both halves by the
    position's displacement radius, so the head's probabilities are born on
    the padded canvas the joint kernel reads; the border is then zeroed. The
    decoder heads' probabilities are flat [B, Hp, Wp, C] (the trainer's) or
    [B, Hp, Wp, S, K] (``local_flat`` off), each with its front door; the
    tiling and the joint follow ``patch_sizes`` and ``backend``. With
    ``projector.local_emit_logits`` (the fused path) the decoder heads emit
    logits and the fused kernels apply the softmax and the border mask.
    ``row_mask`` [B_u] zeroes the pad rows' probabilities before every
    joint (detached; not on the fused path, whose logits it cannot reach);
    ``group`` sums every joint over its ranks."""
    if row_mask is not None and projector.local_emit_logits:
        raise ValueError("a padded batch needs the unfused path: the fused kernels take "
                         "logits, which the row mask cannot reach")
    dec_idx = 0
    half1: Dict[str, torch.Tensor] = {}
    half2: Dict[str, torch.Tensor] = {}
    loss_cfg: Dict[str, Tuple[int, int]] = {}
    for name in feature_names:
        feat = features[name]
        plain = feat[n_labeled:n_labeled + n_unlabeled]
        tf = feat[n_labeled + n_unlabeled:]
        if name in ENCODER_NAMES:
            half1[name], half2[name] = plain, tf
            continue
        pad = paddings[dec_idx]
        loss_cfg[name] = (pad, patch_sizes[dec_idx])
        dec_idx += 1
        half1[name] = F.pad(apply_flips(plain, flip_mask), (0, 0, pad, pad, pad, pad))
        half2[name] = F.pad(tf, (0, 0, pad, pad, pad, pad))

    probs1 = projector(half1)
    probs2 = projector(half2)
    losses: Dict[str, torch.Tensor] = {}
    for name in feature_names:
        p1, p2 = probs1[name], probs2[name]
        if name in ENCODER_NAMES:
            losses[name] = torch.stack(
                [iid_loss(p1[:, s], p2[:, s], mask=row_mask, group=group)[0]
                 for s in range(p1.shape[1])]).mean()
            continue
        padding, patch = loss_cfg[name]
        hp, wp = p1.shape[1], p1.shape[2]
        S, K = projector.head_shape(name)
        if projector.local_emit_logits:
            # p1, p2 are lane-padded logits: no valid multiply here
            if patch < hp - 2 * padding or patch < wp - 2 * padding:
                raise ValueError(f"the fused path covers one full-map tile: patch {patch} < "
                                 f"map {hp - 2 * padding}x{wp - 2 * padding} at {name}")
            losses[name] = iid_segmentation_loss_fused_logits(p1, p2, S, K, padding=padding,
                                                              group=group)
            continue
        valid = torch.zeros((1, hp, wp) + (1,) * (p1.dim() - 3), dtype=p1.dtype,
                            device=p1.device)
        valid[:, padding:hp - padding, padding:wp - padding] = 1.0
        if row_mask is not None:
            valid = valid * row_mask.detach().to(p1.dtype).reshape((-1,) + (1,) * (p1.dim() - 1))
        if p1.dim() == 5:  # [B, Hp, Wp, S, K] (local_flat off)
            losses[name] = iid_segmentation_small_patch_loss_subheads(
                p1 * valid, p2 * valid, padding=padding, patch_size=patch, backend=backend,
                pre_padded=True, group=group)
        else:
            losses[name] = iid_segmentation_small_patch_loss_flat(
                p1 * valid, p2 * valid, S, K, padding=padding, patch_size=patch,
                backend=backend, pre_padded=True, group=group)
    return losses


def build_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    mode: str,
    *,
    num_classes: int,
    generator: torch.Generator,
    feature_names: Sequence[str] = (),
    feature_importance: Sequence[float] = (),
    projector: Optional[torch.nn.Module] = None,
    uda_criterion: str = "mse",
    uda_weight: float = 0.0,
    iic_weight: float = 0.0,
    reg_weight: float = 0.0,
    paddings=1,
    patch_sizes=1024,
    flip_threshold: float = 0.8,
    backend: str = "auto",
    data_store=None,
    crop: int = 224,
    geometry: str = "fused",
    teacher: Optional[torch.nn.Module] = None,
    ema_alpha: float = 0.999,
    ema_weight_decay: float = 1e-6,
    step_counter: Optional[torch.Tensor] = None,
    n_labeled_valid: Optional[int] = None,
    n_unlabeled_valid: Optional[int] = None,
    context: Optional[DistContext] = None,
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, flip_mask=None, aug_params=None) -> metrics.

    batch: {"labeled_image" [Bl, H, W, 1], "labeled_target" [Bl, H, W],
            "unlabeled_image" [Bu, H, W, 1]} tensors on the model's device;
    or, with ``data_store`` (a ``DeviceDataStore``, or a dict of one per
    "labeled" / "unlabeled"), {"labeled_indices" [Bl], "unlabeled_indices"
    [Bu]}: the step gathers those slices and augments them on the store's
    device (``geometry``, ``crop``).
    Each step draws, from ``generator``, the labeled augmentation, the
    unlabeled augmentation (device-data path) and the flip mask, each over
    the whole global batch. Tests inject them: ``flip_mask`` [Bu, 2] bool,
    ``aug_params`` {"labeled": params, "unlabeled": params} as
    ``ops.augment_device.sample_augment_params`` returns them, for the global
    batch (Bu its unlabeled rows, padded).
    ``n_labeled_valid`` / ``n_unlabeled_valid``: how many leading rows of
    each global sub-batch are real (pad-and-mask; None: all).
    ``context``: the data-parallel context (None: one process). With it a
    tensor batch holds the rank's rows, an index batch the global indices.
    ``teacher`` (meanteacher only): the EMA model, a copy of ``model``.
    ``step_counter``: a 0-d int64 CPU tensor, the global step, incremented
    in place by every step (the EMA schedule reads it); the caller keeps it
    to checkpoint it."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: expected one of {MODES}")
    if uda_criterion not in UDA_CRITERIA:
        raise ValueError(f"uda_criterion {uda_criterion!r}: expected one of {UDA_CRITERIA}")
    if (teacher is not None) != (mode == "meanteacher"):
        raise ValueError(f"mode {mode!r} {'needs' if mode == 'meanteacher' else 'takes no'} "
                         "teacher")
    needs_iic = mode in ("iic", "udaiic")
    needs_uda = mode in ("uda", "udaiic", "meanteacher")
    if step_counter is None:
        step_counter = torch.zeros((), dtype=torch.int64)
    ctx = context or single_context()
    group, world = ctx.group, ctx.data_world
    params = [p for g in optimizer.param_groups for p in g["params"]]

    def consistency(p_tf: torch.Tensor, p_target: torch.Tensor) -> torch.Tensor:
        """The UDA / mean-teacher term between two softmax maps, per
        element; the target is detached."""
        if uda_criterion == "mse":
            diff = p_tf.float() - p_target.detach().float()
            return diff * diff
        return kl_div(p_tf, p_target, reduction="none")

    if needs_iic:
        if projector is None:
            raise ValueError(f"mode {mode!r} needs a projector")
        dec_names = [n for n in feature_names if n not in ENCODER_NAMES]
        paddings = _as_list(paddings, len(dec_names))
        patch_sizes = _as_list(patch_sizes, len(dec_names))
        total = sum(float(x) for x in feature_importance)
        importance = [float(x) / total for x in feature_importance]

    def step(batch: Dict[str, torch.Tensor], flip_mask: Optional[torch.Tensor] = None,
             aug_params: Optional[Dict[str, Any]] = None) -> Dict[str, torch.Tensor]:
        if data_store is not None:
            lab_store, unlab_store = _stores(data_store)
            aug_params = aug_params or {}
            n_lab, n_unlab = (len(batch[k]) for k in ("labeled_indices", "unlabeled_indices"))
            labeled_image, labeled_target = augment_from_store(
                lab_store, batch["labeled_indices"], crop, geometry, generator,
                aug_params.get("labeled"), rows=ctx.rows(n_lab))
            unlabeled_image, _ = augment_from_store(
                unlab_store, batch["unlabeled_indices"], crop, geometry, generator,
                aug_params.get("unlabeled"), with_labels=False, rows=ctx.rows(n_unlab))
        else:
            labeled_image = batch["labeled_image"]
            labeled_target = batch["labeled_target"]
            unlabeled_image = batch["unlabeled_image"]
            n_lab, n_unlab = labeled_image.shape[0] * world, unlabeled_image.shape[0] * world
        lab_rows, unlab_rows = ctx.rows(n_lab), ctx.rows(n_unlab)
        # the rank's rows from here on
        n_labeled, n_unlabeled = labeled_image.shape[0], unlabeled_image.shape[0]
        if flip_mask is None:
            flip_mask = sample_flip_mask(generator, n_unlab, flip_threshold)
        elif flip_mask.shape[0] != n_unlab:
            raise ValueError(f"flip_mask has {flip_mask.shape[0]} rows for a global unlabeled "
                             f"batch of {n_unlab}")
        flip_mask = flip_mask[unlab_rows].to(unlabeled_image.device)
        unlabeled_image_tf = apply_flips(unlabeled_image, flip_mask)

        dev = unlabeled_image.device
        n_lab_valid = n_lab if n_labeled_valid is None else int(n_labeled_valid)
        n_unlab_valid = n_unlab if n_unlabeled_valid is None else int(n_unlabeled_valid)
        lab_mask = unlab_mask = bn_mask = None
        if (n_lab_valid, n_unlab_valid) != (n_lab, n_unlab):
            lab_mask = (torch.arange(n_lab, device=dev) < n_lab_valid)[lab_rows].float()
            unlab_mask = (torch.arange(n_unlab, device=dev) < n_unlab_valid)[unlab_rows].float()
            bn_mask = torch.cat([lab_mask, unlab_mask, unlab_mask])

        def mean(per_row: torch.Tensor, mask: Optional[torch.Tensor], n_valid: int):
            """The global mean over the real rows of this rank's share: its
            masked sum over the global element count."""
            if mask is not None:
                per_row = per_row * mask.reshape((-1,) + (1,) * (per_row.dim() - 1))
            return per_row.sum() / (n_valid * per_row[0].numel())

        if teacher is not None:
            teacher.train()
            with torch.no_grad():  # its BN running statistics move here
                teacher_logits_tf = apply_flips(
                    teacher(unlabeled_image, bn_mask=unlab_mask, bn_group=group), flip_mask)

        model.train()
        if projector is not None:
            projector.train()
        optimizer.zero_grad(set_to_none=True)
        inputs = torch.cat([labeled_image, unlabeled_image, unlabeled_image_tf])
        logits, features = model(inputs, return_features=True, bn_mask=bn_mask, bn_group=group)
        label_logits = logits[:n_labeled]
        unlabel_logits = logits[n_labeled:n_labeled + n_unlabeled]
        unlabel_tf_logits = logits[n_labeled + n_unlabeled:]

        onehot = class2one_hot(labeled_target, num_classes, class_axis=-1)
        sup_loss = mean(kl_div(torch.softmax(label_logits, -1), onehot, reduction="none"),
                        lab_mask, n_lab_valid)
        metrics: Dict[str, torch.Tensor] = {"sup_loss": sup_loss}
        reg_loss = torch.zeros((), device=logits.device)
        total_weight = reg_weight
        if needs_uda:
            target_logits = (teacher_logits_tf if teacher is not None
                             else apply_flips(unlabel_logits, flip_mask))
            uda_loss = mean(consistency(torch.softmax(unlabel_tf_logits, -1),
                                        torch.softmax(target_logits, -1)),
                            unlab_mask, n_unlab_valid)
            metrics["uda"] = uda_loss
        if mode == "entropy":
            ent = mean(entropy(torch.softmax(torch.cat([unlabel_logits, unlabel_tf_logits]), -1),
                               reduction="none"),
                       None if unlab_mask is None else torch.cat([unlab_mask, unlab_mask]),
                       2 * n_unlab_valid)
            metrics["entropy"] = ent
        if needs_iic:
            iic_losses = iic_regularization(projector, features, flip_mask, n_labeled,
                                            n_unlabeled, feature_names, paddings, patch_sizes,
                                            backend, row_mask=unlab_mask, group=group)
            # every rank holds the global MI: its share of the objective is 1 / W
            iic_loss_val = sum(w * iic_losses[n] for n, w in zip(feature_names, importance)) / world
            metrics["mi"] = -iic_loss_val
            for n in feature_names:
                metrics[f"individual_mis/{n}"] = -iic_losses[n] / world
        if mode in ("uda", "meanteacher"):
            reg_loss = uda_loss
        elif mode == "entropy":
            reg_loss = ent
        elif mode == "iic":
            reg_loss = iic_loss_val
        elif mode == "udaiic":
            reg_loss = uda_weight * uda_loss + iic_weight * iic_loss_val
            total_weight = 1.0
        total = sup_loss + total_weight * reg_loss
        metrics["reg_loss"] = reg_loss
        metrics["total_loss"] = total
        total.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            inter, union = dice_stats(label_logits.argmax(-1), labeled_target, num_classes,
                                      mask=lab_mask)
        if group is not None:  # the gradients, with every rank's shares of the metrics
            keys = list(metrics)
            rows = [inter.new_zeros((n_lab, num_classes)) for _ in range(2)]
            rows[0][lab_rows], rows[1][lab_rows] = inter, union
            riders = reduce_grads_(params, group, torch.cat(
                [torch.stack([metrics[k].float() for k in keys])]
                + [r.reshape(-1).float() for r in rows]))
            metrics = dict(zip(keys, riders[:len(keys)].unbind()))
            inter, union = (r.reshape(n_lab, num_classes).to(inter.dtype)
                            for r in riders[len(keys):].split(n_lab * num_classes))
        optimizer.step()
        if teacher is not None:
            _ema_update(teacher, model, int(step_counter), ema_alpha, ema_weight_decay)
        step_counter.add_(1)
        metrics["sup_dice_inter"] = inter
        metrics["sup_dice_union"] = union
        return metrics

    return step


@torch.no_grad()
def _ema_update(teacher: torch.nn.Module, student: torch.nn.Module, step: int, alpha: float,
                weight_decay: float) -> None:
    """teacher = (teacher * a + (1 - a) * student) * (1 - weight_decay) over
    the parameters, a = min(1 - 1 / (step + 1), alpha), in fp32 as the JAX
    step computes a; the BN buffers are the teacher's own."""
    t = np.float32(step)
    a = min(np.float32(1.0) - np.float32(1.0) / (t + np.float32(1.0)), np.float32(alpha))
    decay = np.float32(1.0) - np.float32(weight_decay)
    params = list(teacher.parameters())
    torch._foreach_mul_(params, float(a))
    torch._foreach_add_(params, list(student.parameters()), alpha=float(np.float32(1.0) - a))
    torch._foreach_mul_(params, float(decay))


def _eval_sums(model: torch.nn.Module, num_classes: int, image: torch.Tensor,
               target: torch.Tensor, mask: torch.Tensor):
    """One patient's rows: ([masked loss sum, valid rows, inter [C],
    union [C]] as one fp32 vector, the per-pixel loss's H * W, pred)."""
    model.eval()
    logits = model(image)
    per_pixel = kl_div(torch.softmax(logits, -1), class2one_hot(target, num_classes, class_axis=-1),
                       reduction="none")
    valid = mask.float()
    pred = logits.argmax(-1)
    inter, union = dice_stats(pred, target, num_classes, mask=valid)
    sums = torch.cat([(per_pixel * valid[:, None, None]).sum().reshape(1), valid.sum().reshape(1),
                      inter.sum(0), union.sum(0)])
    return sums, per_pixel.shape[1] * per_pixel.shape[2], pred


def _eval_out(sums: torch.Tensor, hw: int, num_classes: int) -> Dict[str, torch.Tensor]:
    """{loss, inter [..., C], union [..., C]} from ``_eval_sums`` vectors
    [..., 2 + 2C]."""
    return {"loss": sums[..., 0] / (sums[..., 1].clamp_min(1.0) * hw),
            "inter": sums[..., 2:2 + num_classes], "union": sums[..., 2 + num_classes:]}


def _store_batch(data_store, crop: int, indices, mask, rows: slice):
    """The centre-cropped slices ``indices[rows]`` of the store, with their
    target and mask, on its device."""
    idx = torch.as_tensor(indices, device=data_store.device).long()[rows]
    image = center_crop_batch(data_store.images[idx].float() / 255.0, crop)[..., None]
    target = center_crop_batch(data_store.labels[idx].to(torch.int32), crop)
    return image, target, torch.as_tensor(mask, device=data_store.device)[rows]


def build_eval_step(model: torch.nn.Module, *, num_classes: int, data_store=None,
                    crop: int = 224, context: Optional[DistContext] = None):
    """Returns evaluate(image, target, mask) -> {loss, inter [1, C],
    union [1, C], pred}: one padded patient volume per call, dice sums pooled
    over its valid slices (volume dice). With ``data_store`` the signature is
    evaluate(indices, mask): the slices are gathered and centre-cropped on
    the store's device. Under ``context`` the image, target and mask are the
    rank's rows (with a store, the indices and mask are the whole patient's
    and the step keeps its rows); the loss and I/U are summed over the
    ranks, ``pred`` holds the rank's rows (``parallel.gather_rows``)."""
    ctx = context or single_context()

    @torch.no_grad()
    def evaluate(image: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
        sums, hw, pred = _eval_sums(model, num_classes, image, target, mask)
        out = _eval_out(reduce_sum_(sums, ctx.group)[None], hw, num_classes)
        return {"loss": out["loss"][0], "inter": out["inter"], "union": out["union"],
                "pred": pred}

    def evaluate_device(indices: torch.Tensor, mask: torch.Tensor):
        return evaluate(*_store_batch(data_store, crop, indices, mask, ctx.rows(len(indices))))

    return evaluate if data_store is None else evaluate_device


# ---------------------------------------------------------------------------
# device-data path: gathering and augmenting from a store, epoch loops
# ---------------------------------------------------------------------------

def _stores(data_store):
    if isinstance(data_store, dict):
        return data_store["labeled"], data_store["unlabeled"]
    return data_store, data_store


def _rows(t: torch.Tensor, idx: Optional[torch.Tensor]) -> torch.Tensor:
    if idx is None:
        return t
    if t.dtype == torch.uint16:  # index its bits as int16 (uint16 kernels are sparse)
        return t.view(torch.int16)[idx].view(torch.uint16)
    return t[idx]


def augment_from_store(store, indices, crop: int, geometry: str,
                       generator: Optional[torch.Generator] = None,
                       params: Optional[Dict[str, Any]] = None,
                       with_labels: bool = True, rows: Optional[slice] = None):
    """Gathers the slices ``indices`` (None: the whole store) on the store's
    device and augments them, with the injected ``params`` or with draws from
    ``generator``, both for all of ``indices``; ``rows``: only those rows of
    the indices and the draws are gathered and augmented (a rank's). A
    packed store is gathered as one plane. Returns (image [B, crop, crop, 1]
    float32, label [B, crop, crop] int32 or None)."""
    idx = None if indices is None else torch.as_tensor(indices, device=store.device).long()
    if params is None:
        n = len(store) if idx is None else idx.shape[0]
        params = sample_augment_params(
            generator, n, store.shape, crop=crop,
            valid_hw=_rows(store.valid_hw_dev, idx), offsets=_rows(store.offsets_dev, idx))
    if rows is not None:
        idx = idx[rows]
        params = {k: None if v is None else v[rows] for k, v in params.items()}
    packed = with_labels and store.packed is not None
    images = _rows(store.packed if packed else store.images, idx)
    labels = None if packed or not with_labels else _rows(store.labels, idx)
    return apply_augment(images, labels, params, crop=crop, geometry=geometry, packed=packed)


def _row(batches: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in batches.items()}


def _stack(per_step: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Per-step metric dicts -> one dict of [steps, ...] device tensors."""
    return {k: torch.stack([m[k] for m in per_step]) for k in per_step[0]}


def build_epoch_scan(step_fn, num_batches: int):
    """A chunk of ``num_batches`` device-data steps: epoch(batches) ->
    stacked metrics, where batches holds [num_batches, B] index tensors.
    No metric leaves the device (the JAX package's ``lax.scan`` epoch)."""

    def epoch(batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return _stack([step_fn(_row(batches, i)) for i in range(num_batches)])

    return epoch


def _fold_in(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + int(i)) % (1 << 63)


def build_augment_fn(data_store, crop: int = 224, geometry: str = "fused",
                     context: Optional[DistContext] = None):
    """aug(seed, i, index_batch) -> {"labeled_image", "labeled_target",
    "unlabeled_image"}: the device augmentation alone, drawn from a generator
    seeded from (seed, i) rather than from the step's generator, so batch
    i + 1 can be augmented before step i runs. Under ``context`` the draws
    cover the global index batch and the rank's rows are augmented."""
    lab_store, unlab_store = _stores(data_store)
    ctx = context or single_context()

    def aug(seed: int, i: int, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        gen = torch.Generator(device=lab_store.device)
        gen.manual_seed(_fold_in(seed, i))
        lab, unlab = batch["labeled_indices"], batch["unlabeled_indices"]
        image, target = augment_from_store(lab_store, lab, crop, geometry, gen,
                                           rows=ctx.rows(len(lab)))
        unlabeled, _ = augment_from_store(unlab_store, unlab, crop, geometry, gen,
                                          with_labels=False, rows=ctx.rows(len(unlab)))
        return {"labeled_image": image, "labeled_target": target, "unlabeled_image": unlabeled}

    return aug


def build_epoch_scan_pipelined(aug_fn, step_fn, num_batches: int):
    """epoch(batches, seed): batch i + 1 is augmented (``aug_fn`` with
    ``seed``) before step i runs; the last iteration augments the first
    batch again and drops it (one wasted augmentation per call), as the JAX
    package's scan does. Everything runs on one stream, in that order.
    ``step_fn`` is a tensor-batch step (no store)."""

    def epoch(batches: Dict[str, torch.Tensor], seed: int) -> Dict[str, torch.Tensor]:
        cur = aug_fn(seed, 0, _row(batches, 0))
        out = []
        for i in range(num_batches):
            nxt = aug_fn(seed, i + 1, _row(batches, (i + 1) % num_batches))
            out.append(step_fn(cur))
            cur = nxt
        return _stack(out)

    return epoch


def build_epoch_scan_preaug(step_fn, data_store, num_batches: int, crop: int = 224,
                            geometry: str = "fused",
                            generator: Optional[torch.Generator] = None,
                            context: Optional[DistContext] = None):
    """``Kernel.augment=epoch``: every stored slice is augmented once per
    call, with draws from ``generator``, and each step takes its rows of the
    augmented stores; the step's flip mask stays drawn per step. Within one
    call the repeats of a slice share one transform (the original project
    draws one per sample). ``step_fn`` is a tensor-batch step (no store).
    Under ``context`` every rank augments the whole store alike and each
    step takes the rank's rows of the global index batch."""
    lab_store, unlab_store = _stores(data_store)
    ctx = context or single_context()

    def epoch(batches: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        lab_img, lab_tgt = augment_from_store(lab_store, None, crop, geometry, generator)
        unlab_img, _ = augment_from_store(unlab_store, None, crop, geometry, generator,
                                          with_labels=False)
        out = []
        for i in range(num_batches):
            li = batches["labeled_indices"][i].long()
            ui = batches["unlabeled_indices"][i].long()
            li, ui = li[ctx.rows(len(li))], ui[ctx.rows(len(ui))]
            out.append(step_fn({"labeled_image": lab_img[li], "labeled_target": lab_tgt[li],
                                "unlabeled_image": unlab_img[ui]}))
        return _stack(out)

    return epoch


def build_eval_scan(model: torch.nn.Module, *, num_classes: int, data_store, crop: int = 224,
                    context: Optional[DistContext] = None):
    """eval_all(indices [P, padded], masks [P, padded]) -> {loss [P],
    inter [P, C], union [P, C]} over every patient of ``data_store``, kept on
    the device. Under ``context`` each rank forwards its rows of every
    patient and the sums of all patients are summed over the ranks in one
    collective."""
    ctx = context or single_context()

    @torch.no_grad()
    def eval_all(indices: torch.Tensor, masks: torch.Tensor) -> Dict[str, torch.Tensor]:
        rows = ctx.rows(indices.shape[1])
        sums = [_eval_sums(model, num_classes,
                           *_store_batch(data_store, crop, indices[i], masks[i], rows))
                for i in range(indices.shape[0])]
        stacked = reduce_sum_(torch.stack([v for v, _, _ in sums]), ctx.group)
        return _eval_out(stacked, sums[0][1], num_classes)

    return eval_all
