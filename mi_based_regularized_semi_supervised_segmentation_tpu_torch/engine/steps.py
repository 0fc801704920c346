"""Train and eval steps (counterpart of the JAX package's ``engine/steps.py``).

One train step: draw the flip mask, build the twin view, ONE U-Net forward
over [labeled, unlabeled, unlabeled_tf] (BN statistics over the mixed batch),
supervised KL (= cross-entropy), the mode's regularizer, backward and an Adam
step. Modes:
- partial: reg = 0
- uda:     reg_weight * mse(softmax(f(Tx)), softmax(T f(x)).detach())
- iic:     reg_weight * importance-weighted IIC losses (global IID loss at
           encoder taps, displaced local MI at decoder taps, with the same
           flips re-applied to the plain decoder features)
- udaiic:  uda_weight * uda + iic_weight * iic

The step updates the model, projector and optimizer in place and returns
its metrics as detached tensors, so the caller syncs with the device only
when it reads them.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..models.unet import ENCODER_NAMES
from ..ops.flips import apply_flips, sample_flip_mask
from ..ops.iic import iid_loss
from ..ops.iic_local import iid_segmentation_small_patch_loss_flat
from ..ops.losses import kl_div, mse_consistency
from ..utils.general import class2one_hot

MODES = ("partial", "uda", "iic", "udaiic")


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
                       backend: str) -> Dict[str, torch.Tensor]:
    """Per-position subhead-mean MI losses, {name: loss}.

    Each position's last 2*B_u feature rows split into (plain, tf). Encoder
    positions pair them directly (pooling is flip-invariant); decoder
    positions re-apply the flips to the plain half and pad both halves by the
    position's displacement radius, so the head's probabilities are born on
    the padded canvas the joint kernel reads; the border is then zeroed."""
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
                [iid_loss(p1[:, s], p2[:, s])[0] for s in range(p1.shape[1])]).mean()
            continue
        padding, patch = loss_cfg[name]
        hp, wp = p1.shape[1], p1.shape[2]
        valid = torch.zeros((1, hp, wp, 1), dtype=p1.dtype, device=p1.device)
        valid[:, padding:hp - padding, padding:wp - padding] = 1.0
        S, K = projector.head_shape(name)
        losses[name] = iid_segmentation_small_patch_loss_flat(
            p1 * valid, p2 * valid, S, K, padding=padding, patch_size=patch,
            backend=backend, pre_padded=True)
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
) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns step(batch, flip_mask=None) -> metrics.

    batch: {"labeled_image" [Bl, H, W, 1], "labeled_target" [Bl, H, W],
            "unlabeled_image" [Bu, H, W, 1]} tensors on the model's device.
    flip_mask: optional [Bu, 2] bool; drawn from ``generator`` when absent
    (tests inject the JAX step's draw)."""
    if mode not in MODES:
        raise NotImplementedError(f"mode {mode!r} is not ported yet; see ROADMAP.md")
    if uda_criterion != "mse":
        raise NotImplementedError(f"uda_criterion {uda_criterion!r} is not ported yet")
    needs_iic = mode in ("iic", "udaiic")
    needs_uda = mode in ("uda", "udaiic")
    if needs_iic:
        if projector is None:
            raise ValueError(f"mode {mode!r} needs a projector")
        dec_names = [n for n in feature_names if n not in ENCODER_NAMES]
        paddings = _as_list(paddings, len(dec_names))
        patch_sizes = _as_list(patch_sizes, len(dec_names))
        total = sum(float(x) for x in feature_importance)
        importance = [float(x) / total for x in feature_importance]

    def step(batch: Dict[str, torch.Tensor],
             flip_mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        labeled_image = batch["labeled_image"]
        labeled_target = batch["labeled_target"]
        unlabeled_image = batch["unlabeled_image"]
        n_labeled, n_unlabeled = labeled_image.shape[0], unlabeled_image.shape[0]
        if flip_mask is None:
            flip_mask = sample_flip_mask(generator, n_unlabeled, flip_threshold)
        flip_mask = flip_mask.to(unlabeled_image.device)
        unlabeled_image_tf = apply_flips(unlabeled_image, flip_mask)

        model.train()
        if projector is not None:
            projector.train()
        optimizer.zero_grad(set_to_none=True)
        inputs = torch.cat([labeled_image, unlabeled_image, unlabeled_image_tf])
        logits, features = model(inputs, return_features=True)
        label_logits = logits[:n_labeled]
        unlabel_logits = logits[n_labeled:n_labeled + n_unlabeled]
        unlabel_tf_logits = logits[n_labeled + n_unlabeled:]

        onehot = class2one_hot(labeled_target, num_classes, class_axis=-1)
        sup_loss = kl_div(torch.softmax(label_logits, -1), onehot)
        metrics: Dict[str, torch.Tensor] = {"sup_loss": sup_loss}
        reg_loss = torch.zeros((), device=logits.device)
        total_weight = reg_weight
        if needs_uda:
            uda_loss = mse_consistency(torch.softmax(unlabel_tf_logits, -1),
                                       torch.softmax(apply_flips(unlabel_logits, flip_mask), -1))
            metrics["uda"] = uda_loss
        if needs_iic:
            iic_losses = iic_regularization(projector, features, flip_mask, n_labeled,
                                            n_unlabeled, feature_names, paddings, patch_sizes,
                                            backend)
            iic_loss_val = sum(w * iic_losses[n] for n, w in zip(feature_names, importance))
            metrics["mi"] = -iic_loss_val
            for n in feature_names:
                metrics[f"individual_mis/{n}"] = -iic_losses[n]
        if mode == "uda":
            reg_loss = uda_loss
        elif mode == "iic":
            reg_loss = iic_loss_val
        elif mode == "udaiic":
            reg_loss = uda_weight * uda_loss + iic_weight * iic_loss_val
            total_weight = 1.0
        total = sup_loss + total_weight * reg_loss
        metrics["reg_loss"] = reg_loss
        metrics["total_loss"] = total
        total.backward()
        optimizer.step()

        with torch.no_grad():
            inter, union = dice_stats(label_logits.argmax(-1), labeled_target, num_classes)
        metrics["sup_dice_inter"] = inter
        metrics["sup_dice_union"] = union
        return {k: v.detach() for k, v in metrics.items()}

    return step


def build_eval_step(model: torch.nn.Module, *, num_classes: int):
    """Returns evaluate(image, target, mask) -> {loss, inter [1, C],
    union [1, C], pred}: one padded patient volume per call, dice sums pooled
    over its valid slices (volume dice)."""

    @torch.no_grad()
    def evaluate(image: torch.Tensor, target: torch.Tensor, mask: torch.Tensor):
        model.eval()
        logits = model(image)
        probs = torch.softmax(logits, -1)
        onehot = class2one_hot(target, num_classes, class_axis=-1)
        per_pixel = kl_div(probs, onehot, reduction="none")
        valid = mask.float()
        denom = valid.sum().clamp_min(1.0) * per_pixel.shape[1] * per_pixel.shape[2]
        loss = (per_pixel * valid[:, None, None]).sum() / denom
        pred = logits.argmax(-1)
        inter, union = dice_stats(pred, target, num_classes, mask=valid)
        return {"loss": loss, "inter": inter.sum(0, keepdim=True),
                "union": union.sum(0, keepdim=True), "pred": pred}

    return evaluate
