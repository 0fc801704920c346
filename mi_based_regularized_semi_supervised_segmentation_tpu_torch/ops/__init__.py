"""The port's ops: losses, IIC, displaced MI (the CUDA joint and fused
kernels behind ``iic_local``), flips, the on-card augmentation and
rotation, and the affine helpers. The kernel modules build their CUDA
libraries on first launch, not on import."""

from .affine import (
    affine_matrix,
    affine_transform,
    cutout,
    invert_affine_matrix,
    random_affine_matrix,
    random_cutout,
)
from .flips import apply_flips, sample_flip_mask
from .iic import compute_joint, iid_loss
from .iic_local import (
    displaced_joint,
    displaced_joint_xla,
    iid_segmentation_loss,
    iid_segmentation_small_patch_loss,
    mi_from_joint,
)
from .losses import entropy, jsd_div, kl_div, mse_consistency, simplex_cross_entropy, supcon_loss

__all__ = [
    "kl_div",
    "entropy",
    "simplex_cross_entropy",
    "jsd_div",
    "mse_consistency",
    "supcon_loss",
    "iid_loss",
    "compute_joint",
    "iid_segmentation_loss",
    "iid_segmentation_small_patch_loss",
    "displaced_joint",
    "displaced_joint_xla",
    "mi_from_joint",
    "sample_flip_mask",
    "apply_flips",
    "affine_matrix",
    "random_affine_matrix",
    "invert_affine_matrix",
    "affine_transform",
    "cutout",
    "random_cutout",
]
