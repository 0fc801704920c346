from .unet import UNet, UNET_DIMENSIONS, ENCODER_NAMES, DECODER_NAMES, TAP_NAMES
from .heads import ClusterHead, LocalClusterHead, ProjectorWrapper, group_softmax_flat

__all__ = [
    "UNet",
    "UNET_DIMENSIONS",
    "ENCODER_NAMES",
    "DECODER_NAMES",
    "TAP_NAMES",
    "ClusterHead",
    "LocalClusterHead",
    "ProjectorWrapper",
    "group_softmax_flat",
]
