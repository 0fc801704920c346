from .unet import UNet, UNET_DIMENSIONS, ENCODER_NAMES, DECODER_NAMES, COMPONENT_NAMES, TAP_NAMES
from .heads import (
    ClusterHead,
    LocalClusterHead,
    LocalProjectionHead,
    ProjectionHead,
    ProjectorWrapper,
    group_softmax_flat,
    split_feature_names,
)

__all__ = [
    "UNet",
    "UNET_DIMENSIONS",
    "ENCODER_NAMES",
    "DECODER_NAMES",
    "COMPONENT_NAMES",
    "TAP_NAMES",
    "ClusterHead",
    "LocalClusterHead",
    "LocalProjectionHead",
    "ProjectionHead",
    "ProjectorWrapper",
    "group_softmax_flat",
    "split_feature_names",
]
