from .acdc import ACDCDataset, ACDCSemiInterface, create_val_split, train_test_split
from .augment import ACDCStrongTransforms, PairedTransform, TwiceTransform
from . import native, pil_augment
from .sampler import InfiniteRandomSampler, PatientSampler, ContrastBatchSampler
from .loader import SegmentationLoader, PatientEvalLoader, TwiceLoader, get_dataloaders, create_val_loader
from .synthetic import generate_synthetic_acdc

__all__ = [
    "ACDCDataset",
    "ACDCSemiInterface",
    "create_val_split",
    "train_test_split",
    "ACDCStrongTransforms",
    "PairedTransform",
    "TwiceTransform",
    "native",
    "pil_augment",
    "InfiniteRandomSampler",
    "PatientSampler",
    "ContrastBatchSampler",
    "TwiceLoader",
    "SegmentationLoader",
    "PatientEvalLoader",
    "get_dataloaders",
    "create_val_loader",
    "generate_synthetic_acdc",
]
