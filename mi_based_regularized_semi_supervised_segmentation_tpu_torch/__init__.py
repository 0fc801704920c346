"""PyTorch / CUDA port of the MI-regularized semi-supervised segmentation
framework, for an NVIDIA H100.

It mirrors the JAX package ``mi_based_regularized_semi_supervised_segmentation_tpu``
module by module: a 2D U-Net trained on ACDC slices with a small labeled
fraction, regularized by UDA softmax consistency between flipped twin views and
IIC mutual information over cluster heads at U-Net feature taps. The
displaced-MI joint of the local IIC term runs as a hand-written CUDA kernel
(``csrc/mi_joint.cu``, bound in ``ops/mi_joint.py``), and so does the 3-shear
rotation of the on-device augmentation (``csrc/rotate.cu``, ``ops/rotate.py``;
``Trainer.device_data: true``, ``Kernel.geometry: shear``). The port imports
neither JAX nor the JAX package; entry points run on ``cuda`` unless the caller
asks for ``cpu``.
"""

import os
from pathlib import Path

PROJECT_PATH = str(Path(__file__).resolve().parents[1])
# DATA_PATH = <repo>/.data unless MISST_DATA_PATH says otherwise
DATA_PATH = os.environ.get("MISST_DATA_PATH", str(Path(PROJECT_PATH) / ".data"))

__version__ = "0.1.0"
