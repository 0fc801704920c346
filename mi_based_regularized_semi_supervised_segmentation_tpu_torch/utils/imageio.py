"""PNG dumps of inference (counterpart of the JAX package's
``utils/imageio.py``): the input slice under ``img/``, its ground truth under
``gt/`` and the prediction under ``pred/`` of a run directory, one PNG per
slice named by its filename stem."""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np


def _save_png(arr: np.ndarray, path: Path) -> None:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(str(path))


def write_img_target(images: np.ndarray, targets: np.ndarray, save_dir: str,
                     filenames: Sequence[str]) -> None:
    """images: [N, H, W, 1] float in [0, 1]; targets: [N, H, W] int."""
    for i, name in enumerate(filenames[: len(images)]):
        img = np.clip(images[i, ..., 0] * 255.0, 0, 255).astype(np.uint8)
        _save_png(img, Path(save_dir) / "img" / f"{name}.png")
        _save_png(targets[i].astype(np.uint8), Path(save_dir) / "gt" / f"{name}.png")


def write_predict(preds: np.ndarray, save_dir: str, filenames: Sequence[str]) -> None:
    """preds: [N, H, W] int label maps."""
    for i, name in enumerate(filenames[: len(preds)]):
        _save_png(preds[i].astype(np.uint8), Path(save_dir) / "pred" / f"{name}.png")
