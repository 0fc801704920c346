"""Headless volume viewer — the reference's 3-D slice viewer re-expressed
for batch environments (WHEEL::deepclustering2/viewer/Viewer.py
Multi_Slice_Viewer + realtime_viewer.multi_slice_viewer_debug). A copy of
the JAX package's ``utils/viewer.py`` for the PyTorch port. The reference's
tool is an interactive matplotlib/pyqtgraph scroller; training hosts and CI
have no display, so the same grouping/overlay logic renders to PNG mosaics
instead: one figure per patient volume, slices in a grid, masks overlaid
with a zero-transparent colormap (the reference's
cmap(zero_transparent=True)). matplotlib is imported on first use only.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np


def zero_transparent_cmap(name: str = "viridis"):
    """Colormap whose 0-bin is fully transparent (Viewer.py:cmap)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    base = plt.get_cmap(name)
    colors = base(np.arange(base.N))
    colors[0, -1] = 0.0
    return ListedColormap(colors)


def group_slices(folder: str, pattern: str = r"(patient\d+_\d+)") -> Dict[str, List[Path]]:
    """Group slice PNGs by the patient id embedded in their stem (the
    Viewer's --group_pattern behavior)."""
    groups: Dict[str, List[Path]] = {}
    for p in sorted(Path(folder).glob("*.png")):
        m = re.search(pattern, p.stem)
        key = m.group(1) if m else p.stem
        groups.setdefault(key, []).append(p)
    return groups


def save_volume_mosaic(
    images: np.ndarray,
    masks: Optional[Sequence[np.ndarray]] = None,
    out_path: str = "volume.png",
    cols: int = 5,
    cmap_name: str = "viridis",
    alpha: float = 0.5,
    titles: Optional[Sequence[str]] = None,
) -> str:
    """images: [S, H, W] float/uint volume; masks: optional list of [S, H, W]
    int maps overlaid zero-transparent. Writes a grid PNG; returns path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    images = np.asarray(images)
    S = images.shape[0]
    cols = max(1, min(cols, S))
    rows = (S + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 2.2 * rows))
    axes = np.atleast_1d(axes).reshape(-1)
    cmap = zero_transparent_cmap(cmap_name)
    for i in range(len(axes)):
        ax = axes[i]
        ax.axis("off")
        if i >= S:
            continue
        ax.imshow(images[i], cmap="gray", interpolation="nearest")
        if masks is not None:
            for mask in masks:
                ax.imshow(np.asarray(mask)[i], cmap=cmap, alpha=alpha,
                          interpolation="nearest",
                          vmin=0, vmax=max(int(np.max(mask)), 1))
        if titles is not None and i < len(titles):
            ax.set_title(str(titles[i]), fontsize=6)
    fig.tight_layout(pad=0.2)
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return str(out)


def render_folder(
    img_folder: str,
    gt_folders: Sequence[str] = (),
    out_dir: str = "viewer_out",
    pattern: str = r"(patient\d+_\d+)",
    cols: int = 5,
) -> List[str]:
    """Batch mode over the reference's on-disk layout (<run>/img/*.png +
    prediction folders): one mosaic per patient. Returns written paths."""
    from PIL import Image

    outs = []
    groups = group_slices(img_folder, pattern)
    for patient, paths in groups.items():
        imgs = np.stack([np.asarray(Image.open(p)) for p in paths])
        masks = []
        for gt in gt_folders:
            gt_paths = [Path(gt) / p.name for p in paths]
            if all(q.exists() for q in gt_paths):
                masks.append(np.stack([np.asarray(Image.open(q))
                                       for q in gt_paths]))
        outs.append(save_volume_mosaic(
            imgs, masks or None,
            out_path=str(Path(out_dir) / f"{patient}.png"), cols=cols,
            titles=[p.stem for p in paths]))
    return outs
