#!/usr/bin/env python3
"""The headline udaiic step's sensitivity to a 1e-7 relative change of its
input images, on the CPU: the floor under any comparison of two runs of the
same step that sum in another order (ranks against one process, card against
CPU).

    python scripts/torch_step_noise.py --crop 224
    python scripts/torch_step_noise.py --crop 32 --clusters 5 --subheads 2

Two steps from the weights of seed 0 (U-Net 1 -> 4, taps Conv5 / Up_conv3 /
Up_conv2, paddings [1, 3], Adam at 1e-3) on a 4 + 10 random batch and on the
same batch times 1 + 1e-7, with one flip mask. Prints one JSON line: the
losses' relative differences, the share of parameter elements whose Adam
move differs by more than 0.05 lr, and the worst tensors' relative L2
gradient differences (with their gradient norms).
"""

from __future__ import annotations

import argparse
import json
import sys
from itertools import chain
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (  # noqa: E402
    build_optimizer,
    build_train_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (  # noqa: E402
    ProjectorWrapper,
    UNet,
)

LR = 1e-3
FEATS = ("Conv5", "Up_conv3", "Up_conv2")


def one_step(batch, flips, clusters: int, subheads: int):
    torch.manual_seed(0)
    model = UNet(1, 4)
    proj = ProjectorWrapper(FEATS, num_clusters=clusters, num_subheads=subheads)
    params = list(chain(model.named_parameters(), proj.named_parameters(prefix="proj")))
    opt = build_optimizer([p for _, p in params], {"name": "Adam", "lr": LR,
                                                  "weight_decay": 1e-5})
    step = build_train_step(model, opt, "udaiic", num_classes=4, generator=torch.Generator(),
                            feature_names=FEATS, feature_importance=[1.0, 0.5, 0.5],
                            projector=proj, uda_weight=10.0, iic_weight=0.1, reg_weight=1.0,
                            paddings=[1, 3], patch_sizes=1024)
    before = {k: p.detach().clone() for k, p in params}
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   flip_mask=torch.from_numpy(flips))
    return ({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
            {k: p.detach() - before[k] for k, p in params},
            {k: p.grad.detach().clone() for k, p in params})


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--crop", type=int, default=224)
    parser.add_argument("--clusters", type=int, default=20)
    parser.add_argument("--subheads", type=int, default=5)
    args = parser.parse_args(argv)
    rng = np.random.default_rng(0)
    c = args.crop
    batch = {"labeled_image": rng.random((4, c, c, 1), dtype=np.float32),
             "labeled_target": rng.integers(0, 4, (4, c, c)).astype(np.int32),
             "unlabeled_image": rng.random((10, c, c, 1), dtype=np.float32)}
    flips = rng.random((10, 2)) < 0.8
    nudged = {k: v * np.float32(1 + 1e-7) if v.dtype == np.float32 else v
              for k, v in batch.items()}
    (l1, m1, g1), (l2, m2, g2) = (one_step(b, flips, args.clusters, args.subheads)
                                  for b in (batch, nudged))
    moves = torch.cat([(m2[k] - m).abs().flatten() for k, m in m1.items()])
    grads = sorted(((float((g2[k] - g).norm() / g.norm()), k, float(g.norm()))
                    for k, g in g1.items() if float(g.norm()) > 0), reverse=True)
    print(json.dumps({
        "crop": c, "clusters": args.clusters, "subheads": args.subheads,
        "loss_rel_diff": {k: abs(l2[k] - v) / abs(v) for k, v in l1.items()},
        "move_loose_share": float((moves > 0.05 * LR).float().mean()),
        "move_max_diff": float(moves.max()),
        "grad_rel_l2_worst": [{"tensor": k, "rel_l2": r, "grad_norm": n}
                              for r, k, n in grads[:4]]}))


if __name__ == "__main__":
    main()
