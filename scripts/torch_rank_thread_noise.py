#!/usr/bin/env python3
"""How far the CPU rank tests' summed gradients stand from their bound, and
how far the one-process reference moves with the intra-op thread count.

    python scripts/torch_rank_thread_noise.py

Runs the step cases of tests/test_torch_distributed.py (udaiic at W = 2 and
3, meanteacher and entropy at W = 3, the device-data step at W = 2) and of
tests/test_torch_pretrain_distributed.py (the pretrain encoder, decoder and
finetune steps) on gloo ranks, as the tests do, then the one-process
references at 1 and at 8 threads. Prints, for each case, the worst
deviation of a summed gradient as a share of its tensor's largest entry
(the tests' bound is 1e-3): the ranks against each reference, the float64
reference at 1 against 8 threads, and (the semi steps) the same step in fp32
at 1 against 8 threads.
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_distributed as semi  # noqa: E402
import test_torch_pretrain_distributed as pre  # noqa: E402

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (  # noqa: E402
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun import (  # noqa: E402
    run_ranks,
)

SEMI = {2: ("udaiic", "device"), 3: ("udaiic", "meanteacher", "entropy")}
PRETRAIN = {2: (("encoder", 5), ("decoder", 5), ("finetune", 3), ("finetune_mt", 3)),
            3: (("encoder", 6), ("decoder", 6))}


def worst(ref: dict, got: dict) -> float:
    return max(float((got["grads"][k] - g).abs().max()) / max(float(g.abs().max()), 1e-30)
               for k, g in ref["grads"].items())


def _device_reference(root: str, f64: bool) -> dict:
    """The one-process device-data step on the ranks' draws (as the test)."""
    store = semi._store(root)
    lab_idx, unlab_idx = torch.tensor(semi.LAB_IDX), torch.tensor(semi.UNLAB_IDX)
    draws = semi._device_draws(store, lab_idx, torch.tensor(semi._pad(semi.UNLAB_IDX, 4)),
                               semi.CROP)
    draws["unlabeled"] = {k: None if v is None else v[:semi.BU]
                          for k, v in draws["unlabeled"].items()}
    model, proj, teacher, step = semi._build("udaiic", data_store=store, classes=4, f64=f64)
    _, flips = semi._batch()
    metrics = step({"labeled_indices": lab_idx, "unlabeled_indices": unlab_idx},
                   flip_mask=torch.from_numpy(flips), aug_params=draws)
    return semi._state(model, proj, teacher, metrics)


def _semi_reference(name: str, root: str, f64: bool) -> dict:
    if name == "device":
        return _device_reference(root, f64)
    batch, flips = semi._batch()
    model, proj, teacher, step = semi._build(name, f64=f64)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   flip_mask=torch.from_numpy(flips))
    return semi._state(model, proj, teacher, metrics)


def _rank_cases(ctx, root: str) -> dict:
    out = {name: (semi._device_step(ctx, root) if name == "device"
                  else semi._step_case(ctx, name)) for name in SEMI[ctx.world]}
    out.update({f"pretrain {phase}": pre._run(ctx, phase, n) for phase, n in PRETRAIN[ctx.world]})
    return out


def _report(world: int, root: str) -> None:
    ranks = run_ranks(_rank_cases, world, root, timeout=300)
    refs, fp32 = {}, {}
    for threads in (1, 8):
        torch.set_num_threads(threads)
        refs[threads] = {name: _semi_reference(name, root, True) for name in SEMI[world]}
        refs[threads].update({f"pretrain {phase}": pre._run(None, phase, n)
                              for phase, n in PRETRAIN[world]})
        fp32[threads] = {name: _semi_reference(name, root, False) for name in SEMI[world]}
    for name in refs[1]:
        line = (f"W={world} {name}: ranks vs float64 reference at 1 / 8 threads "
                f"{max(worst(refs[1][name], r[name]) for r in ranks):.3g} / "
                f"{max(worst(refs[8][name], r[name]) for r in ranks):.3g}; "
                f"float64 reference 1 vs 8 threads {worst(refs[8][name], refs[1][name]):.3g}")
        if name in fp32[1]:
            line += f"; fp32 reference 1 vs 8 threads {worst(fp32[8][name], fp32[1][name]):.3g}"
        print(line, flush=True)


def main() -> None:
    with tempfile.TemporaryDirectory() as root:
        generate_synthetic_acdc(root, num_train_patients=6, num_val_patients=2,
                                slices_per_patient=4, size=64)
        for world in (2, 3):
            _report(world, root)


if __name__ == "__main__":
    main()
