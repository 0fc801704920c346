#!/usr/bin/env python3
"""Time the displaced-MI joint and fused kernels of two source trees of the
PyTorch port on one CUDA card, tree by tree in the order given (e.g. parent,
change, change, parent), each in a process of its own that builds the
tree's kernels into the tree's own ``build/``.

    python3 scripts/wide_joint_ab.py --trees .chip_trees/parent,.,.,.chip_trees/parent \\
        --out wide_ab.json

Per tree, at both decoder taps of the headline udaiic config (Up_conv2
[10, 230, 230] p = 3, Up_conv3 [10, 114, 114] p = 1): the joint's three
products (``mi_joint_fwd`` / ``mi_joint_bwd``, bf16 products) on fp32 and
bf16 probability maps at 128 lanes (5 x 20 clusters), at 150 lanes (5 x 30,
as the training path passes that head) and at 256 (150 live); the fused
kernels (``mi_fused_fwd`` / ``mi_fused_bwd``) on fp32 logits at 128 and 256
lanes. Each: the median of ``--reps`` CUDA-event timings of the wrapper
call, its device time a call (torch.profiler over ``--reps`` calls: steadier
than events on a 0.2 ms call), its ``LAUNCHES`` a call, and a SHA-256 of its
output on seeded inputs (equal digests: the same bits). Then ``main.main``
trains the udaiic host path at 5 x 30 clusters for ``--steps`` steps on
``Kernel.backend=auto`` (fp32 and bf16 compute) and on ``pallas_fused``
(fp32): the median step ms after the first, the joint's (or the fused
kernels') launches a step, and 3 more steps on one batch under the
profiler: device ms a step and the MI kernels' share. The card's name and
power limit are printed first. Imports no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

PORT = "mi_based_regularized_semi_supervised_segmentation_tpu_torch"
TAPS = (("Up_conv2", 10, 224, 3), ("Up_conv3", 10, 112, 1))
SUBHEADS = 5


def _ms(fn, reps: int) -> float:
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, reps: int) -> float:
    """Device time a call of ``fn``: every kernel the profiler records over
    ``reps`` calls, summed, divided by ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def _step_profile(trainer, steps: int = 3) -> dict:
    """Device ms a step over ``steps`` train steps on one host batch, and
    the displaced-MI kernels' part of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lab, unlab = next(zip(trainer._labeled_loader, trainer._unlabeled_loader))
    batch = {"labeled_image": trainer._to_device(lab["image"]),
             "labeled_target": trainer._to_device(lab["target"]),
             "unlabeled_image": trainer._to_device(unlab["image"])}
    trainer._train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    mi = ("joint_", "fused_", "wide_prep", "wide_vjp")
    return {"profiled_wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3 / steps,
            "mi_kernels_ms": sum(e.self_device_time_total for e in events
                                 if any(k in e.key for k in mi)) / 1e3 / steps}


def _digest(t) -> str:
    import torch

    raw = t.detach().contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode())


def _probs(gen, batch: int, edge: int, p: int, clusters: int, lanes: int):
    """Per-subhead softmax maps [N, lanes] on a zero border of width p, dead
    lanes from SUBHEADS * clusters on zero."""
    import torch

    hp = edge + 2 * p
    z = torch.randn((batch, hp, hp, SUBHEADS, clusters), generator=gen, device="cuda")
    x = torch.softmax(z, -1).reshape(batch, hp, hp, SUBHEADS * clusters)
    x = torch.nn.functional.pad(x, (0, lanes - SUBHEADS * clusters))
    valid = torch.zeros((1, hp, hp, 1), device="cuda")
    valid[:, p:hp - p, p:hp - p] = 1.0
    return (x * valid).reshape(-1, lanes).contiguous()


def _logits(gen, n: int, clusters: int, lanes: int):
    import torch

    live = SUBHEADS * clusters
    z = torch.full((n, lanes), torch.finfo(torch.float32).min, device="cuda")
    z[:, :live] = torch.randn((n, live), generator=gen, device="cuda")
    return z


def run_tree(reps: int, steps: int) -> dict:
    """This process's tree (first on sys.path): every timing of the module
    docstring, as one dict."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    mj = importlib.import_module(f"{PORT}.ops.mi_joint")
    mf = importlib.import_module(f"{PORT}.ops.mi_fused")
    build = importlib.import_module(f"{PORT}.ops.build")
    t0 = time.perf_counter()
    build.build(["mi_joint", "mi_fused"])
    out = {"tree": os.getcwd(), "build_s": time.perf_counter() - t0, "rows": []}
    gen = torch.Generator(device="cuda")

    def record(kind, tap, lanes, mode, name, fn, counter):
        counter.clear()
        got = fn()
        launches = sum(counter.values())
        out["rows"].append({"kind": kind, "tap": tap, "lanes": lanes, "mode": mode, "name": name,
                            "ms": _ms(fn, reps), "device_ms": _device_ms(fn, reps),
                            "launches_per_call": launches, "digest": _digest(got)})

    for tap, batch, edge, p in TAPS:
        hp = edge + 2 * p
        n, d = batch * hp * hp, (2 * p + 1) ** 2
        for lanes, clusters in ((128, 20), (SUBHEADS * 30, 30), (256, 30)):
            gen.manual_seed(_seed(tap, lanes))
            a, b = (_probs(gen, batch, edge, p, clusters, lanes) for _ in range(2))
            g = torch.randn((d, lanes, lanes), generator=gen, device="cuda") * 1e-3
            for mode, dtype in (("bf16", torch.float32), ("bf16in", torch.bfloat16)):
                ma, mb = a.to(dtype), b.to(dtype)
                for name, fn in (("fwd", lambda: mj.mi_joint_fwd(ma, mb, hp, p, True)),
                                 ("dx", lambda: mj.mi_joint_bwd(mb, g, hp, p, True, True)),
                                 ("dx_tf", lambda: mj.mi_joint_bwd(ma, g, hp, p, False, True))):
                    record("joint", tap, lanes, mode, name, fn, mj.LAUNCHES)
            del a, b, g, ma, mb
        for lanes, clusters in ((128, 20), (256, 30)):
            gen.manual_seed(_seed(tap, "fused", lanes))
            l1, l2 = (_logits(gen, n, clusters, lanes) for _ in range(2))
            g = torch.randn((d, lanes, lanes), generator=gen, device="cuda") * 1e-3
            args = (hp, hp, p, SUBHEADS, clusters, 1.0)
            for name, fn in (
                    ("fwd", lambda: mf.mi_fused_fwd(l1, l2, *args)),
                    ("dl2", lambda: mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False)),
                    ("dl1", lambda: mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True))):
                record("fused", tap, lanes, "bf16", name, fn, mf.LAUNCHES)
            del l1, l2, g
        torch.cuda.empty_cache()
    if steps:
        main_mod = importlib.import_module(f"{PORT}.main")
        bf16 = ("Precision.compute_dtype=bfloat16", "Precision.bn_dtype=bfloat16")
        for tag, backend, more in (("train_wide_auto_fp32", "auto", ()),
                                   ("train_wide_auto_bf16", "auto", bf16),
                                   ("train_fused_wide_fp32", "pallas_fused", ())):
            mj.reset_launch_counts()
            mf.reset_launch_counts()
            trainer = main_mod.main([
                "Data.synthetic=true", "Data.labeled_data_ratio=0.25",
                "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
                f"Trainer.num_batches={steps}", "Trainer.max_epoch=1", "Trainer.device=cuda",
                f"Kernel.backend={backend}", "IICRegParameters.DecoderParams.num_clusters=30",
                f"Trainer.save_dir=wide_ab_{tag}", "Trainer.step_timing=true", *more])
            out[tag] = {"median_step_ms": statistics.median(trainer.step_times_ms[1:]),
                        "step_ms": trainer.step_times_ms,
                        "mi_launches_per_step": (sum(mj.LAUNCHES.values())
                                                 + sum(mf.LAUNCHES.values())) / steps,
                        **_step_profile(trainer)}
            del trainer
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--trees", default=".", help="comma-separated tree roots, in order")
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--steps", type=int, default=8)
    parser.add_argument("--out", default="")
    parser.add_argument("--run", default="", help=argparse.SUPPRESS)  # one tree, in this process
    args = parser.parse_args(argv)
    if args.run:
        root = str(Path(args.run).resolve())
        os.chdir(root)
        sys.path.insert(0, root)
        print(json.dumps(run_tree(args.reps, args.steps)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("wide_joint_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for tree in args.trees.split(","):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--run", tree,
                               "--reps", str(args.reps), "--steps", str(args.steps)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return proc.returncode
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps({"tree": tree, "build_s": runs[-1]["build_s"]}), flush=True)
    # one line a measurement: each run's ms in the order of --trees
    table = {}
    for i, run in enumerate(runs):
        for r in run["rows"]:
            key = f"{r['kind']}/{r['tap']}/{r['lanes']}/{r['mode']}/{r['name']}"
            entry = table.setdefault(key, {"ms": [], "device_ms": [], "launches_per_call": [],
                                           "digest": []})
            for k in entry:
                entry[k].append(r[k])
        for key in ("train_wide_auto_fp32", "train_wide_auto_bf16", "train_fused_wide_fp32"):
            if key in run:
                entry = table.setdefault(key, {k: [] for k in (
                    "median_step_ms", "mi_launches_per_step", "profiled_wall_ms", "device_ms",
                    "mi_kernels_ms")})
                for k in entry:
                    entry[k].append(run[key][k])
    for key, entry in table.items():
        print(json.dumps({"key": key, **entry}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"nvidia_smi": smi, "trees": args.trees.split(","),
                                              "table": table, "runs": runs}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
