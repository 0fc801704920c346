#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels --reps 20

Phases, each printing JSON lines:
  device   the card's name and power limit (nvidia-smi, also printed raw)
  build    compile every CUDA source of the port with nvcc (sm_90a)
  kernels  each kernel launch of the training path against its plain PyTorch
           version, at both decoder-tap shapes of the headline config:
           exactly on small-integer inputs (all sums exact in fp32), and
           within TOL on probability maps in bf16 and fp32 operand modes;
           times by CUDA events (median), beside the plain version, one
           PyTorch library call of the same function and the card's bound.
           Then the two rotation kernels at the device path's shapes (4 and
           10 slices of 256^2): bit-exact against their plain versions, the
           single-pass rotation against the three-roll one, identity at 0
  step     one small udaiic train step on the card against the same step on
           the CPU (plain joint), same weights, batch and flip mask
  step_device  the same on the device-data path with geometry=shear: the
           same store, injected augmentation draws and flip mask
  train    the headline udaiic trainer through ``main.main`` on synthetic data
           (U-Net 16..256, 224^2 crops, 4 labeled + 10 unlabeled, taps Conv5 /
           Up_conv3 / Up_conv2, 5 x 20 clusters, paddings [1, 3]), with the
           kernel launch counts of that run, set to 0 just before it
  train_device  the same trainer on the device-data path
           (Trainer.device_data=true, 8 steps in chunks of 4), once with
           Kernel.geometry=shear (the rotation kernel, 3 launches a step) and
           once with the default fused geometry; counts set to 0 before each
  profile  device time by kernel and by kind over a few more steps of the host
           path's trainer and of the device path's (shear) trainer
           (torch.profiler), and the device's busy share of the wall

The line before the last is the JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. A failed check raises, and the script exits
non-zero without printing a result. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from importlib import import_module
from itertools import chain
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM
PEAK_FLOPS = {"bf16": 989e12,       # dense tensor cores
              "fp32": 67e12}        # CUDA cores
PORT = "mi_based_regularized_semi_supervised_segmentation_tpu_torch"
JAX_KERNELS = "mi_based_regularized_semi_supervised_segmentation_tpu/ops/pallas/mi_joint.py"
JAX_ROTATE = "mi_based_regularized_semi_supervised_segmentation_tpu/ops/pallas/rotate.py"
# the device path's rotations: (label, slices, edge) of the 256^2 synthetic store
ROTATIONS = (("labeled", 4, 256), ("unlabeled", 10, 256))
# decoder taps of the headline udaiic config: (name, batch, map edge, padding)
TAPS = (("Up_conv2", 10, 224, 3), ("Up_conv3", 10, 112, 1))
LANES, SUBHEADS, CLUSTERS = 128, 5, 20
# max |kernel - plain| / max |plain| on probability maps. Both sides sum the
# same fp32 products in different orders: the forward's accumulators run over
# up to ~24k rows each (tensor-core accumulation, then a chunk sum), so the
# largest of ~800k joint entries drifts by ~1e-4 of the largest entry.
TOL = 5e-4
STEPS_TOL = 1e-3     # step phase: card vs CPU losses (relative)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def port(module: str):
    return import_module(f"{PORT}.{module}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time per call: the summed time of every kernel that ``reps``
    calls of ``fn`` launch (torch.profiler), divided by ``reps``. For
    kernels of a few microseconds, where CUDA events around a call measure
    the host's launch overhead instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    check(total > 0, "the profiler saw no device time")
    return total / 1e3 / reps


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    smi = nvidia_smi()
    print(smi, flush=True)
    info = {"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda, "name": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}
    emit(info)
    return info


def phase_build() -> None:
    build = port("ops.build")
    sources = sorted(p.stem for p in build.SOURCE_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    paths = build.build(sources)
    ptxas = {name: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
             for name, log in build.build_logs.items()}
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v) for k, v in paths.items()}, "ptxas": ptxas})


def _tap_inputs(batch: int, edge: int, padding: int, gen):
    """Probabilities as the training path feeds the joint: per-subhead
    softmax in 100 of 128 lanes, dead lanes 0, a zero border of width p."""
    import torch

    hp = edge + 2 * padding
    z = torch.randn((batch, hp, hp, SUBHEADS, CLUSTERS), generator=gen, device="cuda")
    probs = torch.softmax(z, -1).reshape(batch, hp, hp, SUBHEADS * CLUSTERS)
    probs = torch.nn.functional.pad(probs, (0, LANES - SUBHEADS * CLUSTERS))
    valid = torch.zeros((1, hp, hp, 1), device="cuda")
    valid[:, padding:hp - padding, padding:hp - padding] = 1.0
    return (probs * valid).reshape(-1, LANES).contiguous()


def _exact_check(mj, n: int, wp: int, p: int, gen) -> None:
    """Small integers are exact in bf16, and every sum stays below 2^24, so
    the kernel must equal the plain version bit for bit in both modes: a
    missing, doubled or misplaced row or displacement shows here."""
    import torch

    d = (2 * p + 1) ** 2
    a = torch.randint(0, 2, (n, LANES), generator=gen, device="cuda").float()
    b = torch.randint(0, 2, (n, LANES), generator=gen, device="cuda").float()
    g = torch.randint(-2, 3, (d, LANES, LANES), generator=gen, device="cuda").float()
    ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ref = mj.displaced_joint_plain_flat(ap, bp, wp, p)
    ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), g)
    ref = ref.detach()
    for bf16 in (True, False):
        got = {"fwd": (mj.mi_joint_fwd(a, b, wp, p, bf16), ref),
               "dx": (mj.mi_joint_bwd(b, g, wp, p, True, bf16), ref_da),
               "dx_tf": (mj.mi_joint_bwd(a, g, wp, p, False, bf16), ref_db)}
        for what, (x, y) in got.items():
            err = float((x - y).abs().max())
            check(err == 0.0, f"exact {what} p={p} bf16={bf16}: max err {err}")


def phase_kernels(reps: int) -> list:
    import torch
    import torch.nn.functional as F

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    replaces = {mj.FWD: f"{JAX_KERNELS}:178", mj.BWD_DX_TF: f"{JAX_KERNELS}:230",
                mj.BWD_DX: f"{JAX_KERNELS}:249"}
    rows = []
    for tap, batch, edge, p in TAPS:
        hp = edge + 2 * p
        d = (2 * p + 1) ** 2
        n = batch * hp * hp
        _exact_check(mj, n, hp, p, gen)
        emit({"phase": "kernels", "tap": tap, "exact_check": "passed", "shape": [n, LANES]})
        a = _tap_inputs(batch, edge, p, gen)
        b = _tap_inputs(batch, edge, p, gen)
        c = LANES
        g = torch.randn((d, c, c), generator=gen, device="cuda") * 1e-3
        flops = 2.0 * n * c * c * d
        nbytes = 4.0 * (2 * n * c + d * c * c)  # fwd: A, B in, J out; bwd: S, g in, [N, C] out
        for mode in ("bf16", "fp32"):
            bf16 = mode == "bf16"
            dot = torch.bfloat16 if bf16 else torch.float32
            ar, br, gr = (t.to(dot).float() for t in (a, b, g))
            ap, bp = ar.clone().requires_grad_(True), br.clone().requires_grad_(True)
            ref = mj.displaced_joint_plain_flat(ap, bp, hp, p)
            ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), gr, retain_graph=True)
            nchw = lambda t: t.reshape(batch, hp, hp, c).permute(0, 3, 1, 2).to(dot)
            w = g.reshape(2 * p + 1, 2 * p + 1, c, c)
            cases = {
                mj.FWD: dict(
                    kernel=lambda: mj.mi_joint_fwd(a, b, hp, p, bf16),
                    plain=lambda: mj.displaced_joint_plain_flat(ar, br, hp, p),
                    want=ref.detach(),
                    # the original project's joint: clusters as channels, the
                    # B maps as one Hp x Wp filter per cluster
                    library=lambda: F.conv2d(nchw(a).transpose(0, 1), nchw(b).transpose(0, 1),
                                             padding=p),
                    unpack=lambda o: o.permute(2, 3, 0, 1).reshape(d, c, c)),
                mj.BWD_DX: dict(
                    kernel=lambda: mj.mi_joint_bwd(b, g, hp, p, True, bf16),
                    plain=lambda: torch.autograd.grad(ref, ap, gr, retain_graph=True),
                    want=ref_da,
                    # dx = B correlated with flipped g: a (2p+1)^2 C->C conv
                    library=lambda: F.conv2d(nchw(b), w.flip(0, 1).permute(2, 3, 0, 1).to(dot),
                                             padding=p),
                    unpack=lambda o: o.permute(0, 2, 3, 1).reshape(n, c)),
                mj.BWD_DX_TF: dict(
                    kernel=lambda: mj.mi_joint_bwd(a, g, hp, p, False, bf16),
                    plain=lambda: torch.autograd.grad(ref, bp, gr, retain_graph=True),
                    want=ref_db,
                    library=lambda: F.conv2d(nchw(a), w.permute(3, 2, 0, 1).to(dot), padding=p),
                    unpack=lambda o: o.permute(0, 2, 3, 1).reshape(n, c)),
            }
            for name, case in cases.items():
                got = case["kernel"]()
                want = case["want"]
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(math.isfinite(err) and err <= TOL * scale,
                      f"{tap} {mode} {name}: max err {err} vs max |ref| {scale}")
                lib_err = float((case["unpack"](case["library"]()).float() - want).abs().max())
                by_ops = flops / PEAK_FLOPS[mode] >= nbytes / HBM_BYTES_PER_S
                row = {"phase": "kernels", "name": name, "tap": tap, "label": tap, "mode": mode,
                       "route": "cuda", "source": f"{PORT}/csrc/mi_joint.cu",
                       "replaces": replaces[name], "shape": [n, c], "padding": p,
                       "max_abs_err": err, "max_abs_ref": scale, "tol_rel": TOL,
                       "ms": cuda_ms(case["kernel"], reps),
                       "plain_ms": cuda_ms(case["plain"], max(3, reps // 3), warmup=1),
                       "library_ms": cuda_ms(case["library"], max(3, reps // 3), warmup=1),
                       "library_rel_err": lib_err / scale,
                       "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[mode]) * 1e3,
                       "bound_by": "operations" if by_ops else "bytes",
                       "gflop": flops / 1e9}
                row["achieved_tflops"] = flops / (row["ms"] * 1e-3) / 1e12
                emit(row)
                rows.append(row)
            del ap, bp, ref, ref_da, ref_db, cases
        del a, b, g
        torch.cuda.empty_cache()
    return rows


def phase_kernels_rotate(reps: int) -> list:
    """rotate_shear and lane_roll_rows at the device path's shapes: each
    bit-exact against its plain version on the same tables (the rotation is a
    pixel permutation, so nothing may differ), rotate_shear bit-exact against
    rotate_shear_lanes, identity at angle 0."""
    import torch

    rot = port("ops.rotate")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for label, batch, edge in ROTATIONS:
        x = torch.randint(0, 256, (batch, edge, edge), generator=gen, device="cuda").float()
        ang = torch.rand(batch, generator=gen, device="cuda") * 90.0 - 45.0
        tables = rot.shear_tables(ang, edge, edge)
        tables_l = rot.shear_tables(ang, edge, edge, lane_aligned_rows=True)
        _, _, geom = tables
        _, _, geom_l = tables_l
        got = rot.rotate_shear(x, ang, tables=tables)
        want = rot.rotate_shear_plain(x, ang, tables=tables)
        err = float((got - want).abs().max())
        check(err == 0.0, f"rotate_shear {label}: max err {err} vs plain")
        lanes = rot.rotate_shear_lanes(x, ang, tables=tables_l)
        check(bool(torch.equal(lanes, got)), f"rotate_shear vs rotate_shear_lanes {label}")
        zero = torch.zeros_like(ang)
        check(bool(torch.equal(rot.rotate_shear(x, zero), x))
              and bool(torch.equal(rot.rotate_shear_lanes(x, zero), x)), f"identity {label}")
        s_x = tables_l[0]
        canvas = rot._pad_canvas(x, geom_l)
        roll_err = float((rot.lane_roll_rows(canvas, s_x)
                          - rot.lane_roll_rows_plain(canvas, s_x)).abs().max())
        check(roll_err == 0.0, f"lane_roll_rows {label}: max err {roll_err} vs plain")
        # library yardstick: one torch.gather over the flattened input with the
        # composite source index precomputed (the same permutation); the index
        # comes from rotating 1..H*W (exact in fp32), 0 meaning outside
        n = edge * edge
        ids = torch.arange(1, n + 1, device="cuda", dtype=torch.float32).reshape(1, edge, edge)
        src = rot.rotate_shear(ids.expand(batch, -1, -1).contiguous(), ang, tables=tables)
        src = torch.where(src > 0, src - 1, torch.full_like(src, n)).long().reshape(batch, n)
        x_ext = torch.cat([x.reshape(batch, n), torch.zeros((batch, 1), device="cuda")], 1)
        library = lambda: torch.gather(x_ext, 1, src)
        check(bool(torch.equal(library().reshape(batch, edge, edge), got)),
              f"gather yardstick {label}")
        roll_src = torch.remainder(torch.arange(geom_l[3], device="cuda")[None, None, :]
                                   - s_x[:, :, None].long(), geom_l[3])
        roll_library = lambda: torch.gather(canvas, 2, roll_src)
        hc, wc = geom[2], geom[3]
        rot_bytes = 4.0 * (2 * batch * n + batch * (hc + wc))   # in, out, tables
        roll_bytes = 4.0 * (2 * canvas.numel() + s_x.numel())
        plain_reps = max(3, reps // 3)
        for name, nbytes, kernel, plain, lib_fn, shape, extra in (
                (rot.ROTATE, rot_bytes, lambda: rot.rotate_shear(x, ang, tables=tables),
                 lambda: rot.rotate_shear_plain(x, ang, tables=tables), library,
                 [batch, edge, edge],
                 {"canvas": [hc, wc], "with_tables_device_ms":
                  device_ms(lambda: rot.rotate_shear(x, ang), reps)}),
                (rot.ROLL, roll_bytes, lambda: rot.lane_roll_rows(canvas, s_x),
                 lambda: rot.lane_roll_rows_plain(canvas, s_x), roll_library,
                 list(canvas.shape),
                 {"rotate_shear_lanes_device_ms": device_ms(
                     lambda: rot.rotate_shear_lanes(x, ang, tables=tables_l), reps)})):
            row = {"phase": "kernels", "name": name, "label": f"{label} B={batch}",
                   "route": "cuda", "source": f"{PORT}/csrc/rotate.cu",
                   "replaces": f"{JAX_ROTATE}:138" if name == rot.ROTATE else f"{JAX_ROTATE}:161",
                   "shape": shape, "batch": batch, "max_abs_err": err if name == rot.ROTATE
                   else roll_err, "timing": "device time per call (torch.profiler)",
                   "ms": device_ms(kernel, reps), "plain_ms": device_ms(plain, plain_reps),
                   "library_ms": device_ms(lib_fn, plain_reps),
                   "call_ms": cuda_ms(kernel, reps),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "mbytes": nbytes / 1e6, **extra}
            row["achieved_gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
            emit(row)
            rows.append(row)
        del x, canvas, src, x_ext, roll_src
        torch.cuda.empty_cache()
    return rows


def phase_step() -> None:
    """One udaiic step (crop 32, 2 + 3 slices, 3 classes, 2 x 5 clusters,
    paddings [1, 3]) on the card and on the CPU from the same weights."""
    import numpy as np
    import torch

    models, optim, steps, mj = port("models"), port("engine.optim"), port("engine.steps"), \
        port("ops.mi_joint")
    feats = ["Conv5", "Up_conv3", "Up_conv2"]
    rng = np.random.default_rng(0)
    batch_np = {"labeled_image": rng.random((2, 32, 32, 1), dtype=np.float32),
                "labeled_target": rng.integers(0, 3, (2, 32, 32)),
                "unlabeled_image": rng.random((3, 32, 32, 1), dtype=np.float32)}
    flip_mask = torch.from_numpy(rng.random((3, 2)) < 0.8)
    results = {}
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        model = models.UNet(1, 3)
        proj = models.ProjectorWrapper(feats, num_clusters=5, num_subheads=2)
        model.to(device)
        proj.to(device)
        params = list(chain(model.named_parameters(), proj.named_parameters(prefix="proj")))
        opt = optim.build_optimizer([p for _, p in params],
                                    {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
        gen = torch.Generator(device=device)
        step = steps.build_train_step(
            model, opt, "udaiic", num_classes=3, generator=gen, feature_names=feats,
            feature_importance=[1.0, 0.5, 0.5], projector=proj, uda_weight=10.0,
            iic_weight=0.1, reg_weight=1.0, paddings=[1, 3], patch_sizes=1024)
        before = {k: p.detach().cpu().clone() for k, p in params}
        mj.reset_launch_counts()
        metrics = step({k: torch.from_numpy(v).to(device) for k, v in batch_np.items()},
                       flip_mask=flip_mask)
        launches = sum(mj.LAUNCHES.values())
        results[device] = ({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
                           {k: p.detach().cpu() - before[k] for k, p in params}, launches)
    (l_cpu, d_cpu, n_cpu), (l_gpu, d_gpu, n_gpu) = results["cpu"], results["cuda"]
    check(n_cpu == 0 and n_gpu == 6, f"step launches cpu={n_cpu} cuda={n_gpu} (want 0, 6)")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"step losses differ: {rel}")
    # Adam's first step is ~ -lr * sign(g): where a gradient is near fp32
    # noise the two sides may step opposite ways (<= 2 lr); the bulk agrees
    diffs = np.concatenate([(d_gpu[k] - d_cpu[k]).abs().flatten().numpy() for k in d_cpu])
    loose = float(np.mean(diffs > 0.05 * 1e-3))
    check(diffs.max() <= 2.05e-3 and loose < 0.005, f"param deltas: max {diffs.max()}, "
          f"loose share {loose}")
    emit({"phase": "step", "losses_cpu": l_cpu, "losses_cuda": l_gpu, "rel_err": rel,
          "param_delta_max_diff": float(diffs.max()), "param_delta_loose_share": loose,
          "launches_cuda": n_gpu})


def phase_step_device() -> None:
    """One small device-data udaiic step (crop 32, 2 + 3 slices of a 64^2
    synthetic store, 4 classes, 2 x 5 clusters, paddings [1, 3]) with
    geometry=shear on the card and on the CPU: same weights, same store, the
    same injected augmentation draws and flip mask."""
    import numpy as np
    import torch

    models, optim, steps, mj, rot, data, dp = (
        port("models"), port("engine.optim"), port("engine.steps"), port("ops.mi_joint"),
        port("ops.rotate"), port("data"), port("data.device_pipeline"))
    aug_mod = port("ops.augment_device")
    root = Path(import_module(PORT).PROJECT_PATH) / "build" / "chip_smoke_small"
    data.generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                                 slices_per_patient=4, size=64)
    dataset = data.ACDCDataset(str(root), "train")
    feats = ["Conv5", "Up_conv3", "Up_conv2"]
    lab_idx, unlab_idx = np.array([1, 7]), np.array([0, 5, 9])
    cpu_store = dp.DeviceDataStore(dataset, pack=True)
    gen = torch.Generator().manual_seed(5)
    aug = {"labeled": aug_mod.sample_augment_params(
               gen, 2, cpu_store.shape, crop=32, valid_hw=cpu_store.valid_hw_dev[lab_idx],
               offsets=cpu_store.offsets_dev[lab_idx]),
           "unlabeled": aug_mod.sample_augment_params(
               gen, 3, cpu_store.shape, crop=32, valid_hw=cpu_store.valid_hw_dev[unlab_idx],
               offsets=cpu_store.offsets_dev[unlab_idx])}
    flip_mask = torch.rand((3, 2), generator=gen) < 0.8
    results = {}
    for device in ("cpu", "cuda"):
        store = cpu_store if device == "cpu" else dp.DeviceDataStore(dataset, device=device,
                                                                     pack=True)
        torch.manual_seed(0)
        model = models.UNet(1, 4)
        proj = models.ProjectorWrapper(feats, num_clusters=5, num_subheads=2)
        model.to(device)
        proj.to(device)
        opt = optim.build_optimizer(list(chain(model.parameters(), proj.parameters())),
                                    {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
        step = steps.build_train_step(
            model, opt, "udaiic", num_classes=4, generator=torch.Generator(device=device),
            feature_names=feats, feature_importance=[1.0, 0.5, 0.5], projector=proj,
            uda_weight=10.0, iic_weight=0.1, reg_weight=1.0, paddings=[1, 3], patch_sizes=1024,
            data_store=store, crop=32, geometry="shear")
        mj.reset_launch_counts()
        rot.reset_launch_counts()
        dev_aug = {k: {n: None if t is None else t.to(device) for n, t in v.items()}
                   for k, v in aug.items()}
        metrics = step({"labeled_indices": torch.from_numpy(lab_idx).to(device),
                        "unlabeled_indices": torch.from_numpy(unlab_idx).to(device)},
                       flip_mask=flip_mask.to(device), aug_params=dev_aug)
        results[device] = ({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
                           rot.launch_count(rot.ROTATE), sum(mj.LAUNCHES.values()))
    (l_cpu, r_cpu, j_cpu), (l_gpu, r_gpu, j_gpu) = results["cpu"], results["cuda"]
    check(r_cpu == j_cpu == 0 and r_gpu == 3 and j_gpu == 6,
          f"step_device launches: rotation cpu={r_cpu} cuda={r_gpu} (want 0, 3), "
          f"mi_joint cpu={j_cpu} cuda={j_gpu} (want 0, 6)")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"step_device losses differ: {rel}")
    emit({"phase": "step_device", "geometry": "shear", "losses_cpu": l_cpu,
          "losses_cuda": l_gpu, "rel_err": rel, "rotation_launches_cuda": r_gpu,
          "mi_joint_launches_cuda": j_gpu})


def phase_train(steps: int):
    import torch

    main_mod, mj = port("main"), port("ops.mi_joint")
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", "Trainer.max_epoch=1", "Trainer.device=cuda",
            "Trainer.save_dir=chip_smoke_udaiic", "Trainer.step_timing=true"]
    torch.cuda.reset_peak_memory_stats()
    mj.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = main_mod.main(argv)
    wall = time.perf_counter() - t0
    counts = {f"{name}/p{p}": v for (name, p), v in sorted(mj.LAUNCHES.items())}
    launches = sum(mj.LAUNCHES.values())
    check(launches >= 6 * steps, f"{launches} kernel launches in {steps} steps (want >= 6 per step)")
    row = trainer._storage._rows[0]
    losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", "tra_uda_mean",
                                  "tra_mi_mean")}
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    val_dsc = row["val_dice_DSC_mean"]
    check(0.0 <= val_dsc <= 1.0, f"val DSC {val_dsc}")
    step_ms = statistics.median(trainer.step_times_ms[1:])
    out = {"phase": "train", "steps": steps, "batch": [4, 10], "crop": 224,
           "launches": counts, "launches_per_step": launches / steps, "losses": losses,
           "val_dsc_mean": val_dsc, "first_step_ms": trainer.step_times_ms[0],
           "median_step_ms": step_ms, "step_ms": trainer.step_times_ms,
           "slices_per_s": 24 / (step_ms / 1e3), "epoch_wall_s": trainer.epoch_times_s[0],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wall_s": wall}
    emit(out)
    return trainer, dict(mj.LAUNCHES)


def phase_train_device(steps: int, geometry: str, chunk: int = 4):
    """The headline trainer on the device-data path; returns the trainer and
    the rotation and joint launch counts of this run (set to 0 just before)."""
    import torch

    main_mod, mj, rot = port("main"), port("ops.mi_joint"), port("ops.rotate")
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", f"Trainer.scan_chunk={chunk}",
            "Trainer.max_epoch=1", "Trainer.device=cuda", "Trainer.device_data=true",
            f"Kernel.geometry={geometry}", f"Trainer.save_dir=chip_smoke_device_{geometry}",
            "Trainer.step_timing=true"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mj.reset_launch_counts()
    rot.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = main_mod.main(argv)
    wall = time.perf_counter() - t0
    rot_launches, joint_launches = dict(rot.LAUNCHES), dict(mj.LAUNCHES)
    n_rot, n_joint = rot.launch_count(rot.ROTATE), sum(joint_launches.values())
    want_rot = 3 * steps if geometry == "shear" else 0
    check(n_rot == want_rot and rot.launch_count(rot.ROLL) == 0,
          f"{geometry}: {n_rot} rotation launches in {steps} steps (want {want_rot})")
    check(n_joint >= 6 * steps, f"{geometry}: {n_joint} joint launches in {steps} steps")
    row = trainer._storage._rows[0]
    losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", "tra_uda_mean",
                                  "tra_mi_mean")}
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    val_dsc = row["val_dice_DSC_mean"]
    check(0.0 <= val_dsc <= 1.0, f"val DSC {val_dsc}")
    per_chunk = trainer.step_times_ms[::chunk]
    steady = statistics.median(trainer.step_times_ms[chunk:]) if steps > chunk else per_chunk[0]
    emit({"phase": "train_device", "geometry": geometry, "steps": steps, "scan_chunk": chunk,
          "batch": [4, 10], "crop": 224,
          "rotation_launches": {f"{n}/B{b}": v for (n, b), v in sorted(rot_launches.items())},
          "rotation_launches_per_step": n_rot / steps,
          "joint_launches_per_step": n_joint / steps, "losses": losses, "val_dsc_mean": val_dsc,
          "chunk_ms_per_step": per_chunk, "median_step_ms": steady,
          "median_step_ms_note": "median over the steps after the first chunk "
                                 "(each step: its chunk's wall time / chunk size)",
          "slices_per_s": 24 / (steady / 1e3), "epoch_wall_s": trainer.epoch_times_s[0],
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "wall_s": wall})
    return trainer, rot_launches, joint_launches


def _kernel_kind(name: str) -> str:
    lowered = name.lower()
    if "joint_fwd" in lowered or "joint_bwd" in lowered:
        return "mi_joint (this port's CUDA)"
    if "rotate_shear" in lowered or "lane_roll" in lowered:
        return "rotation (this port's CUDA)"
    if any(k in lowered for k in ("batch_norm", "batchnorm", "bn_", "welford")):
        return "batch norm"
    if any(k in lowered for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
                                  "cutlass", "sm90_")):
        return "convolution / matmul and its layout copies (cuDNN, cuBLAS)"
    return "elementwise, reduction, copy"


def phase_profile(trainer, steps: int, path: str = "host") -> None:
    """Device time of a few train steps of the headline trainer, by kernel
    and by kind (torch.profiler with CUDA activity), on one batch: host
    images already on the card, or (path "device") slice indices whose
    gather and augmentation run inside each step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if path == "host":
        lab, unlab = next(zip(trainer._labeled_loader, trainer._unlabeled_loader))
        batch = {"labeled_image": trainer._to_device(lab["image"]),
                 "labeled_target": trainer._to_device(lab["target"]),
                 "unlabeled_image": trainer._to_device(unlab["image"])}
    else:
        lab, unlab = next(zip(trainer._labeled_index_loader, trainer._unlabeled_index_loader))
        batch = {"labeled_indices": trainer._to_device(lab["indices"]),
                 "unlabeled_indices": trainer._to_device(unlab["indices"])}
    trainer._train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            trainer._train_step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    kernels = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(ms for _, ms, _ in kernels)
    by_kind: dict = {}
    for name, ms, _ in kernels:
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    emit({"phase": "profile", "path": path, "steps": steps, "wall_ms_per_step": wall_ms,
          "device_ms_per_step": device_ms,
          "device_busy_share": device_ms / wall_ms if wall_ms else None,
          "by_kind_ms_per_step": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
          "top_kernels": [{"name": n[:120], "ms_per_step": ms, "calls_per_step": c}
                          for n, ms, c in kernels[:15]]})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="device,build,kernels,step,step_device,train,"
                                              "train_device,profile")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)
    phases = args.phases.split(",")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # fp32 matmuls and convolutions in full fp32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    info = phase_device()
    if "build" in phases:
        phase_build()
    kernel_rows = phase_kernels(args.reps) if "kernels" in phases else []
    rotation_rows = phase_kernels_rotate(args.reps) if "kernels" in phases else []
    if "step" in phases:
        phase_step()
    if "step_device" in phases:
        phase_step_device()
    trainer, launches = phase_train(args.steps) if "train" in phases else (None, {})
    device_trainer, rot_launches = None, {}
    if "train_device" in phases:
        device_trainer, rot_launches, _ = phase_train_device(args.steps, "shear")
        phase_train_device(args.steps, "fused")
    if "profile" in phases:
        if trainer is not None:
            phase_profile(trainer, steps=3)
        if device_trainer is not None:
            phase_profile(device_trainer, steps=3, path="device")
    # one entry per kernel and main-path shape; the joint in the training
    # path's bf16 mode. Launches: the joint's from the host path's train
    # phase, the rotation's from the device path's shear run (lane_roll_rows
    # is not on that path: its counterpart of the JAX path's three-roll
    # rotation is the single-pass rotate_shear, which gives the same output)
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "label")
    summary = [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                    launches=launches.get((r["name"], r["padding"])))
               for r in kernel_rows if r["mode"] == "bf16"]
    summary += [dict(name=f"{r['name']}@B{r['batch']}", **{k: r[k] for k in keys},
                     launches=rot_launches.get((r["name"], r["batch"]), 0),
                     on_main_path=r["name"] == "rotate_shear")
                for r in rotation_rows]
    print(nvidia_smi(), flush=True)  # again beside the summary, for readers of the tail
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
