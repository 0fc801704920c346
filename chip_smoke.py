#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels --reps 20

Phases, each printing JSON lines:
  device   the card's name and power limit (nvidia-smi, also printed raw)
  build    compile every CUDA source of the port with nvcc (sm_90a)
  kernels  each kernel launch of the training path against its plain PyTorch
           version: exactly on small-integer inputs (all sums exact in fp32)
           at ragged shapes and at both decoder-tap shapes of the headline
           config, then at the taps within TOL on probability maps in bf16
           and fp32 operand modes, two calls bit-identical; times by CUDA
           events (median) of the whole wrapper call, beside the plain
           version, one PyTorch library call of the same function (its NCHW
           permute and cast included) and the card's bound, with the device
           time of each kernel the wrapper launches (torch.profiler).
           Then the rotation: the shifts its kernel derives equal
           shear_tables' over 8197 angles; the kernels' scalar paths (a
           width that is no multiple of 4, rows 4 bytes off 16) bit-exact;
           at the device path's shapes (4 slices of 256^2 with their labels
           in one launch, 10 without) each call bit-exact against its plain
           version and the three-roll rotation, identity at 0, one device
           kernel a call (profiler), timed by device time on inputs cycled
           through four times the L2 (and on one set, L2-warm) beside
           torch.gather and shear_tables; the row roll bit-exact, timed the
           same way.
           Then the joint at 256 lanes (a head of 5 x 30 clusters, tiled
           into 128-lane launches): exactly at a ragged shape, then on
           probability maps at the Up_conv3 shape, timed, with its launches
           per call. Then the three fused softmax + mask + joint kernels
           (Kernel.backend=pallas_fused) at the ragged shapes and both
           decoder-tap shapes, on logits: exactly on inputs whose softmax is
           dyadic (one lane per group far above the rest, p = 1; equal lanes,
           p = 1/4), within a stated bound on random logits in both operand
           modes; at the taps timed beside the plain version and the unfused
           path (group softmax, mask, mi_joint kernel) at the same shapes,
           with the device time of each kernel the wrapper launches
  step     one small udaiic train step on the card against the same step on
           the CPU (plain joint), same weights, batch and flip mask
  step_fused  the same with the decoder heads emitting logits (fused kernels
           on the card, their plain version on the CPU): 6 fused launches
  step_device  the same on the device-data path with geometry=shear: the
           same store, injected augmentation draws and flip mask
  step_meanteacher  one small meanteacher step on the card against the CPU:
           the same weights, batch and flip mask; every loss and the
           teacher's parameters and BN statistics after its EMA update
  train    the headline udaiic trainer through ``main.main`` on synthetic data
           (U-Net 16..256, 224^2 crops, 4 labeled + 10 unlabeled, taps Conv5 /
           Up_conv3 / Up_conv2, 5 x 20 clusters, paddings [1, 3]), with the
           kernel launch counts of that run, set to 0 just before it
  train_fused  the same with Kernel.backend=pallas_fused: 2 fused forward and
           4 fused backward launches a step, no mi_joint launch, and a peak
           of device memory below the train phase's
  train_device  the same trainer on the device-data path
           (Trainer.device_data=true, 8 steps in chunks of 4), once with
           Kernel.geometry=shear (the rotation kernel, 2 launches a step) and
           once with the default fused geometry; counts set to 0 before each
  resume   the headline udaiic trainer through ``main.main`` for one epoch of
           4 steps, then ``Checkpoint=<that run dir>``: the loaded state equals
           last.pth bit for bit (model, projector, Adam, step counter,
           generator), and with ``Trainer.max_epoch=2`` the resumed run trains
           epoch 1 only (Storage 2 rows), launching the joint kernels
  inference  ``Inference=true`` on that run dir, host path and
           ``Trainer.device_data=true``: DSC_mean equal to the same trainer's
           test eval, Hausdorff keys, one PNG per test slice in img/ gt/ pred/
  train_zoo  4 full-width steps each of meanteacher (device-data path,
           Kernel.geometry=shear: 2 rotation launches a step; the teacher moved
           from init and unlike the student), entropy and uda with
           UDARegCriterion.name=kl (host path)
  profile  device time by kernel and by kind over a few more steps of the host
           path's trainer, the fused trainer and the device path's (shear)
           trainer (torch.profiler), and the device's busy share of the wall

The line before the last is the JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. A failed check raises, and the script exits
non-zero without printing a result. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from importlib import import_module
from itertools import chain, count
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM
COLD_BYTES = 4 * 50e6               # four times the H100's 50 MB L2 (see cold())
PEAK_FLOPS = {"bf16": 989e12,       # dense tensor cores
              "fp32": 67e12}        # CUDA cores
PORT = "mi_based_regularized_semi_supervised_segmentation_tpu_torch"
JAX_KERNELS = "mi_based_regularized_semi_supervised_segmentation_tpu/ops/pallas/mi_joint.py"
JAX_ROTATE = "mi_based_regularized_semi_supervised_segmentation_tpu/ops/pallas/rotate.py"
JAX_FUSED = "mi_based_regularized_semi_supervised_segmentation_tpu/ops/pallas/mi_fused.py"
# the device path's rotations: (label, slices, edge) of the 256^2 synthetic store;
# the labeled batch rotates its images and labels in one launch
ROTATIONS = (("labeled", 4, 256), ("unlabeled", 10, 256))
SWEEP_ANGLES = 4096  # shift sweep: this many even angles, as many random ones, 5 edge cases
# decoder taps of the headline udaiic config: (name, batch, map edge, padding)
TAPS = (("Up_conv2", 10, 224, 3), ("Up_conv3", 10, 112, 1))
# ragged joint shapes for the exact check: (batch, Hp, Wp, padding); N is no
# multiple of the kernels' 256-row output tile or 64-row stage, Wp no
# multiple of 8; from one partial tile to several forward chunks; padding 2
# and 0 take the kernels' other displacement groups and ring depths
RAGGED = ((1, 37, 43, 3), (3, 29, 21, 1), (2, 101, 67, 3), (1, 13, 11, 1), (2, 12, 10, 2),
          (1, 9, 8, 0))
LANES, SUBHEADS, CLUSTERS = 128, 5, 20
WIDE_CLUSTERS = 30   # IICRegParameters.DecoderParams.num_clusters=30: 150 live lanes in 256
# max |kernel - plain| / max |plain| on probability maps. Both sides sum the
# same fp32 products in different orders: the forward's accumulators run over
# up to ~24k rows each (tensor-core accumulation, then a chunk sum), so the
# largest of ~800k joint entries drifts by ~1e-4 of the largest entry.
TOL = 5e-4
# fused backward, bf16 operands: t = p * dq is rounded to bf16 before its group
# sum, so a last-bit difference in dq (another summation order) moves a
# rounded t by one bf16 step (2^-8 of it), which reaches d(logits) scaled by p:
# max |kernel - plain| / max |plain| up to a few 1e-3, on a small share of the
# entries. The fp32 mode of the same kernels holds at TOL.
FUSED_BF16_BWD_TOL = 1e-2
FUSED_BF16_BWD_SHARE = 1e-3  # share of entries off by more than TOL * max
STEPS_TOL = 1e-3     # step phases: card vs CPU losses (relative)
ZOO_STEPS = 4        # steps of each resume / train_zoo run


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


def device_profile(fn, reps: int, warmup: int = 2) -> dict:
    """Per call, by kernel name: (device ms, launches) of every kernel that
    ``reps`` calls of ``fn`` launch (torch.profiler), divided by ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    # a profiling session now and then records no device activity at all
    # (seen on the card for a window of a few microsecond-kernels): take it
    # again, up to three times, rather than report nothing
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        split: dict = {}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                key = e.key[:80]
                ms, n = split.get(key, (0.0, 0.0))
                split[key] = (ms + e.self_device_time_total / 1e3 / reps, n + e.count / reps)
        if split:
            return split
    raise RuntimeError("check failed: the profiler saw no device time in three sessions")


def device_split(fn, reps: int, warmup: int = 2) -> dict:
    """Device time per call by kernel name (``device_profile``)."""
    return {k: ms for k, (ms, _) in device_profile(fn, reps, warmup).items()}


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Device time per call (``device_split`` summed). For kernels of a few
    microseconds, where CUDA events around a call measure the host's launch
    overhead instead."""
    return sum(device_split(fn, reps, warmup).values())


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
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(k in ln for k in ("registers", "spill", "entry function", "wgmma"))]
             for name, log in build.build_logs.items()}
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v) for k, v in paths.items()}, "ptxas": ptxas})


def _tap_inputs(batch: int, edge: int, padding: int, gen, clusters: int = CLUSTERS,
                lanes: int = LANES):
    """Probabilities as the training path feeds the joint: per-subhead
    softmax in 5 x clusters of `lanes` lanes, dead lanes 0, a zero border of
    width p."""
    import torch

    hp = edge + 2 * padding
    z = torch.randn((batch, hp, hp, SUBHEADS, clusters), generator=gen, device="cuda")
    probs = torch.softmax(z, -1).reshape(batch, hp, hp, SUBHEADS * clusters)
    probs = torch.nn.functional.pad(probs, (0, lanes - SUBHEADS * clusters))
    valid = torch.zeros((1, hp, hp, 1), device="cuda")
    valid[:, padding:hp - padding, padding:hp - padding] = 1.0
    return (probs * valid).reshape(-1, lanes).contiguous()


def _exact_check(mj, n: int, wp: int, p: int, gen, lanes: int = LANES) -> None:
    """Small integers are exact in bf16, and every sum stays below 2^24
    whatever the summation order, so the kernel must equal the plain version
    bit for bit in both modes: a missing, doubled or misplaced row or
    displacement shows here. Every row holds data, so the slabs' first and
    last rows and the zero fill beyond both ends of [0, N) are exercised."""
    import torch

    d = (2 * p + 1) ** 2
    a = torch.randint(0, 2, (n, lanes), generator=gen, device="cuda").float()
    b = torch.randint(0, 2, (n, lanes), generator=gen, device="cuda").float()
    g = torch.randint(-2, 3, (d, lanes, lanes), generator=gen, device="cuda").float()
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
            check(err == 0.0, f"exact {what} p={p} {lanes} lanes bf16={bf16}: max err {err}")


def _joint_cases(mj, a, b, g, batch: int, hp: int, p: int, bf16: bool) -> dict:
    """The joint's three products on square canvases [N, C]: for each, the
    kernel call, the plain version (fp32, bwd by autograd, on operands
    rounded as the mode rounds them), its result, and one PyTorch library
    call of the same function with the unpacking of its output."""
    import torch
    import torch.nn.functional as F

    n, c = a.shape
    d = (2 * p + 1) ** 2
    dot = torch.bfloat16 if bf16 else torch.float32
    ar, br, gr = (t.to(dot).float() for t in (a, b, g))
    ap, bp = ar.clone().requires_grad_(True), br.clone().requires_grad_(True)
    ref = mj.displaced_joint_plain_flat(ap, bp, hp, p)
    ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), gr, retain_graph=True)
    nchw = lambda t: t.reshape(batch, hp, hp, c).permute(0, 3, 1, 2).to(dot)
    w = g.reshape(2 * p + 1, 2 * p + 1, c, c)
    return {
        mj.FWD: dict(
            kernel=lambda: mj.mi_joint_fwd(a, b, hp, p, bf16),
            plain=lambda: mj.displaced_joint_plain_flat(ar, br, hp, p),
            want=ref.detach(),
            # the original project's joint: clusters as channels, the B maps
            # as one Hp x Wp filter per cluster
            library=lambda: F.conv2d(nchw(a).transpose(0, 1), nchw(b).transpose(0, 1), padding=p),
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


def phase_kernels(reps: int) -> list:
    import torch

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    replaces = {mj.FWD: f"{JAX_KERNELS}:178", mj.BWD_DX_TF: f"{JAX_KERNELS}:230",
                mj.BWD_DX: f"{JAX_KERNELS}:249"}
    rows = []
    for batch, hp, wp, p in RAGGED:
        n = batch * hp * wp
        _exact_check(mj, n, wp, p, gen)
        emit({"phase": "kernels", "ragged": [batch, hp, wp, p], "exact_check": "passed",
              "shape": [n, LANES]})
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
            cases = _joint_cases(mj, a, b, g, batch, hp, p, bf16)
            for name, case in cases.items():
                got = case["kernel"]()
                want = case["want"]
                err = float((got - want).abs().max())
                scale = float(want.abs().max())
                check(math.isfinite(err) and err <= TOL * scale,
                      f"{tap} {mode} {name}: max err {err} vs max |ref| {scale}")
                check(bool(torch.equal(case["kernel"](), got)),
                      f"{tap} {mode} {name}: two calls on the same inputs differ")
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
                row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
                row["vs_library"] = row["ms"] / row["library_ms"]
                if bf16:  # the wrapper's kernels: conversion, product, chunk sum
                    row["device_ms_by_kernel"] = device_split(case["kernel"], reps)
                emit(row)
                rows.append(row)
            del cases
        del a, b, g
        torch.cuda.empty_cache()
    return rows


def phase_kernels_wide(reps: int) -> list:
    """The bf16 joint at 256 lanes (5 x 30 clusters: 150 live lanes), which
    the wrapper tiles into one launch per pair of 128-lane blocks: exactly at
    a ragged shape, then on probability maps at the Up_conv3 shape within
    TOL, timed beside the plain version and F.conv2d. ``launches_per_call``
    counts the kernel launches of one wrapper call."""
    import torch

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    lanes = 2 * LANES
    batch, hp, wp, p = RAGGED[1]
    _exact_check(mj, batch * hp * wp, wp, p, gen, lanes)
    emit({"phase": "kernels", "ragged": list(RAGGED[1]), "lanes": lanes, "exact_check": "passed"})
    tap, batch, edge, p = TAPS[1]
    hp = edge + 2 * p
    d = (2 * p + 1) ** 2
    n = batch * hp * hp
    c = lanes
    a = _tap_inputs(batch, edge, p, gen, WIDE_CLUSTERS, lanes)
    b = _tap_inputs(batch, edge, p, gen, WIDE_CLUSTERS, lanes)
    g = torch.randn((d, c, c), generator=gen, device="cuda") * 1e-3
    flops = 2.0 * n * c * c * d
    nbytes = 4.0 * (2 * n * c + d * c * c)
    cases = _joint_cases(mj, a, b, g, batch, hp, p, bf16=True)
    rows = []
    for name, case in cases.items():
        kernel, want = case["kernel"], case["want"]
        mj.reset_launch_counts()
        got = kernel()
        launches = mj.launch_count(name)
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        check(math.isfinite(err) and err <= TOL * scale,
              f"{tap} {lanes} lanes {name}: max err {err} vs max |ref| {scale}")
        check(launches == (lanes // LANES) ** 2,
              f"{tap} {lanes} lanes {name}: {launches} launches in one call (want 4)")
        by_ops = flops / PEAK_FLOPS["bf16"] >= nbytes / HBM_BYTES_PER_S
        row = {"phase": "kernels", "name": name, "tap": tap, "label": f"{tap} {lanes} lanes",
               "mode": "bf16", "route": "cuda", "source": f"{PORT}/csrc/mi_joint.cu",
               "shape": [n, c], "padding": p, "lanes": lanes, "launches_per_call": launches,
               "max_abs_err": err, "max_abs_ref": scale, "tol_rel": TOL,
               "ms": cuda_ms(kernel, reps),
               "plain_ms": cuda_ms(case["plain"], max(3, reps // 3), warmup=1),
               "library_ms": cuda_ms(case["library"], max(3, reps // 3), warmup=1),
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bf16"]) * 1e3,
               "bound_by": "operations" if by_ops else "bytes"}
        row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
        emit(row)
        rows.append(row)
    mj.reset_launch_counts()
    del a, b, g, cases
    torch.cuda.empty_cache()
    return rows


def cold(fn, *args):
    """A closure that calls ``fn`` on the next of k copies of ``args`` and
    holds its result until that copy comes round again. The copies' inputs
    alone span ``COLD_BYTES``, so a call reads its inputs from device memory
    and writes lines that no recent call touched: what the bytes bound
    assumes. Timed on one set of inputs, a call of a few MB finds them in the
    L2 and can read above that bound."""
    nbytes = sum(a.numel() * a.element_size() for a in args)
    k = max(2, math.ceil(COLD_BYTES / nbytes))
    slots = [[a.clone() for a in args] for _ in range(k)]
    held = [None] * k
    turn = count()

    def call():
        i = next(turn) % k
        held[i] = None
        held[i] = fn(*slots[i])
        return held[i]
    return call


def _one_kernel_ms(fn, reps: int, what: str, kernel: str) -> float:
    """Device time of one call of ``fn``, which must launch exactly one
    device kernel, whose name holds ``kernel`` (the profiler, over ``reps``
    calls)."""
    prof = device_profile(fn, reps)
    launches = sum(n for _, n in prof.values())
    check(launches == 1 and all(kernel in k.replace(" ", "") for k in prof),
          f"{what}: {launches} device kernels a call (want 1, {kernel}): {sorted(prof)}")
    return sum(ms for ms, _ in prof.values())


def _rotate_scalar_paths(rot, gen) -> None:
    """What the device path's shapes never take: the rotation at a width that
    is no multiple of 4 (scalar stores), the roll on rows that are no multiple
    of 4 wide or whose base is 4 bytes off 16 (the scalar kernel); each
    bit-exact against its plain version, the kernel variant by the profiler."""
    import torch

    b, h, w = 3, 61, 70
    x = torch.randint(0, 256, (b, h, w), generator=gen, device="cuda").float()
    lab = torch.randint(0, 4, (b, h, w), generator=gen, device="cuda", dtype=torch.int32)
    ang = torch.rand(b, generator=gen, device="cuda") * 90.0 - 45.0
    got = rot.rotate_shear(x, ang, labels=lab)
    want = rot.rotate_shear_pair_plain(x, lab, ang)
    check(all(torch.equal(g, v) for g, v in zip(got, want))
          and torch.equal(rot.rotate_shear(x, ang), want[0]), f"rotate_shear at {w} columns")
    _one_kernel_ms(lambda: rot.rotate_shear(x, ang, labels=lab), 3, "pair, ragged",
                   "rotate_shear_kernel<true,false>")
    _one_kernel_ms(lambda: rot.rotate_shear(x, ang), 3, "images, ragged",
                   "rotate_shear_kernel<false,false>")
    cases = []
    for shape in ((4, 16, 384), (3, 50, 130)):
        c = torch.rand(shape, generator=gen, device="cuda")
        s = torch.randint(-3000, 3000, shape[:2], generator=gen, device="cuda",
                          dtype=torch.int32)
        off = torch.empty(c.numel() + 1, device="cuda")[1:].view(shape)  # 4 bytes off 16
        off.copy_(c)
        want = rot.lane_roll_rows_plain(c, s)
        for t, aligned in ((c, shape[2] % 4 == 0), (off, False)):
            check(torch.equal(rot.lane_roll_rows(t, s), want), f"lane_roll_rows {shape}")
            _one_kernel_ms(lambda: rot.lane_roll_rows(t, s), 3, f"roll {shape}",
                           "lane_roll_rows_vec_kernel(" if aligned else "lane_roll_rows_kernel(")
            cases.append([*shape, "base 4 B off 16" if t is off else "aligned",
                          "vector" if aligned else "scalar"])
    emit({"phase": "kernels", "rotate_scalar_paths": "passed", "rotate": [b, h, w],
          "roll": cases})


def phase_kernels_rotate(reps: int) -> list:
    """The rotation kernels at the device path's shapes. First the shifts the
    rotation kernel derives against ``shear_tables`` over a sweep of angles,
    and the kernels' scalar paths; then, for each batch (the labeled one with
    its labels, in one launch), the call bit-exact against its plain version,
    identity at 0, the images bit-exact against rotate_shear_lanes, one
    device kernel a call; the roll bit-exact, one device kernel a call.
    Times: device time of the whole call on inputs cycled through more than
    the L2 holds (``cold``; also ``l2_warm_ms``, on one set), beside the
    plain version, one torch.gather of the same permutation (of both planes
    for the pair) and one device copy of the same input bytes, timed the same
    way, and ``shear_tables``, which the earlier design launched before its
    kernel."""
    import torch

    rot = port("ops.rotate")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    edge = ROTATIONS[0][2]
    sweep = torch.cat([torch.linspace(-45.0, 45.0, SWEEP_ANGLES, device="cuda"),
                       torch.rand(SWEEP_ANGLES, generator=gen, device="cuda") * 90.0 - 45.0,
                       torch.tensor([0.0, 45.0, -45.0, 1e-6, -1e-6], device="cuda")])
    k_x, k_y = rot.kernel_shifts(sweep, edge, edge)
    s_x, s_y, geom = rot.shear_tables(sweep, edge, edge)
    differ = int((k_x != s_x).sum()) + int((k_y != s_y).sum())
    check(differ == 0, f"kernel shifts differ from shear_tables in {differ} entries")
    emit({"phase": "kernels", "shift_sweep": "passed", "angles": sweep.numel(),
          "shifts_compared": k_x.numel() + k_y.numel(), "canvas": list(geom)})
    _rotate_scalar_paths(rot, gen)
    rows = []
    for label, batch, edge in ROTATIONS:
        pair = label == "labeled"
        planes = 2 if pair else 1
        n = edge * edge
        x = torch.randint(0, 256, (batch, edge, edge), generator=gen, device="cuda").float()
        lab = torch.randint(0, 4, (batch, edge, edge), generator=gen, device="cuda",
                            dtype=torch.int32)
        ang = torch.rand(batch, generator=gen, device="cuda") * 90.0 - 45.0
        tables_l = rot.shear_tables(ang, edge, edge, lane_aligned_rows=True)
        if pair:
            args = (x, ang, lab)
            call = lambda x, ang, lab: rot.rotate_shear(x, ang, labels=lab)
            plain = lambda x, ang, lab: rot.rotate_shear_pair_plain(x, lab, ang)
        else:
            args = (x, ang)
            call = lambda x, ang: (rot.rotate_shear(x, ang),)
            plain = lambda x, ang: (rot.rotate_shear_plain(x, ang),)
        got, want = call(*args), plain(*args)
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        check(err == 0.0 and all(torch.equal(g, w) for g, w in zip(got, want)),
              f"rotate_shear {label}: max err {err} vs plain")
        check(bool(torch.equal(rot.rotate_shear_lanes(x, ang, tables=tables_l), got[0])),
              f"rotate_shear vs rotate_shear_lanes {label}")
        zero = torch.zeros_like(ang)
        same = (rot.rotate_shear(x, zero, labels=lab) if pair else (rot.rotate_shear(x, zero),))
        check(all(torch.equal(g, w) for g, w in zip(same, (x, lab)))
              and bool(torch.equal(rot.rotate_shear_lanes(x, zero), x)), f"identity {label}")
        s_x = tables_l[0]
        canvas = rot._pad_canvas(x, tables_l[2])
        roll_err = float((rot.lane_roll_rows(canvas, s_x)
                          - rot.lane_roll_rows_plain(canvas, s_x)).abs().max())
        check(roll_err == 0.0, f"lane_roll_rows {label}: max err {roll_err} vs plain")
        # library yardstick: one torch.gather over the flattened planes with the
        # composite source index precomputed (the same permutation); the index
        # comes from rotating 1..H*W (exact in fp32), 0 meaning outside
        ids = torch.arange(1, n + 1, device="cuda", dtype=torch.float32).reshape(1, edge, edge)
        src = rot.rotate_shear(ids.expand(batch, -1, -1).contiguous(), ang)
        src = torch.where(src > 0, src - 1, torch.full_like(src, n)).long().reshape(batch, n)
        pad = lambda t: torch.cat([t.reshape(batch, n), t.new_zeros((batch, 1))], 1)
        # the labels' int32 words travel as fp32 bit patterns, as in the kernel
        stacked = torch.stack([pad(x), pad(lab).view(torch.float32)][:planes])
        library = lambda stacked, src: torch.gather(stacked, 2, src.expand(planes, -1, -1))
        lib_out = library(stacked, src)
        check(bool(torch.equal(lib_out[0].reshape(batch, edge, edge), got[0]))
              and (not pair or bool(torch.equal(
                  lib_out[1].view(torch.int32).reshape(batch, edge, edge), got[1]))),
              f"gather yardstick {label}")
        roll_src = torch.remainder(torch.arange(canvas.shape[2], device="cuda")[None, None, :]
                                   - s_x[:, :, None].long(), canvas.shape[2])
        hc, wc = rot.canvas(edge, edge, 45.0, False)[2:]
        rot_bytes = 4.0 * 2 * planes * batch * n               # each plane in and out
        roll_bytes = 4.0 * (2 * canvas.numel() + s_x.numel())
        plain_reps = max(3, reps // 3)
        variant = f"rotate_shear_kernel<{str(pair).lower()},true>"
        for name, nbytes, kernel, kernel_args, plain_fn, lib_fn, lib_args, shape, extra in (
                (rot.ROTATE, rot_bytes, call, args, plain, library, (stacked, src),
                 [batch, edge, edge],
                 {"planes": ["image f32", "labels int32"][:planes], "canvas": [hc, wc],
                  # the bytes moved without a permutation: one device copy of the planes
                  "copy_ms": device_ms(cold(lambda p: p.clone(), torch.stack(
                      [x, lab.view(torch.float32)][:planes])), reps),
                  # what the earlier design launched before its kernel, each call
                  "shear_tables_ms": device_ms(lambda: rot.shear_tables(ang, edge, edge),
                                               reps)}),
                (rot.ROLL, roll_bytes, rot.lane_roll_rows, (canvas, s_x),
                 rot.lane_roll_rows_plain, lambda c, i: torch.gather(c, 2, i),
                 (canvas, roll_src), list(canvas.shape),
                 {"copy_ms": device_ms(cold(lambda c: c.clone(), canvas), reps),
                  "rotate_shear_lanes_device_ms": device_ms(cold(
                     lambda x, ang: rot.rotate_shear_lanes(x, ang, tables=tables_l), x, ang),
                     reps)})):
            what = f"{name} {label}"
            want_kernel = variant if name == rot.ROTATE else "lane_roll_rows_vec_kernel("
            timed = cold(kernel, *kernel_args)
            row = {"phase": "kernels", "name": name,
                   "label": f"{label} B={batch}" + (" (image, labels)" if pair and
                                                   name == rot.ROTATE else ""),
                   "route": "cuda", "source": f"{PORT}/csrc/rotate.cu",
                   "replaces": f"{JAX_ROTATE}:138" if name == rot.ROTATE else f"{JAX_ROTATE}:161",
                   "shape": shape, "batch": batch, "max_abs_err": err if name == rot.ROTATE
                   else roll_err,
                   "timing": "device time per call (torch.profiler): the call's one kernel, "
                             f"inputs cycled through {COLD_BYTES / 1e6:.0f} MB of copies",
                   "ms": _one_kernel_ms(timed, reps, what, want_kernel),
                   "l2_warm_ms": _one_kernel_ms(lambda: kernel(*kernel_args), reps, what,
                                                want_kernel),
                   "plain_ms": device_ms(cold(plain_fn, *kernel_args), plain_reps),
                   "library_ms": device_ms(cold(lib_fn, *lib_args), plain_reps),
                   "call_ms": cuda_ms(timed, reps),
                   "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                   "mbytes": nbytes / 1e6, **extra}
            del timed
            row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
            row["vs_library"] = row["ms"] / row["library_ms"]
            row["achieved_gb_s"] = nbytes / (row["ms"] * 1e-3) / 1e9
            emit(row)
            rows.append(row)
            torch.cuda.empty_cache()
        del x, lab, canvas, src, stacked, roll_src
        torch.cuda.empty_cache()
    return rows


def _fused_logits(n: int, gen, kind: str = "random"):
    """[n, 128] logits as the heads emit them (dead lanes at float32 min):
    random normal in the 5 x 20 live lanes; "onehot": small integers with one
    lane per group at 200 (p = 1 there, exactly 0 elsewhere); "uniform":
    each row one small integer in 100 live lanes (groups of 4: p = 1/4)."""
    import torch

    live = SUBHEADS * CLUSTERS
    z = torch.full((n, LANES), torch.finfo(torch.float32).min, device="cuda")
    if kind == "random":
        z[:, :live] = torch.randn((n, live), generator=gen, device="cuda")
    elif kind == "onehot":
        z[:, :live] = torch.randint(-3, 4, (n, live), generator=gen, device="cuda").float()
        hot = torch.randint(0, CLUSTERS, (n, SUBHEADS), generator=gen, device="cuda")
        hot += torch.arange(SUBHEADS, device="cuda") * CLUSTERS
        z.scatter_(1, hot, 200.0)
    else:
        z[:, :live] = torch.randint(-3, 4, (n, 1), generator=gen, device="cuda").float()
    return z


def _fused_exact_check(mf, n: int, hp: int, wp: int, p: int, gen) -> None:
    """Probabilities of 0, 1 or 1/4, integer cotangents: every product, sum
    and rounding is exact in both operand modes, so the kernels must equal
    the plain version bit for bit (a missing, doubled or misplaced row,
    displacement, lane or group shows here)."""
    import torch

    d = (2 * p + 1) ** 2
    g = torch.randint(-2, 3, (d, LANES, LANES), generator=gen, device="cuda").float()
    for kind, (s, k) in (("onehot", (SUBHEADS, CLUSTERS)), ("uniform", (25, 4))):
        l1, l2 = _fused_logits(n, gen, kind), _fused_logits(n, gen, kind)
        args = (hp, wp, p, s, k, 1.0)
        for dot in (torch.bfloat16, torch.float32):
            bf16 = dot == torch.bfloat16
            got = {"fwd": (mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                           mf.fused_fwd_plain(l1, l2, *args, dot)),
                   "dl2": (mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16),
                           mf.fused_bwd_side_plain(l1, l2, g, *args, dot, transpose_g=False)),
                   "dl1": (mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16),
                           mf.fused_bwd_side_plain(l2, l1, g, *args, dot, transpose_g=True))}
            for what, (x, y) in got.items():
                err = float((x - y).abs().max())
                # (the one-hot softmax is saturated: its fp32 d(logits) are all 0)
                nonzero = what == "fwd" or kind == "uniform"
                check(err == 0.0 and (float(y.abs().max()) > 0 or not nonzero),
                      f"exact fused {kind} {what} p={p} {dot}: max err {err}")


def _fused_compare(mf, name: str, bf16: bool, got, want, where: str):
    """(max error, max |want|, share of entries off by more than TOL of it,
    the tolerance held): random logits against the plain version."""
    diff = (got - want).abs()
    err, scale = float(diff.max()), float(want.abs().max())
    share = float((diff > TOL * scale).float().mean())
    tol = FUSED_BF16_BWD_TOL if bf16 and name != mf.FWD else TOL
    mode = "bf16" if bf16 else "fp32"
    check(math.isfinite(err) and err <= tol * scale,
          f"{where} {mode} {name}: max err {err} vs max |ref| {scale}")
    check(tol == TOL or share <= FUSED_BF16_BWD_SHARE,
          f"{where} {mode} {name}: {share} of the entries off by more than TOL")
    return err, scale, share, tol


def _fused_random_check(mf, n: int, hp: int, wp: int, p: int, gen) -> dict:
    """Random logits, both operand modes, the three kernels against the plain
    version at the tolerances of the tap rows; max error / max |ref| each."""
    import torch

    d = (2 * p + 1) ** 2
    l1, l2 = _fused_logits(n, gen), _fused_logits(n, gen)
    g = torch.randn((d, LANES, LANES), generator=gen, device="cuda") * 1e-3
    args = (hp, wp, p, SUBHEADS, CLUSTERS, 1.0)
    errs = {}
    for dot in (torch.bfloat16, torch.float32):
        bf16 = dot == torch.bfloat16
        for name, got, want in (
                (mf.FWD, mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                 mf.fused_fwd_plain(l1, l2, *args, dot)),
                (mf.BWD_DL2, mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16),
                 mf.fused_bwd_side_plain(l1, l2, g, *args, dot, transpose_g=False)),
                (mf.BWD_DL1, mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16),
                 mf.fused_bwd_side_plain(l2, l1, g, *args, dot, transpose_g=True))):
            err, scale, _, _ = _fused_compare(mf, name, bf16, got, want, f"ragged n={n} p={p}")
            errs[f"{name}/{'bf16' if bf16 else 'fp32'}"] = err / scale
    return errs


def phase_kernels_fused(reps: int) -> list:
    """The three fused kernels at both decoder-tap shapes: exact checks, then
    random logits in both operand modes against the plain version, timed
    beside it and beside the unfused path at the same shapes (per-group
    softmax, mask and the mi_joint kernel; the backward's softmax VJP by
    autograd)."""
    import torch

    mf, mj, heads = port("ops.mi_fused"), port("ops.mi_joint"), port("models.heads")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    replaces = {mf.FWD: f"{JAX_FUSED}:215", mf.BWD_DL2: f"{JAX_FUSED}:254",
                mf.BWD_DL1: f"{JAX_FUSED}:275"}
    rows = []
    for batch, hp, wp, p in RAGGED:
        n = batch * hp * wp
        _fused_exact_check(mf, n, hp, wp, p, gen)
        errs = _fused_random_check(mf, n, hp, wp, p, gen)
        emit({"phase": "kernels", "ragged": [batch, hp, wp, p], "fused_exact_check": "passed",
              "fused_random_rel_err": errs, "shape": [n, LANES]})
    for tap, batch, edge, p in TAPS:
        hp = edge + 2 * p
        d = (2 * p + 1) ** 2
        n = batch * hp * hp
        c = LANES
        _fused_exact_check(mf, n, hp, hp, p, gen)
        emit({"phase": "kernels", "tap": tap, "fused_exact_check": "passed", "shape": [n, c]})
        l1, l2 = _fused_logits(n, gen), _fused_logits(n, gen)
        g = torch.randn((d, c, c), generator=gen, device="cuda") * 1e-3
        args = (hp, hp, p, SUBHEADS, CLUSTERS, 1.0)
        valid = mf.row_valid(n, hp, hp, p, "cuda")
        # the bound counts the S*K live lanes only: the fused function takes S
        # and K, and by its definition every lane from S*K on is dead (p = 0)
        live = SUBHEADS * CLUSTERS
        flops = 2.0 * n * live * live * d
        fwd_bytes = 4.0 * (2 * n * live + d * live * live)  # two logit maps in, J out
        bwd_bytes = 4.0 * (3 * n * live + d * live * live)  # two logit maps and g in, dl out
        # the unfused path: per-group softmax and mask as separate kernels,
        # probabilities in device memory, then the mi_joint kernels
        leaves = [t.clone().requires_grad_(True) for t in (l1, l2)]
        probs = [heads.group_softmax_flat(t, SUBHEADS, CLUSTERS) * valid for t in leaves]
        saved = [t.detach().contiguous() for t in probs]
        for mode in ("bf16", "fp32"):
            bf16 = mode == "bf16"
            dot = torch.bfloat16 if bf16 else torch.float32
            unfused_bwd = lambda own, src, tr: torch.autograd.grad(
                probs[own], leaves[own], mj.mi_joint_bwd(saved[src], g, hp, p, tr, bf16),
                retain_graph=True)
            cases = {
                mf.FWD: dict(
                    kernel=lambda: mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                    plain=lambda: mf.fused_fwd_plain(l1, l2, *args, dot),
                    unfused=lambda: mj.mi_joint_fwd(
                        (heads.group_softmax_flat(l1, SUBHEADS, CLUSTERS) * valid),
                        (heads.group_softmax_flat(l2, SUBHEADS, CLUSTERS) * valid), hp, p, bf16),
                    nbytes=fwd_bytes),
                mf.BWD_DL2: dict(
                    kernel=lambda: mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16),
                    plain=lambda: mf.fused_bwd_side_plain(l1, l2, g, *args, dot, transpose_g=False),
                    unfused=lambda: unfused_bwd(1, 0, False), nbytes=bwd_bytes),
                mf.BWD_DL1: dict(
                    kernel=lambda: mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16),
                    plain=lambda: mf.fused_bwd_side_plain(l2, l1, g, *args, dot, transpose_g=True),
                    unfused=lambda: unfused_bwd(0, 1, True), nbytes=bwd_bytes),
            }
            for name, case in cases.items():
                err, scale, share, tol = _fused_compare(mf, name, bf16, case["kernel"](),
                                                        case["plain"](), tap)
                by_ops = flops / PEAK_FLOPS[mode] >= case["nbytes"] / HBM_BYTES_PER_S
                row = {"phase": "kernels", "name": name, "tap": tap, "label": tap, "mode": mode,
                       "route": "cuda", "source": f"{PORT}/csrc/mi_fused.cu",
                       "replaces": replaces[name], "shape": [n, c], "live_lanes": live,
                       "padding": p, "max_abs_err": err, "max_abs_ref": scale, "tol_rel": tol,
                       "share_above_tol": share,
                       "ms": cuda_ms(case["kernel"], reps),
                       "plain_ms": cuda_ms(case["plain"], max(3, reps // 3), warmup=1),
                       "unfused_path_ms": cuda_ms(case["unfused"], max(3, reps // 3), warmup=1),
                       "library_ms": None,
                       "bound_ms": max(case["nbytes"] / HBM_BYTES_PER_S,
                                       flops / PEAK_FLOPS[mode]) * 1e3,
                       "bound_by": "operations" if by_ops else "bytes",
                       "gflop": flops / 1e9}
                row["achieved_tflops"] = flops / (row["ms"] * 1e-3) / 1e12
                row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
                row["vs_unfused"] = row["ms"] / row["unfused_path_ms"]
                if bf16:  # the wrapper's kernels: softmax pass, product(, chunk sum)
                    row["device_ms_by_kernel"] = device_split(case["kernel"], reps)
                emit(row)
                rows.append(row)
            del cases
        del l1, l2, g, leaves, probs, saved, valid
        torch.cuda.empty_cache()
    return rows


def phase_step(fused: bool = False) -> None:
    """One udaiic step (crop 32, 2 + 3 slices, 3 classes, 2 x 5 clusters,
    paddings [1, 3]) on the card and on the CPU from the same weights; with
    ``fused`` the decoder heads emit logits (the fused kernels on the card)."""
    import numpy as np
    import torch

    models, optim, steps, mj, mf = port("models"), port("engine.optim"), port("engine.steps"), \
        port("ops.mi_joint"), port("ops.mi_fused")
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
        proj = models.ProjectorWrapper(feats, num_clusters=5, num_subheads=2,
                                       local_emit_logits=fused)
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
        mf.reset_launch_counts()
        metrics = step({k: torch.from_numpy(v).to(device) for k, v in batch_np.items()},
                       flip_mask=flip_mask)
        launches = (sum(mj.LAUNCHES.values()), sum(mf.LAUNCHES.values()))
        results[device] = ({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
                           {k: p.detach().cpu() - before[k] for k, p in params}, launches)
    (l_cpu, d_cpu, n_cpu), (l_gpu, d_gpu, n_gpu) = results["cpu"], results["cuda"]
    want = (0, 6) if fused else (6, 0)
    check(n_cpu == (0, 0) and n_gpu == want,
          f"step launches (mi_joint, mi_fused) cpu={n_cpu} cuda={n_gpu} (want (0, 0), {want})")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"step losses differ: {rel}")
    # Adam's first step is ~ -lr * sign(g): where a gradient is near fp32
    # noise the two sides may step opposite ways (<= 2 lr); the bulk agrees
    diffs = np.concatenate([(d_gpu[k] - d_cpu[k]).abs().flatten().numpy() for k in d_cpu])
    loose = float(np.mean(diffs > 0.05 * 1e-3))
    check(diffs.max() <= 2.05e-3 and loose < 0.005, f"param deltas: max {diffs.max()}, "
          f"loose share {loose}")
    emit({"phase": "step_fused" if fused else "step", "losses_cpu": l_cpu, "losses_cuda": l_gpu,
          "rel_err": rel, "param_delta_max_diff": float(diffs.max()),
          "param_delta_loose_share": loose,
          "launches_cuda": dict(zip(("mi_joint", "mi_fused"), n_gpu))})


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
    check(r_cpu == j_cpu == 0 and r_gpu == 2 and j_gpu == 6,
          f"step_device launches: rotation cpu={r_cpu} cuda={r_gpu} (want 0, 2), "
          f"mi_joint cpu={j_cpu} cuda={j_gpu} (want 0, 6)")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"step_device losses differ: {rel}")
    emit({"phase": "step_device", "geometry": "shear", "losses_cpu": l_cpu,
          "losses_cuda": l_gpu, "rel_err": rel, "rotation_launches_cuda": r_gpu,
          "mi_joint_launches_cuda": j_gpu})


def phase_step_meanteacher() -> None:
    """One meanteacher step (crop 32, 2 + 3 slices, 3 classes) on the card and
    on the CPU from the same weights, batch and flip mask: every loss, and
    the teacher after its EMA update (step 0: alpha 0, the student's
    parameters times 1 - wd) with the BN statistics of its own forward."""
    import numpy as np
    import torch

    models, optim, steps = port("models"), port("engine.optim"), port("engine.steps")
    rng = np.random.default_rng(0)
    batch_np = {"labeled_image": rng.random((2, 32, 32, 1), dtype=np.float32),
                "labeled_target": rng.integers(0, 3, (2, 32, 32)),
                "unlabeled_image": rng.random((3, 32, 32, 1), dtype=np.float32)}
    flip_mask = torch.from_numpy(rng.random((3, 2)) < 0.8)
    results = {}
    for device in ("cpu", "cuda"):
        torch.manual_seed(0)
        model = models.UNet(1, 3)
        teacher = copy.deepcopy(model).requires_grad_(False)
        init = torch.cat([p.detach().flatten() for p in teacher.parameters()])
        model.to(device)
        teacher.to(device)
        opt = optim.build_optimizer(model.parameters(),
                                    {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
        counter = torch.zeros((), dtype=torch.int64)
        step = steps.build_train_step(
            model, opt, "meanteacher", num_classes=3, generator=torch.Generator(device=device),
            teacher=teacher, reg_weight=10.0, ema_alpha=0.999, ema_weight_decay=1e-6,
            step_counter=counter)
        metrics = step({k: torch.from_numpy(v).to(device) for k, v in batch_np.items()},
                       flip_mask=flip_mask)
        check(int(counter) == 1, f"{device}: step counter {int(counter)}")
        sd = {k: v.detach().cpu() for k, v in teacher.state_dict().items()}
        results[device] = ({k: float(metrics[k]) for k in ("sup_loss", "uda", "total_loss")},
                           torch.cat([sd[k].flatten() for k, _ in teacher.named_parameters()]),
                           torch.cat([v.flatten() for k, v in sd.items() if "running_" in k]))
    (l_cpu, p_cpu, b_cpu), (l_gpu, p_gpu, b_gpu) = results["cpu"], results["cuda"]
    # after step 0 the teacher is the student times 1 - wd: its move from
    # init to the two-tier bound of the step phase (<= 2 lr; more than 0.05 lr
    # apart for under 0.5% of the elements)
    diffs = ((p_gpu - init) - (p_cpu - init)).abs()
    loose = float((diffs > 0.05 * 1e-3).float().mean())
    check(float(diffs.max()) <= 2.05e-3 and loose < 0.005,
          f"teacher moves: max {float(diffs.max())}, loose share {loose}")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"step_meanteacher losses differ: {rel}")
    # relative to the whole vector: Adam's first step moves a parameter by
    # about lr * sign(g), so single elements with a gradient at fp32 noise
    # may step opposite ways on the two devices
    rel_params = float((p_gpu - p_cpu).norm() / p_cpu.norm())
    rel_stats = float((b_gpu - b_cpu).norm() / b_cpu.norm())
    check(rel_params <= STEPS_TOL and rel_stats <= STEPS_TOL,
          f"teacher differs: parameters {rel_params}, BN statistics {rel_stats}")
    emit({"phase": "step_meanteacher", "losses_cpu": l_cpu, "losses_cuda": l_gpu, "rel_err": rel,
          "teacher_param_rel_err": rel_params, "teacher_bn_stats_rel_err": rel_stats,
          "teacher_param_max_abs_diff": float(diffs.max()), "teacher_param_loose_share": loose})


def phase_train(steps: int, backend: str = "auto"):
    """The headline trainer on the host path; with backend pallas_fused the
    fused kernels (2 forward and 4 backward launches a step) replace the
    mi_joint ones. Returns the trainer and the launch counts of this run of
    the kernels it uses (all counts set to 0 just before)."""
    import torch

    main_mod, mj, mf = port("main"), port("ops.mi_joint"), port("ops.mi_fused")
    fused = backend == "pallas_fused"
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", "Trainer.max_epoch=1", "Trainer.device=cuda",
            f"Kernel.backend={backend}",
            f"Trainer.save_dir=chip_smoke_udaiic{'_fused' if fused else ''}",
            "Trainer.step_timing=true"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mj.reset_launch_counts()
    mf.reset_launch_counts()
    t0 = time.perf_counter()
    trainer = main_mod.main(argv)
    wall = time.perf_counter() - t0
    used, other = (mf, mj) if fused else (mj, mf)
    counts = {f"{name}/p{p}": v for (name, p), v in sorted(used.LAUNCHES.items())}
    launches = sum(used.LAUNCHES.values())
    check(sum(other.LAUNCHES.values()) == 0,
          f"{backend}: {dict(other.LAUNCHES)} launches of the other path's kernels")
    check(trainer._projector.local_emit_logits == fused, f"{backend}: local_emit_logits")
    if fused:
        per_step = {name: mf.launch_count(name) / steps
                    for name in (mf.FWD, mf.BWD_DL2, mf.BWD_DL1)}
        check(per_step == {mf.FWD: 2, mf.BWD_DL2: 2, mf.BWD_DL1: 2},
              f"fused launches per step {per_step} (want 2 forward, 2 + 2 backward)")
    else:
        check(launches >= 6 * steps,
              f"{launches} kernel launches in {steps} steps (want >= 6 per step)")
    row = trainer._storage._rows[0]
    losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", "tra_uda_mean",
                                  "tra_mi_mean")}
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    val_dsc = row["val_dice_DSC_mean"]
    check(0.0 <= val_dsc <= 1.0, f"val DSC {val_dsc}")
    step_ms = statistics.median(trainer.step_times_ms[1:])
    out = {"phase": "train_fused" if fused else "train", "backend": backend, "steps": steps,
           "batch": [4, 10], "crop": 224,
           "launches": counts, "launches_per_step": launches / steps, "losses": losses,
           "val_dsc_mean": val_dsc, "first_step_ms": trainer.step_times_ms[0],
           "median_step_ms": step_ms, "step_ms": trainer.step_times_ms,
           "slices_per_s": 24 / (step_ms / 1e3), "epoch_wall_s": trainer.epoch_times_s[0],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wall_s": wall}
    emit(out)
    return trainer, dict(used.LAUNCHES), out["max_memory_allocated_gib"]


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
    want_rot = 2 * steps if geometry == "shear" else 0  # the labeled pair, the unlabeled batch
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


def _zoo_argv(save_dir: str, *extra: str) -> list:
    """The headline config through ``main.main`` on the card, ZOO_STEPS
    steps an epoch, one run dir under runs/."""
    return ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={ZOO_STEPS}", "Trainer.device=cuda",
            f"Trainer.save_dir={save_dir}", "Trainer.step_timing=true", *extra]


def _state_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _state_leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def phase_resume():
    """One epoch of the headline trainer, then two resumes from its run dir:
    one with no epoch left (the state just after the load, held against
    last.pth bit for bit; the load timed again on it), one that trains epoch
    1. Returns the run dir and the joint launches of the resumed epoch."""
    import torch

    main_mod, mj = port("main"), port("ops.mi_joint")
    save_dir = "chip_smoke_resume"
    shutil.rmtree(Path(port("engine.trainer").SemiTrainer.RUN_DIR) / save_dir, ignore_errors=True)
    first = main_mod.main(_zoo_argv(save_dir, "Trainer.max_epoch=1"))
    run = Path(first._save_dir)
    saved = torch.load(run / "last.pth", map_location="cpu", weights_only=True)
    meta = saved.pop("meta")

    loaded = main_mod.main(_zoo_argv(save_dir, "Trainer.max_epoch=1", f"Checkpoint={run}"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loaded.load_state_dict_from_path(str(run), strict=False)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    got = dict(_state_leaves(loaded.state_dict()))
    want = dict(_state_leaves(saved))
    check(got.keys() == want.keys(), f"resume: entries {sorted(got.keys() ^ want.keys())[:5]}")
    bad = [p for p, w in want.items() if not (
        torch.equal(got[p].cpu(), w) and got[p].dtype == w.dtype
        if isinstance(w, torch.Tensor) else got[p] == w)]
    check(not bad, f"resume: {len(bad)} entries differ from last.pth, e.g. {bad[:5]}")
    n_tensors = sum(isinstance(w, torch.Tensor) for w in want.values())
    check(loaded._start_epoch == 1 and loaded._best_score == meta["best_score"]
          and loaded._storage.state_dict() == meta["storage"],
          f"resume: start epoch {loaded._start_epoch}, best {loaded._best_score}")
    check(int(loaded._step_counter) == ZOO_STEPS, f"resume: step {int(loaded._step_counter)}")

    torch.cuda.synchronize()
    mj.reset_launch_counts()
    t0 = time.perf_counter()
    resumed = main_mod.main(_zoo_argv(save_dir, "Trainer.max_epoch=2", f"Checkpoint={run}"))
    wall = time.perf_counter() - t0
    launches = dict(mj.LAUNCHES)
    n_joint = sum(launches.values())
    check(resumed._start_epoch == 1 and sorted(resumed._storage._rows) == [0, 1]
          and len(resumed.epoch_times_s) == 1,
          f"resume: start epoch {resumed._start_epoch}, Storage rows "
          f"{sorted(resumed._storage._rows)}")
    check(n_joint >= 6 * ZOO_STEPS, f"resume: {n_joint} joint launches in {ZOO_STEPS} steps")
    row = resumed._storage._rows[1]
    check(all(math.isfinite(row[k]) for k in ("tra_sup_loss_mean", "tra_mi_mean")),
          f"resume: epoch 1 losses {row}")
    emit({"phase": "resume", "steps_per_epoch": ZOO_STEPS, "load_s": load_s,
          "tensors_equal_bit_for_bit": n_tensors, "entries_equal": len(want),
          "start_epoch": resumed._start_epoch, "storage_rows": len(resumed._storage._rows),
          "joint_launches_per_step": n_joint / ZOO_STEPS,
          "joint_launches": {f"{n}/p{p}": v for (n, p), v in sorted(launches.items())},
          "resumed_epoch_wall_s": resumed.epoch_times_s[0],
          "resumed_median_step_ms": statistics.median(resumed.step_times_ms[1:]),
          "main_wall_s": wall})
    return run, launches


def phase_inference(run: Path) -> None:
    """``Inference=true`` on the resume phase's run dir (its best.pth), on
    the host path and on the device-data path; each report's DSC_mean against
    the same trainer's test eval, its Hausdorff keys and its PNG dumps.
    ``trainer.inference()`` is timed once more after the main call."""
    main_mod = port("main")
    for device_data in ("false", "true"):
        trainer = main_mod.main(_zoo_argv(run.name, "Trainer.max_epoch=2", f"Checkpoint={run}",
                                          "Inference=true", f"Trainer.device_data={device_data}"))
        report = json.loads((run / "inference.json").read_text())
        _, dsc = trainer._eval_epoch(trainer._test_loader)
        check(abs(dsc - report["dice"]["DSC_mean"]) <= 1e-6,
              f"inference DSC_mean {report['dice']['DSC_mean']} vs test eval {dsc}")
        hd_keys = sorted(k for k in report["hd"] if k.startswith("hausdorff"))
        check(bool(hd_keys), f"inference: no hausdorff keys in {report['hd']}")
        n_test = len(trainer._test_loader.dataset)
        pngs = {f: len(list((run / f).glob("*.png"))) for f in ("img", "gt", "pred")}
        check(all(n == n_test for n in pngs.values()), f"inference PNGs {pngs}, {n_test} slices")
        t0 = time.perf_counter()
        trainer.inference()
        wall = time.perf_counter() - t0
        emit({"phase": "inference", "device_data": device_data == "true",
              "dsc_mean": report["dice"]["DSC_mean"], "test_eval_dsc_mean": dsc,
              "hd": report["hd"], "test_slices": n_test, "pngs": pngs,
              "inference_wall_s": wall, "s_per_test_slice": wall / n_test})


def phase_train_zoo():
    """ZOO_STEPS full-width steps of each of the other trainers through
    ``main.main``. Returns the rotation launches of the meanteacher run."""
    import torch

    main_mod, rot = port("main"), port("ops.rotate")
    runs = (("meanteacher", ["Trainer.name=meanteacher", "Trainer.device_data=true",
                             "Kernel.geometry=shear", "Trainer.scan_chunk=2"]),
            ("entropy", ["Trainer.name=entropy"]),
            ("uda_kl", ["Trainer.name=uda", "UDARegCriterion.name=kl"]))
    rot_launches = {}
    for name, extra in runs:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rot.reset_launch_counts()
        trainer = main_mod.main(_zoo_argv(f"chip_smoke_{name}", "Trainer.max_epoch=1", *extra))
        row = trainer._storage._rows[0]
        term = "tra_entropy_mean" if name == "entropy" else "tra_uda_mean"
        losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", term)}
        check(all(math.isfinite(v) for v in losses.values()), f"{name}: losses {losses}")
        val_dsc = row["val_dice_DSC_mean"]
        check(0.0 <= val_dsc <= 1.0, f"{name}: val DSC {val_dsc}")
        n_rot = rot.launch_count(rot.ROTATE)
        out = {"phase": "train_zoo", "trainer": name, "steps": ZOO_STEPS, "losses": losses,
               "val_dsc_mean": val_dsc, "rotation_launches_per_step": n_rot / ZOO_STEPS,
               "median_step_ms": statistics.median(trainer.step_times_ms[1:]),
               "step_ms": trainer.step_times_ms, "epoch_wall_s": trainer.epoch_times_s[0],
               "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
        if name == "meanteacher":
            out["median_step_ms_note"] = ("chunks of 2 steps, each step its chunk's wall time / 2:"
                                          " the median is the second chunk's")
            check(n_rot == 2 * ZOO_STEPS, f"meanteacher: {n_rot} rotation launches in "
                                          f"{ZOO_STEPS} steps (want 2 a step)")
            rot_launches = dict(rot.LAUNCHES)
            torch.manual_seed(int(trainer._config["RandomSeed"]))
            init = port("models").UNet(1, 4).state_dict()
            teacher = {k: v.cpu() for k, v in trainer._teacher.state_dict().items()}
            student = {k: v.cpu() for k, v in trainer._model.state_dict().items()}
            moved = {k: not torch.equal(teacher[k], init[k]) for k in teacher
                     if "num_batches" not in k}
            unlike = {k: not torch.equal(teacher[k], student[k]) for k in teacher
                      if "num_batches" not in k}
            check(all(moved.values()) and all(unlike.values()),
                  f"meanteacher: teacher entries at init {[k for k, v in moved.items() if not v]}"
                  f", equal to the student's {[k for k, v in unlike.items() if not v]}")
            out["teacher_entries_moved_and_unlike_student"] = len(moved)
        emit(out)
    return rot_launches


def _kernel_kind(name: str) -> str:
    lowered = name.lower()
    # the joint's kernels and the fused path's (which run on the joint's core)
    if any(k in lowered for k in ("fused_fwd", "fused_bwd", "joint_fwd", "joint_bwd",
                                  "joint_prep")):
        return "displaced-MI joint kernels (this port's CUDA: mi_joint, mi_fused)"
    if "rotate_shear" in lowered or "lane_roll" in lowered:
        return "rotation (this port's CUDA)"
    if any(k in lowered for k in ("batch_norm", "batchnorm", "bn_", "welford")):
        return "batch norm"
    if any(k in lowered for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
                                  "cutlass", "sm90_")):
        return "convolution / matmul and its layout copies (cuDNN, cuBLAS)"
    return "elementwise, reduction, copy"


def phase_profile(trainer, steps: int, path: str = "host") -> None:
    """Device time of a few train steps of a headline trainer, by kernel and
    by kind (torch.profiler with CUDA activity), on one batch: host images
    already on the card, or (a device-data trainer) slice indices whose
    gather and augmentation run inside each step. ``path`` labels the line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not trainer._device_data:
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
    parser.add_argument("--phases", default="device,build,kernels,step,step_fused,step_device,"
                                              "step_meanteacher,train,train_fused,train_device,"
                                              "resume,inference,train_zoo,profile")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    start = time.perf_counter()
    walls = {}  # seconds of the phases this slice added

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
    if "kernels" in phases:
        phase_kernels_wide(args.reps)
    rotation_rows = phase_kernels_rotate(args.reps) if "kernels" in phases else []
    fused_rows = phase_kernels_fused(args.reps) if "kernels" in phases else []
    if "step" in phases:
        phase_step()
    if "step_fused" in phases:
        phase_step(fused=True)
    if "step_device" in phases:
        phase_step_device()
    if "step_meanteacher" in phases:
        t0 = time.perf_counter()
        phase_step_meanteacher()
        walls["step_meanteacher"] = time.perf_counter() - t0
    trainer, launches, peak = (phase_train(args.steps) if "train" in phases
                               else (None, {}, None))
    fused_trainer, fused_launches, fused_peak = (phase_train(args.steps, "pallas_fused")
                                                 if "train_fused" in phases else (None, {}, None))
    if peak is not None and fused_peak is not None:
        # the fused path's reason to exist: no probability map in device memory
        check(fused_peak < peak, f"train_fused peak {fused_peak} GiB >= train peak {peak} GiB")
    device_trainer, rot_launches = None, {}
    if "train_device" in phases:
        device_trainer, rot_launches, _ = phase_train_device(args.steps, "shear")
        phase_train_device(args.steps, "fused")
    resume_launches, zoo_rot_launches = {}, {}
    if "resume" in phases or "inference" in phases:  # inference evaluates the resumed run
        t0 = time.perf_counter()
        run, resume_launches = phase_resume()
        walls["resume"] = time.perf_counter() - t0
        if "inference" in phases:
            t0 = time.perf_counter()
            phase_inference(run)
            walls["inference"] = time.perf_counter() - t0
    if "train_zoo" in phases:
        t0 = time.perf_counter()
        zoo_rot_launches = phase_train_zoo()
        walls["train_zoo"] = time.perf_counter() - t0
    if "profile" in phases:
        if trainer is not None:
            phase_profile(trainer, steps=3)
        if fused_trainer is not None:
            phase_profile(fused_trainer, steps=3, path="host_fused")
        if device_trainer is not None:
            phase_profile(device_trainer, steps=3, path="device")
    # one entry per kernel and main-path shape; the joint and the fused
    # kernels in the training path's bf16 mode. Launches: the joint's from the
    # host path's train phase, the fused kernels' from the train_fused phase,
    # the rotation's from the device path's shear run (lane_roll_rows is not
    # on that path: its counterpart of the JAX path's three-roll rotation is
    # the single-pass rotate_shear, which gives the same output)
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "label")
    summary = [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                    pct_of_bound=r["pct_of_bound"], vs_library=r["vs_library"],
                    launches=launches.get((r["name"], r["padding"])),
                    resume_launches=resume_launches.get((r["name"], r["padding"]), 0))
               for r in kernel_rows if r["mode"] == "bf16"]
    summary += [dict(name=f"{r['name']}@B{r['batch']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], l2_warm_ms=r["l2_warm_ms"],
                     launches=rot_launches.get((r["name"], r["batch"]), 0),
                     meanteacher_launches=zoo_rot_launches.get((r["name"], r["batch"]), 0),
                     on_main_path=r["name"] == "rotate_shear")
                for r in rotation_rows]
    summary += [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], unfused_path_ms=r["unfused_path_ms"],
                     launches=fused_launches.get((r["name"], r["padding"]), 0))
                for r in fused_rows if r["mode"] == "bf16"]
    emit({"phase": "walls", "seconds": walls, "script_s": time.perf_counter() - start})
    print(nvidia_smi(), flush=True)  # again beside the summary, for readers of the tail
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
