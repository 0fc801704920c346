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
           with the device time of each kernel the wrapper launches.
           Each joint and fused check also runs on bf16 operands (the
           model's bf16 compute: mode "bf16in"): the joint bit-exact on
           integer inputs, its bf16 gradients equal to the plain version's
           single rounding (also at 256 lanes), within TOL at the taps
           beside one bf16 step of the output's rounding; the fused kernels
           on bf16 logits with -inf dead lanes, exactly on dyadic logits and
           within their tolerances on random ones; each bf16in row timed
           beside its bound (operand bytes halved) and F.conv2d on bf16.
           Then the joint at the tile shapes of patch 32 (10 tiles of 32^2
           with their own zero border: [10, 34, 34, 100] at p = 1,
           [10, 38, 38, 100] at p = 3; C = S*K = 100 lanes) on fp32 and bf16
           operands: exactly on integer inputs, within TOL on probability
           maps, timed beside its bound and F.conv2d
  step     one small udaiic train step on the card against the same step on
           the CPU (plain joint), same weights, batch and flip mask
  step_fused  the same with the decoder heads emitting logits (fused kernels
           on the card, their plain version on the CPU): 6 fused launches
  step_device  the same on the device-data path with geometry=shear: the
           same store, injected augmentation draws and flip mask
  step_meanteacher  one small meanteacher step on the card against the CPU:
           the same weights, batch and flip mask; every loss and the
           teacher's parameters and BN statistics after its EMA update
  step_bf16  the step phase with Precision.compute_dtype=bn_dtype=bfloat16
           (bench.py's headline precision): losses at STEPS_TOL_BF16, the
           parameter moves against the CPU's bf16 step at STEP_BF16_LOOSE,
           closer to it than the CPU's fp32 step, the heads' at
           STEP_BF16_HEADS_LOOSE
  step_s2d the step phase with Arch.stem=s2d (fp32), at STEPS_TOL
  step_heads  the step phase with mlp heads, normalized, and patch 8 (9 tiles
           of the 16^2 map, 49 of the 32^2 one: a joint launch a tile and
           product), at STEPS_TOL
  train    the headline udaiic trainer through ``main.main`` on synthetic data
           (U-Net 16..256, 224^2 crops, 4 labeled + 10 unlabeled, taps Conv5 /
           Up_conv3 / Up_conv2, 5 x 20 clusters, paddings [1, 3]), with the
           kernel launch counts of that run, set to 0 just before it
  train_tiled  the same with IICRegParameters.LossParams.patch_sizes=32, 3
           steps: (36 + 169) x 3 joint launches a step, exactly; the step's
           device time by kind (profiler) and the joint's share of it
  train_heads  the same with mlp heads at every position and normalized
           decoder heads, 3 steps, 6 joint launches a step, fp32 and bf16,
           each then profiled (device time by kind)
  train_backends  the same with Kernel.backend = auto, pallas, xla,
           xla_banded, xla_scan from one seed, 2 steps each on one batch:
           pallas gives auto's losses and launches, the xla* backends launch
           no kernel and give the first step's losses within BACKEND_TOL of
           auto's; peak memory of each, xla_scan's below xla's
  train_fused  the same with Kernel.backend=pallas_fused: 2 fused forward and
           4 fused backward launches a step, no mi_joint launch, and a peak
           of device memory below the train phase's
  train_device  the same trainer on the device-data path
           (Trainer.device_data=true, 8 steps in chunks of 4), once with
           Kernel.geometry=shear (the rotation kernel, 2 launches a step) and
           once with the default fused geometry; counts set to 0 before each
  train_bf16  train, train_fused and train_device (shear) with
           Precision.compute_dtype=bn_dtype=bfloat16: the joint's and the fused
           kernels' bf16-operand launches (2 of each a step, none on fp32
           operands), step wall and peak beside the fp32 run's
  train_remat  the host-path trainer with and without Arch.remat=true from
           the same seed, 3 steps on one batch: the same losses (the first
           step bit for bit), a lower peak of device memory
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
  pretrain the contrastive pretrain pipeline through ``pretrain_main.main``
           at pretrain.yaml's widths (crop 224, 4 patients x 3 partitions, two
           views; projector mlp; IIC heads 10 x 10 on Conv5, 10 x 20 on
           Up_conv3 at padding 0): Trainer.name=iiccontrast, 3 steps in each
           phase (encoder, decoder, finetune): CSV and last.pth each, finite
           losses, frozen components bit-equal across each pretrain phase,
           the joint launched only in the decoder phase, 12 times a step (3
           products, each 4 launches: 200 lanes in two 128-lane blocks, the
           second zero-padded), each phase's step ms and peak; contrastMT's
           finetune alone (its CSV's val DSC the teacher's); one decoder-IIC
           step on the card against the CPU at crop 32 (STEPS_TOL); the
           joint at the decoder's shape ([150528, 200], p = 0) exactly on
           integer inputs, within TOL on probability maps, timed beside its
           bound and torch.matmul
  optim    the headline trainer through ``main.main`` under Optim.name=SGD
           (momentum 0.9) and RAdam: 6 joint launches a step each, finite
           losses; a resume under SGD equal to last.pth in every entry; then
           every OPTIMIZERS name stepped 6 times on that trainer's parameters
           (model and projector), card against CPU from the same values and
           gradients within OPTIM_TOL of the largest move, with the card's
           step time
  arch_zoo every model family of ``get_arch`` (ENet, Attention U-Net,
           DeepLabV2 / V3 / V3+, V3+ also at n_blocks (3, 4, 23, 3), VNet,
           DenseNet3D) and VGG11 + ClassifyHead at full width on ACDC-shaped
           input (14 x 1 x 224^2; volumes 2 x 1 x 16 x 224^2), fp32 and bf16:
           a forward, backward and Adam step, median step ms, device ms
           (profiler), busy share and peak memory; a small eval forward card
           against CPU within ZOO_TOL
  host_tier  the host tier on the card's host (its CPU model and count
           beside the card): the native host library (built by the build
           phase with g++) decodes every synthetic PNG as PIL does; native
           against numpy on 50 draws, held to the CPU tests' pin (the labels
           differ on seed 27 alone, by 2 pixels of a rotation tie; the jitter
           by more than 0 and at most HOST_JITTER_GAP); the median ms of one ACDCStrongTransforms.pretrain
           sample (HOST_DRAWS draws, one thread) and of one batch of each
           headline loader (4 and 10 slices, 4 workers), native and numpy;
           then the headline udaiic trainer through ``main.main`` on the host
           path, fp32 and bf16, each with the native library and with
           MISST_DISABLE_NATIVE=1: epoch wall, the wall between consecutive
           steps (fetch included), the step's device time (profiler, one
           batch) and busy share, 6 joint launches a step, the loaders (N + 3)
           x 14 samples on after the prefetch, and one native augment_pair
           call for every sample drawn (none with it off)
  parallel data parallelism on the one card: 4 gloo ranks on cuda:0, each the
           headline udaiic step (fp32, crop 224) on its rows of the 4 + 10
           batch padded to 4 + 12 (pad-and-mask), its losses and BN
           statistics at STEPS_TOL and its parameter moves at the step
           phase's bound and its summed gradients within PAR_GRAD_TOL
           (relative L2; the Conv5 head's, at noise, reported only) against
           the one-process card step on the unpadded batch, 6 joint launches
           a rank; then the dry run on those ranks
           (parallel/dryrun.py: the flagship step padded, the device-data
           epoch loop, Kernel.augment=epoch, the eval scan over the ranks'
           slices, a checkpoint saved by rank 0 and reloaded by all); between
           the two, in the same spawn, two groups of 2 ranks side by side:
           the fused step (4 + 8, 2 + 4 fused launches a rank, no joint
           launch) and the device-path step (shear, 2 rotation launches a
           rank), each against one process. Any rank's failure fails the
           phase; a rank's step ms is that of ranks time-sharing one card
  train_parallel  the train phase's run through main.main under an NCCL
           group of world 1 set up as torchrun sets it: no data group (a
           rank that holds the whole batch runs the one-process step), the
           losses within STEPS_TOL of the train phase's, the step wall beside
           it, a profile with no collective and as many device events a
           step as without the group (within 1%: the profiler can lose a
           few), the group left at the end
  pretrain_parallel  the pretrain pipeline data parallel on the one card: 4
           gloo ranks on cuda:0, each one step of the iiccontrast encoder and
           decoder phases and of contrastMT's finetune on its 3 of the 12
           slices at 224^2 (1 + 3 in finetune; pretrain.yaml's heads), against
           the same steps in one process on the card: losses and BN
           statistics (the teacher's too) at STEPS_TOL, parameter moves at
           the step phase's bound, summed gradients within PAR_GRAD_TOL,
           exactly 12 joint launches a rank in the decoder step (3 products
           x 4 pairs of 128-lane blocks, p = 0, 37,632 rows) and none in the
           others; each rank's step ms. Then pretrain_main under an NCCL group
           of world 1 set up as torchrun sets it: no data group, no
           collective call, 12 launches a decoder step, the losses within
           STEPS_TOL of the pretrain phase's run
  profile  device time by kernel and by kind over a few more steps of the host
           path's trainer, the fused trainer and the device path's (shear)
           trainer (torch.profiler), and the device's busy share of the wall;
           the same for the three bf16 trainers, whose bf16-operand kernel
           variants must appear by name

The line before the last is the JSON ``kernels`` summary; the last line is
``{"ok": true, "device": {...}}``. A failed check raises, and the script exits
non-zero without printing a result. Without a CUDA device it exits 2.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from functools import partial
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
# the tiles of patch 32 at those taps: (name, batch, tile edge, padding)
TILES = (("Up_conv3", 10, 32, 1), ("Up_conv2", 10, 32, 3))
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
# step_bf16: card vs CPU losses (relative). cuDNN's bf16 convolutions sum in
# another order than the CPU's, so a last-bit difference flips a bf16 output
# by one step now and then, and train-mode BN on this small random-init net
# amplifies the flips layer by layer (tests/test_torch_precision.py measures
# the same against the JAX package: up to 3.1e-3 on the losses)
STEPS_TOL_BF16 = 2e-2
# step_bf16's parameter moves. Adam's first move is about lr * sign(g), and
# the bf16 gradients of this random-init net are mostly rounding noise in the
# encoder (the JAX bf16 step's sit 0.73 relative L2 from its fp32 step's), so
# two right bf16 steps move 10-15% of the elements opposite ways (the port's
# CPU step against the JAX package's, tests/test_torch_precision.py: 0.103-
# 0.149; card against CPU: 0.122). Held: that share, below 0.75 of the share
# of the CPU's fp32 step (0.237: a dtype ignored), and the share in the heads
# (the 1x1 head, the projector's), whose gradients come straight from the
# losses (port against JAX: <= 0.0063; card against CPU: 0.034; a wrong
# gradient there: ~0.5)
STEP_BF16_LOOSE = 0.2
STEP_BF16_LIVENESS = 0.75
STEP_BF16_HEADS_LOOSE = 0.1
BF16 = ("Precision.compute_dtype=bfloat16", "Precision.bn_dtype=bfloat16")
# train_heads: mlp heads at every position, the decoder heads normalized
HEADS = ("IICRegParameters.EncoderParams.head_types=mlp",
         "IICRegParameters.DecoderParams.head_types=mlp",
         "IICRegParameters.DecoderParams.normalize=true")
TILE_PATCH = 32      # train_tiled: the original project's default patch size
# train_backends: the first step's losses of each xla* backend (fp32 products)
# against auto's (bf16 operands, fp32 sums), relative; tests/test_pallas_mi.py
# holds bf16 against fp32 joints at 5e-3. pallas is auto's kernel: bit for bit.
BACKEND_TOL = 5e-3
ZOO_STEPS = 4        # steps of each resume / train_zoo run
PRETRAIN_STEPS = 3   # pretrain: batches an epoch, one epoch a phase
# the pretrain decoder's IIC map (pretrain.yaml): Up_conv3 of 4 patients x 3
# partitions at crop 224, padding 0; IICHead.Decoder's 10 x 20 clusters
PRETRAIN_TAP = ("Up_conv3", 12, 112, 0)
PRETRAIN_HEAD = (10, 20)
# optim: main.main under these Optim sections (6 joint launches a step as
# under Adam); every OPTIMIZERS name stepped OPTIM_STEPS times (past
# Lookahead's sync at 5, Ranger's and RAdam's rectification at 6) on the
# udaiic parameter set, card against CPU on the same gradients: each element
# within OPTIM_TOL of the largest move plus OPTIM_ULPS of its own value's
# fp32 spacing (both sides run the same ops, but a contracted multiply-add on
# the card or a reduction summed in another order moves an update by an ulp,
# and p + u then rounds to the neighbouring float)
OPTIM_RUNS = {"SGD": ("Optim.name=SGD", "Optim.momentum=0.9"), "RAdam": ("Optim.name=RAdam",)}
OPTIM_STEPS = 6
OPTIM_TOL, OPTIM_ULPS = 1e-4, 2.0
# arch_zoo: every family at full width on ACDC-shaped input (2-D: 14 slices of
# 224^2, the headline step's 4 + 10; 3-D: an ACDC volume's slices padded to 16,
# a multiple of VNet's three stride-2 stages), a forward, backward and Adam
# step each in fp32 and bf16; and a small eval forward card against CPU within
# ZOO_TOL of the largest logit (cuDNN and the CPU sum in other orders)
ZOO_2D, ZOO_3D = (14, 1, 224, 224), (2, 1, 16, 224, 224)
ZOO_ACDC = {"input_dim": 1, "num_classes": 4}
ZOO_RUNS = (("enet", ZOO_ACDC, ZOO_2D), ("attention_unet", ZOO_ACDC, ZOO_2D),
            ("deeplabv2", ZOO_ACDC, ZOO_2D), ("deeplabv3", ZOO_ACDC, ZOO_2D),
            ("deeplabv3plus", ZOO_ACDC, ZOO_2D),
            ("deeplabv3plus", dict(ZOO_ACDC, n_blocks=(3, 4, 23, 3)), ZOO_2D),
            ("vgg11", {"input_dim": 1}, ZOO_2D),
            ("vnet", ZOO_ACDC, ZOO_3D), ("densenet3d", {"input_dim": 1}, ZOO_3D))
ZOO_STEPS_TIMED = 3
ZOO_TOL = 1e-4
HOST_DRAWS = 200         # host_tier: per-sample draws of ACDCStrongTransforms.pretrain
HOST_BATCHES = 5         # host_tier: timed batches of each headline loader (after one)
# native vs numpy, pinned as in tests/test_torch_native.py: the jitter differs
# (0 < gap <= HOST_JITTER_GAP) and the labels on seed 27 alone, by 2 pixels
HOST_JITTER_GAP = 2.4e-7
HOST_TIE_PIXELS = {27: 2}
IMPORTED_AT = time.time()  # a spawned rank's import of this file: its startup's first part


@contextmanager
def timed(walls: dict, name: str):
    """Adds the wall seconds of the block to ``walls[name]``."""
    t0 = time.perf_counter()
    yield
    walls[name] = time.perf_counter() - t0


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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    with ThreadPoolExecutor(1) as pool:  # g++ for the host library while nvcc runs
        host = pool.submit(build.build_host, "host_pipeline")
        paths = build.build(sources)
        host_path = host.result()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(k in ln for k in ("registers", "spill", "entry function", "wgmma"))]
             for name, log in build.build_logs.items() if name in sources}
    emit({"phase": "build", "sources": sources, "seconds": time.perf_counter() - t0,
          "libraries": {k: str(v) for k, v in paths.items()}, "ptxas": ptxas,
          "host_library": str(host_path), "host_flags": list(build.HOST_FLAGS)})


def _tap_inputs(batch: int, edge: int, padding: int, gen, clusters: int = CLUSTERS,
                lanes: int = LANES, subheads: int = SUBHEADS):
    """Probabilities as the training path feeds the joint: per-subhead
    softmax in subheads x clusters of `lanes` lanes, dead lanes 0, a zero
    border of width p."""
    import torch

    hp = edge + 2 * padding
    z = torch.randn((batch, hp, hp, subheads, clusters), generator=gen, device="cuda")
    probs = torch.softmax(z, -1).reshape(batch, hp, hp, subheads * clusters)
    probs = torch.nn.functional.pad(probs, (0, lanes - subheads * clusters))
    valid = torch.zeros((1, hp, hp, 1), device="cuda")
    valid[:, padding:hp - padding, padding:hp - padding] = 1.0
    return (probs * valid).reshape(-1, lanes).contiguous()


def _exact_check(mj, n: int, wp: int, p: int, gen, lanes: int = LANES, dtype=None) -> None:
    """Small integers are exact in bf16, and every sum stays below 2^24
    whatever the summation order, so the kernel must equal the plain version
    bit for bit in both modes: a missing, doubled or misplaced row or
    displacement shows here. Every row holds data, so the slabs' first and
    last rows and the zero fill beyond both ends of [0, N) are exercised.
    With bf16 operands (``dtype``) the gradients come back bf16: each exact
    fp32 sum rounded once on both sides, so again bit for bit."""
    import torch

    dtype = dtype or torch.float32
    d = (2 * p + 1) ** 2
    a = torch.randint(0, 2, (n, lanes), generator=gen, device="cuda").to(dtype)
    b = torch.randint(0, 2, (n, lanes), generator=gen, device="cuda").to(dtype)
    g = torch.randint(-2, 3, (d, lanes, lanes), generator=gen, device="cuda").float()
    ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ref = mj.displaced_joint_plain_flat(ap, bp, wp, p)
    ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), g)
    ref = ref.detach()
    for bf16 in ((True,) if dtype == torch.bfloat16 else (True, False)):
        got = {"fwd": (mj.mi_joint_fwd(a, b, wp, p, bf16), ref),
               "dx": (mj.mi_joint_bwd(b, g, wp, p, True, bf16), ref_da),
               "dx_tf": (mj.mi_joint_bwd(a, g, wp, p, False, bf16), ref_db)}
        for what, (x, y) in got.items():
            err = float((x.float() - y.float()).abs().max())
            check(err == 0.0 and x.dtype == y.dtype,
                  f"exact {what} p={p} {lanes} lanes {dtype} bf16={bf16}: max err {err}, "
                  f"{x.dtype} vs {y.dtype}")


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
    gr = g.to(dot).float()
    # bf16 operands are taken as they are; their gradients come back bf16
    ar, br = (a, b) if a.dtype == torch.bfloat16 else (t.to(dot).float() for t in (a, b))
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


def _joint_rows(mj, cases: dict, dtype, where: dict, n: int, c: int, p: int, flops: float,
                nbytes: float, bf16: bool, reps: int, extra=None) -> list:
    """Check and time the joint's three products (``_joint_cases``) on
    operands of ``dtype``: each kernel call within TOL of the plain version
    (a bf16 gradient beside one bf16 step of its own rounding), two calls
    bit-identical; its time beside the plain version's, the library call's
    and the bound. ``where``: the keys that place the rows (phase, tap,
    label, mode); ``extra``: more keys of every row."""
    import torch

    replaces = {mj.FWD: f"{JAX_KERNELS}:178", mj.BWD_DX_TF: f"{JAX_KERNELS}:230",
                mj.BWD_DX: f"{JAX_KERNELS}:249"}
    peak = PEAK_FLOPS["bf16" if bf16 else "fp32"]
    rows = []
    for base, case in cases.items():
        name = mj.kernel_name(base, dtype)
        got = case["kernel"]()
        want = case["want"]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        scale = float(want.float().abs().max())
        # a bf16 gradient adds its output's rounding: an fp32 sum that lies
        # within the summation-order difference of a rounding midpoint
        # rounds the other way, one bf16 step (of the exponent of |want|)
        bf16_steps = None
        if got.dtype == torch.bfloat16:
            step = torch.exp2(torch.floor(torch.log2(want.float().abs())) - 7)
            # the reading behind the allowance: the largest error, in
            # steps of its own entry, among entries off by more than TOL
            off = diff > TOL * scale
            bf16_steps = float((diff / step)[off].max()) if bool(off.any()) else 0.0
            diff = (diff - step).clamp_min(0)
        label = f"{where['label']} {where['mode']} {name}"
        check(math.isfinite(err) and float(diff.max()) <= TOL * scale,
              f"{label}: max err {err} vs max |ref| {scale}")
        check(bool(torch.equal(case["kernel"](), got)),
              f"{label}: two calls on the same inputs differ")
        lib_err = float((case["unpack"](case["library"]()).float()
                         - want.float()).abs().max())
        by_ops = flops / peak >= nbytes / HBM_BYTES_PER_S
        row = {**where, "name": name, "route": "cuda", "source": f"{PORT}/csrc/mi_joint.cu",
               "replaces": replaces[base], "shape": [n, c], "padding": p,
               "max_abs_err": err, "max_abs_ref": scale, "tol_rel": TOL,
               "max_bf16_steps": bf16_steps,
               "ms": cuda_ms(case["kernel"], reps),
               "plain_ms": cuda_ms(case["plain"], max(3, reps // 3), warmup=1),
               "library_ms": cuda_ms(case["library"], max(3, reps // 3), warmup=1),
               "library_rel_err": lib_err / scale,
               "bound_ms": max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3,
               "bound_by": "operations" if by_ops else "bytes",
               "gflop": flops / 1e9}
        row["achieved_tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        if bf16:  # the wrapper's kernels: (conversion,) product(, chunk sum)
            row["device_ms_by_kernel"] = device_split(case["kernel"], reps)
        row.update(extra or {})
        emit(row)
        rows.append(row)
    return rows


def phase_kernels(reps: int) -> list:
    import torch

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for batch, hp, wp, p in RAGGED:
        n = batch * hp * wp
        _exact_check(mj, n, wp, p, gen)
        _exact_check(mj, n, wp, p, gen, dtype=torch.bfloat16)
        emit({"phase": "kernels", "ragged": [batch, hp, wp, p], "exact_check": "passed",
              "exact_check_bf16in": "passed", "shape": [n, LANES]})
    for tap, batch, edge, p in TAPS:
        hp = edge + 2 * p
        d = (2 * p + 1) ** 2
        n = batch * hp * hp
        _exact_check(mj, n, hp, p, gen)
        _exact_check(mj, n, hp, p, gen, dtype=torch.bfloat16)
        emit({"phase": "kernels", "tap": tap, "exact_check": "passed",
              "exact_check_bf16in": "passed", "shape": [n, LANES]})
        a = _tap_inputs(batch, edge, p, gen)
        b = _tap_inputs(batch, edge, p, gen)
        c = LANES
        g = torch.randn((d, c, c), generator=gen, device="cuda") * 1e-3
        flops = 2.0 * n * c * c * d
        # mode -> operands: bf16 products of fp32 maps, the fp32 parity mode,
        # bf16 products of bf16 maps (the model's bf16 compute)
        operands = {"bf16": (a, b), "fp32": (a, b),
                    "bf16in": (a.to(torch.bfloat16), b.to(torch.bfloat16))}
        for mode, (ma, mb) in operands.items():
            bf16 = mode != "fp32"
            # fwd: A, B in, J out; bwd: S, g in, [N, C] out (operands in their type)
            nbytes = 2.0 * ma.element_size() * n * c + 4.0 * d * c * c
            cases = _joint_cases(mj, ma, mb, g, batch, hp, p, bf16)
            rows += _joint_rows(mj, cases, ma.dtype,
                                {"phase": "kernels", "tap": tap, "label": tap, "mode": mode},
                                n, c, p, flops, nbytes, bf16, reps)
            del cases
        del a, b, g, operands
        torch.cuda.empty_cache()
    return rows


def phase_kernels_tiles(reps: int) -> list:
    """The joint at the tile shapes of patch 32 (``IICRegParameters.LossParams.
    patch_sizes=32``, the train_tiled phase): 10 tiles of 32^2 each with its
    own zero border (34^2 at Up_conv3's p = 1, 38^2 at Up_conv2's p = 3) and
    C = S*K = 100 lanes, no dead ones; exactly on integer inputs, then on
    probability maps within TOL, on fp32 operands (bf16 products, the fp32
    model's) and bf16 operands. The bound counts the function's 100 lanes
    (``bound_ms_128``: the 128 lanes the kernels compute)."""
    import torch

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []
    for tap, batch, edge, p in TILES:
        hp = edge + 2 * p
        d = (2 * p + 1) ** 2
        n = batch * hp * hp
        c = SUBHEADS * CLUSTERS
        _exact_check(mj, n, hp, p, gen, lanes=c)
        _exact_check(mj, n, hp, p, gen, lanes=c, dtype=torch.bfloat16)
        emit({"phase": "kernels", "tile": tap, "exact_check": "passed",
              "exact_check_bf16in": "passed", "shape": [n, c], "padding": p})
        a = _tap_inputs(batch, edge, p, gen, lanes=c)
        b = _tap_inputs(batch, edge, p, gen, lanes=c)
        g = torch.randn((d, c, c), generator=gen, device="cuda") * 1e-3
        flops = 2.0 * n * c * c * d
        for mode, (ma, mb) in {"bf16": (a, b), "bf16in": (a.to(torch.bfloat16),
                                                          b.to(torch.bfloat16))}.items():
            nbytes = 2.0 * ma.element_size() * n * c + 4.0 * d * c * c
            cases = _joint_cases(mj, ma, mb, g, batch, hp, p, bf16=True)
            where = {"phase": "kernels", "tap": f"tile_{tap}", "label": f"{tap} tile {edge}",
                     "mode": mode}
            bound_128 = max(nbytes / HBM_BYTES_PER_S,
                            flops * (LANES / c) ** 2 / PEAK_FLOPS["bf16"]) * 1e3
            rows += _joint_rows(mj, cases, ma.dtype, where, n, c, p, flops, nbytes, True, reps,
                                extra={"bound_ms_128": bound_128})
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
    # bf16 operands: the lane blocks' fp32 sums rounded once, as at 128 lanes
    _exact_check(mj, batch * hp * wp, wp, p, gen, lanes, dtype=torch.bfloat16)
    emit({"phase": "kernels", "ragged": list(RAGGED[1]), "lanes": lanes, "exact_check": "passed",
          "exact_check_bf16in": "passed"})
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
        f1, f2 = _fused_logits(n, gen, kind), _fused_logits(n, gen, kind)
        args = (hp, wp, p, s, k, 1.0)
        # fp32 logits in both product modes, then bf16 logits (the bf16 heads':
        # dyadic values exact, dead lanes -inf) in the bf16 mode
        for logits, dot in (((f1, f2), torch.bfloat16), ((f1, f2), torch.float32),
                            ((f1.to(torch.bfloat16), f2.to(torch.bfloat16)), torch.bfloat16)):
            l1, l2 = logits
            bf16 = dot == torch.bfloat16
            got = {"fwd": (mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                           mf.fused_fwd_plain(l1, l2, *args, dot)),
                   "dl2": (mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16),
                           mf.fused_bwd_side_plain(l1, l2, g, *args, dot, transpose_g=False)),
                   "dl1": (mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16),
                           mf.fused_bwd_side_plain(l2, l1, g, *args, dot, transpose_g=True))}
            for what, (x, y) in got.items():
                err = float((x.float() - y.float()).abs().max())
                # (the one-hot softmax is saturated: its fp32 d(logits) are all 0)
                nonzero = what == "fwd" or kind == "uniform"
                check(err == 0.0 and x.dtype == y.dtype
                      and (float(y.float().abs().max()) > 0 or not nonzero),
                      f"exact fused {kind} {what} p={p} {l1.dtype} {dot}: max err {err}")


def _fused_compare(mf, name: str, bf16: bool, got, want, where: str):
    """(max error, max |want|, share of entries off by more than TOL of it,
    the tolerance held): random logits against the plain version."""
    diff = (got.float() - want.float()).abs()
    err, scale = float(diff.max()), float(want.float().abs().max())
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
    f1, f2 = _fused_logits(n, gen), _fused_logits(n, gen)
    g = torch.randn((d, LANES, LANES), generator=gen, device="cuda") * 1e-3
    args = (hp, wp, p, SUBHEADS, CLUSTERS, 1.0)
    errs = {}
    for (l1, l2), dot, mode in (((f1, f2), torch.bfloat16, "bf16"),
                                ((f1, f2), torch.float32, "fp32"),
                                ((f1.to(torch.bfloat16), f2.to(torch.bfloat16)), torch.bfloat16,
                                 "bf16in")):
        bf16 = dot == torch.bfloat16
        for name, got, want in (
                (mf.FWD, mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                 mf.fused_fwd_plain(l1, l2, *args, dot)),
                (mf.BWD_DL2, mf.mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16),
                 mf.fused_bwd_side_plain(l1, l2, g, *args, dot, transpose_g=False)),
                (mf.BWD_DL1, mf.mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16),
                 mf.fused_bwd_side_plain(l2, l1, g, *args, dot, transpose_g=True))):
            err, scale, _, _ = _fused_compare(mf, name, bf16, got, want,
                                              f"ragged n={n} p={p} {mode}")
            errs[f"{name}/{mode}"] = err / scale
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
        fp32_logits = (l1, l2)
        for mode in ("bf16", "fp32", "bf16in"):
            bf16 = mode != "fp32"
            dot = torch.bfloat16 if bf16 else torch.float32
            # bf16in: the bf16 heads' logits (dead lanes -inf) and, on the unfused
            # path, their bf16 probabilities
            l1, l2 = (t.to(torch.bfloat16) if mode == "bf16in" else t for t in fp32_logits)
            esz = l1.element_size()
            fwd_bytes = esz * 2 * n * live + 4.0 * d * live * live  # two logit maps in, J out
            bwd_bytes = esz * 3 * n * live + 4.0 * d * live * live  # two maps, g in, dl out
            # the unfused path: per-group softmax and mask as separate kernels,
            # probabilities in device memory, then the mi_joint kernels
            leaves = [t.clone().requires_grad_(True) for t in (l1, l2)]
            probs = [heads.group_softmax_flat(t, SUBHEADS, CLUSTERS) * valid.to(t.dtype)
                     for t in leaves]
            saved = [t.detach().contiguous() for t in probs]
            peak = PEAK_FLOPS["bf16" if bf16 else "fp32"]
            unfused_bwd = lambda own, src, tr: torch.autograd.grad(
                probs[own], leaves[own], mj.mi_joint_bwd(saved[src], g, hp, p, tr, bf16),
                retain_graph=True)
            cases = {
                mf.FWD: dict(
                    kernel=lambda: mf.mi_fused_fwd(l1, l2, *args, bf16=bf16),
                    plain=lambda: mf.fused_fwd_plain(l1, l2, *args, dot),
                    unfused=lambda: mj.mi_joint_fwd(
                        (heads.group_softmax_flat(l1, SUBHEADS, CLUSTERS) * valid.to(l1.dtype)),
                        (heads.group_softmax_flat(l2, SUBHEADS, CLUSTERS) * valid.to(l2.dtype)),
                        hp, p, bf16),
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
            for base, case in cases.items():
                name = mj.kernel_name(base, l1.dtype)
                err, scale, share, tol = _fused_compare(mf, base, bf16, case["kernel"](),
                                                        case["plain"](), f"{tap} {mode}")
                by_ops = flops / peak >= case["nbytes"] / HBM_BYTES_PER_S
                row = {"phase": "kernels", "name": name, "tap": tap, "label": tap, "mode": mode,
                       "route": "cuda", "source": f"{PORT}/csrc/mi_fused.cu",
                       "replaces": replaces[base], "shape": [n, c], "live_lanes": live,
                       "padding": p, "max_abs_err": err, "max_abs_ref": scale, "tol_rel": tol,
                       "share_above_tol": share,
                       "ms": cuda_ms(case["kernel"], reps),
                       "plain_ms": cuda_ms(case["plain"], max(3, reps // 3), warmup=1),
                       "unfused_path_ms": cuda_ms(case["unfused"], max(3, reps // 3), warmup=1),
                       "library_ms": None,
                       "bound_ms": max(case["nbytes"] / HBM_BYTES_PER_S, flops / peak) * 1e3,
                       "bound_by": "operations" if by_ops else "bytes",
                       "gflop": flops / 1e9}
                row["achieved_tflops"] = flops / (row["ms"] * 1e-3) / 1e12
                row["pct_of_bound"] = 100.0 * row["bound_ms"] / row["ms"]
                row["vs_unfused"] = row["ms"] / row["unfused_path_ms"]
                if bf16:  # the wrapper's kernels: softmax pass, product(, chunk sum)
                    row["device_ms_by_kernel"] = device_split(case["kernel"], reps)
                emit(row)
                rows.append(row)
            del cases, leaves, probs, saved
        del l1, l2, g, valid, fp32_logits
        torch.cuda.empty_cache()
    return rows


def _step_run(device: str, dtype, fused: bool, stem: str, heads=None, patch: int = 1024):
    """One udaiic step (crop 32, 2 + 3 slices, 3 classes, 2 x 5 clusters,
    paddings [1, 3]) on ``device`` from the weights of seed 0: its losses,
    each parameter's move, the (mi_joint, mi_fused) launches and the names of
    the kernels launched. ``heads``: the projector's head options
    (head_types, normalize); ``patch``: patch_sizes."""
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
    torch.manual_seed(0)
    model = models.UNet(1, 3, dtype=dtype, bn_dtype=dtype, stem=stem)
    proj = models.ProjectorWrapper(feats, num_clusters=5, num_subheads=2,
                                   local_emit_logits=fused, local_dtype=dtype, **(heads or {}))
    model.to(device)
    proj.to(device)
    params = list(chain(model.named_parameters(), proj.named_parameters(prefix="proj")))
    opt = optim.build_optimizer([p for _, p in params],
                                {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
    step = steps.build_train_step(
        model, opt, "udaiic", num_classes=3, generator=torch.Generator(device=device),
        feature_names=feats, feature_importance=[1.0, 0.5, 0.5], projector=proj, uda_weight=10.0,
        iic_weight=0.1, reg_weight=1.0, paddings=[1, 3], patch_sizes=patch)
    before = {k: p.detach().cpu().clone() for k, p in params}
    mj.reset_launch_counts()
    mf.reset_launch_counts()
    metrics = step({k: torch.from_numpy(v).to(device) for k, v in batch_np.items()},
                   flip_mask=flip_mask)
    launches = (sum(mj.LAUNCHES.values()), sum(mf.LAUNCHES.values()))
    names = sorted({k for k, _ in chain(mj.LAUNCHES, mf.LAUNCHES)})
    return ({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
            {k: p.detach().cpu() - before[k] for k, p in params}, launches, names)


def _loose_share(moves, ref, keys=None) -> float:
    """The share of parameter elements whose first Adam move (about lr times
    the gradient's sign) differs from ``ref``'s by more than 0.05 lr."""
    import numpy as np

    keys = list(ref) if keys is None else keys
    diffs = np.concatenate([(moves[k] - ref[k]).abs().flatten().numpy() for k in keys])
    return float(np.mean(diffs > 0.05 * 1e-3)) if diffs.size else 0.0


def joint_calls(edges, patch: int) -> int:
    """The joint's kernel calls a step (forward and two backward products a
    tile) over decoder maps of the given edges at ``patch``."""
    tiles = port("ops.iic_local")._tiles
    return 3 * sum(len(tiles(e, e, patch)) for e in edges)


def phase_step(fused: bool = False, phase: str = "", dtype=None, stem: str = "conv",
               tol: float = STEPS_TOL, heads=None, patch: int = 1024) -> None:
    """One udaiic step (``_step_run``) on the card and on the CPU from the
    same weights; with ``fused`` the decoder heads emit logits (the fused
    kernels on the card). ``dtype``: the compute and BN dtype (bf16: the
    kernels' bf16-operand variants on the card, losses at ``tol``, the
    parameter moves as STEP_BF16_* says); ``stem``: the U-Net's stem;
    ``heads``, ``patch``: head options and patch_sizes (step_heads: mlp,
    normalized, patch 8 on the 16^2 and 32^2 maps, one joint launch a tile
    and product)."""
    import numpy as np
    import torch

    dtype = dtype or torch.float32
    phase = phase or ("step_fused" if fused else "step")
    mj = port("ops.mi_joint")
    (l_cpu, d_cpu, n_cpu, _), (l_gpu, d_gpu, n_gpu, names) = (
        _step_run(device, dtype, fused, stem, heads, patch) for device in ("cpu", "cuda"))
    want = (0, 6) if fused else (joint_calls((16, 32), patch), 0)
    check(n_cpu == (0, 0) and n_gpu == want,
          f"{phase} launches (mi_joint, mi_fused) cpu={n_cpu} cuda={n_gpu} (want (0, 0), {want})")
    bf16_in = dtype == torch.bfloat16
    check(all(n.endswith(mj.BF16_OPERANDS) == bf16_in for n in names),
          f"{phase}: launched {names} on {dtype} operands")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= tol for v in rel.values()), f"{phase} losses differ: {rel}")
    # Adam's first step is ~ -lr * sign(g): where a gradient is near fp32
    # noise the two sides may step opposite ways (<= 2 lr); the bulk agrees
    diffs = np.concatenate([(d_gpu[k] - d_cpu[k]).abs().flatten().numpy() for k in d_cpu])
    loose = _loose_share(d_gpu, d_cpu)
    out = {"phase": phase, "dtype": str(dtype), "stem": stem, "heads": heads, "patch": patch,
           "losses_cpu": l_cpu,
           "losses_cuda": l_gpu, "rel_err": rel, "tol_rel": tol,
           "param_delta_max_diff": float(diffs.max()), "param_delta_loose_share": loose,
           "launches_cuda": dict(zip(("mi_joint", "mi_fused"), n_gpu)), "kernels": names}
    if not bf16_in:
        check(diffs.max() <= 2.05e-3 and loose < 0.005, f"param deltas: max {diffs.max()}, "
              f"loose share {loose}")
    else:
        # the same step in fp32 on the CPU: how far a step that ignored the
        # dtype would sit from the CPU's bf16 step
        d_fp32 = _step_run("cpu", torch.float32, fused, stem)[1]
        heads = [k for k in d_cpu if k.startswith(("proj.", "DeConv_1x1."))]
        out.update(param_delta_loose_share_fp32=_loose_share(d_fp32, d_cpu),
                   param_delta_loose_share_heads=_loose_share(d_gpu, d_cpu, heads))
        check(diffs.max() <= 2.05e-3 and loose <= STEP_BF16_LOOSE
              and loose < STEP_BF16_LIVENESS * out["param_delta_loose_share_fp32"]
              and out["param_delta_loose_share_heads"] <= STEP_BF16_HEADS_LOOSE,
              f"{phase} param deltas: {out}")
    emit(out)


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


def phase_train(steps: int, backend: str = "auto", extra=(), phase: str = "", run_tag: str = "",
                calls: int = 6):
    """The headline trainer on the host path; with backend pallas_fused the
    fused kernels (2 forward and 4 backward launches a step) replace the
    mi_joint ones. ``extra``: more config overrides (BF16: the kernels'
    bf16-operand variants, none on fp32 operands). ``calls``: the joint's
    launches a step, a third of them each product's (6: one tile a tap).
    Returns the trainer, the launch counts of this run of the kernels it
    uses (all counts set to 0 just before) and the phase's line."""
    import torch

    main_mod, mj, mf = port("main"), port("ops.mi_joint"), port("ops.mi_fused")
    fused = backend == "pallas_fused"
    phase = phase or ("train_fused" if fused else "train")
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", "Trainer.max_epoch=1", "Trainer.device=cuda",
            f"Kernel.backend={backend}",
            f"Trainer.save_dir=chip_smoke_udaiic{'_fused' if fused else ''}{run_tag}",
            "Trainer.step_timing=true", *extra]
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
    dtype = trainer._model.dtype
    if fused:
        per_step = {name: mf.launch_count(mj.kernel_name(name, dtype)) / steps
                    for name in (mf.FWD, mf.BWD_DL2, mf.BWD_DL1)}
        check(per_step == {mf.FWD: 2, mf.BWD_DL2: 2, mf.BWD_DL1: 2},
              f"fused launches per step {per_step} (want 2 forward, 2 + 2 backward)")
    else:
        per_step = {name: mj.launch_count(mj.kernel_name(name, dtype)) / steps
                    for name in (mj.FWD, mj.BWD_DX, mj.BWD_DX_TF)}
        check(per_step == dict.fromkeys(per_step, calls / 3) and launches == calls * steps,
              f"{phase}: joint launches per step {per_step} on {dtype} (want {calls // 3} of "
              "each)")
    check(all(name.endswith(mj.BF16_OPERANDS) == (dtype == torch.bfloat16)
              for name, _ in used.LAUNCHES), f"{phase}: {dict(used.LAUNCHES)} on {dtype}")
    row = trainer._storage._rows[0]
    losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", "tra_uda_mean",
                                  "tra_mi_mean")}
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    val_dsc = row["val_dice_DSC_mean"]
    check(0.0 <= val_dsc <= 1.0, f"val DSC {val_dsc}")
    step_ms = statistics.median(trainer.step_times_ms[1:])
    out = {"phase": phase, "backend": backend, "dtype": str(dtype), "steps": steps,
           "batch": [4, 10], "crop": 224, "extra": list(extra),
           "launches": counts, "launches_per_step": launches / steps, "losses": losses,
           "val_dsc_mean": val_dsc, "first_step_ms": trainer.step_times_ms[0],
           "median_step_ms": step_ms, "step_ms": trainer.step_times_ms,
           "slices_per_s": 24 / (step_ms / 1e3), "epoch_wall_s": trainer.epoch_times_s[0],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wall_s": wall}
    emit(out)
    return trainer, dict(used.LAUNCHES), out


def phase_train_tiled(steps: int = 3):
    """The headline trainer with patch_sizes=32: each decoder map in tiles of
    32^2 at stride 16, each its own joint (6 x 6 tiles of Up_conv3's 112^2, 13
    x 13 of Up_conv2's 224^2), the kernel launched (36 + 169) x 3 times a
    step, no other joint launch; then the step's device time by kind
    (profile) and the joint's share of it. Returns the trainer and the
    launch counts of its run (set to 0 just before it)."""
    calls = joint_calls((112, 224), TILE_PATCH)
    check(calls == 3 * (36 + 169), f"train_tiled: {calls} joint calls a step, want 615")
    trainer, launches, out = phase_train(
        steps, extra=(f"IICRegParameters.LossParams.patch_sizes={TILE_PATCH}",),
        phase="train_tiled", run_tag="_tiled", calls=calls)
    prof = phase_profile(trainer, steps=steps, path="tiled")
    joint_ms = prof["by_kind_ms_per_step"].get(_kernel_kind("joint_fwd"), 0.0)
    emit({"phase": "train_tiled_split", "launches_per_step": calls,
          "median_step_ms": out["median_step_ms"],
          "profile_wall_ms_per_step": prof["wall_ms_per_step"],
          "device_ms_per_step": prof["device_ms_per_step"], "joint_device_ms_per_step": joint_ms,
          "joint_share_of_device": joint_ms / prof["device_ms_per_step"]})
    return trainer, launches


def phase_train_heads(steps: int = 3) -> None:
    """The headline trainer with mlp heads at every position and normalized
    decoder heads (one full-map tile: 6 joint launches a step), in fp32 and
    in bf16 compute, each then profiled (device time by kind)."""
    for tag, extra in (("fp32", ()), ("bf16", BF16)):
        trainer, _, _ = phase_train(steps, extra=HEADS + extra, phase="train_heads",
                                    run_tag=f"_heads_{tag}")
        heads = trainer._projector.heads
        check(all(h.head_type == "mlp" for h in heads.values())
              and heads["Up_conv3"].normalize and heads["Up_conv2"].normalize
              and not heads["Conv5"].normalize, f"train_heads {tag}: heads not as configured")
        phase_profile(trainer, steps=steps, path=f"heads_{tag}")
        del trainer


def phase_train_backends(steps: int = 2) -> None:
    """The headline trainer (one full-map tile) with each Kernel.backend from
    the same seed, ``steps`` steps on one batch: pallas launches auto's
    kernels (6 a step) and gives auto's first-step losses bit for bit, the
    later ones within STEPS_TOL; xla, xla_banded
    and xla_scan launch none and give the first step's losses within
    BACKEND_TOL of auto's; the peak of device memory above the start, with
    xla_scan's below xla's (its reason to exist)."""
    import torch

    main_mod, mj = port("main"), port("ops.mi_joint")
    batch, results = None, {}
    for backend in ("auto", "pallas", "xla", "xla_banded", "xla_scan"):
        trainer = main_mod.main([
            "Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic", "Trainer.max_epoch=0",
            "Trainer.device=cuda", f"Kernel.backend={backend}",
            f"Trainer.save_dir=chip_smoke_backend_{backend}"])
        if batch is None:
            lab, unlab = next(zip(trainer._labeled_loader, trainer._unlabeled_loader))
            batch = {"labeled_image": trainer._to_device(lab["image"]),
                     "labeled_target": trainer._to_device(lab["target"]),
                     "unlabeled_image": trainer._to_device(unlab["image"])}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        mj.reset_launch_counts()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = trainer._train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")})
        check(all(math.isfinite(v) for step in losses for v in step.values()),
              f"train_backends {backend}: losses {losses}")
        results[backend] = {"losses": losses, "step_ms": times,
                            "launches_per_step": sum(mj.LAUNCHES.values()) / steps,
                            "peak_above_start_gib": (torch.cuda.max_memory_allocated() - base)
                            / 2 ** 30}
        del trainer, metrics
        torch.cuda.empty_cache()
    ref = results["auto"]
    check(ref["launches_per_step"] == 6 and results["pallas"]["launches_per_step"] == 6,
          f"train_backends: joint launches a step auto {ref['launches_per_step']}, pallas "
          f"{results['pallas']['launches_per_step']} (want 6)")
    # the first step bit for bit (the same forward and kernels); later ones
    # within STEPS_TOL, as cuDNN may sum a weight gradient in another order
    pallas = results["pallas"]["losses"]
    rel = max(abs(q[k] - r[k]) / max(abs(r[k]), 1e-12) for q, r in zip(pallas, ref["losses"])
              for k in r)
    check(pallas[0] == ref["losses"][0] and rel <= STEPS_TOL,
          f"train_backends: pallas {pallas} vs auto {ref['losses']}")
    for backend in ("xla", "xla_banded", "xla_scan"):
        got = results[backend]
        rel = {k: abs(got["losses"][0][k] - v) / max(abs(v), 1e-12)
               for k, v in ref["losses"][0].items()}
        got["first_step_rel_err"] = rel
        check(got["launches_per_step"] == 0 and max(rel.values()) <= BACKEND_TOL,
              f"train_backends {backend}: {got['launches_per_step']} joint launches a step, "
              f"first-step losses off auto's by {rel}")
    scan, unrolled = (results[b]["peak_above_start_gib"] for b in ("xla_scan", "xla"))
    check(scan < unrolled, f"train_backends: xla_scan peak {scan} GiB >= xla's {unrolled} GiB")
    emit({"phase": "train_backends", "steps": steps, "tol_rel": BACKEND_TOL,
          "backends": results})


def phase_train_device(steps: int, geometry: str, chunk: int = 4, extra=(), phase: str = "",
                       run_tag: str = ""):
    """The headline trainer on the device-data path; returns the trainer, the
    rotation and joint launch counts of this run (set to 0 just before) and
    the phase's line. ``extra``: more config overrides (BF16)."""
    import torch

    main_mod, mj, rot = port("main"), port("ops.mi_joint"), port("ops.rotate")
    phase = phase or "train_device"
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", f"Trainer.scan_chunk={chunk}",
            "Trainer.max_epoch=1", "Trainer.device=cuda", "Trainer.device_data=true",
            f"Kernel.geometry={geometry}",
            f"Trainer.save_dir=chip_smoke_device{run_tag}_{geometry}",
            "Trainer.step_timing=true", *extra]
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
    dtype = trainer._model.dtype
    check(all(name.endswith(mj.BF16_OPERANDS) == (dtype == torch.bfloat16)
              for name, _ in joint_launches), f"{phase}: {joint_launches} on {dtype}")
    row = trainer._storage._rows[0]
    losses = {k: row[k] for k in ("tra_sup_loss_mean", "tra_reg_loss_mean", "tra_uda_mean",
                                  "tra_mi_mean")}
    check(all(math.isfinite(v) for v in losses.values()), f"non-finite losses {losses}")
    val_dsc = row["val_dice_DSC_mean"]
    check(0.0 <= val_dsc <= 1.0, f"val DSC {val_dsc}")
    per_chunk = trainer.step_times_ms[::chunk]
    steady = statistics.median(trainer.step_times_ms[chunk:]) if steps > chunk else per_chunk[0]
    out = {"phase": phase, "geometry": geometry, "dtype": str(dtype), "steps": steps,
           "scan_chunk": chunk, "batch": [4, 10], "crop": 224,
           "rotation_launches": {f"{n}/B{b}": v for (n, b), v in sorted(rot_launches.items())},
           "rotation_launches_per_step": n_rot / steps,
           "joint_launches_per_step": n_joint / steps, "losses": losses, "val_dsc_mean": val_dsc,
           "chunk_ms_per_step": per_chunk, "median_step_ms": steady,
           "median_step_ms_note": "median over the steps after the first chunk "
                                  "(each step: its chunk's wall time / chunk size)",
           "slices_per_s": 24 / (steady / 1e3), "epoch_wall_s": trainer.epoch_times_s[0],
           "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "wall_s": wall}
    emit(out)
    return trainer, rot_launches, joint_launches, out


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


def _resume_loaded(save_dir: str, *extra: str):
    """One epoch of the headline trainer (``extra``: more overrides), then a
    resume from its run dir with no epoch left: the state just after the
    load held against last.pth bit for bit, the load timed again on it.
    Returns the run dir, the loaded trainer, the load seconds and the
    counts of tensors and entries held."""
    import torch

    main_mod = port("main")
    shutil.rmtree(Path(port("engine.trainer").SemiTrainer.RUN_DIR) / save_dir, ignore_errors=True)
    first = main_mod.main(_zoo_argv(save_dir, "Trainer.max_epoch=1", *extra))
    run = Path(first._save_dir)
    saved = torch.load(run / "last.pth", map_location="cpu", weights_only=True)
    meta = saved.pop("meta")

    loaded = main_mod.main(_zoo_argv(save_dir, "Trainer.max_epoch=1", f"Checkpoint={run}",
                                     *extra))
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
    return run, loaded, load_s, n_tensors, len(want)


def phase_resume():
    """One epoch of the headline trainer, then two resumes from its run dir:
    one with no epoch left (``_resume_loaded``), one that trains epoch 1.
    Returns the run dir and the joint launches of the resumed epoch."""
    import torch

    main_mod, mj = port("main"), port("ops.mi_joint")
    save_dir = "chip_smoke_resume"
    run, _, load_s, n_tensors, n_entries = _resume_loaded(save_dir)

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
          "tensors_equal_bit_for_bit": n_tensors, "entries_equal": n_entries,
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


def phase_train_remat(steps: int = 3) -> None:
    """The host-path headline trainer with and without Arch.remat=true, from
    the same seed (the same weights and step generator), ``steps`` steps on
    one batch each: the same losses (the first step's bit for bit: the same
    forward; later ones within STEPS_TOL, as cuDNN may sum a weight gradient
    in another order from run to run) and a lower peak of device memory above
    what was allocated before the steps (each block keeps only its input)."""
    import torch

    main_mod = port("main")
    batch, results = None, {}
    for remat in (False, True):
        trainer = main_mod.main([
            "Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic", "Trainer.max_epoch=0",
            "Trainer.device=cuda", f"Arch.remat={str(remat).lower()}",
            f"Trainer.save_dir=chip_smoke_remat_{str(remat).lower()}"])
        check(trainer._model.remat == remat, f"train_remat: Arch.remat={remat} not taken")
        if batch is None:
            lab, unlab = next(zip(trainer._labeled_loader, trainer._unlabeled_loader))
            batch = {"labeled_image": trainer._to_device(lab["image"]),
                     "labeled_target": trainer._to_device(lab["target"]),
                     "unlabeled_image": trainer._to_device(unlab["image"])}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses, times = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            metrics = trainer._train_step(batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append({k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")})
        results[remat] = (losses, (torch.cuda.max_memory_allocated() - base) / 2 ** 30, times)
        del trainer, metrics
        torch.cuda.empty_cache()
    (plain, plain_peak, plain_ms), (rem, rem_peak, rem_ms) = results[False], results[True]
    check(plain[0] == rem[0], f"train_remat: first step losses {rem[0]} vs {plain[0]}")
    rel = max(abs(r[k] - q[k]) / max(abs(q[k]), 1e-12) for q, r in zip(plain, rem) for k in q)
    check(rel <= STEPS_TOL, f"train_remat: losses differ by {rel} (relative)")
    check(rem_peak < plain_peak, f"train_remat: peak {rem_peak} GiB >= {plain_peak} GiB")
    emit({"phase": "train_remat", "steps": steps, "losses": plain, "losses_remat": rem,
          "max_rel_diff": rel, "peak_above_start_gib": plain_peak,
          "peak_above_start_gib_remat": rem_peak, "step_ms": plain_ms, "step_ms_remat": rem_ms})


def _pretrain_argv(name: str, save_dir: str, *extra: str) -> list:
    """``pretrain_main`` on the card at pretrain.yaml's widths (crop 224,
    4 patients x 3 partitions a contrastive batch, the default heads),
    PRETRAIN_STEPS steps an epoch, one epoch a phase."""
    return ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", f"Trainer.name={name}", "Trainer.device=cuda",
            f"Trainer.num_batches={PRETRAIN_STEPS}", "Trainer.max_epoch_train_encoder=1",
            "Trainer.max_epoch_train_decoder=1", "Trainer.max_epoch_train_finetune=1",
            f"Trainer.save_dir={save_dir}", "Trainer.step_timing=true", *extra]


@contextmanager
def _watch_phases(cls, record: dict):
    """While it is open, each phase method of the trainer class ``cls`` runs
    with the joint's launch counts set to 0 and the peak memory reset just
    before it; ``record[phase]`` then holds that phase's launches, peak,
    wall and the model's parameters before and after it."""
    from contextlib import ExitStack
    from unittest import mock

    import torch

    mj = port("ops.mi_joint")

    def watched(phase, method):
        def run(self, *args, **kwargs):
            params = lambda: {k: p.detach().clone() for k, p in self._model.named_parameters()}
            before = params()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            mj.reset_launch_counts()
            t0 = time.perf_counter()
            method(self, *args, **kwargs)
            torch.cuda.synchronize()
            record[phase] = {"launches": dict(mj.LAUNCHES), "wall_s": time.perf_counter() - t0,
                             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                             "before": before, "after": params()}
        return run

    with ExitStack() as stack:
        for phase in ("pretrain_encoder", "pretrain_decoder", "finetune"):
            stack.enter_context(mock.patch.object(cls, phase, watched(phase,
                                                                      getattr(cls, phase))))
        yield


def _phase_rows(run: Path, phase: str) -> list:
    import csv

    with open(run / phase / f"{phase}.csv") as f:
        return list(csv.DictReader(f))


def phase_pretrain(steps: int = PRETRAIN_STEPS) -> tuple:
    """``Trainer.name=iiccontrast`` through ``pretrain_main.main``, one epoch
    of ``steps`` batches in each phase: each phase's CSV and last.pth, its
    losses finite; the frozen components' parameters bit-equal across each
    pretrain phase (and the trainable ones moved); the joint launched in the
    decoder phase exactly as its lane tiling says (3 products a step, each
    one launch per pair of 128-lane blocks of the 200 lanes, all at padding
    0) and in no other phase; each phase's median step ms (each step
    synchronised) and peak memory. Returns (the decoder phase's launches,
    the run directory)."""
    import torch

    pm, pre, mj = port("pretrain_main"), port("engine.pretrain"), port("ops.mi_joint")
    subheads, clusters = PRETRAIN_HEAD
    per_product = len(mj._lane_tiles(subheads * clusters)) ** 2
    record: dict = {}
    with _watch_phases(pre.IICContrastTrainer, record):
        trainer = pm.main(_pretrain_argv("iiccontrast", "chip_smoke_pretrain_iic"))
    run = Path(trainer._save_dir)
    trainable = {"pretrain_encoder": pre.component_range("Conv1", "Conv5"),
                 "pretrain_decoder": pre.component_range("Up5", "Up_conv3")}
    losses = {"pretrain_encoder": ("PRETRAIN_ENCODER_contrastive_loss_mean",
                                   "PRETRAIN_ENCODER_iic_loss_mean"),
              "pretrain_decoder": ("PRETRAIN_DECODER_contrastive_loss_mean",
                                   "PRETRAIN_DECODER_iic_loss_mean"),
              "finetune": ("finetune_sup_loss_mean", "val_ds_DSC_mean")}
    check(sorted(record) == sorted(losses), f"pretrain: phases run {sorted(record)}")
    for phase, rec in record.items():
        (row,) = _phase_rows(run, phase)
        values = {k: float(row[k]) for k in losses[phase]}
        check(all(math.isfinite(v) for v in values.values()), f"pretrain {phase}: {values}")
        check((run / phase / "last.pth").is_file(), f"pretrain {phase}: no last.pth")
        out = {"phase": "pretrain", "trainer": "iiccontrast", "stage": phase, "steps": steps,
               "crop": 224, "losses": values, "wall_s": rec["wall_s"],
               "step_ms": trainer.step_times_ms[phase],
               "median_step_ms": statistics.median(trainer.step_times_ms[phase][1:]),
               "max_memory_allocated_gib": rec["peak_gib"],
               "launches": {f"{k}/p{p}": v for (k, p), v in sorted(rec["launches"].items())}}
        if phase in trainable:
            same = {k for k in rec["before"] if torch.equal(rec["before"][k], rec["after"][k])}
            frozen = {k for k, t in pre.freeze_mask(trainer._model, trainable[phase]).items()
                      if not t}
            check(same == frozen, f"pretrain {phase}: unchanged {sorted(same ^ frozen)[:5]} "
                                  "(want exactly the frozen components' parameters)")
            out["frozen_params_bit_equal"] = len(frozen)
        want = {}
        if phase == "pretrain_decoder":
            want = {(name, 0): steps * per_product for name in (mj.FWD, mj.BWD_DX, mj.BWD_DX_TF)}
            out["launches_per_step"] = 3 * per_product
        check(rec["launches"] == want, f"pretrain {phase}: joint launches {rec['launches']} "
                                       f"(want {want})")
        emit(out)
    decoder_launches = record["pretrain_decoder"]["launches"]
    del trainer, record
    torch.cuda.empty_cache()
    return decoder_launches, run


def phase_pretrain_mt(steps: int = PRETRAIN_STEPS) -> None:
    """``Trainer.name=contrastMT`` with ``train_encoder`` and
    ``train_decoder`` false: ``steps`` finetune steps with the mean teacher.
    The val DSC in its CSV is the teacher's (the teacher of last.pth,
    evaluated again, within 1e-6); the teacher moved from init and is unlike
    the student; the losses finite; no joint launch."""
    import torch

    pm, mj, models = port("pretrain_main"), port("ops.mi_joint"), port("models")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mj.reset_launch_counts()
    trainer = pm.main(_pretrain_argv("contrastMT", "chip_smoke_pretrain_mt",
                                     "Trainer.train_encoder=false",
                                     "Trainer.train_decoder=false"))
    check(sum(mj.LAUNCHES.values()) == 0, f"pretrain_mt: joint launches {dict(mj.LAUNCHES)}")
    run = Path(trainer._save_dir)
    (row,) = _phase_rows(run, "finetune")
    losses = {k: float(row[f"finetune_{k}_mean"]) for k in ("sup_loss", "reg_loss")}
    check(all(math.isfinite(v) for v in losses.values()), f"pretrain_mt: losses {losses}")
    dev = trainer._device
    state = torch.load(run / "finetune" / "last.pth", map_location=dev, weights_only=False)
    scores = {}
    for who in ("teacher", "model"):
        net = models.UNet(1, 4).to(dev)
        net.load_state_dict(state[who])
        scores[who] = trainer._eval_phase(net)[1]
    csv_score = float(row["val_ds_DSC_mean"])
    check(abs(scores["teacher"] - csv_score) <= 1e-6,
          f"pretrain_mt: CSV val DSC {csv_score}, the teacher's {scores['teacher']}")
    torch.manual_seed(int(trainer._config["RandomSeed"]))
    init = models.UNet(1, 4).state_dict()
    names = [k for k, _ in models.UNet(1, 4).named_parameters()]
    teacher = {k: state["teacher"][k].cpu() for k in names}
    student = {k: state["model"][k].cpu() for k in names}
    check(all(not torch.equal(teacher[k], init[k]) and not torch.equal(teacher[k], student[k])
              for k in names), "pretrain_mt: a teacher parameter at init or equal to the student's")
    emit({"phase": "pretrain_mt", "trainer": "contrastMT", "steps": steps, "losses": losses,
          "val_dsc_teacher": scores["teacher"], "val_dsc_student": scores["model"],
          "step_ms": trainer.step_times_ms["finetune"],
          "median_step_ms": statistics.median(trainer.step_times_ms["finetune"][1:]),
          "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30})


def _pretrain_step_run(device: str):
    """One decoder-IIC pretrain step (crop 32, 4 slices a view, the pretrain
    heads: 10 x 20 clusters, padding 0) on ``device`` from the weights of
    seed 0, the same batch and flip mask: its losses, each trainable
    parameter's move and the joint's launches."""
    import numpy as np
    import torch

    models, pre, mj = port("models"), port("engine.pretrain"), port("ops.mi_joint")
    subheads, clusters = PRETRAIN_HEAD
    rng = np.random.default_rng(0)
    b = 4
    batch = {"image": rng.random((b, 32, 32, 1), dtype=np.float32),
             "image_tf": rng.random((b, 32, 32, 1), dtype=np.float32),
             "labels": pre.local_labels(["0", "1", "2", "0"], ["p1", "p1", "p2", "p2"],
                                        pre.unfold_locations((4, 4), b))}
    flip_mask = torch.from_numpy(rng.random((b, 2)) < 0.5)
    torch.manual_seed(0)
    model = models.UNet(1, 4).to(device)
    heads = torch.nn.ModuleDict({
        "projector": models.LocalProjectionHead(32),
        "iic": models.LocalClusterHead(32, clusters, subheads, "mlp", flat_output=False)})
    phase = pre._Phase(model, heads, pre.component_range("Up5", "Up_conv3"), 1e-3, 0.0,
                       torch.device(device), 11)
    step = pre.build_pretrain_decoder_step(model, phase.heads["projector"], phase.optimizer,
                                           generator=phase.generator,
                                           iic_head=phase.heads["iic"])
    params = list(chain(model.named_parameters(), heads.named_parameters(prefix="heads")))
    before = {k: p.detach().cpu().clone() for k, p in params}
    mj.reset_launch_counts()
    metrics = step({k: torch.as_tensor(v).to(device) for k, v in batch.items()},
                   flip_mask=flip_mask)
    launches = sum(mj.LAUNCHES.values())
    phase.close()
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach().cpu() - before[k] for k, p in params}, launches)


def phase_pretrain_step() -> None:
    """The decoder-IIC pretrain step on the card (the joint kernels,
    lane-tiled) against the CPU (their plain version): losses within
    STEPS_TOL (relative), the parameter moves as in the step phase."""
    import numpy as np

    mj = port("ops.mi_joint")
    subheads, clusters = PRETRAIN_HEAD
    (l_cpu, d_cpu, n_cpu), (l_gpu, d_gpu, n_gpu) = (_pretrain_step_run(dev)
                                                    for dev in ("cpu", "cuda"))
    want = 3 * len(mj._lane_tiles(subheads * clusters)) ** 2
    check(n_cpu == 0 and n_gpu == want, f"pretrain_step launches cpu={n_cpu} cuda={n_gpu} "
                                        f"(want 0, {want})")
    rel = {k: abs(l_gpu[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12) for k in l_cpu}
    check(all(v <= STEPS_TOL for v in rel.values()), f"pretrain_step losses differ: {rel}")
    diffs = np.concatenate([(d_gpu[k] - d_cpu[k]).abs().flatten().numpy() for k in d_cpu])
    loose = _loose_share(d_gpu, d_cpu)
    check(diffs.max() <= 2.05e-3 and loose < 0.005,
          f"pretrain_step param deltas: max {diffs.max()}, loose share {loose}")
    emit({"phase": "pretrain_step", "losses_cpu": l_cpu, "losses_cuda": l_gpu, "rel_err": rel,
          "tol_rel": STEPS_TOL, "param_delta_max_diff": float(diffs.max()),
          "param_delta_loose_share": loose, "launches_cuda": n_gpu})


def phase_pretrain_joint(reps: int) -> list:
    """The joint at the pretrain decoder's shape ([12 * 112^2, 200] fp32
    probability maps, padding 0, bf16 products, lane-tiled): exactly on
    integer inputs at a ragged shape and at this one (fp32 and bf16
    operands), then within TOL on probability maps, timed beside the plain
    version, its bound and one torch.matmul (at padding 0 the joint is one
    [N, C]^T [N, C] product): bf16 casts of the fp32 inputs included, with
    the fp32 matmul beside it (``library_fp32_ms``)."""
    import torch

    mj = port("ops.mi_joint")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    subheads, clusters = PRETRAIN_HEAD
    c = subheads * clusters
    tap, batch, edge, p = PRETRAIN_TAP
    n = batch * edge * edge
    for shape in (RAGGED[5], (batch, edge, edge, p)):
        rows_n = shape[0] * shape[1] * shape[2]
        _exact_check(mj, rows_n, shape[2], shape[3], gen, c)
        _exact_check(mj, rows_n, shape[2], shape[3], gen, c, dtype=torch.bfloat16)
        emit({"phase": "pretrain_joint", "shape": list(shape), "lanes": c,
              "exact_check": "passed", "exact_check_bf16in": "passed"})
    a = _tap_inputs(batch, edge, p, gen, clusters, c, subheads)
    b = _tap_inputs(batch, edge, p, gen, clusters, c, subheads)
    g = torch.randn((1, c, c), generator=gen, device="cuda") * 1e-3
    cases = _joint_cases(mj, a, b, g, batch, edge, p, bf16=True)
    bf = lambda t: t.to(torch.bfloat16)
    # at padding 0: J = A^T B, dx = B g^T, dx_tf = A g
    matmuls = {mj.FWD: (lambda: torch.matmul(bf(a).T, bf(b)), lambda: torch.matmul(a.T, b)),
               mj.BWD_DX: (lambda: torch.matmul(bf(b), bf(g[0]).T),
                           lambda: torch.matmul(b, g[0].T)),
               mj.BWD_DX_TF: (lambda: torch.matmul(bf(a), bf(g[0])),
                              lambda: torch.matmul(a, g[0]))}
    extra = {}
    for name, (lib, lib32) in matmuls.items():
        cases[name]["library"] = lib
        cases[name]["unpack"] = (lambda o: o[None]) if name == mj.FWD else (lambda o: o)
        extra[name] = cuda_ms(lib32, max(3, reps // 3), warmup=1)
    nbytes = 2.0 * 4 * n * c + 4.0 * c * c
    rows = []
    for name, case in cases.items():
        rows += _joint_rows(mj, {name: case}, a.dtype,
                            {"phase": "pretrain_joint", "tap": tap, "label": f"pretrain {tap}",
                             "mode": "bf16"}, n, c, p, 2.0 * n * c * c, nbytes, True, reps,
                            extra={"library": "torch.matmul, bf16 casts included",
                                   "library_fp32_ms": extra[name],
                                   "launches_per_call": len(mj._lane_tiles(c)) ** 2})
    del a, b, g, cases
    torch.cuda.empty_cache()
    return rows


def phase_optim(steps: int) -> None:
    """``main.main`` udaiic at full width under each of OPTIM_RUNS (``phase_train``:
    6 joint launches a step, finite losses), a resume under SGD equal to
    last.pth in every entry, then every OPTIMIZERS name on that trainer's
    parameter set (model and projector), card against CPU from the same
    values and gradients, with the card's step time."""
    import torch

    for name, extra in OPTIM_RUNS.items():
        trainer, _, _ = phase_train(steps, extra=extra, phase=f"optim_{name}",
                                    run_tag=f"_{name.lower()}")
        check(type(trainer._optimizer).__name__ == name,
              f"optim: Optim.name={name} built {type(trainer._optimizer).__name__}")
    _, loaded, load_s, n_tensors, n_entries = _resume_loaded("chip_smoke_resume_sgd",
                                                              *OPTIM_RUNS["SGD"])
    check(type(loaded._optimizer).__name__ == "SGD", "optim: the resumed trainer's optimizer")
    emit({"phase": "optim_resume", "optimizer": "SGD", "load_s": load_s,
          "tensors_equal_bit_for_bit": n_tensors, "entries_equal": n_entries})

    _optim_names([p.detach().cpu().clone()
                  for p in chain(trainer._model.parameters(), trainer._projector.parameters())])


def _optim_names(params0, device: str = "cuda") -> None:
    """Every OPTIMIZERS name stepped OPTIM_STEPS times from ``params0`` on the
    CPU and on ``device`` with the same gradients (lr changed after step 2):
    the two within OPTIM_TOL of the largest move; ``device``'s step time."""
    import torch

    optim = port("engine.optim")
    gen = torch.Generator().manual_seed(0)
    grads = [[torch.randn(p.shape, generator=gen) for p in params0] for _ in range(OPTIM_STEPS)]
    rows = {}
    for name in sorted(optim.OPTIMIZERS):
        cfg = {"name": name, "lr": 1e-3, "weight_decay": 1e-4, "momentum": 0.9}
        after, step_ms = {}, []
        for dev in ("cpu", device):
            params = [torch.nn.Parameter(p.to(dev, copy=True)) for p in params0]
            opt = optim.build_optimizer(params, cfg)
            optim.init_optimizer_state(opt)
            for i, g in enumerate(grads):
                if i == 2:
                    optim.set_learning_rate(opt, 3e-4)
                for p, gi in zip(params, g):
                    p.grad = gi.to(dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                opt.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            after[dev] = [p.detach().cpu() for p in params]
        moved = max(float((a - p0).abs().max()) for a, p0 in zip(after["cpu"], params0))
        err = max(float((a - b).abs().max()) for a, b in zip(after[device], after["cpu"]))
        # beyond OPTIM_TOL of the largest move, in units of each parameter's
        # fp32 spacing (Adadelta moves ~1e-5 on parameters ~1e-2)
        fp32 = torch.finfo(torch.float32)
        ulps = max(float(((a - b).abs() - OPTIM_TOL * moved)
                         .div(fp32.eps * b.abs().clamp_min(fp32.tiny)).max())
                   for a, b in zip(after[device], after["cpu"]))
        check(moved > 0 and ulps <= OPTIM_ULPS,
              f"optim {name}: card vs CPU {err:.3e} of a {moved:.3e} move ({ulps:.2f} ulps over)")
        rows[name] = {"class": type(opt).__name__, "max_abs_err": err, "largest_move": moved,
                      "ulps_beyond_tol": ulps,
                      "median_step_ms": statistics.median(step_ms[OPTIM_STEPS + 1:])}
    emit({"phase": "optim", "device": device, "parameters": sum(p.numel() for p in params0),
          "tensors": len(params0), "steps": OPTIM_STEPS, "tol": OPTIM_TOL, "names": rows})


def _zoo_model(arch: str, kw: dict, dtype):
    """The family from ``get_arch`` (VGG11: the backbone with ClassifyHead)
    in ``dtype`` compute (VNet has no BN dtype)."""
    import torch

    models = port("models")
    if arch == "vgg11":
        return torch.nn.ModuleDict({"vgg": models.VGG11(kw["input_dim"], dtype=dtype),
                                    "head": models.ClassifyHead(512, 4)})
    extra = {"dtype": dtype} if arch == "vnet" else {"dtype": dtype, "bn_dtype": dtype}
    return models.get_arch(arch, dict(kw, **extra))


def _zoo_forward(model, x):
    """The logits of a zoo model (VGG11 through its ClassifyHead)."""
    import torch

    if isinstance(model, torch.nn.ModuleDict):
        return model["head"](model["vgg"](x))[1]
    return model(x)


def phase_arch_zoo(device: str = "cuda") -> None:
    """Every ZOO_RUNS family at full width, fp32 then bf16: a train step
    (forward, cross-entropy against random labels, backward, Adam) timed by
    the host clock around synchronised steps (median of ZOO_STEPS_TIMED after
    one warm-up), its device time (profiler, one step) and its peak memory
    (parameters, input, gradients, Adam state and activations: the peak
    above what was allocated before the model was built); the fp32 model
    then in a small eval forward, card against CPU."""
    import torch
    import torch.nn.functional as F

    optim = port("engine.optim")
    for arch, kw, shape in ZOO_RUNS:
        tag = arch + ("_101" if kw.get("n_blocks") else "")
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()  # what earlier phases still hold
            torch.manual_seed(0)
            with torch.device(device):  # parameters made on the card
                model = _zoo_model(arch, kw, dtype)
            opt = optim.build_optimizer(model.parameters(), {"name": "Adam", "lr": 1e-4})
            gen = torch.Generator(device=device).manual_seed(1)
            x = torch.randn(shape, generator=gen, device=device)
            with torch.no_grad():  # the logits' shape, without moving the BN statistics
                out_shape = _zoo_forward(model.eval(), x[:1]).shape
            model.train()
            target = torch.randint(0, out_shape[1], (shape[0],) + tuple(out_shape[2:]),
                                   generator=gen, device=device)

            def step():
                opt.zero_grad(set_to_none=True)
                loss = F.cross_entropy(_zoo_forward(model, x), target)
                loss.backward()
                opt.step()
                return loss.detach()

            loss = float(step())  # warm-up (cuDNN's first calls)
            check(math.isfinite(loss), f"arch_zoo {tag} {dtype}: loss {loss}")
            times = []
            for _ in range(ZOO_STEPS_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            device_ms = sum(ms for ms, _ in device_profile(step, reps=1, warmup=0).values())
            step_ms = statistics.median(times)
            emit({"phase": "arch_zoo", "arch": tag, "dtype": str(dtype),
                  "input": list(shape), "kwargs": {k: list(v) if isinstance(v, tuple) else v
                                                   for k, v in kw.items()},
                  "parameters": sum(p.numel() for p in model.parameters()),
                  "median_step_ms": step_ms, "step_ms": times, "device_ms_per_step": device_ms,
                  "device_busy_share": device_ms / step_ms, "peak_gib": peak,
                  "loss": loss})
            if dtype == torch.float32:
                _zoo_card_vs_cpu(tag, model.eval(), shape, device)
            del model, opt, x, target
            torch.cuda.empty_cache()


def _zoo_card_vs_cpu(tag: str, model, shape, device: str) -> None:
    """A small fp32 eval forward of ``model`` on ``device``, then on the CPU:
    within ZOO_TOL of the largest logit."""
    import torch

    small = (2, 1, 64, 64) if len(shape) == 4 else (2, 1, 8, 32, 32)
    x = torch.randn(small, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = _zoo_forward(model, x.to(device)).cpu()
        want = _zoo_forward(model.cpu(), x)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    check(got.dtype == want.dtype == torch.float32 and err <= ZOO_TOL * scale,
          f"arch_zoo {tag}: card vs CPU {err:.3e} of {scale:.3e}")
    emit({"phase": "arch_zoo_check", "arch": tag, "input": list(small), "max_abs_err": err,
          "max_abs": scale, "tol": ZOO_TOL})


def host_cpu() -> dict:
    """The host's CPU: /proc/cpuinfo's first model name and os.cpu_count()."""
    name = "not reported"
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.startswith("model name"):
                name = line.split(":", 1)[1].strip()
                break
    return {"model_name": name, "cpu_count": os.cpu_count()}


@contextmanager
def native_host(on: bool):
    """The port's native host library on (it must build and load: a check)
    or off (``MISST_DISABLE_NATIVE=1``) for the block, its call counts at 0
    when the block starts."""
    nat = port("data.native")
    saved = os.environ.pop("MISST_DISABLE_NATIVE", None)
    if not on:
        os.environ["MISST_DISABLE_NATIVE"] = "1"
    nat.reset()
    try:
        check(nat.available() == on, f"native host library available: {not on}, want {on}")
        nat.reset_call_counts()
        yield nat
    finally:
        os.environ.pop("MISST_DISABLE_NATIVE", None)
        if saved is not None:
            os.environ["MISST_DISABLE_NATIVE"] = saved
        nat.reset()


def _host_gap(nat, aug) -> dict:
    """Native against numpy on this host: ACDCStrongTransforms.pretrain on a
    uniform random 256^2 image with labels in 0..3, seeds 0..49 (the CPU
    tests' inputs): label pixels that differ (rotation ties), and the largest
    image difference on the seeds whose labels agree (the jitter)."""
    import numpy as np

    rng = np.random.default_rng(0)
    img = rng.random((256, 256), dtype=np.float32)
    gt = rng.integers(0, 4, (256, 256)).astype(np.int32)
    tf = aug.ACDCStrongTransforms.pretrain
    tie_pixels, jitter = {}, 0.0
    for seed in range(50):
        a = tf(img, gt, np.random.default_rng(seed))
        lib = nat._lib
        nat._lib, nat._tried = None, True
        try:
            b = tf(img, gt, np.random.default_rng(seed))
        finally:
            nat._lib = lib
        differ = int((a[1] != b[1]).sum())
        if differ:
            tie_pixels[seed] = differ
        else:
            jitter = max(jitter, float(np.abs(a[0] - b[0]).max()))
    return {"seeds": 50, "label_pixels_by_seed": tie_pixels, "jitter_max_abs": jitter}


def _host_run(steps: int, native: bool, extra, tag: str, device: str):
    """The headline udaiic trainer through ``main.main`` on the host path,
    the native library on or off, the joint's launch counts and the native
    call counts set to 0 just before it. Returns the trainer and its line."""
    import torch

    main_mod, mj = port("main"), port("ops.mi_joint")
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=udaiic",
            f"Trainer.num_batches={steps}", "Trainer.max_epoch=1", f"Trainer.device={device}",
            f"Trainer.save_dir=chip_smoke_host_{tag}", "Trainer.step_timing=true", *extra]
    with native_host(native) as nat:
        mj.reset_launch_counts()
        trainer = main_mod.main(argv)
        calls = dict(nat.CALLS)
    launches = sum(mj.LAUNCHES.values())
    if device == "cuda":
        check(launches == 6 * steps, f"host_tier {tag}: {launches} joint launches, want 6 a step")
    loaders = {"labeled": trainer._labeled_loader, "unlabeled": trainer._unlabeled_loader}
    drawn = sum(ld._draw for ld in loaders.values())
    check(drawn == (steps + 3) * (4 + 10), f"host_tier {tag}: the train loaders drew {drawn} "
          f"samples, want (N + 3) x 14 for N = {steps}")
    samples = drawn + len(trainer._val_loader.dataset) + len(trainer._test_loader.dataset)
    want = samples if native else 0
    check(calls["augment_pair"] == want, f"host_tier {tag}: {calls['augment_pair']} native "
          f"augment_pair calls for {samples} samples drawn, want {want}")
    check(native == (calls["decode_png_gray8"] > 0), f"host_tier {tag}: decode calls {calls}")
    row = trainer._storage._rows[0]
    check(all(math.isfinite(row[k]) for k in ("tra_sup_loss_mean", "tra_mi_mean")),
          f"host_tier {tag}: losses {row}")
    walls = trainer.step_walls_ms
    out = {"phase": "host_tier", "run": tag, "native": native, "steps": steps,
           "dtype": str(trainer._model.dtype), "epoch_wall_s": trainer.epoch_times_s[0],
           "step_wall_ms": walls, "median_step_wall_ms": statistics.median(walls[1:] or walls),
           "median_step_ms": statistics.median(trainer.step_times_ms[1:] or trainer.step_times_ms),
           "joint_launches_per_step": launches / steps, "samples_drawn": samples,
           "native_calls": calls, "loader_draws": {k: ld._draw for k, ld in loaders.items()}}
    if device == "cuda":  # device time of a step on one batch already on the card
        lab, unlab = next(zip(trainer._labeled_loader, trainer._unlabeled_loader))
        batch = {"labeled_image": trainer._to_device(lab["image"]),
                 "labeled_target": trainer._to_device(lab["target"]),
                 "unlabeled_image": trainer._to_device(unlab["image"])}
        dev_ms = sum(ms for ms, _ in device_profile(lambda: trainer._train_step(batch), 3,
                                                    warmup=1).values())
        out.update(device_ms_per_step=dev_ms,
                   device_busy_share=dev_ms / out["median_step_wall_ms"])
        torch.cuda.synchronize()
    emit(out)
    return trainer, out


def phase_host_tier(steps: int, device: str = "cuda") -> list:
    """The host tier on the card's host: the native library decodes and
    augments every sample (its call counts say so), native against numpy at
    each level (a sample, a loader batch, the trainer's step and epoch), the
    background prefetch leaving the loaders N + 3 batches on."""
    import numpy as np
    from PIL import Image

    pkg, data, aug = import_module(PORT), port("data"), port("data.augment")
    data.generate_synthetic_acdc(pkg.DATA_PATH)
    head = {"phase": "host_tier", "host_cpu": host_cpu(),
            "nvidia_smi": nvidia_smi() if device == "cuda" else None}
    with native_host(True) as nat:
        pngs = sorted(Path(pkg.DATA_PATH, "ACDC_contrast").rglob("*.png"))
        for path in pngs:
            with Image.open(path) as im:
                check(np.array_equal(nat.decode_png_gray8(path.read_bytes()), np.asarray(im)),
                      f"native decode != PIL on {path}")
        head["decode_equal_to_pil"] = len(pngs)
        gap = _host_gap(nat, aug)
    check(0.0 < gap["jitter_max_abs"] <= HOST_JITTER_GAP, f"native vs numpy jitter {gap}")
    check(gap["label_pixels_by_seed"] == HOST_TIE_PIXELS,
          f"native vs numpy label pixels {gap}, want {HOST_TIE_PIXELS}")
    head["native_vs_numpy"] = gap

    # one sample (one thread) and one batch of each headline loader (4 workers)
    lab_set, unlab_set, _ = data.ACDCSemiInterface(
        pkg.DATA_PATH, 0.25, 0.75).create_semi_supervised_datasets()
    img, gt, _ = lab_set.load_raw(0)
    head["sample_shape"] = list(img.shape)
    for native in (True, False):
        key = "native" if native else "numpy"
        with native_host(native):
            times = []
            for seed in range(HOST_DRAWS):
                t0 = time.perf_counter()
                aug.ACDCStrongTransforms.pretrain(img, gt, np.random.default_rng(seed))
                times.append((time.perf_counter() - t0) * 1e3)
            head[f"sample_ms_{key}"] = statistics.median(times)
            for name, dset, bs in (("labeled", lab_set, 4), ("unlabeled", unlab_set, 10)):
                loader = data.SegmentationLoader(dset, aug.ACDCStrongTransforms.pretrain, bs,
                                                 seed=10, num_workers=4)
                it = iter(loader)
                next(it)
                times = []
                for _ in range(HOST_BATCHES):
                    t0 = time.perf_counter()
                    next(it)
                    times.append((time.perf_counter() - t0) * 1e3)
                head[f"batch_ms_{name}_{key}"] = statistics.median(times)
                loader._pool.shutdown()
    emit(head)

    rows = []
    for precision, extra in (("fp32", ()), ("bf16", BF16)):
        for native in (True, False):
            tag = f"{precision}_{'native' if native else 'numpy'}"
            trainer, out = _host_run(steps, native, extra, tag, device)
            rows.append(out)
            del trainer
    emit({"phase": "host_tier", "summary": [
        {k: r.get(k) for k in ("run", "epoch_wall_s", "median_step_wall_ms", "median_step_ms",
                               "device_ms_per_step", "device_busy_share")} for r in rows],
        "host_cpu": head["host_cpu"], "nvidia_smi": head["nvidia_smi"]})
    return rows


# --- data parallelism: gloo ranks sharing the one card (parallel/mesh.py) ----
PAR_WORLD = 4            # parallel: ranks of the headline step, 4 + 10 padded to 4 + 12
PAR_TIMEOUT = 600.0      # seconds until any rank still running fails the phase
PAR_TIMED_STEPS = 2      # parallel: steps timed after the checked one, on the same batch
# parallel: a rank's summed gradient against one process's, relative L2 per tensor. The
# step's fp32 noise at 224^2 reads up to 1.5e-2 (a BN shift's gradient); a gradient W x
# too large reads W - 1, a rank's own rows alone about 0.9, a mean in place of the sum 1 - 1/W
PAR_GRAD_TOL = 5e-2
# ... except the Conv5 head's, which sits at noise (norm ~7e-10 at random init: a 1e-7
# change of the inputs moves it by as much, scripts/torch_step_noise.py)
PAR_GRAD_NOISE = "proj.heads.Conv5."
# train_parallel: device events a step under the world-1 context against none, relative.
# The same step reads 1536.33-1539 events a step from run to run and from step to step
# (library kernels, copies and memsets); the data group's path would add ~1000 (+65%)
PAR_EVENTS_TOL = 1e-2


def _par_batch(n_lab: int, n_unlab: int, crop: int, seed: int = 0):
    """A numpy batch (4 classes) and flip mask of the given global sizes."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return ({"labeled_image": rng.random((n_lab, crop, crop, 1), dtype=np.float32),
             "labeled_target": rng.integers(0, 4, (n_lab, crop, crop)).astype(np.int32),
             "unlabeled_image": rng.random((n_unlab, crop, crop, 1), dtype=np.float32)},
            rng.random((n_unlab, 2)) < 0.8)


def _par_build(device, ctx, valid=(None, None), fused: bool = False, store=None):
    """(model, named parameters, step) of the headline udaiic config (3
    taps, 5 x 20 clusters, paddings [1, 3]; Adam at 1e-3) from the weights of
    seed 0 on ``device`` under ``ctx``; ``valid``: the real rows of a padded
    batch; ``store``: the device-data path (crop 32, geometry shear)."""
    import torch

    models, optim, steps = port("models"), port("engine.optim"), port("engine.steps")
    feats = ["Conv5", "Up_conv3", "Up_conv2"]
    torch.manual_seed(0)
    model = models.UNet(1, 4).to(device)
    proj = models.ProjectorWrapper(feats, num_clusters=20, num_subheads=5,
                                   local_emit_logits=fused).to(device)
    params = list(chain(model.named_parameters(), proj.named_parameters(prefix="proj")))
    opt = optim.build_optimizer([p for _, p in params],
                                {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
    step = steps.build_train_step(
        model, opt, "udaiic", num_classes=4, generator=torch.Generator(device=device),
        feature_names=feats, feature_importance=[1.0, 0.5, 0.5], projector=proj,
        uda_weight=10.0, iic_weight=0.1, reg_weight=1.0, paddings=[1, 3], patch_sizes=1024,
        data_store=store, crop=32 if store is not None else 224, geometry="shear",
        n_labeled_valid=valid[0], n_unlabeled_valid=valid[1], context=ctx)
    return model, params, step


def _group_profile(ctx, steps: int = 3) -> dict:
    """The headline step (4 + 10 at 224^2, fp32) without a context and under
    ``ctx``, each warmed by one step and then profiled over ``steps`` steps
    (host and device activity): wall and device ms a step, device kernels a
    step (in all and by event name), the device ms by kernel kind and the host
    ops that take the most self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch_np, flips = _par_batch(4, 10, 224)
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    flip_mask = torch.from_numpy(flips).cuda()
    out = {}
    for name, c in (("no context", None), ("nccl world 1", ctx)):
        _, _, step = _par_build("cuda", c)
        step(batch, flip_mask=flip_mask)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                step(batch, flip_mask=flip_mask)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        events = prof.key_averages()
        device = [(e.key, e.self_device_time_total / 1e3 / steps) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.self_device_time_total > 0]
        by_kind: dict = {}
        for key, ms in device:
            by_kind[_kernel_kind(key)] = by_kind.get(_kernel_kind(key), 0.0) + ms
        host = sorted(((e.key, e.self_cpu_time_total / 1e3 / steps, e.count / steps)
                       for e in events if e.self_cpu_time_total > 0), key=lambda t: -t[1])
        counts = {e.key: e.count / steps for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        out[name] = {"wall_ms_per_step": wall, "device_kernels_per_step": sum(counts.values()),
                     "device_events_by_key": counts,
                     "device_ms_per_step": sum(ms for _, ms in device),
                     "by_kind_ms_per_step": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
                     "host_self_ms_per_step_top": [{"op": k[:80], "ms": ms, "calls": n}
                                                   for k, ms, n in host[:10]]}
    return out


def _par_run(device, ctx, batch_np, flips, padded=None, fused: bool = False, store=None,
             aug=None) -> dict:
    """One headline udaiic step (3 taps, 5 x 20 clusters, paddings [1, 3];
    Adam at 1e-3, so the first move shows) from the weights of seed 0 on
    ``device`` under ``ctx`` (None: one process): a tensor batch padded to
    ``padded`` = (labeled, unlabeled) global rows, of which the rank keeps
    its own; an index batch (``store``, crop 32, geometry shear, ``aug`` the
    injected draws) passed whole. Its losses, parameter moves, gradients, BN
    running statistics and kernel launches, then the wall ms of
    PAR_TIMED_STEPS more steps on the same batch."""
    import torch

    mj, mf, rot = port("ops.mi_joint"), port("ops.mi_fused"), port("ops.rotate")
    n_real = tuple(len(v) for k, v in batch_np.items() if not k.endswith("_target"))
    padded = padded or n_real
    model, params, step = _par_build(device, ctx, n_real if padded != n_real else (None, None),
                                     fused, store)
    pad_rows = port("engine.trainer").pad_rows
    full = {k: pad_rows(v, padded[0] if k.startswith("labeled") else padded[1])
            for k, v in batch_np.items()}
    if store is None and ctx is not None:
        full = {k: v[ctx.rows(len(v))] for k, v in full.items()}
    batch = {k: torch.from_numpy(v).to(device) for k, v in full.items()}
    flip_mask = torch.from_numpy(pad_rows(flips, padded[1])).to(device)
    before = {k: p.detach().cpu().clone() for k, p in params}
    for mod in (mj, mf, rot):
        mod.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch, flip_mask=flip_mask, aug_params=aug)
    torch.cuda.synchronize()
    out = {"losses": {k: float(metrics[k]) for k in ("sup_loss", "uda", "mi", "total_loss")},
           "moves": {k: p.detach().cpu() - before[k] for k, p in params},
           "grads": {k: p.grad.detach().cpu() for k, p in params if p.grad is not None},
           "bn_stats": torch.cat([v.detach().cpu().flatten() for k, v in
                                  model.state_dict().items() if "running_" in k]),
           "launches": {"mi_joint": sum(mj.LAUNCHES.values()),
                        "mi_fused": sum(mf.LAUNCHES.values()),
                        "rotate": rot.launch_count(rot.ROTATE)},
           "first_step_ms": (time.perf_counter() - t0) * 1e3,
           "rank": None if ctx is None else ctx.rank, "step_ms": []}
    for _ in range(PAR_TIMED_STEPS):
        t0 = time.perf_counter()
        step(batch, flip_mask=flip_mask, aug_params=aug)
        torch.cuda.synchronize()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    return out


def _full_fp32() -> None:
    """fp32 matmuls and convolutions in full fp32 (TF32 off), as ``main``
    sets them for the parent: a spawned rank starts with torch's defaults,
    which let cuDNN convolve in TF32."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _par_rank(ctx, spawned_at: float, headline, pair, dry_root: str) -> dict:
    """A rank of the PAR_WORLD-rank run: the padded headline step; then, in
    two pairs of ranks (each its own group of 2, side by side), ranks 0-1 the
    fused step and ranks 2-3 the device-path step with geometry shear (the
    whole store staged on the rank's card); then the dry run
    (``parallel/dryrun.py:dryrun_rank``) on all ranks."""
    import torch.distributed as dist

    ready = time.time()
    _full_fp32()
    mesh, data, dp = port("parallel.mesh"), port("data"), port("data.device_pipeline")
    out = {"startup_s": {"to_import": IMPORTED_AT - spawned_at,
                         "import_to_ready": ready - IMPORTED_AT},
           "headline": _par_run(ctx.device, ctx, *headline)}
    groups = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    half = ctx.rank // 2
    sub = mesh.DistContext(world=2, rank=ctx.rank % 2, local_rank=ctx.local_rank,
                           device=ctx.device, group=groups[half])
    fused_np, fused_flips, store_root, index_np, dev_flips, aug = pair
    if half == 0:
        out["fused"] = _par_run(ctx.device, sub, fused_np, fused_flips, fused=True)
    else:
        store = dp.DeviceDataStore(data.ACDCDataset(store_root, "train"), device=ctx.device,
                                   pack=True)
        aug = {k: {n: None if t is None else t.to(ctx.device) for n, t in v.items()}
               for k, v in aug.items()}
        out["device"] = _par_run(ctx.device, sub, index_np, dev_flips, store=store, aug=aug)
    t0 = time.perf_counter()
    out["dryrun"] = port("parallel.dryrun").dryrun_rank(ctx, dry_root)
    out["dryrun"]["wall_s"] = time.perf_counter() - t0
    return out


def _par_compare(what: str, ref: dict, got: dict, launches: dict) -> dict:
    """A rank's step against the one-process step: its launches exactly,
    losses and BN statistics at STEPS_TOL (relative), parameter moves to the
    step phase's two-tier bound, the summed gradient of every tensor within
    PAR_GRAD_TOL (relative L2) but the Conv5 head's (PAR_GRAD_NOISE),
    whose distance is reported only."""
    import numpy as np

    rel = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in ref["losses"].items()}
    diffs = np.concatenate([(got["moves"][k] - m).abs().flatten().numpy()
                            for k, m in ref["moves"].items()])
    loose = float(np.mean(diffs > 0.05 * 1e-3))
    rel_stats = float((got["bn_stats"] - ref["bn_stats"]).norm() / ref["bn_stats"].norm())
    grad_rel = {k: float((got["grads"][k] - g).norm() / max(float(g.norm()), 1e-30))
                for k, g in ref["grads"].items()}
    held = {k: v for k, v in grad_rel.items() if not k.startswith(PAR_GRAD_NOISE)}
    grads_ok = set(got["grads"]) == set(ref["grads"]) and max(held.values()) <= PAR_GRAD_TOL
    out = {"rank": got["rank"], "rel_err": rel, "param_delta_max_diff": float(diffs.max()),
           "param_delta_loose_share": loose, "bn_stats_rel_err": rel_stats,
           "grad_rel_l2_worst": sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3],
           "grad_rel_l2_worst_held": max(held.items(), key=lambda kv: kv[1]),
           "launches": got["launches"], "rank_first_step_ms": got["first_step_ms"],
           "rank_step_ms": got["step_ms"]}
    ok = (got["launches"] == launches and all(v <= STEPS_TOL for v in rel.values())
          and diffs.max() <= 2.05e-3 and loose < 0.005 and rel_stats <= STEPS_TOL
          and grads_ok)
    if not ok:
        emit({"phase": "parallel_mismatch", "what": what, **out})
    check(got["launches"] == launches, f"{what}: launches {got['launches']} (want {launches})")
    check(all(v <= STEPS_TOL for v in rel.values()), f"{what} losses differ: {rel}")
    check(diffs.max() <= 2.05e-3 and loose < 0.005,
          f"{what} parameter moves: max {diffs.max()}, loose share {loose}")
    check(rel_stats <= STEPS_TOL, f"{what} BN statistics differ by {rel_stats}")
    check(grads_ok, f"{what} summed gradients: {out['grad_rel_l2_worst_held']} "
                    f"(bound {PAR_GRAD_TOL}), tensors {len(got['grads'])} of {len(ref['grads'])}")
    return out


def phase_parallel() -> dict:
    """Data parallelism on the one card, PAR_WORLD gloo ranks on cuda:0 in one
    spawn: each the headline udaiic step (fp32, crop 224) on its rows of the
    4 + 10 batch padded to 4 + 12, against the one-process card step on the
    unpadded batch (same weights, flip mask), 6 joint launches a rank; two
    pairs of ranks (W = 2 each) the fused step (4 + 8, no pad: 2 + 4 fused
    launches a rank, no joint launch) and the device-path step (shear, 4 + 10
    indices of the small store: 2 rotation launches a rank), each against
    one process; then the dry run on all ranks. A rank's step ms is that of
    PAR_WORLD processes time-sharing one card through gloo (which stages
    CUDA tensors on the host), not a scaling figure. Returns each kernel's
    launches on one rank."""
    import numpy as np
    import torch

    dryrun = port("parallel.dryrun")
    data, dp, aug_mod = port("data"), port("data.device_pipeline"), port("ops.augment_device")
    build_dir = Path(import_module(PORT).PROJECT_PATH) / "build"
    batch, flips = _par_batch(4, 10, 224)
    padded = (-(-4 // PAR_WORLD) * PAR_WORLD, -(-10 // PAR_WORLD) * PAR_WORLD)
    fused_np, fused_flips = _par_batch(4, 8, 224, seed=1)
    root = build_dir / "chip_smoke_small"
    data.generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                                 slices_per_patient=4, size=64)
    cpu_store = dp.DeviceDataStore(data.ACDCDataset(str(root), "train"), pack=True)
    rng = np.random.default_rng(2)
    index_np = {"labeled_indices": rng.integers(0, len(cpu_store), 4),
                "unlabeled_indices": rng.integers(0, len(cpu_store), 10)}
    gen = torch.Generator().manual_seed(5)
    aug = {k[:-len("_indices")]: aug_mod.sample_augment_params(
               gen, len(v), cpu_store.shape, crop=32, valid_hw=cpu_store.valid_hw_dev[v],
               offsets=cpu_store.offsets_dev[v]) for k, v in index_np.items()}
    dev_flips = rng.random((10, 2)) < 0.8
    dry_root = build_dir / "chip_smoke_dryrun"
    shutil.rmtree(dry_root, ignore_errors=True)
    spawned_at = time.time()
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(
        _par_rank, PAR_WORLD, spawned_at, (batch, flips, padded),
        (fused_np, fused_flips, str(root), index_np, dev_flips, aug), str(dry_root),
        device="cuda:0", timeout=PAR_TIMEOUT, threads=2)
    spawn_wall = time.perf_counter() - t0
    # the one-process references, after the ranks have left the card
    ref = _par_run("cuda", None, batch, flips)
    fused_ref = _par_run("cuda", None, fused_np, fused_flips, fused=True)
    store = dp.DeviceDataStore(data.ACDCDataset(str(root), "train"), device="cuda", pack=True)
    dev_aug = {k: {n: None if t is None else t.cuda() for n, t in v.items()}
               for k, v in aug.items()}
    dev_ref = _par_run("cuda", None, index_np, dev_flips, store=store, aug=dev_aug)
    # parallel/dryrun.py:entry, the headline step and its arguments at full width
    entry_step, entry_args = dryrun.entry("cuda")
    entry_loss = float(entry_step(*entry_args)["total_loss"])
    check(math.isfinite(entry_loss), f"entry(): total loss {entry_loss}")
    joint, fused, shear = ({"mi_joint": 6, "mi_fused": 0, "rotate": 0},
                           {"mi_joint": 0, "mi_fused": 6, "rotate": 0},
                           {"mi_joint": 6, "mi_fused": 0, "rotate": 2})
    rows = [_par_compare(f"parallel rank {r['headline']['rank']}", ref, r["headline"], joint)
            for r in ranks]
    fused_rows = [_par_compare(f"parallel fused rank {r['fused']['rank']}", fused_ref,
                               r["fused"], fused) for r in ranks if "fused" in r]
    device_rows = [_par_compare(f"parallel device rank {r['device']['rank']}", dev_ref,
                                r["device"], shear) for r in ranks if "device" in r]
    emit({"phase": "parallel", "world": PAR_WORLD, "batch": [4, 10], "padded": list(padded),
          "crop": 224, "backend": "gloo", "device": "cuda:0", "nvidia_smi": nvidia_smi(),
          "note": ("rank_*step_ms: a rank's step while all ranks time-share one card through "
                   "gloo (not a scaling figure); step_ms: the steps after the first"),
          "one_process": {"first_step_ms": ref["first_step_ms"], "step_ms": ref["step_ms"],
                          "losses": ref["losses"]},
          "entry_total_loss": entry_loss,
          "ranks": rows, "rank_startup_s": [r["startup_s"] for r in ranks],
          "dryrun": [r["dryrun"] for r in ranks][0], "spawn_wall_s": spawn_wall,
          "pairs": {"world": 2, "fused_batch": [4, 8], "fused": fused_rows,
                    "fused_one_process_step_ms": fused_ref["step_ms"],
                    "device_batch": [4, 10], "device_crop": 32, "geometry": "shear",
                    "device": device_rows, "device_one_process_step_ms": dev_ref["step_ms"]}})
    return {"mi_joint": rows[0]["launches"]["mi_joint"],
            "mi_fused": fused_rows[0]["launches"]["mi_fused"],
            "rotate": device_rows[0]["launches"]["rotate"]}


@contextmanager
def _torchrun_world1(module):
    """The variables ``torchrun`` sets for a world of 1 (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR / MASTER_PORT at a free port), and
    ``module.init_distributed`` spied on: yields what the entry's context
    was (backend, world, device, whether it had a data group); both
    restored at the end."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("localhost", 0))
        free = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(free), "RANK": "0",
           "LOCAL_RANK": "0", "WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    seen = {}
    real_init = module.init_distributed

    def spy(*args, **kwargs):
        ctx = real_init(*args, **kwargs)
        seen.update(backend=dist.get_backend(), world=ctx.world, device=str(ctx.device),
                    group=ctx.group is not None)
        return ctx

    module.init_distributed = spy
    os.environ.update(env)
    try:
        yield seen
    finally:
        module.init_distributed = real_init
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_train_parallel(steps: int, train_out) -> None:
    """The train phase's run through ``main.main`` under an NCCL group of
    world 1, set up as ``torchrun`` sets it (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR / MASTER_PORT): the context has no data group, so the rank
    runs the one-process step (cuDNN BN, no collective); the losses within
    STEPS_TOL of the train phase's, the step time beside it, and a profile
    of the headline step under that context with no collective and as many
    device events a step as without one, within PAR_EVENTS_TOL (the events
    whose counts differ are printed); the group is left at the end."""
    import torch.distributed as dist

    main_mod = port("main")
    real_init = main_mod.init_distributed
    with _torchrun_world1(main_mod) as seen:
        _, _, out = phase_train(steps, phase="train_parallel", run_tag="_parallel")
        ctx = real_init("cuda")  # the same group again, for the profile
        try:
            profile_out = _group_profile(ctx)
        finally:
            ctx.close()
    check(seen == {"backend": "nccl", "world": 1, "device": "cuda:0", "group": False},
          f"train_parallel ran under {seen}")
    by_key = {k: v.pop("device_events_by_key") for k, v in profile_out.items()}
    kernels = {k: v["device_kernels_per_step"] for k, v in profile_out.items()}
    differ = {key: [by_key["nccl world 1"].get(key, 0.0), by_key["no context"].get(key, 0.0)]
              for key in set(by_key["nccl world 1"]) | set(by_key["no context"])
              if by_key["nccl world 1"].get(key) != by_key["no context"].get(key)}
    nccl = [key for key in by_key["nccl world 1"] if _kernel_kind(key) == "collectives (NCCL)"]
    check(not nccl, f"train_parallel: collectives at world 1: {nccl}")
    check(abs(kernels["nccl world 1"] - kernels["no context"])
          <= PAR_EVENTS_TOL * kernels["no context"],
          f"train_parallel: device events a step {kernels}, differing {differ}")
    check(not dist.is_initialized(), "train_parallel: main.main left the group joined")
    line = {"phase": "train_parallel_vs_train", "group": seen,
            "profile": profile_out, "events_differing": differ,
            "median_step_ms": [out["median_step_ms"], train_out and train_out["median_step_ms"]],
            "order": ["nccl world 1", "no context"]}
    if train_out is not None:
        rel = {k: abs(v - train_out["losses"][k]) / max(abs(train_out["losses"][k]), 1e-12)
               for k, v in out["losses"].items()}
        check(all(v <= STEPS_TOL for v in rel.values()), f"train_parallel losses differ: {rel}")
        line["rel_err"] = rel
    emit(line)


# --- the pretrain pipeline on gloo ranks sharing the one card (engine/pretrain.py) ---
PPAR_WORLD = 4        # pretrain_parallel: ranks, each 3 of the 12 contrastive slices
PPAR_PATIENTS = 4     # pretrain.yaml's PretrainData.group_sample_num (x 3 partitions)
PPAR_LABELED = 4      # pretrain.yaml's FineTuneData.batch_size (contrastMT's labeled rows)
PPAR_PHASES = ("encoder", "decoder", "finetune_mt")
# pretrain_parallel's encoder step: at random init on noise its IIC loss, an MI over 12
# globally pooled slices, sits at 0 (-5e-9 on the card) and its head's gradient at the fp32
# noise (relative L2 1.28 between a rank and one process, norm 1.5e-8), where a joint left
# unsummed over the ranks would pass. So its two views are one slice at one intensity level
# (drawn in [0, PPAR_LEVEL)) under two draws of noise, and its IIC head's weights are scaled
# by PPAR_HEAD_SCALE: the MI reads -0.18 nats and the head's gradient norm 0.1 (a CPU run at
# 64^2), and every loss and gradient is held without a floor or an exclusion
PPAR_LEVEL = 4.0
PPAR_HEAD_SCALE = 30.0
# pretrain_main at world 1 against the pretrain phase's run: a loss's error is taken
# relative to max(|loss|, PPAR_LOSS_FLOOR). That run's encoder IIC loss sits at 0 (random
# init), where the fp32 sums' order alone moves it; an MI's own scale is log(10) = 2.3 nats
PPAR_LOSS_FLOOR = 1e-2


def _ppar_data(seed: int = 3) -> dict:
    """The global batch of each phase at pretrain.yaml's widths (crop 224):
    12 slices in two views (4 patients x 3 partitions) with the encoder's
    and the decoder's contrastive labels, the decoder's flip draw; the
    encoder's two views of the 12 slices (see PPAR_LEVEL); 4 labeled slices
    with targets and 12 unlabeled, the finetune flip draw."""
    import numpy as np

    pre = port("engine.pretrain")
    rng = np.random.default_rng(seed)
    n = 3 * PPAR_PATIENTS
    parts = [str(i % 3) for i in range(n)]
    groups = [f"patient{i // 3}" for i in range(n)]
    level = rng.random((n, 1, 1, 1), dtype=np.float32) * PPAR_LEVEL
    return {"enc_image": level + rng.random((n, 224, 224, 1), dtype=np.float32),
            "enc_image_tf": level + rng.random((n, 224, 224, 1), dtype=np.float32),
            "image": rng.random((n, 224, 224, 1), dtype=np.float32),
            "image_tf": rng.random((n, 224, 224, 1), dtype=np.float32),
            "labels_encoder": pre.global_labels(parts, groups),
            "labels_decoder": pre.local_labels(parts, groups, pre.unfold_locations((4, 4), n)),
            "flips": rng.random((n, 2)) < 0.5,
            "labeled": rng.random((PPAR_LABELED, 224, 224, 1), dtype=np.float32),
            "target": rng.integers(0, 4, (PPAR_LABELED, 224, 224)).astype(np.int32),
            "mt_flips": rng.random((n, 2)) < 0.5}


def _ppar_step(phase: str, device):
    """(model, ``engine/pretrain.py:_Phase``) of one pretrain phase at
    pretrain.yaml's widths (projector mlp; IIC heads 10 x 10 linear on
    Conv5, 10 x 20 mlp on Up_conv3; the mean teacher), the U-Net of seed 0,
    the heads of seed 1 (the encoder's IIC head's weights times
    PPAR_HEAD_SCALE), Adam at 1e-3 (so the first move shows) with
    pretrain.yaml's weight decays, the trainer's freeze."""
    import torch

    models, pre = port("models"), port("engine.pretrain")
    subheads, clusters = PRETRAIN_HEAD
    torch.manual_seed(0)
    model = models.UNet(1, 4).to(device)
    torch.manual_seed(1)
    teacher = None
    if phase == "encoder":
        heads = {"projector": models.ProjectionHead(256, output_dim=256, head_type="mlp"),
                 "iic": models.ClusterHead(256, num_clusters=10, num_subheads=10,
                                           head_type="linear")}
        with torch.no_grad():
            heads["iic"].linear.weight.mul_(PPAR_HEAD_SCALE)
        comps, wd = pre.component_range("Conv1", "Conv5"), 1e-5
    elif phase == "decoder":
        heads = {"projector": models.LocalProjectionHead(32, head_type="mlp"),
                 "iic": models.LocalClusterHead(32, num_clusters=clusters,
                                                num_subheads=subheads, head_type="mlp",
                                                flat_output=False)}
        comps, wd = pre.component_range("Up5", "Up_conv3"), 0.0
    else:
        heads, comps, wd = {}, pre.COMPONENT_NAMES, 1e-5
        teacher = copy.deepcopy(model).requires_grad_(False)
    phase_state = pre._Phase(model, torch.nn.ModuleDict(heads), comps, 1e-3, wd,
                             torch.device(device), 11, teacher)
    return model, phase_state


def _ppar_run(device, ctx, data: dict) -> dict:
    """One step of each PPAR_PHASES phase (``engine/pretrain.py``'s builders)
    on ``device`` under ``ctx`` (None: one process on the global batch):
    the rank's rows of each batch, the labels whole, the flip draws
    injected. For each: its losses, parameter moves, summed gradients, BN
    running statistics (the teacher's too), the joint's launches, the first
    step's ms, then the ms of PAR_TIMED_STEPS more steps on the same batch."""
    import torch

    pre, mj = port("engine.pretrain"), port("ops.mi_joint")
    rows = (lambda a: a) if ctx is None else (lambda a: a[ctx.rows(len(a))])
    t = lambda a: torch.from_numpy(rows(a)).to(device)
    n = len(data["image"])
    out = {}
    for phase in PPAR_PHASES:
        model, ph = _ppar_step(phase, device)
        if phase == "encoder":
            step = pre.build_pretrain_encoder_step(
                model, ph.heads["projector"], ph.optimizer, iic_head=ph.heads["iic"],
                step_counter=ph.counter, context=ctx)
            batch = {"image": t(data["enc_image"]), "image_tf": t(data["enc_image_tf"]),
                     "labels": torch.from_numpy(data["labels_encoder"]).to(device)}
            kw = {"n_valid": n}
        elif phase == "decoder":
            step = pre.build_pretrain_decoder_step(
                model, ph.heads["projector"], ph.optimizer, generator=ph.generator,
                iic_head=ph.heads["iic"], step_counter=ph.counter, context=ctx)
            batch = {"image": t(data["image"]), "image_tf": t(data["image_tf"]),
                     "labels": torch.from_numpy(data["labels_decoder"]).to(device)}
            kw = {"n_valid": n, "flip_mask": torch.from_numpy(data["flips"])}
        else:
            step = pre.build_finetune_mt_step(
                model, ph.teacher, ph.optimizer, num_classes=4, generator=ph.generator,
                step_counter=ph.counter, context=ctx)
            batch = {"image": t(data["labeled"]), "target": t(data["target"]),
                     "unlabeled_image": t(data["image"])}
            kw = {"n_valid": PPAR_LABELED, "n_unlabeled_valid": n,
                  "flip_mask": torch.from_numpy(data["mt_flips"])}
        params = list(chain(model.named_parameters(), ph.heads.named_parameters(prefix="heads")))
        before = {k: p.detach().cpu().clone() for k, p in params}
        stats = lambda net: torch.cat([v.detach().cpu().flatten() for k, v in
                                       net.state_dict().items() if "running_" in k])
        mj.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step(batch, **kw)
        torch.cuda.synchronize()
        rec = {"losses": {k: float(v) for k, v in metrics.items() if v.dim() == 0},
               "moves": {k: p.detach().cpu() - before[k] for k, p in params},
               "grads": {k: p.grad.detach().cpu() for k, p in params if p.grad is not None},
               "bn_stats": stats(model),
               "launches": {f"{k}/p{p}": v for (k, p), v in sorted(mj.LAUNCHES.items())},
               "first_step_ms": (time.perf_counter() - t0) * 1e3, "step_ms": [],
               "rank": None if ctx is None else ctx.rank}
        if ph.teacher is not None:
            rec["teacher_bn_stats"] = stats(ph.teacher)
        for _ in range(PAR_TIMED_STEPS):
            t0 = time.perf_counter()
            step(batch, **kw)
            torch.cuda.synchronize()
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        ph.close()
        out[phase] = rec
        del model, ph, step, batch
    return out


def _ppar_rank(ctx, spawned_at: float, data: dict) -> dict:
    """A rank of the pretrain_parallel run: the three steps on its rows."""
    ready = time.time()
    _full_fp32()
    out = _ppar_run(ctx.device, ctx, data)
    out["startup_s"] = {"to_import": IMPORTED_AT - spawned_at,
                        "import_to_ready": ready - IMPORTED_AT}
    return out


def _ppar_compare(phase: str, ref: dict, got: dict, launches: dict):
    """A rank's step of ``phase`` against the one-process step: (the
    readings, the checks as (ok, message) pairs). Held: the joint's launches
    exactly, the losses and the BN statistics (the teacher's too) within
    STEPS_TOL (relative), the parameter moves to the step phase's two-tier
    bound, each tensor's summed gradient within PAR_GRAD_TOL (relative L2),
    the worst reported with the reference's norm."""
    import numpy as np

    what = f"pretrain_parallel {phase} rank {got['rank']}"
    rel = {k: abs(got["losses"][k] - v) / max(abs(v), 1e-12) for k, v in ref["losses"].items()}
    diffs = np.concatenate([(got["moves"][k] - m).abs().flatten().numpy()
                            for k, m in ref["moves"].items()])
    loose = float(np.mean(diffs > 0.05 * 1e-3))
    stats = {k: float((got[k] - ref[k]).norm() / ref[k].norm())
             for k in ("bn_stats", "teacher_bn_stats") if k in ref}
    grad_rel = {k: float((got["grads"][k] - g).norm() / max(float(g.norm()), 1e-30))
                for k, g in ref["grads"].items()}
    out = {"phase_step": phase, "rank": got["rank"], "rel_err": rel,
           "param_delta_max_diff": float(diffs.max()), "param_delta_loose_share": loose,
           "stats_rel_err": stats,
           "grad_rel_l2_worst": [(k, v, float(ref["grads"][k].norm())) for k, v in
                                 sorted(grad_rel.items(), key=lambda kv: -kv[1])[:3]],
           "launches": got["launches"], "rank_first_step_ms": got["first_step_ms"],
           "rank_step_ms": got["step_ms"]}
    checks = [(got["launches"] == launches, f"launches {got['launches']} (want {launches})"),
              (set(rel) == set(got["losses"]) and all(v <= STEPS_TOL for v in rel.values()),
               f"losses differ: {rel}"),
              (diffs.max() <= 2.05e-3 and loose < 0.005,
               f"parameter moves: max {diffs.max()}, loose share {loose}"),
              (all(v <= STEPS_TOL for v in stats.values()), f"BN statistics differ: {stats}"),
              (set(got["grads"]) == set(ref["grads"]) and max(grad_rel.values()) <= PAR_GRAD_TOL,
               f"summed gradients: {out['grad_rel_l2_worst']} (bound {PAR_GRAD_TOL})")]
    return out, [(ok, f"{what}: {msg}") for ok, msg in checks]


def phase_pretrain_parallel(pretrain_run) -> dict:
    """The pretrain pipeline's steps data parallel on the one card:
    PPAR_WORLD gloo ranks on cuda:0 in one spawn, each one step of the
    ``iiccontrast`` encoder and decoder phases and of ``contrastMT``'s
    finetune on its 3 of the 12 slices at 224^2 (1 + 3 in finetune), against
    the same steps in one process on the card (``_ppar_compare``): exactly
    12 joint launches a rank in the decoder step (3 products x 4 pairs of
    128-lane blocks at p = 0 on 3 x 112^2 = 37,632 rows), none in the other
    two. Then ``pretrain_main`` under an NCCL group of world 1 set up as
    ``torchrun`` sets it: no data group and no collective call (each
    ``torch.distributed`` collective counted), the decoder phase's 12
    launches a step, the losses within STEPS_TOL of ``pretrain_run`` (the
    pretrain phase's run directory, None when it did not run). A rank's step ms is that of ranks time-sharing one card
    through gloo, not a scaling figure. Returns a rank's decoder launches."""
    dryrun, mj = port("parallel.dryrun"), port("ops.mi_joint")
    data = _ppar_data()
    spawned_at = time.time()
    t0 = time.perf_counter()
    ranks = dryrun.run_ranks(_ppar_rank, PPAR_WORLD, spawned_at, data, device="cuda:0",
                             timeout=PAR_TIMEOUT, threads=2)
    spawn_wall = time.perf_counter() - t0
    ref = _ppar_run("cuda", None, data)  # after the ranks have left the card
    subheads, clusters = PRETRAIN_HEAD
    per_step = {f"{name}/p0": len(mj._lane_tiles(subheads * clusters)) ** 2
                for name in (mj.FWD, mj.BWD_DX, mj.BWD_DX_TF)}
    check(sum(per_step.values()) == 12, f"pretrain_parallel: {per_step} a decoder step")
    compared = [_ppar_compare(phase, ref[phase], r[phase], per_step if phase == "decoder" else {})
                for r in ranks for phase in PPAR_PHASES]
    rows = [row for row, _ in compared]
    emit({"phase": "pretrain_parallel", "world": PPAR_WORLD, "slices": len(data["image"]),
          "labeled": PPAR_LABELED, "crop": 224, "backend": "gloo", "device": "cuda:0",
          "nvidia_smi": nvidia_smi(),
          "note": ("rank_*step_ms: a rank's step while all ranks time-share one card through "
                   "gloo (not a scaling figure); step_ms: the steps after the first"),
          "one_process": {phase: {"first_step_ms": ref[phase]["first_step_ms"],
                                  "step_ms": ref[phase]["step_ms"],
                                  "losses": ref[phase]["losses"],
                                  "launches": ref[phase]["launches"]} for phase in PPAR_PHASES},
          "ranks": rows, "rank_startup_s": [r["startup_s"] for r in ranks],
          "spawn_wall_s": spawn_wall})
    for _, checks in compared:  # every reading printed before the first failure
        for ok, msg in checks:
            check(ok, msg)
    _ppar_main_world1(pretrain_run)
    return {(k.rsplit("/p", 1)[0], int(k.rsplit("/p", 1)[1])): v
            for k, v in ranks[0]["decoder"]["launches"].items()}


def _ppar_main_world1(single) -> None:
    """``pretrain_main.main`` (iiccontrast, PRETRAIN_STEPS steps a phase, as
    the pretrain phase) with the torchrun variables of a world of 1 set:
    an NCCL group whose context has no data group, no collective call, the
    decoder phase's 12 launches a step, and the phase CSVs' losses within
    STEPS_TOL of ``single``'s, the pretrain phase's run (relative to
    PPAR_LOSS_FLOOR at least; the same seeds, data and card; None: not run);
    the group left at the end."""
    import torch.distributed as dist

    pm, mj, pre = port("pretrain_main"), port("ops.mi_joint"), port("engine.pretrain")
    calls = []
    collectives = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
                   "reduce_scatter", "reduce_scatter_tensor", "barrier", "gather", "scatter")
    originals = {name: getattr(dist, name) for name in collectives}

    def counted(name):
        def call(*args, **kwargs):
            calls.append(name)
            return originals[name](*args, **kwargs)
        return call

    record: dict = {}
    for name in collectives:
        setattr(dist, name, counted(name))
    try:
        with _torchrun_world1(pm) as seen, _watch_phases(pre.IICContrastTrainer, record):
            trainer = pm.main(_pretrain_argv("iiccontrast", "chip_smoke_pretrain_world1"))
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)
    check(seen == {"backend": "nccl", "world": 1, "device": "cuda:0", "group": False},
          f"pretrain_parallel world 1 ran under {seen}")
    check(not calls, f"pretrain_parallel world 1: collectives called {sorted(set(calls))}")
    check(not dist.is_initialized(), "pretrain_parallel: pretrain_main left the group joined")
    subheads, clusters = PRETRAIN_HEAD
    per_product = len(mj._lane_tiles(subheads * clusters)) ** 2
    want = {(name, 0): PRETRAIN_STEPS * per_product for name in (mj.FWD, mj.BWD_DX, mj.BWD_DX_TF)}
    check(record["pretrain_decoder"]["launches"] == want,
          f"pretrain_parallel world 1: decoder launches {record['pretrain_decoder']['launches']}")
    run = Path(trainer._save_dir)
    line = {"phase": "pretrain_parallel_world1", "group": seen, "collective_calls": len(calls),
            "median_step_ms": {k: statistics.median(v[1:]) for k, v in
                               trainer.step_times_ms.items()}}
    if single is not None:
        rel = {}
        for phase in pre.PHASES:
            (a,), (b,) = _phase_rows(run, phase), _phase_rows(single, phase)
            for k in a:
                if k.endswith("_loss_mean"):
                    rel[f"{phase}/{k}"] = abs(float(a[k]) - float(b[k])) / max(
                        abs(float(b[k])), PPAR_LOSS_FLOOR)
        check(all(v <= STEPS_TOL for v in rel.values()), f"pretrain_parallel world 1: {rel}")
        line["rel_err_vs_pretrain_phase"] = rel
    emit(line)


def _kernel_kind(name: str) -> str:
    lowered = name.lower()
    # the joint's kernels and the fused path's (which run on the joint's core)
    if any(k in lowered for k in ("fused_fwd", "fused_bwd", "joint_fwd", "joint_bwd",
                                  "joint_prep")):
        return "displaced-MI joint kernels (this port's CUDA: mi_joint, mi_fused)"
    if "rotate_shear" in lowered or "lane_roll" in lowered:
        return "rotation (this port's CUDA)"
    if "nccl" in lowered:
        return "collectives (NCCL)"
    if any(k in lowered for k in ("batch_norm", "batchnorm", "bn_", "welford")):
        return "batch norm"
    if any(k in lowered for k in ("conv", "xmma", "cudnn", "implicit", "gemm", "wgrad", "dgrad",
                                  "cutlass", "sm90_")):
        return "convolution / matmul and its layout copies (cuDNN, cuBLAS)"
    return "elementwise, reduction, copy"


def phase_profile(trainer, steps: int, path: str = "host", expect=(), forbid=()) -> dict:
    """Device time of a few train steps of a headline trainer, by kernel and
    by kind (torch.profiler with CUDA activity), on one batch: host images
    already on the card, or (a device-data trainer) slice indices whose
    gather and augmentation run inside each step. ``path`` labels the line;
    each of ``expect`` must be part of a kernel's name, none of ``forbid``."""
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    names = [n for n, _, _ in kernels]
    for part in expect:
        check(any(part in n for n in names), f"profile {path}: no kernel named *{part}*")
    for part in forbid:
        check(not any(part in n for n in names), f"profile {path}: a kernel named *{part}*")
    out = {"phase": "profile", "path": path, "dtype": str(trainer._model.dtype), "steps": steps,
           "wall_ms_per_step": wall_ms, "device_ms_per_step": device_ms,
           "device_busy_share": device_ms / wall_ms if wall_ms else None,
           "by_kind_ms_per_step": dict(sorted(by_kind.items(), key=lambda kv: -kv[1])),
           "top_kernels": [{"name": n[:120], "ms_per_step": ms, "calls_per_step": c}
                           for n, ms, c in kernels[:15]]}
    emit(out)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--phases", default="device,build,kernels,step,step_fused,step_device,"
                                              "step_meanteacher,step_bf16,step_s2d,step_heads,"
                                              "train,train_tiled,train_heads,train_backends,"
                                              "train_fused,train_device,train_bf16,train_remat,"
                                              "resume,inference,train_zoo,pretrain,optim,arch_zoo,"
                                              "host_tier,parallel,train_parallel,"
                                              "pretrain_parallel,profile")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--steps", type=int, default=8)
    args = parser.parse_args(argv)
    phases = args.phases.split(",")
    start = time.perf_counter()
    walls = {}  # seconds of each phase

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
        with timed(walls, "build"):
            phase_build()
    kernel_rows, tile_rows, rotation_rows, fused_rows = [], [], [], []
    if "kernels" in phases:
        with timed(walls, "kernels_joint"):
            kernel_rows = phase_kernels(args.reps)
            phase_kernels_wide(args.reps)
            tile_rows = phase_kernels_tiles(args.reps)
        with timed(walls, "kernels_rotate"):
            rotation_rows = phase_kernels_rotate(args.reps)
        with timed(walls, "kernels_fused"):
            fused_rows = phase_kernels_fused(args.reps)
    for name, run in (("step", phase_step), ("step_fused", partial(phase_step, fused=True)),
                      ("step_device", phase_step_device),
                      ("step_meanteacher", phase_step_meanteacher),
                      ("step_bf16", partial(phase_step, phase="step_bf16", dtype=torch.bfloat16,
                                            tol=STEPS_TOL_BF16)),
                      ("step_s2d", partial(phase_step, phase="step_s2d", stem="s2d")),
                      ("step_heads", partial(phase_step, phase="step_heads", patch=8,
                                             heads={"head_types": "mlp", "normalize": True}))):
        if name in phases:
            with timed(walls, name):
                run()
    trainer, launches, train_out = None, {}, None
    if "train" in phases:
        with timed(walls, "train"):
            trainer, launches, train_out = phase_train(args.steps)
    tiled_launches = {}
    if "train_tiled" in phases:
        with timed(walls, "train_tiled"):
            tiled_trainer, tiled_launches = phase_train_tiled()
            del tiled_trainer
    if "train_heads" in phases:
        with timed(walls, "train_heads"):
            phase_train_heads()
    if "train_backends" in phases:
        with timed(walls, "train_backends"):
            phase_train_backends()
    fused_trainer, fused_launches, fused_out = None, {}, None
    if "train_fused" in phases:
        with timed(walls, "train_fused"):
            fused_trainer, fused_launches, fused_out = phase_train(args.steps, "pallas_fused")
    if train_out is not None and fused_out is not None:
        # the fused path's reason to exist: no probability map in device memory
        peak, fused_peak = (o["max_memory_allocated_gib"] for o in (train_out, fused_out))
        check(fused_peak < peak, f"train_fused peak {fused_peak} GiB >= train peak {peak} GiB")
    device_trainer, rot_launches, device_out = None, {}, None
    if "train_device" in phases:
        with timed(walls, "train_device"):
            device_trainer, rot_launches, _, device_out = phase_train_device(args.steps, "shear")
            phase_train_device(args.steps, "fused")
    # the bf16 compute (bench.py's headline precision) on the three paths
    bf16_runs, bf16_launches, bf16_fused_launches = {}, {}, {}
    if "train_bf16" in phases:
        with timed(walls, "train_bf16"):
            kw = dict(extra=BF16, phase="train_bf16", run_tag="_bf16")
            trainer16, bf16_launches, out16 = phase_train(args.steps, **kw)
            fused16, bf16_fused_launches, fused_out16 = phase_train(args.steps, "pallas_fused",
                                                                    **kw)
            device16, _, _, device_out16 = phase_train_device(args.steps, "shear", **kw)
        bf16_runs = {"host": (trainer16, out16, train_out),
                     "host_fused": (fused16, fused_out16, fused_out),
                     "device": (device16, device_out16, device_out)}
    if "train_remat" in phases:
        with timed(walls, "train_remat"):
            phase_train_remat()
    resume_launches, zoo_rot_launches = {}, {}
    if "resume" in phases or "inference" in phases:  # inference evaluates the resumed run
        with timed(walls, "resume"):
            run, resume_launches = phase_resume()
        if "inference" in phases:
            with timed(walls, "inference"):
                phase_inference(run)
    if "train_zoo" in phases:
        with timed(walls, "train_zoo"):
            zoo_rot_launches = phase_train_zoo()
    pretrain_rows, pretrain_launches, pretrain_run = [], {}, None
    if "pretrain" in phases:
        with timed(walls, "pretrain"):
            pretrain_launches, pretrain_run = phase_pretrain()
            phase_pretrain_mt()
            phase_pretrain_step()
            pretrain_rows = phase_pretrain_joint(args.reps)
    if "optim" in phases:
        with timed(walls, "optim"):
            phase_optim(args.steps)
    if "arch_zoo" in phases:
        with timed(walls, "arch_zoo"):
            phase_arch_zoo()
    if "host_tier" in phases:
        with timed(walls, "host_tier"):
            phase_host_tier(args.steps)
    par_launches = {}
    if "parallel" in phases:
        with timed(walls, "parallel"):
            par_launches = phase_parallel()
    if "train_parallel" in phases:
        with timed(walls, "train_parallel"):
            phase_train_parallel(args.steps, train_out)
    ppar_launches = {}
    if "pretrain_parallel" in phases:
        with timed(walls, "pretrain_parallel"):
            ppar_launches = phase_pretrain_parallel(pretrain_run)
    profiles = {}
    t0 = time.perf_counter()
    if "profile" in phases:
        for path, tr in (("host", trainer), ("host_fused", fused_trainer),
                         ("device", device_trainer)):
            if tr is not None:
                profiles[path] = phase_profile(tr, steps=3, path=path)
        # the bf16 runs' kernels by name: the bf16-operand variants, and no
        # conversion pass of fp32 operands on the joint's path
        bf16_kernels = {"host": (("StoreRows<__nv_bfloat16>", "joint_fwd_partial"),
                                 ("CastRows<float>",)),
                        "host_fused": (("SoftmaxRows<__nv_bfloat16>", "VjpRows<__nv_bfloat16>"),
                                       ("SoftmaxRows<float>",)),
                        "device": (("StoreRows<__nv_bfloat16>", "rotate_shear"),
                                   ("CastRows<float>",))}
        for path, (tr, out16, out32) in bf16_runs.items():
            prof = phase_profile(tr, steps=3, path=f"{path}_bf16", expect=bf16_kernels[path][0],
                                 forbid=bf16_kernels[path][1])
            prof32 = profiles.get(path, {})
            emit({"phase": "train_bf16_vs_fp32", "path": path,
                  "median_step_ms": [out16["median_step_ms"], out32 and out32["median_step_ms"]],
                  "device_ms_per_step": [prof["device_ms_per_step"],
                                         prof32.get("device_ms_per_step")],
                  "max_memory_allocated_gib": [out16["max_memory_allocated_gib"],
                                               out32 and out32["max_memory_allocated_gib"]],
                  "order": ["bf16", "fp32"]})
        walls["profile"] = time.perf_counter() - t0
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
                    resume_launches=resume_launches.get((r["name"], r["padding"]), 0),
                    parallel_rank_launches_all_joints=par_launches.get("mi_joint"))
               for r in kernel_rows if r["mode"] == "bf16"]
    # the joint at the tile shapes of patch 32 (fp32 operands, the tiled run's)
    summary += [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], vs_library=r["vs_library"],
                     bound_ms_128=r["bound_ms_128"],
                     launches=tiled_launches.get((r["name"], r["padding"]), 0))
                for r in tile_rows if r["mode"] == "bf16"]
    # the bf16-operand variants (Precision.compute_dtype=bfloat16): launches
    # from the train_bf16 runs (host path; the fused ones from its fused run)
    summary += [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], vs_library=r["vs_library"],
                     launches=bf16_launches.get((r["name"], r["padding"]), 0))
                for r in kernel_rows if r["mode"] == "bf16in"]
    summary += [dict(name=f"{r['name']}@B{r['batch']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], l2_warm_ms=r["l2_warm_ms"],
                     launches=rot_launches.get((r["name"], r["batch"]), 0),
                     meanteacher_launches=zoo_rot_launches.get((r["name"], r["batch"]), 0),
                     parallel_rank_launches_all_rotations=par_launches.get("rotate")
                     if r["name"] == "rotate_shear" else None,
                     on_main_path=r["name"] == "rotate_shear")
                for r in rotation_rows]
    summary += [dict(name=f"{r['name']}@{r['tap']}", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], unfused_path_ms=r["unfused_path_ms"],
                     launches=(bf16_fused_launches if r["mode"] == "bf16in" else fused_launches)
                     .get((r["name"], r["padding"]), 0),
                     parallel_rank_launches_all_fused=par_launches.get("mi_fused"))
                for r in fused_rows if r["mode"] in ("bf16", "bf16in")]
    # the joint at the pretrain decoder's shape (p = 0, 200 lanes): launches
    # from the decoder phase of the pretrain run; the library is torch.matmul
    summary += [dict(name=f"{r['name']}@pretrain", **{k: r[k] for k in keys},
                     pct_of_bound=r["pct_of_bound"], vs_library=r["vs_library"],
                     library_fp32_ms=r["library_fp32_ms"],
                     launches=pretrain_launches.get((r["name"], r["padding"]), 0),
                     pretrain_parallel_rank_launches=ppar_launches.get(
                         (r["name"], r["padding"])))
                for r in pretrain_rows]
    emit({"phase": "walls", "seconds": walls, "script_s": time.perf_counter() - start})
    print(nvidia_smi(), flush=True)  # again beside the summary, for readers of the tail
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
