#!/usr/bin/env python3
"""Where a call of the joint's wrappers spends its time on a CUDA card: the
host (Python, the allocator, ctypes, the launch) against the device.

    python scripts/torch_joint_host_cost.py [--reps 200]

For the joint at the pretrain decoder's shape ([150528, 200] fp32 at
padding 0: one launch a product over all lanes) and for the grouped joint
on the 36 tile pieces of Up_conv3 at patch 32, and for torch.matmul on bf16
casts beside the p = 0 products, prints one JSON line each: the host's
milliseconds a call (calls issued back to back, no synchronisation inside),
one call's milliseconds between CUDA events (the card idle before it, so
the host's part before the launch counts), and the device milliseconds a
call (torch.profiler). Then a cProfile of the p = 0 backward wrapper: the
functions that take the most of its host time. Needs a card; the kernels
are built from the checkout at first use.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import (  # noqa: E402
    iic_local,
    mi_joint,
)


def event_ms(fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def device_ms(fn, reps: int) -> float:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / reps


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--reps", type=int, default=200)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, c = 12 * 112 * 112, 200
    a, b = (torch.rand((n, c), generator=gen, device="cuda") for _ in range(2))
    g = torch.randn((1, c, c), generator=gen, device="cuda") * 1e-3
    bf = lambda t: t.to(torch.bfloat16)
    calls = {
        "p0 fwd": lambda: mi_joint.mi_joint_fwd(a, b, 112, 0),
        "p0 dx": lambda: mi_joint.mi_joint_bwd(b, g, 112, 0, True),
        "p0 dx_tf": lambda: mi_joint.mi_joint_bwd(a, g, 112, 0, False),
        "matmul fwd": lambda: torch.matmul(bf(a).T, bf(b)),
        "matmul dx": lambda: torch.matmul(bf(b), bf(g[0]).T),
        "matmul dx_tf": lambda: torch.matmul(bf(a), bf(g[0])),
    }
    # the grouped joint on Up_conv3's tiles of patch 32 (pre-padded [10, 114, 114])
    p, edge = 1, 112
    x = torch.rand((10, edge + 2 * p, edge + 2 * p, 100), generator=gen, device="cuda")
    plan = iic_local._piece_plan(edge + 2 * p, edge + 2 * p, edge, edge, 32, p, (0, edge), p,
                                 x.device)
    order = iic_local._batch_order(plan, 10)
    flat = iic_local._gather_pieces(x, plan.x_index, plan.x_dead, order).contiguous()
    pieces = plan.pieces(10)
    gp = torch.randn((len(pieces), 9, 100, 100), generator=gen, device="cuda") * 1e-3
    calls["tiles fwd"] = lambda: mi_joint.mi_joint_fwd_pieces(flat, flat, pieces, p)
    calls["tiles dx"] = lambda: mi_joint.mi_joint_bwd_pieces(flat, gp, pieces, p, True)
    smi = torch.cuda.get_device_name(0)
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        print(json.dumps({"call": name, "device": smi, "host_ms": host_ms(fn, args.reps),
                          "event_ms": event_ms(fn, 20), "device_ms": device_ms(fn, 20)}),
              flush=True)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(args.reps):
        calls["p0 dx"]()
    prof.disable()
    torch.cuda.synchronize()
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(20)
    print(out.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
