"""Time design alternatives of the port's rotation kernels on the card.

Builds ``scripts/torch_rotate_variants.cu`` (the roll with 1-8 rows a block,
staged by a bulk copy or loaded directly; the rotation with each tile's
source staged in shared memory) and times each beside the shipped kernel
(``ops/rotate.py``) and a device copy of the same bytes, at the device path's
shapes: the roll on [B, 384, 384] canvases, the rotation of B=4 images with
their labels and of B=10 images alone. Each variant is first held bit-exact
against the plain version. Times are profiler device time per call, in us:
``cold`` on inputs cycled through four times the L2 (``chip_smoke.cold``),
``warm`` on one set of inputs. Prints one JSON line per shape and round, the
card's name and power limit first. Needs one CUDA device and nvcc:

    python3 scripts/torch_rotate_variants.py [--rounds 2]
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_rotate_variants: no CUDA device", file=sys.stderr)
        return 2
    print(cs.nvidia_smi(), flush=True)
    out_dir = ROOT / "build" / "torch_kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "librotate_variants.so"
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                    str(ROOT / "scripts" / "torch_rotate_variants.cu")], check=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.roll_var.argtypes = [i, vp, vp, vp, i, i, i, vp]
    lib.rot_staged_f32.argtypes = [vp] * 5 + [i] * 7 + [vp]
    rot = cs.port("ops.rotate")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def times(fn, operands):
        cold = cs.device_ms(cs.cold(fn, *operands), 20) * 1e3
        warm = cs.device_ms(lambda: fn(*operands), 20) * 1e3
        return {"cold_us": cold, "warm_us": warm}

    for rnd in range(args.rounds):
        for batch in (4, 10):
            c = torch.randn(batch, 384, 384, generator=gen, device="cuda")
            s = torch.randint(-400, 400, (batch, 384), generator=gen, device="cuda",
                              dtype=torch.int32)
            want = rot.lane_roll_rows_plain(c, s)
            row = {"kernel": "lane_roll_rows", "round": rnd, "shape": list(c.shape),
                   "shipped": times(rot.lane_roll_rows, (c, s)),
                   "device copy": times(lambda c, s: c.clone(), (c, s))}
            for v in range(8):
                def roll(c, s, v=v):
                    o = torch.empty_like(c)
                    rc = lib.roll_var(v, c.data_ptr(), s.data_ptr(), o.data_ptr(), batch, 384,
                                      384, stream())
                    cs.check(rc == 0, f"roll variant {v}: CUDA error {rc}")
                    return o
                cs.check(torch.equal(roll(c, s), want), f"roll variant {v} differs")
                row[f"{'bulk' if v < 4 else 'direct'} {1 << (v & 3)} rows a block"] = times(
                    roll, (c, s))
            print(json.dumps(row), flush=True)
        for batch, pair in ((4, True), (10, False)):
            x = torch.randint(0, 256, (batch, 256, 256), generator=gen, device="cuda").float()
            lab = torch.randint(0, 4, (batch, 256, 256), generator=gen, device="cuda",
                                dtype=torch.int32)
            ang = torch.rand(batch, generator=gen, device="cuda") * 90.0 - 45.0
            py, px, hc, wc = rot.canvas(256, 256, 45.0, False)
            operands = (x, ang, lab) if pair else (x, ang)

            def shipped(x, a, lab=None):
                return rot.rotate_shear(x, a, labels=lab)

            def staged(x, a, lab=None):
                oi = torch.empty_like(x)
                ol = None if lab is None else torch.empty_like(lab)
                rc = lib.rot_staged_f32(x.data_ptr(), None if lab is None else lab.data_ptr(),
                                        a.data_ptr(), oi.data_ptr(),
                                        None if ol is None else ol.data_ptr(), batch, 256, 256,
                                        py, px, hc, wc, stream())
                cs.check(rc == 0, f"staged rotation: CUDA error {rc}")
                return oi if lab is None else (oi, ol)

            got, want = staged(*operands), shipped(*operands)
            cs.check(all(torch.equal(g, w) for g, w in zip(got, want)) if pair
                     else torch.equal(got, want), "staged rotation differs")
            planes = torch.stack([x, lab.view(torch.float32)][:2 if pair else 1])
            print(json.dumps({"kernel": "rotate_shear", "round": rnd, "shape": list(x.shape),
                              "labels": pair, "shipped": times(shipped, operands),
                              "source staged in shared memory": times(staged, operands),
                              "device copy": times(lambda p: p.clone(), (planes,))}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
