#!/usr/bin/env python3
"""Which ``decay ** t`` the optax chains' bias corrections take, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_pow_rounding.py

For each decay the chains use (0.9, 0.99, 0.999, and NovoGrad's 0.25) and
t = 1..20000, compares three fp32 values of ``decay ** t``: the port's
(``engine/optim.py:_pow``: the fp32 decay raised in float64 and rounded
once), numpy's fp32 power (what the port computed on the host before its
chains were built for a CUDA graph) and XLA:CPU's, as optax computes it
(``decay ** count`` on an int32 count inside ``jax.jit``). Also RAdam's
rho_t at b2 = 0.999 around its switch at 5, in float64 and from the port's
fp32 scalars. Prints one JSON line: per decay, the number of t where each
pair differs and the first such t.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (  # noqa: E402
    RAdam,
    _pow,
)

T = 20_000
DECAYS = (0.9, 0.99, 0.999, 0.25)


def _pairs(port, numpy, xla, t):
    out = {}
    for name, a, b in (("port_vs_numpy", port, numpy), ("port_vs_xla", port, xla),
                       ("numpy_vs_xla", numpy, xla)):
        differ = a != b
        out[name] = {"differ": int(differ.sum()),
                     "first_t": int(t[differ][0]) if differ.any() else None}
    return out


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    t = np.arange(1, T + 1)
    rows = {}
    for decay in DECAYS:
        port = _pow(decay, torch.from_numpy(t.astype(np.float32))).numpy()
        numpy = np.float32(decay) ** t.astype(np.float32)
        xla = np.asarray(jax.jit(lambda c, d=decay: d ** c)(jnp.asarray(t, jnp.int32)))
        rows[str(decay)] = _pairs(port, numpy, xla, t)
    p = [torch.nn.Parameter(torch.zeros(1))]
    radam = RAdam(p, 1e-3)
    group = radam.param_groups[0]
    rho_inf = 2 / (1 - 0.999) - 1
    rho = {}
    for step in range(3, 9):
        s = radam._scalars(group, torch.tensor(float(step)), torch.tensor(1e-3))
        b2t = 0.999 ** step
        rho[step] = {"rho_float64": rho_inf - 2 * step * b2t / (1 - b2t),
                     "rectified": bool(s["rectified"]), "r": float(s["r"])}
    print(json.dumps({"steps": T, "decays": rows, "radam_b2_0.999": rho}))


if __name__ == "__main__":
    main()
