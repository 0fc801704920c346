"""The port's displaced-MI joint (plain version of the CUDA kernel) against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go to both sides as the same
arrays. Tolerances: fp32 operands rtol 1e-4 / atol 1e-5 for values and both
gradients (those of tests/test_pallas_mi.py: summation order only); bf16
operands the same, since both sides round the same operands (and the
cotangent) to bf16 and sum exact products in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
    iid_segmentation_small_patch_loss_flat as jax_loss_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_joint import (
    displaced_joint_pallas,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic_local import (
    displaced_joint_plain,
    iid_segmentation_small_patch_loss_flat,
)

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _maps(rng, shape, live=None, padding=0):
    """Softmax-like maps [B, H, W, C]; lanes from ``live`` on are dead (0);
    with ``padding`` a zero border of that width (a pre-padded canvas)."""
    c = shape[-1]
    live = live or c
    z = rng.normal(size=shape[:-1] + (live,))
    e = np.exp(z - z.max(-1, keepdims=True))
    x = np.zeros(shape, np.float32)
    x[..., :live] = e / e.sum(-1, keepdims=True)
    if padding:
        x[:, :padding] = x[:, -padding:] = 0
        x[:, :, :padding] = x[:, :, -padding:] = 0
    return x


def _jax_joint_and_grads(x, y, g, padding, dot, pre_padded):
    f = lambda a, b: displaced_joint_pallas(a, b, padding, None, dot, pre_padded)
    joint, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(y))
    ga, gb = vjp(jnp.asarray(g))
    return np.asarray(joint), np.asarray(ga), np.asarray(gb)


def _torch_joint_and_grads(x, y, g, padding, dot, pre_padded):
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    joint = mi_joint.displaced_joint(tx, ty, padding, dot, pre_padded)
    (joint * torch.tensor(g)).sum().backward()
    return joint.detach().numpy(), tx.grad.numpy(), ty.grad.numpy()


# every padding, both canvas forms, both lane layouts and both operand modes,
# each value in at least two cases (interpret-mode Pallas takes seconds a case)
@pytest.mark.parametrize("padding,pre_padded,lanes,mode", [
    (1, False, "c6", "fp32"),
    (2, True, "c128_dead", "fp32"),
    (3, False, "c128_dead", "bf16"),
    (1, True, "c6", "bf16"),
    (3, True, "c6", "fp32"),
    (2, False, "c6", "bf16"),
])
def test_joint_matches_pallas_values_and_grads(rng, padding, pre_padded, lanes, mode):
    c, live = (6, 6) if lanes == "c6" else (128, 20)
    edge = 2 * padding if pre_padded else 0
    shape = (2, 9 + edge, 8 + edge, c)
    x = _maps(rng, shape, live, padding if pre_padded else 0)
    y = _maps(rng, shape, live, padding if pre_padded else 0)
    t = 2 * padding + 1
    g = rng.normal(size=(t, t, c, c)).astype(np.float32)
    tdot, jdot = DTYPES[mode]
    want = _jax_joint_and_grads(x, y, g, padding, jdot, pre_padded)
    got = _torch_joint_and_grads(x, y, g, padding, tdot, pre_padded)
    for name, w, v in zip(("joint", "dx", "dx_tf"), want, got):
        assert v.shape == w.shape, name
        np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("padding", [1, 3])
def test_plain_per_displacement_matches_flat_form(rng, padding):
    """displaced_joint_plain (sliced, fp32) == the flat-offset form."""
    x = _maps(rng, (2, 11, 10, 5))
    y = _maps(rng, (2, 11, 10, 5))
    flat = mi_joint.displaced_joint(torch.tensor(x), torch.tensor(y), padding, torch.float32)
    sliced = displaced_joint_plain(torch.tensor(x), torch.tensor(y), padding)
    np.testing.assert_allclose(sliced.numpy(), flat.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ours,theirs,rtol", [
    ("plain", "xla", 1e-4),     # fp32 both sides
    ("auto", "pallas", 1e-4),   # bf16 operands both sides
    ("auto", "xla", 5e-3),      # bf16 against fp32 (tests/test_pallas_mi.py:105-107)
])
def test_flat_loss_matches_jax(rng, ours, theirs, rtol):
    """The pre-padded flat front door of the training path: S=3 subheads of
    K=4 clusters in 128 lanes, padding 2, one full-map tile."""
    S, K, p = 3, 4, 2
    x = _maps(rng, (2, 10 + 2 * p, 9 + 2 * p, 128), S * K, p)
    y = _maps(rng, (2, 10 + 2 * p, 9 + 2 * p, 128), S * K, p)
    want = float(jax_loss_flat(jnp.asarray(x), jnp.asarray(y), S, K, p, 1024,
                               backend=theirs, pre_padded=True))
    got = float(iid_segmentation_small_patch_loss_flat(
        torch.tensor(x), torch.tensor(y), S, K, p, 1024, backend=ours, pre_padded=True))
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_flat_loss_unported_paths_raise(rng):
    x = torch.tensor(_maps(rng, (1, 12, 12, 128), 20, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        iid_segmentation_small_patch_loss_flat(x, x, 2, 10, 1, 4, pre_padded=True)
    with pytest.raises(ValueError, match="unknown backend 'pallas_fused'"):
        iid_segmentation_small_patch_loss_flat(x, x, 2, 10, 1, 1024, backend="pallas_fused",
                                               pre_padded=True)


def test_kernel_wrappers_refuse_cpu_and_bad_operands():
    """The launch wrappers take only contiguous fp32 CUDA tensors; they check
    before touching the library, so this runs without a card."""
    a = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mi_joint.mi_joint_fwd(a, a, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        mi_joint.mi_joint_bwd(a, torch.zeros((9, 8, 8)), 8, 1, transpose_g=True)
    with pytest.raises(ValueError, match="dot_dtype"):
        mi_joint.displaced_joint_flat(a, a, 8, 1, torch.float16)


@pytest.mark.parametrize("n,padding", [(529_000, 3), (129_960, 1), (300, 1)])
def test_forward_chunking_covers_rows(n, padding):
    rows, chunks = mi_joint.fwd_chunking(n, 128, padding, sm_count=132)
    assert rows % 32 == 0
    assert (chunks - 1) * rows < n <= chunks * rows


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(rng):
    """The CUDA kernel against its plain version, both operand modes, on a
    small pre-padded canvas (C = 128, padding 3); rtol 1e-4 of max |ref|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    x = _maps(rng, (2, 20, 19, 128), 100, 3)
    y = _maps(rng, (2, 20, 19, 128), 100, 3)
    g = torch.tensor(rng.normal(size=(7, 7, 128, 128)).astype(np.float32))
    for dot in (torch.float32, torch.bfloat16):
        outs = []
        for dev in ("cpu", "cuda"):
            tx = torch.tensor(x, device=dev, requires_grad=True)
            ty = torch.tensor(y, device=dev, requires_grad=True)
            joint = mi_joint.displaced_joint(tx, ty, 3, dot, pre_padded=True)
            (joint * g.to(dev)).sum().backward()
            outs.append([t.detach().cpu().numpy() for t in (joint, tx.grad, ty.grad)])
        for want, got in zip(*outs):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
