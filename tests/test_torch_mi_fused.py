"""The port's fused softmax + mask + joint (plain version of the CUDA kernels)
against the JAX package's ``displaced_joint_softmax_pallas`` in interpret mode.

Inputs are built from a numpy seed as ``tests/test_mi_fused.py`` builds them
(live lanes normal, dead lanes at float32 min) and go to both sides as the
same arrays. Tolerances, each with its reason:
- fp32 operands: J at rtol 1e-4, the logit gradients at rtol 1e-4 with an
  absolute floor of 1e-5 of their largest entry (both sides compute the same
  fp32 arithmetic in other summation orders; the softmax VJP t - p * s
  cancels to near zero in places, where only the floor is meaningful);
- bf16 operands: the largest error over the largest entry, at most 2e-4.
  Both sides round the same values at the same points, but a last-bit
  difference in an exp or a sum can move a value across a bf16 rounding
  boundary. Measured over seeds 0-3 of these cases: 7.2e-5 for J, 2.0e-7 for
  the logit gradients.
"""

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import group_softmax_flat
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_fused
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic_local import (
    iid_segmentation_loss_fused_logits,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.mi_joint import (
    displaced_joint_plain_flat,
)

try:  # the JAX side; a card's machine without JAX runs only the cuda-marked test
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
        iid_segmentation_loss_fused_logits as jax_loss_fused_logits,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_fused import (
        displaced_joint_softmax_pallas,
    )
    DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
except ImportError:
    jax = jnp = jax_loss_fused_logits = displaced_joint_softmax_pallas = None
    DTYPES = {"fp32": (torch.float32, None), "bf16": (torch.bfloat16, None)}

S, K = 2, 3
SK = S * K
C = 128
BF16_BOUND = 2e-4


def _logits(rng, B, Hp, Wp, sk=SK):
    """Lane-padded logits as LocalClusterHead(emit_logits) produces them."""
    z = np.full((B, Hp, Wp, C), np.finfo(np.float32).min, np.float32)
    z[..., :sk] = rng.normal(size=(B, Hp, Wp, sk)).astype(np.float32)
    return z


def _jax(l1, l2, g, pad, dot, band=None, s=S, k=K):
    f = lambda a, b: displaced_joint_softmax_pallas(a, b, pad, s, k, 1.0, band, dot)
    joint, vjp = jax.vjp(f, jnp.asarray(l1), jnp.asarray(l2))
    d1, d2 = vjp(jnp.asarray(g))
    return [np.asarray(x) for x in (joint, d1, d2)]


def _port(l1, l2, g, pad, dot, s=S, k=K):
    t1 = torch.tensor(l1, requires_grad=True)
    t2 = torch.tensor(l2, requires_grad=True)
    joint = mi_fused.displaced_joint_softmax(t1, t2, pad, s, k, 1.0, dot)
    (joint * torch.tensor(g)).sum().backward()
    return [x.detach().numpy() for x in (joint, t1.grad, t2.grad)]


def _cotangent(rng, pad):
    t = 2 * pad + 1
    return rng.normal(size=(t, t, C, C)).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# pad 1 and 2 as tests/test_mi_fused.py, both operand modes, and a canvas whose
# rows cross several of the JAX kernel's 40-row bands
@pytest.mark.parametrize("pad,shape,band,mode", [
    (1, (2, 11, 10), None, "fp32"),
    (2, (2, 13, 12), None, "fp32"),
    (1, (1, 20, 11), 40, "fp32"),
    (1, (2, 11, 10), None, "bf16"),
    (2, (2, 13, 12), None, "bf16"),
    (1, (1, 20, 11), 40, "bf16"),
])
def test_matches_pallas_values_and_logit_grads(rng, pad, shape, band, mode):
    l1, l2 = _logits(rng, *shape), _logits(rng, *shape)
    g = _cotangent(rng, pad)
    tdot, jdot = DTYPES[mode]
    want = _jax(l1, l2, g, pad, jdot, band)
    got = _port(l1, l2, g, pad, tdot)
    for name, w, v in zip(("joint", "dl1", "dl2"), want, got):
        assert v.shape == w.shape, name
        if mode == "fp32":
            atol = 0.0 if name == "joint" else 1e-5 * np.abs(w).max()
            np.testing.assert_allclose(v, w, rtol=1e-4, atol=atol, err_msg=name)
        else:
            err = _rel_err(v, w)
            assert err <= BF16_BOUND, f"{name}: {err:.2e} of the largest entry"


def test_dead_lanes_give_exact_zeros(rng):
    l1, l2 = _logits(rng, 2, 11, 10), _logits(rng, 2, 11, 10)
    for mode in ("fp32", "bf16"):
        joint, dl1, dl2 = _port(l1, l2, _cotangent(rng, 1), 1, DTYPES[mode][0])
        assert np.abs(joint[:, :, SK:, :]).max() == 0.0
        assert np.abs(joint[:, :, :, SK:]).max() == 0.0
        assert np.abs(dl1[..., SK:]).max() == 0.0 and np.abs(dl2[..., SK:]).max() == 0.0
        assert np.abs(joint[:, :, :SK, :SK]).min() > 0.0


def test_group_far_below_the_row_max_has_zero_probability(rng):
    """The softmax takes the max over the whole row, so a group 200 logit
    units below another underflows to exact zeros, on both sides; the
    per-group softmax of the unfused path would not."""
    l1, l2 = _logits(rng, 2, 11, 10), _logits(rng, 2, 11, 10)
    l1[..., K:SK] += 200.0  # group 1 of l1 far above group 0, in every row
    g = _cotangent(rng, 1)
    want = _jax(l1, l2, g, 1, jnp.float32)
    got = _port(l1, l2, g, 1, torch.float32)
    assert np.abs(got[0][:, :, :K, :]).max() == 0.0  # group 0 of l1: no mass
    assert np.abs(want[0][:, :, :K, :]).max() == 0.0
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    assert np.abs(got[1][..., :K]).max() == 0.0  # and no gradient
    per_group = group_softmax_flat(torch.tensor(l1), S, K)
    assert float(per_group[..., :K].min()) > 0.0


def test_plain_backward_equals_autograd_of_the_composed_reference(rng):
    """fp32: the written-out backward against autograd through the row-max
    group softmax, the interior mask and displaced_joint_plain_flat (the same
    arithmetic in another order: rtol 1e-5, floor 1e-6 of the largest)."""
    pad, B, hp, wp = 2, 2, 12, 11
    l1, l2 = _logits(rng, B, hp, wp), _logits(rng, B, hp, wp)
    g = torch.tensor(_cotangent(rng, pad)).reshape(-1, C, C)
    t1 = torch.tensor(l1.reshape(-1, C), requires_grad=True)
    t2 = torch.tensor(l2.reshape(-1, C), requires_grad=True)
    valid = mi_fused.row_valid(t1.shape[0], hp, wp, pad)

    def probs(t):
        z = torch.where(torch.arange(C) < SK, t, float("-inf"))
        e = torch.exp(z - z.max(-1, keepdim=True).values)
        den = e[:, :SK].reshape(-1, S, K).sum(-1, keepdim=True).expand(-1, S, K)
        return torch.nn.functional.pad(e[:, :SK] / (den.reshape(-1, SK) + 1e-16),
                                       (0, C - SK)) * valid

    ref = displaced_joint_plain_flat(probs(t1), probs(t2), wp, pad)
    ref_d1, ref_d2 = torch.autograd.grad(ref, (t1, t2), g)
    got = mi_fused.fused_fwd_plain(t1.detach(), t2.detach(), hp, wp, pad, S, K, 1.0,
                                   torch.float32)
    got_d1, got_d2 = mi_fused.fused_bwd_plain(t1.detach(), t2.detach(), g, hp, wp, pad, S, K,
                                              1.0, torch.float32)
    torch.testing.assert_close(got, ref.detach(), rtol=1e-5, atol=0.0)
    for name, v, w in (("dl1", got_d1, ref_d1), ("dl2", got_d2, ref_d2)):
        torch.testing.assert_close(v, w, rtol=1e-5, atol=1e-6 * float(w.abs().max()), msg=name)


def test_fused_logits_loss_matches_jax(rng):
    """The loss front door with the headline numerics (bf16 operands, T = 1):
    S=3 subheads of K=4 in 128 lanes, padding 2. The value at rtol 1e-5
    (measured 1.4e-6 over seeds 0-3). The logit gradients within 2e-3 of their
    largest entry (measured 6.7e-4): dL/dJ comes from joints that differ by
    up to 7e-5, and its rounding to bf16 then lands a few entries one bf16
    step apart."""
    s, k, pad = 3, 4, 2
    l1 = _logits(rng, 2, 12, 11, s * k)
    l2 = _logits(rng, 2, 12, 11, s * k)
    want, jgrads = jax.value_and_grad(
        lambda a, b: jax_loss_fused_logits(a, b, s, k, pad), argnums=(0, 1))(
            jnp.asarray(l1), jnp.asarray(l2))
    t1 = torch.tensor(l1, requires_grad=True)
    t2 = torch.tensor(l2, requires_grad=True)
    loss = iid_segmentation_loss_fused_logits(t1, t2, s, k, pad)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    for v, w in ((t1.grad, jgrads[0]), (t2.grad, jgrads[1])):
        assert _rel_err(v.numpy(), np.asarray(w)) <= 2e-3


def test_front_door_checks_before_any_kernel():
    x = torch.zeros((1, 8, 8, 64))
    with pytest.raises(ValueError, match="128-lane"):
        mi_fused.displaced_joint_softmax(x, x, 1, S, K)
    y = torch.zeros((1, 8, 8, C))
    with pytest.raises(ValueError, match="dot_dtype"):
        mi_fused.displaced_joint_softmax(y, y, 1, S, K, dot_dtype=torch.float16)
    with pytest.raises(ValueError, match="S\\*K"):
        mi_fused.displaced_joint_softmax(y, y, 1, 13, 10)
    with pytest.raises(ValueError, match="canvases"):
        mi_fused.displaced_joint_softmax(y, y, 4, S, K)
    with pytest.raises(ValueError, match="CUDA"):
        mi_fused.mi_fused_fwd(y.reshape(-1, C), y.reshape(-1, C), 8, 8, 1, S, K)


@pytest.mark.parametrize("n,wp,padding", [(529_000, 230, 3), (129_960, 114, 1)])
def test_launch_setup_is_the_joints_plan_and_scratch(n, wp, padding):
    """At both decoder taps the bf16 fused kernels take the joint's launch
    plan, and their scratch holds the masked probabilities as two [N, 128]
    bf16 buffers (forward) or one (backward, beside g as H): no fp32
    probability or dq buffer of N rows."""
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint

    for backward in (False, True):
        plan, spec = mi_fused.launch_setup(n, wp, padding, 132, backward)
        assert plan == mi_joint.launch_plan(n, C, padding, wp, 132)
        assert spec == mi_joint.bf16_scratch(plan, backward)
        rows = [dtype for shape, dtype in spec.values() if shape[0] == n]
        assert rows == [torch.bfloat16] * (1 if backward else 2)
        assert all(shape[1:] == (C,) for shape, _ in spec.values() if shape[0] == n)


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    """The CUDA kernels against the plain version on a small canvas (padding
    3, S x K = 5 x 20): fp32 logits in both operand modes, then bf16 logits
    with -inf dead lanes (the bf16 heads' output), 1e-4 of the largest entry,
    except the logit gradients of the bf16 products at 1e-2. There t is
    rounded to bf16 before its group sum, so a last-bit difference in dq
    (another summation order) can move a rounded t by one bf16 step, which
    reaches dl scaled by p; the fp32 mode of the same kernels holds at 1e-4.
    bf16 logits get bf16 gradients, finite, 0 in the dead lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    l1, l2 = _logits(rng, 2, 20, 19, 100), _logits(rng, 2, 20, 19, 100)
    g = _cotangent(rng, 3) * 1e-2
    for dtype, dot in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16)):
        outs = []
        for dev in ("cpu", "cuda"):
            t1 = torch.tensor(l1, device=dev).to(dtype).requires_grad_(True)
            t2 = torch.tensor(l2, device=dev).to(dtype).requires_grad_(True)
            joint = mi_fused.displaced_joint_softmax(t1, t2, 3, 5, 20, 1.0, dot)
            (joint * torch.tensor(g, device=dev)).sum().backward()
            assert t1.grad.dtype == t2.grad.dtype == dtype
            assert torch.all(t1.grad[..., 100:] == 0) and torch.all(t2.grad[..., 100:] == 0)
            outs.append([t.detach().float().cpu().numpy() for t in (joint, t1.grad, t2.grad)])
        for i, (want, got) in enumerate(zip(*outs)):
            assert np.isfinite(got).all()
            tol = 1e-2 if i and dot == torch.bfloat16 else 1e-4
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())
