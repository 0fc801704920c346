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
  the logit gradients;
- bf16 logits (the bf16 heads' output; bf16 products): J as bf16 operands;
  the logit gradients come back bf16, each fp32 result rounded once on both
  sides, so an fp32 value within the summation-order difference of a rounding
  midpoint rounds the other way: each entry may be one bf16 step (of its own
  magnitude) apart, and what is left is held at 2e-4 of the largest entry.
The 256-lane cases (C = 2 x 128, the heads' lane padding of S*K > 128) hold
the same tolerances, with one allowance for J in the bf16 modes: groups of
30-32 lanes hold probabilities up to ~0.5, and a last-bit difference in a
group sum that rounds one such probability to the neighbouring bf16 value on
one side moves a J entry by one bf16 step of it times its partner, so J is
held at 2e-4 of its largest entry plus 2^-8 max(p1) max(p2) (one such flip).
Measured over seeds 0-3 (12 cases a mode): J 0.0 in 11 of the 12 bf16-product
cases and 8.1e-4 in one (seed 3, 8 x 32), 4.9e-5 on bf16 logits; the logit
gradients at most 1.8e-4 (bf16 products) and 1.1e-4 beyond one step (bf16
logits); fp32 at most 3.9e-7 relative.
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
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

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
WIDE = 256
BF16_BOUND = 2e-4


def _logits(rng, B, Hp, Wp, sk=SK, lanes=C):
    """Lane-padded logits as LocalClusterHead(emit_logits) produces them."""
    z = np.full((B, Hp, Wp, lanes), np.finfo(np.float32).min, np.float32)
    z[..., :sk] = rng.normal(size=(B, Hp, Wp, sk)).astype(np.float32)
    return z


def _jax(l1, l2, g, pad, dot, band=None, s=S, k=K, dtype=None):
    f = lambda a, b: displaced_joint_softmax_pallas(a, b, pad, s, k, 1.0, band, dot)
    joint, vjp = jax.vjp(f, jnp.asarray(l1, dtype), jnp.asarray(l2, dtype))
    d1, d2 = vjp(jnp.asarray(g))
    return [np.asarray(x.astype(jnp.float32)) for x in (joint, d1, d2)]


def _port(l1, l2, g, pad, dot, s=S, k=K, dtype=torch.float32):
    t1 = torch.tensor(l1).to(dtype).requires_grad_(True)
    t2 = torch.tensor(l2).to(dtype).requires_grad_(True)
    joint = mi_fused.displaced_joint_softmax(t1, t2, pad, s, k, 1.0, dot)
    (joint * torch.tensor(g)).sum().backward()
    assert t1.grad.dtype == t2.grad.dtype == dtype
    return [x.detach().float().numpy() for x in (joint, t1.grad, t2.grad)]


def _cotangent(rng, pad, lanes=C):
    t = 2 * pad + 1
    return rng.normal(size=(t, t, lanes, lanes)).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel_err_bf16(got, want):
    """_rel_err of bf16 results beyond one bf16 step of each entry's own
    magnitude (its single rounding)."""
    with np.errstate(divide="ignore"):
        step = np.exp2(np.floor(np.log2(np.abs(want))) - 7)
    excess = np.clip(np.abs(got - want) - step, 0.0, None)
    return float(excess.max() / np.abs(want).max())


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


# C = 256 (two 128-lane blocks), each in fp32 and bf16 products on fp32
# logits and in bf16 products on bf16 logits: (S, K, far)
WIDE_CASES = {
    # 5 x 30 = 150 live lanes: group 4 covers lanes 120-149, across lane 128
    "straddle": (5, 30, False),
    # 8 x 32 = 256: no dead lane
    "dense": (8, 32, False),
    # 5 x 30, l1's lanes 128-149 200 logit units up: every row's max lies in
    # block 1, and groups 0-3 (block 0) and lanes 120-127 underflow to zeros
    "max_in_block_1": (5, 30, True),
}
WIDE_MODES = {"fp32": (torch.float32, "fp32"), "bf16": (torch.float32, "bf16"),
              "bf16_logits": (torch.bfloat16, "bf16")}


@pytest.mark.parametrize("case", list(WIDE_CASES))
@pytest.mark.parametrize("mode", list(WIDE_MODES))
def test_matches_pallas_at_256_lanes(rng, case, mode):
    s, k, far = WIDE_CASES[case]
    logit_dtype, dot = WIDE_MODES[mode]
    l1 = _logits(rng, 1, 12, 12, s * k, WIDE)
    l2 = _logits(rng, 1, 12, 12, s * k, WIDE)
    if far:
        l1[..., C:s * k] += 200.0
    g = _cotangent(rng, 1, WIDE)
    jdtype = jnp.bfloat16 if logit_dtype == torch.bfloat16 else jnp.float32
    want = _jax(l1, l2, g, 1, DTYPES[dot][1], s=s, k=k, dtype=jdtype)
    got = _port(l1, l2, g, 1, DTYPES[dot][0], s=s, k=k, dtype=logit_dtype)
    p_max = [float(mi_fused.group_softmax_rowmax(torch.tensor(x).reshape(-1, WIDE), s, k)
                   .max()) for x in (l1, l2)]
    for name, w, v in zip(("joint", "dl1", "dl2"), want, got):
        assert v.shape == w.shape, name
        if mode == "fp32":
            atol = 0.0 if name == "joint" else 1e-5 * np.abs(w).max()
            np.testing.assert_allclose(v, w, rtol=1e-4, atol=atol, err_msg=name)
        elif name == "joint":
            flip = 2.0 ** -8 * p_max[0] * p_max[1] / np.abs(w).max()
            err = _rel_err(v, w)
            assert err <= BF16_BOUND + flip, f"{name}: {err:.2e} of the largest entry"
        else:
            err = _rel_err_bf16(v, w) if mode == "bf16_logits" else _rel_err(v, w)
            assert err <= BF16_BOUND, f"{name}: {err:.2e} of the largest entry"
    if far:  # no mass and no gradient below lane 120 of l1, on both sides
        for joint, dl1 in ((want[0], want[1]), (got[0], got[1])):
            assert np.abs(joint[:, :, :120, :]).max() == 0.0
            assert np.abs(dl1[..., :120]).max() == 0.0
            assert np.abs(joint[:, :, C:s * k, :]).max() > 0.0


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


def test_fused_logits_loss_matches_jax_at_256_lanes(rng):
    """The loss front door at 5 x 30 clusters (150 live lanes in 256, group 4
    across lane 128), padding 1, at the 128-lane test's tolerances (measured
    over seeds 0-3: the value within 6.0e-6 relative, the logit gradients
    within 4.5e-4 of their largest entry)."""
    s, k, pad = 5, 30, 1
    l1 = _logits(rng, 1, 12, 12, s * k, WIDE)
    l2 = _logits(rng, 1, 12, 12, s * k, WIDE)
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
    for lanes in (64, 192):  # no multiple of 128
        x = torch.zeros((1, 8, 8, lanes))
        with pytest.raises(ValueError, match="128-lane"):
            mi_fused.displaced_joint_softmax(x, x, 1, S, K)
    x = torch.zeros((1, 8, 8, mi_fused.MAX_LANES + C))
    with pytest.raises(ValueError, match="at most"):
        mi_fused.displaced_joint_softmax(x, x, 1, S, K)
    with pytest.raises(ValueError, match="S\\*K"):
        mi_fused.displaced_joint_softmax(torch.zeros((1, 8, 8, WIDE)), torch.zeros(
            (1, 8, 8, WIDE)), 1, 13, 20)
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


@pytest.mark.parametrize("n,wp,padding", [(529_000, 230, 3), (129_960, 114, 1)])
@pytest.mark.parametrize("live", [WIDE, 150])
def test_launch_setup_at_256_lanes(n, wp, padding, live):
    """At C = 256 the plan is the joint's wide plan for the S*K live lanes:
    rows of W = 64 ceil(S*K / 64) lanes (192 at 5 x 30: the quarter past
    S*K is neither stored nor computed), one bf16 copy of W lanes an
    operand, H of the live 128-lane output blocks, the forward's chunk
    partials of W x W, and the backward alone adds the [N, 256] fp32 dq that
    its product writes (the VJP's group sums straddle the blocks)."""
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint

    d = (2 * padding + 1) ** 2
    w = 64 * -(-live // 64)
    for backward in (False, True):
        plan, spec = mi_fused.launch_setup(n, wp, padding, 132, backward, lanes=WIDE, live=live)
        assert plan == mi_joint.wide_plan(n, live, padding, wp, 132)
        assert plan.lanes == w and plan.quarters ** 2 == (9 if live == 150 else 16)
        if backward:
            assert spec == {"s16": ((n, w), torch.bfloat16),
                            "h16": ((2, d, C, w), torch.bfloat16),
                            "dq": ((n, WIDE), torch.float32)}
        else:
            assert spec == {"a16": ((n, w), torch.bfloat16), "b16": ((n, w), torch.bfloat16),
                            "partial": ((plan.fwd_chunks, d, w, w), torch.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,clusters", [(C, 20), (WIDE, 30), (WIDE, 20)])
def test_kernels_match_plain_on_card(lanes, clusters):
    """The CUDA kernels against the plain version on a small canvas (padding
    3, S x K = 5 x 20 in 128 lanes, 5 x 30 in 256, and 5 x 20 in 256: rows
    of two live quarters, one output block): fp32 logits in both
    operand modes, then bf16 logits
    with -inf dead lanes (the bf16 heads' output), 1e-4 of the largest entry,
    except the logit gradients of the bf16 products at 1e-2. There t is
    rounded to bf16 before its group sum, so a last-bit difference in dq
    (another summation order) can move a rounded t by one bf16 step, which
    reaches dl scaled by p; the fp32 mode of the same kernels holds at 1e-4.
    bf16 logits get bf16 gradients, finite, 0 in the dead lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    live = 5 * clusters
    l1, l2 = _logits(rng, 2, 20, 19, live, lanes), _logits(rng, 2, 20, 19, live, lanes)
    g = _cotangent(rng, 3, lanes) * 1e-2
    for dtype, dot in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16)):
        outs = []
        for dev in ("cpu", "cuda"):
            t1 = torch.tensor(l1, device=dev).to(dtype).requires_grad_(True)
            t2 = torch.tensor(l2, device=dev).to(dtype).requires_grad_(True)
            joint = mi_fused.displaced_joint_softmax(t1, t2, 3, 5, clusters, 1.0, dot)
            (joint * torch.tensor(g, device=dev)).sum().backward()
            assert t1.grad.dtype == t2.grad.dtype == dtype
            assert torch.all(t1.grad[..., live:] == 0) and torch.all(t2.grad[..., live:] == 0)
            outs.append([t.detach().float().cpu().numpy() for t in (joint, t1.grad, t2.grad)])
        for i, (want, got) in enumerate(zip(*outs)):
            assert np.isfinite(got).all()
            tol = 1e-2 if i and dot == torch.bfloat16 else 1e-4
            np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,clusters", [(C, 20), (WIDE, 30)])
@pytest.mark.parametrize("rows", ["interior", "top", "bottom", "both"])
def test_kernels_take_l1_window_on_card(lanes, clusters, rows):
    """The kernels with l1's window of live rows (``rows1``, a band's halo'd
    canvas under the H split), forward, dl2 and dl1, in the three operand
    modes of ``test_kernels_match_plain_on_card``. The interior window is
    the unsplit call: bit for bit the output with no window. A window open
    at the top, the bottom or both is held against the plain version with
    the same window at ``chip_smoke.py``'s kernel tolerances: 5e-4 of the
    largest entry, the bf16 products' logit gradients 1e-2 (the reason is
    in ``test_kernels_match_plain_on_card``); fp32 products hold at 1e-4.
    With bf16 products a last-bit difference in a softmax can round one
    probability to the neighbouring bf16 value, which moves a J entry by
    2^-8 p1 p2: on an H100 1-2 of 802,816 J entries at 128 lanes sat
    1.06e-4 of the largest entry off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(1)
    p, hp, wp, s = 3, 20, 19, 5
    live = s * clusters
    window = {"interior": (p, hp - p), "top": (0, hp - p), "bottom": (p, hp),
              "both": (0, hp)}[rows]
    l1, l2 = (_logits(rng, 2, hp, wp, live, lanes).reshape(-1, lanes) for _ in range(2))
    g = _cotangent(rng, p, lanes).reshape(-1, lanes, lanes) * 1e-2
    args = (hp, wp, p, s, clusters, 1.0)
    for dtype, bf16 in ((torch.float32, False), (torch.float32, True), (torch.bfloat16, True)):
        def run(dev, **kw):
            a, b = (torch.tensor(t, device=dev).to(dtype) for t in (l1, l2))
            gt = torch.tensor(g, device=dev)
            if dev == "cpu":
                dot = torch.bfloat16 if bf16 else torch.float32
                return [mi_fused.fused_fwd_plain(a, b, *args, dot, **kw),
                        *mi_fused.fused_bwd_plain(a, b, gt, *args, dot, **kw)]
            return [mi_fused.mi_fused_fwd(a, b, *args, bf16=bf16, **kw),
                    mi_fused.mi_fused_bwd(b, a, gt, *args, transpose_g=True, bf16=bf16, **kw),
                    mi_fused.mi_fused_bwd(a, b, gt, *args, transpose_g=False, bf16=bf16, **kw)]
        got = run("cuda", rows1=window)
        if rows == "interior":
            for a, b in zip(got, run("cuda")):
                assert torch.equal(a, b)
            continue
        for i, (want, out) in enumerate(zip(run("cpu", rows1=window), got)):
            want, out = want.float().numpy(), out.float().cpu().numpy()
            assert np.isfinite(out).all()
            tol = (1e-2 if i else 5e-4) if bf16 else 1e-4
            np.testing.assert_allclose(out, want, rtol=0, atol=tol * np.abs(want).max(),
                                       err_msg=f"{dtype} logits, bf16 products {bf16}, out {i}")
