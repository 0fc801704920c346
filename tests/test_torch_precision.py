"""bf16 compute (``Precision.compute_dtype`` / ``bn_dtype``), ``Arch.remat``
and ``Arch.stem=s2d`` of the port against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and go to both sides as the same
arrays; weights are the JAX package's, mapped by ``weights.py``. What each
test holds, and why at that tolerance:

- The bf16 group softmax (the probability heads' rounding points) within 1
  bf16 ulp of JAX's, dead lanes exactly 0: both sides round the same values
  at the same points, but an exp or an fp32 group sum may differ in its last
  fp32 bit, which moves a value across a bf16 rounding boundary now and then.
- The bf16 logits head bit-equal to JAX's on dyadic inputs (every product and
  sum exact), dead lanes -inf (``jnp.pad`` rounds float32 min to -inf in
  bf16); within 1 ulp on random inputs.
- The U-Net's logits and taps, with their dtypes, for (bf16, fp32 BN) and
  (bf16, bf16 BN). Eval mode (running statistics): relative L2 error 1e-3
  (measured 8.7e-5; the taps through Up_conv4 bit-equal in bf16: the same
  rounding points; an fp32 summation-order difference in a convolution flips
  ~5e-5 of its bf16 outputs by one ulp). Train mode (batch statistics): the
  statistics are fp32 sums of bf16 values taken in another order (XLA's fast
  variance, PyTorch's own), a relative shift of ~1e-6 that flips ~0.04% of a
  BN layer's bf16 outputs by one ulp, and train-mode BN on a random-init net
  amplifies such flips layer by layer. So the port's distance from the JAX
  bf16 model is held below 0.75 of the JAX bf16 model's own distance from the
  JAX fp32 model (measured 0.5-0.6 on the outputs, 0.35-0.4 on the running
  statistics): a dtype that the port ignored would sit at 1.0. The first BN
  layer's running statistics, whose input is the same on both sides, at the
  existing rtol 1e-4 (statistics taken in bf16 would be off by ~2^-9).
- The joint and fused plain versions on bf16 operands against the JAX Pallas
  kernels in interpret mode: J at rtol 1e-4 (the fp32 sums of the same exact
  products, another order), the bf16 gradients within 1 bf16 ulp (the fp32
  sums rounded once on both sides) beside an absolute floor of 1e-5 of the
  largest entry (where a sum cancels to near 0, its summation order moves it
  by more than a bf16 step of so small a value). At 256 lanes the tiled
  backward is checked to round once, on integer inputs whose fp32 sums are
  exact.
- One bf16 step (udaiic on both data paths, the fused logits branch,
  meanteacher) against the JAX bf16 step, which is compiled with XLA's
  ``xla_allow_excess_precision`` off: by default XLA may keep a jitted
  computation's bf16 intermediates in fp32, which no eager op sequence can
  copy; off, each op rounds to the dtype flax gives it, as the port's ops do.
  The losses at rtol 2e-2 (the model's train-mode bf16 outputs differ by the
  flips above, ~5% relative L2 at the logits of this tiny random net, which
  the losses average; measured <= 3.1e-3), with an absolute floor of 2e-6 for
  the MIs near 0 (2.4e-5 at Conv5: nearly independent cluster maps), the
  first BN layer's running statistics at rtol 1e-4 and every running
  statistic within 0.02 of its tensor's largest entry (measured <= 3.2e-3).
  Liveness: the port's bf16 step moves the BN running statistics closer to
  the JAX bf16 step's than the port's fp32 step does (below 0.75 of its
  distance; measured 0.36; the losses of a near-init net are too flat in the
  logits to tell). The parameters: Adam's first move is about lr times the
  gradient's sign, and this random-init net's bf16 gradients are mostly
  rounding noise in the encoder (the JAX bf16 step's sit 0.73 relative L2
  from its fp32 step's), so two right bf16 steps move some elements opposite
  ways. Held: that share against the JAX bf16 step at 0.2 (measured
  0.103-0.149), below 0.75 of the port's fp32 step's share (measured
  0.60-0.63: a dtype ignored, or a backward that is wrong upstream of most
  parameters, sits at 1.0 or above), and at 0.05 in the 1x1 head and the
  projector's heads, whose gradients come straight from the losses
  (measured <= 0.0063).
- ``Arch.remat``: forward and gradients bit-identical to no remat, the BN
  running statistics updated once per forward. ``Arch.stem=s2d``: logits and
  taps against JAX s2d at rtol 1e-4 (fp32).
- A bf16 run's checkpoint holds fp32 parameters and Adam state; the trainer
  refuses a ``Parallel.num_devices`` other than its world size.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoints import make_config, make_loaders
from test_torch_device_data import jax_draws
from test_torch_step import BL, BU, C, CROP, FEATS, IMPORTANCE, K, LR, S, WD, _np_tree, \
    _port_state

from mi_based_regularized_semi_supervised_segmentation_tpu.data import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.device_pipeline import (
    DeviceDataStore as JStore,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    build_optimizer as j_build_optimizer,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import init_train_state
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
    build_train_step as j_build_train_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models import (
    ProjectorWrapper as JProjector,
    UNet as JUNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models.heads import (
    LocalClusterHead as JLocalHead,
    group_softmax_flat as j_group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
    sample_flip_mask as j_sample_flip_mask,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_fused import (
    displaced_joint_softmax_pallas,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_joint import (
    displaced_joint_pallas,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.trainer import (
    precision_dtypes,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    LocalClusterHead,
    ProjectorWrapper,
    TAP_NAMES,
    UNet,
    group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_fused, mi_joint
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import unet_state_dict

DT = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
BF16_PAIRS = [("bfloat16", "float32"), ("bfloat16", "bfloat16")]


def _bf16(x) -> torch.Tensor:
    """A JAX or numpy bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.int16).copy()).view(torch.bfloat16)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance, in bf16 steps, between two bf16 tensors."""
    def ordered(t):
        bits = t.contiguous().view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(a) - ordered(b)).abs().max())


def _near(got: torch.Tensor, want: torch.Tensor, floor: float = 1e-5) -> bool:
    """Within one bf16 step of ``want`` (2^-7 of it at most) or within
    ``floor`` of its largest entry."""
    got, want = got.float(), want.float()
    step = 2.0 ** (torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    return bool(((got - want).abs() <= step + floor * float(want.abs().max())).all())


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [1.0, 0.7])
def test_bf16_group_softmax_matches_jax_rounding_points(rng, T):
    S_, K_, C_ = 3, 5, 32
    z = jnp.asarray((rng.normal(size=(2, 6, 5, C_)) * 3).astype(np.float32), jnp.bfloat16)
    want = _bf16(j_group_softmax_flat(z, S_, K_, T))
    tz = _bf16(z).requires_grad_(True)
    got = group_softmax_flat(tz, S_, K_, T)
    assert got.dtype == torch.bfloat16
    assert _ulps(got, want) <= 1
    assert float((got == want).float().mean()) >= 0.99
    assert torch.all(got[..., S_ * K_:] == 0)
    # the fp32 softmax rounded once is another function: it misses the bf16 exps
    fp32 = group_softmax_flat(tz.detach().float(), S_, K_, T).to(torch.bfloat16)
    assert float((fp32 == want).float().mean()) < float((got == want).float().mean())
    (got.float() * torch.tensor(rng.normal(size=z.shape).astype(np.float32))).sum().backward()
    assert torch.all(tz.grad[..., S_ * K_:] == 0) and torch.isfinite(tz.grad.float()).all()


@pytest.mark.parametrize("kind", ["dyadic", "random"])
def test_bf16_logits_head_matches_jax_with_minus_inf_dead_lanes(rng, kind):
    dim, S_, K_ = 32, 2, 5
    if kind == "dyadic":  # small dyadic values: every product and sum exact in fp32
        feats = rng.integers(-8, 9, (2, 6, 5, dim)).astype(np.float32) / 8
        w = rng.integers(-16, 17, (dim, S_ * K_)).astype(np.float32) / 64
        b = rng.integers(-8, 9, (S_ * K_,)).astype(np.float32) / 16
    else:
        feats = rng.normal(size=(2, 6, 5, dim)).astype(np.float32)
        w = (rng.normal(size=(dim, S_ * K_)) / np.sqrt(dim)).astype(np.float32)
        b = (rng.normal(size=(S_ * K_,)) * 0.1).astype(np.float32)
    jhead = JLocalHead(num_clusters=K_, num_subheads=S_, dtype=jnp.bfloat16, flat_output=True,
                       lane_multiple=128, emit_logits=True)
    want = _bf16(jhead.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(feats)))
    head = LocalClusterHead(dim, K_, S_, emit_logits=True, dtype=torch.bfloat16)
    head.linear.weight.data = torch.tensor(w.T.copy())
    head.linear.bias.data = torch.tensor(b)
    with torch.no_grad():
        got = head(torch.tensor(feats))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape == (2, 6, 5, 128)
    assert torch.all(got[..., S_ * K_:] == float("-inf"))
    assert torch.equal(got[..., S_ * K_:].view(torch.int16), want[..., S_ * K_:].view(torch.int16))
    if kind == "dyadic":
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    else:
        assert _ulps(got[..., :S_ * K_], want[..., :S_ * K_]) <= 1
    # the probability head of the same weights: the bf16 group softmax, 0 in dead lanes
    jprob = JLocalHead(num_clusters=K_, num_subheads=S_, dtype=jnp.bfloat16, flat_output=True,
                       lane_multiple=128)
    want_p = _bf16(jprob.apply({"params": {"kernel": w, "bias": b}}, jnp.asarray(feats)))
    head.emit_logits = False
    with torch.no_grad():
        got_p = head(torch.tensor(feats))
    assert got_p.dtype == torch.bfloat16 and _ulps(got_p, want_p) <= 1
    assert torch.all(got_p[..., S_ * K_:] == 0)


def test_projector_keeps_encoder_heads_fp32():
    proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S, local_dtype=torch.bfloat16)
    feats = {"Conv5": torch.randn(2, 1, 1, 256).bfloat16(),
             "Up_conv3": torch.randn(2, 8, 8, 32).bfloat16(),
             "Up_conv2": torch.randn(2, 16, 16, 16).bfloat16()}
    with torch.no_grad():
        out = proj(feats)
    assert out["Conv5"].dtype == torch.float32
    assert out["Up_conv3"].dtype == out["Up_conv2"].dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in proj.parameters())


# ---------------------------------------------------------------------------
# U-Net
# ---------------------------------------------------------------------------

def _jax_unet(stem="conv", edge=32):
    """Random-init JAX U-Net variables (numpy) at crop ``edge``."""
    v = JUNet(input_dim=1, num_classes=3, stem=stem).init(
        jax.random.PRNGKey(0), jnp.zeros((1, edge, edge, 1)), train=False)
    return (jax.tree_util.tree_map(np.asarray, jax.device_get(v["params"])),
            jax.tree_util.tree_map(np.asarray, jax.device_get(v["batch_stats"])))


def _unet_outputs(params, stats, x, compute, bn, train, stem="conv"):
    """(logits, taps, running statistics after the forward) of both sides."""
    jm = JUNet(input_dim=1, num_classes=3, dtype=DT[compute][1], bn_dtype=DT[bn][1], stem=stem)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (jl, jf), mut = jm.apply(variables, jnp.asarray(x), train=True, return_features=True,
                                 mutable=["batch_stats"])
        jstats = unet_state_dict(params, jax.device_get(mut["batch_stats"]))
    else:
        jl, jf = jm.apply(variables, jnp.asarray(x), train=False, return_features=True)
        jstats = None
    model = UNet(1, 3, dtype=DT[compute][0], bn_dtype=DT[bn][0], stem=stem)
    model.load_state_dict(unet_state_dict(params, stats))
    model.train(train)
    with torch.no_grad():
        tl, tf = model(torch.tensor(x), return_features=True)
    return (jl, jf, jstats), (tl, tf, model.state_dict())


@pytest.mark.parametrize("compute,bn", BF16_PAIRS)
@pytest.mark.parametrize("train", [False, True])
def test_bf16_unet_matches_jax(rng, compute, bn, train):
    params, stats = _jax_unet()
    x = rng.normal(size=(3, 32, 32, 1)).astype(np.float32)
    (jl, jf, jstats), (tl, tf, tsd) = _unet_outputs(params, stats, x, compute, bn, train)
    assert tl.dtype == torch.float32 and jl.dtype == jnp.float32
    for name in TAP_NAMES:
        assert str(tf[name].dtype) == f"torch.{jf[name].dtype}", name
    outs = [("logits", tl, jl)] + [(n, tf[n], jf[n]) for n in TAP_NAMES]
    if not train:
        for name, got, want in outs:
            assert _rel(got.float(), np.asarray(want, np.float32)) <= 1e-3, name
        return
    (fl, ff, fstats), _ = _unet_outputs(params, stats, x, "float32", "float32", train)
    fp32 = dict([("logits", fl)] + [(n, ff[n]) for n in TAP_NAMES])
    for name, got, want in outs:
        want = np.asarray(want, np.float32)
        assert _rel(got.float(), want) <= 0.75 * _rel(fp32[name], want), name
    keys = [k for k in jstats if "running_" in k]
    stat = lambda sd: np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in keys])
    assert _rel(stat(tsd), stat(jstats)) <= 0.75 * _rel(stat(fstats), stat(jstats))
    for key in ("Conv1.conv.1.running_mean", "Conv1.conv.1.running_var"):
        np.testing.assert_allclose(tsd[key].numpy(), jstats[key].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=key)


@pytest.mark.parametrize("train", [False, True])
def test_s2d_unet_matches_jax(rng, train):
    params, stats = _jax_unet("s2d")
    assert params["Conv1"]["conv0"]["kernel"].shape == (3, 3, 4, 16)
    x = rng.normal(size=(3, 32, 32, 1)).astype(np.float32)
    (jl, jf, jstats), (tl, tf, tsd) = _unet_outputs(params, stats, x, "float32", "float32",
                                                    train, stem="s2d")
    assert tl.shape == (3, 32, 32, 3) and tf["Conv1"].shape == (3, 16, 16, 16)
    # train-mode BN amplifies fp32 summation-order differences, as in
    # tests/test_torch_models.py (atol 3e-4 there)
    atol = 3e-4 if train else 1e-5
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=atol)
    for name in TAP_NAMES:
        np.testing.assert_allclose(tf[name].numpy(), np.asarray(jf[name]), rtol=1e-4, atol=atol,
                                   err_msg=name)
    if train:
        for key in jstats:
            if "running_" in key:
                np.testing.assert_allclose(tsd[key].numpy(), jstats[key].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=key)


def test_s2d_channel_order_is_jax_not_pixel_shuffle():
    from mi_based_regularized_semi_supervised_segmentation_tpu.models.unet import (
        depth_to_space as j_d2s,
        space_to_depth as j_s2d,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models.unet import (
        depth_to_space,
        space_to_depth,
    )

    x = np.arange(2 * 4 * 6 * 3, dtype=np.float32).reshape(2, 4, 6, 3)
    np.testing.assert_array_equal(space_to_depth(torch.tensor(x), 2).numpy(),
                                  np.asarray(j_s2d(jnp.asarray(x), 2)))
    y = np.arange(2 * 2 * 3 * 12, dtype=np.float32).reshape(2, 2, 3, 12)
    np.testing.assert_array_equal(depth_to_space(torch.tensor(y), 2).numpy(),
                                  np.asarray(j_d2s(jnp.asarray(y), 2)))
    pixel = torch.nn.functional.pixel_shuffle(torch.tensor(y).permute(0, 3, 1, 2), 2)
    assert not np.array_equal(pixel.permute(0, 2, 3, 1).numpy(), np.asarray(j_d2s(y, 2)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_remat_is_bit_identical_and_moves_bn_stats_once(rng, compute):
    torch.manual_seed(0)
    base = UNet(1, 3, dtype=DT[compute][0], bn_dtype=DT[compute][0])
    rem = UNet(1, 3, dtype=DT[compute][0], bn_dtype=DT[compute][0], remat=True)
    rem.load_state_dict(base.state_dict())
    x = torch.tensor(rng.normal(size=(2, 32, 32, 1)).astype(np.float32))
    tgt = torch.tensor(rng.normal(size=(2, 32, 32, 3)).astype(np.float32))
    outs = []
    for model in (base, rem):
        model.train()
        logits, feats = model(x, return_features=True)
        loss = ((logits - tgt) ** 2).mean() + sum(f.float().mean() for f in feats.values())
        loss.backward()
        outs.append((logits.detach(), {n: p.grad for n, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()}))
    (l0, g0, s0), (l1, g1, s1) = outs
    assert torch.equal(l0, l1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
    for key in s0:  # the recompute in backward left the statistics alone
        assert torch.equal(s0[key], s1[key]), key
    assert int(s1["Conv1.conv.1.num_batches_tracked"]) == 1


# ---------------------------------------------------------------------------
# kernels' plain versions on bf16 operands
# ---------------------------------------------------------------------------

def _maps(rng, shape, live, padding):
    """bf16-rounded softmax maps [B, Hp, Wp, C] with a zero border of width p."""
    z = rng.normal(size=shape[:-1] + (live,))
    e = np.exp(z - z.max(-1, keepdims=True))
    x = np.zeros(shape, np.float32)
    x[..., :live] = e / e.sum(-1, keepdims=True)
    x[:, :padding] = x[:, x.shape[1] - padding:] = 0
    x[:, :, :padding] = x[:, :, x.shape[2] - padding:] = 0
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


@pytest.mark.parametrize("padding,lanes,live", [(1, 6, 6), (3, 128, 20), (2, 128, 100)])
def test_bf16_joint_matches_pallas_and_rounds_gradients_once(rng, padding, lanes, live):
    shape = (2, 9 + 2 * padding, 8 + 2 * padding, lanes)
    x, y = _maps(rng, shape, live, padding), _maps(rng, shape, live, padding)
    t = 2 * padding + 1
    g = rng.normal(size=(t, t, lanes, lanes)).astype(np.float32)
    f = lambda a, b: displaced_joint_pallas(a, b, padding, None, jnp.bfloat16, True)
    joint, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(y))
    jdx, jdy = vjp(jnp.asarray(g))
    assert jdx.dtype == jnp.bfloat16
    tx, ty = _bf16(x).requires_grad_(True), _bf16(y).requires_grad_(True)
    tj = mi_joint.displaced_joint(tx, ty, padding, torch.bfloat16, pre_padded=True)
    (tj * torch.tensor(g)).sum().backward()
    assert tj.dtype == torch.float32 and tx.grad.dtype == ty.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tj.detach().numpy(), np.asarray(joint), rtol=1e-4, atol=1e-5)
    assert _near(tx.grad, _bf16(jdx)) and _near(ty.grad, _bf16(jdy))


def test_bf16_lane_tiled_backward_rounds_once_at_256_lanes(rng):
    """Integer operands: every fp32 sum is exact, so the gradient rounded once
    is exact.to(bf16), bit for bit; rounding each 128-lane block's sum first
    would differ (checked)."""
    padding, c = 1, 256
    hp, wp = 9, 8
    n, d = 2 * hp * wp, (2 * padding + 1) ** 2
    src = torch.tensor(rng.integers(0, 9, (n, c)).astype(np.float32)).to(torch.bfloat16)
    g = torch.tensor(rng.integers(-40, 41, (d, c, c)).astype(np.float32))
    blocks = lambda out_dtype: lambda s, h, tr: _plain_bwd(s, h, wp, padding, tr, out_dtype)
    for transpose_g in (False, True):
        exact = mi_joint.lane_tiled_bwd(src.float(), g, blocks(torch.float32), transpose_g)
        got = mi_joint.lane_tiled_bwd(src, g, blocks(torch.float32), transpose_g)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), exact.to(torch.bfloat16).view(torch.int16))
        twice = mi_joint.lane_tiled_bwd(src.float(), g, blocks(torch.bfloat16), transpose_g)
        assert not torch.equal(twice.to(torch.bfloat16), got)


def _plain_bwd(src, g, wp, padding, transpose_g, out_dtype):
    """One 128-lane block's backward product by autograd of the plain joint,
    in ``out_dtype`` (J is linear in each operand, so the other may be 0)."""
    src = src.float()
    other = torch.zeros_like(src, requires_grad=True)
    pair = (other, src) if transpose_g else (src, other)
    joint = mi_joint.displaced_joint_plain_flat(*pair, wp, padding, torch.bfloat16)
    return torch.autograd.grad(joint, other, g)[0].to(out_dtype).float()


def _logits(rng, b, hp, wp, sk):
    """bf16 logits as the bf16 heads emit them: dead lanes -inf."""
    z = np.full((b, hp, wp, 128), -np.inf, np.float32)
    z[..., :sk] = rng.normal(size=(b, hp, wp, sk))
    return np.asarray(jnp.asarray(z, jnp.bfloat16))


@pytest.mark.parametrize("pad,shape", [(1, (2, 11, 10)), (2, (2, 13, 12))])
def test_bf16_fused_matches_pallas_with_minus_inf_dead_lanes(rng, pad, shape):
    S_, K_ = 2, 3
    l1, l2 = _logits(rng, *shape, S_ * K_), _logits(rng, *shape, S_ * K_)
    t = 2 * pad + 1
    g = rng.normal(size=(t, t, 128, 128)).astype(np.float32)
    f = lambda a, b: displaced_joint_softmax_pallas(a, b, pad, S_, K_, 1.0, None, jnp.bfloat16)
    joint, vjp = jax.vjp(f, jnp.asarray(l1), jnp.asarray(l2))
    jd1, jd2 = vjp(jnp.asarray(g))
    assert jd1.dtype == jnp.bfloat16
    t1, t2 = _bf16(l1).requires_grad_(True), _bf16(l2).requires_grad_(True)
    tj = mi_fused.displaced_joint_softmax(t1, t2, pad, S_, K_, 1.0, torch.bfloat16)
    (tj * torch.tensor(g)).sum().backward()
    assert torch.isfinite(tj).all() and t1.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tj.detach().numpy(), np.asarray(joint), rtol=1e-4, atol=1e-7)
    for got, want in ((t1.grad, jd1), (t2.grad, jd2)):
        assert torch.isfinite(got.float()).all()
        assert torch.all(got[..., S_ * K_:] == 0)
        assert _near(got, _bf16(want))


# ---------------------------------------------------------------------------
# one train step against the JAX step
# ---------------------------------------------------------------------------

MODES = {
    "udaiic": dict(uda_criterion="mse", uda_weight=10.0, iic_weight=0.1, reg_weight=1.0,
                   paddings=[1, 1], patch_sizes=1024),
    "meanteacher": dict(uda_criterion="mse", reg_weight=10.0, ema_alpha=0.999,
                        ema_weight_decay=1e-6),
}
LOSS_KEYS = ("sup_loss", "uda", "mi", "reg_loss", "total_loss")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc_precision"))
    generate_synthetic_acdc(root, num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


def _jax_step(mode, compute, bn, emit_logits, store, num_classes=C):
    """The JAX step's metrics, its state before and after (the port's
    layout, the teacher under "teacher.") and the inputs the port's step
    takes: the flip mask and, with a store, the augmentation draws."""
    jc, jb = DT[compute][1], DT[bn][1]
    needs_iic = mode == "udaiic"
    jmodel = JUNet(input_dim=1, num_classes=num_classes, dtype=jc, bn_dtype=jb)
    jproj = JProjector(feature_names=FEATS, num_clusters=K, num_subheads=S, local_flat=True,
                       local_dtype=jc, local_emit_logits=emit_logits) if needs_iic else None
    tx = j_build_optimizer({"name": "Adam", "lr": LR, "weight_decay": WD})
    state = init_train_state(jmodel, tx, (1, CROP, CROP, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS if needs_iic else None,
                             with_ema=mode == "meanteacher")

    def snapshot(st):
        params = _np_tree(st.params)
        out = _port_state(params, _np_tree(st.batch_stats)) if needs_iic else \
            unet_state_dict(params["model"], _np_tree(st.batch_stats))
        if st.ema_params is not None:
            ema = _np_tree(st.ema_params)
            out.update({f"teacher.{k}": v for k, v in
                        unet_state_dict(ema["params"], ema["batch_stats"]).items()})
        return out

    before = snapshot(state)
    _, flip_key, aug_l, aug_u = jax.random.split(state.rng, 4)
    inputs = {"flip_mask": torch.from_numpy(np.array(j_sample_flip_mask(flip_key, BU, 0.8)))}
    kw = dict(num_classes=num_classes, feature_names=FEATS, feature_importance=IMPORTANCE,
              **MODES[mode])
    if store is None:
        rng = np.random.default_rng(0)
        batch = {"labeled_image": rng.random((BL, CROP, CROP, 1), dtype=np.float32),
                 "labeled_target": rng.integers(0, C, (BL, CROP, CROP)).astype(np.int32),
                 "unlabeled_image": rng.random((BU, CROP, CROP, 1), dtype=np.float32)}
        jstep = j_build_train_step(jmodel, tx, mode, projector=jproj, backend="pallas", **kw)
    else:
        jstore, lab, unlab = store
        batch = {"labeled_indices": lab, "unlabeled_indices": unlab}
        inputs["aug_params"] = {
            "labeled": jax_draws(aug_l, BL, jstore.shape, CROP, jstore.valid_hw_dev[lab],
                                 jstore.offsets_dev[lab]),
            "unlabeled": jax_draws(aug_u, BU, jstore.shape, CROP, jstore.valid_hw_dev[unlab],
                                   jstore.offsets_dev[unlab])}
        jstep = j_build_train_step(jmodel, tx, mode, projector=jproj, backend="pallas",
                                   data_store={"labeled": jstore, "unlabeled": jstore},
                                   crop=CROP, geometry="fused", **kw)
    args = (state, {k: jnp.asarray(v) for k, v in batch.items()})
    compiled = jstep.lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})
    state1, jmetrics = compiled(*args)
    return jmetrics, before, snapshot(state1), batch, inputs


def _port_step(mode, compute, bn, emit_logits, before, batch, inputs, store=None,
               num_classes=C):
    tc, tb = DT[compute][0], DT[bn][0]
    model = UNet(1, num_classes, dtype=tc, bn_dtype=tb)
    model.load_state_dict({k: v for k, v in before.items()
                           if not k.startswith(("proj.", "teacher."))})
    params, proj, teacher = list(model.parameters()), None, None
    if mode == "udaiic":
        proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S,
                                local_emit_logits=emit_logits, local_dtype=tc)
        proj.load_state_dict({k[5:]: v for k, v in before.items() if k.startswith("proj.")})
        params += list(proj.parameters())
    else:
        teacher = copy.deepcopy(model).requires_grad_(False)
        teacher.load_state_dict({k[8:]: v for k, v in before.items() if k.startswith("teacher.")})
    opt = build_optimizer(params, {"name": "Adam", "lr": LR, "weight_decay": WD})
    step = build_train_step(model, opt, mode, num_classes=num_classes,
                            generator=torch.Generator(),
                            feature_names=FEATS, feature_importance=IMPORTANCE, projector=proj,
                            teacher=teacher, data_store=store, crop=CROP, geometry="fused",
                            **MODES[mode])
    metrics = step({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}, **inputs)
    after = dict(model.state_dict())
    if proj is not None:
        after.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
    if teacher is not None:
        after.update({f"teacher.{k}": v for k, v in teacher.state_dict().items()})
    return metrics, after


def _move_share(after, after_jax, before, keys) -> float:
    """The share of the elements of ``keys`` whose move in the step differs
    in sign from the JAX step's (Adam's first move is about lr * sign(g))."""
    move = lambda sd, k: np.asarray(sd[k], np.float64) - np.asarray(before[k], np.float64)
    got = np.concatenate([move(after, k).ravel() for k in keys])
    want = np.concatenate([move(after_jax, k).ravel() for k in keys])
    return float(np.mean(np.sign(got) != np.sign(want)))


def _check_step(jmetrics, metrics, after_jax, after, before, after_fp32):
    """``after_fp32``: the port's fp32 step from the same state and inputs."""
    for key in [k for k in LOSS_KEYS if k in jmetrics] + [
            k for k in jmetrics if k.startswith("individual_mis/")]:
        assert metrics[key].dtype == torch.float32, key
        np.testing.assert_allclose(float(metrics[key]), float(jmetrics[key]), rtol=2e-2,
                                   atol=2e-6, err_msg=key)
    for key in after_jax:
        if "running_" not in key:
            continue
        want, got = after_jax[key].numpy(), after[key].numpy()
        assert np.abs(got - want).max() <= 0.02 * np.abs(want).max(), key
        if ".Conv1.conv.1." in f".{key}":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6, err_msg=key)
    for key, value in after.items():
        if value.is_floating_point():
            assert value.dtype == torch.float32, key
    # the parameters: the share of moves against the JAX bf16 step's, below
    # 0.2, below 0.75 of the port's fp32 step's share, and in the heads below
    # 0.05 (measured 0.103-0.149, 0.60-0.63 of the fp32 step's, <= 0.0063)
    params = [k for k in after_jax if not k.startswith("teacher.") and "running_" not in k]
    heads = [k for k in params if k.startswith(("proj.", "DeConv_1x1."))]
    share = _move_share(after, after_jax, before, params)
    share_fp32 = _move_share(after_fp32, after_jax, before, params)
    assert share <= 0.2 and share < 0.75 * share_fp32, (share, share_fp32)
    assert _move_share(after, after_jax, before, heads) <= 0.05


@pytest.mark.parametrize("mode,compute,bn,emit_logits", [
    ("udaiic", "bfloat16", "bfloat16", False),
    ("udaiic", "bfloat16", "bfloat16", True),
    ("meanteacher", "bfloat16", "bfloat16", False),
])
def test_bf16_step_matches_jax(mode, compute, bn, emit_logits):
    jmetrics, before, after_jax, batch, inputs = _jax_step(mode, compute, bn, emit_logits, None)
    metrics, after = _port_step(mode, compute, bn, emit_logits, before, batch, inputs)
    _, fp32 = _port_step(mode, "float32", "float32", emit_logits, before, batch, inputs)
    _check_step(jmetrics, metrics, after_jax, after, before, fp32)
    if mode == "udaiic" and bn == "bfloat16" and not emit_logits:
        # liveness: the port's fp32 step sits farther from the JAX bf16 step
        keys = [k for k in after_jax if "running_" in k]
        stats = lambda sd: np.concatenate([np.asarray(sd[k], np.float64).ravel() for k in keys])
        dist = lambda sd: np.linalg.norm(stats(sd) - stats(after_jax))
        assert dist(after) < 0.75 * dist(fp32)


def test_bf16_device_step_matches_jax(data_root):
    jstore = JStore(JACDCDataset(data_root, "train"), pack=True)
    store = DeviceDataStore(ACDCDataset(data_root, "train"), pack=True)
    lab, unlab = np.array([1, 7], np.int32), np.array([0, 5, 18], np.int32)
    jmetrics, before, after_jax, batch, inputs = _jax_step(
        "udaiic", "bfloat16", "bfloat16", False, (jstore, lab, unlab), num_classes=4)
    step = lambda dt: _port_step("udaiic", dt, dt, False, before, batch, inputs, store,
                                 num_classes=4)
    (metrics, after), (_, fp32) = step("bfloat16"), step("float32")
    _check_step(jmetrics, metrics, after_jax, after, before, fp32)


# ---------------------------------------------------------------------------
# trainer: config, checkpoints
# ---------------------------------------------------------------------------

def test_precision_and_arch_keys_parse_and_only_num_devices_is_refused(tmp_path):
    cfg = make_config("udaiic")
    assert precision_dtypes(cfg) == (torch.float32, torch.float32)  # the default stays fp32
    cfg["Precision"] = {"compute_dtype": "bfloat16", "bn_dtype": "bfloat16"}
    cfg["Arch"] = dict(cfg.get("Arch") or {}, stem="s2d", remat=True)
    trainer = trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None,
                                     val_loader=None, test_loader=None, configuration=cfg,
                                     device="cpu", crop_size=32, run_dir=str(tmp_path))
    trainer.init()
    model = trainer._model
    assert (model.dtype, model.bn_dtype, model.stem, model.remat) == (
        torch.bfloat16, torch.bfloat16, "s2d", True)
    heads = trainer._projector.heads
    assert heads["Up_conv2"].dtype == torch.bfloat16
    for key, value in (("compute_dtype", "float16"), ("bn_dtype", "bf16")):
        bad = dict(cfg, Precision={key: value})
        with pytest.raises(ValueError, match=f"Precision.{key}"):
            precision_dtypes(bad)
    with pytest.raises(ValueError, match="Parallel.num_devices=2 but the world size is 1"):
        trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None, val_loader=None,
                               test_loader=None, configuration=dict(cfg, Parallel={
                                   "num_devices": 2}), device="cpu", run_dir=str(tmp_path))


def test_bf16_run_checkpoint_holds_fp32(data_root, tmp_path):
    cfg = make_config("udaiic")
    cfg["Precision"] = {"compute_dtype": "bfloat16", "bn_dtype": "bfloat16"}
    trainer = trainer_zoos["udaiic"](**make_loaders(data_root), configuration=cfg,
                                     device="cpu", save_dir="bf16", max_epoch=1, num_batches=2,
                                     crop_size=CROP, run_dir=str(tmp_path / "runs"))
    trainer.init()
    trainer.start_training()
    state = torch.load(tmp_path / "runs" / "bf16" / "last.pth", weights_only=False)
    tensors = [v for v in _leaves(state) if isinstance(v, torch.Tensor) and v.is_floating_point()]
    assert tensors and all(t.dtype == torch.float32 for t in tensors)
    assert np.isfinite(trainer._storage._rows[0]["tra_mi_mean"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
