"""The port's contrastive pretrain functions and steps against the JAX
package's (``engine/pretrain.py``, the pretrain losses and heads).

Held:
- the label, layout and freeze helpers: equal to the JAX ones;
- ``supcon_loss`` in every mode, ``jsd_div``, ``simplex_cross_entropy``:
  values and input gradients at rtol 1e-5;
- the projection heads and bare cluster heads, started from the JAX
  parameters through ``weights.py``: outputs at rtol 1e-5 (atol 1e-6);
- one step of each of the four steps from the same weights, batch and (for
  the flips) the mask the JAX step draws from its state's rng: every loss at
  rtol 2e-4; the post-Adam parameters with the step tests' two-tier bound
  (tests/test_torch_step.py: Adam's first step is about -lr * sign(g), so a
  gradient at fp32 noise may step the other way: |diff| <= 2.05 lr, more
  than 0.05 lr apart for under 0.5% of the elements) and the BN running
  statistics, frozen components' included, at rtol 1e-4 (atol 1e-6); the
  frozen components' parameters bit-equal on both sides; the finetune
  steps' dice sums (pixel counts) within 2 pixels, as the port's and the JAX
  logits differ by rounding, which flips the argmax of a near-tied
  pixel now and then (1 of 12 sums, by 1, in the finetune step).
  The JAX step computes in float64 (the U-Net's ``dtype`` and ``bn_dtype``
  under ``jax.enable_x64``; the parameters and the Adam state stay fp32): at
  fp32 its U-Net gradients on the CPU lie about ten times farther from the
  same step in float64 than the port's fp32 ones do, and the elements
  stepping the other way then come near the 0.5% bound in the decoder and
  finetune steps; against the float64 reference they stay far below it
  whatever the thread count. The decoder step's
  IIC term through the port's ``auto`` door (on CPU tensors the kernel's plain
  version: bf16 operands, fp32 sums) is held against the JAX step with the
  Pallas kernel in interpret mode (its ``auto`` off the TPU is
  ``xla_banded``, fp32 products; tests/test_torch_iic_local.py holds the
  port's ``xla_banded`` against it).
Crop 32, 4 slices a view, the pretrain config's heads (projector mlp, IIC
10 x 10 linear on Conv5 and 10 x 20 mlp on Up_conv3, padding 0, patch 512).
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from test_torch_step import LR, _check_params, _np_tree

from mi_based_regularized_semi_supervised_segmentation_tpu.engine import pretrain as jpre
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    build_optimizer as j_build_optimizer,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import TrainState
from mi_based_regularized_semi_supervised_segmentation_tpu.models import heads as jheads
from mi_based_regularized_semi_supervised_segmentation_tpu.models import unet as junet
from mi_based_regularized_semi_supervised_segmentation_tpu.ops import losses as jlosses
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
    sample_flip_mask as j_sample_flip_mask,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import pretrain
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import heads, unet
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import losses
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    cluster_head_state_dict,
    local_projection_head_state_dict,
    projection_head_state_dict,
    unet_state_dict,
)

CROP, B, C = 32, 4, 3


@functools.lru_cache(maxsize=None)
def _jax_unet():
    """The JAX U-Net's variables (seed 0) and its Conv5 / Up_conv3 features
    of zeros at crop 32, as host copies, made once (flax's init runs op by
    op); each use makes its own device arrays from them."""
    jmodel = junet.UNet(input_dim=1, num_classes=C)
    v = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, CROP, CROP, 1)), train=False)
    feats = jmodel.apply(v, jnp.zeros((B, CROP, CROP, 1)), train=False, return_features=True)[1]
    return _np_tree(v), {k: np.asarray(feats[k]) for k in ("Conv5", "Up_conv3")}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs several test processes on
    the machine's cores at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
PARTS, GROUPS = ["0", "1", "2", "0"], ["p1", "p1", "p2", "p2"]


# ---------------------------------------------------------------------------
# helpers: labels, layout, freeze
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("option", ["partition", "patient", "both"])
def test_label_helpers_match_jax(option):
    flags = pretrain.group_option_flags(option)
    assert flags == jpre.group_option_flags(option)
    np.testing.assert_array_equal(pretrain.global_labels(PARTS, GROUPS, *flags),
                                  jpre.global_labels(PARTS, GROUPS, *flags))
    for hw, parts in (((4, 4), (2, 2)), ((6, 4), (3, 2))):
        locs = pretrain.unfold_locations(hw, B, parts)
        assert locs == jpre.unfold_locations(hw, B, parts)
        np.testing.assert_array_equal(pretrain.local_labels(PARTS, GROUPS, locs),
                                      jpre.local_labels(PARTS, GROUPS, locs))
    with pytest.raises(ValueError, match="group_option"):
        pretrain.group_option_flags("slice")


@pytest.mark.parametrize("parts", [(2, 2), (3, 2)])
def test_unfold_blocks_matches_jax(rng, parts):
    x = rng.normal(size=(3, 6, 4, 5)).astype(np.float32)
    got, locs = pretrain.unfold_blocks(torch.from_numpy(x), parts)
    want, jlocs = jpre.unfold_blocks(jnp.asarray(x), parts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert locs == jlocs


@pytest.mark.parametrize("span", [("Conv1", "Conv5"), ("Up5", "Up_conv3"), ("Conv1", "DeConv_1x1")])
def test_component_range_and_freeze_mask_match_jax(span):
    comps = pretrain.component_range(*span)
    assert comps == jpre.component_range(*span)
    assert unet.COMPONENT_NAMES == junet.COMPONENT_NAMES
    jparams = _jax_unet()[0]["params"]
    jmask = jpre.freeze_mask({"model": jparams, "projector": {"w": jnp.zeros(3)}}, comps)
    assert jax.tree_util.tree_leaves(jmask["projector"]) == [1.0]
    mask = pretrain.freeze_mask(unet.UNet(1, C), comps)
    keep = unet.component_param_filter(comps)
    for name, trains in mask.items():
        comp = name.split(".", 1)[0]
        assert set(jax.tree_util.tree_leaves(jmask["model"][comp])) == {float(trains)}, name
        assert keep(name) == trains
    with pytest.raises(ValueError, match="comes after"):
        pretrain.component_range(span[1], span[0])


def test_weight_norm_and_split_feature_names_match_jax():
    v = _jax_unet()[0]
    model = unet.UNet(1, C)
    model.load_state_dict(unet_state_dict(v["params"], v["batch_stats"]))
    got, want = unet.weight_norm(model), junet.weight_norm(v["params"])
    assert len(got) == len(want)
    np.testing.assert_allclose(sorted(got.values()), sorted(want.values()), rtol=1e-5)
    names = ["Up_conv2", "Conv5", "Up5", "Conv1"]
    assert heads.split_feature_names(names) == jheads.split_feature_names(names)
    with pytest.raises(ValueError, match="not all"):
        heads.split_feature_names(["Conv5", "Conv9"])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _grad_pair(port_fn, jax_fn, *arrays):
    """(port value, port grads, JAX value, JAX grads) of a scalar function
    of ``arrays`` (gradients with respect to each)."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    val = port_fn(*ts)
    grads = [torch.zeros_like(t) if g is None else g  # a detached input: zero, as in JAX
             for t, g in zip(ts, torch.autograd.grad(val, ts, allow_unused=True))]
    jval, jgrads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(arrays))))(
        *map(jnp.asarray, arrays))
    return val, grads, jval, jgrads


def _assert_pair(val, grads, jval, jgrads, rtol=1e-5):
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=rtol)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=rtol, atol=1e-7)


@pytest.mark.parametrize("mode", ["labels", "mask", "simclr", "one"])
def test_supcon_loss_matches_jax(rng, mode):
    f = rng.normal(size=(6, 2, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = np.asarray([0, 1, 0, 2, 1, 1])
    mask = (rng.random((6, 6)) < 0.4).astype(np.float32)
    kw = {"labels": dict(labels=labels), "mask": dict(mask=mask), "simclr": {},
          "one": dict(labels=labels, contrast_mode="one")}[mode]
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    _assert_pair(*_grad_pair(lambda x: losses.supcon_loss(x, **tkw),
                             lambda x: jlosses.supcon_loss(x, **jkw), f))
    with pytest.raises(ValueError, match="both"):
        losses.supcon_loss(torch.from_numpy(f), labels=torch.from_numpy(labels),
                           mask=torch.from_numpy(mask))


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_jsd_div_and_simplex_cross_entropy_match_jax(rng, reduction):
    p = [np.asarray(jax.nn.softmax(rng.normal(size=(5, 3, 4)) * 2, -1), np.float32)
         for _ in range(3)]
    _assert_pair(*_grad_pair(lambda *x: losses.jsd_div(*x, reduction=reduction),
                             lambda *x: jlosses.jsd_div(*x, reduction=reduction), *p))
    _assert_pair(*_grad_pair(
        lambda x, t: losses.simplex_cross_entropy(x, t, reduction=reduction),
        lambda x, t: jlosses.simplex_cross_entropy(x, t, reduction=reduction), p[0], p[1]))


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _jax_head(kind, ptype):
    """(flax head, port head, weight map, input shape)."""
    if kind == "projection":
        return (jheads.ProjectionHead(output_dim=256, head_type=ptype),
                heads.ProjectionHead(256, output_dim=256, head_type=ptype),
                projection_head_state_dict, (B, 2, 2, 256))
    if kind == "local_projection":
        return (jheads.LocalProjectionHead(head_type=ptype, output_size=(4, 4)),
                heads.LocalProjectionHead(32, head_type=ptype), local_projection_head_state_dict,
                (B, 8, 12, 32))
    if kind == "cluster":
        return (jheads.ClusterHead(num_clusters=10, num_subheads=10, head_type=ptype),
                heads.ClusterHead(256, num_clusters=10, num_subheads=10, head_type=ptype),
                cluster_head_state_dict, (B, 2, 2, 256))
    return (jheads.LocalClusterHead(num_clusters=20, num_subheads=10, head_type=ptype),
            heads.LocalClusterHead(32, num_clusters=20, num_subheads=10, head_type=ptype,
                                   flat_output=False), cluster_head_state_dict, (B, 6, 5, 32))


@pytest.mark.parametrize("ptype", ["linear", "mlp"])
@pytest.mark.parametrize("kind", ["projection", "local_projection", "cluster", "local_cluster"])
def test_heads_through_the_weight_maps_match_jax(rng, kind, ptype):
    jhead, head, to_torch, shape = _jax_head(kind, ptype)
    x = rng.normal(size=shape).astype(np.float32)
    params = jhead.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    head.load_state_dict(to_torch(_np_tree(params)))
    want = np.asarray(jhead.apply({"params": params}, jnp.asarray(x)))
    got = head(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_local_projection_pool_must_divide_the_map():
    with pytest.raises(ValueError, match="does not divide"):
        heads.LocalProjectionHead(32)(torch.zeros((1, 6, 5, 32)))
    with pytest.raises(ValueError, match="head_type"):
        heads.ProjectionHead(16, head_type="conv")


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------

# (phase, IIC head, disable_contrastive, JAX backend of the decoder IIC:
# None = its own)
STEPS = {
    "encoder": ("encoder", False, False, None),
    "encoder_iic": ("encoder", True, False, None),
    "encoder_iic_only": ("encoder", True, True, None),
    "decoder": ("decoder", False, False, None),
    "decoder_iic": ("decoder", True, False, "pallas"),
    "decoder_iic_only": ("decoder", True, True, "pallas"),
    "finetune": ("finetune", False, False, None),
    "finetune_mt": ("finetune_mt", False, False, None),
}
WD = {"encoder": 1e-5, "decoder": 0.0, "finetune": 1e-5, "finetune_mt": 1e-5}
EMA_WD = 1e-3  # large enough that the teacher's decay shows


def _jax_heads(phase, iic, feats):
    """{name: (flax head, its params, port head, port state_dict)}."""
    out = {}
    if phase == "encoder":
        specs = {"projector": ("projection", "mlp", "Conv5")}
        if iic:
            specs["iic"] = ("cluster", "linear", "Conv5")
    elif phase == "decoder":
        specs = {"projector": ("local_projection", "mlp", "Up_conv3")}
        if iic:
            specs["iic"] = ("local_cluster", "mlp", "Up_conv3")
    else:
        return out
    for salt, (name, (kind, ptype, pos)) in enumerate(specs.items()):
        jhead, head, to_torch, _ = _jax_head(kind, ptype)
        params = jhead.init(jax.random.PRNGKey(11 + salt), feats[pos])["params"]
        out[name] = (jhead, params, head, to_torch(_np_tree(params)))
    return out


def _port_layout(params, stats, heads_sd):
    """The JAX state as the port's phase state_dict: model, then heads.*"""
    sd = unet_state_dict(params["model"], stats)
    for name, to_torch in heads_sd.items():
        sd.update({f"heads.{name}.{k}": v for k, v in to_torch(params[name]).items()})
    return sd


def _run_step(case, monkeypatch):
    phase, iic, disable, jax_backend = STEPS[case]
    rng = np.random.default_rng(1)
    jmodel = junet.UNet(input_dim=1, num_classes=C, dtype=jnp.float64, bn_dtype=jnp.float64)
    v_np, feats = _jax_unet()
    v = jax.tree_util.tree_map(jnp.asarray, v_np)
    hs = _jax_heads(phase, iic, {k: jnp.asarray(f) for k, f in feats.items()})
    wd = WD[phase]
    tx = j_build_optimizer({"name": "Adam", "lr": LR, "weight_decay": wd})
    params = {"model": v["params"], **{k: h[1] for k, h in hs.items()}}
    mt = phase == "finetune_mt"
    ema = {"params": jax.tree_util.tree_map(jnp.copy, v["params"]),
           "batch_stats": jax.tree_util.tree_map(jnp.copy, v["batch_stats"])} if mt else None
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=v["batch_stats"], opt_state=tx.init(params),
                       rng=jax.random.PRNGKey(1), ema_params=ema)
    image = rng.random((B, CROP, CROP, 1), dtype=np.float32)
    image_tf = rng.random((B, CROP, CROP, 1), dtype=np.float32)
    target = rng.integers(0, C, (B, CROP, CROP)).astype(np.int32)
    with jax.enable_x64(True):  # the mask the step draws (its uniforms follow x64)
        flip = np.asarray(j_sample_flip_mask(jax.random.split(state.rng)[1], B, 0.5))
    if phase == "encoder":
        comps = pretrain.component_range("Conv1", "Conv5")
        batch = {"image": image, "image_tf": image_tf,
                 "labels": pretrain.global_labels(PARTS, GROUPS)}
        extra = dict(iic_weight=0.5, disable_contrastive=disable) if iic else {}
        jstep = jpre.build_pretrain_encoder_step(
            jmodel, hs["projector"][0], tx, mask=jpre.freeze_mask(params, comps),
            iic_head=hs["iic"][0] if iic else None, **extra)
    elif phase == "decoder":
        comps = pretrain.component_range("Up5", "Up_conv3")
        batch = {"image": image, "image_tf": image_tf, "labels": pretrain.local_labels(
            PARTS, GROUPS, pretrain.unfold_locations((4, 4), B))}
        extra = dict(iic_weight=0.5, disable_contrastive=disable) if iic else {}
        if jax_backend is not None:
            monkeypatch.setattr(jpre, "iid_segmentation_small_patch_loss_subheads",
                                functools.partial(jpre.iid_segmentation_small_patch_loss_subheads,
                                                  backend=jax_backend))
        jstep = jpre.build_pretrain_decoder_step(
            jmodel, hs["projector"][0], tx, mask=jpre.freeze_mask(params, comps),
            iic_head=hs["iic"][0] if iic else None, **extra)
    else:
        comps = unet.COMPONENT_NAMES
        batch = {"image": image, "target": target}
        if mt:
            batch["unlabeled_image"] = image_tf
            jstep = jpre.build_finetune_mt_step(jmodel, tx, num_classes=C, reg_weight=10.0,
                                                ema_weight_decay=EMA_WD)
        else:
            jstep = jpre.build_finetune_step(jmodel, tx, num_classes=C)
    maps = {name: (cluster_head_state_dict if name == "iic" else
                   (projection_head_state_dict if phase == "encoder"
                    else local_projection_head_state_dict)) for name in hs}
    before = _port_layout(_np_tree(params), v_np["batch_stats"], maps)
    with jax.enable_x64(True):
        state1, jmetrics = jstep(state, {k: jnp.asarray(x) for k, x in batch.items()})
    after_jax = _port_layout(_np_tree(state1.params), _np_tree(state1.batch_stats), maps)

    # --- the port: the same weights, batch and flips ---------------------
    model = unet.UNet(1, C)
    model.load_state_dict(unet_state_dict(v_np["params"], v_np["batch_stats"]))
    port_heads = {}
    for name, (_, _, head, sd) in hs.items():
        head.load_state_dict(sd)
        port_heads[name] = head
    teacher = None
    if mt:
        teacher = copy.deepcopy(model).requires_grad_(False)
    ph = pretrain._Phase(model, nn.ModuleDict(port_heads), comps, LR, wd, torch.device("cpu"),
                         11, teacher)
    tb = {k: torch.from_numpy(x) for k, x in batch.items()}
    if phase == "encoder":
        step = pretrain.build_pretrain_encoder_step(
            model, ph.heads["projector"], ph.optimizer,
            iic_head=ph.heads["iic"] if iic else None, **extra)
        metrics = step(tb)
    elif phase == "decoder":
        step = pretrain.build_pretrain_decoder_step(
            model, ph.heads["projector"], ph.optimizer, generator=ph.generator,
            iic_head=ph.heads["iic"] if iic else None, **extra)
        metrics = step(tb, flip_mask=torch.tensor(flip))
    elif mt:
        step = pretrain.build_finetune_mt_step(model, teacher, ph.optimizer, num_classes=C,
                                               generator=ph.generator, reg_weight=10.0,
                                               ema_weight_decay=EMA_WD)
        metrics = step(tb, flip_mask=torch.tensor(flip))
    else:
        step = pretrain.build_finetune_step(model, ph.optimizer, num_classes=C)
        metrics = step(tb)
    ph.close()
    after = {k: v.clone() for k, v in ph.state_dict()["model"].items()}
    after.update({f"heads.{k}": v for k, v in ph.heads.state_dict().items()})
    out = dict(jmetrics=jmetrics, metrics=metrics, before=before, after_jax=after_jax,
               after=after, comps=comps)
    if mt:
        out["teacher"] = (teacher.state_dict(), unet_state_dict(
            _np_tree(state1.ema_params["params"]), _np_tree(state1.ema_params["batch_stats"])),
            unet_state_dict(v_np["params"], v_np["batch_stats"]))
    return out


@pytest.mark.parametrize("case", list(STEPS))
def test_step_matches_jax(case, monkeypatch):
    r = _run_step(case, monkeypatch)
    jm, m = r["jmetrics"], r["metrics"]
    assert set(jm) == set(m)
    for key in jm:
        if key.startswith("sup_dice"):  # pixel counts: an fp32 near-tie may flip an argmax
            assert np.abs(m[key].numpy() - np.asarray(jm[key])).max() <= 2, key
        else:
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-4, atol=1e-7,
                                       err_msg=key)
    if STEPS[case][2]:  # disable_contrastive: the IIC term is the loss
        assert float(m["total_loss"]) == float(m["iic_loss"])
    _check_params(r["before"], r["after_jax"], r["after"])
    frozen = [k for k in r["before"] if not k.startswith("heads.")
              and k.split(".", 1)[0] not in r["comps"] and "running_" not in k
              and "num_batches" not in k]
    assert bool(frozen) == case.startswith(("encoder", "decoder"))
    for key in frozen:
        assert torch.equal(r["after"][key], r["before"][key]), key
        assert torch.equal(r["after_jax"][key], r["before"][key]), key
    moved = [k for k in r["before"] if "running_mean" in k
             and not torch.equal(r["after"][k], r["before"][k])]
    assert len(moved) == len([k for k in r["before"] if "running_mean" in k])  # all BN layers
    if "teacher" in r:  # step 0: alpha = 0, teacher = student * (1 - wd)
        teacher, jteacher, init = r["teacher"]
        for key, t in teacher.items():
            if "running_" in key:
                np.testing.assert_allclose(t.numpy(), jteacher[key].numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=key)
                assert not torch.equal(t, init[key])
            elif "num_batches" not in key:
                np.testing.assert_allclose(t.numpy(), r["after"][key].numpy() * (1 - EMA_WD),
                                           rtol=1e-6, err_msg=key)
        _check_params(init, jteacher, teacher)  # the student scaled
