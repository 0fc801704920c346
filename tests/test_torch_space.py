"""The spatial H split of the port (``parallel/mesh.py:split_context``,
``parallel/halo.py``, the U-Net on a band, the split step) on gloo ranks on
the CPU, against the JAX package's ``batch_sharding(mesh,
space_axis="space")`` step and against the port's one-process step.

Each module fixture spawns its world once (``parallel/dryrun.py:run_ranks``:
a ``file://`` store under ``tmp_path``, one thread a rank, every join under
a 120 s timeout) and runs every case of that world. Held:

- the JAX test's own case (``tests/test_parallel.py``,
  ``test_space_axis_sharded_conv_numerics``): a ``uda`` step (U-Net 1 -> 3,
  Adam at 1e-3, MSE at ``reg_weight`` 5, crop 16, 8 + 8 slices) on 4 x 2
  ranks, from the JAX init (the U-Net's weights through ``weights.py``'s
  map, which serves the split as it is) and the JAX flip draw, against the
  JAX step on ``make_mesh(8, space_axis="space", space_size=2)`` with the
  batch placed by ``batch_sharding(mesh, space_axis="space")``:
  ``sup_loss`` and ``total_loss`` at rtol 1e-4, every parameter at atol
  2.5e-3, the JAX test's bounds. At crop 16 and S = 2 Conv5 (1 row) is
  computed whole;
- the same case under SGD with the U-Net in float64 on both sides, where a
  move is lr times the gradient (Adam's first move, about lr times its
  sign, hides a wrong gradient sum), against the JAX test's reference side,
  the unsharded JAX step: losses at rtol 2e-4, each parameter's move within
  1e-3 of its tensor's largest move, BN statistics at rtol 1e-4. (Under
  SGD in float64 the JAX step on the 4 x 2 mesh itself strays from the
  unsharded one far beyond these bounds at Conv4 and Up_conv5 on XLA's CPU
  devices, where in fp32 the two agree within fp32 noise; the port's split
  agrees with the unsharded step.);
- port against port on 4 ranks as 2 x 2 and as 1 x 4 (crop 32: Conv5's 2
  rows computed whole), ``uda``, ``partial``, ``entropy`` and
  ``meanteacher``, a padded batch (2 + 3 padded to 2 + 4) and the
  device-data step (2 x 2, injected draws), each against the one-process
  step with a flip mask that flips H on every unlabeled row: every metric at
  rtol 2e-4 (atol 1e-7), the dice sums exactly, the summed gradients within
  1e-3 of each tensor's largest entry, BN statistics (and the teacher's) at
  rtol 1e-4, the teacher's parameters after its EMA update within 2.05 lr
  (Adam's first move is about lr times the gradient's sign). The U-Net
  runs in float64 on both sides, as the rank tests of
  ``test_torch_distributed.py`` run it (fp32 ties in max-pool windows and
  ReLUs make a step's gradients depend on the summation order);
- the exchanges' forward and backward at S = 2 and 3, in float64 and in
  bf16, against the same functions of the whole map under autograd;
- the whole-level rule (``models/unet.py:band_levels``), and the named
  refusals: the s2d stem on bands of odd rows, a model of the zoo other
  than the U-Net, an H the bands cannot split. The IIC modes, remat and s2d
  under the split are held in ``tests/test_torch_space_iic.py``, the tiled
  IIC and the halo deeper than a band in ``tests/test_torch_space_tiles.py``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

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
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import UNet, get_arch
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models.unet import band_levels
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.augment_device import (
    sample_augment_params,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    DistContext,
    batch_sharding,
    local_band,
    shard_batch,
    split_context,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun import run_ranks
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.halo import (
    SpaceSplitUnsupported,
    band_slice,
    flip_bands,
    gather_h,
    halo_exchange,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP, C = 32, 3
STEP_KW = {"uda": dict(uda_criterion="mse", reg_weight=5.0),
           "partial": dict(reg_weight=0.0),
           "entropy": dict(reg_weight=0.5),
           "meanteacher": dict(uda_criterion="mse", reg_weight=10.0, ema_alpha=0.999,
                               ema_weight_decay=1e-4)}
LAYOUTS = {"2x2": 2, "1x4": 4}  # data x space on 4 ranks: the space size
STEP_CASES = [(layout, mode) for layout in LAYOUTS for mode in STEP_KW] + [("2x2", "padded")]
JAX_CROP, JAX_BATCH, JAX_SPACE = 16, 8, 2
SGD_LR = 0.1
# the JAX cases: each one's optimizer and whether the U-Net computes in float64
JAX_CASES = {"adam": ({"name": "Adam", "lr": 1e-3}, False),
             "sgd": ({"name": "SGD", "lr": SGD_LR}, True)}


def _batch(n_lab, n_unlab, crop=CROP, seed=3):
    """A float64 batch and a flip mask that flips H on every unlabeled row
    (W at random)."""
    rng = np.random.default_rng(seed)
    batch = {"labeled_image": rng.random((n_lab, crop, crop, 1)),
             "labeled_target": rng.integers(0, C, (n_lab, crop, crop)).astype(np.int32),
             "unlabeled_image": rng.random((n_unlab, crop, crop, 1))}
    flips = np.stack([np.ones(n_unlab, bool), rng.random(n_unlab) < 0.5], 1)
    return batch, flips


def _pad(a, n):
    return np.concatenate([a, np.repeat(a[-1:], n - len(a), 0)])


def _build(mode, context=None, n_valid=(None, None), data_store=None, classes=C):
    """The mode's float64 U-Net (and teacher), Adam and step from seed 0."""
    torch.manual_seed(0)
    f64 = dict(dtype=torch.float64, bn_dtype=torch.float64)
    model = UNet(1, classes, **f64).double()
    teacher = None
    if mode == "meanteacher":
        teacher = UNet(1, classes, **f64).double().requires_grad_(False)
        teacher.load_state_dict(model.state_dict())
    opt = build_optimizer(list(model.parameters()), {"name": "Adam", "lr": 1e-3,
                                                    "weight_decay": 1e-5})
    step = build_train_step(model, opt, mode, num_classes=classes, generator=torch.Generator(),
                            teacher=teacher, context=context, n_labeled_valid=n_valid[0],
                            n_unlabeled_valid=n_valid[1], data_store=data_store, crop=CROP,
                            **STEP_KW[mode])
    return model, teacher, step


def _state(model, teacher, metrics):
    out = {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
           "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
           "buffers": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}}
    if teacher is not None:
        out["teacher"] = {k: v.clone() for k, v in teacher.state_dict().items()}
    return out


def _step(mode, ctx=None):
    """One step of ``mode`` (``padded``: uda on 2 + 3 padded to 2 + 4) on
    the rank's rows and band, or in one process without ``ctx``."""
    padded = mode == "padded"
    mode = "uda" if padded else mode
    batch, flips = _batch(2, 3 if padded else 2)
    n_valid = (None, None)
    if padded and ctx is not None:
        batch = {k: _pad(v, 4) if k.startswith("unlabeled") else v for k, v in batch.items()}
        flips, n_valid = _pad(flips, 4), (2, 3)
    model, teacher, step = _build(mode, ctx, n_valid)
    metrics = step(batch_sharding(batch, ctx), flip_mask=torch.from_numpy(flips))
    return _state(model, teacher, metrics)


def _store(root):
    return DeviceDataStore(ACDCDataset(str(root), "train"), pack=True)


LAB_IDX, UNLAB_IDX = [1, 7], [0, 5]


def _device_step(root, ctx=None):
    """uda on the device-data path: the global indices, injected draws, the
    rank's rows augmented whole and its band kept."""
    store = _store(root)
    lab, unlab = torch.tensor(LAB_IDX), torch.tensor(UNLAB_IDX)
    gen = torch.Generator().manual_seed(5)
    draws = {k: sample_augment_params(gen, len(i), store.shape, crop=CROP,
                                      valid_hw=store.valid_hw_dev[i], offsets=store.offsets_dev[i])
             for k, i in (("labeled", lab), ("unlabeled", unlab))}
    model, teacher, step = _build("uda", ctx, data_store=store, classes=4)
    _, flips = _batch(2, 2)
    metrics = step({"labeled_indices": lab, "unlabeled_indices": unlab},
                   flip_mask=torch.from_numpy(flips), aug_params=draws)
    return _state(model, teacher, metrics)


# --- the exchanges against the whole map ------------------------------------
EXCHANGE_ROWS = 4  # a band's rows


EXCHANGE_DTYPES = {"float64": torch.float64, "bfloat16": torch.bfloat16}


def _whole_map(space_size, dtype, seed=11):
    g = torch.Generator().manual_seed(seed)
    shape = (2, 3, EXCHANGE_ROWS * space_size, 5)
    return torch.rand(shape, generator=g, dtype=torch.float64).to(EXCHANGE_DTYPES[dtype])


def _upstream(shape, space_rank, kind, dtype):
    g = torch.Generator().manual_seed(100 * space_rank + len(kind))
    return torch.rand(shape, generator=g, dtype=torch.float64).to(EXCHANGE_DTYPES[dtype])


def _exchanges(ctx):
    """Each exchange's output and input gradient on this rank's band of
    ``_whole_map`` in float64 and in bf16 (which travels as fp32) for an
    upstream gradient drawn from its space rank: the one-row halo along
    dim 2, the band swap along dim 1 (of the map as [B, H, W, C]), the
    whole-map gather along dim 2."""
    out = {}
    for dtype in EXCHANGE_DTYPES:
        whole = _whole_map(ctx.space_size, dtype)
        for kind, fn in (("halo", lambda x: halo_exchange(x, ctx, 2)),
                         ("flip", lambda x: flip_bands(x, ctx, 1)),
                         ("gather", lambda x: gather_h(x, ctx, 2))):
            src = whole.permute(0, 2, 3, 1) if kind == "flip" else whole
            x = local_band(src, ctx, 1 if kind == "flip" else 2).clone().requires_grad_(True)
            y = fn(x)
            y.backward(_upstream(y.shape, ctx.space_rank, kind, dtype))
            out[kind, dtype] = (y.detach(), x.grad)
    return out


def _exchange_reference(kind, space_size, dtype):
    """(per space rank: the output, the input gradient) of the same
    functions on the whole map (its values in ``dtype``) under float64
    autograd: the objective is the sum over the space ranks of each output
    against its upstream gradient."""
    whole = _whole_map(space_size, dtype).double()
    src = (whole.permute(0, 2, 3, 1) if kind == "flip" else whole).clone().requires_grad_(True)
    h = EXCHANGE_ROWS
    outs = []
    for s in range(space_size):
        if kind == "halo":
            outs.append(F.pad(src, (0, 0, 1, 1))[:, :, s * h:(s + 1) * h + 2])
        elif kind == "flip":
            outs.append(src.flip(1)[:, s * h:(s + 1) * h])
        else:
            outs.append(src)
    total = sum((o * _upstream(o.shape, s, kind, dtype).double()).sum()
                for s, o in enumerate(outs))
    total.backward()
    dim = 1 if kind == "flip" else 2
    return [(o.detach(), src.grad.narrow(dim, s * h, h)) for s, o in enumerate(outs)]


# --- the worlds -------------------------------------------------------------
def _world4_rank(ctx, root):
    """Every case of the 4-rank world: the 2 x 2 and 1 x 4 steps, the
    device-data step, the exchanges at S = 2 (the 2 x 2 layout's space
    groups) and S = 3 (ranks 0-2; rank 3 makes the group and waits)."""
    grids = {name: split_context(ctx, s) for name, s in LAYOUTS.items()}
    out = {"steps": {(layout, mode): _step(mode, grids[layout]) for layout, mode in STEP_CASES},
           "device": _device_step(root, grids["2x2"]),
           "exchanges": {2: _exchanges(grids["2x2"])},
           "space_rank": {name: g.space_rank for name, g in grids.items()}}
    three = dist.new_group([0, 1, 2])
    if ctx.rank < 3:
        sub = DistContext(world=3, rank=ctx.rank, space_size=3, space_group=three, split_h=True)
        out["exchanges"][3] = _exchanges(sub)
    ctx.barrier()
    return out


def _jax_rank(ctx, weights, batch, flips):
    """The JAX test's uda step on the rank's rows and band (4 x 2), from the
    JAX init and the JAX flip draw of each case: ``adam`` (fp32 U-Net, the
    JAX test's own) and ``sgd`` (float64 U-Net)."""
    grid = split_context(ctx, JAX_SPACE)
    out = {}
    for case, (optim, f64) in JAX_CASES.items():
        torch.manual_seed(0)
        model = (UNet(1, C, dtype=torch.float64, bn_dtype=torch.float64).double() if f64
                 else UNet(1, C))
        model.load_state_dict(weights)
        opt = build_optimizer(list(model.parameters()), optim)
        step = build_train_step(model, opt, "uda", num_classes=C, generator=torch.Generator(),
                                context=grid, uda_criterion="mse", reg_weight=5.0)
        metrics = step(batch_sharding(batch, grid), flip_mask=torch.from_numpy(flips[case]))
        out[case] = {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
                     "state": {k: v.clone() for k, v in model.state_dict().items()}}
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_space_torch")
    generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def world4(data_root, tmp_path_factory):
    return run_ranks(_world4_rank, 4, str(data_root), timeout=120,
                     workdir=str(tmp_path_factory.mktemp("space4")))


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    """The JAX test's setup and its space-sharded step, and the port's 8
    ranks from the same start. JAX is imported here only: the ranks import
    this module."""
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
        build_optimizer as j_build_optimizer,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import (
        init_train_state,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
        build_train_step as j_build_train_step,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.models import UNet as JUNet
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
        sample_flip_mask as j_sample_flip_mask,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.parallel import (
        batch_sharding as j_batch_sharding,
        make_mesh,
        replicate_state,
    )
    from test_torch_step import _np_tree, _port_state

    rng = np.random.default_rng(0)  # tests/conftest.py's ``rng``
    n, crop = JAX_BATCH, JAX_CROP
    batch = {"labeled_image": rng.random((n, crop, crop, 1)).astype(np.float32),
             "labeled_target": rng.integers(0, C, (n, crop, crop)).astype(np.int32),
             "unlabeled_image": rng.random((n, crop, crop, 1)).astype(np.float32)}
    mesh = make_mesh(8, space_axis="space", space_size=JAX_SPACE)
    sharding = j_batch_sharding(mesh, space_axis="space")
    out, flips = {}, {}
    for case, (optim, f64) in JAX_CASES.items():
        tx = j_build_optimizer(optim)
        state = init_train_state(JUNet(input_dim=1, num_classes=C), tx, (1, crop, crop, 1),
                                 seed=0)
        weights = _port_state(_np_tree(state.params), _np_tree(state.batch_stats))
        jmodel = (JUNet(input_dim=1, num_classes=C, dtype=jnp.float64, bn_dtype=jnp.float64)
                  if f64 else JUNet(input_dim=1, num_classes=C))
        jstep = j_build_train_step(jmodel, tx, "uda", num_classes=C, uda_criterion="mse",
                                   reg_weight=5.0)
        with jax.enable_x64(f64):  # the mask the step draws (its uniforms follow x64)
            _, flip_key = jax.random.split(state.rng)  # the draw the JAX step makes
            flips[case] = np.array(j_sample_flip_mask(flip_key, n, 0.8))
            if f64:  # the unsharded step (the module docstring)
                state1, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            else:
                state1, jm = jstep(replicate_state(state, mesh),
                                   {k: jax.device_put(jnp.asarray(v), sharding)
                                    for k, v in batch.items()})
            out[case] = {"metrics": {k: np.asarray(v) for k, v in jm.items()}, "before": weights,
                         "after": _port_state(_np_tree(state1.params),
                                              _np_tree(state1.batch_stats))}
    # weights: the init of seed 0, the same in both cases
    ranks = run_ranks(_jax_rank, 8, weights, batch, flips, timeout=120,
                      workdir=str(tmp_path_factory.mktemp("space8")))
    for case in JAX_CASES:
        out[case]["ranks"] = [r[case] for r in ranks]
    return out


# --- the checks -------------------------------------------------------------
def _check_step(ref, got, n_lab=2):
    assert set(ref["metrics"]) == set(got["metrics"])
    for k, v in ref["metrics"].items():
        if k.startswith("sup_dice"):
            np.testing.assert_array_equal(got["metrics"][k][:n_lab], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    assert set(ref["grads"]) == set(got["grads"])
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * float(g.abs().max()) + 1e-12, err_msg=k)
    for k, v in ref["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, v in ref.get("teacher", {}).items():  # its parameters: the student's Adam move
        if v.is_floating_point():
            np.testing.assert_allclose(got["teacher"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6 if "running_" in k else 2.05e-3,
                                       err_msg=f"teacher {k}")


@pytest.mark.parametrize("layout,mode", STEP_CASES)
def test_split_step_matches_one_process(layout, mode, world4):
    ref = _step(mode)
    for rank, r in enumerate(world4):
        assert r["space_rank"][layout] == rank % LAYOUTS[layout]
        _check_step(ref, r["steps"][(layout, mode)])


def test_split_device_data_step_matches_one_process(world4, data_root):
    ref = _device_step(data_root)
    for r in world4:
        _check_step(ref, r["device"])


@pytest.mark.parametrize("dtype", list(EXCHANGE_DTYPES))
@pytest.mark.parametrize("space_size", [2, 3])
@pytest.mark.parametrize("kind", ["halo", "flip", "gather"])
def test_exchange_matches_whole_map(kind, space_size, dtype, world4):
    """Outputs exactly; input gradients at 1e-12 in float64, and in bf16
    within the rounding of one bf16 sum (2^-8 relative: a halo row's
    gradient adds a neighbour's)."""
    want = _exchange_reference(kind, space_size, dtype)
    tol = 1e-12 if dtype == "float64" else 2.0 ** -8
    ranks = world4[:space_size]  # the first space group of either layout
    for s, r in enumerate(ranks):
        y, dx = r["exchanges"][space_size][kind, dtype]
        assert y.dtype == dx.dtype == EXCHANGE_DTYPES[dtype]
        torch.testing.assert_close(y.double(), want[s][0], rtol=0, atol=0)
        torch.testing.assert_close(dx.double(), want[s][1], rtol=tol, atol=1e-12)


def test_jax_space_sharded_step(jax_case):
    """The JAX test's case on 4 x 2 ranks against the JAX step on the 4 x 2
    mesh at the JAX test's bounds; the U-Net's flax <-> torch map of
    ``weights.py`` serves the split as it is (no new map)."""
    case = jax_case["adam"]
    for r in case["ranks"]:
        for key in ("sup_loss", "total_loss"):
            np.testing.assert_allclose(r["metrics"][key], float(case["metrics"][key]),
                                       rtol=1e-4, err_msg=key)
        for k, v in case["after"].items():
            if "running_" not in k and "num_batches" not in k:
                np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(), rtol=0,
                                           atol=2.5e-3, err_msg=k)


def test_split_matches_jax_step_under_sgd(jax_case):
    """The same case under SGD with both U-Nets in float64, where a
    parameter's move is lr times its gradient (Adam's first move, about lr
    times the gradient's sign, hides a wrong sum): the halo, band swap and
    gather backwards and the BN groups of the banded and the whole levels
    (Conv5, 1 row, is computed whole) held against the unsharded JAX step,
    the reference side of the JAX test (the module docstring). Losses at
    rtol 2e-4, each parameter's move within 1e-3 of its tensor's largest
    move, the BN statistics at rtol 1e-4."""
    case = jax_case["sgd"]
    for r in case["ranks"]:
        for key in ("sup_loss", "uda", "total_loss"):
            np.testing.assert_allclose(r["metrics"][key], float(case["metrics"][key]),
                                       rtol=2e-4, atol=1e-7, err_msg=key)
        for k, p0 in case["before"].items():
            after = case["after"][k].numpy()
            if "running_" in k:
                np.testing.assert_allclose(r["state"][k].numpy(), after, rtol=1e-4, atol=1e-6,
                                           err_msg=k)
            elif "num_batches" not in k:
                move = after - p0.double().numpy()
                port_move = (r["state"][k] - p0.double()).numpy()
                np.testing.assert_allclose(port_move, move, rtol=0,
                                           atol=1e-3 * float(np.abs(move).max()) + 1e-12,
                                           err_msg=k)


@pytest.mark.parametrize("height,space_size,levels", [
    (16, 2, 4), (224, 4, 4), (32, 4, 4), (32, 2, 5), (224, 2, 5), (12, 3, 3), (64, 8, 4)])
def test_band_levels_rule(height, space_size, levels):
    assert band_levels(height, space_size) == levels


def _fake_split(world=2, rank=0, space_size=2):
    """A split context without groups: the refusals come before any collective."""
    return DistContext(world=world, rank=rank, space_size=space_size, split_h=True)


def _build_split(model, mode="uda", **kw):
    opt = build_optimizer(list(model.parameters()), {"name": "Adam", "lr": 1e-3})
    return build_train_step(model, opt, mode, num_classes=C, generator=torch.Generator(),
                            context=_fake_split(), **kw)


@pytest.mark.parametrize("case", ["s2d_odd_band", "enet", "unsplit_h"])
def test_split_refusals(case):
    """What the H split does not run raises ``SpaceSplitUnsupported``, naming
    it, before any collective: the s2d stem on bands of odd rows, a model of
    the zoo; and an H the bands cannot split raises ``ValueError``."""
    if case == "s2d_odd_band":
        model = UNet(1, C, stem="s2d")
        with pytest.raises(SpaceSplitUnsupported, match="bands of 5 rows"):
            model(torch.zeros(1, 5, 16, 1), space=_fake_split())
    elif case == "enet":
        with pytest.raises(SpaceSplitUnsupported, match="ENet"):
            _build_split(get_arch("enet", {"input_dim": 1, "num_classes": C}))
    else:
        ctx = _fake_split(world=4, rank=1, space_size=4)
        batch = {"labeled_image": np.zeros((2, 18, 16, 1), np.float32)}
        with pytest.raises(ValueError, match="H = 18 does not split into 4"):
            batch_sharding(batch, ctx)
        with pytest.raises(ValueError, match="H = 18"):
            band_levels(18, 4)


def test_without_the_split_the_context_is_unchanged():
    """A context without the split (every context ``init_distributed``
    returns) keeps whole rows: no band, ``batch_sharding`` is
    ``shard_batch``; a split context's bands tile H in space-rank order."""
    plain = DistContext(world=4, rank=3, space_size=2)
    assert plain.space_rank == 1 and plain.band(16) == slice(0, 16)
    x = np.arange(2 * 16 * 4).reshape(2, 16, 4, 1)
    assert local_band(x, plain) is x
    got, want = batch_sharding({"x": x}, None), shard_batch({"x": x}, None)
    assert torch.equal(got["x"], want["x"])
    bands = [_fake_split(world=4, rank=r, space_size=4).band(16) for r in range(4)]
    assert bands == [slice(0, 4), slice(4, 8), slice(8, 12), slice(12, 16)]
    whole = torch.arange(16.0).reshape(1, 1, 16, 1)
    assert torch.equal(torch.cat([band_slice(whole, _fake_split(4, r, 4)) for r in range(4)], 2),
                       whole)
