"""The IIC modes under the port's spatial H split (``engine/steps.py``
``iic_regularization`` on bands, ``parallel/halo.py``'s halo of p rows, the
band-aware window of ``ops/mi_fused.py``), s2d and remat on bands, on gloo
ranks on the CPU, against the JAX package's ``batch_sharding(mesh,
space_axis="space")`` step and against the port's one-process step.

Each module fixture spawns its world once (``parallel/dryrun.py:run_ranks``,
one process a rank, every join under a timeout) and runs every case of
that world. Held:

- (a) the JAX package's udaiic case (``tests/test_parallel.py``'s
  ``_udaiic_setup``: crop 16, Conv5 + Up_conv2 heads of 2 x 5 clusters,
  padding 1, ``backend="xla"``, Adam at 1e-3, every unlabeled row flipped)
  on 8 + 8 slices, on 4 x 2 ranks from the JAX init and the JAX flip draw,
  against the JAX step on ``make_mesh(8, space_axis="space",
  space_size=2)`` with the batch placed by ``batch_sharding``:
  ``sup_loss``, ``mi`` and ``total_loss`` at rtol 1e-4, every parameter,
  the projector's too, at atol 2.5e-3 (Up_conv2's bands hold 8 rows; Conv5,
  1 row, is computed whole);
- (b) the same case under SGD with the U-Net in float64 on both sides (a
  move is lr times the gradient; Adam's first move, about lr times its
  sign, hides a wrong gradient sum) against the unsharded JAX step: ``mi``
  at rtol 2e-4, each parameter's move, the projector's included, within
  1e-3 of its tensor's largest move;
- (c) port against the one-process port at crop 32 with the headline taps
  Conv5 / Up_conv3 / Up_conv2 at paddings [1, 3], on 4 ranks as 2 x 2
  (every level on bands: Conv5's 2 rows split) and as 1 x 4 (Conv5 whole):
  ``iic`` and ``udaiic``; the ``xla``, ``xla_banded``, ``xla_scan``,
  ``auto`` and ``pallas`` backends (the kernels' plain versions on the
  CPU) and ``pallas_fused`` (the fused kernels' plain version); flat and
  5-D heads; a padded batch (2 + 3 padded to 2 + 4); the device-data path.
  Each tap's joint summed over the world (the decoder taps' raw [S, T, T,
  K, K] sums, the encoder's normalized [K, K] joints) at rtol 1e-6, every
  metric at rtol 2e-4, the dice sums exactly, the summed gradients within
  1e-3 of each tensor's largest entry. The U-Net runs in float64 on both
  sides (fp32 ties in max-pool windows and ReLUs make a step's gradients
  depend on the summation order), the heads and joints in fp32. The Conv5
  head's weights are scaled by 30: at init its MI is ~1e-7 and its
  gradient sits at the fp32 rounding of the pooled vectors, which a band's
  sum (2 x 2: Conv5 on bands) rounds otherwise than the whole map's mean
  (4% of the head's bias gradient unscaled, in every 2 x 2 case);
- (d) the fused kernels' plain forward and backward on S = 2 and 3 bands,
  each with its window of live rows for l1 (the halo rows, but the map's
  ends), against the whole map: J summed over the bands, dl1 and dl2
  reassembled, at 128 and 256 lanes, with fp32 and bf16 products; the
  unsplit window gives the output without one bit for bit;
- (e) ``halo_exchange`` with 1 to 3 rows and with one row more than a band
  holds, forward and backward, against the same function of the whole map
  under autograd, at S = 2 and 4;
- (f) s2d and remat split steps (udaiic) against one process, in both
  layouts; and a decoder tap computed whole under the split (Up_conv5 at
  crop 16 over 4 bands: its joint summed over the data group, as the
  encoder's).
"""

from itertools import chain

import numpy as np
import pytest
import torch
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
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic as iic_mod
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic_local as til
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_fused
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.augment_device import (
    sample_augment_params,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    batch_sharding,
    local_band,
    split_context,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun import run_ranks
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.halo import (
    halo_exchange,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP, C = 32, 3
FEATS = ("Conv5", "Up_conv3", "Up_conv2")
IMPORTANCE = [1.0, 0.5, 0.5]
SUBHEADS, CLUSTERS = 2, 5
STEP_KW = dict(uda_criterion="mse", uda_weight=5.0, iic_weight=0.5, reg_weight=1.0,
               paddings=[1, 3], patch_sizes=1024)
LAYOUTS = {"2x2": 2, "1x4": 4}  # data x space on 4 ranks: the space size
HEAD_SCALE = 30.0  # the Conv5 head's weights times this (chip_smoke.py's PAR_HEAD_SCALE)
# (layout, mode, backend, heads, variant): variant "" (a tensor batch),
# "padded", "device", "s2d", "remat" or "whole" (taps WHOLE_FEATS at crop
# WHOLE_CROP: over 4 bands Up_conv5's 2 rows are computed whole)
PORT_CASES = (
    [(lay, mode, "xla", "flat", "") for lay in LAYOUTS for mode in ("iic", "udaiic")]
    + [(lay, "udaiic", "auto", "flat", "") for lay in LAYOUTS]
    + [("2x2", "udaiic", "xla", "5d", ""), ("1x4", "udaiic", "auto", "5d", ""),
       ("2x2", "udaiic", "xla_banded", "flat", ""), ("1x4", "udaiic", "xla_scan", "5d", ""),
       ("1x4", "iic", "pallas", "flat", ""),
       ("2x2", "udaiic", "pallas_fused", "flat", ""), ("1x4", "iic", "pallas_fused", "flat", ""),
       ("2x2", "udaiic", "xla", "flat", "padded"), ("2x2", "udaiic", "auto", "flat", "device")]
    + [(lay, "udaiic", backend, "flat", variant) for variant, backend in (("s2d", "xla"),
                                                                         ("remat", "auto"))
       for lay in LAYOUTS]
    + [("1x4", "udaiic", "auto", "flat", "whole")])
WHOLE_FEATS, WHOLE_CROP = ("Conv5", "Up_conv5", "Up_conv2"), 16
CASE_IDS = ["-".join(x for x in case if x) for case in PORT_CASES]
JAX_CROP, JAX_BATCH, JAX_SPACE = 16, 8, 2
JAX_FEATS = ("Conv5", "Up_conv2")
JAX_KW = dict(uda_criterion="mse", uda_weight=5.0, iic_weight=0.5, reg_weight=1.0,
              paddings=[1], patch_sizes=1024, backend="xla")
SGD_LR = 0.1
# the JAX cases: each one's optimizer and whether the U-Net computes in float64
JAX_CASES = {"adam": ({"name": "Adam", "lr": 1e-3}, False),
             "sgd": ({"name": "SGD", "lr": SGD_LR}, True)}


# --- the joints a step sums --------------------------------------------------
class _Joints:
    """Records each joint a step's IIC losses reach, summed over their
    group, in the order the step computes them: an encoder subhead's
    normalized [K, K] (``ops/iic.py:compute_joint``), a decoder tap's raw
    [S, T, T, K, K] (what ``ops/iic_local.py:mi_from_joint`` receives)."""

    def __enter__(self):
        self.joints, self._saved = [], (iic_mod.compute_joint, til.mi_from_joint)
        compute_joint, mi_from_joint = self._saved

        def joint(*args, **kwargs):
            out = compute_joint(*args, **kwargs)
            self.joints.append(out.detach().clone())
            return out

        def mi(j, *args, **kwargs):
            self.joints.append(j.detach().clone())
            return mi_from_joint(j, *args, **kwargs)

        iic_mod.compute_joint, til.mi_from_joint = joint, mi
        return self

    def __exit__(self, *exc):
        iic_mod.compute_joint, til.mi_from_joint = self._saved


# --- (c), (f): port against port --------------------------------------------
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


def _build(mode, backend, heads, variant, context=None, n_valid=(None, None), data_store=None,
           classes=C):
    """The float64 U-Net, the fp32 heads, Adam and the step from seed 0."""
    feats = WHOLE_FEATS if variant == "whole" else FEATS
    torch.manual_seed(0)
    model = UNet(1, classes, dtype=torch.float64, bn_dtype=torch.float64,
                 stem="s2d" if variant == "s2d" else "conv", remat=variant == "remat").double()
    fused = backend == "pallas_fused"
    proj = ProjectorWrapper(feats, num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                            local_flat=heads == "flat", local_emit_logits=fused)
    with torch.no_grad():  # lift the Conv5 term out of fp32 noise (the module docstring)
        proj.heads["Conv5"].linear.weight.mul_(HEAD_SCALE)
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
    kw = dict(STEP_KW, paddings=[1, 1] if variant == "whole" else [1, 3])
    if mode == "iic":
        kw = dict(paddings=[1, 3], patch_sizes=1024, reg_weight=0.5)
    step = build_train_step(model, opt, mode, num_classes=classes, generator=torch.Generator(),
                            feature_names=feats, feature_importance=IMPORTANCE, projector=proj,
                            backend="auto" if fused else backend, context=context,
                            n_labeled_valid=n_valid[0], n_unlabeled_valid=n_valid[1],
                            data_store=data_store, crop=CROP, **kw)
    return model, proj, step


def _state(model, proj, metrics, joints):
    named = list(chain(model.named_parameters(), proj.named_parameters(prefix="proj")))
    return {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in named if p.grad is not None},
            "buffers": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k},
            "joints": joints}


def _store(root):
    return DeviceDataStore(ACDCDataset(str(root), "train"), pack=True)


LAB_IDX, UNLAB_IDX = [1, 7], [0, 5]


def _port_step(case, ctx=None, root=None):
    """One step of ``case`` on the rank's rows and band, or in one process
    without ``ctx``."""
    _, mode, backend, heads, variant = case
    batch, flips = _batch(2, 3 if variant == "padded" else 2,
                          crop=WHOLE_CROP if variant == "whole" else CROP)
    n_valid, store, aug = (None, None), None, None
    if variant == "padded" and ctx is not None:
        batch = {k: _pad(v, 4) if k.startswith("unlabeled") else v for k, v in batch.items()}
        flips, n_valid = _pad(flips, 4), (2, 3)
    if variant == "device":
        store = _store(root)
        gen = torch.Generator().manual_seed(5)
        aug = {k: sample_augment_params(gen, len(i), store.shape, crop=CROP,
                                        valid_hw=store.valid_hw_dev[i],
                                        offsets=store.offsets_dev[i])
               for k, i in (("labeled", torch.tensor(LAB_IDX)),
                            ("unlabeled", torch.tensor(UNLAB_IDX)))}
        batch = {"labeled_indices": torch.tensor(LAB_IDX),
                 "unlabeled_indices": torch.tensor(UNLAB_IDX)}
    else:
        batch = batch_sharding(batch, ctx)
    model, proj, step = _build(mode, backend, heads, variant, ctx, n_valid, store,
                               classes=4 if store is not None else C)
    with _Joints() as rec:
        metrics = step(batch, flip_mask=torch.from_numpy(flips), aug_params=aug)
    return _state(model, proj, metrics, rec.joints)


# --- (e): the halo of p rows against the whole map ---------------------------
HALO_ROWS = 4  # a band's rows


def _whole(space_size, seed=11):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((2, 3, HALO_ROWS * space_size, 5), generator=g, dtype=torch.float64)


def _upstream(shape, space_rank, rows):
    g = torch.Generator().manual_seed(100 * space_rank + rows)
    return torch.rand(shape, generator=g, dtype=torch.float64)


def _halos(ctx):
    """The halo of 1 to 3 rows and of HALO_ROWS + 1 (past the neighbouring
    band) along dim 2: each one's output and input gradient on this rank's
    band for an upstream gradient drawn from its space rank."""
    out = {}
    whole = _whole(ctx.space_size)
    for rows in (1, 2, 3, HALO_ROWS + 1):
        x = local_band(whole, ctx, 2).clone().requires_grad_(True)
        y = halo_exchange(x, ctx, 2, rows=rows)
        y.backward(_upstream(y.shape, ctx.space_rank, rows))
        out[rows] = (y.detach(), x.grad)
    return out


def _halo_reference(space_size, rows):
    whole = _whole(space_size).clone().requires_grad_(True)
    h = HALO_ROWS
    outs = [F.pad(whole, (0, 0, rows, rows))[:, :, s * h:(s + 1) * h + 2 * rows]
            for s in range(space_size)]
    sum((o * _upstream(o.shape, s, rows)).sum() for s, o in enumerate(outs)).backward()
    return [(o.detach(), whole.grad.narrow(2, s * h, h)) for s, o in enumerate(outs)]


# --- the worlds ---------------------------------------------------------------
def _world4_rank(ctx, root):
    grids = {name: split_context(ctx, s) for name, s in LAYOUTS.items()}
    out = {"steps": {case: _port_step(case, grids[case[0]], root) for case in PORT_CASES},
           "halos": {s: _halos(grids[name]) for name, s in LAYOUTS.items()},
           "space_rank": {name: g.space_rank for name, g in grids.items()}}
    ctx.barrier()
    return out


def _jax_rank(ctx, weights, batch, flips, kw=JAX_KW):
    """The JAX udaiic case (step options ``kw``) on the rank's rows and band
    (4 x 2), from the JAX init and the JAX flip draw: ``adam`` (fp32 U-Net,
    the JAX case's own) and ``sgd`` (float64 U-Net)."""
    grid = split_context(ctx, JAX_SPACE)
    out = {}
    for case, (optim, f64) in JAX_CASES.items():
        torch.manual_seed(0)
        model = (UNet(1, C, dtype=torch.float64, bn_dtype=torch.float64).double() if f64
                 else UNet(1, C))
        proj = ProjectorWrapper(JAX_FEATS, num_clusters=5, num_subheads=2)
        model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("proj.")})
        proj.load_state_dict({k[5:]: v for k, v in weights.items() if k.startswith("proj.")})
        opt = build_optimizer(list(chain(model.parameters(), proj.parameters())), optim)
        step = build_train_step(model, opt, "udaiic", num_classes=C, generator=torch.Generator(),
                                context=grid, feature_names=JAX_FEATS,
                                feature_importance=[1.0, 1.0], projector=proj, **kw)
        metrics = step(batch_sharding(batch, grid), flip_mask=torch.from_numpy(flips[case]))
        state = dict(model.state_dict())
        state.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
        out[case] = {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
                     "state": {k: v.clone() for k, v in state.items()}}
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_space_iic_torch")
    generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def world4(data_root, tmp_path_factory):
    return run_ranks(_world4_rank, 4, str(data_root), timeout=300,
                     workdir=str(tmp_path_factory.mktemp("space_iic4")))


@pytest.fixture(scope="module")
def jax_case(tmp_path_factory):
    return jax_split_case(tmp_path_factory, JAX_KW, "space_iic8")


def jax_split_case(tmp_path_factory, kw, tag):
    """The JAX udaiic case with step options ``kw``: its space-sharded step
    (Adam) and its unsharded float64 step (SGD), and the port's 8 ranks from
    the same start. JAX is imported here only: the ranks import this
    module."""
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
    from mi_based_regularized_semi_supervised_segmentation_tpu.models import (
        ProjectorWrapper as JProjector,
        UNet as JUNet,
    )
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
    jproj = JProjector(feature_names=JAX_FEATS, num_clusters=5, num_subheads=2,
                       head_types="linear", normalize=False, local_flat=True)
    out, flips = {}, {}
    for case, (optim, f64) in JAX_CASES.items():
        tx = j_build_optimizer(optim)
        state = init_train_state(JUNet(input_dim=1, num_classes=C), tx, (1, crop, crop, 1),
                                 seed=0, projector=jproj, projector_feature_names=JAX_FEATS)
        weights = _port_state(_np_tree(state.params), _np_tree(state.batch_stats))
        jmodel = (JUNet(input_dim=1, num_classes=C, dtype=jnp.float64, bn_dtype=jnp.float64)
                  if f64 else JUNet(input_dim=1, num_classes=C))
        jstep = j_build_train_step(jmodel, tx, "udaiic", num_classes=C, projector=jproj,
                                   feature_names=JAX_FEATS, feature_importance=[1.0, 1.0],
                                   flip_threshold=1.0, **kw)
        with jax.enable_x64(f64):  # the mask the step draws (its uniforms follow x64)
            _, flip_key = jax.random.split(state.rng)  # the draw the JAX step makes
            flips[case] = np.array(j_sample_flip_mask(flip_key, n, 1.0))
            if f64:  # the unsharded step
                state1, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
            else:
                state1, jm = jstep(replicate_state(state, mesh),
                                   {k: jax.device_put(jnp.asarray(v), sharding)
                                    for k, v in batch.items()})
            out[case] = {"metrics": {k: np.asarray(v) for k, v in jm.items()}, "before": weights,
                         "after": _port_state(_np_tree(state1.params),
                                              _np_tree(state1.batch_stats))}
    ranks = run_ranks(_jax_rank, 8, out["adam"]["before"], batch, flips, kw, timeout=300,
                      workdir=str(tmp_path_factory.mktemp(tag)))
    for case in JAX_CASES:
        out[case]["ranks"] = [r[case] for r in ranks]
    return out


# --- the checks -----------------------------------------------------------------
def _check_joints(ref, got):
    assert len(ref) == len(got) and ref
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(r.abs().max()), err_msg=f"joint {i}")


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
    _check_joints(ref["joints"], got["joints"])


@pytest.mark.parametrize("case", PORT_CASES, ids=CASE_IDS)
def test_iic_split_step_matches_one_process(case, world4, data_root):
    """(c) and (f): the split step of each case against one process."""
    ref = _port_step(case, root=data_root)
    for rank, r in enumerate(world4):
        assert r["space_rank"][case[0]] == rank % LAYOUTS[case[0]]
        _check_step(ref, r["steps"][case])


@pytest.mark.parametrize("space_size", list(LAYOUTS.values()))
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_halo_of_rows_matches_whole_map(rows, space_size, world4):
    """(e): outputs exactly, input gradients at 1e-12; so is the halo of
    HALO_ROWS + 1 rows, which reaches past the neighbouring band."""
    for n in (rows, HALO_ROWS + 1):
        want = _halo_reference(space_size, n)
        for s, r in enumerate(world4[:space_size]):  # the first space group of the layout
            y, dx = r["halos"][space_size][n]
            torch.testing.assert_close(y, want[s][0], rtol=0, atol=0)
            torch.testing.assert_close(dx, want[s][1], rtol=1e-12, atol=1e-12)


def check_jax_adam(case):
    """The port's ranks against the JAX space-sharded step: ``sup_loss``,
    ``mi`` and ``total_loss`` at rtol 1e-4, every parameter at atol
    2.5e-3."""
    for r in case["ranks"]:
        for key in ("sup_loss", "mi", "total_loss"):
            np.testing.assert_allclose(r["metrics"][key], float(case["metrics"][key]),
                                       rtol=1e-4, err_msg=key)
        assert any(k.startswith("proj.") for k in case["after"])
        for k, v in case["after"].items():
            if "running_" not in k and "num_batches" not in k:
                np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(), rtol=0,
                                           atol=2.5e-3, err_msg=k)


def check_jax_sgd(case):
    """The port's float64 ranks against the unsharded float64 JAX step
    under SGD: the losses at rtol 2e-4, each parameter's move within 1e-3
    of its tensor's largest move."""
    for r in case["ranks"]:
        for key in ("sup_loss", "uda", "mi", "total_loss", "individual_mis/Conv5",
                    "individual_mis/Up_conv2"):
            np.testing.assert_allclose(r["metrics"][key], float(case["metrics"][key]),
                                       rtol=2e-4, atol=1e-7, err_msg=key)
        for k, p0 in case["before"].items():
            if "running_" in k or "num_batches" in k:
                continue
            move = case["after"][k].double().numpy() - p0.double().numpy()
            port_move = (r["state"][k].double() - p0.double()).numpy()
            np.testing.assert_allclose(port_move, move, rtol=0,
                                       atol=1e-3 * float(np.abs(move).max()) + 1e-12,
                                       err_msg=k)


def test_jax_udaiic_space_sharded_step(jax_case):
    """(a): the JAX udaiic case on 4 x 2 ranks against the JAX step on the
    4 x 2 mesh."""
    check_jax_adam(jax_case["adam"])


def test_udaiic_split_matches_jax_step_under_sgd(jax_case):
    """(b): the same case under SGD with both U-Nets in float64 against the
    unsharded JAX step: ``mi`` at rtol 2e-4, the other losses too, each
    parameter's move, the projector's included, within 1e-3 of its
    tensor's largest move."""
    check_jax_sgd(jax_case["sgd"])


# --- (d): the fused kernels' plain version on bands ----------------------------
FUSED_B, FUSED_H, FUSED_W, FUSED_P = 2, 6, 5, 2


def _logit_canvases(lanes, seed):
    """Two [B, Hp, Wp, lanes] logit canvases of a whole map (finite border
    logits, which the window masks; dead lanes from S*K on at float32 min)
    and the heads' S, K."""
    S, K = (5, 20) if lanes == 128 else (5, 30)
    g = torch.Generator().manual_seed(seed)
    p = FUSED_P
    shape = (FUSED_B, FUSED_H * 6 + 2 * p, FUSED_W + 2 * p, lanes)
    out = []
    for _ in range(2):
        x = torch.randn(shape, generator=g) * 3
        x[..., S * K:] = torch.finfo(torch.float32).min
        out.append(x)
    return out, S, K


def _bands(l1, l2, space_size):
    """Each band's (l1 canvas with its halo, l2 canvas on its border, l1's
    window), from the whole map's canvases (rows [p, p + H) the map)."""
    p = FUSED_P
    h = (l1.shape[1] - 2 * p) // space_size
    out = []
    for s in range(space_size):
        a = l1[:, s * h:s * h + h + 2 * p]
        b = l2[:, s * h:s * h + h + 2 * p].clone()
        b[:, :p] = 7.0  # a border of its own: anything finite, masked
        b[:, -p:] = -3.0
        rows1 = (p if s == 0 else 0, h + p if s == space_size - 1 else h + 2 * p)
        out.append((a.contiguous(), b, rows1))
    return out, h


@pytest.mark.parametrize("dot", ["float32", "bfloat16"])
@pytest.mark.parametrize("lanes", [128, 256])
@pytest.mark.parametrize("space_size", [2, 3])
def test_fused_plain_on_bands_matches_whole_map(space_size, lanes, dot):
    """(d): J summed over the bands and the reassembled dl1 / dl2 against the
    whole map's, for one cotangent g: fp32 products at rtol 1e-5; bf16
    products at rtol 1e-5 for J and within 2^-5 of each gradient's largest
    entry: a halo row's dl1 is the sum of two bands' VJPs of their partial
    dq, each rounding its terms to bf16 before its group sum, where the
    whole map's VJP rounds those of the whole dq once (the partials of a
    random g cancel, so 2^-7 does not hold at these inputs)."""
    (l1, l2), S, K = _logit_canvases(lanes, seed=space_size + lanes)
    dot_dtype = getattr(torch, dot)
    p = FUSED_P
    _, hp, wp, c = l1.shape
    flat = lambda t: t.reshape(-1, c)
    geo = (hp, wp, p, S, K, 1.0, dot_dtype)
    g = torch.randn(((2 * p + 1) ** 2, c, c), generator=torch.Generator().manual_seed(1))
    j_whole = mi_fused.fused_fwd_plain(flat(l1), flat(l2), *geo)
    dl1_whole, dl2_whole = (d.reshape(l1.shape) for d in
                            mi_fused.fused_bwd_plain(flat(l1), flat(l2), g, *geo))
    j_sum = torch.zeros_like(j_whole)
    dl1, dl2 = torch.zeros_like(l1), torch.zeros_like(l2)
    bands, h = _bands(l1, l2, space_size)
    for s, (a, b, rows1) in enumerate(bands):
        bgeo = (a.shape[1], wp, p, S, K, 1.0, dot_dtype)
        j_sum += mi_fused.fused_fwd_plain(flat(a), flat(b), *bgeo, rows1=rows1)
        da, db = mi_fused.fused_bwd_plain(flat(a), flat(b), g, *bgeo, rows1=rows1)
        dl1[:, s * h:s * h + h + 2 * p] += da.reshape(a.shape)
        dl2[:, s * h + p:s * h + h + p] += db.reshape(b.shape)[:, p:p + h]
        assert not db.reshape(b.shape)[:, :p].any() and not db.reshape(b.shape)[:, -p:].any()
    np.testing.assert_allclose(j_sum.numpy(), j_whole.numpy(), rtol=1e-5,
                               atol=1e-5 * float(j_whole.abs().max()))
    tol = 1e-5 if dot == "float32" else 2.0 ** -5
    for got, want in ((dl1, dl1_whole), (dl2, dl2_whole)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5 if dot == "float32" else 0,
                                   atol=tol * float(want.abs().max()))
    # the unsplit window: the output without one, bit for bit
    inner = (p, hp - p)
    assert torch.equal(mi_fused.fused_fwd_plain(flat(l1), flat(l2), *geo, rows1=inner), j_whole)
    for a, b in zip(mi_fused.fused_bwd_plain(flat(l1), flat(l2), g, *geo, rows1=inner),
                    (dl1_whole, dl2_whole)):
        assert torch.equal(a.reshape(l1.shape), b)
    with pytest.raises(ValueError, match="live rows"):
        mi_fused.row_valid(10, hp, wp, p, rows=(3, 3))


def test_fused_front_door_takes_the_window():
    """``displaced_joint_softmax(rows1=)`` reaches the plain forward and
    backward: its gradient to l1 is live on the window's rows only."""
    (l1, l2), S, K = _logit_canvases(128, seed=3)
    l1 = l1[:, :10].clone().requires_grad_(True)
    l2 = l2[:, :10].clone().requires_grad_(True)
    p = FUSED_P
    j = mi_fused.displaced_joint_softmax(l1, l2, p, S, K, rows1=(0, 8))
    want = mi_fused.fused_fwd_plain(l1.detach().reshape(-1, 128), l2.detach().reshape(-1, 128),
                                    10, l1.shape[2], p, S, K, rows1=(0, 8))
    assert torch.equal(j.reshape(want.shape), want)
    (j * torch.rand(j.shape, generator=torch.Generator().manual_seed(4))).sum().backward()
    assert l1.grad[:, :8, p:-p].abs().sum(-1).min() > 0
    assert not l1.grad[:, 8:].any() and not l1.grad[:, :, :p].any()
    assert not l2.grad[:, :p].any() and not l2.grad[:, -p:].any()
