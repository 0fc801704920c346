"""The tiled IIC and the halo deeper than a band under the port's spatial H
split (``ops/iic_local.py:_tiled_joints``, ``parallel/halo.py``), on gloo
ranks on the CPU, against the JAX package's ``batch_sharding(mesh,
space_axis="space")`` step and against the port's one-process step.

Each module fixture spawns its world once (``parallel/dryrun.py:run_ranks``)
and runs every case of that world. Held:

- (a) the JAX package's udaiic case (``tests/test_parallel.py``'s
  ``_udaiic_setup``: crop 16, Conv5 + Up_conv2 heads of 2 x 5 clusters,
  padding 1, ``backend="xla"``) with ``patch_sizes=[8]``: 3 x 3 tiles of the
  16 x 16 map, the middle row of tiles crossing the bands at row 8. On 4 x 2
  ranks against the JAX step on ``make_mesh(8, space_axis="space",
  space_size=2)`` (Adam: losses at rtol 1e-4, parameters at atol 2.5e-3),
  and under SGD with both U-Nets in float64 against the unsharded JAX step
  (each move within 1e-3 of its tensor's largest move);
- (b) port against the one-process port at crop 32 with the headline taps
  Conv5 / Up_conv3 / Up_conv2, paddings [1, 3] and ``patch_sizes=[8, 16]``
  (3 x 3 tiles of each decoder map), on 2 x 2 and 1 x 4: ``iic`` and
  ``udaiic``, the ``xla``, ``xla_banded``, ``xla_scan``, ``auto`` and
  ``pallas`` backends (the kernels' plain versions on the CPU), flat and
  5-D heads, a padded batch (2 + 3 padded to 2 + 4), the device-data path.
  The per-tile joints summed over the world at rtol 1e-6, every metric at
  rtol 2e-4, the summed gradients within 1e-3 of each tensor's largest
  entry (``tests/test_torch_space_iic.py:_check_step``; the U-Net in
  float64 on both sides, the Conv5 head's weights x30);
- (c) ``halo_exchange`` with up to 2h + 1 rows at S = 2 and 4, forward and
  backward, against the whole map under autograd; the step at padding 5 on
  Up_conv3's 4-row bands (crop 32, 1 x 4) against one process, one
  full-map tile (unfused and fused) and tiled; and, without ranks, each
  band's tile pieces summed against the whole map's tile joints;
- (d) the tiles a rank's band meets at crop 224, patch 32: 115 a rank at
  2 x 2, 64 / 89 / 89 / 64 at 1 x 4 (three joint launches each a step).
"""

from itertools import chain

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic_local as til
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
from test_torch_space_iic import (
    FEATS,
    HALO_ROWS,
    HEAD_SCALE,
    IMPORTANCE,
    JAX_KW,
    LAB_IDX,
    LAYOUTS,
    UNLAB_IDX,
    _batch,
    _check_step,
    _halo_reference,
    _Joints,
    _pad,
    _state,
    _store,
    _upstream,
    _whole,
    check_jax_adam,
    check_jax_sgd,
    jax_split_case,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

C, CROP, SUBHEADS, CLUSTERS = 3, 32, 2, 5
PATCHES = [8, 16]  # Up_conv3's 16^2 and Up_conv2's 32^2 maps: 3 x 3 tiles each
STEP_KW = dict(uda_criterion="mse", uda_weight=5.0, iic_weight=0.5, reg_weight=1.0)
# (layout, mode, backend, heads, variant): variant "" (a tensor batch),
# "padded", "device", or "deep" (Up_conv3 at padding 5 on 1 x 4's 4-row
# bands: one full-map tile), "deep_tiles" (the same, tiled)
PORT_CASES = (
    [(lay, "udaiic", backend, "flat", "") for lay in LAYOUTS for backend in ("xla", "auto")]
    + [("2x2", "iic", "auto", "flat", ""), ("1x4", "iic", "pallas", "flat", ""),
       ("2x2", "udaiic", "xla_banded", "flat", ""), ("1x4", "udaiic", "xla_scan", "5d", ""),
       ("2x2", "udaiic", "auto", "5d", ""), ("1x4", "udaiic", "xla", "5d", "")]
    + [(lay, "udaiic", backend, "flat", variant) for variant, backend in (("padded", "xla"),
                                                                         ("device", "auto"))
       for lay in LAYOUTS]
    + [("1x4", "udaiic", backend, "flat", "deep") for backend in ("auto", "pallas_fused")]
    + [("1x4", "udaiic", backend, "flat", "deep_tiles") for backend in ("xla", "auto")])
CASE_IDS = ["-".join(x for x in case if x) for case in PORT_CASES]
DEEP_PADDINGS = [5, 3]
# (d): the tiles of patch 32 a band meets at crop 224: Up_conv3's 112^2 map
# and Up_conv2's 224^2
TILE_COUNTS = {2: [115, 115], 4: [64, 89, 89, 64]}
JAX_TILES_KW = dict(JAX_KW, patch_sizes=[8])


def _build(mode, backend, heads, variant, context=None, n_valid=(None, None), data_store=None,
           classes=C):
    """The float64 U-Net, the fp32 heads, Adam and the tiled step from seed
    0 (``deep``: padding 5 at Up_conv3, one full-map tile)."""
    torch.manual_seed(0)
    model = UNet(1, classes, dtype=torch.float64, bn_dtype=torch.float64).double()
    fused = backend == "pallas_fused"
    proj = ProjectorWrapper(FEATS, num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                            local_flat=heads == "flat", local_emit_logits=fused)
    with torch.no_grad():  # the Conv5 term out of fp32 noise (test_torch_space_iic.py)
        proj.heads["Conv5"].linear.weight.mul_(HEAD_SCALE)
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5})
    kw = dict(paddings=DEEP_PADDINGS if variant.startswith("deep") else [1, 3],
              patch_sizes=1024 if variant == "deep" else PATCHES)
    kw.update(STEP_KW if mode == "udaiic" else dict(reg_weight=0.5))
    step = build_train_step(model, opt, mode, num_classes=classes, generator=torch.Generator(),
                            feature_names=FEATS, feature_importance=IMPORTANCE, projector=proj,
                            backend="auto" if fused else backend, context=context,
                            n_labeled_valid=n_valid[0], n_unlabeled_valid=n_valid[1],
                            data_store=data_store, crop=CROP, **kw)
    return model, proj, step


def _port_step(case, ctx=None, root=None):
    """One step of ``case`` on the rank's rows and band, or in one process
    without ``ctx``."""
    _, mode, backend, heads, variant = case
    batch, flips = _batch(2, 3 if variant == "padded" else 2)
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


# --- (c): halos deeper than a band --------------------------------------------
DEEP_ROWS = (HALO_ROWS + 1, 2 * HALO_ROWS, 2 * HALO_ROWS + 1)  # h = HALO_ROWS


def _deep_halos(ctx):
    """Each halo of DEEP_ROWS rows along dim 2: its output and input
    gradient on this rank's band for an upstream gradient drawn from its
    space rank."""
    out = {}
    whole = _whole(ctx.space_size)
    for rows in DEEP_ROWS:
        x = local_band(whole, ctx, 2).clone().requires_grad_(True)
        y = halo_exchange(x, ctx, 2, rows=rows)
        y.backward(_upstream(y.shape, ctx.space_rank, rows))
        out[rows] = (y.detach(), x.grad)
    return out


# --- the world ----------------------------------------------------------------
def _world4_rank(ctx, root):
    grids = {name: split_context(ctx, s) for name, s in LAYOUTS.items()}
    out = {"steps": {case: _port_step(case, grids[case[0]], root) for case in PORT_CASES},
           "halos": {s: _deep_halos(grids[name]) for name, s in LAYOUTS.items()},
           "space_rank": {name: g.space_rank for name, g in grids.items()}}
    ctx.barrier()
    return out


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
        generate_synthetic_acdc,
    )

    root = tmp_path_factory.mktemp("acdc_space_tiles_torch")
    generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def world4(data_root, tmp_path_factory):
    return run_ranks(_world4_rank, 4, str(data_root), timeout=300,
                     workdir=str(tmp_path_factory.mktemp("space_tiles4")))


@pytest.fixture(scope="module")
def jax_tiles(tmp_path_factory):
    return jax_split_case(tmp_path_factory, JAX_TILES_KW, "space_tiles8")


# --- the checks -------------------------------------------------------------------
@pytest.mark.parametrize("case", PORT_CASES, ids=CASE_IDS)
def test_tiled_split_step_matches_one_process(case, world4, data_root):
    """(b) and (c): the tiled (or deep) split step of each case against one
    process: joints, metrics, dice, gradients, BN statistics."""
    ref = _port_step(case, root=data_root)
    for rank, r in enumerate(world4):
        assert r["space_rank"][case[0]] == rank % LAYOUTS[case[0]]
        _check_step(ref, r["steps"][case])


@pytest.mark.parametrize("space_size", list(LAYOUTS.values()))
@pytest.mark.parametrize("rows", DEEP_ROWS)
def test_deep_halo_matches_whole_map(rows, space_size, world4):
    """(c): a halo past the neighbouring band, outputs exactly, input
    gradients at 1e-12."""
    want = _halo_reference(space_size, rows)
    for s, r in enumerate(world4[:space_size]):  # the first space group of the layout
        y, dx = r["halos"][space_size][rows]
        torch.testing.assert_close(y, want[s][0], rtol=0, atol=0)
        torch.testing.assert_close(dx, want[s][1], rtol=1e-12, atol=1e-12)


def test_jax_tiled_space_sharded_step(jax_tiles):
    """(a): the JAX udaiic case at patch 8 on 4 x 2 ranks against the JAX
    step on the 4 x 2 mesh."""
    check_jax_adam(jax_tiles["adam"])


def test_tiled_split_matches_jax_step_under_sgd(jax_tiles):
    """(a): the same case under SGD with both U-Nets in float64 against the
    unsharded JAX step."""
    check_jax_sgd(jax_tiles["sgd"])


@pytest.mark.parametrize("backend", ["xla", "auto", "xla_banded", "xla_scan"])
@pytest.mark.parametrize("padding,patch", [(1, 8), (3, 6), (5, 8), (9, 8)])
@pytest.mark.parametrize("space_size", [2, 4])
def test_band_pieces_sum_to_the_tiles(space_size, padding, patch, backend):
    """(c): each band's tile pieces, from its halo'd canvas and its
    zero-bordered one, summed over the bands against the whole map's tile
    joints at rtol 1e-6, displacements deeper than a band's rows included;
    a band's tiles that miss it are zero."""
    b, h, w, s, k = 2, 16, 12, 2, 3
    p = padding
    g = torch.Generator().manual_seed(10 * space_size + p)
    x, x_tf = (F.pad(torch.rand((b, h, w, s, k), generator=g), (0, 0, 0, 0, p, p, p, p))
               for _ in range(2))
    want = til._tiled_joints(x, x_tf, p, patch, backend, True, None, None)
    rows = h // space_size
    got = torch.zeros_like(want)
    for r in range(space_size):
        band = (r * rows, (r + 1) * rows)
        xb = x[:, band[0]:band[1] + 2 * p]
        tb = x_tf[:, band[0]:band[1] + 2 * p].clone()
        tb[:, :p], tb[:, -p:] = 7.0, -3.0  # a border of its own: anything, dead
        share = til._tiled_joints(xb, tb, p, patch, backend, True, h, band)
        tiles = til._tiles(h, w, patch)
        for t, (rs, _) in enumerate(tiles):
            if rs.stop <= band[0] or rs.start >= band[1]:
                assert not share[t].any()
        assert len(tiles) == share.shape[0]
        got += share
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("space_size", sorted(TILE_COUNTS))
def test_tiles_a_rank_meets(space_size):
    """(d): the pieces a rank's band gives at crop 224, patch 32, over
    Up_conv3's 112^2 map (p = 1) and Up_conv2's 224^2 (p = 3): three joint
    launches each a step (345 a rank at 2 x 2, against 615 in one
    process)."""
    counts = []
    for r in range(space_size):
        pieces = 0
        for edge, p in ((112, 1), (224, 3)):
            h = edge // space_size
            plan = til._piece_plan(h + 2 * p, edge + 2 * p, edge, edge, 32, p,
                                   (r * h, (r + 1) * h), p, torch.device("cpu"))
            assert plan.n_tiles == len(til._tiles(edge, edge, 32))
            pieces += len(plan.tiles)
        counts.append(pieces)
    assert counts == TILE_COUNTS[space_size]
    assert sum(len(til._tiles(e, e, 32)) for e in (112, 224)) == 205
