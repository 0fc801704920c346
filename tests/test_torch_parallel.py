"""The port's data-parallel layer in one process (``parallel/mesh.py``,
pad-and-mask in ``engine/steps.py``, the ``Parallel`` checks), no spawn.

Held:
- ``local_batch_slice`` and the context's rows, data rank and data world
  (the counterpart of ``tests/test_parallel.py``'s multi-host mesh test),
  ``init_distributed`` without a launcher, ``launcher_world``;
- ``shard_batch``: the rank's rows, non-arrays passed through, the whole
  array kept with one warning per key when its rows do not divide;
- ``check_parallel``, ``main.main`` and ``pretrain_main.main`` refusing a
  ``num_devices`` other than the world size (naming both and the entry's
  ``torchrun`` line) before any data;
- masked BN against plain BN over the real rows: outputs of the real rows
  and running statistics at rtol 1e-5;
- the fused gate refusing a batch that needs pad rows, in the gate and in
  the trainer;
- the padded udaiic step (2 + 3 padded to 4 + 4 at crop 16, the setup of
  ``tests/test_parallel.py::test_padded_masked_step_matches_unpadded``)
  against the port's unpadded step and against the JAX padded step
  (``n_labeled_valid=2, n_unlabeled_valid=3``): losses at rtol 2e-4, dice
  sums of the real rows equal and 0 on pad rows, parameters to the step
  tests' two-tier bound, BN statistics at rtol 1e-4.
"""

from itertools import chain

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
    sample_flip_mask as j_sample_flip_mask,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import pretrain_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    check_parallel,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer as trainer_mod
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models.unet import BatchNorm2d
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    DistContext,
    init_distributed,
    launcher_world,
    local_batch_slice,
    shard_batch,
    single_context,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import mesh
from test_torch_step import _check_params, _np_tree, _port_state
from test_torch_trainer import _config
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP, C, BL, BU, PAD = 16, 3, 2, 3, 4
FEATS = ("Conv5", "Up_conv2")
STEP_KW = dict(num_classes=C, feature_names=FEATS, feature_importance=[1.0, 1.0],
               uda_criterion="mse", uda_weight=5.0, iic_weight=0.5, reg_weight=1.0,
               paddings=[1], patch_sizes=1024, backend="xla")


def test_local_batch_slice_and_context_rows():
    assert local_batch_slice(16, 0, 4) == slice(0, 4)
    assert local_batch_slice(16, 3, 4) == slice(12, 16)
    for bad in ((10, 0, 4), (16, 4, 4)):
        with pytest.raises(ValueError):
            local_batch_slice(*bad)
    # 8 processes as [4 data, 2 space]: process-major, a replica's ranks share rows
    ctx = DistContext(world=8, rank=5, space_size=2)
    assert (ctx.data_world, ctx.data_rank, ctx.rows(12)) == (4, 2, slice(6, 9))
    assert DistContext(world=8, rank=4, space_size=2).rows(12) == slice(6, 9)
    one = single_context()
    assert (one.world, one.data_world, one.rows(5), one.group) == (1, 1, slice(0, 5), None)


def test_init_distributed_without_a_launcher(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert launcher_world() == 1
    ctx = init_distributed("cpu")
    assert (ctx.world, ctx.group, ctx.owns_group) == (1, None, False)
    with pytest.raises(ValueError, match="space_size=2"):
        init_distributed("cpu", space_size=2)
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed("cpu", multihost=True, num_processes=2, process_id=0)
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert launcher_world() == 4
    assert launcher_world(multihost=True, num_processes=16) == 16


def test_data_world_of_one_has_no_group(tmp_path, monkeypatch):
    """A rank that holds the whole batch (world 1 under a launcher, or every
    rank on the space axis) gets no data group: it runs the one-process step
    (cuDNN BN on a card, no collective)."""
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    ctx = init_distributed("cpu", "gloo", space_size=1, init_method=f"file://{tmp_path}/store",
                           world_size=1, rank=0)
    try:
        assert (ctx.world, ctx.data_world, ctx.group, ctx.owns_group) == (1, 1, None, True)
        assert mesh._data_group(2, 1, 2) is None  # 2 ranks on the space axis
    finally:
        ctx.close()
    assert not torch.distributed.is_initialized()


def test_shard_batch_rows_passthrough_and_warn_once(capsys):
    mesh._REPLICATION_WARNED.clear()
    ctx = DistContext(world=2, rank=1)
    batch = {"image": np.arange(8).reshape(4, 2), "mask": torch.arange(4),
             "odd": np.arange(3), "group": ["a", "b"], "scalar": 7}
    out = shard_batch(batch, ctx)
    np.testing.assert_array_equal(out["image"].numpy(), [[4, 5], [6, 7]])
    assert out["mask"].tolist() == [2, 3]
    assert out["group"] == ["a", "b"] and out["scalar"] == 7
    assert out["odd"].tolist() == [0, 1, 2] and isinstance(out["odd"], torch.Tensor)
    shard_batch(batch, ctx)
    assert capsys.readouterr().out.count("'odd' batch dim 3 does not divide") == 1
    whole = shard_batch(batch, None)
    assert whole["image"].shape == (4, 2)


def test_check_parallel_and_main_refusals(tmp_path):
    check_parallel({"Parallel": {"num_devices": None, "data_axis": "batch"}}, world=4)
    check_parallel({"Parallel": {"num_devices": 4, "space_size": 2}}, world=4)
    with pytest.raises(ValueError, match=r"num_devices=2 but the world size is 1.*"
                                         r"torchrun --nproc_per_node=2"):
        check_parallel({"Parallel": {"num_devices": 2}})
    with pytest.raises(ValueError, match="space_size=3 does not divide the world size 4"):
        check_parallel({"Parallel": {"space_size": 3}}, world=4)
    with pytest.raises(ValueError, match="multihost=true needs"):
        check_parallel({"Parallel": {"multihost": True, "num_processes": 2}}, world=2)
    with pytest.raises(ValueError, match="Parallel.mesh"):
        check_parallel({"Parallel": {"mesh": 2}})
    absent = tmp_path / "absent"
    argv = ["Trainer.device=cpu", "Data.synthetic=false", f"Data.root_dir={absent}"]
    with pytest.raises(ValueError, match="num_devices=3 but the world size is 1"):
        port_main.main(argv + ["Parallel.num_devices=3"])
    with pytest.raises(ValueError, match=r"num_devices=2 but the world size is 1.*torchrun "
                                         r"--nproc_per_node=2 -m \S*\.pretrain_main "):
        pretrain_main.main(argv + ["Parallel.num_devices=2"])
    assert not absent.exists()


@pytest.mark.parametrize("shape", [(5, 4, 6, 6), (7, 3)])
def test_masked_batchnorm_matches_plain_over_real_rows(shape):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=gen) * 2 + 0.5
    n_real = shape[0] - 2
    mask = torch.arange(shape[0]) < n_real
    plain, masked = BatchNorm2d(shape[1]), BatchNorm2d(shape[1])
    with torch.no_grad():
        for bn in (plain, masked):
            bn.weight.copy_(torch.linspace(0.5, 1.5, shape[1]))
            bn.bias.copy_(torch.linspace(-1, 1, shape[1]))
    y_plain = plain(x[:n_real])
    y_masked = masked(x, mask)
    torch.testing.assert_close(y_masked[:n_real], y_plain, rtol=1e-5, atol=1e-6)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(masked, name), getattr(plain, name), rtol=1e-5,
                                   atol=1e-7)
    assert int(masked.num_batches_tracked) == 1


def test_fused_gate_refuses_a_padded_batch(tmp_path, monkeypatch):
    cuda = torch.device("cuda")
    linear = [("linear", False), ("linear", False)]
    assert trainer_mod.fused_path_unmet(cuda, 1024, 224, linear, padded=False) is None
    assert "pad rows" in trainer_mod.fused_path_unmet(cuda, 1024, 224, linear, padded=True)
    seen = []
    monkeypatch.setattr(trainer_mod, "fused_path_unmet",
                        lambda *args: seen.append(args[-1]) or "refused")
    cfg = _config("udaiic")
    cfg["Kernel"] = {"backend": "pallas_fused"}
    cfg["LabeledData"] = {"batch_size": 3}
    cfg["UnlabeledData"] = {"batch_size": 4}
    trainer = trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None,
                                     val_loader=None, test_loader=None, configuration=cfg,
                                     device="cpu", crop_size=32, run_dir=str(tmp_path),
                                     context=DistContext(world=2))
    trainer.init()
    assert seen == [True] and trainer._projector.local_emit_logits is False
    assert (trainer._lab_bs_padded, trainer._unlab_bs_padded) == (4, 4)


def _batch():
    rng = np.random.default_rng(0)
    return {"labeled_image": rng.random((BL, CROP, CROP, 1), dtype=np.float32),
            "labeled_target": rng.integers(0, C, (BL, CROP, CROP)).astype(np.int32),
            "unlabeled_image": rng.random((BU, CROP, CROP, 1), dtype=np.float32)}


def _pad(a, n):
    return np.concatenate([a, np.repeat(a[-1:], n - len(a), 0)])


def _port_step(weights, batch, flip_mask, **valid):
    model = UNet(1, C)
    model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("proj.")})
    proj = ProjectorWrapper(FEATS, num_clusters=5, num_subheads=2)
    proj.load_state_dict({k[5:]: v for k, v in weights.items() if k.startswith("proj.")})
    opt = build_optimizer(list(chain(model.parameters(), proj.parameters())),
                          {"name": "Adam", "lr": 1e-3})
    step = build_train_step(model, opt, "udaiic", generator=torch.Generator(), projector=proj,
                            **valid, **STEP_KW)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   flip_mask=torch.from_numpy(flip_mask))
    after = dict(model.state_dict())
    after.update({f"proj.{k}": v for k, v in proj.state_dict().items()})
    return metrics, after


def test_padded_step_matches_unpadded_and_jax_padded():
    batch = _batch()
    padded = {k: _pad(v, PAD) for k, v in batch.items()}
    # the JAX padded step from its init, its flip draw over the padded rows
    jmodel = JUNet(input_dim=1, num_classes=C)
    jproj = JProjector(feature_names=FEATS, num_clusters=5, num_subheads=2, local_flat=True)
    tx = j_build_optimizer({"name": "Adam", "lr": 1e-3})
    state = init_train_state(jmodel, tx, (1, CROP, CROP, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS)
    before = _port_state(_np_tree(state.params), _np_tree(state.batch_stats))
    _, flip_key = jax.random.split(state.rng)
    flip_mask = np.array(j_sample_flip_mask(flip_key, PAD, 0.8))
    jstep = j_build_train_step(jmodel, tx, "udaiic", projector=jproj, n_labeled_valid=BL,
                               n_unlabeled_valid=BU, **STEP_KW)
    state1, jm = jstep(state, {k: jnp.asarray(v) for k, v in padded.items()})
    after_jax = _port_state(_np_tree(state1.params), _np_tree(state1.batch_stats))

    m_pad, after_pad = _port_step(before, padded, flip_mask, n_labeled_valid=BL,
                                  n_unlabeled_valid=BU)
    m_ref, after_ref = _port_step(before, batch, flip_mask[:BU])
    for key in ("sup_loss", "uda", "mi", "reg_loss", "total_loss",
                "individual_mis/Conv5", "individual_mis/Up_conv2"):
        for want in (float(m_ref[key]), float(jm[key])):
            np.testing.assert_allclose(float(m_pad[key]), want, rtol=2e-4, atol=1e-7,
                                       err_msg=key)
    for key in ("sup_dice_inter", "sup_dice_union"):
        got = m_pad[key].numpy()
        np.testing.assert_array_equal(got[:BL], m_ref[key].numpy())
        np.testing.assert_array_equal(got, np.asarray(jm[key]))
        assert not got[BL:].any()
    for want in (after_ref, after_jax):
        _check_params(before, want, after_pad)
