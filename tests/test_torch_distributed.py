"""The port's data parallelism on several CPU processes (gloo), against the
one-process port.

Each module fixture spawns its ranks once (``parallel/dryrun.py:run_ranks``:
a ``file://`` store under ``tmp_path``, one thread a rank, every join under
a 120 s timeout, results back through files) and runs every case of that
world size; the tests hold the results against the same computation in this
process without a context and without pad rows. Held:

- the gradient convention: rank r's loss all_reduce_sum(x_r . x_r) / W gives
  the gradient 2 x_r, exactly;
- udaiic at W = 2 (2 + 3 padded to 2 + 4) and W = 3 (padded to 3 + 3), and
  meanteacher and entropy at W = 3, each rank's step against the one-process
  unpadded step (same weights, batch and flip mask; the kernel backend's
  plain version): every metric at rtol 2e-4 (atol 1e-7), the dice sums of
  the real rows exactly and 0 on pad rows; the summed gradients within 1e-3
  of each tensor's largest entry; the parameters after Adam to the step
  tests' two-tier bound (<= 2.05 lr apart; more than 0.05 lr apart for under
  0.5% of the elements); BN running statistics (and the teacher's) at rtol
  1e-4, atol 1e-6; every rank holds the same state. These steps, the
  device-data step's and the pipelined loop's run the U-Net in float64 on
  both sides (``dtype``, ``bn_dtype`` and its parameters; the projector and
  the losses stay fp32): in fp32 the one-process step's own gradients move
  by up to 1.3% of a tensor's largest entry between 1 and 8 intra-op
  threads (ties in max-pool windows and ReLUs at zero flip with the last
  bit), so the udaiic, meanteacher, entropy and device-data cases failed at
  one thread; in float64 such a flip is about 1e9 times rarer;
- the same udaiic step at W = 2 from the JAX init (SGD, the JAX flip draw,
  the ``xla`` backend on both sides) against the JAX padded step sharded
  over 2 XLA CPU devices (``make_mesh(2)``, ``shard_batch``): losses at
  rtol 2e-4, dice sums exactly, each parameter's move (the summed gradient
  times lr) within 1e-3 of its tensor's largest move, BN statistics at
  rtol 1e-4. This holds the ranks against the reference, not only against
  the port's own one-process step;
- the device-data step at W = 2 (2 + 3 indices padded to 2 + 4) with
  injected augmentation draws and flip mask (the same bounds). The steps run
  at crop 16: at crop 32 a relative change of 1e-7 in the input images alone
  moves the randomly initialised U-Net's gradients by up to 2% relative L2
  in a tensor, against 0.25% at crop 16 (``scripts/torch_step_noise.py``:
  ties in max-pool windows, ReLUs at zero), beyond any bound that would
  still catch a fault;
- ``Trainer.pipelined_scan``'s loop at W = 2 (2 + 3 indices padded to
  2 + 4, two SGD steps) against the same padded loop in one process: both
  steps' metrics, the parameters' moves within 1e-3 of each tensor's
  largest move, the BN statistics;
- the eval scan's per-patient loss and I/U over the ranks' slices at rtol
  1e-5;
- ``parallel/dryrun.py:dryrun_rank`` on the two ranks: finite, the
  checkpoint round trip exact, the same values on both ranks;
- ``main.main`` at W = 2 (``Parallel.num_devices=2``, the world size;
  device-data path, one epoch of 2 steps): one
  ``storage.csv`` and one ``last.pth``, the final state within the two-tier
  bound of a one-process run over two Adam steps (4.1 lr; 1% of elements
  beyond 0.05 lr), then a resume to epoch 2 on both ranks;
- the trainer's host path at W = 2 with 2 + 3 padded to 2 + 4, one step:
  the state after its epoch against the one-process trainer's.
"""

import os
from itertools import chain
from pathlib import Path

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
    DevicePatientEvalLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    build_train_step,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
    build_augment_fn,
    build_epoch_scan_pipelined,
    build_eval_scan,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ProjectorWrapper,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.augment_device import (
    sample_augment_params,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    all_reduce_sum,
    single_context,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun import (
    dryrun_rank,
    run_ranks,
)

CROP, BL, BU, C = 16, 2, 3, 3
FEATS = ("Conv5", "Up_conv2")
LR = 1e-3
SGD = {"name": "SGD", "lr": 0.1}
BACKEND = "auto"
STEP_KW = {
    "udaiic": dict(uda_criterion="mse", uda_weight=5.0, iic_weight=0.5, reg_weight=1.0,
                   paddings=[1], patch_sizes=1024),
    "meanteacher": dict(uda_criterion="mse", reg_weight=10.0, ema_alpha=0.999,
                        ema_weight_decay=1e-4),
    "entropy": dict(reg_weight=0.5),
}


@pytest.fixture(autouse=True)
def _test_threads():
    """The intra-op threads of a test's one-process references: at most two
    (the suite runs several test processes on the machine's cores at once),
    or ``MISST_TEST_THREADS`` where it is set, 0 for torch's default. The
    float64 comparisons hold at any count (the ranks run at one;
    ``scripts/torch_rank_thread_noise.py`` reads the references at 1 and 8):
    ``MISST_TEST_THREADS=1`` and ``MISST_TEST_THREADS=0`` show it."""
    threads = torch.get_num_threads()
    wanted = os.environ.get("MISST_TEST_THREADS")
    torch.set_num_threads(min(threads, 2) if wanted is None else int(wanted) or threads)
    yield
    torch.set_num_threads(threads)


def _pad(a, n):
    a = np.asarray(a)
    return np.concatenate([a, np.repeat(a[-1:], n - len(a), 0)])


def _round_up(n, w):
    return -(-n // w) * w


def _batch():
    rng = np.random.default_rng(3)
    return ({"labeled_image": rng.random((BL, CROP, CROP, 1), dtype=np.float32),
             "labeled_target": rng.integers(0, C, (BL, CROP, CROP)).astype(np.int32),
             "unlabeled_image": rng.random((BU, CROP, CROP, 1), dtype=np.float32)},
            rng.random((BU, 2)) < 0.8)


def _unet(classes, f64):
    """The U-Net, in float64 (compute, BN and parameters) with ``f64``."""
    if not f64:
        return UNet(1, classes)
    return UNet(1, classes, dtype=torch.float64, bn_dtype=torch.float64).double()


def _build(mode, context=None, n_valid=(None, None), data_store=None, crop=CROP, classes=C,
           optim=None, weights=None, backend=BACKEND, f64=True):
    """The mode's model, projector, teacher and step from the weights of
    seed 0, or from ``weights`` (a port state dict, the projector's under
    ``proj.``). ``f64``: the U-Net in float64 (the projector and the losses
    stay fp32), which puts the gradients of two runs that differ only in
    their rounding (a rank's step and one process's, or two thread counts)
    far inside the bounds below."""
    torch.manual_seed(0)
    model = _unet(classes, f64)
    teacher = proj = None
    params = list(model.parameters())
    if mode == "udaiic":
        proj = ProjectorWrapper(FEATS, num_clusters=5, num_subheads=2)
        params += list(proj.parameters())
    if weights is not None:
        model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("proj.")})
        proj.load_state_dict({k[5:]: v for k, v in weights.items() if k.startswith("proj.")})
    if mode == "meanteacher":
        teacher = _unet(classes, f64).requires_grad_(False)
        teacher.load_state_dict(model.state_dict())
    opt = build_optimizer(params, optim or {"name": "Adam", "lr": LR, "weight_decay": 1e-5})
    step = build_train_step(model, opt, mode, num_classes=classes, generator=torch.Generator(),
                            feature_names=FEATS if proj else (), feature_importance=[1.0, 1.0],
                            projector=proj, teacher=teacher, backend=backend,
                            data_store=data_store, crop=crop, n_labeled_valid=n_valid[0],
                            n_unlabeled_valid=n_valid[1], context=context, **STEP_KW[mode])
    return model, proj, teacher, step


def _state(model, proj, teacher, metrics):
    """What a step case hands back: metrics, parameters, gradients, buffers."""
    named = list(chain(model.named_parameters(),
                       proj.named_parameters(prefix="proj") if proj else []))
    out = {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
           "params": {k: p.detach().clone() for k, p in named},
           "grads": {k: p.grad.clone() for k, p in named if p.grad is not None},
           "buffers": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}}
    if teacher is not None:
        out["teacher"] = {k: v.clone() for k, v in teacher.state_dict().items()}
    return out


def _step_case(ctx, mode, start=None):
    """The mode's step on this rank's rows of the padded global batch;
    ``start``: (weights, padded flip mask), with SGD and the ``xla`` backend (the JAX step's in
    ``test_udaiic_two_ranks_match_jax_sharded_step``; ``auto``'s joint rounds
    its operands to bf16, as the JAX Pallas kernel does)."""
    batch, flips = _batch()
    w = ctx.data_world
    lab_p, unlab_p = _round_up(BL, w), _round_up(BU, w)
    weights = optim = None
    backend = BACKEND
    if start is not None:
        (weights, flips), optim, backend = start, SGD, "xla"
    model, proj, teacher, step = _build(mode, ctx, (BL, BU), optim=optim, weights=weights,
                                        backend=backend, f64=start is None)
    full = {"labeled_image": _pad(batch["labeled_image"], lab_p),
            "labeled_target": _pad(batch["labeled_target"], lab_p),
            "unlabeled_image": _pad(batch["unlabeled_image"], unlab_p)}
    rows = {k: torch.from_numpy(v[ctx.rows(len(v))]) for k, v in full.items()}
    metrics = step(rows, flip_mask=torch.from_numpy(_pad(flips, unlab_p)))
    return _state(model, proj, teacher, metrics)


def _reference(mode):
    batch, flips = _batch()
    model, proj, teacher, step = _build(mode)
    metrics = step({k: torch.from_numpy(v) for k, v in batch.items()},
                   flip_mask=torch.from_numpy(flips))
    return _state(model, proj, teacher, metrics)


def _grad_case(ctx):
    """Tentpole rule: rank r holds x_r; its loss is all_reduce(x.x) / W."""
    x = torch.tensor([1.0 + ctx.rank, -2.0, 0.5 * ctx.rank], requires_grad=True)
    (all_reduce_sum((x * x).sum(), ctx.group) / ctx.data_world).backward()
    return {"x": x.detach(), "grad": x.grad}


def _store(root):
    return DeviceDataStore(ACDCDataset(str(root), "train"), pack=True)


def _device_draws(store, lab_idx, unlab_idx, crop):
    gen = torch.Generator().manual_seed(5)
    return {k: sample_augment_params(gen, len(i), store.shape, crop=crop,
                                     valid_hw=store.valid_hw_dev[i], offsets=store.offsets_dev[i])
            for k, i in (("labeled", lab_idx), ("unlabeled", unlab_idx))}


LAB_IDX, UNLAB_IDX = [1, 7], [0, 5, 9]


def _device_step(ctx, root):
    """udaiic on the device-data path: the global indices (2 + 3 padded to
    2 + 4, the last repeated), injected draws for all four."""
    store = _store(root)
    lab_idx, unlab_idx = torch.tensor(LAB_IDX), torch.tensor(_pad(UNLAB_IDX, 4))
    model, proj, teacher, step = _build("udaiic", ctx, (BL, BU), data_store=store,
                                        classes=4)
    _, flips = _batch()
    metrics = step({"labeled_indices": lab_idx, "unlabeled_indices": unlab_idx},
                   flip_mask=torch.from_numpy(_pad(flips, 4)),
                   aug_params=_device_draws(store, lab_idx, unlab_idx, CROP))
    return _state(model, proj, teacher, metrics)


def _pipelined_case(ctx, root):
    """``Trainer.pipelined_scan``'s loop over 2 steps of 2 + 3 indices
    padded to 2 + 4: each batch augmented from a (seed, i) generator over
    the global indices, the rank's rows kept."""
    store = _store(root)
    stores = {"labeled": store, "unlabeled": store}
    model, proj, teacher, step = _build("udaiic", ctx, (BL, BU), classes=4, optim=SGD)
    epoch = build_epoch_scan_pipelined(build_augment_fn(stores, crop=CROP, context=ctx), step, 2)
    batches = {"labeled_indices": torch.tensor([LAB_IDX, [3, 4]]),
               "unlabeled_indices": torch.tensor(np.stack([_pad(UNLAB_IDX, 4), [8, 2, 6, 6]]))}
    metrics = epoch(batches, 11)
    return _state(model, proj, teacher, metrics)


def _eval_case(ctx, root):
    store = DeviceDataStore(ACDCDataset(str(root), "val"))
    torch.manual_seed(0)
    model = UNet(1, 4)
    loader = DevicePatientEvalLoader(store, pad_multiple=max(ctx.data_world, 1) if ctx else 8)
    idx = torch.from_numpy(np.stack([b["indices"] for b in loader]))
    masks = torch.from_numpy(np.stack([b["mask"] for b in loader]))
    return build_eval_scan(model, num_classes=4, data_store=store, crop=32, context=ctx)(idx, masks)


def _main_argv(root, run, *extra):
    return ["Trainer.name=udaiic", f"Trainer.save_dir={run}", "Trainer.device=cpu",
            "Trainer.num_batches=2", "Trainer.max_epoch=1", "Trainer.device_data=true",
            "Trainer.crop_size=32", "Trainer.progress=false", f"Data.root_dir={root}",
            "Data.labeled_data_ratio=0.5", "Data.unlabeled_data_ratio=0.5",
            "LabeledData.batch_size=2", "UnlabeledData.batch_size=2",
            "IICRegParameters.EncoderParams.num_clusters=5",
            "IICRegParameters.DecoderParams.num_clusters=5",
            "IICRegParameters.EncoderParams.num_subheads=2",
            "IICRegParameters.DecoderParams.num_subheads=2", *extra]


def _trainer_state(trainer):
    return {k: v.detach().clone() for k, v in chain(
        trainer._model.state_dict().items(),
        (("proj." + k, v) for k, v in trainer._projector.state_dict().items()))}


def _main_case(ctx, root, run):
    first = port_main.main(_main_argv(root, run, f"Parallel.num_devices={ctx.world}"))
    state = _trainer_state(first)
    resumed = port_main.main(_main_argv(root, run, "Trainer.max_epoch=2", f"Checkpoint={run}"))
    return {"state": state, "rows": sorted(resumed._storage._rows),
            "steps": int(resumed._step_counter), "start": resumed._start_epoch,
            "files": sorted(p.name for p in Path(run).iterdir())}


def _host_trainer(root, run_dir, context=None):
    from test_torch_checkpoints import make_config, make_loaders

    cfg = make_config("udaiic")
    trainer = trainer_zoos["udaiic"](configuration=cfg, save_dir="host", max_epoch=1,
                                     num_batches=1, device="cpu", crop_size=32,
                                     run_dir=str(run_dir), context=context,
                                     **make_loaders(root))
    trainer.init()
    trainer.start_training()
    return trainer


def _host_case(ctx, root, run_dir):
    trainer = _host_trainer(root, run_dir, ctx)
    return {"state": _trainer_state(trainer), "padded": (trainer._lab_bs_padded,
                                                        trainer._unlab_bs_padded),
            "dice": trainer._storage._rows[0]["tra_sup_dice_DSC_mean"]}


def _cases(ctx, cases):
    return {name: fn(ctx, *args) for name, fn, args in cases}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_dist_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def jax_start():
    """The JAX udaiic step's start at W = 2 (the setup of
    ``tests/test_parallel.py::test_padded_masked_step_matches_unpadded``):
    its model, projector, optimizer (SGD: the move is the gradient itself,
    where Adam's first, about lr * sign(g), would hide its scale) and state
    from seed 0, the state's
    weights as a port state dict, and its flip draw over the 4 padded
    unlabeled rows. JAX is imported here only: the ranks import this module."""
    import jax

    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
        build_optimizer as j_build_optimizer,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import (
        init_train_state,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.models import (
        ProjectorWrapper as JProjector,
        UNet as JUNet,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
        sample_flip_mask as j_sample_flip_mask,
    )
    from test_torch_step import _np_tree, _port_state

    jmodel = JUNet(input_dim=1, num_classes=C)
    jproj = JProjector(feature_names=FEATS, num_clusters=5, num_subheads=2, local_flat=True)
    tx = j_build_optimizer(SGD)
    state = init_train_state(jmodel, tx, (1, CROP, CROP, 1), seed=0, projector=jproj,
                             projector_feature_names=FEATS)
    _, flip_key = jax.random.split(state.rng)  # the draw the JAX step makes
    return {"modules": (jmodel, jproj, tx), "state": state,
            "weights": _port_state(_np_tree(state.params), _np_tree(state.batch_stats)),
            "flips": np.array(j_sample_flip_mask(flip_key, _round_up(BU, 2), 0.8))}


@pytest.fixture(scope="module")
def world2(data_root, tmp_path_factory, jax_start):
    tmp = tmp_path_factory.mktemp("w2")
    cases = [("grad", _grad_case, ()), ("udaiic", _step_case, ("udaiic",)),
             ("jax", _step_case, ("udaiic", (jax_start["weights"], jax_start["flips"]))),
             ("device", _device_step, (str(data_root),)), ("eval", _eval_case, (str(data_root),)),
             ("pipelined", _pipelined_case, (str(data_root),)),
             ("main", _main_case, (str(data_root), str(tmp / "main"))),
             ("host", _host_case, (str(data_root), str(tmp / "host"))),
             ("dryrun", dryrun_rank, (str(tmp / "dryrun"),))]
    return run_ranks(_cases, 2, cases, timeout=120, workdir=str(tmp))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    cases = [(m, _step_case, (m,)) for m in ("udaiic", "meanteacher", "entropy")]
    return run_ranks(_cases, 3, cases, timeout=120, workdir=str(tmp_path_factory.mktemp("w3")))


def _check_params(ref, got, steps=1, loose_share=0.005):
    n_tot = n_loose = 0
    for k, p in ref.items():
        diff = (got[k] - p).abs()
        assert float(diff.max()) <= (2 * steps + 0.05) * LR, f"{k}: {float(diff.max())}"
        n_tot += diff.numel()
        n_loose += int((diff > 0.05 * LR).sum())
    assert n_loose / n_tot < loose_share, f"{n_loose}/{n_tot} elements apart"


def _check_step(ref, got, n_lab=BL):
    m_ref, m_got = ref["metrics"], got["metrics"]
    assert set(m_ref) == set(m_got)
    for k, v in m_ref.items():
        if k.startswith("sup_dice"):
            np.testing.assert_array_equal(m_got[k][:n_lab], v, err_msg=k)
            assert not m_got[k][n_lab:].any(), k
        else:
            np.testing.assert_allclose(m_got[k], v, rtol=2e-4, atol=1e-7, err_msg=k)
    assert set(ref["grads"]) == set(got["grads"])
    for k, g in ref["grads"].items():
        scale = float(g.abs().max())
        np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-3 * scale + 1e-12, err_msg=k)
    _check_params(ref["params"], got["params"])
    for k, v in ref["buffers"].items():
        np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k, v in ref.get("teacher", {}).items():
        if v.is_floating_point():
            np.testing.assert_allclose(got["teacher"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=2.05 * LR if "running_" not in k else 1e-6,
                                       err_msg=f"teacher {k}")


def _same_on_every_rank(results, name):
    for r in results[1:]:
        for k, v in results[0][name]["params"].items():
            assert torch.equal(r[name]["params"][k], v), f"{name}: {k} differs across ranks"


def test_gradient_convention(world2):
    for rank, r in enumerate(world2):
        torch.testing.assert_close(r["grad"]["grad"], 2 * r["grad"]["x"], rtol=0, atol=0)


@pytest.mark.parametrize("world", [2, 3])
def test_udaiic_step_matches_one_process(world, world2, world3):
    results = world2 if world == 2 else world3
    ref = _reference("udaiic")
    for r in results:
        _check_step(ref, r["udaiic"])
    _same_on_every_rank(results, "udaiic")


def test_udaiic_two_ranks_match_jax_sharded_step(world2, jax_start):
    """Each of the 2 ranks' udaiic steps (2 + 3 padded to 2 + 4, from the
    JAX init, the JAX flip draw) against the JAX padded step sharded over 2
    XLA CPU devices on the same batch (``n_labeled_valid=2``,
    ``n_unlabeled_valid=3``), both under SGD: the losses at rtol 2e-4, the
    dice sums exactly, each parameter's move (the summed gradient times lr)
    within 1e-3 of its tensor's largest move, the BN statistics at rtol
    1e-4."""
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
        build_train_step as j_build_train_step,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.parallel import (
        make_mesh,
        replicate_state,
        shard_batch,
    )
    from test_torch_step import _np_tree, _port_state

    jmodel, jproj, tx = jax_start["modules"]
    jstep = j_build_train_step(jmodel, tx, "udaiic", projector=jproj, num_classes=C,
                               feature_names=FEATS, feature_importance=[1.0, 1.0],
                               backend="xla", n_labeled_valid=BL, n_unlabeled_valid=BU,
                               **STEP_KW["udaiic"])
    mesh = make_mesh(2)
    batch, _ = _batch()
    padded = {k: _pad(v, _round_up(len(v), 2)) for k, v in batch.items()}
    state1, jm = jstep(replicate_state(jax_start["state"], mesh), shard_batch(padded, mesh))
    after_jax = _port_state(_np_tree(state1.params), _np_tree(state1.batch_stats))
    for r in world2:
        got = r["jax"]
        for key in ("sup_loss", "uda", "mi", "reg_loss", "total_loss",
                    "individual_mis/Conv5", "individual_mis/Up_conv2"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=2e-4,
                                       atol=1e-7, err_msg=key)
        for key in ("sup_dice_inter", "sup_dice_union"):
            np.testing.assert_array_equal(got["metrics"][key], np.asarray(jm[key]), key)
        for k, p0 in jax_start["weights"].items():
            if "running_" in k:
                np.testing.assert_allclose(got["buffers"][k].numpy(), after_jax[k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
            elif "num_batches" not in k:
                move = (after_jax[k] - p0).numpy()
                np.testing.assert_allclose((got["params"][k] - p0).numpy(), move, rtol=0,
                                           atol=1e-3 * float(np.abs(move).max()) + 1e-12,
                                           err_msg=k)


@pytest.mark.parametrize("mode", ["meanteacher", "entropy"])
def test_mode_step_matches_one_process_at_three_ranks(mode, world3):
    ref = _reference(mode)
    for r in world3:
        _check_step(ref, r[mode])
    _same_on_every_rank(world3, mode)


def test_device_data_step_matches_one_process(world2, data_root):
    """The ranks' draws cover the padded 2 + 4 batch; the reference takes
    the real rows of the same draws."""
    store = _store(data_root)
    lab_idx, unlab_idx = torch.tensor(LAB_IDX), torch.tensor(UNLAB_IDX)
    draws = _device_draws(store, lab_idx, torch.tensor(_pad(UNLAB_IDX, 4)), CROP)
    draws["unlabeled"] = {k: None if v is None else v[:BU] for k, v in draws["unlabeled"].items()}
    model, proj, teacher, step = _build("udaiic", data_store=store,
                                        classes=4)
    _, flips = _batch()
    metrics = step({"labeled_indices": lab_idx, "unlabeled_indices": unlab_idx},
                   flip_mask=torch.from_numpy(flips), aug_params=draws)
    ref = _state(model, proj, teacher, metrics)
    for r in world2:
        _check_step(ref, r["device"])


def test_pipelined_scan_matches_one_process(world2, data_root):
    """The ranks' loop against the same padded loop in one process (the
    draws cover the padded batch on both sides), under SGD, whose move is
    the gradient itself (Adam's first move, about lr * sign(g), would carry
    the first step's noise into the second): both steps' metrics, each
    parameter's move over the two steps within 1e-3 of its tensor's largest
    move, the BN statistics."""
    ref = _pipelined_case(single_context(), data_root)
    init = _state(*_build("udaiic", classes=4)[:3], {})["params"]
    for r in world2:
        got = r["pipelined"]
        for k, v in ref["metrics"].items():
            if not k.startswith("sup_dice"):
                np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-4, atol=1e-7,
                                           err_msg=k)
        for k, p in ref["params"].items():
            move = p - init[k]
            np.testing.assert_allclose((got["params"][k] - init[k]).numpy(), move.numpy(),
                                       rtol=0, atol=1e-3 * float(move.abs().max()) + 1e-12,
                                       err_msg=k)
        for k, v in ref["buffers"].items():
            np.testing.assert_allclose(got["buffers"][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_dryrun_on_two_ranks(world2):
    """``parallel/dryrun.py:dryrun_rank`` (what ``dryrun_multichip`` runs on
    each rank): the flagship step padded, the device-data epoch loop,
    ``Kernel.augment=epoch``, the eval scan and the checkpoint round trip
    (which raises on any mismatch); every rank reports the same values."""
    first = world2[0]["dryrun"]
    assert first["padded"] == [4, 10] and first["checkpoint_leaves"] > 0
    for key in ("step_total_loss", "scan_losses", "preaug_losses", "eval_dsc_mean"):
        assert np.all(np.isfinite(first[key])), key
        assert world2[1]["dryrun"][key] == first[key], key


def test_eval_scan_sums_over_ranks(world2, data_root):
    ref = _eval_case(None, data_root)
    for r in world2:
        for k in ("loss", "inter", "union"):
            np.testing.assert_allclose(r["eval"][k].numpy(), ref[k].numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_main_at_two_ranks_matches_one_process_and_resumes(world2, data_root, tmp_path):
    ref = port_main.main(_main_argv(data_root, tmp_path / "one"))
    want = _trainer_state(ref)
    for r in world2:
        got = r["main"]["state"]
        params = {k: v for k, v in want.items() if "running_" not in k and "num_batches" not in k}
        _check_params(params, got, steps=2, loose_share=0.01)
        for k in want:
            if "running_" in k:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6)
        assert r["main"]["rows"] == [0, 1] and r["main"]["steps"] == 4
        assert r["main"]["start"] == 1
    # rank 0 alone writes: no temporary file of a second writer is left
    assert world2[0]["main"]["files"] == sorted(p.name for p in (tmp_path / "one").iterdir())
    assert {"last.pth", "best.pth", "storage.csv", "config.yaml"} <= set(
        world2[0]["main"]["files"])


def test_host_trainer_pads_and_matches_one_process(world2, data_root, tmp_path):
    ref = _host_trainer(data_root, tmp_path)
    want = _trainer_state(ref)
    for r in world2:
        assert r["host"]["padded"] == (2, 4)
        got = r["host"]["state"]
        _check_params({k: v for k, v in want.items()
                       if "running_" not in k and "num_batches" not in k}, got)
        for k in want:
            if "running_" in k:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-6)
        assert r["host"]["dice"] == pytest.approx(
            ref._storage._rows[0]["tra_sup_dice_DSC_mean"], rel=1e-6)
