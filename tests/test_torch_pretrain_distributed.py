"""The port's contrastive pretrain pipeline on several CPU processes (gloo),
against the one-process port and against the JAX package on a mesh.

Each module fixture spawns its ranks once (``parallel/dryrun.py:run_ranks``:
a ``file://`` store, every join under a timeout, results back through
files) and runs every case of that world size. Held:

- ``all_gather_rows``: the global rows in order, and each rank's gradient
  the sum over the ranks' losses of its own rows', exactly;
- ``supcon_loss`` with a group and pad rows (labels, an explicit mask,
  SimCLR, ``contrast_mode="one"``, the decoder's 4 blocks; pad rows filled
  with other features and labels, which must not matter; at W = 3 one rank
  holding pad rows only): the ranks' losses summed, and each rank's input
  gradient, against the one-process function on the real rows at rtol 1e-5;
- the ``iiccontrast`` encoder and decoder steps at W = 2 (5 slices padded
  to 6) and W = 3 (6 slices), ``contrastMT``'s finetune step (3 + 5 padded
  to 4 + 6) and plain ``contrast`` finetune (3 padded to 4) at W = 2, each
  rank against the one-process step on the real rows (same weights, batch
  and flip mask): every metric at rtol 2e-4 (atol 1e-7), the dice sums of
  the real rows exactly and 0 on pad rows; each summed gradient within 1e-3
  of its tensor's largest entry; the parameters after Adam to the step
  tests' two-tier bound (<= 2.05 lr apart; more than 0.05 lr apart for
  under 0.5% of the elements); the BN running statistics (and the
  teacher's) at rtol 1e-4, atol 1e-6; every rank holding the same state.
  The U-Net computes in float64 on both sides (``dtype`` and ``bn_dtype``,
  its parameters too), the heads and losses in fp32: a random-init U-Net's
  fp32 gradients move by up to 3% of a tensor's largest entry with the
  intra-op thread count alone (ties in max-pool windows, ReLUs at zero;
  ``scripts/torch_step_noise.py``), and in float64 such a tie is 1e9 times
  rarer, so the bound stands above the noise at any thread count;
- the ``iiccontrast`` encoder and decoder steps at W = 2 from the JAX init
  (``weights.py``), under SGD, against the JAX steps on ``make_mesh(2)``
  XLA CPU devices with ``shard_batch`` / ``replicate_state`` on a batch of
  4 slices (JAX does not pad the pretrain), the JAX flip draw injected, the
  JAX U-Net in float64 (``jax.enable_x64``) and the decoder IIC on the
  ``xla_banded`` joint on both sides (fp32 products): losses at rtol 2e-4,
  each parameter's move within 1e-3 of its tensor's largest move, frozen
  ones not moving, the BN statistics at rtol 1e-4. This holds the slice
  against the reference, not only against the port's own one-process step;
- ``pretrain_main.main`` at W = 2 (``Parallel.num_devices=2``, the world
  size; ``iiccontrast``, one step a phase, 3 contrastive slices padded to 4,
  3 finetune slices padded to 4) against the one-process run: the phase CSVs
  agree (losses at rtol 2e-4, atol 1e-5: the decoder's IIC loss sits near 0
  at random init, -4.7e-3, and its phase starts from the encoder phase's
  parameters, whose first Adam step differs in sign on small entries at
  crop 224 in fp32, so it reads 1.6e-6 apart; the DSCs at 5e-3 absolute: at
  random init the classes' logits lie close, so those sign flips move
  near-tied pixels' argmax, 1.8e-3 on finetune's class-2 train DSC of 0.014
  at one thread; the step cases hold the dice sums exactly); both ranks
  ending in the same state (the run's steps, at lr 1e-6, are too small to
  show a wrong gradient sum: the step cases hold those); rank 1 wrote nothing (its checkpoint, CSV, config and event-log writers spied on)
  and the run directory holds the one-process run's files; a resume from
  the written ``last.pth`` leaves both ranks in the same state, that of the
  file;
- ``Parallel.num_devices=2`` in one process raises ``check_parallel``'s
  ``ValueError`` naming the ``pretrain_main`` ``torchrun`` line.
Crop 16, the pretrain heads at 2 subheads of 10 clusters.
"""

import copy
import csv
import functools
import os
from itertools import chain
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn as nn

from mi_based_regularized_semi_supervised_segmentation_tpu_torch import pretrain_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    pretrain,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.optim import (
    init_optimizer_state,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.trainer import pad_rows
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    ClusterHead,
    LocalClusterHead,
    LocalProjectionHead,
    ProjectionHead,
    UNet,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import losses
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    all_gather_rows,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel.dryrun import (
    run_ranks,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import Storage

CROP, C = 16, 3
LR = 1e-3
SGD = {"name": "SGD", "lr": 0.1}
F64 = torch.float64
CLUSTERS, SUBHEADS = 10, 2
IIC_WEIGHT = 0.5
COMPONENTS = {"encoder": ("Conv1", "Conv5"), "decoder": ("Up5", "Up_conv3"),
              "finetune": ("Conv1", "DeConv_1x1"), "finetune_mt": ("Conv1", "DeConv_1x1")}
PARTS = ["0", "1", "2", "0", "1", "2"]
GROUPS = ["p1", "p1", "p1", "p2", "p2", "p2"]


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


def _round_up(n, w):
    return -(-n // w) * w


def _pad_list(values, n):
    return list(values) + list(values[-1:]) * (n - len(values))


def _data(n, n_unlab=5):
    """Two views and a target of ``n`` slices, ``n_unlab`` unlabeled slices,
    and a flip draw over each (numpy, seeded)."""
    rng = np.random.default_rng(7)
    return {"image": rng.random((n, CROP, CROP, 1), dtype=np.float32),
            "image_tf": rng.random((n, CROP, CROP, 1), dtype=np.float32),
            "target": rng.integers(0, C, (n, CROP, CROP)).astype(np.int32),
            "unlabeled_image": rng.random((n_unlab, CROP, CROP, 1), dtype=np.float32),
            "flips": rng.random((n, 2)) < 0.5, "unlab_flips": rng.random((n_unlab, 2)) < 0.5}


def _labels(phase, n):
    """The contrastive labels of ``n`` slices (the first ``n`` of
    PARTS / GROUPS, repeating the last past them, as the trainer pads)."""
    parts, groups = _pad_list(PARTS, n)[:n], _pad_list(GROUPS, n)[:n]
    if phase == "encoder":
        return pretrain.global_labels(parts, groups)
    return pretrain.local_labels(parts, groups, pretrain.unfold_locations((4, 4), n))


def _heads(phase):
    torch.manual_seed(1)
    if phase == "encoder":
        return {"projector": ProjectionHead(256, output_dim=256, head_type="mlp"),
                "iic": ClusterHead(256, num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                                   head_type="linear")}
    if phase == "decoder":
        return {"projector": LocalProjectionHead(32, head_type="mlp", output_size=(4, 4)),
                "iic": LocalClusterHead(32, num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                                        head_type="mlp", flat_output=False)}
    return {}


def _build(phase, context=None, weights=None, optim=None):
    """The phase's model (a float64 U-Net from seed 0, or ``weights``: a
    port layout, the heads' under ``heads.``), heads, teacher and step, the
    frozen components' parameters out of the optimizer (Adam at LR unless
    ``optim``)."""
    torch.manual_seed(0)
    model = UNet(1, C, dtype=F64, bn_dtype=F64)
    heads = nn.ModuleDict(_heads(phase))
    if weights is not None:
        model.load_state_dict({k: v for k, v in weights.items() if not k.startswith("heads.")})
        heads.load_state_dict({k[6:]: v for k, v in weights.items() if k.startswith("heads.")})
    model.double()
    teacher = copy.deepcopy(model).requires_grad_(False) if phase == "finetune_mt" else None
    mask = pretrain.freeze_mask(model, pretrain.component_range(*COMPONENTS[phase]))
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
    params = [p for name, p in model.named_parameters() if mask[name]] + list(heads.parameters())
    opt = build_optimizer(params, optim or {"name": "Adam", "lr": LR, "weight_decay": 1e-5})
    init_optimizer_state(opt)
    gen = torch.Generator()
    kw = dict(context=context)
    if phase == "encoder":
        step = pretrain.build_pretrain_encoder_step(
            model, heads["projector"], opt, iic_head=heads["iic"], iic_weight=IIC_WEIGHT, **kw)
    elif phase == "decoder":
        step = pretrain.build_pretrain_decoder_step(
            model, heads["projector"], opt, generator=gen, iic_head=heads["iic"],
            iic_weight=IIC_WEIGHT, **kw)
    elif phase == "finetune":
        step = pretrain.build_finetune_step(model, opt, num_classes=C, **kw)
    else:
        step = pretrain.build_finetune_mt_step(model, teacher, opt, num_classes=C, generator=gen,
                                               ema_weight_decay=1e-3, **kw)
    return model, heads, teacher, step


def _state(model, heads, teacher, metrics):
    named = list(chain(model.named_parameters(), heads.named_parameters(prefix="heads")))
    out = {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
           "params": {k: p.detach().clone() for k, p in named},
           "grads": {k: p.grad.clone() for k, p in named if p.grad is not None},
           "buffers": {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}}
    if teacher is not None:
        out["teacher"] = {k: v.clone() for k, v in teacher.state_dict().items()}
    return out


def _run(ctx, phase, n, weights=None, optim=None, flips=None):
    """The phase's step on ``n`` real slices (the unlabeled: 5), padded to
    the data world, this rank's rows (``ctx`` None: one process, unpadded).
    ``flips``: the injected draw (default the data's)."""
    d = _data(n)
    w = 1 if ctx is None else ctx.data_world
    m, n_unlab = _round_up(n, w), len(d["unlabeled_image"])
    mu = _round_up(n_unlab, w)
    rows = (lambda a: a) if ctx is None else (lambda a: a[ctx.rows(len(a))])
    model, heads, teacher, step = _build(phase, ctx, weights, optim)
    t = lambda a, k: torch.from_numpy(rows(pad_rows(a, k)))
    if phase in ("encoder", "decoder"):
        batch = {"image": t(d["image"], m), "image_tf": t(d["image_tf"], m),
                 "labels": torch.from_numpy(_labels(phase, m))}
        kw = {} if phase == "encoder" else {"flip_mask": torch.from_numpy(
            d["flips"] if flips is None else flips)}
        metrics = step(batch, n_valid=n, **kw)
    elif phase == "finetune":
        metrics = step({"image": t(d["image"], m), "target": t(d["target"], m)}, n_valid=n)
    else:
        metrics = step({"image": t(d["image"], m), "target": t(d["target"], m),
                        "unlabeled_image": t(d["unlabeled_image"], mu)},
                       flip_mask=torch.from_numpy(d["unlab_flips"]), n_valid=n,
                       n_unlabeled_valid=n_unlab)
    return _state(model, heads, teacher, metrics)


def _jax_case(ctx, phase, start):
    """The rank's step from the JAX start under SGD, the decoder IIC on the
    ``xla_banded`` joint (the JAX step's off the TPU)."""
    weights, flips = start
    banded = functools.partial(pretrain.iid_segmentation_small_patch_loss_subheads,
                               backend="xla_banded")
    with mock.patch.object(pretrain, "iid_segmentation_small_patch_loss_subheads", banded):
        return _run(ctx, phase, 4, weights, SGD, flips)


# --- supcon and the gather ----------------------------------------------
SUPCON = {  # name: (real rows a block, blocks, mode)
    "labels": (5, 1, "labels"), "mask": (5, 1, "mask"), "simclr": (5, 1, "simclr"),
    "one": (5, 1, "one"), "blocks": (3, 4, "labels"), "pad_rank": (4, 1, "labels"),
}


def _supcon_inputs(name, world):
    """(real features [blocks * n, 2, 8] block-major, their labels / mask,
    the padded global features [blocks, m, 2, 8] and labels / mask, m):
    pad rows hold other features and labels, which the loss must ignore."""
    n, blocks, mode = SUPCON[name]
    m = _round_up(n, world)
    rng = np.random.default_rng(11)
    f = rng.normal(size=(blocks, m, 2, 8))
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    lab = rng.integers(0, 3, (blocks, m))
    lab[:, n:] = 99
    real = f[:, :n].reshape(blocks * n, 2, 8)
    kw, kw_pad = {}, {}
    if mode in ("labels", "one"):
        kw["labels"], kw_pad["labels"] = lab[:, :n].reshape(-1), lab.reshape(-1)
    elif mode == "mask":
        full = (rng.random((m, m)) < 0.4).astype(np.float64)
        kw["mask"], kw_pad["mask"] = full[:n, :n], full
    if mode == "one":
        kw["contrast_mode"] = kw_pad["contrast_mode"] = "one"
    return real, kw, f, kw_pad, m


def _tensors(kw):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}


def _supcon_case(ctx):
    out = {}
    for name in SUPCON:
        n, blocks, _ = SUPCON[name]
        if name == "pad_rank" and ctx.data_world != 3:
            continue
        _, _, f, kw_pad, m = _supcon_inputs(name, ctx.data_world)
        rows = ctx.rows(m)
        local = torch.from_numpy(f[:, rows].reshape(-1, 2, 8)).requires_grad_(True)
        row_mask = (torch.arange(m) < n)[rows].repeat(blocks)
        loss = losses.supcon_loss(local, row_mask=row_mask, context=ctx, blocks=blocks,
                                  **_tensors(kw_pad))
        loss.backward()
        out[name] = {"loss": float(loss), "grad": local.grad.reshape(blocks, -1, 2, 8)}
    x = torch.tensor([[1.0 + ctx.rank, -2.0], [0.5 * ctx.rank, 3.0]], requires_grad=True)
    gathered = all_gather_rows(x, ctx)
    weight = torch.arange(gathered.numel(), dtype=torch.float32).reshape(gathered.shape)
    ((gathered * weight).sum() * (ctx.rank + 1)).backward()
    out["gather"] = {"x": x.detach(), "gathered": gathered.detach(), "grad": x.grad}
    return out


# --- pretrain_main ----------------------------------------------------------
def _main_argv(root, run, *extra):
    return ["Trainer.name=iiccontrast", "Trainer.device=cpu", f"Trainer.save_dir={run}",
            f"Data.root_dir={root}", "Data.labeled_data_ratio=0.5",
            "Data.unlabeled_data_ratio=0.5", "Trainer.num_batches=1",
            "Trainer.max_epoch_train_encoder=1", "Trainer.max_epoch_train_decoder=1",
            "Trainer.max_epoch_train_finetune=1", "PretrainData.group_sample_num=1",
            "PretrainData.num_workers=0", "FineTuneData.num_workers=0",
            "FineTuneData.batch_size=3", "IICHead.Encoder.num_subheads=2",
            "IICHead.Decoder.num_subheads=2", *extra]


def _model_state(trainer):
    return {k: v.detach().clone() for k, v in trainer._model.state_dict().items()}


def _main_case(ctx, root, run):
    """``pretrain_main.main`` at the world size, every write of this rank
    recorded; then a resume from the run directory."""
    writes = []

    def spy(what, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            writes.append(what)
            return fn(*args, **kwargs)
        return wrapped

    with mock.patch.object(pretrain, "save_checkpoint", spy("checkpoint",
                                                            pretrain.save_checkpoint)), \
            mock.patch.object(Storage, "to_csv", spy("csv", Storage.to_csv)), \
            mock.patch.object(pretrain.yaml, "safe_dump", spy("config", pretrain.yaml.safe_dump)), \
            mock.patch.object(pretrain, "SummaryWriter", spy("events", pretrain.SummaryWriter)):
        first = pretrain_main.main(_main_argv(root, run, f"Parallel.num_devices={ctx.world}"))
        state = _model_state(first)
        ctx.barrier()  # both ranks have run before either lists the directory
        files = sorted(str(p.relative_to(run)) for p in Path(run).rglob("*") if p.is_file())
        resumed = pretrain_main.main(_main_argv(root, run, f"Checkpoint={run}"))
    return {"run": run, "state": state, "writes": writes, "files": files,
            "resumed": _model_state(resumed), "padded": first._padded(3)}


def _cases(ctx, cases):
    return {name: fn(ctx, *args) for name, fn, args in cases}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_pretrain_dist")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


def _jax_heads(phase):
    from mi_based_regularized_semi_supervised_segmentation_tpu.models import heads as jheads
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
        cluster_head_state_dict,
        local_projection_head_state_dict,
        projection_head_state_dict,
    )

    if phase == "encoder":
        return {"projector": (jheads.ProjectionHead(output_dim=256, head_type="mlp"),
                              projection_head_state_dict, "Conv5"),
                "iic": (jheads.ClusterHead(num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                                           head_type="linear"), cluster_head_state_dict, "Conv5")}
    return {"projector": (jheads.LocalProjectionHead(head_type="mlp", output_size=(4, 4)),
                          local_projection_head_state_dict, "Up_conv3"),
            "iic": (jheads.LocalClusterHead(num_clusters=CLUSTERS, num_subheads=SUBHEADS,
                                            head_type="mlp"), cluster_head_state_dict,
                    "Up_conv3")}


@pytest.fixture(scope="module")
def jax_start():
    """Each pretrain phase's JAX state from the U-Net of seed 0 and heads of
    seeds 11 and 12 (SGD: the move is the gradient itself, where Adam's
    first, about lr * sign(g), would hide its scale), the state as a port
    layout, the phase's step and its flip draw over the 4 slices. JAX is
    imported here only: the ranks import this module."""
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.engine import pretrain as jpre
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
        build_optimizer as j_build_optimizer,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import TrainState
    from mi_based_regularized_semi_supervised_segmentation_tpu.models import unet as junet
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.flips import (
        sample_flip_mask as j_sample_flip_mask,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
        unet_state_dict,
    )
    from test_torch_step import _np_tree

    v = junet.UNet(input_dim=1, num_classes=C).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, CROP, CROP, 1)), train=False)
    feats = junet.UNet(input_dim=1, num_classes=C).apply(
        v, jnp.zeros((4, CROP, CROP, 1)), train=False, return_features=True)[1]
    jmodel = junet.UNet(input_dim=1, num_classes=C, dtype=jnp.float64, bn_dtype=jnp.float64)
    tx = j_build_optimizer(SGD)
    out = {}
    for phase in ("encoder", "decoder"):
        hs = _jax_heads(phase)
        params = {"model": v["params"]}
        for salt, (name, (head, _, pos)) in enumerate(hs.items()):
            params[name] = head.init(jax.random.PRNGKey(11 + salt), feats[pos])["params"]
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           batch_stats=v["batch_stats"], opt_state=tx.init(params),
                           rng=jax.random.PRNGKey(1), ema_params=None)
        with jax.enable_x64(True):  # the mask the step draws (its uniforms follow x64)
            flips = np.asarray(j_sample_flip_mask(jax.random.split(state.rng)[1], 4, 0.5))
        mask = jpre.freeze_mask(params, pretrain.component_range(*COMPONENTS[phase]))
        build = (jpre.build_pretrain_encoder_step if phase == "encoder"
                 else jpre.build_pretrain_decoder_step)
        step = build(jmodel, hs["projector"][0], tx, mask=mask, iic_head=hs["iic"][0],
                     iic_weight=IIC_WEIGHT)

        def layout(params, stats, hs=hs):
            sd = unet_state_dict(params["model"], stats)
            for name, (_, to_torch, _) in hs.items():
                sd.update({f"heads.{name}.{k}": t for k, t in to_torch(params[name]).items()})
            return sd

        out[phase] = {"state": state, "step": step, "layout": layout, "flips": flips,
                      "weights": layout(_np_tree(params), _np_tree(v["batch_stats"]))}
    return out


@pytest.fixture(scope="module")
def world2(data_root, tmp_path_factory, jax_start):
    tmp = tmp_path_factory.mktemp("pw2")
    cases = [("supcon", _supcon_case, ())]
    cases += [(p, _run, (p, 5)) for p in ("encoder", "decoder")]
    cases += [(p, _run, (p, 3)) for p in ("finetune", "finetune_mt")]
    cases += [(f"jax_{p}", _jax_case, (p, (jax_start[p]["weights"], jax_start[p]["flips"])))
              for p in ("encoder", "decoder")]
    cases += [("main", _main_case, (str(data_root), str(tmp / "main")))]
    return run_ranks(_cases, 2, cases, timeout=240, workdir=str(tmp))


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    cases = [("supcon", _supcon_case, ())] + [(p, _run, (p, 6)) for p in ("encoder", "decoder")]
    return run_ranks(_cases, 3, cases, timeout=120, workdir=str(tmp_path_factory.mktemp("pw3")))


def _check_params(ref, got):
    """Adam's first step is about -LR * sign(g): every element within
    2.05 LR, and under 0.5% of them more than 0.05 LR apart."""
    n_tot = n_loose = 0
    for k, p in ref.items():
        diff = (got[k] - p).abs()
        assert float(diff.max()) <= 2.05 * LR, f"{k}: {float(diff.max())}"
        n_tot += diff.numel()
        n_loose += int((diff > 0.05 * LR).sum())
    assert n_loose / n_tot < 0.005, f"{n_loose}/{n_tot} elements apart"


def _check_step(ref, got, n_real):
    m_ref, m_got = ref["metrics"], got["metrics"]
    assert set(m_ref) == set(m_got)
    for k, v in m_ref.items():
        if k.startswith("sup_dice"):
            np.testing.assert_array_equal(m_got[k][:n_real], v, err_msg=k)
            assert not m_got[k][n_real:].any(), k
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
        for part in ("params", "buffers", "teacher"):
            for k, v in results[0][name].get(part, {}).items():
                assert torch.equal(r[name][part][k], v), f"{name}: {part} {k} differs"


@pytest.mark.parametrize("world,name", [(w, n) for w in (2, 3) for n in SUPCON
                                        if w == 3 or n != "pad_rank"])
def test_supcon_over_ranks_matches_one_process(name, world, world2, world3):
    results = world2 if world == 2 else world3
    real, kw, _, _, m = _supcon_inputs(name, world)
    n, blocks, _ = SUPCON[name]
    x = torch.from_numpy(real).requires_grad_(True)
    want = losses.supcon_loss(x, **_tensors(kw))
    want.backward()
    got = sum(r["supcon"][name]["loss"] for r in results)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    grad = torch.cat([r["supcon"][name]["grad"] for r in results], dim=1)  # [blocks, m, 2, 8]
    np.testing.assert_allclose(grad[:, :n].reshape(-1, 2, 8).numpy(), x.grad.numpy(), rtol=1e-5,
                               atol=1e-12)
    assert not grad[:, n:].any()
    if name == "pad_rank":
        assert results[2]["supcon"][name]["loss"] == 0.0


@pytest.mark.parametrize("world", [2, 3])
def test_all_gather_rows_orders_rows_and_sums_gradients(world, world2, world3):
    results = world2 if world == 2 else world3
    xs = [r["supcon"]["gather"]["x"] for r in results]
    for r in results:
        assert torch.equal(r["supcon"]["gather"]["gathered"], torch.cat(xs))
    weight = torch.arange(2 * world * 2, dtype=torch.float32).reshape(2 * world, 2)
    total = sum(rank + 1 for rank in range(world))
    for rank, r in enumerate(results):
        torch.testing.assert_close(r["supcon"]["gather"]["grad"],
                                   weight[2 * rank:2 * rank + 2] * total, rtol=0, atol=0)


@pytest.mark.parametrize("world,phase,n", [
    (2, "encoder", 5), (2, "decoder", 5), (3, "encoder", 6), (3, "decoder", 6),
    (2, "finetune", 3), (2, "finetune_mt", 3)])
def test_step_over_ranks_matches_one_process(world, phase, n, world2, world3):
    results = world2 if world == 2 else world3
    ref = _run(None, phase, n)
    for r in results:
        _check_step(ref, r[phase], n)
    _same_on_every_rank(results, phase)


@pytest.mark.parametrize("phase", ["encoder", "decoder"])
def test_two_ranks_match_jax_on_a_mesh(phase, world2, jax_start):
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.parallel import (
        make_mesh,
        replicate_state,
        shard_batch,
    )
    from test_torch_step import _np_tree

    start = jax_start[phase]
    d = _data(4)
    batch = {"image": d["image"], "image_tf": d["image_tf"], "labels": _labels(phase, 4)}
    with jax.enable_x64(True):
        mesh = make_mesh(2)
        state = jax.tree_util.tree_map(jnp.copy, start["state"])  # the step donates it
        state1, jm = start["step"](replicate_state(state, mesh),
                                   shard_batch({k: jnp.asarray(v) for k, v in batch.items()},
                                               mesh))
    after = start["layout"](_np_tree(state1.params), _np_tree(state1.batch_stats))
    before = start["weights"]
    comps = pretrain.component_range(*COMPONENTS[phase])
    for r in world2:
        got = r[f"jax_{phase}"]
        for key in ("contrastive_loss", "iic_loss", "total_loss"):
            np.testing.assert_allclose(got["metrics"][key], float(jm[key]), rtol=2e-4,
                                       atol=1e-7, err_msg=key)
        for k, p0 in before.items():
            if "running_" in k:
                np.testing.assert_allclose(got["buffers"][k].numpy(), after[k].numpy(),
                                           rtol=1e-4, atol=1e-6, err_msg=k)
            elif "num_batches" not in k:
                move = (after[k] - p0).numpy()
                port_move = (got["params"][k] - p0.double()).numpy()
                if not k.startswith("heads.") and k.split(".", 1)[0] not in comps:
                    assert not move.any() and not port_move.any(), f"frozen {k} moved"
                np.testing.assert_allclose(port_move, move, rtol=0,
                                           atol=1e-3 * float(np.abs(move).max()) + 1e-12,
                                           err_msg=k)
    _same_on_every_rank(world2, f"jax_{phase}")


def _csv_rows(run, phase):
    with open(Path(run) / phase / f"{phase}.csv") as f:
        return list(csv.DictReader(f))


def test_pretrain_main_at_two_ranks_matches_one_process_and_resumes(world2, data_root,
                                                                    tmp_path):
    run = tmp_path / "one"
    ref = pretrain_main.main(_main_argv(data_root, run))
    ranks = [r["main"] for r in world2]
    assert [r["padded"] for r in ranks] == [4, 4]
    main_run = Path(ranks[0]["run"])
    for phase in pretrain.PHASES:
        want, got = _csv_rows(run, phase), _csv_rows(main_run, phase)
        assert len(want) == len(got) == 1 and set(want[0]) == set(got[0])
        for key, value in want[0].items():
            if not value or not _is_number(value):
                assert got[0][key] == value, key
                continue
            tol = dict(rtol=0, atol=5e-3) if "_ds_" in key else dict(rtol=2e-4, atol=1e-5)
            np.testing.assert_allclose(float(got[0][key]), float(value), err_msg=key, **tol)
    # The run's steps (at lr 1e-6 and 1e-7) are too small for its parameters
    # or later losses to tell a wrong gradient sum from the one-process run's:
    # the step cases hold the summed gradients. Here the ranks must agree.
    assert set(ranks[0]["state"]) == set(_model_state(ref))
    for k, v in ranks[0]["state"].items():
        assert torch.equal(ranks[1]["state"][k], v), k
    # rank 0 alone writes: three CSVs, four checkpoints (finetune's best), the config, events
    assert sorted(set(ranks[0]["writes"])) == ["checkpoint", "config", "csv", "events"]
    assert ranks[1]["writes"] == []
    one_files = sorted(str(p.relative_to(run)) for p in run.rglob("*") if p.is_file())
    assert ranks[0]["files"] == ranks[1]["files"] == one_files
    last = torch.load(main_run / "finetune" / "last.pth", weights_only=False)["model"]
    for r in ranks:
        for k, v in last.items():
            assert torch.equal(r["resumed"][k], v), k


def _is_number(value):
    try:
        float(value)
    except ValueError:
        return False
    return True


def test_pretrain_main_checks_num_devices_against_the_world(tmp_path):
    absent = tmp_path / "absent"
    with pytest.raises(ValueError, match=r"num_devices=2 but the world size is 1.*torchrun "
                                         r"--nproc_per_node=2 -m \S*\.pretrain_main "):
        pretrain_main.main(["Trainer.device=cpu", "Data.synthetic=false",
                            f"Data.root_dir={absent}", "Parallel.num_devices=2"])
    assert not absent.exists()
