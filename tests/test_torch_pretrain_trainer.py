"""The port's pretrain trainers through ``pretrain_main`` on the CPU, and the
two repairs that came with them: ``Trainer.profile`` writes a trace, and
``pretrain_main`` and ``main`` check the ``Parallel`` keys against the world
size before any data (the data-parallel runs are in
tests/test_torch_pretrain_distributed.py).

The trainers run end to end on a small synthetic ACDC set (64^2 slices, which
the loaders pad and crop to 224), one batch an epoch, one patient a
contrastive batch (3 slices, two views each), IIC heads of 2 subheads (the
suite runs these files in parallel with others, and CPU time at crop 224
adds up): each phase writes its CSV and
``last.pth``, finetune its ``best.pth``; every loss is finite; the frozen
components' parameters are bit-equal across each pretrain phase (the encoder
phase's checkpoint against the initial weights, the decoder phase's against
the encoder phase's); a resume from ``Checkpoint=`` restores each phase's
state bit for bit and trains only the epochs left.

The joint at the pretrain decoder's shape (padding 0, S * K = 10 x 20 = 200
lanes, lane-tiled into a 128-lane block and a 72-lane one padded to 128;
the tiling's CPU test is in tests/test_torch_mi_joint.py), marked ``cuda``
(it skips without a card): the kernel against its plain version through the
5-D loss (rtol 1e-4 of the loss, 2e-3 of the largest gradient entry: see
the test). This
file needs no JAX, so the card's run takes it (``pytest --noconftest -m
cuda``).
"""

import csv
import json
import math

import numpy as np
import pytest
import torch

from test_torch_checkpoints import CROP, make_config, make_loaders

from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import pretrain_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    component_range,
    pretrain_zoos,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import UNet
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic_local, mi_joint

SEED = 10  # pretrain.yaml's RandomSeed


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the suite runs several test processes on
    the machine's cores at once, and crop-224 steps on all cores in each
    would oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_pretrain_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


def _argv(name, data_root, run, epochs=1, *extra):
    return [f"Trainer.name={name}", "Trainer.device=cpu", f"Trainer.save_dir={run}",
            f"Data.root_dir={data_root}", "Data.labeled_data_ratio=0.5",
            "Data.unlabeled_data_ratio=0.5", "Trainer.num_batches=1",
            f"Trainer.max_epoch_train_encoder={epochs}",
            f"Trainer.max_epoch_train_decoder={epochs}",
            f"Trainer.max_epoch_train_finetune={epochs}", "PretrainData.group_sample_num=1",
            "PretrainData.num_workers=0", "FineTuneData.num_workers=0",
            "FineTuneData.batch_size=2", "IICHead.Encoder.num_subheads=2",
            "IICHead.Decoder.num_subheads=2", *extra]


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def _params(state):
    """The model's parameters of a checkpoint (BN running statistics move in
    every component: the frozen ones still run their forward in train mode)."""
    names = {n for n, _ in UNet(1, 4).named_parameters()}
    return {k: v for k, v in state["model"].items() if k in names}


def _same(a, b, components):
    return all(torch.equal(a[k], b[k]) for k in a if k.split(".", 1)[0] in components)


def _check_run(run, trainer, name):
    """Each phase's CSV (finite losses) and last.pth, finetune's best.pth, and
    the frozen components' parameters bit-equal across each pretrain phase."""
    assert type(trainer) is pretrain_zoos[name]
    losses = {"pretrain_encoder": ["contrastive_loss"], "pretrain_decoder": ["contrastive_loss"],
              "finetune": ["sup_loss"]}
    if name == "iiccontrast":
        losses["pretrain_encoder"].append("iic_loss")
        losses["pretrain_decoder"].append("iic_loss")
    if name == "contrastMT":
        losses["finetune"].append("reg_loss")
    key = {"pretrain_encoder": "PRETRAIN_ENCODER", "pretrain_decoder": "PRETRAIN_DECODER",
           "finetune": "finetune"}
    for phase, names in losses.items():
        (row,) = _rows(run / phase / f"{phase}.csv")
        for loss in names:
            assert math.isfinite(float(row[f"{key[phase]}_{loss}_mean"])), (phase, loss)
        assert (run / phase / "last.pth").is_file()
    assert 0 <= float(row["val_ds_DSC_mean"]) <= 1 and (run / "finetune" / "best.pth").is_file()
    state = {p: torch.load(run / p / "last.pth", weights_only=False) for p in losses}
    torch.manual_seed(SEED)
    init = _params({"model": UNet(1, 4).state_dict()})
    enc, dec = (_params(state[p]) for p in ("pretrain_encoder", "pretrain_decoder"))
    encoder, decoder = component_range("Conv1", "Conv5"), component_range("Up5", "Up_conv3")
    others = [c for c in component_range("Conv1", "DeConv_1x1") if c not in encoder]
    assert _same(enc, init, others) and not _same(enc, init, encoder)
    others = [c for c in component_range("Conv1", "DeConv_1x1") if c not in decoder]
    assert _same(dec, enc, others) and not _same(dec, enc, decoder)
    assert state["finetune"]["meta"]["phase"] == "finetune"
    assert (state["finetune"]["teacher"] is not None) == (name == "contrastMT")
    assert not any(p.requires_grad is False for p in trainer._model.parameters())


@pytest.mark.parametrize("name", ["contrast", "contrastMT"])
def test_pretrain_main_runs_every_phase(data_root, tmp_path, name):
    run = tmp_path / name
    _check_run(run, pretrain_main.main(_argv(name, data_root, run)), name)


def test_pretrain_main_runs_and_resumes_iiccontrast(data_root, tmp_path):
    """``iiccontrast`` end to end (as the test above), then a resume of the
    finished run with no epoch left holds last.pth's state; with one more
    epoch each phase trains epoch 1 only (its CSV: that row) and finetune
    keeps its best score."""
    run = tmp_path / "resume"
    first = pretrain_main.main(_argv("iiccontrast", data_root, run))
    _check_run(run, first, "iiccontrast")
    saved = torch.load(run / "finetune" / "last.pth", weights_only=False)
    again = pretrain_main.main(_argv("iiccontrast", data_root, run, 1, f"Checkpoint={run}"))
    for k, v in again._model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert again._best_score == first._best_score == saved["meta"]["best_score"]
    assert all(t == [] for t in again.step_times_ms.values())
    more = pretrain_main.main(_argv("iiccontrast", data_root, run, 2, f"Checkpoint={run}",
                                    "Trainer.step_timing=true"))
    for phase in ("pretrain_encoder", "pretrain_decoder", "finetune"):
        assert [r["epoch"] for r in _rows(run / phase / f"{phase}.csv")] == ["1"], phase
        assert len(more.step_times_ms[phase]) == 1
        meta = torch.load(run / phase / "last.pth", weights_only=False)["meta"]
        assert meta["cur_epoch"] == 1
    assert more._best_score >= first._best_score


@pytest.mark.parametrize("argv,error,match", [
    (["Trainer.profile=true"], TypeError, "profile"),
    (["PretrainEncoder.num_clusters=3"], ValueError, "iiccontrast only"),
    (["PretrainEncoder.group_option=slice"], ValueError, "group_option"),
])
def test_pretrain_options_are_checked(data_root, tmp_path, argv, error, match):
    args = _argv("contrast", data_root, tmp_path / "opts", 0, *argv)
    with pytest.raises(error, match=match):
        pretrain_main.main(args)


@pytest.mark.parametrize("path", ["host", "device_data", "epoch_scan"])
def test_trainer_profile_writes_a_trace(tmp_path, path, data_root):
    """``Trainer.profile``: true traces every epoch, an epoch number that
    epoch only; on the host path, the device-data path and its epoch scan."""
    trainer_kw = {"host": {}, "device_data": dict(device_data=True, epoch_scan=False),
                  "epoch_scan": dict(device_data=True, scan_chunk=1)}[path]
    for setting, want in ((True, ["epoch_000.json", "epoch_001.json"]), (1, ["epoch_001.json"])):
        run = tmp_path / f"run_{setting}"
        trainer = trainer_zoos["partial"](
            **make_loaders(data_root), configuration=make_config("partial", **trainer_kw),
            save_dir="prof", max_epoch=2, num_batches=2, device="cpu", crop_size=CROP,
            run_dir=str(run), profile=setting)
        trainer.init()
        trainer.start_training()
        traces = sorted(p.name for p in (run / "prof" / "profile").iterdir())
        assert traces == want, setting
        events = json.loads((run / "prof" / "profile" / want[-1]).read_text())["traceEvents"]
        assert events


def test_trainer_profile_raises_when_the_trace_cannot_be_written(tmp_path, data_root):
    trainer = trainer_zoos["partial"](
        **make_loaders(data_root), configuration=make_config("partial"), save_dir="prof",
        max_epoch=1, num_batches=1, device="cpu", crop_size=CROP, run_dir=str(tmp_path),
        profile=0)
    trainer.init()
    (tmp_path / "prof" / "profile").write_text("a file where the trace directory goes")
    with pytest.raises(OSError):
        trainer.start_training()


@pytest.mark.parametrize("key,value", [
    ("num_devices", 2), ("space_size", 2), ("multihost", "true"), ("data_axis", "batch"),
    ("coordinator_address", "10.0.0.1:1234"), ("num_processes", 2), ("process_id", 0),
    ("mesh_shape", 4),
])
@pytest.mark.parametrize("entry", ["main", "pretrain_main"])
def test_parallel_keys_off_their_defaults_raise(tmp_path, entry, key, value):
    """Before any data is made or loaded: the data root does not exist. Both
    entries run data parallel and check the keys against the launcher's
    world size (1 here, no launcher): a ``num_devices`` or ``space_size`` it
    cannot run, ``multihost`` without its coordinator and an unknown key
    raise ``ValueError`` (``num_devices`` naming the entry's ``torchrun``
    line); ``data_axis`` (a name) and the keys read under ``multihost`` only
    pass the check, and the run stops at the absent data."""
    run = pretrain_main.main if entry == "pretrain_main" else port_main.main
    argv = [f"Parallel.{key}={value}", "Trainer.device=cpu", "Data.synthetic=false",
            f"Data.root_dir={tmp_path / 'absent'}"]
    if key in MAIN_ACCEPTS:
        with pytest.raises(AssertionError, match="absent") as info:
            run(argv)
        assert "Parallel" not in str(info.value)
    else:
        with pytest.raises(ValueError, match=f"Parallel.{key}") as info:
            run(argv)
        if key == "num_devices":
            assert f"torchrun --nproc_per_node=2 -m {run.__module__} " in str(info.value)
    assert not (tmp_path / "absent").exists()


# the Parallel keys that both entries take at a world of 1 without a launcher
MAIN_ACCEPTS = ("data_axis", "coordinator_address", "num_processes", "process_id")


def test_parallel_defaults_pass(data_root, tmp_path):
    pretrain_main.main(_argv("contrast", data_root, tmp_path / "par", 0, "Parallel.num_devices=1",
                             "Parallel.space_size=1", "Parallel.multihost=false",
                             "Parallel.data_axis=data"))


@pytest.mark.cuda
def test_decoder_iic_on_card_matches_plain():
    """The pretrain decoder's IIC loss (5-D door, padding 0, one tile, 10 x 20
    = 200 lanes) on the card (the kernel, lane-tiled: 4 launches a product)
    against the CPU (its plain version): the loss at rtol 1e-4; both input
    gradients within 2e-3 of their largest entry. The cotangent of J comes
    from J, whose fp32 sums the two sides take in other orders, and both
    round it to bf16: where a last-bit difference crosses a rounding
    midpoint, that entry moves by one bf16 step (2^-8 of it) on one side
    (measured on the card: 0.11% of the entries beyond 1e-4 of the largest,
    the largest difference 6.1e-4 of it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    z = [rng.normal(size=(4, 28, 28, 10, 20)).astype(np.float32) for _ in range(2)]
    outs = []
    mi_joint.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        q = [torch.softmax(torch.tensor(x, device=dev), -1).requires_grad_(True) for x in z]
        loss = iic_local.iid_segmentation_small_patch_loss_subheads(q[0], q[1], padding=0,
                                                                    patch_size=512)
        loss.backward()
        outs.append([loss.item()] + [t.grad.cpu().numpy() for t in q])
    assert sum(mi_joint.LAUNCHES.values()) == 12
    assert set(p for _, p in mi_joint.LAUNCHES) == {0}
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-4)
    for got, want in zip(outs[1][1:], outs[0][1:]):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max())
