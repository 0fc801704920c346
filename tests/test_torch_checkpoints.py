"""Checkpoints and resume of the port on the CPU (``engine/checkpoints.py``,
``SemiTrainer.load_state_dict_from_path``), at crop 32 on a small synthetic
ACDC set.

A resume restores the state and not the data order: neither package restores
the samplers' position (``data/sampler.py`` reseeds per trainer). So the tests
hold the restored state itself, exactly: every tensor and counter of the
checkpoint, the epoch, best score and ``Storage``; and one more step on the
same injected batch and flip mask gives the same parameters bit for bit from
the resumed trainer as from the one that wrote the checkpoint.
"""

import csv
import json

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCSemiInterface,
    PatientEvalLoader,
    SegmentationLoader,
    create_val_split,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.augment import (
    PairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    build_optimizer,
    checkpoints,
    init_optimizer_state,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.checkpoints import (
    BEST_NAME,
    LAST_NAME,
    resolve_checkpoint,
    save_checkpoint,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

CROP = 32


def make_loaders(root, crop=CROP):
    """Host loaders over a synthetic set at ``root``: 2 + 3 train slices a
    batch, val carved from unlabeled, patient-grouped test."""
    tf_train = PairedTransform(rotation=45, vflip=True, hflip=True, crop=crop,
                               jitter=(0.5, 1.5))
    tf_val = PairedTransform(rotation=0, vflip=False, hflip=False, crop=crop,
                             center_crop=True, jitter=None)
    lab, unlab, test = ACDCSemiInterface(str(root), 0.5, 0.5).create_semi_supervised_datasets()
    return dict(
        labeled_loader=SegmentationLoader(lab, tf_train, 2, seed=0, num_workers=0),
        unlabeled_loader=SegmentationLoader(unlab, tf_train, 3, seed=1, num_workers=0),
        val_loader=PatientEvalLoader(create_val_split(unlab, 2), tf_val),
        test_loader=PatientEvalLoader(test, tf_val),
    )


def make_config(mode, clusters=5, **trainer):
    return {
        "RandomSeed": 7,
        "Arch": {"input_dim": 1, "num_classes": 4},
        "Optim": {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-5},
        "Scheduler": {"multiplier": 2, "warmup_max": 1},
        "Trainer": {"feature_names": ["Conv5", "Up_conv3", "Up_conv2"],
                    "feature_importance": [1, 0.5, 0.5], "name": mode, **trainer},
        "UDARegCriterion": {"name": "mse", "weight": 5.0},
        "IICRegParameters": {
            "EncoderParams": {"num_clusters": clusters, "num_subheads": 2},
            "DecoderParams": {"num_clusters": clusters, "num_subheads": 2},
            "LossParams": {"paddings": [1, 3], "patch_sizes": 1024},
            "weight": 0.1,
        },
        "EntropyMinParameters": {"weight": 0.5},
        "MeanTeacherParameters": {"name": "mse", "weight": 10, "alpha": 0.999,
                                  "weight_decay": 1e-4},
    }


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_ckpt_torch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


@pytest.fixture(scope="module")
def loaders(data_root):
    return make_loaders(data_root)


def _trainer(mode, loaders, run_dir, save_dir="run", clusters=5, max_epoch=1, **trainer):
    t = trainer_zoos[mode](configuration=make_config(mode, clusters, **trainer),
                           save_dir=save_dir, max_epoch=max_epoch, num_batches=2, device="cpu",
                           crop_size=CROP, run_dir=str(run_dir), **loaders)
    t.init()
    return t


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def _assert_same(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys(), got.keys() ^ want.keys()
    for path, w in want.items():
        g = got[path]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g.cpu(), w.cpu()), path
        else:
            assert g == w, path


def _one_step(trainer, seed=11):
    """One train step on a fixed batch and flip mask."""
    rng = np.random.default_rng(seed)
    batch = {"labeled_image": torch.from_numpy(rng.random((2, CROP, CROP, 1), dtype=np.float32)),
             "labeled_target": torch.from_numpy(rng.integers(0, 4, (2, CROP, CROP))),
             "unlabeled_image": torch.from_numpy(rng.random((3, CROP, CROP, 1),
                                                            dtype=np.float32))}
    trainer._train_step(batch, flip_mask=torch.from_numpy(rng.random((3, 2)) < 0.8))


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("mode", ["udaiic", "meanteacher"])
def test_resume_restores_every_tensor_and_counter(loaders, tmp_path, mode, strict):
    first = _trainer(mode, loaders, tmp_path)
    first.start_training()
    saved = torch.load(tmp_path / "run" / LAST_NAME, weights_only=True)
    assert int(saved["step"]) == 2 and saved["meta"]["cur_epoch"] == 0
    assert (saved["teacher"] is None) == (mode != "meanteacher")

    resumed = _trainer(mode, loaders, tmp_path, save_dir="resumed", max_epoch=2)
    resumed.load_state_dict_from_path(str(tmp_path / "run"), strict=strict)
    _assert_same(resumed.state_dict(), {k: v for k, v in saved.items() if k != "meta"})
    _assert_same(resumed.state_dict(), first.state_dict())
    assert resumed._start_epoch == 1 and resumed._cur_epoch == 0
    assert resumed._best_score == first._best_score == saved["meta"]["best_score"]
    assert resumed._storage.state_dict() == first._storage.state_dict()

    # the restored state is the whole state: one more step on the same batch
    # and flip mask moves both trainers alike, bit for bit
    _one_step(first)
    _one_step(resumed)
    _assert_same(resumed.state_dict(), first.state_dict())

    resumed.start_training()  # the second epoch only
    with open(tmp_path / "resumed" / "storage.csv") as f:
        assert [int(r["epoch"]) for r in csv.DictReader(f)] == [0, 1]
    assert len(resumed.epoch_times_s) == 1
    assert int(resumed._step_counter) == 2 + 1 + 2


def test_mlp_heads_run_saves_and_loads_strictly(loaders, tmp_path):
    """A udaiic run with mlp, normalized heads at every position and tiled
    patches (patch 8: 9 tiles of the 16^2 Up_conv3 map, 49 of the 32^2
    Up_conv2 one) trains, saves, and a fresh trainer of the same config
    loads its checkpoint strictly: every tensor, the mlp weights among them."""
    cfg = make_config("udaiic")
    for part in ("EncoderParams", "DecoderParams"):
        cfg["IICRegParameters"][part].update(head_types="mlp", normalize=True)
    cfg["IICRegParameters"]["LossParams"]["patch_sizes"] = 8

    def build(save_dir):
        t = trainer_zoos["udaiic"](configuration=json.loads(json.dumps(cfg)), save_dir=save_dir,
                                   max_epoch=1, num_batches=2, device="cpu", crop_size=CROP,
                                   run_dir=str(tmp_path), **loaders)
        t.init()
        return t

    first = build("mlp")
    first.start_training()
    assert np.isfinite(first._storage._rows[0]["tra_mi_mean"])
    saved = torch.load(tmp_path / "mlp" / LAST_NAME, weights_only=True)
    assert {f"heads.{n}.{k}" for n in ("Conv5", "Up_conv3", "Up_conv2")
            for k in ("w1", "b1", "w2", "b2")} <= set(saved["projector"])
    resumed = build("mlp_resumed")
    resumed.load_state_dict_from_path(str(tmp_path / "mlp"), strict=True)
    _assert_same(resumed.state_dict(), first.state_dict())


def test_lenient_load_of_partial_into_udaiic_leaves_the_projector_at_init(loaders, tmp_path,
                                                                         capsys):
    partial = _trainer("partial", loaders, tmp_path, save_dir="partial")
    partial.start_training()
    saved = torch.load(tmp_path / "partial" / LAST_NAME, weights_only=True)

    udaiic = _trainer("udaiic", loaders, tmp_path, save_dir="udaiic")
    proj_init = {k: v.clone() for k, v in udaiic._projector.state_dict().items()}
    with pytest.raises(ValueError, match="/projector"):
        udaiic.load_state_dict_from_path(str(tmp_path / "partial"), strict=True)
    capsys.readouterr()
    udaiic.load_state_dict_from_path(str(tmp_path / "partial"), strict=False)
    assert "entries missing from the checkpoint" in capsys.readouterr().out
    _assert_same(udaiic._model.state_dict(), saved["model"])
    _assert_same(udaiic._projector.state_dict(), proj_init)
    # Adam: the model's entries (the optimizer's first parameters) from the
    # checkpoint, the projector's still at zero
    state = udaiic._optimizer.state_dict()["state"]
    n_model = len(list(udaiic._model.parameters()))
    for i, entry in saved["optimizer"]["state"].items():
        assert i < n_model
        _assert_same(state[i], entry)
    for i in range(n_model, len(state)):
        assert float(state[i]["step"]) == 0 and not state[i]["exp_avg"].any()
    assert udaiic._start_epoch == 1


def test_strict_load_with_a_shape_mismatch_raises(loaders, tmp_path):
    five = _trainer("udaiic", loaders, tmp_path, save_dir="five")
    five.save(0.5)
    six = _trainer("udaiic", loaders, tmp_path, save_dir="six", clusters=6)
    before = {k: v.clone() for k, v in six._projector.state_dict().items()}
    with pytest.raises(ValueError, match=r"/projector/heads\.Conv5\.linear\.weight: "
                                         r"tensor\[12, 256\] in the trainer, tensor\[10, 256\]"):
        six.load_state_dict_from_path(str(tmp_path / "five"), strict=True)
    six.load_state_dict_from_path(str(tmp_path / "five"), strict=False)
    after = six._projector.state_dict()
    for key, value in before.items():  # every head changed its width: all at init
        assert torch.equal(after[key], value), key
    _assert_same(six._model.state_dict(), five._model.state_dict())


def test_checkpoint_paths_resolve_to_last_for_resume_and_best_for_inference(loaders, tmp_path):
    trainer = _trainer("partial", loaders, tmp_path)
    run = tmp_path / "run"
    trainer.save(0.9)  # best.pth and last.pth: this state
    best_weight = trainer._model.DeConv_1x1.weight.detach().clone()
    with torch.no_grad():
        trainer._model.DeConv_1x1.weight.add_(1.0)
    trainer._cur_epoch = 3
    trainer.save(0.1)  # not better: last.pth only
    assert resolve_checkpoint(run) == run / LAST_NAME
    assert resolve_checkpoint(run, BEST_NAME) == run / BEST_NAME
    assert resolve_checkpoint(run / BEST_NAME) == run / BEST_NAME
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint(tmp_path / "absent")

    other = _trainer("partial", loaders, tmp_path, save_dir="other")
    other.load_state_dict_from_path(str(run))
    assert other._start_epoch == 4 and other._best_score == 0.9
    assert torch.equal(other._model.DeConv_1x1.weight, best_weight + 1.0)
    other.inference(str(run))
    assert torch.equal(other._model.DeConv_1x1.weight, best_weight)
    with pytest.raises(FileNotFoundError):
        other.inference(str(tmp_path / "other"))  # no best.pth there yet


def test_adam_state_made_at_init_steps_as_torchs_own():
    """The Adam state that trainers create at init (so that a checkpoint has
    every entry from the start) steps bit for bit as torch's lazy one."""
    torch.manual_seed(0)
    models = [torch.nn.Linear(5, 3) for _ in range(2)]
    models[1].load_state_dict(models[0].state_dict())
    opts = [build_optimizer(m.parameters(), {"name": "Adam", "lr": 1e-3, "weight_decay": 1e-4})
            for m in models]
    init_optimizer_state(opts[1])
    assert len(opts[0].state) == 0 and len(opts[1].state) == 2
    x = torch.randn(7, 5)
    for _ in range(3):
        for model, opt in zip(models, opts):
            opt.zero_grad()
            model(x).pow(2).sum().backward()
            opt.step()
    _assert_same(opts[1].state_dict(), opts[0].state_dict())
    _assert_same(models[1].state_dict(), models[0].state_dict())


class _Interrupted(Exception):
    pass


def test_an_interrupted_write_keeps_the_previous_checkpoint(tmp_path, monkeypatch):
    path = tmp_path / LAST_NAME
    first = {"model": {"w": torch.arange(6.0)}, "step": torch.tensor(1)}
    save_checkpoint(path, first, {"cur_epoch": 0})
    real_save = torch.save

    def torn_save(obj, f):
        real_save(obj, f)
        with open(f, "r+b") as fh:  # the job dies half-way through the write
            fh.truncate(fh.seek(0, 2) // 2)
        raise _Interrupted

    monkeypatch.setattr(checkpoints.torch, "save", torn_save)
    with pytest.raises(_Interrupted):
        save_checkpoint(path, {"model": {"w": torch.zeros(6)}, "step": torch.tensor(2)},
                        {"cur_epoch": 1})
    monkeypatch.undo()
    assert sorted(p.name for p in tmp_path.iterdir()) == [LAST_NAME]
    state, meta = checkpoints.load_checkpoint(path, first)
    _assert_same(state, first)
    assert meta == {"cur_epoch": 0}


def test_main_resumes_a_run_and_runs_inference(data_root, tmp_path):
    """``main.main``: one epoch, then ``Checkpoint=<run dir>`` with
    ``Trainer.max_epoch=2`` and ``Inference=true``: the resumed run trains
    epoch 1 only, then evaluates best.pth with the PNG dumps."""
    run = tmp_path / "cli"
    argv = ["Trainer.name=meanteacher", f"Trainer.save_dir={run}", "Trainer.device=cpu",
            "Trainer.num_batches=2", f"Data.root_dir={data_root}",
            "Data.labeled_data_ratio=0.5", "Data.unlabeled_data_ratio=0.5",
            "LabeledData.batch_size=2", "UnlabeledData.batch_size=2",
            "LabeledData.num_workers=0", "UnlabeledData.num_workers=0"]
    first = port_main.main(argv + ["Trainer.max_epoch=1"])
    assert int(first._step_counter) == 2
    resumed = port_main.main(argv + ["Trainer.max_epoch=2", f"Checkpoint={run}",
                                     "Inference=true"])
    assert resumed._start_epoch == 1 and sorted(resumed._storage._rows) == [0, 1]
    assert len(resumed.epoch_times_s) == 1 and int(resumed._step_counter) == 4
    report = json.loads((run / "inference.json").read_text())
    assert set(report) == {"loss", "dice", "hd"} and 0 <= report["dice"]["DSC_mean"] <= 1
    n_test = len(resumed._test_loader.dataset)
    for folder in ("img", "gt", "pred"):
        assert len(list((run / folder).glob("*.png"))) == n_test, folder
