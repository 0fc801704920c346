"""The train loaders with ``own_process`` (``data/loader.py:_OwnProcess``):
their batches made in a process of the loader's own, as ``pretrain_main``
makes them on a card, so the loader's threads never hold the trainer's GIL.

Checked: the batches equal, bit for bit, those of the same loader on
threads and of the JAX package's loader (native against native, numpy
against numpy), the draw counter and the native calls counted as on
threads; ``set_total_freedom`` reaching the process between batches; a
batch that outgrows the shared region the arrays cross in; the
loader's error raised in the caller, a process that died named; ``close``
and a restart; a daemonic caller keeping the threads; the prefetch's N + 3
pulls; ``pretrain_main`` and ``main`` with such loaders writing the
threaded runs' CSVs.
"""

import csv
from contextlib import closing

import numpy as np
import pytest

from mi_based_regularized_semi_supervised_segmentation_tpu.data.acdc import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.augment import (
    PairedTransform as JPairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.loader import (
    SegmentationLoader as JSegmentationLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.loader import (
    TwiceLoader as JTwiceLoader,
)
import mi_based_regularized_semi_supervised_segmentation_tpu_torch as port_package
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import main as port_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import pretrain_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    PairedTransform,
    SegmentationLoader,
    TwiceLoader,
    generate_synthetic_acdc,
    loader as loader_mod,
    native,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import pretrain
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    prefetch_to_device,
)
from test_torch_augment_geometry import host_path  # noqa: F401  (both packages, one path)
from test_torch_pinned_ring import LazyRing
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

TF = dict(rotation=45, vflip=True, hflip=True, crop=48, jitter=(0.5, 1.5))
KEYS = ("image", "target", "image_tf", "target_tf")


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_own_process")
    generate_synthetic_acdc(str(root), num_train_patients=3, num_val_patients=1,
                            slices_per_patient=4, size=64)
    return root


def _same(a, b, keys):
    for k in keys:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert a["filename"] == b["filename"] and a["group"] == b["group"]


def test_twice_loader_in_its_process_equals_threads_and_jax(data_root, host_path):
    """4 batches of 4 slices, the geometry shared, then independent (switched
    between batches): each package's loader on threads and the port's in its
    own process, bit-equal; its draw counter and native calls as on threads."""
    make = lambda own: TwiceLoader(ACDCDataset(str(data_root), "train"), PairedTransform(**TF),
                                   batch_size=4, total_freedom=False, seed=4, num_workers=2,
                                   own_process=own)
    own, threads = make(True), make(False)
    theirs = JTwiceLoader(JACDCDataset(str(data_root), "train"), JPairedTransform(**TF),
                          batch_size=4, total_freedom=False, seed=4, num_workers=2)
    try:
        assert own._process is not None and own._pool is None
        got = {}
        for name, loader in (("own", own), ("threads", threads), ("jax", theirs)):
            native.reset_call_counts()
            it, batches = iter(loader), []
            for i in range(4):
                if i == 2:
                    loader.set_total_freedom(True)
                batches.append(next(it))
            got[name] = (batches, dict(native.CALLS), loader._draw)
        for a, b, c in zip(got["own"][0], got["threads"][0], got["jax"][0]):
            _same(a, b, KEYS)
            _same(a, c, KEYS)
        assert got["own"][1:] == got["threads"][1:] == (got["own"][1], 16)
        if host_path == "native":  # the independent views' augment pairs, counted back
            assert got["own"][1]["augment_pair"] == 2 * 4 * 2
    finally:
        own.close()


def test_segmentation_loader_in_its_process_through_the_prefetch(data_root):
    """Two epochs of N = 1 through the prefetch (and a staging ring): the
    JAX loader's batches, N + 3 pulls an epoch."""
    own = SegmentationLoader(ACDCDataset(str(data_root), "train"), PairedTransform(**TF), 2,
                             seed=5, num_workers=2, own_process=True)
    theirs = iter(JSegmentationLoader(JACDCDataset(str(data_root), "train"),
                                      JPairedTransform(**TF), 2, seed=5, num_workers=2))
    try:
        ring = LazyRing()
        ours_it = iter(own)
        for epoch in range(2):
            with closing(prefetch_to_device(ours_it, ring=ring)) as it:
                got = next(it)
            assert own._draw == (epoch + 1) * 4 * 2
            want = [next(theirs) for _ in range(4)][0]
            np.testing.assert_array_equal(got["image"].numpy(), want["image"])
            np.testing.assert_array_equal(got["target"].numpy(), want["target"])
            assert got["filename"] == want["filename"]
    finally:
        own.close()


def test_batches_outgrowing_the_shared_region(data_root):
    """Batches of 1, 4, 2 and 4 slices: the region the arrays cross in is
    made again when a batch outgrows it; every batch the threads' one."""
    sizes = [[0], [0, 1, 2, 3], [4, 5], [6, 7, 8, 9]]
    make = lambda own: TwiceLoader(ACDCDataset(str(data_root), "train"), PairedTransform(**TF),
                                   batch_sampler=sizes, seed=6, num_workers=2, own_process=own)
    own, threads = make(True), make(False)
    try:
        regions = []
        for a, b in zip(own, threads):
            _same(a, b, KEYS)
            regions.append(own._process._region.size)
        assert regions[0] < regions[1] == regions[2] == regions[3]
    finally:
        own.close()


def test_errors_close_and_restart(data_root):
    dataset = ACDCDataset(str(data_root), "train")
    loader = TwiceLoader(dataset, PairedTransform(**TF), batch_sampler=[[0, 1], [len(dataset)]],
                         seed=4, num_workers=2, own_process=True)
    it = iter(loader)
    assert next(it)["filename"] == [dataset.stems[0], dataset.stems[1]]
    with pytest.raises(IndexError):
        next(it)  # the sampler's bad index, raised in the loader's process
    loader._process._process.kill()
    loader._process._process.join(timeout=30)
    assert not loader._process._process.is_alive()
    with pytest.raises(RuntimeError, match="process .* ended"):
        next(iter(loader))
    loader.close()
    assert loader._process is None
    threads = TwiceLoader(dataset, PairedTransform(**TF), batch_sampler=[[0, 1]], seed=4,
                          num_workers=2)
    threads._draw = loader._draw  # the draws of the batches that failed are spent
    restarted = next(iter(loader))  # a new process on the next batch
    try:
        assert loader._process is not None
        _same(restarted, next(iter(threads)), KEYS)
    finally:
        loader.close()


def test_a_daemonic_caller_keeps_the_threads(data_root, monkeypatch):
    class Daemon:
        daemon = True

    monkeypatch.setattr(loader_mod.mp, "current_process", lambda: Daemon())
    loader = SegmentationLoader(ACDCDataset(str(data_root), "train"), PairedTransform(**TF), 2,
                                num_workers=2, own_process=True)
    assert loader._process is None and loader._pool is not None
    assert next(iter(loader))["image"].shape == (2, 48, 48, 1)


def test_main_with_loaders_in_their_processes(tmp_path, monkeypatch):
    """The partial trainer through ``main.main`` on the CPU, one step of 1 +
    1 slices, with the host path's loaders in their own processes (as on a
    card) and on threads: the same storage CSV, value for value; the
    loaders' processes closed at the end."""
    monkeypatch.setattr(port_package, "DATA_PATH", str(tmp_path / "data"))  # main reads it
    argv = ["Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=partial", "Trainer.num_batches=1",
            "Trainer.max_epoch=1", "Trainer.device=cpu", "LabeledData.batch_size=1",
            "UnlabeledData.batch_size=1", f"Trainer.run_dir={tmp_path / 'runs'}"]
    real = port_main.get_dataloaders
    made = []
    for own in (True, False):
        def dataloaders(*args, **kwargs):
            loaders = real(*args, **{**kwargs, "own_process": own})
            made.append(loaders[:2])
            return loaders
        with monkeypatch.context() as m:
            m.setattr(port_main, "get_dataloaders", dataloaders)
            port_main.main(argv + [f"Trainer.save_dir=own_{own}"])
    assert [loader._own_process for loader in made[0] + made[1]] == [True] * 2 + [False] * 2
    assert all(loader._process is None for loader in made[0])  # closed by main
    rows = [_rows(tmp_path / "runs" / f"own_{own}", ".", "storage.csv") for own in (True, False)]
    assert rows[0] == rows[1] and len(rows[0]) == 2


def _rows(run, phase, name=None):
    with open(run / phase / (name or f"{phase}.csv")) as f:
        return list(csv.reader(f))


def test_pretrain_main_with_loaders_in_their_processes(tmp_path, monkeypatch):
    """iiccontrast through ``pretrain_main`` on the CPU, one batch of one
    patient an epoch, with the loaders in their own processes (as on a card)
    and on threads: the same CSVs, value for value."""
    monkeypatch.setenv("MISST_DATA_PATH", str(tmp_path / "data"))
    monkeypatch.setattr(pretrain_main, "DATA_PATH", str(tmp_path / "data"))
    argv = ["Trainer.device=cpu", "Data.synthetic=true", "Data.labeled_data_ratio=0.25",
            "Data.unlabeled_data_ratio=0.75", "Trainer.name=iiccontrast",
            "Trainer.num_batches=1", "Trainer.max_epoch_train_encoder=1",
            "Trainer.max_epoch_train_decoder=1", "Trainer.max_epoch_train_finetune=1",
            "PretrainData.group_sample_num=1", "FineTuneData.batch_size=1",
            "IICHead.Encoder.num_subheads=2", "IICHead.Decoder.num_subheads=2"]
    runs = {}
    for own in (True, False):
        force = lambda cls: (lambda *a, **k: cls(*a, **{**k, "own_process": own}))
        with monkeypatch.context() as m:
            m.setattr(pretrain.ContrastTrainer, "RUN_DIR", str(tmp_path / "runs"))
            m.setattr(pretrain_main, "TwiceLoader", force(TwiceLoader))
            m.setattr(pretrain_main, "SegmentationLoader", force(SegmentationLoader))
            trainer = pretrain_main.main(argv + [f"Trainer.save_dir=own_{own}"])
        assert trainer._pretrain_loader._own_process is own
        assert trainer._pretrain_loader._process is None  # closed by pretrain_main
        runs[own] = tmp_path / "runs" / f"own_{own}"
    for phase in pretrain.PHASES:
        assert _rows(runs[True], phase) == _rows(runs[False], phase)
