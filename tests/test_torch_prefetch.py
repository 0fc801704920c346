"""The port's background prefetch (``parallel/mesh.py:prefetch_to_device``)
against the JAX package's, and the data order it gives the trainers.

The JAX package's epoch pulls its host iterator through a thread with a
queue of depth 2: when the epoch has consumed N batches, the worker has
pulled N + 3 (two in the queue, one blocked in ``put``) if its loader keeps
ahead of the step, and as few as N + 1 if the loader is the bottleneck, since
it checks its stop flag only after a pull. Every pull moves a loader on (its
augmentation draw counter ``_draw``, its sampler's shuffles), so epoch 1
starts where those pulls left it. The port always leaves its loaders N + 3
on, deterministically; the JAX worker gets there only by timing, so the JAX
side of each comparison waits until it has.

Checked: the two prefetches over one batch source a side, N = 1 and 3, two
epochs, the port's also through a staging ring (``PinnedRing``, its copies
made lazy on the CPU): the same batches in the same order, N + 3 pulls an
epoch; the JAX and port prefetch over the JAX and port loaders on one
synthetic set (each on the native host path and on the numpy one, like with
like), 2 epochs of N = 3, with ``_draw`` equal after each epoch and epoch 1's
first batch bit-equal; the port's host-path trainer, its device-data path
without the epoch scan and the three pretrain phases pull N + 3 batches from
each loader for N steps; the prefetch itself at exact counts, with an
exception of the host iterator raised in the consumer.
"""

import threading
import time
from contextlib import closing

import numpy as np
import pytest
import torch

from test_torch_checkpoints import CROP, make_config, make_loaders

from mi_based_regularized_semi_supervised_segmentation_tpu.data import native as jax_native
from mi_based_regularized_semi_supervised_segmentation_tpu.data.acdc import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.augment import (
    PairedTransform as JPairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.loader import (
    SegmentationLoader as JSegmentationLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.parallel.mesh import (
    prefetch_to_device as jax_prefetch_to_device,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    ACDCSemiInterface,
    ContrastBatchSampler,
    PairedTransform,
    PatientEvalLoader,
    SegmentationLoader,
    TwiceLoader,
    generate_synthetic_acdc,
    native,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import (
    pretrain_zoos,
    trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.parallel import (
    prefetch_to_device,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import SummaryWriter
from test_torch_pinned_ring import LazyRing
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

SURPLUS = 3  # depth 2 + the batch the worker holds


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_prefetch")
    generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                            slices_per_patient=4, size=64)
    return root


def _jax_native_loads(timeout_s: float = 60.0) -> bool:
    """The JAX binding loaded afresh; retried while another test process may
    be writing its library (it builds into native/ without a rename)."""
    deadline = time.monotonic() + timeout_s
    while True:
        jax_native._lib, jax_native._tried = None, False
        if jax_native.available() or time.monotonic() > deadline:
            return jax_native.available()
        time.sleep(0.5)


@pytest.fixture(params=["native", "numpy"])
def host_path(request, monkeypatch):
    """Both packages on the native host path, or both on numpy."""
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    if request.param == "numpy":
        monkeypatch.setenv("MISST_DISABLE_NATIVE", "1")
    native.reset()
    if request.param == "native":
        assert native.available() and _jax_native_loads()
    else:
        assert not native.available() and not jax_native.available()
    yield request.param
    native.reset()


def _wait_for(cond, what: str, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


def test_prefetch_leaves_the_loaders_where_the_jax_one_does(data_root, host_path):
    """Two epochs of N = 3 through each package's prefetch, each over its own
    package's loader on one synthetic set: ``_draw`` equal after each epoch
    (N + 3 batches an epoch), epoch 1's first batch bit-equal."""
    n, batch = 3, 2
    tf_args = dict(rotation=45, vflip=True, hflip=True, crop=48, jitter=(0.5, 1.5))
    port = SegmentationLoader(ACDCDataset(str(data_root), "train"), PairedTransform(**tf_args),
                              batch, seed=5, num_workers=2)
    jax = JSegmentationLoader(JACDCDataset(str(data_root), "train"),
                              JPairedTransform(**tf_args), batch, seed=5, num_workers=2)
    firsts = []
    for epoch in range(2):
        want = (epoch + 1) * (n + SURPLUS) * batch
        with closing(prefetch_to_device(iter(port))) as it:
            ours = [next(it) for _ in range(n)]
        assert port._draw == want  # exact at the close, no waiting
        jit = jax_prefetch_to_device(iter(jax), None)
        theirs = [next(jit) for _ in range(n)]
        _wait_for(lambda: jax._draw == want, f"JAX worker pulled {jax._draw} of {want}")
        jit.close()  # its worker stays blocked in put, holding batch N + 3
        assert jax._draw == port._draw == want
        for a, b in zip(ours, theirs):
            assert a["filename"] == b["filename"]
        firsts.append((ours[0], theirs[0]))
    ours, theirs = firsts[1]
    np.testing.assert_array_equal(ours["image"], np.asarray(theirs["image"]))
    np.testing.assert_array_equal(ours["target"], np.asarray(theirs["target"]))
    assert ours["filename"] == theirs["filename"]


class _Counter:
    """An endless iterator that counts its pulls."""

    def __init__(self):
        self.pulls = 0

    def __iter__(self):
        while True:
            self.pulls += 1
            yield {"x": np.full(2, self.pulls)}


@pytest.mark.parametrize("consumed", [0, 1, 5])
def test_prefetch_pulls_exactly_n_plus_3(consumed):
    """N consumed, N + 3 pulled at the close, every time, and the thread gone
    after it; a generator never started (N = 0) starts no thread and pulls
    nothing, as the JAX one."""
    want = consumed + SURPLUS if consumed else 0
    for _ in range(20):
        source = _Counter()
        before = threading.active_count()
        with closing(prefetch_to_device(iter(source))) as it:
            got = [next(it) for _ in range(consumed)]
        assert [int(b["x"][0]) for b in got] == list(range(1, consumed + 1))
        assert source.pulls == want
        assert threading.active_count() == before
        time.sleep(0.01)  # a worker that pulled once more after the stop would show now
        assert source.pulls == want


def test_prefetch_ends_with_its_iterator_and_raises_its_errors():
    def finite():
        yield from ({"i": i} for i in range(4))

    with closing(prefetch_to_device(finite())) as it:
        assert [b["i"] for b in it] == [0, 1, 2, 3]

    def failing():
        yield {"i": 0}
        raise ValueError("loader broke")

    with closing(prefetch_to_device(failing())) as it:
        assert next(it)["i"] == 0
        with pytest.raises(ValueError, match="loader broke"):
            next(it)

    def failing_late():  # in a surplus pull: raised at the close
        yield {"i": 0}
        yield {"i": 1}
        raise ValueError("surplus broke")

    it = prefetch_to_device(failing_late())
    assert next(it)["i"] == 0
    with pytest.raises(ValueError, match="surplus broke"):
        it.close()


class _Batches:
    """An endless host iterator of distinct batches (an image, int32 labels,
    a list), counting its pulls."""

    def __init__(self, seed: int):
        self.rng, self.pulls = np.random.default_rng(seed), 0

    def __iter__(self):
        while True:
            self.pulls += 1
            yield {"image": self.rng.random((2, 4, 4, 1), dtype=np.float32),
                   "labels": np.full(8, self.pulls, np.int32), "group": [f"g{self.pulls}"]}


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_prefetch_hands_out_the_jax_batches(n, staged):
    """Two epochs of N steps over one host iterator a side (a phase's): the
    port's prefetch, plain or through one staging ring kept across the
    epochs (``PinnedRing``'s slots with lazy copies, as on the card), hands
    out the JAX prefetch's batches in its order and leaves its iterator
    pulled as often, N + 3 an epoch (the JAX side waited for)."""
    ours_src, theirs_src = _Batches(0), _Batches(0)
    ours_it, theirs_it = iter(ours_src), iter(theirs_src)
    ring = LazyRing() if staged else None
    for epoch in range(2):
        want = (epoch + 1) * (n + SURPLUS)
        with closing(prefetch_to_device(ours_it, ring=ring)) as it:
            ours = [next(it) for _ in range(n)]
        assert ours_src.pulls == want
        jit = jax_prefetch_to_device(theirs_it, None)
        theirs = [next(jit) for _ in range(n)]
        _wait_for(lambda: theirs_src.pulls == want,
                  f"JAX worker pulled {theirs_src.pulls} of {want}")
        jit.close()  # its worker stays blocked in put, holding batch N + 3
        assert theirs_src.pulls == want
        for a, b in zip(ours, theirs):
            assert a["group"] == b["group"]
            for k in ("image", "labels"):
                np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


class _Counting:
    """A loader whose batches are counted as they are pulled."""

    def __init__(self, loader):
        self.loader, self.pulls = loader, 0

    def __getattr__(self, name):
        return getattr(self.loader, name)

    def __iter__(self):
        for batch in self.loader:
            self.pulls += 1
            yield batch


@pytest.mark.parametrize("path", ["host", "device_data"])
def test_trainer_epochs_pull_n_plus_3_batches(data_root, tmp_path, path):
    """2 epochs of N = 1 step: each loader pulled 2 * (N + 3) times (on the
    host path ``_draw`` says so too); before the prefetch it was 2 * N."""
    n, epochs = 1, 2
    extra = {"device_data": True, "epoch_scan": False} if path == "device_data" else {}
    loaders = make_loaders(data_root)
    trainer = trainer_zoos["partial"](configuration=make_config("partial", **extra),
                                      save_dir=f"pf_{path}", max_epoch=epochs, num_batches=n,
                                      device="cpu", crop_size=CROP, run_dir=str(tmp_path),
                                      **loaders)
    trainer.init()
    names = (("_labeled_index_loader", "_unlabeled_index_loader") if path == "device_data"
             else ("_labeled_loader", "_unlabeled_loader"))
    counted = [_Counting(getattr(trainer, name)) for name in names]
    for name, loader in zip(names, counted):
        setattr(trainer, name, loader)
    trainer.start_training()
    assert [c.pulls for c in counted] == [epochs * (n + SURPLUS)] * 2
    if path == "host":
        assert loaders["labeled_loader"]._draw == epochs * (n + SURPLUS) * 2
        assert loaders["unlabeled_loader"]._draw == epochs * (n + SURPLUS) * 3


def test_pretrain_phases_pull_n_plus_3_batches(data_root, tmp_path):
    """contrastMT, 2 epochs of N = 1 in each phase: the pretrain loader is
    pulled 2 * (N + 3) times by each pretrain phase and by finetune (its
    unlabeled views), the finetune loader 2 * (N + 3) times."""
    n, epochs, group = 1, 2, 2
    tf = PairedTransform(rotation=45, vflip=True, hflip=True, crop=CROP, jitter=(0.5, 1.5))
    tf_val = PairedTransform(rotation=0, vflip=False, hflip=False, crop=CROP, center_crop=True,
                             jitter=None)
    lab, unlab, test = ACDCSemiInterface(str(data_root), 0.5, 0.5).create_semi_supervised_datasets()
    sampler = ContrastBatchSampler(unlab.stems, unlab.get_group, unlab.get_partition,
                                   group_sample_num=group, seed=10)
    pretrain_loader = TwiceLoader(unlab, tf, batch_sampler=sampler, seed=10, num_workers=2)
    fine_tune_loader = SegmentationLoader(lab, tf, 2, seed=11, num_workers=0)
    trainer = pretrain_zoos["contrastMT"](
        pretrain_loader=pretrain_loader, fine_tune_loader=fine_tune_loader,
        val_loader=PatientEvalLoader(test, tf_val),
        configuration={"RandomSeed": 10, "Arch": {"input_dim": 1, "num_classes": 4}},
        save_dir="pf_pretrain", max_epoch_train_encoder=epochs,
        max_epoch_train_decoder=epochs, max_epoch_train_finetune=epochs, num_batches=n,
        device="cpu", run_dir=str(tmp_path))
    draws = {}
    with SummaryWriter(str(tmp_path / "pf_pretrain")) as writer:
        for phase in ("pretrain_encoder", "pretrain_decoder", "finetune"):
            getattr(trainer, phase)(writer)
            draws[phase] = (pretrain_loader._draw, fine_tune_loader._draw)
    per_batch = group * 3  # a slice of each partition of each sampled patient
    per_phase = epochs * (n + SURPLUS) * per_batch
    assert draws == {"pretrain_encoder": (per_phase, 0),
                     "pretrain_decoder": (2 * per_phase, 0),
                     "finetune": (3 * per_phase, epochs * (n + SURPLUS) * 2)}
