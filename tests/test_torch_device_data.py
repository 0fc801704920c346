"""The port's device-data path on the CPU against the JAX package's: the
staged store, the index loaders, the on-device augmentation with the JAX
draws injected, and the device eval step.

Inputs: a synthetic ACDC set (64^2 slices staged on a 72 x 80 canvas, so
every slice has a valid window off the canvas origin), numpy seeds, and the
JAX package's own draws from its keys (threefry and Philox streams never
match, so draws are injected, not compared). Tolerances:
- store, loaders, crop offsets, labels: exact;
- images without jitter: exact (the same rint of the same fp32 source
  coordinates, then the same gather);
- images with jitter: atol 1e-6 (values are below ~2; the per-image mean is
  a sum in another order);
- eval loss rtol 1e-5 (convolution sums in another order), inter and union
  exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.data import (
    ACDCDataset as JACDCDataset,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.device_pipeline import (
    DeviceDataStore as JStore,
    DeviceIndexLoader as JIndexLoader,
    DevicePatientEvalLoader as JEvalLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.state import init_train_state
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.optim import (
    build_optimizer as j_build_optimizer,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine.steps import (
    build_eval_step as j_build_eval_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.models import UNet as JUNet
from mi_based_regularized_semi_supervised_segmentation_tpu.ops.augment_device import (
    _crop_offsets_in_window as j_crop_offsets,
    augment_pair_batch as j_augment_pair_batch,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import (
    ACDCDataset,
    generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data.device_pipeline import (
    DeviceDataStore,
    DeviceIndexLoader,
    DevicePatientEvalLoader,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
    build_eval_step,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import UNet
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.augment_device import (
    apply_augment,
    crop_offsets_in_window,
    crop_batch,
    sample_augment_params,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import unet_state_dict
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

PAD_TO = (72, 80)
CROP = 48


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("acdc_dev_torch"))
    generate_synthetic_acdc(root, num_train_patients=4, num_val_patients=2,
                            slices_per_patient=4, size=64)
    port = DeviceDataStore(ACDCDataset(root, "train"), pad_to=PAD_TO, pack=True)
    jstore = JStore(JACDCDataset(root, "train"), pad_to=PAD_TO, pack=True)
    return port, jstore


def jax_draws(key, b, shape, crop, valid_hw=None, offsets=None, rotation=45.0,
              jitter=(0.5, 1.5), flips=True):
    """The draws ``augment_pair_batch`` makes from ``key``
    (ops/augment_device.py:143-166 and :241-244), as the port's params."""
    h, w = shape
    k_rot, k_v, k_h, k_y, k_x, k_b, k_c = jax.random.split(key, 7)
    p = {"angles": None, "vflip": None, "hflip": None, "brightness": None, "contrast": None}
    if rotation:
        p["angles"] = jax.random.uniform(k_rot, (b,), minval=-rotation, maxval=rotation)
    if flips:
        p["vflip"] = jax.random.bernoulli(k_v, 0.5, (b,))
        p["hflip"] = jax.random.bernoulli(k_h, 0.5, (b,))
        if offsets is not None:
            top = jnp.where(p["vflip"], h - offsets[:, 0] - valid_hw[:, 0], offsets[:, 0])
            left = jnp.where(p["hflip"], w - offsets[:, 1] - valid_hw[:, 1], offsets[:, 1])
            offsets = jnp.stack([top, left], axis=1)
    if valid_hw is not None and offsets is not None:
        p["ys"] = j_crop_offsets(k_y, b, valid_hw[:, 0], offsets[:, 0], crop, h)
        p["xs"] = j_crop_offsets(k_x, b, valid_hw[:, 1], offsets[:, 1], crop, w)
    else:
        p["ys"] = jax.random.randint(k_y, (b,), 0, max(h - crop, 0) + 1)
        p["xs"] = jax.random.randint(k_x, (b,), 0, max(w - crop, 0) + 1)
    if jitter is not None:
        p["brightness"] = jax.random.uniform(k_b, (b, 1, 1), minval=jitter[0],
                                             maxval=jitter[1])[:, 0, 0]
        p["contrast"] = jax.random.uniform(k_c, (b, 1, 1), minval=jitter[0],
                                           maxval=jitter[1])[:, 0, 0]
    return {k: None if v is None else torch.from_numpy(np.array(v)) for k, v in p.items()}


def test_store_equals_jax_store(stores):
    port, jstore = stores
    np.testing.assert_array_equal(port.images.numpy(), np.asarray(jstore.images))
    np.testing.assert_array_equal(port.labels.numpy(), np.asarray(jstore.labels))
    assert port.packed.dtype == torch.uint16
    np.testing.assert_array_equal(port.packed.numpy(), np.asarray(jstore.packed))
    np.testing.assert_array_equal(port.valid_hw, jstore.valid_hw)
    np.testing.assert_array_equal(port.offsets, jstore.offsets)
    np.testing.assert_array_equal(port.valid_hw_dev.numpy(), jstore.valid_hw)
    np.testing.assert_array_equal(port.offsets_dev.numpy(), jstore.offsets)
    assert port.stems == jstore.stems and port.groups == jstore.groups
    assert port.partitions == jstore.partitions
    assert port.shape == jstore.shape == PAD_TO and len(port) == len(jstore) == 16
    assert port.offsets[0].tolist() == [4, 8]


def test_index_loaders_equal_jax(stores):
    port, jstore = stores
    it, jit_ = iter(DeviceIndexLoader(port, 3, seed=5)), iter(JIndexLoader(jstore, 3, seed=5))
    for _ in range(12):  # more than two passes over the 16 slices
        a, b = next(it), next(jit_)
        np.testing.assert_array_equal(a["indices"], b["indices"])
        assert a["indices"].dtype == np.int32 and a["group"] == b["group"]
    ev, jev = DevicePatientEvalLoader(port), JEvalLoader(jstore)
    assert len(ev) == len(jev) == 4 and ev.padded_size == jev.padded_size == 8
    for a, b in zip(ev, jev):
        for k in ("indices", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
        assert a["group"] == b["group"] and a["filename"] == b["filename"]


def test_crop_offsets_in_window_equal_jax():
    rng = np.random.default_rng(0)
    size = rng.integers(10, 90, 64).astype(np.int32)
    start = rng.integers(0, 40, 64).astype(np.int32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(j_crop_offsets(key, 64, jnp.asarray(size), jnp.asarray(start), 32, 96))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (64,))))
    got = crop_offsets_in_window(u, torch.from_numpy(size), torch.from_numpy(start), 32, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def test_crop_batch_clamps_like_dynamic_slice():
    x = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(2, 8, 8)
    got = crop_batch(x, torch.tensor([-3, 7]), torch.tensor([6, -1]), 4)
    torch.testing.assert_close(got[0], x[0, 0:4, 4:8], rtol=0, atol=0)
    torch.testing.assert_close(got[1], x[1, 4:8, 0:4], rtol=0, atol=0)


def test_sample_augment_params_bounds(stores):
    port, _ = stores
    gen = torch.Generator().manual_seed(0)
    idx = torch.arange(16)
    p = sample_augment_params(gen, 16, port.shape, crop=CROP, valid_hw=port.valid_hw_dev[idx],
                              offsets=port.offsets_dev[idx])
    assert p["angles"].abs().max() <= 45.0 and p["angles"].std() > 5.0
    assert 0.5 <= float(p["brightness"].min()) and float(p["contrast"].max()) <= 1.5
    # the crop lies in the (flipped) valid window of each 64^2 slice
    top = torch.where(p["vflip"], PAD_TO[0] - 4 - 64, torch.tensor(4))
    left = torch.where(p["hflip"], PAD_TO[1] - 8 - 64, torch.tensor(8))
    assert bool(((p["ys"] >= top) & (p["ys"] + CROP <= top + 64)).all())
    assert bool(((p["xs"] >= left) & (p["xs"] + CROP <= left + 64)).all())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("geometry", ["fused", "sequential", "shear"])
def test_augment_matches_jax_with_injected_draws(stores, geometry, packed):
    port, jstore = stores
    idx = np.array([0, 3, 5, 9, 14], np.int32)
    for seed, jitter in ((1, None), (2, (0.5, 1.5))):
        key = jax.random.PRNGKey(seed)
        vh, off = jstore.valid_hw_dev[idx], jstore.offsets_dev[idx]
        if packed:
            j_args = (jstore.packed[idx], None)
            args = (port.packed[torch.from_numpy(idx).long()], None)
        else:
            j_args = (jstore.images[idx], jstore.labels[idx])
            args = (port.images[torch.from_numpy(idx).long()],
                    port.labels[torch.from_numpy(idx).long()])
        want_img, want_lab = j_augment_pair_batch(key, *j_args, crop=CROP, jitter=jitter,
                                                  valid_hw=vh, offsets=off, geometry=geometry,
                                                  packed=packed)
        params = jax_draws(key, len(idx), port.shape, CROP, vh, off, jitter=jitter)
        img, lab = apply_augment(*args, params, crop=CROP, geometry=geometry, packed=packed)
        assert img.shape == (5, CROP, CROP, 1) and lab.dtype == torch.int32
        np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
        if jitter is None:
            np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
        else:
            np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=1e-6)


def test_unlabeled_augment_without_windows_matches_jax(stores):
    """No labels, no valid windows (crop offsets uniform over the canvas)."""
    port, jstore = stores
    idx = np.array([2, 7, 11], np.int32)
    key = jax.random.PRNGKey(9)
    want, _ = j_augment_pair_batch(key, jstore.images[idx], None, crop=CROP, jitter=None)
    params = jax_draws(key, 3, port.shape, CROP, jitter=None)
    got, lab = apply_augment(port.images[torch.from_numpy(idx).long()], None, params, crop=CROP)
    assert lab is None
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_device_eval_step_matches_jax(stores):
    port, jstore = stores
    jmodel = JUNet(input_dim=1, num_classes=4)
    state = init_train_state(jmodel, j_build_optimizer({"name": "Adam", "lr": 1e-3}),
                             (1, 32, 32, 1), seed=0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    stats = jax.tree_util.tree_map(np.asarray, jax.device_get(state.batch_stats))
    jeval = j_build_eval_step(jmodel, num_classes=4, data_store=jstore, crop=32)
    model = UNet(1, 4)
    model.load_state_dict(unet_state_dict(params["model"], stats))
    ev = build_eval_step(model, num_classes=4, data_store=port, crop=32)
    for batch in DevicePatientEvalLoader(port):
        want = jeval(state.params, state.batch_stats, jnp.asarray(batch["indices"]),
                     jnp.asarray(batch["mask"]))
        got = ev(torch.from_numpy(batch["indices"]), torch.from_numpy(batch["mask"]))
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(got["inter"].numpy(), np.asarray(want["inter"]))
        np.testing.assert_array_equal(got["union"].numpy(), np.asarray(want["union"]))
