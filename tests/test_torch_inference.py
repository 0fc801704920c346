"""Inference of the port against the JAX package's, on the CPU.

- ``SurfaceMeter`` (Hausdorff, HD95, ASSD) on the same prediction volumes as
  the JAX meter: exactly equal summaries, including a volume with a class
  missing from the prediction, where both keep the classes added before it
  (the ``RuntimeError`` swallowed by ``ExceptionIgnorer`` as inference does).
- ``SemiTrainer.inference`` with the JAX trainer's initial weights carried
  over by ``weights.py`` (crop 32, synthetic ACDC), against the JAX
  ``inference()``: the PNG predictions of both are compared pixel by pixel.
  The two forwards sum in different orders, so a pixel whose two largest
  logits tie to float32 noise may take another class: at most 1 in 10^4 of
  the pixels may differ (none did on this input). DSC_mean within 1e-4 and
  each class's Hausdorff distance within 1 pixel (a flipped border pixel
  moves it by at most its distance to the next surface point); on
  identical predictions both are exact.
- On ``Trainer.device_data`` the port forwards from the device store: the
  same report as the trainer's own ``_eval_epoch`` (DSC within 1e-6), the
  same predictions as the host path, one PNG per test slice in each folder.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
from PIL import Image

from test_torch_checkpoints import CROP, make_config, make_loaders

from mi_based_regularized_semi_supervised_segmentation_tpu.data import (
    PatientEvalLoader as JPatientEvalLoader,
    SegmentationLoader as JSegmentationLoader,
    create_val_split as j_create_val_split,
    generate_synthetic_acdc as j_generate_synthetic_acdc,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.acdc import (
    ACDCSemiInterface as JACDCSemiInterface,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.data.augment import (
    PairedTransform as JPairedTransform,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.engine import (
    trainer_zoos as j_trainer_zoos,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.utils.general import (
    ExceptionIgnorer as JExceptionIgnorer,
)
from mi_based_regularized_semi_supervised_segmentation_tpu.utils.meters import (
    SurfaceMeter as JSurfaceMeter,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer_zoos
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import (
    ExceptionIgnorer,
    SurfaceMeter,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import unet_state_dict
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)


def _volumes(seed):
    """Prediction / target volumes [4, 24, 24] with 4 classes as blobs: a
    disc per foreground class, its centre and radius drawn per volume."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:24, :24]
    out = []
    for _ in range(2):
        vol = np.zeros((4, 24, 24), np.int64)
        for c in (1, 2, 3):
            cy, cx = rng.integers(5, 19, 2)
            r = rng.uniform(2.0, 5.0)
            for z in range(4):
                vol[z][(yy - cy) ** 2 + (xx - cx + z) ** 2 <= r * r] = c
        out.append(vol)
    return out


@pytest.mark.parametrize("method", ["hausdorff", "hd95", "assd"])
def test_surface_meter_matches_jax_exactly(method):
    meters = [(SurfaceMeter(4, metername=method), ExceptionIgnorer),
              (JSurfaceMeter(4, metername=method), JExceptionIgnorer)]
    pairs = [_volumes(seed) for seed in range(3)]
    pred, target = _volumes(9)
    pred[pred == 2] = 0  # class 2 absent from this prediction: raises at class 2
    pairs.append((pred, target))
    for meter, ignorer in meters:
        for pred, target in pairs:
            with ignorer(RuntimeError):
                meter.add(pred, target)
    ours, theirs = meters[0][0], meters[1][0]
    # class 1 took all four volumes, classes 2 and 3 the first three only
    assert [len(ours._values[c]) for c in (1, 2, 3)] == [4, 3, 3]
    assert ours.summary().keys() == {f"{method}{c}" for c in (1, 2, 3)} | {f"{method}_mean"}
    assert ours.summary() == theirs.summary()
    for c in (1, 2, 3):
        assert ours._values[c] == theirs._values[c]


def test_surface_meter_raises_on_empty_masks_like_jax():
    pred, target = _volumes(4)
    for meter in (SurfaceMeter(4), JSurfaceMeter(4)):
        with pytest.raises(RuntimeError, match="empty mask"):
            meter.add(np.zeros_like(pred), target)
    assert SurfaceMeter(4).summary() == JSurfaceMeter(4).summary() == {}


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_inference")
    j_generate_synthetic_acdc(str(root), num_train_patients=6, num_val_patients=2,
                              slices_per_patient=4, size=64)
    return root


def _jax_loaders(root):
    tf_train = JPairedTransform(rotation=45, vflip=True, hflip=True, crop=CROP,
                                jitter=(0.5, 1.5))
    tf_val = JPairedTransform(rotation=0, vflip=False, hflip=False, crop=CROP,
                              center_crop=True, jitter=None)
    lab, unlab, test = JACDCSemiInterface(str(root), 0.5, 0.5).create_semi_supervised_datasets()
    return dict(
        labeled_loader=JSegmentationLoader(lab, tf_train, 2, seed=0, num_workers=0),
        unlabeled_loader=JSegmentationLoader(unlab, tf_train, 3, seed=1, num_workers=0),
        val_loader=JPatientEvalLoader(j_create_val_split(unlab, 2), tf_val),
        test_loader=JPatientEvalLoader(test, tf_val),
    )


@pytest.fixture(scope="module")
def jax_inference(data_root, tmp_path_factory):
    """The JAX trainer's initial state as best.ckpt, its inference report,
    and the model weights in the port's layout."""
    run_dir = tmp_path_factory.mktemp("jax_runs")
    trainer = j_trainer_zoos["partial"](configuration=make_config("partial"), save_dir="jax",
                                        max_epoch=1, num_batches=2, crop_size=CROP,
                                        run_dir=str(run_dir), **_jax_loaders(data_root))
    trainer.init()
    trainer.save(0.5)
    report, _ = trainer.inference()
    state = trainer._state
    weights = unet_state_dict(_np(state.params["model"]), _np(state.batch_stats))
    return report, run_dir / "jax", weights


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _port_inference(data_root, run_dir, weights, **trainer_cfg):
    loaders = make_loaders(data_root)
    trainer = trainer_zoos["partial"](configuration=make_config("partial", **trainer_cfg),
                                      save_dir="port", max_epoch=1, num_batches=2, device="cpu",
                                      crop_size=CROP, run_dir=str(run_dir), **loaders)
    trainer.init()
    trainer._model.load_state_dict(weights)
    trainer.save(0.5)
    report, score = trainer.inference()
    return trainer, report, score, Path(run_dir) / "port"


def _preds(run):
    return {p.stem: np.asarray(Image.open(p)) for p in sorted((run / "pred").glob("*.png"))}


def test_inference_matches_jax(data_root, tmp_path, jax_inference):
    jreport, jrun, weights = jax_inference
    _, report, score, run = _port_inference(data_root, tmp_path, weights)
    ours, theirs = _preds(run), _preds(jrun)
    assert ours.keys() == theirs.keys() and len(ours) > 0
    n_pix = sum(p.size for p in ours.values())
    n_diff = sum(int((ours[k] != theirs[k]).sum()) for k in ours)
    assert n_diff <= n_pix * 1e-4, f"{n_diff} of {n_pix} pixels differ"
    assert report.keys() == jreport.keys() == {"loss", "dice", "hd"}
    assert report["hd"].keys() == jreport["hd"].keys()
    if n_diff == 0:
        assert report["hd"] == jreport["hd"]
    for key, value in jreport["hd"].items():
        np.testing.assert_allclose(report["hd"][key], value, atol=1.0, err_msg=key)
    np.testing.assert_allclose(score, jreport["dice"]["DSC_mean"], atol=1e-4)
    np.testing.assert_allclose(report["loss"]["mean"], jreport["loss"]["mean"], rtol=1e-5)
    assert json.loads((run / "inference.json").read_text())["dice"]["DSC_mean"] == score
    for folder in ("img", "gt"):
        for p in sorted((jrun / folder).glob("*.png")):
            np.testing.assert_array_equal(np.asarray(Image.open(run / folder / p.name)),
                                          np.asarray(Image.open(p)), err_msg=str(p))


def test_device_data_inference_realigns_the_store_forward(data_root, tmp_path, jax_inference):
    _, _, weights = jax_inference
    _, host_report, _, host_run = _port_inference(data_root, tmp_path / "host", weights)
    host_preds = _preds(host_run)
    trainer, report, score, run = _port_inference(data_root, tmp_path / "dev", weights,
                                                  device_data=True)
    _, eval_score = trainer._eval_epoch(trainer._test_loader)
    assert abs(eval_score - score) <= 1e-6
    assert report["hd"].keys() == host_report["hd"].keys()
    preds = _preds(run)
    assert preds.keys() == host_preds.keys()
    n_test = len(trainer._test_loader.dataset)
    for folder in ("img", "gt", "pred"):
        assert len(list((run / folder).glob("*.png"))) == n_test, folder
    for key, pred in preds.items():
        np.testing.assert_array_equal(pred, host_preds[key], err_msg=key)
