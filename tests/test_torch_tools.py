"""The port's tools against the JAX package's: the headless viewer
(``utils/viewer.py``: its mosaics decoded pixel for pixel, ``group_slices``,
the zero-transparent colormap) and the cluster helper (``utils/cluster.py``:
the script text, ``JobSubmiter.run`` in local mode); and every public
top-level name of the five JAX modules this slice ports has a counterpart."""

import inspect
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mi_based_regularized_semi_supervised_segmentation_tpu.data import native as jnative
from mi_based_regularized_semi_supervised_segmentation_tpu.data import pil_augment as jpa
from mi_based_regularized_semi_supervised_segmentation_tpu.utils import cluster as jcluster
from mi_based_regularized_semi_supervised_segmentation_tpu.utils import meters as jmeters
from mi_based_regularized_semi_supervised_segmentation_tpu.utils import viewer as jviewer
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import data as pdata
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import utils as putils
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import native as pnative
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.data import pil_augment as ppa
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import cluster as pcluster
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import meters as pmeters
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.utils import viewer as pviewer


def _public(module):
    """Top-level names defined in ``module`` (not imported into it)."""
    return {n for n, v in vars(module).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", module.__name__) == module.__name__
            and n not in ("annotations",)}


@pytest.mark.parametrize("jax_module,port_module", [
    (jpa, ppa), (jnative, pnative), (jviewer, pviewer), (jcluster, pcluster),
    (jmeters, pmeters)], ids=["pil_augment", "native", "viewer", "cluster", "meters"])
def test_every_public_name_has_a_counterpart(jax_module, port_module):
    missing = sorted(n for n in _public(jax_module) if not hasattr(port_module, n))
    assert not missing, missing
    for n in _public(jax_module):
        theirs, ours = getattr(jax_module, n), getattr(port_module, n)
        if inspect.isfunction(theirs):
            assert inspect.signature(ours) == inspect.signature(theirs), n


def test_the_modules_are_exported_as_in_the_jax_package():
    assert pdata.pil_augment is ppa and pdata.native is pnative
    assert putils.viewer is pviewer and putils.cluster is pcluster


@pytest.fixture
def slices(tmp_path):
    """Two patients of three slices each as img/ and gt/ PNGs, and the
    volume and mask they came from."""
    rng = np.random.default_rng(0)
    vol = rng.random((7, 16, 16))
    mask = (vol > 0.7).astype(np.uint8) + (vol > 0.9)
    img_dir, gt_dir = tmp_path / "img", tmp_path / "gt"
    img_dir.mkdir()
    gt_dir.mkdir()
    for pid in (1, 2):
        for s in range(3):
            stem = f"patient{pid:03d}_01_{s:02d}.png"
            Image.fromarray((vol[s] * 255).astype(np.uint8)).save(img_dir / stem)
            Image.fromarray(mask[s]).save(gt_dir / stem)
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(img_dir / "other.png")  # no patient id
    return vol, mask, img_dir, gt_dir


def _pixels(path):
    with Image.open(path) as im:
        return np.asarray(im)


def test_viewer_matches_jax(slices, tmp_path):
    vol, mask, img_dir, gt_dir = slices
    ours, theirs = pviewer.zero_transparent_cmap("magma"), jviewer.zero_transparent_cmap("magma")
    np.testing.assert_array_equal(ours.colors, theirs.colors)
    assert ours(0)[-1] == 0.0

    assert pviewer.group_slices(str(img_dir)) == jviewer.group_slices(str(img_dir))
    assert (pviewer.group_slices(str(img_dir), r"(patient\d+)")
            == jviewer.group_slices(str(img_dir), r"(patient\d+)"))

    for side, module in (("ours", pviewer), ("theirs", jviewer)):
        module.save_volume_mosaic(vol, [mask], out_path=str(tmp_path / side / "m.png"), cols=3,
                                  titles=[f"s{i}" for i in range(7)])
    np.testing.assert_array_equal(_pixels(tmp_path / "ours" / "m.png"),
                                  _pixels(tmp_path / "theirs" / "m.png"))

    outs = {side: module.render_folder(str(img_dir), [str(gt_dir)],
                                       out_dir=str(tmp_path / f"v_{side}"))
            for side, module in (("ours", pviewer), ("theirs", jviewer))}
    assert [Path(p).name for p in outs["ours"]] == [Path(p).name for p in outs["theirs"]]
    assert len(outs["ours"]) == 3  # two patients and the stem without an id
    for a, b in zip(outs["ours"], outs["theirs"]):
        np.testing.assert_array_equal(_pixels(a), _pixels(b))


@pytest.mark.parametrize("kwargs", [
    {}, {"time": 3, "job_name": "j", "nodes": 2, "gres": "gpu:4", "cpus_per_task": 12,
         "mem": 8, "mail_user": "x@y.z"}])
def test_cluster_script_text_matches_jax(kwargs):
    assert (pcluster.sbatch_script_prefix("acct", **kwargs)
            == jcluster.sbatch_script_prefix("acct", **kwargs))
    args = dict(project_path="/work/proj", account="acct",
                prepare_env=["module load python", "source venv/bin/activate"], **kwargs)
    assert (pcluster.JobSubmiter(**args).script_for("python main.py Trainer.name=udaiic")
            == jcluster.JobSubmiter(**args).script_for("python main.py Trainer.name=udaiic"))


def test_job_submiter_runs_locally(tmp_path):
    sub = pcluster.JobSubmiter(project_path=str(tmp_path), on_local=True, account="acct",
                               prepare_env=["export FOO=1"])
    assert sub.run("echo $FOO > ran.txt") == 0
    assert (tmp_path / "ran.txt").read_text().strip() == "1"
    assert sub.run("exit 3") == 3
