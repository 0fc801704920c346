"""Import hygiene of the PyTorch port: it imports neither JAX nor the JAX
package, and its entry points refuse to run on a CUDA device that is not
there instead of falling back to the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mi_based_regularized_semi_supervised_segmentation_tpu_torch as port
from mi_based_regularized_semi_supervised_segmentation_tpu_torch import pretrain_main
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer as port_trainer
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_fused, rotate

REPO = Path(port.PROJECT_PATH)
PORT_DIR = Path(port.__file__).resolve().parent
JAX_PACKAGE = "mi_based_regularized_semi_supervised_segmentation_tpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", JAX_PACKAGE)


def _port_modules():
    return sorted(
        ".".join((PORT_DIR.name,) + p.relative_to(PORT_DIR).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in PORT_DIR.rglob("*.py"))


def _imported_roots(path: Path):
    """Top-level names of every absolute import in a source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_every_port_module_imports_without_jax():
    modules = _port_modules()
    for name in ("ops.mi_joint", "ops.mi_fused", "ops.rotate", "ops.augment_device",
                 "ops.affine", "data.device_pipeline", "engine.steps", "engine.pretrain",
                 "engine.optim", "models.zoo", "models.vgg", "utils.general", "weights", "main",
                 "pretrain_main", "parallel.mesh", "parallel.halo", "data.native",
                 "data.pil_augment",
                 "utils.viewer", "utils.cluster"):
        assert f"{PORT_DIR.name}.{name}" in modules, name
    code = ("import importlib, sys\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN[:4]!r}"
            f" or m.split('.')[0] == {JAX_PACKAGE!r})\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("source", ["package", "chip_smoke.py"])
def test_sources_import_no_jax_and_nothing_of_the_jax_package(source):
    files = sorted(PORT_DIR.rglob("*.py")) if source == "package" else [REPO / "chip_smoke.py"]
    assert files
    for path in files:
        for name in _imported_roots(path):
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path.relative_to(REPO)} imports {name}"
        text = path.read_text()
        assert f"{JAX_PACKAGE}." not in text.replace(f"{JAX_PACKAGE}_torch", ""), (
            f"{path.relative_to(REPO)} names a module of the JAX package")


def test_cuda_request_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_trainer.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        port_trainer.SemiTrainer(labeled_loader=None, unlabeled_loader=None, val_loader=None,
                                 test_loader=None, configuration={}, device="cuda",
                                 run_dir=None)
    with pytest.raises(RuntimeError, match="cuda"):
        port_trainer.SemiTrainer(labeled_loader=None, unlabeled_loader=None, val_loader=None,
                                 test_loader=None, device="cuda", run_dir=None,
                                 configuration={"Trainer": {"device_data": True},
                                                "Kernel": {"geometry": "shear"}})
    assert port_trainer.resolve_device("cpu") == torch.device("cpu")


def test_pretrain_main_without_a_card_raises(monkeypatch, tmp_path):
    """``pretrain_main`` asks for cuda by default (``config/pretrain.yaml``)
    and refuses before it makes or reads any data."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="Trainer.device=cpu"):
        pretrain_main.main([f"Trainer.save_dir={tmp_path / 'run'}", "Data.synthetic=false",
                            f"Data.root_dir={tmp_path / 'absent'}"])
    assert not (tmp_path / "run").exists()


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor: what the rotation
    wrapper sees when it is handed a card's tensor."""

    @property
    def is_cuda(self):
        return True


def test_rotation_of_a_cuda_tensor_without_a_card_raises():
    """No fallback: a CUDA tensor goes to the kernel, and without a card (or
    nvcc) that raises instead of rotating with the plain version."""
    images = torch.zeros((2, 16, 16)).as_subclass(_CudaLooking)
    angles = torch.tensor([10.0, -20.0]).as_subclass(_CudaLooking)
    rotate.reset_launch_counts()
    with pytest.raises(RuntimeError):
        rotate.rotate_shear(images, angles)
    with pytest.raises(RuntimeError):
        rotate.lane_roll_rows(images, torch.zeros((2, 16), dtype=torch.int32)
                              .as_subclass(_CudaLooking))
    assert sum(rotate.LAUNCHES.values()) == 0


def test_fused_joint_of_a_cuda_tensor_without_a_card_raises():
    """No fallback: CUDA logits go to the fused kernels, and without a card (or
    nvcc) that raises instead of taking the plain version."""
    logits = torch.zeros((2, 10, 10, 128)).as_subclass(_CudaLooking)
    mi_fused.reset_launch_counts()
    with pytest.raises(RuntimeError):
        mi_fused.displaced_joint_softmax(logits, logits, 1, 5, 20)
    flat = logits.reshape(-1, 128)
    with pytest.raises(RuntimeError):
        mi_fused.mi_fused_bwd(flat, flat, torch.zeros((9, 128, 128)).as_subclass(_CudaLooking),
                              10, 10, 1, 5, 20)
    assert sum(mi_fused.LAUNCHES.values()) == 0
