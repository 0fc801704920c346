"""The fused path (``Kernel.backend=pallas_fused``) through a train step and the
trainer's selection rule.

The step: one ``udaiic`` step with the decoder heads emitting logits on both
sides, from the same weights (``weights.py``), batch and flip mask; the JAX
step runs its fused Pallas kernels in interpret mode, the port the plain
version of its fused kernels (bf16 operands on both sides). Losses at rtol
2e-4, post-Adam parameters to the two-tier bound of ``test_torch_step.py``.
"""

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer as trainer_mod
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import trainer_zoos
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import (
    iic_local,
    mi_fused,
    mi_joint,
)
from test_torch_step import _check_losses, _check_params, _run_both
from test_torch_trainer import _config

CROP = 32


def _spy(monkeypatch):
    """Counts the calls of the fused joint made through the loss front door."""
    calls = []
    real = iic_local.displaced_joint_softmax

    def spy(*args, **kwargs):
        calls.append(args[2])  # padding
        return real(*args, **kwargs)

    monkeypatch.setattr(iic_local, "displaced_joint_softmax", spy)
    return calls


def test_udaiic_fused_step_matches_jax(monkeypatch):
    calls = _spy(monkeypatch)
    mi_fused.reset_launch_counts()
    mi_joint.reset_launch_counts()
    jmetrics, metrics, before, after_jax, after = _run_both("udaiic", "auto", "auto", seed=0,
                                                            emit_logits=True)
    assert calls == [1, 1]  # both decoder taps took the fused path
    assert sum(mi_fused.LAUNCHES.values()) == sum(mi_joint.LAUNCHES.values()) == 0
    _check_losses(jmetrics, metrics)
    _check_params(before, after_jax, after)


def _trainer(tmp_path, backend="pallas_fused", **iic):
    cfg = _config("udaiic")
    cfg["Kernel"] = {"backend": backend}
    cfg["IICRegParameters"].update(iic)
    return trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None, val_loader=None,
                                  test_loader=None, configuration=cfg, device="cpu",
                                  crop_size=CROP, run_dir=str(tmp_path))


def test_pallas_fused_on_cpu_trains_unfused_and_warns(tmp_path, capsys):
    """As the JAX trainer does off the TPU, the CPU trains the unfused path;
    unlike it, the port says so."""
    trainer = _trainer(tmp_path)
    trainer.init()
    assert trainer._projector.local_emit_logits is False
    out = capsys.readouterr().out
    assert "[trainer] WARNING: Kernel.backend=pallas_fused: the fused kernels run on cuda" in out
    trainer = _trainer(tmp_path, backend="auto")
    trainer.init()
    assert trainer._projector.local_emit_logits is False
    assert "WARNING" not in capsys.readouterr().out


def test_fused_gate_conditions():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    linear, lanes = [("linear", False), ("linear", False)], [100, 100]
    assert trainer_mod.fused_path_unmet(cuda, 1024, 224, linear, lanes) is None
    assert trainer_mod.fused_path_unmet(cuda, [1024, 224], 224, linear, lanes) is None
    assert "cuda" in trainer_mod.fused_path_unmet(cpu, 1024, 224, linear, lanes)
    assert "patch_sizes" in trainer_mod.fused_path_unmet(cuda, [1024, 64], 224, linear, lanes)
    for heads in ([("mlp", False), ("linear", False)], [("linear", True), ("linear", False)]):
        assert "linear and unnormalized" in trainer_mod.fused_path_unmet(cuda, 1024, 224, heads,
                                                                          lanes)


def test_fused_gate_names_a_head_wider_than_one_tile():
    """The fused kernels take S*K <= 128 live lanes; 5 x 30 clusters (150
    lanes, padded to 256) fail the gate on any device, named by S*K."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    linear = [("linear", False), ("linear", False)]
    for device in (cuda, cpu):
        assert "S*K=150" in trainer_mod.fused_path_unmet(device, 1024, 224, linear, [150, 150])
    assert trainer_mod.fused_path_unmet(cuda, 1024, 224, linear, [100, 128]) is None


def _cpu_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"labeled_image": torch.tensor(rng.random((2, CROP, CROP, 1), dtype=np.float32)),
            "labeled_target": torch.tensor(rng.integers(0, 4, (2, CROP, CROP)),
                                           dtype=torch.int32),
            "unlabeled_image": torch.tensor(rng.random((3, CROP, CROP, 1), dtype=np.float32))}


def test_wide_head_with_pallas_fused_warns_and_trains_unfused(tmp_path, capsys):
    """DecoderParams.num_clusters=30 (5 x 30 = 150 lanes in 256) with
    Kernel.backend=pallas_fused: the trainer names S*K in its warning, the
    decoder heads emit 256-lane probabilities and a step runs the unfused
    path."""
    trainer = _trainer(tmp_path, DecoderParams={"num_clusters": 30, "num_subheads": 5})
    trainer.init()
    out = capsys.readouterr().out
    assert "[trainer] WARNING: Kernel.backend=pallas_fused: decoder heads with S*K=150" in out
    proj = trainer._projector
    assert proj.local_emit_logits is False
    assert proj.heads["Up_conv2"](torch.zeros(1, 4, 4, 16)).shape[-1] == 256
    metrics = trainer._train_step(_cpu_batch())
    assert np.isfinite(float(metrics["total_loss"])) and float(metrics["mi"]) != 0.0


def test_fused_ok_emits_logits_and_the_trainer_step_runs_fused(tmp_path, monkeypatch):
    """With the gate passed (mocked: this host has no card), the projector's
    decoder heads emit logits and the trainer's step goes through the fused
    joint at both decoder taps (the plain version, on CPU tensors)."""
    monkeypatch.setattr(trainer_mod, "fused_path_unmet", lambda *args: None)
    calls = _spy(monkeypatch)
    trainer = _trainer(tmp_path)
    trainer.init()
    proj = trainer._projector
    assert proj.local_emit_logits
    assert all(proj.heads[n].emit_logits for n in ("Up_conv3", "Up_conv2"))
    rng = np.random.default_rng(0)
    batch = {"labeled_image": torch.tensor(rng.random((2, CROP, CROP, 1), dtype=np.float32)),
             "labeled_target": torch.tensor(rng.integers(0, 4, (2, CROP, CROP)), dtype=torch.int32),
             "unlabeled_image": torch.tensor(rng.random((3, CROP, CROP, 1), dtype=np.float32))}
    metrics = trainer._train_step(batch)
    assert calls == [1, 3]  # LossParams.paddings of the two decoder taps
    assert np.isfinite(float(metrics["total_loss"])) and float(metrics["mi"]) != 0.0


def test_emit_logits_head_pads_with_float32_min():
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
        LocalClusterHead,
    )

    head = LocalClusterHead(16, num_clusters=5, num_subheads=2, emit_logits=True)
    x = torch.randn(1, 4, 4, 16)
    out = head(x)
    assert out.shape == (1, 4, 4, 128)
    assert bool((out[..., 10:] == torch.finfo(torch.float32).min).all())
    torch.testing.assert_close(out[..., :10], head.linear(x))
    with pytest.raises(ValueError, match="T = 1"):
        LocalClusterHead(16, T=0.5, emit_logits=True)


def test_fused_step_needs_one_full_map_tile():
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine.steps import (
        iic_regularization,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
        ProjectorWrapper,
    )

    proj = ProjectorWrapper(["Up_conv2"], num_clusters=5, num_subheads=2, local_emit_logits=True)
    feats = {"Up_conv2": torch.randn(5, 8, 8, 16)}
    flips = torch.zeros((2, 2), dtype=torch.bool)
    with pytest.raises(ValueError, match="full-map tile"):
        iic_regularization(proj, feats, flips, 1, 2, ["Up_conv2"], [1], [4], "auto")
    losses = iic_regularization(proj, feats, flips, 1, 2, ["Up_conv2"], [1], [8], "auto")
    assert torch.isfinite(losses["Up_conv2"])
