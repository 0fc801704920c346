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
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

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


def _trainer(tmp_path, backend="pallas_fused", crop=CROP, **iic):
    cfg = _config("udaiic")
    cfg["Kernel"] = {"backend": backend}
    cfg["IICRegParameters"].update(iic)
    return trainer_zoos["udaiic"](labeled_loader=None, unlabeled_loader=None, val_loader=None,
                                  test_loader=None, configuration=cfg, device="cpu",
                                  crop_size=crop, run_dir=str(tmp_path))


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
    linear = [("linear", False), ("linear", False)]
    assert trainer_mod.fused_path_unmet(cuda, 1024, 224, linear) is None
    assert trainer_mod.fused_path_unmet(cuda, [1024, 224], 224, linear) is None
    assert "cuda" in trainer_mod.fused_path_unmet(cpu, 1024, 224, linear)
    assert "patch_sizes" in trainer_mod.fused_path_unmet(cuda, [1024, 64], 224, linear)
    for heads in ([("mlp", False), ("linear", False)], [("linear", True), ("linear", False)]):
        assert "linear and unnormalized" in trainer_mod.fused_path_unmet(cuda, 1024, 224, heads)


@pytest.mark.parametrize("lanes", [128, 256, mi_fused.MAX_LANES, mi_fused.MAX_LANES + 128])
def test_fused_gate_width_condition(lanes):
    """A head's lanes up to ``MAX_LANES`` (1024) take the fused path; 1152
    is an unmet condition named by its width, not an error in the kernel
    wrapper."""
    heads = [("linear", False, 128), ("linear", False, lanes)]
    unmet = trainer_mod.fused_path_unmet(torch.device("cuda"), 1024, 224, heads)
    if lanes <= mi_fused.MAX_LANES:
        assert unmet is None
    else:
        assert f"{lanes} lanes" in unmet and str(mi_fused.MAX_LANES) in unmet


@pytest.mark.parametrize("subheads,clusters,lanes", [(5, 204, 1024), (5, 210, 1152)])
def test_fused_gate_takes_the_heads_lanes(tmp_path, monkeypatch, subheads, clusters, lanes):
    """The trainer hands the gate each decoder head's lanes, S*K rounded up
    to 128: 5 x 204 (1020 live lanes in 1024) passes it on cuda, 5 x 210 (1050
    in 1152) does not (the gate's inputs recorded from a CPU trainer, which
    trains unfused either way)."""
    seen = []
    real = trainer_mod.fused_path_unmet
    monkeypatch.setattr(trainer_mod, "fused_path_unmet",
                        lambda *args: seen.append(args) or real(*args))
    trainer = _trainer(tmp_path, DecoderParams={"num_clusters": clusters,
                                                "num_subheads": subheads})
    trainer.init()
    assert trainer._projector.local_emit_logits is False  # the CPU: unfused either way
    (device, *rest), = seen
    assert device.type == "cpu" and {head[2] for head in rest[2]} == {lanes}
    unmet = real(torch.device("cuda"), *rest)
    assert unmet is None if lanes <= mi_fused.MAX_LANES else f"{lanes} lanes" in unmet


def test_fused_gate_names_a_head_wider_than_one_tile(tmp_path, capsys, monkeypatch):
    """The gate has no lane-width condition: the fused kernels take logits of
    any multiple of 128 lanes, as the JAX kernel does. A 5 x 30 trainer
    (150 live lanes in 256) passes the gate on cuda (the gate's inputs
    recorded from the trainer), and on the CPU its warning names cuda, not
    the width."""
    seen = []
    real = trainer_mod.fused_path_unmet
    monkeypatch.setattr(trainer_mod, "fused_path_unmet",
                        lambda *args: seen.append(args) or real(*args))
    trainer = _trainer(tmp_path, DecoderParams={"num_clusters": 30, "num_subheads": 5})
    trainer.init()
    out = capsys.readouterr().out
    assert "[trainer] WARNING: Kernel.backend=pallas_fused: the fused kernels run on cuda" in out
    assert "S*K" not in out and "lane" not in out
    (device, *rest), = seen
    assert device.type == "cpu"
    assert real(torch.device("cuda"), *rest) is None


def _cpu_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"labeled_image": torch.tensor(rng.random((2, CROP, CROP, 1), dtype=np.float32)),
            "labeled_target": torch.tensor(rng.integers(0, 4, (2, CROP, CROP)),
                                           dtype=torch.int32),
            "unlabeled_image": torch.tensor(rng.random((3, CROP, CROP, 1), dtype=np.float32))}


def test_wide_head_with_pallas_fused_warns_and_trains_unfused(tmp_path, monkeypatch):
    """DecoderParams.num_clusters=30 (5 x 30 = 150 live lanes in 256) with
    Kernel.backend=pallas_fused and the gate passed (mocked: this host has no
    card): the decoder heads emit 256-lane logits, and a step at crop 16 goes
    through the fused joint (its plain version, on CPU tensors) at both
    decoder taps. Each tap's MI equals the JAX package's fused-logits loss on
    the same logits (its Pallas kernel in interpret mode) within rtol 1e-5
    plus 1e-6 nats: at random init the MI sits near 0 (8e-4 nats), where its
    terms cancel and a relative bound alone means little (measured 2.7e-8
    and 1.2e-8 nats). ``mi`` is their importance-weighted sum with the
    Conv5 term."""
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
        iid_segmentation_loss_fused_logits as jax_loss_fused_logits,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import steps

    monkeypatch.setattr(trainer_mod, "fused_path_unmet", lambda *args: None)
    taps = []
    real = steps.iid_segmentation_loss_fused_logits

    def spy(l1, l2, S, K, padding, **kwargs):
        taps.append((l1.detach().numpy(), l2.detach().numpy(), S, K, padding))
        return real(l1, l2, S, K, padding=padding, **kwargs)

    monkeypatch.setattr(steps, "iid_segmentation_loss_fused_logits", spy)
    crop = 16
    trainer = _trainer(tmp_path, crop=crop, DecoderParams={"num_clusters": 30, "num_subheads": 5})
    trainer.init()
    proj = trainer._projector
    assert proj.local_emit_logits
    assert proj.heads["Up_conv2"](torch.zeros(1, 4, 4, 16)).shape[-1] == 256
    rng = np.random.default_rng(0)
    batch = {"labeled_image": torch.tensor(rng.random((2, crop, crop, 1), dtype=np.float32)),
             "labeled_target": torch.tensor(rng.integers(0, 4, (2, crop, crop)),
                                            dtype=torch.int32),
             "unlabeled_image": torch.tensor(rng.random((3, crop, crop, 1), dtype=np.float32))}
    metrics = trainer._train_step(batch)
    assert [(t[0].shape, t[2:]) for t in taps] == [((3, 10, 10, 256), (5, 30, 1)),
                                                   ((3, 22, 22, 256), (5, 30, 3))]
    for name, (l1, l2, S, K, padding) in zip(("Up_conv3", "Up_conv2"), taps):
        want = -float(jax_loss_fused_logits(jnp.asarray(l1), jnp.asarray(l2), S, K, padding))
        np.testing.assert_allclose(float(metrics[f"individual_mis/{name}"]), want, rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    mis = [float(metrics[f"individual_mis/{n}"]) for n in ("Conv5", "Up_conv3", "Up_conv2")]
    np.testing.assert_allclose(float(metrics["mi"]), (mis[0] + 0.5 * mis[1] + 0.5 * mis[2]) / 2,
                               rtol=1e-6)


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


def test_wide_head_on_auto_hands_the_joint_its_live_lanes(tmp_path, monkeypatch):
    """DecoderParams.num_clusters=30 (5 x 30 = 150 live lanes in the heads'
    256) on Kernel.backend=auto: a step at crop 16 hands the flat loss front
    door the S*K = 150 live lanes alone at both decoder taps (above 128 lanes
    the joint's wide kernels then compute the quarters that hold a live lane:
    9 quarter tiles of J, not 16). Each tap's MI equals the JAX package's
    flat loss on the heads' whole 256-lane maps (the 150 lanes and 106 zero
    ones; its Pallas joint in interpret mode) within rtol 1e-4 plus 1e-6
    nats: the dead lanes add nothing to J, and both sides round the same
    operands to bf16 (the MI sits near 0 at init, where a relative bound
    alone means little; measured 1.4e-7 and 9.1e-8 nats, and the same with
    the dead lanes handed to the joint)."""
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
        iid_segmentation_small_patch_loss_flat as jax_loss_flat,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu_torch.engine import steps

    taps = []
    real = steps.iid_segmentation_small_patch_loss_flat

    def spy(x, x_tf, S, K, **kwargs):
        taps.append((x.detach().numpy(), x_tf.detach().numpy(), S, K, kwargs["padding"],
                     kwargs["patch_size"]))
        return real(x, x_tf, S, K, **kwargs)

    monkeypatch.setattr(steps, "iid_segmentation_small_patch_loss_flat", spy)
    crop = 16
    trainer = _trainer(tmp_path, backend="auto", crop=crop,
                       DecoderParams={"num_clusters": 30, "num_subheads": 5})
    trainer.init()
    assert not trainer._projector.local_emit_logits
    assert trainer._projector.heads["Up_conv2"](torch.zeros(1, 4, 4, 16)).shape[-1] == 256
    rng = np.random.default_rng(0)
    batch = {"labeled_image": torch.tensor(rng.random((2, crop, crop, 1), dtype=np.float32)),
             "labeled_target": torch.tensor(rng.integers(0, 4, (2, crop, crop)),
                                            dtype=torch.int32),
             "unlabeled_image": torch.tensor(rng.random((3, crop, crop, 1), dtype=np.float32))}
    metrics = trainer._train_step(batch)
    assert [(t[0].shape, t[2:5]) for t in taps] == [((3, 10, 10, 150), (5, 30, 1)),
                                                   ((3, 22, 22, 150), (5, 30, 3))]
    dead = ((0, 0), (0, 0), (0, 0), (0, 256 - 150))
    for name, (x, x_tf, S, K, padding, patch) in zip(("Up_conv3", "Up_conv2"), taps):
        want = -float(jax_loss_flat(jnp.asarray(np.pad(x, dead)), jnp.asarray(np.pad(x_tf, dead)),
                                    S, K, padding, patch, backend="auto", pre_padded=True))
        np.testing.assert_allclose(float(metrics[f"individual_mis/{name}"]), want, rtol=1e-4,
                                   atol=1e-6, err_msg=name)
