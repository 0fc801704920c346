"""The port's mlp and normalized cluster heads (``models/heads.py``), their
weight map (``weights.py``) and one udaiic step with such heads on tiled
patches, against the JAX package.

Inputs are numpy arrays from fixed seeds; the weights are the JAX package's,
mapped by ``weights.projector_state_dict`` and loaded strictly. Held:
- fp32 heads, outputs and input gradients: rtol 1e-5, atol 1e-7 (summation
  order only; the gradients' atol 1e-6 of their largest entry);
- bf16 decoder heads: the rules of tests/test_torch_precision.py, within one
  bf16 step of the JAX output: both sides round at the same points (the
  weights cast to bf16, each product's fp32 sum rounded once, the bias add,
  the normalization and the softmax in bf16), but an fp32 sum in another
  order may cross a bf16 rounding boundary now and then;
- the step: losses at rtol 2e-4, the parameters' two-tier bound and the BN
  statistics at rtol 1e-4, as tests/test_torch_step.py holds them.
Two faults of the JAX package's ``normalize`` are pinned here beside the
port's finite values: its flat head is NaN where it has dead lanes (its -inf
lanes times 0), which the JAX trainer's flat heads have whenever S*K is no
multiple of 128, so the port's flat normalized heads are held against the
JAX 5-D head of the same weights, which normalizes the same logits; and its
5-D head's gradient is NaN at a zero logit vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.models.heads import (
    LocalClusterHead as JLocalHead,
    ProjectorWrapper as JProjector,
    group_softmax_flat as j_group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.models import (
    LocalClusterHead,
    ProjectorWrapper,
    group_softmax_flat,
)
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.weights import (
    projector_state_dict,
)

from test_torch_precision import _bf16, _ulps
from test_torch_step import _check_losses, _check_params, _run_both
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

FEATS = ("Conv5", "Up_conv3", "Up_conv2")
S, K = 2, 5
SHAPES = {"Conv5": (2, 2, 2, 256), "Up_conv3": (2, 6, 5, 32), "Up_conv2": (2, 8, 7, 16)}


def _features(rng):
    return {name: rng.normal(size=shape).astype(np.float32) for name, shape in SHAPES.items()}


def _jax_projector(head_types, normalize, flat, feats):
    jproj = JProjector(feature_names=FEATS, num_clusters=K, num_subheads=S,
                       head_types=head_types, normalize=normalize, local_flat=flat)
    params = jproj.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()})
    return jproj, jax.device_get(params["params"])


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "5d"])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("head_types", ["linear", "mlp"])
def test_projector_matches_jax(rng, head_types, normalize, flat):
    """Every position's output and the decoder heads' input gradients; the
    port's flat heads against the JAX flat head where it is finite, and
    against the JAX 5-D head always."""
    feats = _features(rng)
    jproj5, params = _jax_projector(head_types, normalize, False, feats)
    proj = ProjectorWrapper(FEATS, num_clusters=K, num_subheads=S, head_types=head_types,
                            normalize=normalize, local_flat=flat)
    sd = projector_state_dict(params)
    if head_types == "mlp":
        assert {"heads.Conv5.w1", "heads.Up_conv2.b2"} <= set(sd)
        assert tuple(sd["heads.Up_conv3.w1"].shape) == (S, 32, 64)  # interm_dim 64 local,
        assert tuple(sd["heads.Conv5.w2"].shape) == (S, 128, K)     # 128 global
    proj.load_state_dict(sd, strict=True)

    cot = {n: rng.normal(size=SHAPES[n][:3] + (S, K)).astype(np.float32) for n in FEATS[1:]}
    want, vjp = jax.vjp(lambda f: jproj5.apply({"params": params}, f),
                        {k: jnp.asarray(v) for k, v in feats.items()})
    (want_grad,) = vjp({"Conv5": jnp.zeros_like(want["Conv5"]),
                        **{n: jnp.asarray(c) for n, c in cot.items()}})
    tfeats = {k: torch.tensor(v, requires_grad=True) for k, v in feats.items()}
    got = proj(tfeats)
    np.testing.assert_allclose(got["Conv5"].detach().numpy(), np.asarray(want["Conv5"]),
                               rtol=1e-5, atol=1e-7)
    loss = 0
    for name in FEATS[1:]:
        out = got[name]
        if flat:
            assert out.shape == SHAPES[name][:3] + (128,)
            assert torch.all(out[..., S * K:] == 0)
            loss = loss + (out[..., :S * K] * torch.tensor(cot[name].reshape(
                *SHAPES[name][:3], S * K))).sum()
            out = out[..., :S * K].reshape(*SHAPES[name][:3], S, K)
        else:
            loss = loss + (out * torch.tensor(cot[name])).sum()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(want[name]), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    loss.backward()
    for name in FEATS[1:]:
        g, w = tfeats[name].grad.numpy(), np.asarray(want_grad[name])
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6 * np.abs(w).max(), err_msg=name)

    if flat:  # the JAX flat head of the same weights
        jflat, _ = _jax_projector(head_types, normalize, True, feats)
        want_flat = jflat.apply({"params": params}, {k: jnp.asarray(v) for k, v in feats.items()})
        for name in FEATS[1:]:
            w = np.asarray(want_flat[name])
            if normalize:  # the reference's fault: -inf dead lanes times 0
                assert np.isnan(w[..., :S * K]).all() and torch.isfinite(got[name]).all()
            else:
                np.testing.assert_allclose(got[name].detach().numpy(), w, rtol=1e-5, atol=1e-7)


def test_group_softmax_flat_normalize_matches_jax_without_dead_lanes(rng):
    """The flat normalization's own rounding points (squares summed in fp32,
    rsqrt, a product) against JAX where it has no dead lanes; with dead lanes
    the live lanes are unchanged."""
    z = rng.normal(size=(3, 4, S * K)).astype(np.float32) * 2
    want = np.asarray(j_group_softmax_flat(jnp.asarray(z), S, K, 0.7, normalize=True))
    got = group_softmax_flat(torch.tensor(z), S, K, 0.7, normalize=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    padded = np.concatenate([z, np.full((3, 4, 6), np.finfo(np.float32).min, np.float32)], -1)
    wide = group_softmax_flat(torch.tensor(padded), S, K, 0.7, normalize=True)
    assert torch.equal(wide[..., :S * K], got) and torch.all(wide[..., S * K:] == 0)
    zb = jnp.asarray(z, jnp.bfloat16)
    got_b = group_softmax_flat(_bf16(zb), S, K, 0.7, normalize=True)
    assert _ulps(got_b, _bf16(j_group_softmax_flat(zb, S, K, 0.7, normalize=True))) <= 1


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "5d"])
@pytest.mark.parametrize("head_type,normalize", [("mlp", False), ("mlp", True),
                                                 ("linear", True)])
def test_bf16_local_head_matches_jax(rng, head_type, normalize, flat):
    """A decoder head computing in bf16 against the JAX head in bf16. Flat:
    the JAX head with as many lanes as live ones (its normalize is finite
    there); the port's 128-lane head gives the same live lanes."""
    feats = rng.normal(size=(2, 6, 5, 32)).astype(np.float32)
    jhead = JLocalHead(num_clusters=K, num_subheads=S, head_type=head_type, normalize=normalize,
                       dtype=jnp.bfloat16, flat_output=flat, lane_multiple=1)
    params = jax.device_get(jhead.init(jax.random.PRNGKey(1), jnp.asarray(feats))["params"])
    want = _bf16(jhead.apply({"params": params}, jnp.asarray(feats)))
    head = LocalClusterHead(32, K, S, head_type=head_type, normalize=normalize,
                            dtype=torch.bfloat16, flat_output=flat)
    sd = projector_state_dict({"Up_conv3": params})
    head.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = head(torch.tensor(feats))
    assert got.dtype == torch.bfloat16
    if flat:
        assert got.shape == (2, 6, 5, 128) and torch.all(got[..., S * K:] == 0)
        got = got[..., :S * K]
    assert got.shape == want.shape
    assert _ulps(got, want) <= 1
    assert float((got == want).float().mean()) >= 0.95


def test_head_options_checked():
    with pytest.raises(ValueError, match="head_type='conv'"):
        LocalClusterHead(16, K, S, head_type="conv")
    with pytest.raises(ValueError, match="emit_logits"):
        LocalClusterHead(16, K, S, normalize=True, emit_logits=True)
    with pytest.raises(ValueError, match="emit_logits"):
        LocalClusterHead(16, K, S, emit_logits=True, flat_output=False)


def test_normalized_head_gradient_at_a_zero_logit_vector():
    """A pixel of zero features (the zero border the step pads the taps
    with) under zero biases has zero logits, and a zero cotangent (the step's
    border mask). The JAX 5-D head's gradient is NaN there (sqrt'(0) = inf
    times 0); the port's is 0 there and equal elsewhere."""
    feats = np.random.default_rng(2).normal(size=(1, 3, 3, 16)).astype(np.float32)
    feats[0, 0, 0] = 0
    cot = np.random.default_rng(3).normal(size=(1, 3, 3, S, K)).astype(np.float32)
    cot[0, 0, 0] = 0
    jhead = JLocalHead(num_clusters=K, num_subheads=S, normalize=True, flat_output=False)
    params = jax.device_get(jhead.init(jax.random.PRNGKey(0), jnp.asarray(feats))["params"])
    _, vjp = jax.vjp(lambda f: jhead.apply({"params": params}, f), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    head = LocalClusterHead(16, K, S, normalize=True, flat_output=False)
    sd = projector_state_dict({"Up_conv2": params})
    head.load_state_dict({k.split(".", 2)[2]: v for k, v in sd.items()}, strict=True)
    x = torch.tensor(feats, requires_grad=True)
    (head(x) * torch.tensor(cot)).sum().backward()
    assert np.isnan(want[0, 0, 0]).all() and torch.all(x.grad[0, 0, 0] == 0)
    np.testing.assert_allclose(x.grad.numpy()[0, 1:], want[0, 1:], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("port_flat", [True, False], ids=["flat", "5d"])
def test_udaiic_step_mlp_normalized_tiled_matches_jax(port_flat):
    """One udaiic step with mlp, normalized heads and patch 8 on a 16^2 crop:
    Up_conv3 (8^2) one pre-padded tile, Up_conv2 (16^2) 9 tiles of their own
    zero border; fp32 joints (xla) on both sides. The JAX step trains its own
    layout, flat heads; 2 x 64 clusters fill its 128 lanes, the one width at
    which its normalized flat heads are finite (see above)."""
    jmetrics, metrics, before, after_jax, after = _run_both(
        "udaiic", "xla", "xla", heads=dict(head_types="mlp", normalize=True), clusters=64,
        port_flat=port_flat, crop=16, patch_sizes=8)
    assert any(k.endswith(".w1") for k in before)
    _check_losses(jmetrics, metrics)
    _check_params(before, after_jax, after)
