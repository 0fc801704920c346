"""The port's displaced-MI losses (``ops/iic_local.py``) against the JAX
package's: every backend on the [B, H, W, K], [B, H, W, S, K] and flat
[B, H, W, C] front doors; one tile and several (a map the stride does not
divide among them); pre-padded maps and not; a mask on the [B, H, W, K]
ones. Inputs are numpy probability maps from fixed seeds.

Held, the loss and the gradients of both maps (``jax.grad`` against
autograd):
- fp32 backends (xla, xla_banded, xla_scan against the JAX backend of the
  same name; plain against xla): the loss at rel 1e-5, each gradient within
  1e-5 of its largest entry (summation order only);
- auto and pallas (bf16 operands, fp32 sums; on CPU tensors the kernel's
  plain version) against the JAX pallas kernel in interpret mode: rtol 1e-4
  with an atol of 1e-5 of the largest entry, the joint's tolerance in
  tests/test_torch_mi_joint.py (both sides round the same operands).
Interpret-mode Pallas takes seconds a tile, so the kernel backends take the
pre-padded cases (one tile, and 4 tiles) and the JAX results are computed
once per case for auto and pallas.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu.ops import iic_local as jil
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic_local as til
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

S, K, LANES = 2, 3, 128
JAX_BACKEND = {"auto": "pallas", "pallas": "pallas", "xla": "xla", "plain": "xla",
               "xla_banded": "xla_banded", "xla_scan": "xla_scan"}
FP32 = ("xla", "plain", "xla_banded", "xla_scan")
KERNEL = ("auto", "pallas")
# name -> (interior H, W, patch, pre_padded, padding)
CASES = {
    "single": (6, 5, 1024, False, 1),
    "single_prepadded": (6, 5, 1024, True, 2),
    "tiles": (8, 8, 4, False, 1),               # 3 x 3 tiles, stride 2 divides 8 - 4
    "tiles_prepadded_ragged": (6, 5, 4, True, 1),  # 2 x 2 tiles; columns 0 and 1
}
KERNEL_CASES = ("single_prepadded", "tiles_prepadded_ragged")


def _probs(seed, shape, padding=0):
    """Per-subhead softmax maps [B, H, W, S, K] (a zero border of width
    ``padding`` around the interior, the trainer's pre-padded canvas)."""
    z = np.random.default_rng(seed).normal(size=shape) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    x = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if padding:
        x = np.pad(x[:, padding:-padding, padding:-padding],
                   [(0, 0), (padding, padding), (padding, padding)] + [(0, 0)] * (x.ndim - 3))
    return x


def _case_inputs(case, door):
    h, w, _, pre_padded, p = CASES[case]
    edge = 2 * p if pre_padded else 0
    shape = (2, h + edge, w + edge, S, K)
    x, y = (_probs(seed, shape, p if pre_padded else 0) for seed in (1, 2))
    if door == "flat":  # S*K live lanes of 128, the rest dead (0)
        x, y = (np.pad(t.reshape(shape[:3] + (S * K,)), [(0, 0)] * 3 + [(0, LANES - S * K)])
                for t in (x, y))
    return x, y


def _jax_fn(door, case, backend):
    _, _, patch, pre_padded, p = CASES[case]
    if door == "flat":
        return lambda a, b: jil.iid_segmentation_small_patch_loss_flat(
            a, b, S, K, p, patch, backend=backend, pre_padded=pre_padded)
    return lambda a, b: jil.iid_segmentation_small_patch_loss_subheads(
        a, b, p, patch, backend=backend, pre_padded=pre_padded)


def _port_fn(door, case, backend):
    _, _, patch, pre_padded, p = CASES[case]
    if door == "flat":
        return lambda a, b: til.iid_segmentation_small_patch_loss_flat(
            a, b, S, K, p, patch, backend=backend, pre_padded=pre_padded)
    return lambda a, b: til.iid_segmentation_small_patch_loss_subheads(
        a, b, p, patch, backend=backend, pre_padded=pre_padded)


def _jax_value_and_grads(fn, inputs):
    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(x) for x in inputs))
    return float(value), [np.asarray(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _jax_door(door, case, jax_backend):
    return _jax_value_and_grads(_jax_fn(door, case, jax_backend), _case_inputs(case, door))


def _port_value_and_grads(fn, inputs):
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    value = fn(*ts)
    value.backward()
    return float(value.detach()), [t.grad.numpy() for t in ts]


def _check(backend, got, want):
    (v, grads), (wv, wgrads) = got, want
    kernel = backend in KERNEL
    np.testing.assert_allclose(v, wv, rtol=1e-4 if kernel else 1e-5)
    for i, (g, w) in enumerate(zip(grads, wgrads)):
        assert g.shape == w.shape and np.isfinite(g).all()
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=1e-4 if kernel else 0,
                                   atol=1e-5 * scale, err_msg=f"gradient {i}")


def _door_cases():
    for door in ("5d", "flat"):
        for backend in FP32 + KERNEL:
            for case in (KERNEL_CASES if backend in KERNEL else CASES):
                yield door, case, backend


@pytest.mark.parametrize("door,case,backend", list(_door_cases()))
def test_subhead_front_doors_match_jax(door, case, backend):
    want = _jax_door(door, case, JAX_BACKEND[backend])
    got = _port_value_and_grads(_port_fn(door, case, backend), _case_inputs(case, door))
    _check(backend, got, want)


# [B, H, W, K] front doors with a mask: (interior H, W, patch, padding)
MASKED = {"loss": (6, 5, None, 2), "small_patch": (6, 5, 4, 1)}


def _masked_inputs():
    x, y = (_probs(seed, (2, 6, 5, 4)) for seed in (3, 4))
    mask = (np.random.default_rng(5).random((2, 6, 5, 1)) < 0.7).astype(np.float32)
    return x, y, mask


@functools.lru_cache(maxsize=None)
def _jax_masked(door, jax_backend):
    _, _, patch, p = MASKED[door]
    if door == "loss":
        fn = lambda a, b, m: jil.iid_segmentation_loss(a, b, p, mask=m, backend=jax_backend)
    else:
        fn = lambda a, b, m: jil.iid_segmentation_small_patch_loss(a, b, p, patch, mask=m,
                                                                  backend=jax_backend)
    return _jax_value_and_grads(fn, _masked_inputs())


@pytest.mark.parametrize("door", list(MASKED))
@pytest.mark.parametrize("backend", FP32 + KERNEL)
def test_masked_front_doors_match_jax(door, backend):
    """The mask multiplies both maps and takes no gradient (JAX: zero)."""
    _, _, patch, p = MASKED[door]
    if door == "loss":
        fn = lambda a, b, m: til.iid_segmentation_loss(a, b, p, mask=m, backend=backend)
    else:
        fn = lambda a, b, m: til.iid_segmentation_small_patch_loss(a, b, p, patch, mask=m,
                                                                  backend=backend)
    inputs = _masked_inputs()
    ts = [torch.tensor(x, requires_grad=True) for x in inputs]
    value = fn(*ts)
    value.backward()
    value_j, grads_j = _jax_masked(door, JAX_BACKEND[backend])
    assert ts[2].grad is None and not grads_j[2].any()
    _check(backend, (float(value.detach()), [t.grad.numpy() for t in ts[:2]]),
           (value_j, grads_j[:2]))


@pytest.mark.parametrize("size,patch", [(112, 32), (224, 32), (9, 4), (5, 4), (4, 8), (7, 1)])
def test_tile_offsets_match_jax(size, patch):
    step = max(patch // 2, 1)
    assert til._tile_offsets(size, patch, step) == jil._tile_offsets(size, patch, step)


def test_headline_tile_counts():
    """patch 32 at the headline taps: 6 x 6 tiles of Up_conv3's 112^2 map
    and 13 x 13 of Up_conv2's 224^2 one (chip_smoke.py's train_tiled)."""
    assert len(til._tiles(112, 112, 32)) == 36 and len(til._tiles(224, 224, 32)) == 169


@pytest.mark.parametrize("band_rows", [3, 8])
def test_banded_and_subhead_leading_joints_match_jax(band_rows):
    x, y = (_probs(seed, (2, 7, 6, S, K)) for seed in (6, 7))
    flat = lambda t: t.reshape(2, 7, 6, S * K)
    want = jil.displaced_joint_xla_banded(jnp.asarray(flat(x)), jnp.asarray(flat(y)), 2,
                                          band_rows=band_rows)
    got = til.displaced_joint_xla_banded(torch.tensor(flat(x)), torch.tensor(flat(y)), 2,
                                         band_rows=band_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    lead = lambda t: np.ascontiguousarray(np.moveaxis(t, 3, 0))  # [S, B, H, W, K]
    want = jil.displaced_joint_subheads(jnp.asarray(lead(x)), jnp.asarray(lead(y)), 1)
    got = til.displaced_joint_subheads(torch.tensor(lead(x)), torch.tensor(lead(y)), 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_mi_from_joint_is_per_joint_over_a_stack():
    """A stack of joints gives each joint's own loss (its own min)."""
    joints = torch.rand(4, 3, 3, K, K) * torch.tensor([1.0, 10.0, 0.1, 3.0])[:, None, None,
                                                                                 None, None]
    stacked = til.mi_from_joint(joints)
    one_by_one = torch.stack([til.mi_from_joint(j) for j in joints])
    assert stacked.shape == (4,)
    torch.testing.assert_close(stacked, one_by_one, rtol=1e-6, atol=0)


def _saved_bytes(fn, *inputs):
    """Bytes of the distinct storages autograd saves for ``fn``'s backward."""
    storages = {}

    def pack(t):
        storages[t.untyped_storage().data_ptr()] = t.untyped_storage().nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(*inputs)
    return sum(storages.values())


def test_xla_scan_saves_one_padded_copy_where_xla_saves_per_displacement():
    """xla_scan's forward keeps the padded copy and x_tf for the backward
    (checkpointed displacements save nothing else); xla keeps temporaries of
    every displacement. Padding 3: 49 displacements."""
    x, y = (torch.tensor(_probs(seed, (2, 12, 12, S, K)), requires_grad=True) for seed in (8, 9))
    scan = _saved_bytes(til.displaced_joint_xla_subheads_scan, x, y, 3)
    unrolled = _saved_bytes(til.displaced_joint_xla_subheads, x, y, 3)
    padded = 2 * 18 * 18 * S * K * 4
    assert scan <= padded + x.numel() * 4
    assert unrolled > 20 * x.numel() * 4


def test_unknown_backend_refused():
    x = torch.zeros((1, 4, 4, S, K))
    with pytest.raises(ValueError, match="unknown backend 'pallas_fused'"):
        til.iid_segmentation_small_patch_loss_subheads(x, x, 1, 1024, backend="pallas_fused")
    with pytest.raises(ValueError, match="unknown backend 'bogus'"):
        til.displaced_joint(x[..., 0, :], x[..., 0, :], 1, backend="bogus")
