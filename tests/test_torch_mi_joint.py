"""The port's displaced-MI joint (plain version of the CUDA kernel) against the
JAX package's Pallas kernel, run in interpret mode on the CPU.

Inputs come from numpy with a fixed seed and go to both sides as the same
arrays. Tolerances: fp32 operands rtol 1e-4 / atol 1e-5 for values and both
gradients (those of tests/test_pallas_mi.py: summation order only); bf16
operands the same, since both sides round the same operands (and the
cotangent) to bf16 and sum exact products in fp32.
"""

import re

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops.iic_local import (
    displaced_joint_xla,
    iid_segmentation_small_patch_loss_flat,
)
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

try:  # the JAX side; a card's machine without JAX runs only the cuda-marked tests
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.iic_local import (
        iid_segmentation_small_patch_loss_flat as jax_loss_flat,
    )
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_joint import (
        displaced_joint_pallas,
    )
    DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
except ImportError:
    jax = jnp = jax_loss_flat = displaced_joint_pallas = None
    DTYPES = {"fp32": (torch.float32, None), "bf16": (torch.bfloat16, None)}


def _maps(rng, shape, live=None, padding=0):
    """Softmax-like maps [B, H, W, C]; lanes from ``live`` on are dead (0);
    with ``padding`` a zero border of that width (a pre-padded canvas)."""
    c = shape[-1]
    live = live or c
    z = rng.normal(size=shape[:-1] + (live,))
    e = np.exp(z - z.max(-1, keepdims=True))
    x = np.zeros(shape, np.float32)
    x[..., :live] = e / e.sum(-1, keepdims=True)
    if padding:
        x[:, :padding] = x[:, -padding:] = 0
        x[:, :, :padding] = x[:, :, -padding:] = 0
    return x


def _jax_joint_and_grads(x, y, g, padding, dot, pre_padded):
    f = lambda a, b: displaced_joint_pallas(a, b, padding, None, dot, pre_padded)
    joint, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(y))
    ga, gb = vjp(jnp.asarray(g))
    return np.asarray(joint), np.asarray(ga), np.asarray(gb)


def _torch_joint_and_grads(x, y, g, padding, dot, pre_padded):
    tx = torch.tensor(x, requires_grad=True)
    ty = torch.tensor(y, requires_grad=True)
    joint = mi_joint.displaced_joint(tx, ty, padding, dot, pre_padded)
    (joint * torch.tensor(g)).sum().backward()
    return joint.detach().numpy(), tx.grad.numpy(), ty.grad.numpy()


# every padding, both canvas forms, both lane layouts and both operand modes,
# each value in at least two cases (interpret-mode Pallas takes seconds a case);
# above 128 lanes (c256: a head of 5 x 30 clusters, 150 live lanes padded to
# 256; c150: the same head at its 150 lanes, as the training path passes it;
# c200: 10 x 20 clusters) the wide kernels' decomposition (their plan's blocks
# evaluated as plain products, ``_wide_by_plan``) is held to JAX too
@pytest.mark.parametrize("padding,pre_padded,lanes,mode", [
    (1, False, "c6", "fp32"),
    (2, True, "c128_dead", "fp32"),
    (3, False, "c128_dead", "bf16"),
    (1, True, "c6", "bf16"),
    (3, True, "c6", "fp32"),
    (2, False, "c6", "bf16"),
    (1, True, "c256", "bf16"),
    (1, True, "c150", "bf16"),
    (3, False, "c150", "fp32"),
    (1, False, "c200", "fp32"),
    (3, True, "c200", "bf16"),
])
def test_joint_matches_pallas_values_and_grads(rng, padding, pre_padded, lanes, mode):
    c, live = {"c6": (6, 6), "c128_dead": (128, 20), "c256": (256, 150), "c150": (150, 150),
               "c200": (200, 200)}[lanes]
    edge = 2 * padding if pre_padded else 0
    shape = (2, 9 + edge, 8 + edge, c)
    x = _maps(rng, shape, live, padding if pre_padded else 0)
    y = _maps(rng, shape, live, padding if pre_padded else 0)
    t = 2 * padding + 1
    g = rng.normal(size=(t, t, c, c)).astype(np.float32)
    tdot, jdot = DTYPES[mode]
    want = _jax_joint_and_grads(x, y, g, padding, jdot, pre_padded)
    got = _torch_joint_and_grads(x, y, g, padding, tdot, pre_padded)
    for name, w, v in zip(("joint", "dx", "dx_tf"), want, got):
        assert v.shape == w.shape, name
        np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-5, err_msg=name)
    if c > 128:
        wp = shape[2] + (0 if pre_padded else 2 * padding)
        if not pre_padded:
            x, y = (np.pad(u, ((0, 0), (padding,) * 2, (padding,) * 2, (0, 0))) for u in (x, y))
        a, b = torch.tensor(x.reshape(-1, c)), torch.tensor(y.reshape(-1, c))
        plan = mi_joint.wide_plan(a.shape[0], c, padding, wp, 132)
        by_plan = _wide_by_plan(a, b, torch.tensor(g.reshape(t * t, c, c)), plan, tdot)
        for name, w, v in zip(("joint", "dx", "dx_tf"), want, by_plan):
            if name != "joint" and not pre_padded:  # the interior of the padded canvas
                v = v.reshape(x.shape)[:, padding:-padding, padding:-padding]
            np.testing.assert_allclose(v.float().numpy().reshape(w.shape), w, rtol=1e-4,
                                       atol=1e-5, err_msg=f"wide plan {name}")


@pytest.mark.parametrize("padding", [1, 3])
def test_plain_per_displacement_matches_flat_form(rng, padding):
    """displaced_joint_xla (sliced, fp32) == the flat-offset form."""
    x = _maps(rng, (2, 11, 10, 5))
    y = _maps(rng, (2, 11, 10, 5))
    flat = mi_joint.displaced_joint(torch.tensor(x), torch.tensor(y), padding, torch.float32)
    sliced = displaced_joint_xla(torch.tensor(x), torch.tensor(y), padding)
    np.testing.assert_allclose(sliced.numpy(), flat.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ours,theirs,rtol", [
    ("plain", "xla", 1e-4),     # fp32 both sides
    ("auto", "pallas", 1e-4),   # bf16 operands both sides
    ("auto", "xla", 5e-3),      # bf16 against fp32 (tests/test_pallas_mi.py:105-107)
])
def test_flat_loss_matches_jax(rng, ours, theirs, rtol):
    """The pre-padded flat front door of the training path: S=3 subheads of
    K=4 clusters in 128 lanes, padding 2, one full-map tile."""
    S, K, p = 3, 4, 2
    x = _maps(rng, (2, 10 + 2 * p, 9 + 2 * p, 128), S * K, p)
    y = _maps(rng, (2, 10 + 2 * p, 9 + 2 * p, 128), S * K, p)
    want = float(jax_loss_flat(jnp.asarray(x), jnp.asarray(y), S, K, p, 1024,
                               backend=theirs, pre_padded=True))
    got = float(iid_segmentation_small_patch_loss_flat(
        torch.tensor(x), torch.tensor(y), S, K, p, 1024, backend=ours, pre_padded=True))
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_flat_loss_unported_paths_raise(rng):
    """Multi-tile (patch 8 on a 12 x 12 interior: 4 tiles, each its own
    joint on 20 live lanes) against the JAX package, bf16 products at the
    joint tolerance above; pallas_fused is no backend of the joint."""
    x_np = _maps(rng, (1, 14, 14, 128), 20, 1)
    y_np = _maps(rng, (1, 14, 14, 128), 20, 1)
    want = float(jax_loss_flat(jnp.asarray(x_np), jnp.asarray(y_np), 2, 10, 1, 8,
                               backend="pallas", pre_padded=True))
    got = float(iid_segmentation_small_patch_loss_flat(
        torch.tensor(x_np), torch.tensor(y_np), 2, 10, 1, 8, backend="pallas", pre_padded=True))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    x = torch.tensor(x_np)
    with pytest.raises(ValueError, match="unknown backend 'pallas_fused'"):
        iid_segmentation_small_patch_loss_flat(x, x, 2, 10, 1, 1024, backend="pallas_fused",
                                               pre_padded=True)


def test_kernel_wrappers_refuse_cpu_and_bad_operands():
    """The launch wrappers take only contiguous fp32 CUDA tensors; they check
    before touching the library, so this runs without a card."""
    a = torch.zeros((64, 8))
    with pytest.raises(ValueError, match="CUDA"):
        mi_joint.mi_joint_fwd(a, a, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        mi_joint.mi_joint_bwd(a, torch.zeros((9, 8, 8)), 8, 1, transpose_g=True)
    with pytest.raises(ValueError, match="dot_dtype"):
        mi_joint.displaced_joint_flat(a, a, 8, 1, torch.float16)


@pytest.mark.parametrize("n,padding", [(529_000, 3), (129_960, 1), (300, 1)])
def test_forward_chunking_covers_rows(n, padding):
    rows, chunks = mi_joint.fwd_chunking(n, 128, padding, sm_count=132)
    assert rows % 32 == 0
    assert (chunks - 1) * rows < n <= chunks * rows


# launch-plan shapes (n, padding, wp): both decoder taps of the headline config
# and ragged ones (n no multiple of the 256-row tile or the 64-row stage, wp no
# multiple of 8, a batch of 1, one partial tile, padding 0 and 2)
PLAN_SHAPES = [(529_000, 3, 230), (129_960, 1, 114), (1 * 37 * 43, 3, 43),
               (3 * 29 * 21, 1, 21), (2 * 101 * 67, 3, 67), (13 * 11, 1, 11),
               (2 * 12 * 10, 2, 10), (9 * 8, 0, 8)]


def _plan(n, padding, wp):
    return mi_joint.launch_plan(n, 128, padding, wp, sm_count=132)


@pytest.mark.parametrize("n,padding,wp", PLAN_SHAPES)
def test_plan_bwd_covers_each_output_row_once(n, padding, wp):
    plan = _plan(n, padding, wp)
    assert plan.bwd_grid == (plan.bwd_blocks,)
    seen = np.zeros(n, np.int64)
    for block in range(plan.bwd_blocks):
        lo, hi = plan.bwd_out_rows(block)
        assert lo < hi
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n,padding,wp", PLAN_SHAPES)
def test_plan_staged_windows_stay_in_bounds(n, padding, wp):
    """Every staged row window lies in [-(p*wp + p), n + p*wp + p) and fits
    its shared-memory buffer."""
    plan = _plan(n, padding, wp)
    p, t = padding, plan.taps
    low, high = -(p * wp + p), n + p * wp + p
    for block in range(plan.bwd_blocks):
        for dy in range(t):
            lo, hi = plan.bwd_slab_window(block, dy)
            assert low <= lo < hi <= high
            assert hi - lo <= plan.bwd_slab_rows
    for chunk in range(plan.fwd_chunks):
        for dy in range(t):
            for group in range(plan.fwd_groups):
                lo, hi = plan.fwd_a_window(chunk, dy, group)
                assert low <= lo < hi <= high
    assert plan.fwd_groups * plan.fwd_dx_group == t


@pytest.mark.parametrize("n,padding,wp", PLAN_SHAPES)
def test_plan_shared_memory_fits(n, padding, wp):
    plan = _plan(n, padding, wp)
    assert 0 < plan.bwd_smem <= 232_448
    assert 0 < plan.fwd_smem <= 232_448
    assert plan.bwd_slab_rows == mi_joint.BWD_TILE + 2 * padding
    # a slab buffer is refilled only after the last step of its dy read it
    assert 2 * plan.taps >= plan.bwd_stages - 2


@pytest.mark.parametrize("n,padding,wp", PLAN_SHAPES)
def test_plan_fwd_chunks_cover_rows(n, padding, wp):
    plan = _plan(n, padding, wp)
    assert plan.fwd_rows_per_chunk % mi_joint.FWD_STAGE_ROWS == 0
    assert plan.fwd_grid == (4 * plan.fwd_groups * plan.taps, plan.fwd_chunks)
    end = 0
    for chunk in range(plan.fwd_chunks):
        lo, hi = plan.fwd_chunk_rows(chunk)
        assert lo == end and hi > lo  # contiguous, none empty
        end = hi
    assert end == n


def test_plan_whole_waves_at_the_taps():
    """At both decoder taps the forward's blocks fill whole waves of 132 SMs."""
    for n, padding, wp in PLAN_SHAPES[:2]:
        grid = _plan(n, padding, wp).fwd_grid
        assert grid[0] * grid[1] % 132 == 0


def test_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="lanes"):
        mi_joint.launch_plan(1000, 129, 1, 20, 132)
    with pytest.raises(ValueError, match="shared memory"):
        mi_joint.launch_plan(100_000, 128, 40, 100, 132)
    with pytest.raises(ValueError, match="rows"):
        mi_joint.launch_plan(0, 128, 1, 20, 132)
    with pytest.raises(ValueError, match="padding"):
        mi_joint.launch_plan(1000, 128, 5, 10, 132)


def test_plan_constants_match_kernel_source():
    """The plan's geometry is the kernel's: the constants of csrc/mi_joint.cu
    and the headers it includes (the wgmma core, joint_core.cuh)."""
    src = "".join(path.read_text() for path in mi_joint.build.sources_of("mi_joint"))
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["LANES"]) == mi_joint.LANES
    assert int(consts["BW_TILE"]) == mi_joint.BWD_TILE
    assert int(consts["BW_KC"]) == mi_joint.BWD_STAGE_LANES
    assert int(consts["FW_KT"]) == mi_joint.FWD_STAGE_ROWS
    assert int(consts["FW_HALF"]) == mi_joint.FWD_HALF
    assert int(consts["FW_STAGES"]) == mi_joint.FWD_STAGES
    assert int(consts["WIDE_Q"]) == mi_joint.WIDE_QUARTER


def _wide_by_plan(a, b, g, plan, dot, round_each=False):
    """The wide kernels' decomposition evaluated on the CPU: every block of
    ``plan``'s forward and backward grids as the plain product its kernel
    computes (its quarter tile or output block, its chunk or row tile, its
    displacements and K quarters, rows outside [0, N) zero), on operands and
    g rounded to ``dot``, each block's sum in fp32. J is the chunk sum in
    chunk order (each entry of a chunk's partial written by exactly one
    block); a backward output is each block's accumulator, cast to the
    operand's dtype once (``round_each``: each K quarter's partial rounded to
    bf16 first, the order the kernels avoid). Returns (J, dx, dx_tf)."""
    n, c = a.shape
    w, q, p, wp, t = plan.lanes, plan.quarters, plan.padding, plan.wp, plan.taps
    shift = p * wp + p
    rnd = lambda x: x.float().to(dot).float()
    a_w, b_w = (torch.nn.functional.pad(rnd(x), (0, w - c)) for x in (a, b))
    a_pad = torch.nn.functional.pad(a_w, (0, 0, shift, shift))
    quarter = lambda i: slice(64 * i, 64 * i + 64)
    partial = torch.zeros((plan.fwd_chunks, t * t, w, w))
    written = torch.zeros((plan.fwd_chunks, t * t, w, w), dtype=torch.int64)
    for chunk in range(plan.fwd_chunks):
        lo, hi = plan.fwd_chunk_rows(chunk)
        for bx in range(plan.fwd_grid[0]):
            i, j, dy, dx0 = plan.fwd_block(bx)
            for dx in range(dx0, dx0 + plan.fwd_dx_group):
                off = dy * wp + dx  # a_pad[n + off] = A[n + o_d]
                d = dy * t + dx
                partial[chunk, d, quarter(i), quarter(j)] = (
                    a_pad[lo + off:hi + off, quarter(i)].T @ b_w[lo:hi, quarter(j)])
                written[chunk, d, quarter(i), quarter(j)] += 1
    assert bool((written == 1).all())
    joint = partial[0]
    for chunk in range(1, plan.fwd_chunks):
        joint = joint + partial[chunk]
    gr = rnd(g)

    def backward(src, transpose_g):
        # H[ob, d, j, k] as the conversion pass writes it, zeros past C
        h = torch.zeros((plan.bwd_out_blocks, t * t, 128, w))
        for ob in range(plan.bwd_out_blocks):
            j0, j1 = plan.bwd_out_lanes(ob)
            for d in range(t * t):
                h[ob, d, :j1 - j0, :c] = (gr[t * t - 1 - d, j0:j1, :] if transpose_g
                                          else gr[d, :, j0:j1].T)
        s_pad = torch.nn.functional.pad(torch.nn.functional.pad(rnd(src), (0, w - c)),
                                        (0, 0, shift, shift))
        out = torch.zeros((n, 128 * plan.bwd_out_blocks))
        for ob in range(plan.bwd_out_blocks):
            nj = plan.bwd_block_lanes(ob)
            for bx in range(plan.bwd_grid[0]):
                lo, hi = plan.bwd_out_rows(bx)
                parts = [torch.zeros((hi - lo, nj)) for _ in range(q)]
                for dy, kc, dx in plan.bwd_steps():
                    off = dy * wp + dx
                    parts[kc] += s_pad[lo + off:hi + off, quarter(kc)] @ h[ob, dy * t + dx,
                                                                           :nj, quarter(kc)].T
                if round_each:
                    parts = [x.to(torch.bfloat16).float() for x in parts]
                acc = parts[0]
                for x in parts[1:]:
                    acc = acc + x
                out[lo:hi, 128 * ob:128 * ob + nj] = acc
        return out[:, :c].to(src.dtype)

    # dx = sum_d B[m - o_d] @ g[d]^T: the backward on B with g[D-1-d]^T
    return joint[:, :c, :c], backward(b, True), backward(a, False)


# the wide plan at the taps of the headline config (Up_conv2, Up_conv3) and
# the pretrain decoder's map at p = 0: (n, padding, wp)
WIDE_SHAPES = [(529_000, 3, 230), (129_960, 1, 114), (150_528, 0, 112)]


@pytest.mark.parametrize("c,quarters,out_blocks", [
    (100, 2, 1), (128, 2, 1), (150, 3, 2), (200, 4, 2), (256, 4, 2), (1024, 16, 8)])
def test_wide_plan_layout(c, quarters, out_blocks):
    """Rows of W = 64 q lanes, q = ceil(C / 64) but at least 2 (4 quarter
    tiles of J at C <= 128, the 128-lane kernels' 4 quarters): the forward's
    grid is q^2 quarter tiles x displacement groups x taps by chunks, the
    backward's row tiles by 128-lane output blocks with q K stages a
    displacement; shared memory within the card's, the slab ring deep
    enough; each shape's counts at the three maps."""
    for n, padding, wp in WIDE_SHAPES:
        plan = mi_joint.wide_plan(n, c, padding, wp, sm_count=132)
        t = 2 * padding + 1
        assert plan.lanes == 64 * quarters == mi_joint.wide_lanes(c) >= c
        assert plan.quarters == quarters and plan.bwd_out_blocks == out_blocks
        assert plan.fwd_grid == (quarters ** 2 * plan.fwd_groups * t, plan.fwd_chunks)
        assert plan.fwd_groups * plan.fwd_dx_group == t
        assert plan.bwd_grid == (-(-n // 256), out_blocks)
        assert len(plan.bwd_steps()) == t * quarters * t
        assert plan.fwd_smem == mi_joint.launch_plan(n, 128, padding, wp, 132).fwd_smem
        assert plan.bwd_smem == (plan.bwd_stages * 128 * 64 * 2
                                 + plan.bwd_slabs * (256 + 2 * padding) * 128)
        assert plan.bwd_smem <= mi_joint.SMEM_LIMIT
        # a slab buffer is refilled only after the last step of its last slab
        assert t * (plan.bwd_slabs - 1) >= plan.bwd_stages - 2
        # about 4 blocks an SM (a chunk may go to rounding the rows up to
        # whole stages), at least 4 stages a chunk
        least = min(-(-4 * 132 // plan.fwd_grid[0]), -(-n // 256))
        assert plan.fwd_grid[1] >= least - 1
        assert plan.fwd_rows_per_chunk % 64 == 0 and plan.fwd_rows_per_chunk >= 256
    if c == 150:  # a 5 x 30 head at Up_conv2: 9 quarter tiles (16 tiled), 3 K stages (4),
        # output blocks of 128 and 64 lanes
        plan = mi_joint.wide_plan(529_000, 150, 3, 230, 132)
        assert (plan.quarters ** 2, plan.quarters) == (9, 3)
        assert [plan.bwd_block_lanes(ob) for ob in range(2)] == [128, 64]
        assert (plan.bwd_stages, plan.bwd_slabs, plan.bwd_smem) == (6, 2, 165_376)
        assert mi_joint.wide_plan(129_960, 150, 1, 114, 132).bwd_slabs == 3


@pytest.mark.parametrize("n,padding,wp,c", [(1 * 37 * 43, 3, 43, 150), (3 * 29 * 21, 1, 21, 200),
                                            (2 * 12 * 10, 2, 10, 300), (9 * 8, 0, 8, 384)])
def test_wide_plan_covers_rows_and_windows(n, padding, wp, c):
    """The forward's chunks tile [0, N) in order, none empty; each backward
    row tile's output rows once; every staged slab window lies within the
    shifted operand's zero-extended rows and fits its buffer."""
    plan = mi_joint.wide_plan(n, c, padding, wp, sm_count=132)
    end = 0
    for chunk in range(plan.fwd_chunks):
        lo, hi = plan.fwd_chunk_rows(chunk)
        assert lo == end and hi > lo
        end = hi
    assert end == n
    seen = np.zeros(n, np.int64)
    low, high = -(padding * wp + padding), n + padding * wp + padding
    for block in range(plan.bwd_grid[0]):
        lo, hi = plan.bwd_out_rows(block)
        seen[lo:hi] += 1
        for dy in range(plan.taps):
            s_lo, s_hi = plan.bwd_slab_window(block, dy)
            assert low <= s_lo < s_hi <= high and s_hi - s_lo <= plan.bwd_slab_rows
    assert (seen == 1).all()
    lanes = [plan.bwd_out_lanes(ob) for ob in range(plan.bwd_out_blocks)]
    assert lanes[0][0] == 0 and lanes[-1][1] == c
    assert all(a[1] == b[0] for a, b in zip(lanes, lanes[1:]))
    # each block computes the lanes it writes, in whole quarters
    computed = [plan.bwd_block_lanes(ob) for ob in range(plan.bwd_out_blocks)]
    assert all(hi - lo <= nj for (lo, hi), nj in zip(lanes, computed))
    assert sum(computed) == plan.lanes


def test_wide_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="lanes"):
        mi_joint.wide_plan(1000, 0, 1, 20, 132)
    with pytest.raises(ValueError, match="rows"):
        mi_joint.wide_plan(0, 150, 1, 20, 132)
    with pytest.raises(ValueError, match="padding"):
        mi_joint.wide_plan(1000, 150, 5, 10, 132)
    with pytest.raises(ValueError, match="shared memory"):
        mi_joint.wide_plan(100_000, 150, 300, 1000, 132)


def test_wide_rows_are_read_in_place_only_at_their_width():
    """bf16 operands skip the conversion pass only as rows of exactly the
    lanes the kernels read: 128, or W = C where C is a multiple of 64 above
    128; fp32 operands always convert."""
    bf = lambda c: torch.zeros((4, c), dtype=torch.bfloat16)
    assert [mi_joint.row_lanes(c) for c in (100, 128, 150, 192, 256)] == [128, 128, 192, 192, 256]
    assert not mi_joint.converts_rows(bf(128), bf(128))
    assert not mi_joint.converts_rows(bf(192)) and not mi_joint.converts_rows(bf(256))
    assert mi_joint.converts_rows(bf(100)) and mi_joint.converts_rows(bf(150))
    assert mi_joint.converts_rows(torch.zeros((4, 256)))


@pytest.mark.parametrize("padding,c", [(1, 150), (3, 150), (0, 300), (2, 200), (1, 256)])
@pytest.mark.parametrize("mode", ["bf16", "fp32"])
def test_wide_plan_decomposition_matches_plain_joint(rng, padding, c, mode):
    """The wide kernels' decomposition (``_wide_by_plan``: their plan's
    forward quarter tiles and chunks, backward output blocks, row tiles, K
    quarters and displacements as plain products) against the plain joint
    and its autograd at C lanes: J and both gradients within 1e-5 of the
    largest entry (summation order only). In bf16 mode both round the same
    operands and g."""
    tdot = DTYPES[mode][0]
    shape = (2, 9 + 2 * padding, 8 + 2 * padding, c)
    wp = shape[2]
    a = torch.tensor(_maps(rng, shape, c, padding).reshape(-1, c))
    b = torch.tensor(_maps(rng, shape, c, padding).reshape(-1, c))
    t = 2 * padding + 1
    g = torch.tensor(rng.normal(size=(t * t, c, c)).astype(np.float32))
    ap, bp = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
    ref = mi_joint.displaced_joint_plain_flat(ap, bp, wp, padding, tdot)
    ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), g)
    plan = mi_joint.wide_plan(a.shape[0], c, padding, wp, sm_count=4)
    got = _wide_by_plan(a, b, g, plan, tdot)
    for name, x, want in zip(("joint", "dx", "dx_tf"), got, (ref, ref_da, ref_db)):
        assert x.shape == want.shape, name
        want = want.detach().numpy()
        np.testing.assert_allclose(x.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("n,padding,wp", PLAN_SHAPES[:2])
def test_bf16_scratch_is_bf16_rows_and_no_fp32_rows(n, padding, wp):
    """A bf16 call's scratch at the taps: the operands' bf16 copies ([N, 128]
    each: two in the forward, one in the backward), g as H, the forward's
    chunk partials; no [N, ...] fp32 buffer."""
    plan = _plan(n, padding, wp)
    d = plan.taps ** 2
    fwd = mi_joint.bf16_scratch(plan, backward=False)
    bwd = mi_joint.bf16_scratch(plan, backward=True)
    assert fwd == {"a16": ((n, 128), torch.bfloat16), "b16": ((n, 128), torch.bfloat16),
                   "partial": ((plan.fwd_chunks, d, 128, 128), torch.float32)}
    assert bwd == {"s16": ((n, 128), torch.bfloat16), "h16": ((d, 128, 128), torch.bfloat16)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape,padding", [
    ((2, 20, 19, 128), 3),   # small pre-padded canvas
    ((1, 23, 17, 128), 1),   # ragged: n = 391
    ((3, 37, 43, 100), 3),   # ragged n = 4773, C < 128 lanes
    ((2, 13, 12, 256), 1),   # 256 lanes: the wide kernels, 16 quarter tiles
    ((2, 15, 14, 150), 3),   # a 5 x 30 head's 150 lanes: 9 quarter tiles, 2 output blocks
    ((4, 16, 16, 200), 0),   # the pretrain decoder's IIC: 200 lanes at padding 0
    ((2, 9, 8, 300), 0),     # past 256 lanes at padding 0: the wide kernels
])
def test_kernel_matches_plain_on_card(shape, padding):
    """The CUDA kernels against their plain version, on pre-padded canvases:
    fp32 operands in both product modes, rtol 1e-4 of max |ref|; then bf16
    operands (the model's bf16 compute): J the same, the bf16 gradients
    within one bf16 step (rtol 2^-7) beside 1e-4 of max |ref| (both sides
    round an fp32 sum once; the sums differ in order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    rng = np.random.default_rng(0)
    c = shape[-1]
    x = _maps(rng, shape, min(c, 100), padding)
    y = _maps(rng, shape, min(c, 100), padding)
    t = 2 * padding + 1
    g = torch.tensor(rng.normal(size=(t, t, c, c)).astype(np.float32))
    for dtype, dot in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16)):
        outs = []
        for dev in ("cpu", "cuda"):
            tx = torch.tensor(x, device=dev).to(dtype).requires_grad_(True)
            ty = torch.tensor(y, device=dev).to(dtype).requires_grad_(True)
            joint = mi_joint.displaced_joint(tx, ty, padding, dot, pre_padded=True)
            (joint * g.to(dev)).sum().backward()
            assert tx.grad.dtype == ty.grad.dtype == dtype
            outs.append([t.detach().float().cpu().numpy() for t in (joint, tx.grad, ty.grad)])
        for i, (want, got) in enumerate(zip(*outs)):
            rtol = 2 ** -7 if i and dtype == torch.bfloat16 else 0
            np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-4 * np.abs(want).max())
