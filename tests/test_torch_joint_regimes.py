"""The displaced-MI joint's two whole-call regimes (``ops/mi_joint.py``):
p = 0 over all lanes in one product (``gram_plan``, the pretrain decoder's
IIC: [150528, 200] at padding 0), and every tile piece of a tap in one
product (``pieces_plan``, ``displaced_joint_pieces``; the pieces of
``ops/iic_local.py:_piece_plan``).

Held on the CPU: the launch plans (every row covered once, shared memory
within the card's limit, the constants of the kernel source), the piece
table against ``_gather_pieces``' layout, the grouped autograd with the plain
stand-ins in place of the kernels against each tile's own joint, and both
regimes against the JAX package. Tolerances: the plain stand-ins against
the per-tile plain joints sum the same products in other orders, 1e-5 of
the largest entry; against JAX (its Pallas kernel in interpret mode, bf16
operands and fp32 sums on both sides, the same rounding), the tolerances of
tests/test_torch_iic_local.py and tests/test_torch_mi_joint.py: the loss
rtol 1e-4, values and gradients rtol 1e-4 with an atol of 1e-5 of the
largest entry. The cuda-marked tests hold the kernels against their plain
versions on the card.
"""

import functools
import re

import numpy as np
import pytest
import torch

from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import iic_local as til
from mi_based_regularized_semi_supervised_segmentation_tpu_torch.ops import mi_joint
from torch_threads import two_threads  # noqa: F401  (two intra-op threads a test)

try:  # the JAX side; a card's machine without JAX runs only the cuda-marked tests
    import jax
    import jax.numpy as jnp

    from mi_based_regularized_semi_supervised_segmentation_tpu.ops import iic_local as jil
    from mi_based_regularized_semi_supervised_segmentation_tpu.ops.pallas.mi_joint import (
        displaced_joint_pallas,
    )
except ImportError:
    jax = jnp = jil = displaced_joint_pallas = None

SM = 132  # an H100's SMs
LANE_COUNTS = (1, 100, 128, 200, 256)
ROW_COUNTS = (150528, 1, 31, 33, 72, 1000, 4773, 37 * 43 * 3)


def _source_constants():
    src = "".join(path.read_text() for path in mi_joint.build.sources_of("mi_joint"))
    return {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}


# ---------------------------------------------------------------------------
# p = 0: the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", ROW_COUNTS)
@pytest.mark.parametrize("c", LANE_COUNTS)
def test_gram_plan_covers_every_row_once(n, c):
    """The forward's chunks and the backward's tiles (each block's in turn)
    cover [0, N) once; the chunks are whole stages; the lanes computed are
    C rounded up to 128 or 256, a slab block for each 128 of them."""
    plan = mi_joint.gram_plan(n, c, SM)
    assert plan.cp == (128 if c <= 128 else 256) and plan.fwd_slabs == plan.cp // 128
    assert plan.fwd_rows_per_chunk % mi_joint.GRAM_STAGE_ROWS == 0
    rows = [plan.fwd_chunk_rows(k) for k in range(plan.fwd_chunks)]
    assert rows[0][0] == 0 and rows[-1][1] == n
    assert all(lo < hi and hi == nxt for (lo, hi), (nxt, _) in zip(rows, rows[1:] + [(n, 0)]))
    assert plan.fwd_slabs * plan.fwd_chunks <= SM or plan.fwd_chunks == 1
    tiles = sorted(t for blk in range(plan.bwd_blocks) for t in plan.bwd_block_tiles(blk))
    assert tiles == list(range(plan.bwd_tiles))
    assert plan.bwd_tiles == -(-n // plan.bwd_tile_rows) and plan.bwd_blocks <= SM


@pytest.mark.parametrize("c", LANE_COUNTS)
def test_gram_plan_shared_memory_matches_kernel_source(c):
    """The plan's shared memory is the kernels' (the constants of
    csrc/mi_joint.cu: stage rows, buffers, the widest C) and fits a block."""
    k = _source_constants()
    assert (k["GR_KT"], k["GR_BUFS"], k["GR_MAX_LANES"]) == (
        mi_joint.GRAM_STAGE_ROWS, mi_joint.GRAM_BUFS, mi_joint.GRAM_MAX_LANES)
    plan = mi_joint.gram_plan(150528, c, SM)
    cp = plan.cp
    assert plan.fwd_smem == k["GR_BUFS"] * (2 + cp // 64) * k["GR_KT"] * 128
    h_stage = k["LANES"] * k["BW_KC"] * 2  # joint_core.cuh's BW_H_BYTES
    rows = 128 if cp == 128 else 64       # gram_bwd_rows
    assert plan.bwd_tile_rows == rows
    assert plan.bwd_smem == (cp // 128) * (cp // 64) * h_stage + rows * cp * 2
    assert max(plan.fwd_smem, plan.bwd_smem) <= mi_joint.SMEM_LIMIT == k["SMEM_MAX"]


def test_gram_plan_at_the_pretrain_decoder():
    """[150528, 200]: 66 chunks of 72 stages by 2 slabs (one wave of 132
    blocks), 2352 backward tiles of 64 rows on 132 persistent blocks."""
    plan = mi_joint.gram_plan(150528, 200, SM)
    assert plan.fwd_grid == (2, 66) and plan.fwd_rows_per_chunk == 72 * 32
    assert (plan.bwd_tiles, plan.bwd_blocks) == (2352, 132)


def test_gram_plan_refuses_what_the_kernels_do_not_take():
    for n, c in ((10, 0), (10, 257), (0, 128)):
        with pytest.raises(ValueError):
            mi_joint.gram_plan(n, c, SM)


def test_whole_width_takes_bf16_products_at_p0_only():
    assert mi_joint._whole_width(0, 200, True) and mi_joint._whole_width(0, 1, True)
    assert not mi_joint._whole_width(1, 100, True)
    assert not mi_joint._whole_width(0, 200, False)
    assert not mi_joint._whole_width(0, 384, True)


# ---------------------------------------------------------------------------
# the tiles: the piece table and its plan
# ---------------------------------------------------------------------------

# (name, map rows, map cols, patch, padding, band, origin): the whole map
# (pre-padded, origin p) at patch 8 / 16 / 32, and the 2 x 2 split's band of
# rows [112, 224) of a 224-row map at patch 32 (its tiles cut by the band's
# top edge, a halo of p rows in the canvas)
PIECE_CASES = {
    "whole_p8": (40, 36, 8, 1, None, 1),
    "whole_p16": (40, 36, 16, 3, None, 3),
    "whole_p32": (64, 64, 32, 3, None, 3),
    "band_2x2": (224, 40, 32, 3, (112, 224), 3),
}


def _case_plan(name, device="cpu"):
    map_rows, cols, patch, p, band, origin = PIECE_CASES[name]
    b0, b1 = band or (0, map_rows)
    rows = b1 - b0 + 2 * origin
    return til._piece_plan(rows, cols + 2 * origin, map_rows, cols, patch, p, (b0, b1), origin,
                           torch.device(device)), rows, cols + 2 * origin


@pytest.mark.parametrize("name", sorted(PIECE_CASES))
def test_piece_table_is_the_gather_layout(name):
    """Each piece's (first row, rows, wp) is where ``_gather_pieces`` lays
    its canvas: the pieces follow one another from row 0, each the batch's
    canvases [B, rows, cols] of its shape, and ``_split_pieces`` cuts the
    same views the table names. Every row of the buffer is one piece's."""
    batch = 3
    plan, rows, cols = _case_plan(name)
    pieces = plan.pieces(batch)
    assert len(pieces) == len(plan.tiles) == len(plan.shapes)
    at = 0
    for (first, n, wp), (rc, wc) in zip(pieces, plan.shapes):
        assert first == at and n == batch * rc * wc and wp == wc
        at += n
    x = torch.arange(batch * rows * cols, dtype=torch.float32).reshape(batch, rows, cols, 1) + 1
    flat = til._gather_pieces(x, plan.x_index, plan.x_dead, til._batch_order(plan, batch))
    assert flat.shape == (at, 1)
    for (first, n, wp), canvas in zip(pieces, til._split_pieces(flat, batch, plan.shapes)):
        assert torch.equal(flat[first:first + n].reshape(canvas.shape), canvas)
    map_rows, map_cols, patch, p, band, origin = PIECE_CASES[name]
    if band is not None:  # the band: pieces cut by its edge ride along
        assert len({rc for rc, _ in plan.shapes}) > 1
        return
    # the whole map: piece t is tile t's interior on a zero border of p
    for t, (first, n, wp) in zip(plan.tiles, pieces):
        rs, cs = til._tiles(map_rows, map_cols, patch)[t]
        want = torch.zeros((batch, rs.stop - rs.start + 2 * p, cs.stop - cs.start + 2 * p, 1))
        want[:, p:-p, p:-p] = x[:, origin + rs.start:origin + rs.stop,
                                origin + cs.start:origin + cs.stop]
        assert torch.equal(flat[first:first + n].reshape(want.shape), want)


@pytest.mark.parametrize("name", sorted(PIECE_CASES))
@pytest.mark.parametrize("c", [6, 100, 128])
def test_pieces_plan_covers_each_piece_once(name, c):
    """The grouped backward's blocks cover each piece's rows once, in
    BWD_TILE-row tiles that never cross a piece; the forward has a column of
    blocks for each piece; stages and shared memory are launch_plan's."""
    batch = 2
    plan_g, _, _ = _case_plan(name)
    p = PIECE_CASES[name][3]
    pieces = plan_g.pieces(batch)
    plan = mi_joint.pieces_plan(pieces, c, p, SM)
    t = 2 * p + 1
    assert plan.fwd_grid == (4 * plan.fwd_groups * t, len(pieces))
    assert plan.total_rows == sum(n for _, n, _ in pieces)
    seen = np.zeros(plan.total_rows, np.int64)
    for blk in range(plan.bwd_blocks):
        i, lo, hi = plan.bwd_block_rows(blk)
        first, n, _ = pieces[i]
        assert first <= lo < hi <= first + n and hi - lo <= mi_joint.BWD_TILE
        seen[lo:hi] += 1
    assert (seen == 1).all()
    base = mi_joint.launch_plan(pieces[0][1], c, p, pieces[0][2], SM)
    assert (plan.bwd_stages, plan.bwd_smem, plan.fwd_dx_group, plan.fwd_smem) == (
        base.bwd_stages, base.bwd_smem, base.fwd_dx_group, base.fwd_smem)
    assert plan.table()[-1][3] + -(-pieces[-1][1] // mi_joint.BWD_TILE) == plan.bwd_blocks
    assert _source_constants()["PIECE_FIELDS"] == len(plan.table()[0])


def test_pieces_plan_refuses_gaps_and_narrow_canvases():
    with pytest.raises(ValueError, match="follow"):
        mi_joint.pieces_plan(((0, 10, 8), (12, 10, 8)), 100, 1, SM)
    with pytest.raises(ValueError, match="padding"):
        mi_joint.pieces_plan(((0, 10, 6),), 100, 3, SM)
    with pytest.raises(ValueError):
        mi_joint.pieces_plan((), 100, 1, SM)


# ---------------------------------------------------------------------------
# the grouped autograd with the plain stand-ins
# ---------------------------------------------------------------------------

def _probs(rng, shape, padding=0):
    """Per-subhead softmax maps [B, H, W, S, K], a zero border of width
    ``padding``."""
    z = rng.normal(size=shape) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    x = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    if padding:
        x[:, :padding] = x[:, -padding:] = 0
        x[:, :, :padding] = x[:, :, -padding:] = 0
    return x


def _plain_grouped(pieces, p, dot):
    """The grouped call's autograd with the plain stand-ins in the kernels'
    places: what the card runs, less the kernels."""
    return lambda a, b: mi_joint.pieces_joint(
        a, b, lambda x, y: mi_joint.pieces_fwd_plain(x, y, pieces, p, dot),
        lambda s, g, tr: mi_joint.pieces_bwd_plain(s, g, pieces, p, tr, dot))


@pytest.mark.parametrize("name", ["whole_p8", "band_2x2"])
@pytest.mark.parametrize("operands,dot", [(torch.float32, torch.bfloat16),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.float32, torch.float32)])
def test_grouped_stand_ins_match_per_tile_joints(name, operands, dot):
    """The grouped autograd fed the plain stand-ins (``pieces_joint``) against
    each piece's own plain joint (``displaced_joint_plain_flat`` on its rows,
    autograd for the backward), on the gathered canvases of a whole map and
    of a band: J and both gradients within 1e-5 of their largest entry (bf16
    gradients: one bf16 step, both sides rounding an fp32 sum once)."""
    rng = np.random.default_rng(7)
    batch, s, k = 2, 2, 3
    plan, rows, cols = _case_plan(name)
    p = PIECE_CASES[name][3]
    x = torch.tensor(_probs(rng, (batch, rows, cols, s, k))).reshape(batch, rows, cols, s * k)
    y = torch.tensor(_probs(rng, (batch, rows, cols, s, k))).reshape(batch, rows, cols, s * k)
    order = til._batch_order(plan, batch)
    a = til._gather_pieces(x, plan.x_index, plan.x_dead, order).to(operands)
    b = til._gather_pieces(y, plan.tf_index, plan.tf_dead, order).to(operands)
    pieces = plan.pieces(batch)
    g = torch.tensor(rng.normal(size=(len(pieces), (2 * p + 1) ** 2, s * k, s * k)),
                     dtype=torch.float32)
    outs = []
    for fn in (_plain_grouped(pieces, p, dot),
               lambda u, v: torch.stack([mi_joint.displaced_joint_plain_flat(
                   u[f:f + n], v[f:f + n], wp, p, dot) for f, n, wp in pieces])):
        ta, tb = (t.clone().requires_grad_(True) for t in (a, b))
        joint = fn(ta, tb)
        (joint * g).sum().backward()
        assert ta.grad.dtype == tb.grad.dtype == operands
        outs.append([t.detach().float() for t in (joint, ta.grad, tb.grad)])
    for what, got, want in zip(("joint", "da", "db"), *outs):
        rtol = 2 ** -7 if what != "joint" and operands == torch.bfloat16 else 0
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=rtol,
                                   atol=1e-5 * float(want.abs().max()), err_msg=what)
    # the dispatch on CPU tensors: the plain stack
    assert torch.equal(mi_joint.displaced_joint_pieces(a, b, pieces, p, dot),
                       mi_joint.pieces_fwd_plain(a, b, pieces, p, dot))


def test_tiled_joints_take_one_grouped_call_on_kernel_backends(monkeypatch):
    """``_tiled_joints`` hands every piece of a tap to one grouped call on
    auto / pallas (S*K <= 128) and keeps the per-piece loop on the others
    and above 128 lanes."""
    calls = []
    grouped = mi_joint.displaced_joint_pieces
    monkeypatch.setattr(mi_joint, "displaced_joint_pieces",
                        lambda *a, **kw: calls.append(len(a[2])) or grouped(*a, **kw))
    rng = np.random.default_rng(3)
    p, patch = 1, 8
    shape = (2, 20 + 2 * p, 18 + 2 * p, 2, 3)
    x, y = (torch.tensor(_probs(rng, shape, p)) for _ in range(2))
    n_tiles = len(til._tiles(20, 18, patch))
    for backend, want in (("auto", [n_tiles]), ("pallas", [n_tiles]), ("xla", [])):
        calls.clear()
        til._tiled_joints(x, y, p, patch, backend, True, None, None)
        assert calls == want, backend
    wide = (2, 10 + 2 * p, 10 + 2 * p, 5, 30)
    calls.clear()
    til._tiled_joints(*(torch.tensor(_probs(rng, wide, p)) for _ in range(2)), p, patch, "auto",
                      True, None, None)
    assert calls == []


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

needs_jax = pytest.mark.skipif(jax is None, reason="the JAX package is not installed")


@functools.lru_cache(maxsize=None)
def _tiled_case(p):
    """Pre-padded [2, 12 + 2p, 10 + 2p, 2, 3] maps at patch 8: 2 x 2 tiles
    of the 12 x 10 interior, the last ones flush with its far edges."""
    rng = np.random.default_rng(11 + p)
    shape = (2, 12 + 2 * p, 10 + 2 * p, 2, 3)
    return _probs(rng, shape, p), _probs(rng, shape, p)


@functools.lru_cache(maxsize=None)
def _jax_tiled(p):
    x, y = _tiled_case(p)
    fn = lambda a, b: jil.iid_segmentation_small_patch_loss_subheads(
        a, b, p, 8, backend="pallas", pre_padded=True)
    value, grads = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return float(value), [np.asarray(g) for g in grads]


@needs_jax
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("through", ["dispatch", "stand_ins"])
def test_tiled_loss_matches_jax(monkeypatch, p, through):
    """The port's tiled loss on ``auto`` (pre-padded, patch 8), its tiles in
    one grouped call, against the JAX loss on its Pallas kernel in interpret
    mode: the loss and both gradients. ``stand_ins``: the grouped call as
    the card runs it (``pieces_joint``), the plain stand-ins in the kernels'
    places."""
    if through == "stand_ins":
        monkeypatch.setattr(mi_joint, "displaced_joint_pieces",
                            lambda a, b, pieces, padding, dot: _plain_grouped(
                                pieces, padding, dot)(a, b))
    x, y = _tiled_case(p)
    tx, ty = (torch.tensor(t, requires_grad=True) for t in (x, y))
    loss = til.iid_segmentation_small_patch_loss_subheads(tx, ty, p, 8, backend="auto",
                                                          pre_padded=True)
    loss.backward()
    want, want_grads = _jax_tiled(p)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-4)
    for i, (g, w) in enumerate(zip((tx.grad.numpy(), ty.grad.numpy()), want_grads)):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=f"gradient {i}")


@needs_jax
@pytest.mark.parametrize("mode", ["fp32", "bf16"])
def test_p0_joint_at_200_lanes_matches_jax(mode):
    """The joint at padding 0 over 200 lanes (the pretrain decoder's 10 x 20
    clusters; on the card one product over all lanes) against the JAX
    kernel in interpret mode, values and both gradients: through the
    dispatch (the plain version on CPU tensors) and through the kernels'
    autograd with the plain stand-ins (``joint_bwd_plain_flat``)."""
    rng = np.random.default_rng(5)
    c, shape = 200, (2, 9, 8, 200)
    x = rng.random(shape).astype(np.float32)
    y = rng.random(shape).astype(np.float32)
    g = rng.normal(size=(1, 1, c, c)).astype(np.float32)
    tdot, jdot = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[mode]
    joint, vjp = jax.vjp(lambda a, b: displaced_joint_pallas(a, b, 0, None, jdot, True),
                         jnp.asarray(x), jnp.asarray(y))
    want = [np.asarray(joint)] + [np.asarray(t) for t in vjp(jnp.asarray(g))]
    wp = shape[2]
    stand_ins = lambda a, b: mi_joint.pieces_joint(
        a, b, lambda u, v: mi_joint.displaced_joint_plain_flat(u, v, wp, 0, tdot),
        lambda s, gg, tr: mi_joint.joint_bwd_plain_flat(s, gg, wp, 0, tr, tdot))
    for fn in (lambda a, b: mi_joint.displaced_joint_flat(a, b, wp, 0, tdot), stand_ins):
        ta, tb = (torch.tensor(t.reshape(-1, c), requires_grad=True) for t in (x, y))
        out = fn(ta, tb)
        (out * torch.tensor(g.reshape(1, c, c))).sum().backward()
        got = [out.detach().numpy(), ta.grad.numpy(), tb.grad.numpy()]
        for what, v, w in zip(("joint", "dx", "dx_tf"), got, want):
            np.testing.assert_allclose(v.reshape(w.shape), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max(), err_msg=what)


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("c", LANE_COUNTS)
@pytest.mark.parametrize("rows", [1, 37, 4773])
def test_p0_kernels_match_plain_on_card(rows, c):
    """The p = 0 kernels against the plain version on the card, fp32 and bf16
    operands, ragged rows: exact on small integers (every sum exact in
    fp32), and one launch a product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    gen = torch.Generator(device="cuda").manual_seed(rows + c)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (torch.randint(0, 2, (rows, c), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        g = torch.randint(-2, 3, (1, c, c), generator=gen, device="cuda").float()
        ap, bp = (t.clone().requires_grad_(True) for t in (a, b))
        ref = mi_joint.displaced_joint_plain_flat(ap, bp, 1, 0)
        ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), g)
        mi_joint.reset_launch_counts()
        got = (mi_joint.mi_joint_fwd(a, b, 1, 0), mi_joint.mi_joint_bwd(b, g, 1, 0, True),
               mi_joint.mi_joint_bwd(a, g, 1, 0, False))
        assert sum(mi_joint.LAUNCHES.values()) == 3
        for what, x, y in zip(("fwd", "dx", "dx_tf"), got, (ref, ref_da, ref_db)):
            assert x.dtype == y.dtype and torch.equal(x.float(), y.float()), (what, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["whole_p16", "band_2x2"])
def test_grouped_kernels_match_plain_on_card(name):
    """The grouped kernels against the plain stack of per-piece joints on
    the card, fp32 and bf16 operands of 100 lanes: exact on small integers,
    one launch a product for all pieces."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA kernel has no CPU mode)")
    plan, _, _ = _case_plan(name)
    p = PIECE_CASES[name][3]
    pieces = plan.pieces(2)
    n, c, d = pieces[-1][0] + pieces[-1][1], 100, (2 * p + 1) ** 2
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (torch.randint(0, 2, (n, c), generator=gen, device="cuda").to(dtype)
                for _ in range(2))
        g = torch.randint(-2, 3, (len(pieces), d, c, c), generator=gen, device="cuda").float()
        ap, bp = (t.clone().requires_grad_(True) for t in (a, b))
        ref = mi_joint.pieces_fwd_plain(ap, bp, pieces, p)
        ref_da, ref_db = torch.autograd.grad(ref, (ap, bp), g)
        mi_joint.reset_launch_counts()
        got = (mi_joint.mi_joint_fwd_pieces(a, b, pieces, p),
               mi_joint.mi_joint_bwd_pieces(b, g, pieces, p, True),
               mi_joint.mi_joint_bwd_pieces(a, g, pieces, p, False))
        assert sum(mi_joint.LAUNCHES.values()) == 3
        for what, x, y in zip(("fwd", "dx", "dx_tf"), got, (ref, ref_da, ref_db)):
            assert x.dtype == y.dtype and torch.equal(x.float(), y.float()), (what, dtype)
