"""Local (spatially displaced) IIC segmentation MI loss.

Counterpart of the JAX package's ``ops/iic_local.py``:

  J[dy, dx, k1, k2] = sum_{b,y,x} x[b, y+dy-p, x+dx-p, k1] * x_tf[b, y, x, k2]

with zero contribution outside the image, then per-displacement
normalization, symmetrization and the negative MI (``mi_from_joint``).

Backends (``Kernel.backend``), the same on every front door; none falls back
to another:
  auto, pallas  the CUDA kernel (``ops/mi_joint.py``: bf16 operands, fp32
                sums) for CUDA tensors, its plain version (same rounding) for
                CPU tensors; the JAX package's ``pallas``
  xla           fp32 products, one per displacement (``displaced_joint_xla``,
                ``displaced_joint_xla_subheads``): the parity path
  plain         the same as ``xla`` (the port's first name for it)
  xla_banded    fp32 products of 8-row bands against the stacked (2p+1)^2
                shifts (``displaced_joint_xla_banded``). The JAX package's
                products there are at DEFAULT precision: fp32 on its CPU,
                bf16 passes on a TPU
  xla_scan      ``xla``'s numerics over the (2p+1)^2 displacements of one
                zero-padded copy, each under ``torch.utils.checkpoint``, so
                the backward holds one displacement's temporary
                (``displaced_joint_xla_subheads_scan``)

Front doors: [B, H, W, K] maps (``iid_segmentation_loss``, with a detached
mask; ``iid_segmentation_small_patch_loss``), [B, H, W, S, K] subhead maps
(``iid_segmentation_loss_subheads``,
``iid_segmentation_small_patch_loss_subheads``), flat [B, H, W, C] maps with
C >= S*K (``iid_segmentation_small_patch_loss_flat``, the trainer's), and
logits for ``Kernel.backend=pallas_fused``
(``iid_segmentation_loss_fused_logits``: the decoder heads emit logits and
the ``ops/mi_fused.py`` kernels apply softmax, mask and joint; one full-map
tile, bf16 operands, T = 1).

Small-patch tiling (patch smaller than the map): tiles of patch x patch at
stride patch // 2, the last one flush with the far edge (``_tile_offsets``);
each tile gets its own zero border and takes no halo from its neighbours.
The tiles are gathered onto their bordered canvases in one indexing op
whose indices are built once per geometry and device (``_piece_plan``,
``_gather_pieces``: one flat buffer, piece after piece). On the kernel
backends (S*K <= 128 lanes) the whole buffer goes to the grouped joint
(``mi_joint.displaced_joint_pieces``: on the card one launch a product for
all of a map's tiles, 6 a step over two decoder taps; the gradient comes
back as one tensor for the gather's scatter); on the others, and above 128
lanes, each canvas goes to its backend's joint. The per-tile joints are
stacked so that ``mi_from_joint`` runs once over them, each joint with its
own min; the loss is the mean over tiles of the subhead-mean MI.
``pre_padded`` maps (the trainer's: the zero border of width p is already
there) are gathered from as they stand, border skipped;
a single full-map tile keeps its canvas, and on the kernel backends the
flatten is then a free reshape.

The spatial H split (``map_rows``, the whole map's rows; ``band``, the
canvases' rows [b0, b1) of it): the canvases hold a band of the map, x_out's
with a halo of p rows from the bands around it in its border
(``engine/steps.py:iic_regularization``), x_tf_out's with a zero border.
Every backend reads x_out's canvas as it stands, halo and all: the kernels
as their operand, the others by shifting it against x_tf_out's interior
(``_subhead_joint``'s ``halo``). One full-map tile takes the band's canvas
whole. Below the map the tiles are the whole map's, in its order; each
tile with a row in the band gives a piece: x_tf's canvas the tile's rows in
the band on a zero border of p, x's the same rows +- p from the halo'd
canvas, every entry outside the tile zero, as each tile keeps its own zero
border. A piece goes to the backend's joint as a pre-padded canvas with a
halo (on ``auto`` / ``pallas`` the grouped CUDA joint on the band's pieces as
they stand), a tile that misses the band gives a zero joint, and the stacked
[n_tiles, ...] joints are the band's shares of the one-process joints. The
band's joints, a tile's or the whole map's, are summed over the ranks by
``group``: the one-process joints on every rank.

Data parallelism: every front door takes ``group``, a process group. The
raw joint of each displacement (each tile's, the fused forward's J
included) is summed over its ranks before ``mi_from_joint``, on every
backend; the sum's backward sums the gradient too, so each kernel's backward
receives the global dL/dJ. Every rank then holds the MI of the global batch.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_sum
from . import mi_joint
from .mi_fused import displaced_joint_softmax

KERNEL_BACKENDS = ("auto", "pallas")
BACKENDS = KERNEL_BACKENDS + ("xla", "plain", "xla_banded", "xla_scan")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}: expected one of {BACKENDS}")


def _check_maps(x: torch.Tensor, x_tf: torch.Tensor, dims: int) -> None:
    if x.dim() != dims or x.shape != x_tf.shape:
        raise ValueError(f"expected two equal {dims}-D shapes, got {tuple(x.shape)}, "
                         f"{tuple(x_tf.shape)}")


def displaced_joint_xla_subheads(x: torch.Tensor, x_tf: torch.Tensor,
                                 padding: int) -> torch.Tensor:
    """[B, H, W, S, K] x2 -> [T, T, S, K, K] raw displaced sums, fp32, one
    product of two shifted slices per displacement, all subheads at once."""
    _check_maps(x, x_tf, 5)
    _, h, w, _, _ = x.shape
    p = padding
    x, x_tf = x.float(), x_tf.float()
    rows = []
    for dy in range(-p, p + 1):
        y0, y1 = max(0, -dy), min(h, h - dy)
        cols = []
        for dx in range(-p, p + 1):
            x0, x1 = max(0, -dx), min(w, w - dx)
            a = x[:, y0 + dy:y1 + dy, x0 + dx:x1 + dx]
            b = x_tf[:, y0:y1, x0:x1]
            cols.append(torch.einsum("bhwsk,bhwsl->skl", a, b))
        rows.append(torch.stack(cols))
    return torch.stack(rows)


def displaced_joint_xla(x: torch.Tensor, x_tf: torch.Tensor, padding: int) -> torch.Tensor:
    """[B, H, W, K] x2 -> [T, T, K, K]: ``displaced_joint_xla_subheads`` of
    one subhead."""
    _check_maps(x, x_tf, 4)
    return displaced_joint_xla_subheads(x[..., None, :], x_tf[..., None, :], padding)[:, :, 0]


def displaced_joint_xla_banded(x: torch.Tensor, x_tf: torch.Tensor, padding: int,
                               band_rows: int = 8) -> torch.Tensor:
    """[B, H, W, C] x2 -> [T, T, C, C]: per band of ``band_rows`` rows of
    x_tf, the (2p+1)^2 shifted bands of the zero-padded x stacked into
    [B, rb, W, T*T, C] and contracted against it in one fp32 product."""
    _check_maps(x, x_tf, 4)
    p = padding
    return _xla_banded_canvas(F.pad(x.float(), (0, 0, p, p, p, p)), x_tf.float(), p, band_rows)


def _xla_banded_canvas(xp: torch.Tensor, xtf: torch.Tensor, padding: int,
                       band_rows: int = 8) -> torch.Tensor:
    """``displaced_joint_xla_banded`` of x's canvas ``xp`` [B, H+2p, W+2p, C]
    as it stands (its border zero, or a band's halo rows) against x_tf
    [B, H, W, C]."""
    b, h, w, c = xtf.shape
    p, t = padding, 2 * padding + 1
    out = xtf.new_zeros((t * t, c, c))
    for h0 in range(0, h, band_rows):
        rb = min(band_rows, h - h0)
        shifts = torch.stack([xp[:, h0 + dy:h0 + dy + rb, dx:dx + w]
                              for dy in range(t) for dx in range(t)], dim=3)
        out = out + torch.einsum("brwdc,brwe->dce", shifts, xtf[:, h0:h0 + rb])
    return out.reshape(t, t, c, c)


def _one_displacement(xp: torch.Tensor, xtf: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    _, h, w, _, _ = xtf.shape
    return torch.einsum("bhwsk,bhwsl->skl", xp[:, dy:dy + h, dx:dx + w], xtf)


def displaced_joint_xla_subheads_scan(x: torch.Tensor, x_tf: torch.Tensor,
                                      padding: int) -> torch.Tensor:
    """``displaced_joint_xla_subheads`` with its memory bounded: one
    zero-padded fp32 copy of x, and each displacement's product under
    ``torch.utils.checkpoint``, so the forward keeps no per-displacement
    temporary and the backward recomputes one displacement at a time. Zero
    padding adds exact zeros, so the values are the sliced form's up to
    summation order."""
    _check_maps(x, x_tf, 5)
    p = padding
    return _xla_scan_canvas(F.pad(x.float(), (0, 0, 0, 0, p, p, p, p)), x_tf.float(), p)


def _xla_scan_canvas(xp: torch.Tensor, xtf: torch.Tensor, padding: int) -> torch.Tensor:
    """``displaced_joint_xla_subheads_scan`` of x's canvas ``xp``
    [B, H+2p, W+2p, S, K] as it stands against x_tf [B, H, W, S, K]."""
    _, _, _, s, k = xtf.shape
    t = 2 * padding + 1
    joints = [checkpoint(_one_displacement, xp, xtf, dy, dx, use_reentrant=False)
              for dy in range(t) for dx in range(t)]
    return torch.stack(joints).reshape(t, t, s, k, k)


def _xla_canvas(xp: torch.Tensor, xtf: torch.Tensor, padding: int) -> torch.Tensor:
    """``displaced_joint_xla_subheads`` of x's canvas ``xp``
    [B, H+2p, W+2p, S, K] as it stands against x_tf [B, H, W, S, K]: one
    product of x's shifted window and x_tf per displacement."""
    t = 2 * padding + 1
    return torch.stack([torch.stack([_one_displacement(xp, xtf, dy, dx) for dx in range(t)])
                        for dy in range(t)])


def displaced_joint_subheads(x: torch.Tensor, x_tf: torch.Tensor, padding: int) -> torch.Tensor:
    """Subhead-leading form: [S, B, H, W, K] x2 -> [S, T, T, K, K]."""
    _check_maps(x, x_tf, 5)
    return displaced_joint_xla_subheads(x.movedim(0, 3), x_tf.movedim(0, 3),
                                        padding).movedim(2, 0)


def displaced_joint(x: torch.Tensor, x_tf: torch.Tensor, padding: int,
                    backend: str = "auto") -> torch.Tensor:
    """[B, H, W, K] x2 -> [T, T, K, K] by ``backend``."""
    _check_backend(backend)
    if backend in KERNEL_BACKENDS:
        return mi_joint.displaced_joint(x, x_tf, padding, torch.bfloat16)
    if backend == "xla_banded":
        return displaced_joint_xla_banded(x, x_tf, padding)
    if backend == "xla_scan":
        _check_maps(x, x_tf, 4)
        return displaced_joint_xla_subheads_scan(x[..., None, :], x_tf[..., None, :],
                                                 padding)[:, :, 0]
    return displaced_joint_xla(x, x_tf, padding)


def mi_from_joint(joint: torch.Tensor, lamb: float = 1.0) -> torch.Tensor:
    """[..., T, T, K, K] raw sums -> [...] negative MI averaged over the
    displacements of each joint. Per joint: min subtraction (detached),
    per-displacement normalization over both cluster axes, symmetrization,
    then sum(-P * (log P - lamb log Pi - lamb log Pj)) / T^2."""
    t = joint.shape[-4]
    whole = (-4, -3, -2, -1)
    p = joint - joint.amin(dim=whole, keepdim=True).detach() + 1e-16
    p = p / p.sum(dim=(-2, -1), keepdim=True)
    p = (p + p.transpose(-2, -1)) / 2.0
    p_i = p.sum(-2, keepdim=True).expand_as(p)
    p_j = p.sum(-1, keepdim=True).expand_as(p)
    loss = -p * (torch.log(p + 1e-16) - lamb * torch.log(p_i + 1e-16)
                 - lamb * torch.log(p_j + 1e-16))
    return loss.sum(dim=whole) / (t * t)


def _subhead_mi(joint: torch.Tensor, lamb: float, group=None) -> torch.Tensor:
    """[..., T, T, S, K, K] -> the subhead-mean MI, averaged over the leading
    axes (tiles), of the joint summed over ``group``."""
    return mi_from_joint(all_reduce_sum(joint, group).movedim(-3, 0), lamb).mean()


def _block_diagonal_subheads(flat_joint: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """[..., T, T, S*K, S*K] -> per-subhead diagonal blocks
    [..., T, T, S, K, K] (a view)."""
    r = flat_joint.reshape(flat_joint.shape[:-2] + (s, k, s, k))
    return torch.diagonal(r, dim1=-4, dim2=-2).movedim(-1, -3)


def _tile_offsets(size: int, patch: int, step: int) -> Tuple[int, ...]:
    """The original project's patch offsets: range(0, size - patch, step)
    plus max(size - patch, 0)."""
    offsets = list(range(0, max(size - patch, 0), step))
    offsets.append(max(size - patch, 0))
    return tuple(offsets)


def _tiles(h: int, w: int, patch: int) -> List[Tuple[slice, slice]]:
    """(rows, cols) of each tile of an h x w map, row-major."""
    ph, pw = min(patch, h), min(patch, w)
    step = max(patch // 2, 1)
    return [(slice(hy, hy + ph), slice(wx, wx + pw)) for hy in _tile_offsets(h, patch, step)
            for wx in _tile_offsets(w, patch, step)]


@dataclasses.dataclass(frozen=True)
class _PiecePlan:
    """The gather of a map's tile pieces: ``tiles`` the numbers of the tiles
    (of ``n_tiles``, in ``_tiles``' order) that have a piece, ``shapes``
    each piece's canvas [rows, cols]; per half, the flat index of each
    canvas entry into one image's [rows * cols] (piece-major, then
    row-major) and whether the entry is dead (zero on the canvas);
    ``start`` and ``size``, the first entry and the entries of each entry's
    piece, place a batch's entries piece by piece (``_batch_order``)."""

    n_tiles: int
    tiles: Tuple[int, ...]
    shapes: Tuple[Tuple[int, int], ...]
    x_index: torch.Tensor
    x_dead: torch.Tensor
    tf_index: torch.Tensor
    tf_dead: torch.Tensor
    start: torch.Tensor
    size: torch.Tensor

    def pieces(self, batch: int) -> mi_joint.Pieces:
        """Each piece's (first row, rows, canvas width) in the flat [rows, C]
        buffer of a batch's canvases laid piece by piece (``_batch_order``):
        the grouped joint's table."""
        return _pieces(self.shapes, batch)


@functools.lru_cache(maxsize=64)
def _pieces(shapes: Tuple[Tuple[int, int], ...], batch: int) -> mi_joint.Pieces:
    sizes = [batch * rc * wc for rc, wc in shapes]
    firsts = np.cumsum([0] + sizes[:-1])
    return tuple((int(f), n, wc) for f, n, (_, wc) in zip(firsts, sizes, shapes))


@functools.lru_cache(maxsize=64)
def _piece_plan(rows: int, cols: int, map_rows: int, map_cols: int, patch: int, padding: int,
                band: Tuple[int, int], origin: int, device: torch.device) -> _PiecePlan:
    """The pieces of the tiles of a ``map_rows`` x ``map_cols`` map held in
    [B, rows, cols, ...] arrays whose entry (0, 0) is the map's pixel
    (band[0] - origin, -origin): the whole map (band (0, map_rows)) or a
    band of it, pre-padded (``origin`` = p) or not (0). A tile's piece is
    its rows in the band [b0, b1) on a zero border of p: x_tf's canvas those
    rows, x's the same rows +- p, each entry outside the tile zero. Built
    once per geometry and device."""
    p, (b0, b1) = padding, band
    tiles = _tiles(map_rows, map_cols, patch)
    kept, shapes, parts = [], [], {k: [] for k in ("xi", "xd", "ti", "td")}
    for t, (rs, cs) in enumerate(tiles):
        y0, y1 = max(rs.start, b0), min(rs.stop, b1)
        if y0 >= y1:  # the tile misses the band
            continue
        g = np.arange(y0 - p, y1 + p)[:, None]  # the canvas's rows and columns in the map
        c = np.arange(cs.start - p, cs.stop + p)[None, :]
        at_r, at_c = g - b0 + origin, c + origin
        in_cols = (c >= cs.start) & (c < cs.stop)
        live_x = (g >= rs.start) & (g < rs.stop) & in_cols
        live_tf = (g >= y0) & (g < y1) & in_cols
        inside = (at_r >= 0) & (at_r < rows) & (at_c >= 0) & (at_c < cols)
        if not inside[live_x].all():
            raise ValueError(f"tile {t} reaches past the [{rows}, {cols}] canvas of the band "
                             f"{band}: a band's canvas needs a halo of p = {p} rows")
        flat = np.clip(at_r, 0, rows - 1) * cols + np.clip(at_c, 0, cols - 1)
        for key, live in (("x", live_x), ("t", live_tf)):
            parts[key + "i"].append(flat.reshape(-1))
            parts[key + "d"].append((~live).reshape(-1))
        kept.append(t)
        shapes.append((y1 - y0 + 2 * p, cs.stop - cs.start + 2 * p))
    sizes = [rc * wc for rc, wc in shapes]
    parts["start"] = [np.repeat(np.cumsum([0] + sizes[:-1]), sizes)]
    parts["size"] = [np.repeat(sizes, sizes)]
    index = {k: torch.from_numpy(np.concatenate(v)).to(device) for k, v in parts.items()}
    return _PiecePlan(len(tiles), tuple(kept), tuple(shapes), index["xi"], index["xd"],
                      index["ti"], index["td"], index["start"], index["size"])


def _batch_order(plan: _PiecePlan, batch: int) -> torch.Tensor:
    """[batch, n]: where entry i of image b lands when a batch's canvases lie
    piece by piece, each piece's [batch, rows, cols] contiguous."""
    n = plan.start.numel()
    at = torch.arange(batch, device=plan.start.device)[:, None]
    within = torch.arange(n, device=plan.start.device) - plan.start
    return batch * plan.start + within + at * plan.size


def _gather_pieces(x: torch.Tensor, index: torch.Tensor, dead: torch.Tensor,
                   order: torch.Tensor) -> torch.Tensor:
    """The canvases of a ``_PiecePlan`` half from [B, H, W, ...] ``x``, laid
    out by ``order`` (``_batch_order``) in one flat [rows, ...] buffer, piece
    after piece (each piece's [B, rows, cols, ...] contiguous): one gather,
    its dead entries zeroed. The backward is one accumulating scatter into
    x, where a slice per piece would add a zero-filled copy of x per piece."""
    b, tail = x.shape[0], x.shape[3:]
    flat = torch.empty(order.numel(), dtype=index.dtype, device=x.device)
    flat[order.reshape(-1)] = (index + x.shape[1] * x.shape[2] * torch.arange(
        b, device=x.device)[:, None]).reshape(-1)
    holes = torch.empty(order.numel(), dtype=torch.bool, device=x.device)
    holes[order.reshape(-1)] = dead.expand(b, -1).reshape(-1)
    return x.reshape((-1,) + tail)[flat].masked_fill(holes.reshape((-1,) + (1,) * len(tail)), 0)


def _split_pieces(flat: torch.Tensor, batch: int,
                  shapes: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """``_gather_pieces``' buffer as the canvases [B, rows, cols, ...]."""
    tail = flat.shape[1:]
    return [piece.view((batch, rc, wc) + tail) for piece, (rc, wc) in
            zip(flat.split([batch * rc * wc for rc, wc in shapes]), shapes)]


def _tiled_joints(x: torch.Tensor, x_tf: torch.Tensor, padding: int, patch: int, backend: str,
                  pre_padded: bool, map_rows: Optional[int],
                  band: Optional[Tuple[int, int]]) -> torch.Tensor:
    """[n_tiles, T, T, S, K, K]: each tile's joint over [B, H, W, S, K] maps
    (``pre_padded``: canvases with the border of width p), or under the H
    split (``map_rows``, the whole map's rows; ``band``, the canvases' rows
    [b0, b1) of it) each tile's share from its piece of the band: zeros for
    a tile that misses the band. Each piece is a pre-padded canvas taken as
    it stands: on the kernel backends (S*K <= 128 lanes) all of them go to
    the grouped joint (``mi_joint.displaced_joint_pieces``: one call, one
    launch a product on the card); otherwise each to the backend's joint."""
    rows, cols = x.shape[1:3]
    b, _, _, s, k = x.shape
    o = padding if pre_padded else 0
    if map_rows is None:
        map_rows, band = rows - 2 * o, (0, rows - 2 * o)
    elif band is None or not pre_padded:
        raise ValueError("a band's tiles need pre-padded canvases and the band's rows")
    plan = _piece_plan(rows, cols, map_rows, cols - 2 * o, patch, padding, tuple(band), o,
                       x.device)
    order = _batch_order(plan, b)
    xs, ts = (_gather_pieces(t, i, dead, order) for t, i, dead in
              ((x, plan.x_index, plan.x_dead), (x_tf, plan.tf_index, plan.tf_dead)))
    if backend in KERNEL_BACKENDS and s * k <= mi_joint.LANES:
        t = 2 * padding + 1
        flat = mi_joint.displaced_joint_pieces(xs.reshape(-1, s * k), ts.reshape(-1, s * k),
                                               plan.pieces(b), padding, torch.bfloat16)
        joints = _block_diagonal_subheads(flat.reshape((-1, t, t, s * k, s * k)), s, k)
    else:
        joints = torch.stack([_subhead_joint(a, c, padding, backend, pre_padded=True, halo=True)
                              for a, c in zip(_split_pieces(xs, b, plan.shapes),
                                              _split_pieces(ts, b, plan.shapes))])
    if len(plan.tiles) == plan.n_tiles:
        return joints
    out = joints.new_zeros((plan.n_tiles,) + joints.shape[1:])
    return out.index_copy(0, torch.tensor(plan.tiles, device=joints.device), joints)


def _strip(x: torch.Tensor, padding: int) -> torch.Tensor:
    """A pre-padded map's interior (the border of width ``padding`` off)."""
    p = padding
    return x[:, p:x.shape[1] - p, p:x.shape[2] - p]


def iid_segmentation_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor, padding: int = 7,
                          lamb: float = 1.0, mask: Optional[torch.Tensor] = None,
                          backend: str = "auto", group=None) -> torch.Tensor:
    """Displaced-MI loss over per-pixel cluster simplexes [B, H, W, K]; the
    ``mask`` multiplies both maps and takes no gradient."""
    if mask is not None:
        mask = mask.detach()
        x_out, x_tf_out = x_out * mask, x_tf_out * mask
    return mi_from_joint(all_reduce_sum(displaced_joint(x_out, x_tf_out, padding, backend), group),
                         lamb)


def iid_segmentation_small_patch_loss(x_out: torch.Tensor, x_tf_out: torch.Tensor,
                                      padding: int = 7, patch_size: int = 32, lamb: float = 1.0,
                                      mask: Optional[torch.Tensor] = None,
                                      backend: str = "auto", group=None) -> torch.Tensor:
    """``iid_segmentation_loss`` averaged over the tiles of [B, H, W, K] maps
    (one full-map tile when ``patch_size`` covers the map): the subhead
    front door with one subhead."""
    _check_maps(x_out, x_tf_out, 4)
    if mask is not None:
        mask = mask.detach()
        x_out, x_tf_out = x_out * mask, x_tf_out * mask
    return iid_segmentation_small_patch_loss_subheads(
        x_out[..., None, :], x_tf_out[..., None, :], padding, patch_size, lamb, backend,
        group=group)


def _subhead_joint(x: torch.Tensor, x_tf: torch.Tensor, padding: int, backend: str,
                   pre_padded: bool = False, halo: bool = False) -> torch.Tensor:
    """[B, H, W, S, K] x2 -> [T, T, S, K, K] by ``backend``. The kernel
    backends take the maps as [B, H, W, S*K] (C = S*K lanes, no dead ones),
    pre-padded or not, and read x's canvas as it stands. On pre-padded
    canvases the others shift a canvas of x against x_tf's interior: x's as
    it stands with ``halo`` (its border rows a band's halo under the H
    split), else x's interior on a zero border, so that the border takes no
    gradient (the JAX package's ``xla`` backends strip it)."""
    _check_backend(backend)
    b, h, w, s, k = x.shape
    if backend in KERNEL_BACKENDS:
        flat = mi_joint.displaced_joint(x.reshape(b, h, w, s * k), x_tf.reshape(b, h, w, s * k),
                                        padding, torch.bfloat16, pre_padded)
        return _block_diagonal_subheads(flat, s, k)
    if pre_padded:
        p = padding
        xp = x.float() if halo else F.pad(_strip(x, p).float(), (0, 0, 0, 0, p, p, p, p))
        xtf = _strip(x_tf, p).float()
        if backend == "xla_banded":
            _, hi, wi, _, _ = xtf.shape
            flat = _xla_banded_canvas(xp.reshape(b, h, w, s * k),
                                      xtf.reshape(b, hi, wi, s * k), padding)
            return _block_diagonal_subheads(flat, s, k)
        if backend == "xla_scan":
            return _xla_scan_canvas(xp, xtf, padding)
        return _xla_canvas(xp, xtf, padding)
    if backend == "xla_banded":
        flat = displaced_joint_xla_banded(x.reshape(b, h, w, s * k),
                                          x_tf.reshape(b, h, w, s * k), padding)
        return _block_diagonal_subheads(flat, s, k)
    if backend == "xla_scan":
        return displaced_joint_xla_subheads_scan(x, x_tf, padding)
    return displaced_joint_xla_subheads(x, x_tf, padding)


def iid_segmentation_loss_subheads(x_out: torch.Tensor, x_tf_out: torch.Tensor, padding: int,
                                   lamb: float = 1.0, backend: str = "auto",
                                   pre_padded: bool = False, group=None) -> torch.Tensor:
    """Mean over subheads of the displaced-MI loss of [B, H, W, S, K] maps
    (one tile). ``pre_padded``: the maps carry the zero border of width
    ``padding``."""
    _check_maps(x_out, x_tf_out, 5)
    return _subhead_mi(_subhead_joint(x_out, x_tf_out, padding, backend, pre_padded), lamb,
                       group)


def iid_segmentation_small_patch_loss_subheads(
    x_out: torch.Tensor,
    x_tf_out: torch.Tensor,
    padding: int,
    patch_size: int,
    lamb: float = 1.0,
    backend: str = "auto",
    pre_padded: bool = False,
    group=None,
    map_rows: Optional[int] = None,
    band: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """The tiled subhead loss over [B, H, W, S, K] maps: the mean over tiles
    of each tile's subhead-mean loss. A pre-padded map that one tile covers
    takes one joint of its canvases, border and all. ``map_rows``: the whole
    map's rows when the canvases hold a band of it (``_one_tile``), x_out's
    with a halo of p rows (``_subhead_joint``); ``band``: the band's rows
    [b0, b1) of the map, which tiles below the map need (``_tiled_joints``)."""
    _check_maps(x_out, x_tf_out, 5)
    _check_backend(backend)
    if pre_padded and _one_tile(x_out, padding, patch_size, map_rows):
        return _subhead_mi(_subhead_joint(x_out, x_tf_out, padding, backend, True,
                                          halo=map_rows is not None), lamb, group)
    return _subhead_mi(_tiled_joints(x_out, x_tf_out, padding, patch_size, backend, pre_padded,
                                     map_rows, band), lamb, group)


def iid_segmentation_small_patch_loss_flat(
    x_out: torch.Tensor,
    x_tf_out: torch.Tensor,
    S: int,
    K: int,
    padding: int,
    patch_size: int,
    lamb: float = 1.0,
    backend: str = "auto",
    pre_padded: bool = False,
    group=None,
    map_rows: Optional[int] = None,
    band: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """Subhead-mean displaced-MI loss over flat [B, H, W, C] maps, C >= S*K
    (trailing lanes dead). A single tile on a kernel backend takes the joint
    of all C lanes as they are (the headline config's patch_sizes=1024);
    otherwise the dead lanes are dropped and the [B, H, W, S, K] view goes to
    ``iid_segmentation_small_patch_loss_subheads``. ``map_rows`` and
    ``band``: the whole map's rows and the band's when pre-padded canvases
    hold a band of it."""
    b, h, w, c = x_out.shape
    if c < S * K:
        raise ValueError(f"{c} lanes cannot hold {S} x {K} clusters")
    _check_backend(backend)
    one = (_one_tile(x_out, padding, patch_size, map_rows) if pre_padded
           else patch_size >= max(h, w))
    if backend in KERNEL_BACKENDS and one:
        flat = mi_joint.displaced_joint(x_out, x_tf_out, padding, torch.bfloat16, pre_padded)
        return _subhead_mi(_block_diagonal_subheads(flat[:, :, :S * K, :S * K], S, K), lamb,
                           group)
    five = lambda t: t[..., :S * K].reshape(b, h, w, S, K)
    return iid_segmentation_small_patch_loss_subheads(
        five(x_out), five(x_tf_out), padding, patch_size, lamb, backend, pre_padded, group,
        map_rows, band)


def _one_tile(x: torch.Tensor, padding: int, patch: int, map_rows: Optional[int]) -> bool:
    """Whether one tile covers the map of a pre-padded canvas [B, Hp, Wp, ...]:
    its interior, or with ``map_rows`` (the H split: the canvas holds a band
    of the map, its x canvas a halo of p rows) the whole map's rows by the
    interior's columns."""
    rows = x.shape[1] - 2 * padding if map_rows is None else map_rows
    return patch >= max(rows, x.shape[2] - 2 * padding)


def iid_segmentation_loss_fused_logits(l1: torch.Tensor, l2: torch.Tensor, S: int, K: int,
                                       padding: int, lamb: float = 1.0,
                                       T: float = 1.0, group=None,
                                       rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Subhead-mean displaced-MI loss straight from pre-padded C-lane logit
    canvases [B, Hp, Wp, C], C a multiple of 128 holding the S*K live lanes
    (one full-map tile): the row-max group softmax over the whole row, the
    interior mask and the joint in the fused kernels, bf16 operands. The
    fused forward's J is summed over ``group``; its backward gets the global
    gradient. ``rows1``: l1's live rows [y_lo, y_hi) of each canvas (a band's
    halo'd canvas under the H split; None: its interior)."""
    flat = displaced_joint_softmax(l1, l2, padding, S, K, T, rows1=rows1)
    return _subhead_mi(_block_diagonal_subheads(flat[:, :, :S * K, :S * K], S, K), lamb,
                       group)
