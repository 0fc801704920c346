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
The tiles are gathered onto their bordered canvases in one op
(``_tile_canvases``), each canvas goes to its backend's joint, and the
per-tile joints are stacked so that ``mi_from_joint`` runs once over them,
each joint with its own min; the loss is the mean over tiles of the
subhead-mean MI. With ``pre_padded`` maps (the trainer's: the zero border of
width p is already there) the border is stripped before tiling; a single
full-map tile keeps it, and on the kernel backends the flatten is then a free
reshape.

The spatial H split (``map_rows``, the whole map's rows): the canvases hold
a band of the map, x_out's with a halo of p rows from the neighbouring
bands in its border (``engine/steps.py:iic_regularization``), x_tf_out's
with a zero border. One tile must cover the whole map (the step refuses a
patch below it: tiles would cross the bands). Every backend reads x_out's
canvas as it stands, halo and all: the kernels as their operand, the others
by shifting it against x_tf_out's interior (``_subhead_joint``'s
``halo``). The band's joint
is the band's share of the map's, summed over the ranks by ``group``.

Data parallelism: every front door takes ``group``, a process group. The
raw joint of each displacement (each tile's, the fused forward's J
included) is summed over its ranks before ``mi_from_joint``, on every
backend; the sum's backward sums the gradient too, so each kernel's backward
receives the global dL/dJ. Every rank then holds the MI of the global batch.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
    """[T, T, S*K, S*K] -> per-subhead diagonal blocks [T, T, S, K, K] (a
    view)."""
    t = flat_joint.shape[0]
    r = flat_joint.reshape(t, t, s, k, s, k)
    return torch.diagonal(r, dim1=2, dim2=4).movedim(-1, 2)


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


def _tile_canvases(x: torch.Tensor, patch: int, padding: int) -> Tuple[torch.Tensor, ...]:
    """The tiles of [B, H, W, ...] maps, each on its own zero border of width
    ``padding``: n contiguous [B, ph + 2p, pw + 2p, ...] canvases, gathered
    by one indexing op and padded by one pad. Their backward is one stack
    and one scatter-add into the map, where a slice per tile would add a
    zero-filled copy of the whole map per tile."""
    tiles = _tiles(x.shape[1], x.shape[2], patch)
    rows = torch.tensor([list(range(r.start, r.stop)) for r, _ in tiles], device=x.device)
    cols = torch.tensor([list(range(c.start, c.stop)) for _, c in tiles], device=x.device)
    stack = x[:, rows[:, :, None], cols[:, None, :]].movedim(1, 0)  # [n, B, ph, pw, ...]
    p = padding
    tail = (0, 0) * (x.dim() - 3)
    return F.pad(stack, tail + (p, p, p, p)).unbind(0)


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
) -> torch.Tensor:
    """The tiled subhead loss over [B, H, W, S, K] maps: the mean over tiles
    of each tile's subhead-mean loss. A pre-padded map that one tile covers
    takes one joint of its canvases, border and all. ``map_rows``:
    the whole map's rows when the canvases hold a band of it (``_one_tile``),
    x_out's with a halo of p rows (``_subhead_joint``)."""
    _check_maps(x_out, x_tf_out, 5)
    _check_backend(backend)
    if pre_padded:
        if _one_tile(x_out, padding, patch_size, map_rows):
            return _subhead_mi(_subhead_joint(x_out, x_tf_out, padding, backend, True,
                                              halo=map_rows is not None), lamb, group)
        x_out, x_tf_out = _strip(x_out, padding), _strip(x_tf_out, padding)
    joints = [_subhead_joint(a, b, padding, backend, pre_padded=True) for a, b in zip(
        _tile_canvases(x_out, patch_size, padding), _tile_canvases(x_tf_out, patch_size, padding))]
    return _subhead_mi(torch.stack(joints), lamb, group)


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
) -> torch.Tensor:
    """Subhead-mean displaced-MI loss over flat [B, H, W, C] maps, C >= S*K
    (trailing lanes dead). A single tile on a kernel backend takes the joint
    of all C lanes as they are (the headline config's patch_sizes=1024);
    otherwise the dead lanes are dropped and the [B, H, W, S, K] view goes to
    ``iid_segmentation_small_patch_loss_subheads``. ``map_rows``: the whole
    map's rows when pre-padded canvases hold a band of it (``_one_tile``)."""
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
        map_rows)


def _one_tile(x: torch.Tensor, padding: int, patch: int, map_rows: Optional[int]) -> bool:
    """Whether one tile covers the map of a pre-padded canvas [B, Hp, Wp, ...]:
    its interior, or with ``map_rows`` (the H split: the canvas holds a band
    of the map, its x canvas a halo of p rows) the whole map's rows by the
    interior's columns. The step refuses a tile below a banded map
    (``engine/steps.py:check_iic_split``)."""
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
