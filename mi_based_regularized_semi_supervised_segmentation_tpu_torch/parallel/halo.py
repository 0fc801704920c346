"""The exchanges of the spatial H split between the space ranks of a data
rank (what XLA inserts under the JAX package's ``batch_sharding(mesh,
space_axis="space")``).

Under a split context (``parallel/mesh.py:split_context``) space rank s of
S holds the band ``[s * h, (s + 1) * h)`` of a map of H = S * h rows:

- ``halo_exchange(x, context, dim, rows=1)``: the band with the ``rows``
  rows of the map above it and below it (zeros past the map's ends: the
  global convolution's zero padding, or the IIC canvas's border). Up to a
  band's h rows they come from the neighbouring bands' edges, and the
  backward adds the halo rows' gradients to the neighbours' edge rows;
  beyond h the halo is cut from the whole map (``gather_h``), whose
  backward sums the gradients over the space group.
- ``flip_bands(x, context, dim)``: the band of the map flipped along H.
  Flipped band s holds band S - 1 - s reversed; the backward is the same
  swap of the gradient.
- ``gather_h(x, context, dim)``: the whole map on every space rank
  (``parallel/mesh.py:all_gather_parts`` over the space group: its backward
  sums the gradients over the space group and keeps the rank's band, since
  each rank's loss sees the whole map only through its own band of what is
  computed from it). ``band_slice`` keeps the rank's band of a whole map
  (its backward is the slice's: zeros outside the band).

The halo and the band swap are ``torch.autograd.Function``s. Every exchange
is one ``gather_parts`` over the space group: each rank writes its part into
zeros and the group sums them. A sum with zeros is exact, and every backend
sums: gloo, which carries several ranks on one card, stages CUDA tensors on
the host for ``all_reduce`` but takes none in ``all_gather`` or a
point-to-point ``send``. So there is one path whatever the backend, and a
failed collective raises. A bf16 or fp16 band travels as fp32 (exact both
ways). ``EXCHANGED`` counts the bytes of the buffers a rank reduces, by
exchange, forward and backward (a remat block's recompute counts again):
``halo`` the U-Net's one-row halos, ``iic_halo`` the IIC halves' p-row
ones (``kind``), ``flip`` and ``gather``.
"""

from __future__ import annotations

from typing import Dict

import torch

from .mesh import DistContext, all_gather_parts, gather_parts

EXCHANGED: Dict[str, int] = {"halo": 0, "iic_halo": 0, "flip": 0, "gather": 0}


def reset_exchange_counts() -> None:
    for k in EXCHANGED:
        EXCHANGED[k] = 0


class SpaceSplitUnsupported(NotImplementedError):
    """A model, option or mode that the H split does not run."""


def _tally(kind: str, reduced: torch.Tensor) -> None:
    """Counts the bytes of a buffer reduced over the space group (a bf16 or
    fp16 one as fp32)."""
    EXCHANGED[kind] += reduced.numel() * max(reduced.element_size(), 4)


def _every_band(x: torch.Tensor, context: DistContext, kind: str) -> torch.Tensor:
    """[S, ...]: every space rank's ``x`` (the same shape on each), slot s
    space rank s's."""
    slots = gather_parts(x[None], context.space_group, context.space_size, context.space_rank)
    _tally(kind, slots)
    return slots


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, context: DistContext, dim: int, rows: int, kind: str):
        ctx.context, ctx.dim, ctx.rows, ctx.kind = context, dim, rows, kind
        s, last, r = context.space_rank, context.space_size - 1, rows
        edges = _every_band(torch.stack([x.narrow(dim, 0, r), x.narrow(dim, x.shape[dim] - r, r)]),
                            context, kind)
        zeros = torch.zeros_like(x.narrow(dim, 0, r))
        above = edges[s - 1, 1] if s > 0 else zeros  # the last rows of the band above
        below = edges[s + 1, 0] if s < last else zeros  # the first rows of the band below
        return torch.cat([above, x, below], dim=dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        context, dim, r = ctx.context, ctx.dim, ctx.rows
        s, last = context.space_rank, context.space_size - 1
        h = grad.shape[dim] - 2 * r
        # slot s: the gradients of its halo rows, owed to the bands above and below
        owed = _every_band(torch.stack([grad.narrow(dim, 0, r), grad.narrow(dim, h + r, r)]),
                           context, ctx.kind)
        dx = grad.narrow(dim, r, h).clone()
        if s > 0:  # the band above's lower halo: this band's first rows
            dx.narrow(dim, 0, r).add_(owed[s - 1, 1])
        if s < last:  # the band below's upper halo: this band's last rows
            dx.narrow(dim, h - r, r).add_(owed[s + 1, 0])
        return dx, None, None, None, None


def halo_exchange(x: torch.Tensor, context: DistContext, dim: int = 2, rows: int = 1,
                  kind: str = "halo") -> torch.Tensor:
    """The band ``x`` with the ``rows`` rows of the map above and below it
    along ``dim`` (zeros past the map's ends): [..., h + 2 rows, ...], its
    bytes counted under ``EXCHANGED[kind]``. Beyond the band's h rows the
    halo spans several bands and is cut from the whole map."""
    if rows <= 0:
        return x
    h = x.shape[dim]
    if rows > h:
        pad = [0, 0] * (x.dim() - 1 - dim) + [rows, rows]
        whole = torch.nn.functional.pad(gather_h(x, context, dim, kind), pad)
        return whole.narrow(dim, context.space_rank * h, h + 2 * rows)
    return _Halo.apply(x, context, dim, rows, kind)


def _swap(x: torch.Tensor, context: DistContext, dim: int) -> torch.Tensor:
    """Band S - 1 - s of the others, reversed along ``dim``."""
    bands = _every_band(x, context, "flip")
    return bands[context.space_size - 1 - context.space_rank].flip(dim)


class _FlipBands(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, context: DistContext, dim: int):
        ctx.context, ctx.dim = context, dim
        return _swap(x, context, dim)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _swap(grad.contiguous(), ctx.context, ctx.dim), None, None


def flip_bands(x: torch.Tensor, context: DistContext, dim: int = 1) -> torch.Tensor:
    """This rank's band of the whole map flipped along H (``dim``)."""
    return _FlipBands.apply(x, context, dim)


def gather_h(x: torch.Tensor, context: DistContext, dim: int = 2,
             kind: str = "gather") -> torch.Tensor:
    """The whole map along H (``dim``) from the space ranks' bands, on every
    space rank, with the gradient summed over the space group, its bytes
    counted under ``EXCHANGED[kind]``."""
    whole = all_gather_parts(x, context.space_group, context.space_size, context.space_rank, dim)
    _tally(kind, whole)
    if whole.requires_grad:  # the backward reduces a buffer of the same size
        whole.register_hook(lambda grad: _tally(kind, grad))
    return whole


def band_slice(x: torch.Tensor, context: DistContext, dim: int = 2) -> torch.Tensor:
    """This rank's band of a whole map along ``dim``."""
    band = context.band(x.shape[dim])
    return x.narrow(dim, band.start, band.stop - band.start)
