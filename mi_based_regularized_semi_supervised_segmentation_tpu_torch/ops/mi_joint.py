"""Displaced-MI joint: the CUDA kernel (``csrc/mi_joint.cu``), its wrappers and
its plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/mi_joint.py``
(``displaced_joint_pallas``). Inputs are [B, H, W, C] maps; each image is
zero-padded by p (or arrives pre-padded) and flattened row-major into an
[N, C] matrix, so a displacement (dy, dx) becomes the row offset
``o_d = (dy - p) * Wp + (dx - p)``; rows outside [0, N) read as zero:

    J[d, k1, k2] = sum_n A[n + o_d, k1] * B[n, k2]

The backward is two products of the same shape (see the kernel source).
``dot_dtype=torch.bfloat16`` rounds both operands (and, in the backward, the
incoming cotangent) to bf16 and accumulates in fp32, as the TPU kernel does;
``torch.float32`` is the parity mode. The operands are fp32, or bf16 when the
model computes in bf16 (``Precision.compute_dtype``; bf16 products only): J
is fp32 either way and the gradients come back in the operands' dtype, each
fp32 sum over all displacements (and K quarters) rounded once, as the TPU
kernel's VJP returns ``dx.astype(x.dtype)``.

The bf16 products take three shapes of launch, one launch a product each:
  * p > 0, C <= 128: rows zero-padded to 128 lanes on the card, geometry
    from ``launch_plan`` and scratch from ``bf16_scratch``;
  * p > 0, C > 128, and p = 0, C > 256: rows of W = 64 q lanes, q =
    ceil(C / 64) quarters (``wide_lanes``), zeros past C; the forward over
    the q^2 quarter tiles of J, the backward over 128-lane output blocks and
    the source's q quarters (``wide_plan``, ``wide_scratch``);
  * p = 0, C <= 256: J = A^T B, dx_tf = A g and dx = B g^T over all lanes,
    the operands converted inside the kernel (``gram_plan``).
The grouped call (``displaced_joint_pieces``) takes many canvases laid one
after another in one [rows, C] buffer (the tile pieces of
``ops/iic_local.py:_tiled_joints``), each with its own width and rows
outside it zero, and returns their joints [n_pieces, D, C, C]: one launch a
product for all of them (``pieces_plan``; C <= 128).
Every plan is plain Python that the CPU tests check.

Dispatch: CUDA tensors go to the kernel (or the call raises), CPU tensors to
``displaced_joint_plain_flat`` (the grouped call: its stack over the
pieces). ``LAUNCHES`` counts wrapper calls by (kernel, padding), one a call
at any C; a call on bf16 operands counts under the name with
``BF16_OPERANDS`` appended (under a CUDA graph, once a replay:
``ops/launches.py``). ``chip_smoke.py`` reads it to show the training
path ran through the kernels. Device kernels a call, at p > 0 (128 lanes or
wide rows): fp32 operands 3 forward (conversion pass, product, chunk sum)
and 2 backward (conversion of the source and g, product); bf16 operands
of exactly 128 (or W) lanes 2 forward (no conversion pass) and 2 backward
(the pass converts g alone); the grouped call 2 forward (conversion pass,
product writing J) and 2 backward; p = 0 up to 256 lanes, 2 forward
(product, chunk sum) and 1 backward. A udaiic step with two decoder taps
makes 6 calls at any head width; the pretrain decoder step 3.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build, launches

KERNEL_SOURCE = "mi_joint"
FWD, BWD_DX_TF, BWD_DX = "mi_joint_fwd", "mi_joint_bwd_dx_tf", "mi_joint_bwd_dx"
BF16_OPERANDS = "_bf16in"  # suffix of the launches on bf16 operands
LAUNCHES: "collections.Counter[Tuple[str, int]]" = launches.counter()

_KT = 32    # rows per staged slice of the fp32 kernel (rows_per_chunk is a multiple)
_TILE = 128  # output tile edge of the fp32 kernel

# the bf16 kernels' geometry (constants of csrc/mi_joint.cu)
LANES = 128            # C is zero-padded to this many lanes
BWD_TILE = 256         # joint_bwd: output rows per block
BWD_STAGE_LANES = 64   # joint_bwd: K lanes of g per pipeline stage
FWD_STAGE_ROWS = 64    # joint_fwd_partial: rows per pipeline stage
FWD_STAGES = 6
FWD_HALF = 64          # joint_fwd_partial: a block's J tile is 64 x 64
SMEM_LIMIT = 232_448   # dynamic shared memory a block may use on an H100
WIDE_QUARTER = 64       # the wide kernels' lane quarter: rows of 64 q lanes
# the p = 0 kernels (joint_gram_fwd / joint_gram_bwd)
GRAM_STAGE_ROWS = 32   # forward: rows per stage
GRAM_BUFS = 3          # forward: bf16 stage buffers
GRAM_MAX_LANES = 256   # C <= 256, computed as 128 or 256 lanes


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_count(name: str) -> int:
    return sum(v for (k, _), v in LAUNCHES.items() if k == name)


def kernel_name(base: str, dtype: torch.dtype) -> str:
    """The launch name of kernel ``base`` on operands of ``dtype``."""
    return base + BF16_OPERANDS if dtype == torch.bfloat16 else base


def _offsets(wp: int, padding: int):
    """Row offsets o_d + shift (all >= 0) of the (2p+1)^2 displacements."""
    t = 2 * padding + 1
    return [dy * wp + dx for dy in range(t) for dx in range(t)]


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

class _RoundGradBF16(torch.autograd.Function):
    """Identity whose backward rounds the cotangent to bf16 (the kernel's
    backward reads g as bf16 operands)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    """bf16-rounded values with a straight-through (fp32) gradient."""
    return x + (x.to(torch.bfloat16).to(x.dtype) - x).detach()


def displaced_joint_plain_flat(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                               dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, C] x2 -> [D, C, C]: one shifted-slice product per displacement, in
    fp32, with autograd giving the backward. With bf16 ``dot_dtype`` the
    operands and the cotangent are rounded as the kernel rounds them. bf16
    operands are taken exactly; their gradients are the fp32 sums over all
    displacements, rounded to bf16 once (at the upcast)."""
    n, _ = a.shape
    shift = padding * wp + padding
    bf16 = dot_dtype == torch.bfloat16
    a, b = a.float(), b.float()
    if bf16:
        a, b = _round_bf16(a), _round_bf16(b)
    a_pad = F.pad(a, (0, 0, shift, shift))  # a_pad[r] = a[r - shift], zero outside
    joint = torch.stack([a_pad[off:off + n].T @ b for off in _offsets(wp, padding)])
    return _RoundGradBF16.apply(joint) if bf16 else joint


def joint_bwd_plain_flat(src: torch.Tensor, g: torch.Tensor, wp: int, padding: int,
                         transpose_g: bool,
                         dot_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The backward products of ``displaced_joint_plain_flat`` written out
    (``mi_joint_bwd``'s function), [N, C] in src's dtype:
      transpose_g=False (src = A): dx_tf[n] = sum_d A[n + o_d] @ g[d]
      transpose_g=True  (src = B): dx[m]    = sum_d B[m - o_d] @ g[d]^T
    bf16 ``dot_dtype`` rounds src and g to bf16; the sums are fp32, cast to
    src's dtype once."""
    n, _ = src.shape
    shift = padding * wp + padding
    s, gg = src.float(), g.float()
    if dot_dtype == torch.bfloat16:
        s, gg = s.to(torch.bfloat16).float(), gg.to(torch.bfloat16).float()
    pad = F.pad(s, (0, 0, shift, shift))  # pad[r] = src[r - shift], zero outside
    out = torch.zeros_like(s)
    for d, off in enumerate(_offsets(wp, padding)):
        if transpose_g:
            out += pad[2 * shift - off:2 * shift - off + n] @ gg[d].T
        else:
            out += pad[off:off + n] @ gg[d]
    return out.to(src.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL_SOURCE)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.mi_joint_fwd_bf16.argtypes = [vp, vp, vp, vp, vp, vp, ll, i, i, i, ll, i, i, i, vp]
        lib.mi_joint_bwd_bf16.argtypes = [vp, vp, vp, vp, vp, ll, i, i, i, i, i, i, vp]
        lib.mi_joint_fwd_fp32.argtypes = [vp, vp, vp, vp, ll, i, i, i, ll, i, vp]
        lib.mi_joint_bwd_fp32.argtypes = [vp, vp, vp, ll, i, i, i, i, vp]
        lib.mi_joint_fwd_bf16in.argtypes = lib.mi_joint_fwd_bf16.argtypes
        lib.mi_joint_bwd_bf16in.argtypes = lib.mi_joint_bwd_bf16.argtypes
        lib.mi_joint_fwd_pieces.argtypes = [vp, vp, i, vp, vp, vp, i, vp, ll, i, i, i, i, vp]
        lib.mi_joint_bwd_pieces.argtypes = [vp, i, vp, vp, vp, vp, i, i, vp, ll, i, i, i, i, i,
                                            vp]
        lib.mi_joint_gram_fwd.argtypes = [vp, vp, i, vp, vp, ll, i, i, ll, i, i, vp]
        lib.mi_joint_gram_bwd.argtypes = [vp, i, vp, vp, ll, i, i, i, i, i, vp]
        lib.mi_joint_fwd_wide.argtypes = [vp, vp, i, vp, vp, vp, vp, ll, i, i, i, ll, i, i, i, vp]
        lib.mi_joint_bwd_wide.argtypes = [vp, i, vp, vp, vp, vp, ll, i, i, i, i, i, i, i, vp]
        for fn in (lib.mi_joint_fwd_bf16, lib.mi_joint_bwd_bf16, lib.mi_joint_fwd_fp32,
                   lib.mi_joint_bwd_fp32, lib.mi_joint_fwd_bf16in, lib.mi_joint_bwd_bf16in,
                   lib.mi_joint_fwd_pieces, lib.mi_joint_bwd_pieces, lib.mi_joint_gram_fwd,
                   lib.mi_joint_gram_bwd, lib.mi_joint_fwd_wide, lib.mi_joint_bwd_wide):
            fn.restype = i
        lib.mi_joint_error_string.argtypes = [i]
        lib.mi_joint_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().mi_joint_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


OPERAND_DTYPES = (torch.float32, torch.bfloat16)


def _check_operand(t: torch.Tensor, name: str, shape=None, dtypes=OPERAND_DTYPES) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_geometry(wp: int, padding: int) -> None:
    if padding < 0 or wp <= 2 * padding:
        raise ValueError(f"padding {padding} does not fit canvas width {wp}")


def fwd_chunking(n: int, c: int, padding: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_chunk, n_chunks) of the fp32 forward's (and the fused
    forward's) split over rows: about 8 blocks per SM, each chunk a multiple
    of the kernel's 32-row slice."""
    d = (2 * padding + 1) ** 2
    tiles = (-(-c // _TILE)) ** 2
    want = max(1, math.ceil(8 * sm_count / (d * tiles)))
    want = min(want, max(1, math.ceil(n / 256)), 65535)
    rows = -(-n // want)
    rows = -(-rows // _KT) * _KT
    return rows, -(-n // rows)


@dataclasses.dataclass(frozen=True)
class JointPlan:
    """Launch geometry of the bf16 kernels for one call shape: every number
    the wrapper hands the CUDA side, and the source row windows the kernels
    stage. A window is what the block's own rows need; its rows outside
    [0, N) are zero-filled in shared memory, never read."""
    n: int
    padding: int
    wp: int
    # joint_bwd: grid (bwd_blocks,), BWD_TILE output rows a block; per dy one
    # slab of bwd_slab_rows source rows (two buffers), then bwd_stages stages
    # of BWD_STAGE_LANES lanes of g
    bwd_blocks: int
    bwd_slab_rows: int
    bwd_stages: int
    bwd_smem: int
    # joint_fwd_partial: grid (4 * fwd_groups * taps, fwd_chunks); a block
    # takes one chunk of rows, one dy, fwd_dx_group displacements along x
    # (the largest of 7, 5, 3, 1 that divides 2p + 1) and a 64 x 64 quarter
    # of J, in FWD_STAGES stages of FWD_STAGE_ROWS rows
    fwd_dx_group: int
    fwd_groups: int
    fwd_rows_per_chunk: int
    fwd_chunks: int
    fwd_smem: int

    @property
    def taps(self) -> int:
        return 2 * self.padding + 1

    @property
    def bwd_grid(self) -> Tuple[int]:
        return (self.bwd_blocks,)

    @property
    def bwd_slabs(self) -> int:
        """Source slab buffers of joint_bwd: one a dy, double-buffered."""
        return 2

    @property
    def fwd_grid(self) -> Tuple[int, int]:
        return (4 * self.fwd_groups * self.taps, self.fwd_chunks)

    def bwd_out_rows(self, block: int) -> Tuple[int, int]:
        lo = block * BWD_TILE
        return lo, min(self.n, lo + BWD_TILE)

    def bwd_slab_window(self, block: int, dy: int) -> Tuple[int, int]:
        lo, hi = self.bwd_out_rows(block)
        shift = (dy - self.padding) * self.wp
        return lo + shift - self.padding, hi + shift + self.padding

    def fwd_chunk_rows(self, chunk: int) -> Tuple[int, int]:
        lo = chunk * self.fwd_rows_per_chunk
        return lo, min(self.n, lo + self.fwd_rows_per_chunk)

    def fwd_a_window(self, chunk: int, dy: int, group: int) -> Tuple[int, int]:
        """A rows that the chunk's stages read for (dy, group): B row r meets
        A row r + (dy - p) * wp + dx - p for each dx of the group."""
        lo, hi = self.fwd_chunk_rows(chunk)
        shift = (dy - self.padding) * self.wp + group * self.fwd_dx_group - self.padding
        return lo + shift, hi + shift + self.fwd_dx_group - 1


@functools.lru_cache(maxsize=64)
def launch_plan(n: int, c: int, padding: int, wp: int, sm_count: int) -> JointPlan:
    """The bf16 kernels' launch plan (see ``JointPlan``). The backward's ring
    has 6 stages, 4 in flight; 4 stages, 2 in flight, where 6 do not fit or
    where p = 0 (a dy has 2 steps there, and a slab buffer may be refilled
    only after the last step that read it). The forward's chunk count gives
    whole waves of blocks (a multiple of sm_count / gcd(blocks per chunk,
    sm_count)), at least 4 blocks per SM and at least 4 stages a chunk."""
    if not 1 <= c <= LANES:
        raise ValueError(f"the bf16 joint kernels take 1 to {LANES} lanes, got C = {c}")
    if n < 1:
        raise ValueError(f"no rows (N = {n})")
    _check_geometry(wp, padding)
    t = 2 * padding + 1
    slab_rows = BWD_TILE + 2 * padding
    smem = {s: 2 * slab_rows * LANES * 2 + s * LANES * BWD_STAGE_LANES * 2 for s in (6, 4)}
    fits = [s for s in (6, 4) if smem[s] <= SMEM_LIMIT and 2 * t >= s - 2]
    if not fits:
        raise ValueError(f"padding {padding} needs {smem[4]} bytes of shared memory "
                         f"(at most {SMEM_LIMIT})")
    stages = fits[0]
    group = next(g for g in (7, 5, 3, 1) if t % g == 0)
    groups = t // group
    stage = FWD_HALF * 2 * (2 * FWD_STAGE_ROWS + group - 1)  # B slice and A slab, bf16
    fwd_smem = FWD_STAGES * math.ceil(stage / 1024) * 1024   # stages 1024-byte aligned
    per_chunk = 4 * groups * t
    unit = sm_count // math.gcd(per_chunk, sm_count)
    want = unit * max(1, math.ceil(4 * sm_count / (per_chunk * unit)))
    chunks = max(1, min(want, math.ceil(n / (4 * FWD_STAGE_ROWS)), 65535))
    rows = math.ceil(math.ceil(n / chunks) / FWD_STAGE_ROWS) * FWD_STAGE_ROWS
    return JointPlan(n=n, padding=padding, wp=wp, bwd_blocks=math.ceil(n / BWD_TILE),
                     bwd_slab_rows=slab_rows, bwd_stages=stages, bwd_smem=smem[stages],
                     fwd_dx_group=group, fwd_groups=groups, fwd_rows_per_chunk=rows,
                     fwd_chunks=math.ceil(n / rows), fwd_smem=fwd_smem)


ScratchSpec = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def bf16_scratch(plan: JointPlan, backward: bool, rows: bool = True) -> ScratchSpec:
    """The scratch of one bf16 call, name -> (shape, dtype): the conversion
    pass's bf16 copies of the operands ([N, 128] each: two in the forward,
    the source in the backward; none with ``rows`` off, for bf16 operands of
    128 lanes that the kernels read in place), the backward's g as H
    [D, 128, 128] bf16 and the forward's chunk partials (fp32 J tiles). No
    [N, 128] fp32 buffer."""
    d = plan.taps ** 2
    copy = ((plan.n, LANES), torch.bfloat16)
    if backward:
        spec = {"s16": copy, "h16": ((d, LANES, LANES), torch.bfloat16)}
    else:
        spec = {"a16": copy, "b16": copy,
                "partial": ((plan.fwd_chunks, d, LANES, LANES), torch.float32)}
    return spec if rows else {k: v for k, v in spec.items() if k not in ("a16", "b16", "s16")}


def row_lanes(c: int) -> int:
    """Lanes of a row the bf16 kernels read for C live lanes: 128 up to 128
    lanes, else the wide kernels' W (``wide_lanes``)."""
    return LANES if c <= LANES else wide_lanes(c)


def converts_rows(*operands: torch.Tensor) -> bool:
    """Whether a bf16 call's conversion pass copies the operand rows: always
    for fp32 operands; for bf16 ones unless they are rows of exactly the
    lanes the kernels read (``row_lanes``: 128, or W = C for a multiple of
    64 above 128) at 16-byte aligned addresses, which they read in place."""
    return any(t.dtype != torch.bfloat16 or t.shape[-1] != row_lanes(t.shape[-1])
               or t.data_ptr() % 16 for t in operands)


def alloc_scratch(spec: ScratchSpec, device: torch.device) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """Launch geometry of the p = 0 kernels over all lanes (J = A^T B,
    dx_tf = A g, dx = B g^T) for one call shape: C <= 256 lanes computed as
    ``cp`` = 128 or 256 (zero-padded)."""
    n: int
    c: int
    cp: int
    # joint_gram_fwd: grid (fwd_slabs, fwd_chunks); block (slab, chunk) sums
    # its chunk's rows into partial[chunk, 128 slab:+128, :cp], in stages of
    # GRAM_STAGE_ROWS rows; joint_fwd_reduce sums the chunks
    fwd_slabs: int
    fwd_rows_per_chunk: int
    fwd_chunks: int
    fwd_smem: int
    # joint_gram_bwd: bwd_blocks persistent blocks over bwd_tiles tiles of
    # bwd_tile_rows rows, each block holding all of g as bf16
    bwd_tile_rows: int
    bwd_tiles: int
    bwd_blocks: int
    bwd_smem: int

    @property
    def fwd_grid(self) -> Tuple[int, int]:
        return (self.fwd_slabs, self.fwd_chunks)

    def fwd_chunk_rows(self, chunk: int) -> Tuple[int, int]:
        lo = chunk * self.fwd_rows_per_chunk
        return lo, min(self.n, lo + self.fwd_rows_per_chunk)

    def bwd_block_tiles(self, block: int) -> List[int]:
        return list(range(block, self.bwd_tiles, self.bwd_blocks))


@functools.lru_cache(maxsize=64)
def gram_plan(n: int, c: int, sm_count: int) -> GramPlan:
    """The p = 0 kernels' launch plan (see ``GramPlan``): the forward's
    chunks give one block per SM (``cp`` / 128 slab blocks a chunk), at
    least 4 stages a chunk; the backward one persistent block per SM."""
    if not 1 <= c <= GRAM_MAX_LANES:
        raise ValueError(f"the p = 0 kernels take 1 to {GRAM_MAX_LANES} lanes, got C = {c}")
    if n < 1:
        raise ValueError(f"no rows (N = {n})")
    cp = LANES if c <= LANES else GRAM_MAX_LANES
    slabs = cp // LANES
    want = max(1, sm_count // slabs)
    chunks = max(1, min(want, math.ceil(n / (4 * GRAM_STAGE_ROWS)), 65535))
    rows = math.ceil(math.ceil(n / chunks) / GRAM_STAGE_ROWS) * GRAM_STAGE_ROWS
    tile_rows = 128 if cp == LANES else 64
    tiles = math.ceil(n / tile_rows)
    h_bytes = (cp // LANES) * (cp // BWD_STAGE_LANES) * LANES * BWD_STAGE_LANES * 2
    return GramPlan(n=n, c=c, cp=cp, fwd_slabs=slabs, fwd_rows_per_chunk=rows,
                    fwd_chunks=math.ceil(n / rows),
                    fwd_smem=GRAM_BUFS * (2 + cp // 64) * GRAM_STAGE_ROWS * 64 * 2,
                    bwd_tile_rows=tile_rows, bwd_tiles=tiles, bwd_blocks=min(tiles, sm_count),
                    bwd_smem=h_bytes + tile_rows * cp * 2)


Pieces = Tuple[Tuple[int, int, int], ...]  # per piece: (first row, rows, canvas width)


@dataclasses.dataclass(frozen=True)
class PiecesPlan:
    """Launch geometry of the grouped kernels (``displaced_joint_pieces``):
    the pieces tile rows [0, total_rows) of the flat operands one after
    another. The forward's grid is (4 * fwd_groups * taps, n_pieces): a
    block takes one whole piece (one chunk: it writes its sums into J), one
    dy, fwd_dx_group displacements along x and a 64 x 64 quarter of J. The
    backward's bwd_blocks blocks are each piece's BWD_TILE-row tiles in
    turn, piece i's from first_block[i]. Stages and shared memory are
    ``launch_plan``'s."""
    pieces: Pieces
    padding: int
    total_rows: int
    first_block: Tuple[int, ...]
    bwd_blocks: int
    bwd_stages: int
    bwd_smem: int
    fwd_dx_group: int
    fwd_groups: int
    fwd_smem: int
    # the table on each device it was sent to (not part of the plan's value)
    tables: Dict[torch.device, torch.Tensor] = dataclasses.field(
        default_factory=dict, compare=False, hash=False, repr=False)

    @property
    def taps(self) -> int:
        return 2 * self.padding + 1

    def device_table(self, device: torch.device) -> torch.Tensor:
        """``table()`` as int64 [n_pieces, 4] on ``device``, sent once."""
        if device not in self.tables:
            self.tables[device] = torch.tensor(self.table(), dtype=torch.int64, device=device)
        return self.tables[device]

    @property
    def n_pieces(self) -> int:
        return len(self.pieces)

    @property
    def fwd_grid(self) -> Tuple[int, int]:
        return (4 * self.fwd_groups * self.taps, self.n_pieces)

    def table(self) -> List[Tuple[int, int, int, int]]:
        """The kernels' device table: per piece (first row, rows, wp, first
        backward block)."""
        return [piece + (fb,) for piece, fb in zip(self.pieces, self.first_block)]

    def bwd_block_rows(self, block: int) -> Tuple[int, int, int]:
        """(piece, first, last + 1 flat row) of backward block ``block``, as
        the kernel finds them: the last piece whose first block is at or
        before it."""
        i = bisect.bisect_right(self.first_block, block) - 1
        first, rows, _ = self.pieces[i]
        lo = first + (block - self.first_block[i]) * BWD_TILE
        return i, lo, min(first + rows, lo + BWD_TILE)


@functools.lru_cache(maxsize=64)
def pieces_plan(pieces: Pieces, c: int, padding: int, sm_count: int) -> PiecesPlan:
    """The grouped kernels' launch plan (see ``PiecesPlan``). The pieces
    must lie one after another from row 0, each with at least one row."""
    if not pieces:
        raise ValueError("no pieces")
    at = 0
    for first, rows, wp in pieces:
        if first != at or rows < 1:
            raise ValueError(f"piece ({first}, {rows}, {wp}) does not follow row {at}")
        _check_geometry(wp, padding)
        at += rows
    base = launch_plan(pieces[0][1], c, padding, pieces[0][2], sm_count)
    blocks = [math.ceil(rows / BWD_TILE) for _, rows, _ in pieces]
    first_block = tuple(int(x) for x in np.cumsum([0] + blocks[:-1]))
    return PiecesPlan(pieces=pieces, padding=padding, total_rows=at, first_block=first_block,
                      bwd_blocks=sum(blocks), bwd_stages=base.bwd_stages,
                      bwd_smem=base.bwd_smem, fwd_dx_group=base.fwd_dx_group,
                      fwd_groups=base.fwd_groups, fwd_smem=base.fwd_smem)


def wide_lanes(c: int) -> int:
    """W: the lanes of a wide row for C live lanes, q = ceil(C / 64) quarters
    of 64 lanes, at least 2 (zeros past C)."""
    return WIDE_QUARTER * max(2, math.ceil(c / WIDE_QUARTER))


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Launch geometry of the wide kernels (``csrc/joint_core.cuh``:
    joint_fwd_wide, joint_bwd_wide) for one call shape: rows of ``lanes`` =
    W = 64 q lanes for C live lanes. The forward's grid is (q^2 * fwd_groups
    * taps, fwd_chunks): a block takes one chunk of rows, one quarter tile
    (k1 quarter, k2 quarter) of J, one dy and fwd_dx_group displacements
    along x, as ``launch_plan``'s block takes a quarter of a 128-lane J. The
    backward's grid is (bwd_row_blocks, bwd_out_blocks): BWD_TILE output rows
    and 128 output lanes a block (64 in a last block of one quarter,
    ``bwd_block_lanes``), its K loop over the taps^2 displacements
    and the source's q quarters (``bwd_steps``), each (dy, quarter) slab of
    the source staged once in a ring of bwd_slabs buffers, H in bwd_stages
    stages of BWD_STAGE_LANES lanes."""
    n: int
    c: int
    padding: int
    wp: int
    lanes: int
    fwd_dx_group: int
    fwd_groups: int
    fwd_rows_per_chunk: int
    fwd_chunks: int
    fwd_smem: int
    bwd_row_blocks: int
    bwd_out_blocks: int
    bwd_slabs: int
    bwd_stages: int
    bwd_smem: int

    @property
    def taps(self) -> int:
        return 2 * self.padding + 1

    @property
    def quarters(self) -> int:
        """q: the 64-lane quarters of a row, the backward's K stages a
        displacement; the forward computes q^2 quarter tiles of J."""
        return self.lanes // WIDE_QUARTER

    @property
    def fwd_grid(self) -> Tuple[int, int]:
        return (self.quarters ** 2 * self.fwd_groups * self.taps, self.fwd_chunks)

    @property
    def bwd_grid(self) -> Tuple[int, int]:
        return (self.bwd_row_blocks, self.bwd_out_blocks)

    @property
    def bwd_slab_rows(self) -> int:
        return BWD_TILE + 2 * self.padding

    def fwd_block(self, bx: int) -> Tuple[int, int, int, int]:
        """(k1 quarter, k2 quarter, dy, first dx) of forward block column
        ``bx``, as the kernel decodes blockIdx.x."""
        tiles = self.quarters ** 2
        tile, rest = bx % tiles, bx // tiles
        return (tile // self.quarters, tile % self.quarters, rest // self.fwd_groups,
                rest % self.fwd_groups * self.fwd_dx_group)

    def fwd_chunk_rows(self, chunk: int) -> Tuple[int, int]:
        lo = chunk * self.fwd_rows_per_chunk
        return lo, min(self.n, lo + self.fwd_rows_per_chunk)

    def bwd_out_rows(self, block: int) -> Tuple[int, int]:
        lo = block * BWD_TILE
        return lo, min(self.n, lo + BWD_TILE)

    def bwd_out_lanes(self, block: int) -> Tuple[int, int]:
        """The lanes [lo, hi) of J's C that output block ``block`` writes."""
        lo = block * LANES
        return lo, min(self.c, lo + LANES)

    def bwd_block_lanes(self, block: int) -> int:
        """The lanes output block ``block`` computes: 128 (its m64n128
        accumulators), or 64 where it holds the row's last quarter alone."""
        return WIDE_QUARTER if self.lanes - block * LANES <= WIDE_QUARTER else LANES

    def bwd_steps(self) -> List[Tuple[int, int, int]]:
        """A backward block's K loop, in order: (dy, source quarter, dx)."""
        return [(dy, kc, dx) for dy in range(self.taps) for kc in range(self.quarters)
                for dx in range(self.taps)]

    def bwd_slab_window(self, block: int, dy: int) -> Tuple[int, int]:
        lo, hi = self.bwd_out_rows(block)
        shift = (dy - self.padding) * self.wp
        return lo + shift - self.padding, hi + shift + self.padding


def _wide_chunks(per_chunk: int, n: int, sm_count: int) -> int:
    """The forward's chunk count: at least 4 blocks per SM; of the counts up
    to twice that, the first whose blocks fill their last wave to 95% (else
    the fullest), and at least 4 stages a chunk."""
    least = max(1, math.ceil(4 * sm_count / per_chunk))
    fill = lambda k: per_chunk * k / (math.ceil(per_chunk * k / sm_count) * sm_count)
    counts = range(least, 2 * least + 1)
    chunks = next((k for k in counts if fill(k) >= 0.95), max(counts, key=lambda k: (fill(k), -k)))
    return max(1, min(chunks, math.ceil(n / (4 * FWD_STAGE_ROWS)), 65535))


@functools.lru_cache(maxsize=64)
def wide_plan(n: int, c: int, padding: int, wp: int, sm_count: int) -> WidePlan:
    """The wide kernels' launch plan (see ``WidePlan``). The backward's ring
    takes 6 stages (4 in flight), or 4 where 6 do not fit, and as many slab
    buffers as it needs: a buffer is refilled bwd_stages - 2 steps ahead of
    its slab's first step, after the taps steps of each slab between."""
    if c < 1:
        raise ValueError(f"no lanes (C = {c})")
    if n < 1:
        raise ValueError(f"no rows (N = {n})")
    _check_geometry(wp, padding)
    t = 2 * padding + 1
    lanes = wide_lanes(c)
    slab = (BWD_TILE + 2 * padding) * WIDE_QUARTER * 2
    slabs = {s: max(2, math.ceil((s - 2) / t) + 1) for s in (6, 4)}
    smem = {s: s * LANES * BWD_STAGE_LANES * 2 + k * slab for s, k in slabs.items()}
    fits = [s for s in (6, 4) if smem[s] <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"padding {padding} needs {smem[4]} bytes of shared memory "
                         f"(at most {SMEM_LIMIT})")
    stages = fits[0]
    group = next(g for g in (7, 5, 3, 1) if t % g == 0)
    stage = FWD_HALF * 2 * (2 * FWD_STAGE_ROWS + group - 1)
    per_chunk = (lanes // WIDE_QUARTER) ** 2 * (t // group) * t
    chunks = _wide_chunks(per_chunk, n, sm_count)
    rows = math.ceil(math.ceil(n / chunks) / FWD_STAGE_ROWS) * FWD_STAGE_ROWS
    return WidePlan(n=n, c=c, padding=padding, wp=wp, lanes=lanes, fwd_dx_group=group,
                    fwd_groups=t // group, fwd_rows_per_chunk=rows,
                    fwd_chunks=math.ceil(n / rows),
                    fwd_smem=FWD_STAGES * math.ceil(stage / 1024) * 1024,
                    bwd_row_blocks=math.ceil(n / BWD_TILE), bwd_out_blocks=math.ceil(c / LANES),
                    bwd_slabs=slabs[stages], bwd_stages=stages, bwd_smem=smem[stages])


def wide_scratch(plan: WidePlan, backward: bool, rows: bool = True) -> ScratchSpec:
    """The scratch of one wide call, name -> (shape, dtype): the operands'
    bf16 rows [N, W] (two in the forward, the source in the backward; none
    with ``rows`` off: bf16 rows of W lanes read in place), the backward's g
    as H [out blocks, D, 128, W] bf16 and the forward's chunk partials
    [chunks, D, W, W] fp32."""
    d = plan.taps ** 2
    copy = ((plan.n, plan.lanes), torch.bfloat16)
    if backward:
        spec = {"s16": copy,
                "h16": ((plan.bwd_out_blocks, d, LANES, plan.lanes), torch.bfloat16)}
    else:
        spec = {"a16": copy, "b16": copy,
                "partial": ((plan.fwd_chunks, d, plan.lanes, plan.lanes), torch.float32)}
    return spec if rows else {k: v for k, v in spec.items() if k not in ("a16", "b16", "s16")}


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


# A call's host work all comes before its one launch, so it counts in the
# call's time wherever the card waits on it: the current stream is read raw
# (no Stream object), and the device is made current only where it is not.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: torch.device) -> int:
    """The current stream of ``device``, as the cudaStream_t a launch takes."""
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _on(device: torch.device):
    """``device`` made current for a raw launch (nothing where it is)."""
    if torch.cuda.current_device() == device.index:
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def _check_modes(operand: torch.Tensor, bf16: bool) -> None:
    if operand.dtype == torch.bfloat16 and not bf16:
        raise TypeError("bf16 operands take the bf16 products (bf16=True); the fp32 mode "
                        "takes fp32 operands")


def _whole_width(padding: int, c: int, bf16: bool) -> bool:
    """Whether a call takes the p = 0 kernels over all lanes."""
    return bf16 and padding == 0 and c <= GRAM_MAX_LANES


def mi_joint_fwd(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                 bf16: bool = True) -> torch.Tensor:
    """Kernel launch: J [D, C, C] fp32 from flat canvases a, b [N, C] (fp32,
    or bf16 with bf16 products); in bf16 at p = 0 over all lanes (C <= 256),
    above 128 lanes on the wide kernels."""
    _check_operand(a, "a")
    _check_operand(b, "b", a.shape, (a.dtype,))
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    _check_modes(a, bf16)
    _check_geometry(wp, padding)
    if _whole_width(padding, a.shape[1], bf16):
        return _launch_gram_fwd(a, b)
    if bf16 and a.shape[1] > LANES:
        return _launch_fwd_wide(a, b, wp, padding)
    return _launch_fwd(a, b, wp, padding, bf16)


def _launch_gram_fwd(a, b):
    n, c = a.shape
    with _on(a.device):
        plan = gram_plan(n, c, _sm_count(a.device.index))
        partial = torch.empty((plan.fwd_chunks, plan.cp, plan.cp), dtype=torch.float32,
                              device=a.device)
        out = torch.empty((1, c, c), dtype=torch.float32, device=a.device)
        rc = _library().mi_joint_gram_fwd(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16), partial.data_ptr(),
            out.data_ptr(), n, c, plan.cp, plan.fwd_rows_per_chunk, plan.fwd_chunks,
            plan.fwd_smem, _stream(a.device))
    name = kernel_name(FWD, a.dtype)
    _check(rc, name)
    LAUNCHES[(name, 0)] += 1
    return out


def _launch_gram_bwd(src, g, transpose_g):
    n, c = src.shape
    with _on(src.device):
        plan = gram_plan(n, c, _sm_count(src.device.index))
        out = torch.empty((n, c), dtype=src.dtype, device=src.device)
        rc = _library().mi_joint_gram_bwd(
            src.data_ptr(), int(src.dtype == torch.bfloat16), g.data_ptr(), out.data_ptr(), n, c,
            plan.cp, int(transpose_g), plan.bwd_blocks, plan.bwd_smem,
            _stream(src.device))
    name = kernel_name(BWD_DX if transpose_g else BWD_DX_TF, src.dtype)
    _check(rc, name)
    LAUNCHES[(name, 0)] += 1
    return out


def _launch_fwd(a, b, wp, padding, bf16):
    n, c = a.shape
    d = (2 * padding + 1) ** 2
    lib = _library()
    with _on(a.device):
        sms = _sm_count(a.device.index)
        out = torch.empty((d, c, c), dtype=torch.float32, device=a.device)
        stream = _stream(a.device)
        if bf16:
            plan = launch_plan(n, c, padding, wp, sms)
            buf = alloc_scratch(bf16_scratch(plan, backward=False, rows=converts_rows(a, b)),
                                a.device)
            fn = lib.mi_joint_fwd_bf16in if a.dtype == torch.bfloat16 else lib.mi_joint_fwd_bf16
            rc = fn(a.data_ptr(), b.data_ptr(), _ptr(buf, "a16"), _ptr(buf, "b16"),
                    buf["partial"].data_ptr(), out.data_ptr(), n, c, padding, wp,
                    plan.fwd_rows_per_chunk, plan.fwd_chunks, plan.fwd_dx_group, plan.fwd_smem,
                    stream)
        else:
            rows, chunks = fwd_chunking(n, c, padding, sms)
            partial = torch.empty((chunks, d, c, c), dtype=torch.float32, device=a.device)
            rc = lib.mi_joint_fwd_fp32(a.data_ptr(), b.data_ptr(), partial.data_ptr(),
                                       out.data_ptr(), n, c, padding, wp, rows, chunks, stream)
    name = kernel_name(FWD, a.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def _launch_fwd_wide(a, b, wp, padding):
    n, c = a.shape
    d = (2 * padding + 1) ** 2
    with _on(a.device):
        plan = wide_plan(n, c, padding, wp, _sm_count(a.device.index))
        buf = alloc_scratch(wide_scratch(plan, backward=False, rows=converts_rows(a, b)),
                            a.device)
        out = torch.empty((d, c, c), dtype=torch.float32, device=a.device)
        rc = _library().mi_joint_fwd_wide(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16), _ptr(buf, "a16"),
            _ptr(buf, "b16"), buf["partial"].data_ptr(), out.data_ptr(), n, c, padding, wp,
            plan.fwd_rows_per_chunk, plan.fwd_chunks, plan.fwd_dx_group, plan.fwd_smem,
            _stream(a.device))
    name = kernel_name(FWD, a.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def _ptr(buf: Dict[str, torch.Tensor], name: str):
    """A scratch buffer's address, None (NULL) where the call has none."""
    return buf[name].data_ptr() if name in buf else None


def mi_joint_bwd(src: torch.Tensor, g: torch.Tensor, wp: int, padding: int,
                 transpose_g: bool, bf16: bool = True) -> torch.Tensor:
    """Kernel launch: out [N, C] in src's dtype (fp32, or bf16 with bf16
    products: each fp32 sum rounded once); above 128 lanes in bf16 on the
    wide kernels. g [D, C, C] is fp32 (the cotangent of J).

    transpose_g=False: dx_tf[n] = sum_d src[n + o_d] @ g[d]     (src = A)
    transpose_g=True:  dx[m]    = sum_d src[m - o_d] @ g[d]^T   (src = B)
    """
    _check_operand(src, "src")
    n, c = src.shape
    d = (2 * padding + 1) ** 2
    _check_operand(g, "g", (d, c, c), (torch.float32,))
    if src.device != g.device:
        raise ValueError(f"src on {src.device}, g on {g.device}")
    _check_modes(src, bf16)
    _check_geometry(wp, padding)
    if _whole_width(padding, c, bf16):
        return _launch_gram_bwd(src, g, transpose_g)
    if bf16 and c > LANES:
        return _launch_bwd_wide(src, g, wp, padding, transpose_g)
    return _launch_bwd(src, g, wp, padding, transpose_g, bf16)


def _launch_bwd_wide(src, g, wp, padding, transpose_g):
    n, c = src.shape
    with _on(src.device):
        plan = wide_plan(n, c, padding, wp, _sm_count(src.device.index))
        buf = alloc_scratch(wide_scratch(plan, backward=True, rows=converts_rows(src)),
                            src.device)
        out = torch.empty((n, c), dtype=src.dtype, device=src.device)
        rc = _library().mi_joint_bwd_wide(
            src.data_ptr(), int(src.dtype == torch.bfloat16), g.data_ptr(), _ptr(buf, "s16"),
            buf["h16"].data_ptr(), out.data_ptr(), n, c, padding, wp, int(transpose_g),
            plan.bwd_stages, plan.bwd_slabs, plan.bwd_smem, _stream(src.device))
    name = kernel_name(BWD_DX if transpose_g else BWD_DX_TF, src.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def _launch_bwd(src, g, wp, padding, transpose_g, bf16):
    n, c = src.shape
    lib = _library()
    with _on(src.device):
        out = torch.empty((n, c), dtype=src.dtype, device=src.device)
        stream = _stream(src.device)
        if bf16:
            plan = launch_plan(n, c, padding, wp, _sm_count(src.device.index))
            buf = alloc_scratch(bf16_scratch(plan, backward=True, rows=converts_rows(src)),
                                src.device)
            geometry = (n, c, padding, wp, int(transpose_g), plan.bwd_stages, plan.bwd_smem,
                        stream)
            if src.dtype == torch.bfloat16:
                rc = lib.mi_joint_bwd_bf16in(src.data_ptr(), g.data_ptr(), _ptr(buf, "s16"),
                                             buf["h16"].data_ptr(), out.data_ptr(), *geometry)
            else:
                rc = lib.mi_joint_bwd_bf16(src.data_ptr(), g.data_ptr(), buf["s16"].data_ptr(),
                                           buf["h16"].data_ptr(), out.data_ptr(), *geometry)
        else:
            rc = lib.mi_joint_bwd_fp32(src.data_ptr(), g.data_ptr(), out.data_ptr(), n, c,
                                       padding, wp, int(transpose_g), stream)
    name = kernel_name(BWD_DX if transpose_g else BWD_DX_TF, src.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


class _Joint(torch.autograd.Function):
    """J = fwd(a, b) with the backward products bwd(src, g, transpose_g):
    the kernels' wrappers, or (on the CPU, in the tests) their plain
    stand-ins. J is fp32; the gradients come in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        ctx.save_for_backward(a, b)
        ctx.bwd = bwd
        return fwd(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = ctx.bwd(b, g, True) if ctx.needs_input_grad[0] else None
        db = ctx.bwd(a, g, False) if ctx.needs_input_grad[1] else None
        return da, db, None, None


def _check_dot(dot_dtype: torch.dtype) -> None:
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dot_dtype must be bfloat16 or float32, got {dot_dtype}")


def displaced_joint_flat(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                         dot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, C] x2 -> [D, C, C]: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    _check_dot(dot_dtype)
    if a.is_cuda or b.is_cuda:
        bf16 = dot_dtype == torch.bfloat16
        return _Joint.apply(a, b, lambda x, y: mi_joint_fwd(x, y, wp, padding, bf16),
                            lambda s, g, tr: mi_joint_bwd(s, g, wp, padding, tr, bf16))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return displaced_joint_plain_flat(a, b, wp, padding, dot_dtype)
    raise ValueError(f"unsupported devices {a.device}, {b.device}")


# ---------------------------------------------------------------------------
# the grouped joint: many canvases, one launch a product
# ---------------------------------------------------------------------------

def _piece_rows(t: torch.Tensor, pieces: Pieces) -> List[torch.Tensor]:
    return [t[first:first + rows] for first, rows, _ in pieces]


def pieces_fwd_plain(a: torch.Tensor, b: torch.Tensor, pieces: Pieces, padding: int,
                     dot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The grouped forward's function: [n_pieces, D, C, C], each piece's
    ``displaced_joint_plain_flat`` on its rows."""
    return torch.stack([displaced_joint_plain_flat(x, y, wp, padding, dot_dtype)
                        for x, y, (_, _, wp) in zip(_piece_rows(a, pieces),
                                                    _piece_rows(b, pieces), pieces)])


def pieces_bwd_plain(src: torch.Tensor, g: torch.Tensor, pieces: Pieces, padding: int,
                     transpose_g: bool, dot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The grouped backward's function: [rows, C], each piece's
    ``joint_bwd_plain_flat`` on its rows and its g."""
    return torch.cat([joint_bwd_plain_flat(x, g[i], wp, padding, transpose_g, dot_dtype)
                      for i, (x, (_, _, wp)) in enumerate(zip(_piece_rows(src, pieces), pieces))])


def _pieces_plan_for(a: torch.Tensor, pieces: Pieces, padding: int) -> PiecesPlan:
    """The grouped call's plan for operands ``a`` [rows, C], which the
    pieces must cover."""
    if not a.shape[1] <= LANES:
        raise ValueError(f"the grouped kernels take 1 to {LANES} lanes, got C = {a.shape[1]}")
    plan = pieces_plan(pieces, a.shape[1], padding, _sm_count(a.device.index))
    if plan.total_rows != a.shape[0]:
        raise ValueError(f"the pieces cover {plan.total_rows} rows of {a.shape[0]}")
    return plan


def mi_joint_fwd_pieces(a: torch.Tensor, b: torch.Tensor, pieces: Pieces,
                        padding: int) -> torch.Tensor:
    """Kernel launch: J [n_pieces, D, C, C] fp32 of the pieces of flat
    canvases a, b [rows, C] (fp32 or bf16; bf16 products, C <= 128), one
    launch for all of them."""
    _check_operand(a, "a")
    _check_operand(b, "b", a.shape, (a.dtype,))
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    plan = _pieces_plan_for(a, pieces, padding)
    n, c = a.shape
    d = (2 * padding + 1) ** 2
    with _on(a.device):
        copies = converts_rows(a, b)
        buf = alloc_scratch({k: ((n, LANES), torch.bfloat16) for k in ("a16", "b16")}
                            if copies else {}, a.device)
        out = torch.empty((plan.n_pieces, d, c, c), dtype=torch.float32, device=a.device)
        rc = _library().mi_joint_fwd_pieces(
            a.data_ptr(), b.data_ptr(), int(a.dtype == torch.bfloat16), _ptr(buf, "a16"),
            _ptr(buf, "b16"), plan.device_table(a.device).data_ptr(), plan.n_pieces,
            out.data_ptr(), n, c, padding, plan.fwd_dx_group, plan.fwd_smem,
            _stream(a.device))
    name = kernel_name(FWD, a.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def mi_joint_bwd_pieces(src: torch.Tensor, g: torch.Tensor, pieces: Pieces, padding: int,
                        transpose_g: bool) -> torch.Tensor:
    """Kernel launch: the grouped backward product [rows, C] in src's dtype
    from src [rows, C] and g [n_pieces, D, C, C] fp32 (``mi_joint_bwd`` of
    each piece with its g), one launch for all pieces."""
    _check_operand(src, "src")
    n, c = src.shape
    d = (2 * padding + 1) ** 2
    _check_operand(g, "g", (len(pieces), d, c, c), (torch.float32,))
    if src.device != g.device:
        raise ValueError(f"src on {src.device}, g on {g.device}")
    plan = _pieces_plan_for(src, pieces, padding)
    with _on(src.device):
        spec = {"h16": ((plan.n_pieces, d, LANES, LANES), torch.bfloat16)}
        if converts_rows(src):
            spec["s16"] = ((n, LANES), torch.bfloat16)
        buf = alloc_scratch(spec, src.device)
        out = torch.empty((n, c), dtype=src.dtype, device=src.device)
        rc = _library().mi_joint_bwd_pieces(
            src.data_ptr(), int(src.dtype == torch.bfloat16), g.data_ptr(), _ptr(buf, "s16"),
            buf["h16"].data_ptr(), plan.device_table(src.device).data_ptr(), plan.n_pieces,
            plan.bwd_blocks, out.data_ptr(), n, c, padding, int(transpose_g), plan.bwd_stages,
            plan.bwd_smem, _stream(src.device))
    name = kernel_name(BWD_DX if transpose_g else BWD_DX_TF, src.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def pieces_joint(a: torch.Tensor, b: torch.Tensor, fwd: Callable, bwd: Callable) -> torch.Tensor:
    """The grouped call's autograd over the forward ``fwd(a, b)`` and the
    backward products ``bwd(src, g, transpose_g)``: the kernels, or their
    plain stand-ins (``pieces_fwd_plain``, ``pieces_bwd_plain``)."""
    return _Joint.apply(a, b, fwd, bwd)


def displaced_joint_pieces(a: torch.Tensor, b: torch.Tensor, pieces: Pieces, padding: int,
                           dot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[rows, C] x2 -> [n_pieces, D, C, C]: the joint of each piece (first
    row, rows, canvas width) of the flat canvases, its rows outside the
    piece zero. CUDA tensors: the grouped kernels (bf16 products, C <= 128),
    one launch a product; CPU tensors: the stack of each piece's plain
    version."""
    _check_dot(dot_dtype)
    if a.is_cuda or b.is_cuda:
        if dot_dtype != torch.bfloat16:
            raise ValueError("the grouped kernels compute bf16 products only")
        return pieces_joint(a, b, lambda x, y: mi_joint_fwd_pieces(x, y, pieces, padding),
                            lambda s, g, tr: mi_joint_bwd_pieces(s, g, pieces, padding, tr))
    if a.device.type == "cpu" and b.device.type == "cpu":
        return pieces_fwd_plain(a, b, pieces, padding, dot_dtype)
    raise ValueError(f"unsupported devices {a.device}, {b.device}")


def displaced_joint(x: torch.Tensor, x_tf: torch.Tensor, padding: int,
                    dot_dtype: torch.dtype = torch.bfloat16,
                    pre_padded: bool = False) -> torch.Tensor:
    """[B, H, W, C] x2 -> [T, T, C, C] raw displaced correlation sums
    (``displaced_joint_pallas``). With ``pre_padded`` the maps already carry
    the zero border ([B, H+2p, W+2p, C]) and the flatten is a free reshape.
    The kernels read x's border rows as they stand: only x is shifted, and
    x_tf's border is zero, so a row of x's border enters J where it lies
    within p of x_tf's interior. Under the spatial H split x is a band's
    canvas, or a tile's piece of it, whose border rows hold the rows of the
    map around it (a halo of p rows, ``engine/steps.py:iic_regularization``,
    ``ops/iic_local.py:_tiled_joints``): the kernel reads them like any row,
    and the bands' joints sum to the whole map's. Nothing in the kernels
    changes for it."""
    if x.shape != x_tf.shape or x.dim() != 4:
        raise ValueError(f"expected two equal [B, H, W, C] shapes, got {x.shape}, {x_tf.shape}")
    p = padding
    if not pre_padded:
        x = F.pad(x, (0, 0, p, p, p, p))
        x_tf = F.pad(x_tf, (0, 0, p, p, p, p))
    _, _, wp, c = x.shape
    t = 2 * p + 1
    joint = displaced_joint_flat(x.reshape(-1, c), x_tf.reshape(-1, c), wp, p, dot_dtype)
    return joint.reshape(t, t, c, c)
