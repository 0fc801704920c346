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
fp32 sum over all displacements (and lane blocks) rounded once, as the TPU
kernel's VJP returns ``dx.astype(x.dtype)``. A bf16 launch takes C <= 128 lanes
(zero-padded to 128 on the card); a wider C is tiled into 128-lane blocks, the
last one zero-padded when C is no multiple of 128 (``lane_tiled_fwd``,
``lane_tiled_bwd``), one launch per block pair.
The launch geometry comes from ``launch_plan`` and the scratch from
``bf16_scratch``, plain Python that the CPU tests check.

Dispatch: CUDA tensors go to the kernel (or the call raises), CPU tensors to
``displaced_joint_plain_flat``. ``LAUNCHES`` counts kernel launches by
(kernel, padding), one a wrapper call; a call on bf16 operands counts under
the name with ``BF16_OPERANDS`` appended. ``chip_smoke.py`` reads it to show
the training path ran through the kernels. Device kernels a call, at 128
lanes: fp32 operands 3 forward (conversion pass, product, chunk sum) and 2
backward (conversion of the source and g, product); bf16 operands 2 forward
(no conversion pass) and 2 backward (the pass converts g alone). A udaiic
step with two decoder taps makes 6 calls either way.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F

from . import build

KERNEL_SOURCE = "mi_joint"
FWD, BWD_DX_TF, BWD_DX = "mi_joint_fwd", "mi_joint_bwd_dx_tf", "mi_joint_bwd_dx"
BF16_OPERANDS = "_bf16in"  # suffix of the launches on bf16 operands
LAUNCHES: "collections.Counter[Tuple[str, int]]" = collections.Counter()

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
        lib.mi_joint_bwd_bf16in.argtypes = [vp, vp, vp, vp, vp, i, ll, i, i, i, i, i, i, vp]
        for fn in (lib.mi_joint_fwd_bf16, lib.mi_joint_bwd_bf16, lib.mi_joint_fwd_fp32,
                   lib.mi_joint_bwd_fp32, lib.mi_joint_fwd_bf16in, lib.mi_joint_bwd_bf16in):
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


def converts_rows(*operands: torch.Tensor) -> bool:
    """Whether a bf16 call's conversion pass copies the operand rows: always
    for fp32 operands; for bf16 ones unless they are rows of exactly 128
    lanes at 16-byte aligned addresses, which the kernels read in place."""
    return any(t.dtype != torch.bfloat16 or t.shape[-1] != LANES or t.data_ptr() % 16
               for t in operands)


def alloc_scratch(spec: ScratchSpec, device: torch.device) -> Dict[str, torch.Tensor]:
    return {name: torch.empty(shape, dtype=dtype, device=device)
            for name, (shape, dtype) in spec.items()}


def _lane_tiles(c: int) -> List[slice]:
    return [slice(i, min(i + LANES, c)) for i in range(0, c, LANES)]


def _lanes(x: torch.Tensor, *tiles: slice) -> torch.Tensor:
    """``x``'s block at ``tiles`` (one per trailing axis), zero-padded to 128
    on each and contiguous: the square 128-lane operands a launch takes."""
    x = x[(Ellipsis,) + tiles]
    widths = [LANES - (t.stop - t.start) for t in reversed(tiles)]
    return F.pad(x, [w for width in widths for w in (0, width)]) if any(widths) \
        else x.contiguous()


def lane_tiled_fwd(a: torch.Tensor, b: torch.Tensor,
                   fwd: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """J [D, C, C] of [N, C] operands of any width from a forward that takes
    128 lanes (``fwd(A_i, B_j)`` -> [D, 128, 128]): block (i, j) of J is fwd
    on the 128-lane blocks A_i, B_j, each copied contiguous once, a last
    partial block (C no multiple of 128) zero-padded to 128 lanes and its
    rows and columns of J dropped."""
    tiles = _lane_tiles(a.shape[1])
    a_t = [_lanes(a, t) for t in tiles]
    b_t = [_lanes(b, t) for t in tiles]
    w = [t.stop - t.start for t in tiles]
    return torch.cat([torch.cat([fwd(ai, bj)[:, :w[i], :w[j]] for j, bj in enumerate(b_t)],
                                dim=2) for i, ai in enumerate(a_t)], dim=1)


def lane_tiled_bwd(src: torch.Tensor, g: torch.Tensor,
                   bwd: Callable[[torch.Tensor, torch.Tensor, bool], torch.Tensor],
                   transpose_g: bool) -> torch.Tensor:
    """The backward products of ``mi_joint_bwd`` for any width from one that
    takes 128 lanes (``bwd(src_k, g_k, transpose_g)``, returning fp32):
      transpose_g=False (src = A): dx_tf_j = sum_i bwd(A_i, g_ij, False)
      transpose_g=True  (src = B): dx_i    = sum_j bwd(B_j, g_ij, True)
    with g_ij the (i, j) lane block of g [D, C, C]; a last partial block is
    zero-padded to 128 lanes (in src and g) and its padding dropped from the
    result. The block results are summed in fp32 and the result is cast to
    ``src``'s dtype once, so bf16 operands get a gradient rounded once, as
    at 128 lanes."""
    tiles = _lane_tiles(src.shape[1])
    src_t = [_lanes(src, t) for t in tiles]
    out = []
    for o in tiles:  # the output's lane block
        parts = [bwd(src_t[k], _lanes(g, o, t) if transpose_g else _lanes(g, t, o),
                     transpose_g) for k, t in enumerate(tiles)]
        out.append(functools.reduce(torch.add, parts)[:, :o.stop - o.start])
    return torch.cat(out, dim=1).to(src.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _check_modes(operand: torch.Tensor, bf16: bool) -> None:
    if operand.dtype == torch.bfloat16 and not bf16:
        raise TypeError("bf16 operands take the bf16 products (bf16=True); the fp32 mode "
                        "takes fp32 operands")


def mi_joint_fwd(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                 bf16: bool = True) -> torch.Tensor:
    """Kernel launch: J [D, C, C] fp32 from flat canvases a, b [N, C] (fp32,
    or bf16 with bf16 products); in bf16 one launch per pair of 128-lane
    blocks."""
    _check_operand(a, "a")
    _check_operand(b, "b", a.shape, (a.dtype,))
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    _check_modes(a, bf16)
    _check_geometry(wp, padding)
    if bf16 and a.shape[1] > LANES:
        return lane_tiled_fwd(a, b, lambda x, y: _launch_fwd(x, y, wp, padding, bf16))
    return _launch_fwd(a, b, wp, padding, bf16)


def _launch_fwd(a, b, wp, padding, bf16):
    n, c = a.shape
    d = (2 * padding + 1) ** 2
    lib = _library()
    with torch.cuda.device(a.device):
        sms = _sm_count(a.device.index)
        out = torch.empty((d, c, c), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
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


def _ptr(buf: Dict[str, torch.Tensor], name: str):
    """A scratch buffer's address, None (NULL) where the call has none."""
    return buf[name].data_ptr() if name in buf else None


def mi_joint_bwd(src: torch.Tensor, g: torch.Tensor, wp: int, padding: int,
                 transpose_g: bool, bf16: bool = True) -> torch.Tensor:
    """Kernel launch: out [N, C] in src's dtype (fp32, or bf16 with bf16
    products); in bf16 one launch per pair of 128-lane blocks, summed in fp32.
    g [D, C, C] is fp32 (the cotangent of J).

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
    if bf16 and c > LANES:
        return lane_tiled_bwd(
            src, g, lambda s, h, tr: _launch_bwd(s, h, wp, padding, tr, bf16, torch.float32),
            transpose_g)
    return _launch_bwd(src, g, wp, padding, transpose_g, bf16, src.dtype)


def _launch_bwd(src, g, wp, padding, transpose_g, bf16, out_dtype):
    n, c = src.shape
    lib = _library()
    with torch.cuda.device(src.device):
        out = torch.empty((n, c), dtype=out_dtype, device=src.device)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        if bf16:
            plan = launch_plan(n, c, padding, wp, _sm_count(src.device.index))
            buf = alloc_scratch(bf16_scratch(plan, backward=True, rows=converts_rows(src)),
                                src.device)
            geometry = (n, c, padding, wp, int(transpose_g), plan.bwd_stages, plan.bwd_smem,
                        stream)
            if src.dtype == torch.bfloat16:
                rc = lib.mi_joint_bwd_bf16in(src.data_ptr(), g.data_ptr(), _ptr(buf, "s16"),
                                             buf["h16"].data_ptr(), out.data_ptr(),
                                             int(out_dtype == torch.bfloat16), *geometry)
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


class _DisplacedJointCUDA(torch.autograd.Function):
    """The kernels' autograd: J fp32; the gradients in the operands' dtype."""

    @staticmethod
    def forward(ctx, a, b, wp, padding, bf16):
        ctx.save_for_backward(a, b)
        ctx.geometry = (wp, padding, bf16)
        return mi_joint_fwd(a, b, wp, padding, bf16)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        wp, padding, bf16 = ctx.geometry
        g = g.contiguous()
        da = db = None
        if ctx.needs_input_grad[0]:
            da = mi_joint_bwd(b, g, wp, padding, transpose_g=True, bf16=bf16)
        if ctx.needs_input_grad[1]:
            db = mi_joint_bwd(a, g, wp, padding, transpose_g=False, bf16=bf16)
        return da, db, None, None, None


def displaced_joint_flat(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                         dot_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[N, C] x2 -> [D, C, C]: the kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dot_dtype must be bfloat16 or float32, got {dot_dtype}")
    if a.is_cuda or b.is_cuda:
        return _DisplacedJointCUDA.apply(a, b, wp, padding, dot_dtype == torch.bfloat16)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return displaced_joint_plain_flat(a, b, wp, padding, dot_dtype)
    raise ValueError(f"unsupported devices {a.device}, {b.device}")


def displaced_joint(x: torch.Tensor, x_tf: torch.Tensor, padding: int,
                    dot_dtype: torch.dtype = torch.bfloat16,
                    pre_padded: bool = False) -> torch.Tensor:
    """[B, H, W, C] x2 -> [T, T, C, C] raw displaced correlation sums
    (``displaced_joint_pallas``). With ``pre_padded`` the maps already carry
    the zero border ([B, H+2p, W+2p, C]) and the flatten is a free reshape."""
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
