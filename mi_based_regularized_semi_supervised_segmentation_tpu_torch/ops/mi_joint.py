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
``torch.float32`` is the parity mode.

Dispatch: CUDA tensors go to the kernel (or the call raises), CPU tensors to
``displaced_joint_plain_flat``. ``LAUNCHES`` counts kernel launches by
(kernel, padding); ``chip_smoke.py`` reads it to show the training path ran
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build

KERNEL_SOURCE = "mi_joint"
FWD, BWD_DX_TF, BWD_DX = "mi_joint_fwd", "mi_joint_bwd_dx_tf", "mi_joint_bwd_dx"
LAUNCHES: "collections.Counter[Tuple[str, int]]" = collections.Counter()

_KT = 32    # rows per staged slice in the kernel (rows_per_chunk is a multiple)
_TILE = 128  # output tile edge in the kernel


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_count(name: str) -> int:
    return sum(v for (k, _), v in LAUNCHES.items() if k == name)


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
    operands and the cotangent are rounded as the kernel rounds them."""
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
        lib.mi_joint_fwd.argtypes = [vp, vp, vp, vp, ll, i, i, i, ll, i, i, vp]
        lib.mi_joint_fwd.restype = i
        lib.mi_joint_bwd.argtypes = [vp, vp, vp, ll, i, i, i, i, i, i, vp]
        lib.mi_joint_bwd.restype = i
        lib.mi_joint_error_string.argtypes = [i]
        lib.mi_joint_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().mi_joint_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check_operand(t: torch.Tensor, name: str, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _check_geometry(wp: int, padding: int) -> None:
    if padding < 0 or wp <= 2 * padding:
        raise ValueError(f"padding {padding} does not fit canvas width {wp}")


def fwd_chunking(n: int, c: int, padding: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_chunk, n_chunks) of the forward's split over rows: about 8
    blocks per SM, each chunk a multiple of the kernel's 32-row slice."""
    d = (2 * padding + 1) ** 2
    tiles = (-(-c // _TILE)) ** 2
    want = max(1, math.ceil(8 * sm_count / (d * tiles)))
    want = min(want, max(1, math.ceil(n / 256)), 65535)
    rows = -(-n // want)
    rows = -(-rows // _KT) * _KT
    return rows, -(-n // rows)


def mi_joint_fwd(a: torch.Tensor, b: torch.Tensor, wp: int, padding: int,
                 bf16: bool = True) -> torch.Tensor:
    """Kernel launch: J [D, C, C] fp32 from flat canvases a, b [N, C]."""
    _check_operand(a, "a")
    _check_operand(b, "b", a.shape)
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    n, c = a.shape
    _check_geometry(wp, padding)
    d = (2 * padding + 1) ** 2
    lib = _library()
    with torch.cuda.device(a.device):
        sms = torch.cuda.get_device_properties(a.device).multi_processor_count
        rows, chunks = fwd_chunking(n, c, padding, sms)
        partial = torch.empty((chunks, d, c, c), dtype=torch.float32, device=a.device)
        out = torch.empty((d, c, c), dtype=torch.float32, device=a.device)
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = lib.mi_joint_fwd(a.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
                              n, c, padding, wp, rows, chunks, int(bf16), stream)
    _check(rc, FWD)
    LAUNCHES[(FWD, padding)] += 1
    return out


def mi_joint_bwd(src: torch.Tensor, g: torch.Tensor, wp: int, padding: int,
                 transpose_g: bool, bf16: bool = True) -> torch.Tensor:
    """Kernel launch: out [N, C] fp32.

    transpose_g=False: dx_tf[n] = sum_d src[n + o_d] @ g[d]     (src = A)
    transpose_g=True:  dx[m]    = sum_d src[m - o_d] @ g[d]^T   (src = B)
    """
    _check_operand(src, "src")
    n, c = src.shape
    d = (2 * padding + 1) ** 2
    _check_operand(g, "g", (d, c, c))
    if src.device != g.device:
        raise ValueError(f"src on {src.device}, g on {g.device}")
    _check_geometry(wp, padding)
    lib = _library()
    with torch.cuda.device(src.device):
        out = torch.empty((n, c), dtype=torch.float32, device=src.device)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.mi_joint_bwd(src.data_ptr(), g.data_ptr(), out.data_ptr(), n, c, padding, wp,
                              -1 if transpose_g else 1, int(transpose_g), int(bf16), stream)
    name = BWD_DX if transpose_g else BWD_DX_TF
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


class _DisplacedJointCUDA(torch.autograd.Function):
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
