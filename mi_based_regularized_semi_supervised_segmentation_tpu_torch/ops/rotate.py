"""Per-sample nearest rotation by three integer shears: the CUDA kernels
(``csrc/rotate.cu``), their wrappers and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/rotate.py``. Each [B, H, W]
float image is rotated about its centre by its own angle (degrees), on its own
canvas, with zero fill, as

    R(theta) = shear_x(-tan(theta/2)) . shear_y(sin(theta)) . shear_x(-tan(theta/2))

Each shear rounds to integer shifts and rolls the rows (or columns) of a
zero canvas padded so that no roll wraps real content, so the result is a
pixel permutation: exact for integer-valued inputs such as labels.

- ``rotate_shear`` (``rotate_shear_pallas``): one kernel launch that derives
  the shifts from the angles and inverts the three rolls per output pixel,
  for the images and, given, their int32 labels together. Its canvas is
  ``Hc = round_up(H + 2py, 8)`` by ``Wc = round_up(W + 2px, 128)``.
- ``lane_roll_rows`` (``_lane_roll_rows``): ``out[b, r, c] = x[b, r, (c - s[b, r]) mod Wc]``.
- ``rotate_shear_lanes`` (``rotate_shear_pallas_lanes``): three
  ``lane_roll_rows`` with two transposes, on a canvas with both sides rounded
  to 128. Its output equals ``rotate_shear``'s.

Rolls follow ``torch.roll`` / ``jnp.roll``: a roll by s moves element i to
i + s. Dispatch: CUDA tensors go to the kernel (or the call raises), CPU
tensors to the plain version. ``LAUNCHES`` counts kernel launches by (name,
batch size), under a CUDA graph once a replay (``ops/launches.py``).
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import build, launches

KERNEL_SOURCE = "rotate"
ROTATE, ROLL = "rotate_shear", "lane_roll_rows"
LAUNCHES: "collections.Counter[Tuple[str, int]]" = launches.counter()
LANE, SUBLANE = 128, 8

# (s_x [B, Hc] int32, s_y [B, Wc] int32, (py, px, Hc, Wc))
Tables = Tuple[torch.Tensor, torch.Tensor, Tuple[int, int, int, int]]


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_count(name: str) -> int:
    return sum(v for (k, _), v in LAUNCHES.items() if k == name)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=64)
def canvas(h: int, w: int, max_angle: float, lane_aligned_rows: bool) -> Tuple[int, int, int, int]:
    """Static (py, px, Hc, Wc): stage 1 reaches x + tan(theta/2) y, stages 2
    and 3 the final rotated coordinates; the alignment padding goes to the far
    side, so the content stays centred at (py + (H-1)/2, px + (W-1)/2).
    Cached: a kernel call would otherwise spend more host time here than the
    card spends rotating."""
    tm = math.radians(float(max_angle))
    cy0, cx0 = (h - 1) / 2.0, (w - 1) / 2.0
    grid = [tm * i / 32.0 for i in range(33)]
    x_half = max(cx0 + math.tan(tm / 2.0) * cy0,
                 max(cx0 * math.cos(a) + cy0 * math.sin(a) for a in grid))
    y_half = max(cx0 * math.sin(a) + cy0 * math.cos(a) for a in grid)
    px = int(math.ceil(x_half - cx0)) + 2
    py = int(math.ceil(y_half - cy0)) + 2
    hc = _round_up(h + 2 * py, LANE if lane_aligned_rows else SUBLANE)
    wc = _round_up(w + 2 * px, LANE)
    return py, px, hc, wc


def shear_tables(angles: torch.Tensor, h: int, w: int, max_angle: float = 45.0,
                 lane_aligned_rows: bool = False) -> Tables:
    """Per-row x shifts ``s_x`` [B, Hc] and per-column y shifts ``s_y``
    [B, Wc], reduced mod the canvas, computed in fp32 on ``angles``' device
    as the JAX package does: rint is round-half-to-even (``torch.round``) and
    the modulo is floor-mod (``torch.remainder``)."""
    py, px, hc, wc = canvas(h, w, max_angle, lane_aligned_rows)
    dev = angles.device
    # negated: the inverse map src = R(theta) dest of rotate_nearest_batch
    # applies dest = R(-theta) src; the shear chain applies dest = R(theta) src
    theta = -(angles.float() * (math.pi / 180))
    a = -torch.tan(theta / 2.0)
    b = torch.sin(theta)
    rows = torch.arange(hc, dtype=torch.float32, device=dev) - (py + (h - 1) / 2.0)
    cols = torch.arange(wc, dtype=torch.float32, device=dev) - (px + (w - 1) / 2.0)
    s_x = torch.remainder(torch.round(a[:, None] * rows[None, :]).to(torch.int32), wc)
    s_y = torch.remainder(torch.round(b[:, None] * cols[None, :]).to(torch.int32), hc)
    return s_x.to(torch.int32).contiguous(), s_y.to(torch.int32).contiguous(), (py, px, hc, wc)


def _pad_canvas(images: torch.Tensor, geom) -> torch.Tensor:
    py, px, hc, wc = geom
    _, h, w = images.shape
    return F.pad(images, (px, wc - w - px, py, hc - h - py))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def lane_roll_rows_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, R, Wc] with row r of image b rolled by shifts[b, r] (mod Wc)."""
    wc = x.shape[-1]
    cols = torch.arange(wc, device=x.device)
    src = torch.remainder(cols[None, None, :] - shifts[:, :, None].long(), wc)
    return torch.gather(x, 2, src)


def _roll_columns_plain(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, Hc, Wc] with column c of image b rolled by shifts[b, c] (mod Hc)."""
    hc = x.shape[1]
    rows = torch.arange(hc, device=x.device)
    src = torch.remainder(rows[None, :, None] - shifts[:, None, :].long(), hc)
    return torch.gather(x, 1, src)


def rotate_shear_plain(images: torch.Tensor, angles: torch.Tensor, max_angle: float = 45.0,
                       tables: Optional[Tables] = None) -> torch.Tensor:
    """The three rolls of ``_rotate_kernel`` on its canvas: rows by s_x,
    columns by s_y, rows by s_x again; then the H x W window."""
    _, h, w = images.shape
    s_x, s_y, geom = tables if tables is not None else shear_tables(angles, h, w, max_angle)
    py, px, _, _ = geom
    z = lane_roll_rows_plain(_pad_canvas(images, geom), s_x)
    z = lane_roll_rows_plain(_roll_columns_plain(z, s_y), s_x)
    return z[:, py:py + h, px:px + w]


def rotate_shear_pair_plain(images: torch.Tensor, labels: torch.Tensor, angles: torch.Tensor,
                            max_angle: float = 45.0, tables: Optional[Tables] = None):
    """(images, labels) rotated by the same shifts; the int32 labels through
    fp32, exact below 2^24, as the JAX path rotates them."""
    _, h, w = images.shape
    tables = tables if tables is not None else shear_tables(angles, h, w, max_angle)
    return (rotate_shear_plain(images, angles, max_angle, tables),
            rotate_shear_plain(labels.float(), angles, max_angle, tables).to(torch.int32))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL_SOURCE)
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.rotate_shear_f32.argtypes = [vp] * 7 + [i] * 7 + [vp]
        lib.rotate_shear_f32.restype = i
        lib.lane_roll_rows_f32.argtypes = [vp, vp, vp, i, i, i, vp]
        lib.lane_roll_rows_f32.restype = i
        lib.rotate_error_string.argtypes = [i]
        lib.rotate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().rotate_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check_operand(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _rotate_shear_cuda(images: torch.Tensor, angles: torch.Tensor,
                       labels: Optional[torch.Tensor], geom: Tuple[int, int, int, int]):
    """One launch: (images, labels or None)."""
    py, px, hc, wc = geom
    b, h, w = images.shape
    _check_operand(images, "images", torch.float32, (b, h, w))
    _check_operand(angles, "angles", torch.float32, (b,), images.device)
    if labels is not None:
        _check_operand(labels, "labels", torch.int32, (b, h, w), images.device)
    lib = _library()
    with torch.cuda.device(images.device):
        out = torch.empty_like(images)
        out_lab = None if labels is None else torch.empty_like(labels)
        stream = torch.cuda.current_stream(images.device).cuda_stream
        rc = lib.rotate_shear_f32(images.data_ptr(), _ptr(labels), angles.data_ptr(),
                                  out.data_ptr(), _ptr(out_lab), None, None, b, h, w,
                                  py, px, hc, wc, stream)
    _check(rc, ROTATE)
    LAUNCHES[(ROTATE, b)] += 1
    return out, out_lab


def _lane_roll_rows_cuda(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    b, r, wc = x.shape
    _check_operand(x, "x", torch.float32, (b, r, wc))
    _check_operand(shifts, "shifts", torch.int32, (b, r), x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        out = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lane_roll_rows_f32(x.data_ptr(), shifts.data_ptr(), out.data_ptr(), b, r, wc,
                                    stream)
    _check(rc, ROLL)
    LAUNCHES[(ROLL, b)] += 1
    return out


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU operands, False for CUDA ones; raises on a mix."""
    cuda = [t.is_cuda for t in tensors]
    if all(cuda):
        return False
    if not any(cuda) and all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"operands on mixed or unsupported devices {[str(t.device) for t in tensors]}")


def rotate_shear(images: torch.Tensor, angles: torch.Tensor, max_angle: float = 45.0,
                 labels: Optional[torch.Tensor] = None, tables: Optional[Tables] = None):
    """[B, H, W] float rotated per sample by ``angles`` (degrees, |angle| <=
    ``max_angle``), and with ``labels`` ([B, H, W] int32) the labels by the
    same permutation: returns the images, or (images, labels). CUDA tensors
    take one kernel launch, which derives its own shifts; CPU tensors the
    plain version, the labels through fp32 as the JAX path rotates them.
    ``tables`` (from ``shear_tables``) skips recomputing the shifts of the
    plain version, and is refused with CUDA tensors."""
    if images.dim() != 3 or not images.is_floating_point():
        raise TypeError(f"images must be a float [B, H, W] tensor, got {images.dtype} "
                        f"{tuple(images.shape)}")
    operands = (images, angles)
    if labels is not None:
        if labels.dtype != torch.int32:
            raise TypeError(f"labels must be int32, got {labels.dtype}")
        if labels.shape != images.shape:
            raise ValueError(f"labels have shape {tuple(labels.shape)}, expected the images' "
                             f"{tuple(images.shape)}")
        operands += (labels,)
    _, h, w = images.shape
    if _on_cpu(*operands):
        if labels is None:
            return rotate_shear_plain(images, angles, max_angle, tables)
        return rotate_shear_pair_plain(images, labels, angles, max_angle, tables)
    if tables is not None:
        raise ValueError("tables= is for the plain version: the kernel derives its own shifts")
    angles = angles if angles.dtype == torch.float32 else angles.float()
    out, out_lab = _rotate_shear_cuda(images, angles, labels, canvas(h, w, max_angle, False))
    return out if labels is None else (out, out_lab)


def kernel_shifts(angles: torch.Tensor, h: int, w: int,
                  max_angle: float = 45.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shifts (s_x [B, Hc], s_y [B, Wc]) that the rotation kernel derives
    for ``angles`` (fp32, on the card) of [h, w] images, written by one
    launch of the kernel that moves no pixel; ``shear_tables`` computes the
    same with torch ops."""
    b = angles.shape[0]
    _check_operand(angles, "angles", torch.float32, (b,))
    py, px, hc, wc = canvas(h, w, max_angle, False)
    lib = _library()
    with torch.cuda.device(angles.device):
        s_x = torch.empty((b, hc), dtype=torch.int32, device=angles.device)
        s_y = torch.empty((b, wc), dtype=torch.int32, device=angles.device)
        stream = torch.cuda.current_stream(angles.device).cuda_stream
        rc = lib.rotate_shear_f32(None, None, angles.data_ptr(), None, None, s_x.data_ptr(),
                                  s_y.data_ptr(), b, h, w, py, px, hc, wc, stream)
    _check(rc, ROTATE)
    LAUNCHES[(ROTATE, b)] += 1
    return s_x, s_y


def lane_roll_rows(x: torch.Tensor, shifts: torch.Tensor) -> torch.Tensor:
    """[B, R, Wc] row rolls by ``shifts`` [B, R]: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if _on_cpu(x, shifts):
        return lane_roll_rows_plain(x, shifts)
    return _lane_roll_rows_cuda(x, shifts)


def rotate_shear_lanes(images: torch.Tensor, angles: torch.Tensor, max_angle: float = 45.0,
                       tables: Optional[Tables] = None) -> torch.Tensor:
    """``rotate_shear`` as three row rolls: the column shear runs on the
    transposed canvas. ``tables`` must come from
    ``shear_tables(..., lane_aligned_rows=True)``."""
    _, h, w = images.shape
    if tables is None:
        tables = shear_tables(angles, h, w, max_angle, lane_aligned_rows=True)
    s_x, s_y, geom = tables
    py, px, _, _ = geom
    z = lane_roll_rows(_pad_canvas(images, geom), s_x)
    z = lane_roll_rows(z.transpose(1, 2).contiguous(), s_y).transpose(1, 2).contiguous()
    z = lane_roll_rows(z, s_x)
    return z[:, py:py + h, px:px + w]
