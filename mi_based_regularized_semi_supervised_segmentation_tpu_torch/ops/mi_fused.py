"""Fused displaced-MI joint from logits: the CUDA kernels (``csrc/mi_fused.cu``),
their wrappers and their plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/mi_fused.py``
(``displaced_joint_softmax_pallas``, ``Kernel.backend=pallas_fused``). Inputs
are two pre-padded logit canvases [B, Hp, Wp, C], C = 128 t lanes (t = 1 to
``MAX_LANES // LANES``; the JAX kernel asserts only C % 128 == 0), with the
dead lanes from S*K on at float32 min as ``LocalClusterHead(emit_logits=True)``
emits them (-inf when the heads compute in bf16: bf16 logits, which the
kernels read and convert to fp32), flattened row-major to [N, C]. For a row n:

    valid(n) = (y, x) of n lies in [y_lo, y_hi) x [p, Wp - p)   (conv zero padding)
    z  = l / T on the live lanes, -inf on the dead ones
    e  = exp(z - m), m the max of z over the whole ROW (not per group)
    p  = e / (den + 1e-16), den the per-group sum of e (of bf16-rounded e
         when dot_dtype is bf16)
    pm = p * valid, rounded to dot_dtype
    J[d, k1, k2] = sum_n pm1[n + o_d, k1] * pm2[n, k2],  o_d = (dy - p) * Wp + (dx - p)

[y_lo, y_hi) is [p, Hp - p) for l2, and for l1 unless the caller gives
l1's window (``rows1``): under the spatial H split l1's canvas is a band of
the map with a halo of p rows from its neighbours, live except at the map's
ends (``engine/steps.py:iic_regularization``), while l2 keeps its zero
border. The unsplit window gives the unsplit kernels' output bit for bit.

A group far below its row's max underflows to all-zero probabilities, as on
the TPU (``group_softmax_flat`` normalizes per group and would not). Backward,
with g = dL/dJ rounded to dot_dtype:

    dq2[n] = valid2(n) * sum_d pm1[n + o_d] @ g[d]
    dq1[m] = valid1(m) * sum_d pm2[m - o_d] @ g[d]^T   (a halo row's dl1 too)
    t = p * dq;  s = per-group sum of t (of bf16-rounded t in bf16 mode)
    dl = (t - p * s) / T, 0 on the dead lanes, in the logits' dtype (bf16
         logits: rounded once, the TPU kernel's ``out_dtype = l.dtype``)

Products are summed in fp32. On the kernel path no fp32 probability tensor
is ever allocated: in bf16 mode a conversion pass forms the masked softmax of
each whole row once a call into bf16 rows, and the products run on the
joint's kernels at its launch plan (``launch_setup``). At C = 128 the rows
are 128 lanes, and the joint's backward kernel also applies the softmax VJP
to its own rows before it writes, so no dq exists. At C = 128 t, t > 1, the
rows are the joint's wide rows of W = 64 ceil(S*K / 64) lanes (the quarters
that hold a live lane), each product one launch of the joint's wide kernels
over them; the VJP's group sums straddle the 128-lane blocks, so the
backward's product writes an [N, C] fp32 dq scratch once and one pass over
whole rows applies the VJP (``csrc/mi_fused.cu``). The plain version computes the same in fp32 with
bf16 rounding at exactly those points, at any C; its backward is written
out, not left to autograd, which would round elsewhere.

Data parallelism: each rank's call returns the J of its rows; the loss front
door (``ops/iic_local.py:iid_segmentation_loss_fused_logits``) sums J over
the ranks before the MI, and that sum's backward hands every rank the global
g, so the kernels run unchanged at the per-rank shapes. A padded batch never
reaches them: its pad rows would need a row mask inside the softmax, and the
trainer sends such a batch to the unfused path.

Dispatch: CUDA tensors go to the kernels (or the call raises), CPU tensors to
the plain version. ``LAUNCHES`` counts kernel launches by (kernel, padding),
one a wrapper call, a call on bf16 logits under the name with
``mi_joint.BF16_OPERANDS`` appended, whatever the lane count (under a CUDA
graph, once a replay: ``ops/launches.py``). The device
kernels a call launches, whatever the logits' dtype: in bf16 mode at t = 1
(128 lanes) 3 in the forward (softmax pass, product, chunk sum) and 2 in each
backward (softmax pass with g, product with the VJP epilogue); at t > 1 3 in
the forward (softmax pass, product over the live quarter tiles, chunk sum)
and 3 in each backward (softmax pass with g, product into dq, VJP pass). The
fp32 mode launches 2 in the forward and 2 in each backward at any t.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import build, launches
from .mi_joint import (JointPlan, ScratchSpec, WidePlan, _check_modes, _check_operand, _offsets,
                       _ptr, _sm_count, alloc_scratch, bf16_scratch, fwd_chunking, kernel_name,
                       launch_plan, wide_plan, wide_scratch)

KERNEL_SOURCE = "mi_fused"
FWD, BWD_DL2, BWD_DL1 = "mi_fused_fwd", "mi_fused_bwd_dl2", "mi_fused_bwd_dl1"
LANES = 128  # the kernels' lane block: logits take C = LANES * t lanes
MAX_LANES = 1024  # t <= 8: the whole-row kernels keep rows of C floats a warp in shared memory
LAUNCHES: "collections.Counter[Tuple[str, int]]" = launches.counter()


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def launch_count(name: str) -> int:
    return sum(v for (k, _), v in LAUNCHES.items() if k == name)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

def _round(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def row_valid(n: int, hp: int, wp: int, padding: int, device=None,
              rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """[n, 1] fp32: 1 where a tall row of [B, Hp, Wp] canvases is live: its
    x in [p, Wp - p), its y in ``rows`` = [y_lo, y_hi) (the interior
    [p, Hp - p) by default)."""
    rem = torch.arange(n, device=device) % (hp * wp)
    y, x = rem // wp, rem % wp
    p = padding
    y_lo, y_hi = window(hp, padding, rows)
    return ((y >= y_lo) & (y < y_hi) & (x >= p) & (x < wp - p)).float()[:, None]


def window(hp: int, padding: int, rows: Optional[Tuple[int, int]] = None) -> Tuple[int, int]:
    """A canvas's live rows [y_lo, y_hi): ``rows``, or the interior."""
    y_lo, y_hi = (padding, hp - padding) if rows is None else (int(rows[0]), int(rows[1]))
    if not 0 <= y_lo < y_hi <= hp:
        raise ValueError(f"live rows [{y_lo}, {y_hi}) outside a canvas of {hp} rows")
    return y_lo, y_hi


def _group_sum(x: torch.Tensor, S: int, K: int) -> torch.Tensor:
    """[N, C] -> each live lane's group sum (fp32), 0 on the dead lanes."""
    sk = S * K
    sums = x[:, :sk].reshape(-1, S, K).sum(-1, keepdim=True).expand(-1, S, K)
    return F.pad(sums.reshape(-1, sk), (0, x.shape[1] - sk))


def group_softmax_rowmax(logits: torch.Tensor, S: int, K: int, T: float = 1.0,
                         bf16: bool = True) -> torch.Tensor:
    """[N, C] logits -> unmasked fp32 probabilities, the TPU kernel's softmax:
    the max over all live lanes of the row, per-group sums of the (bf16-rounded)
    exps, dead lanes exactly 0."""
    live = torch.arange(logits.shape[1], device=logits.device) < S * K
    z = torch.where(live, logits.float() / T, float("-inf"))
    e = torch.exp(z - z.amax(-1, keepdim=True))
    return e / (_group_sum(_round(e, bf16), S, K) + 1e-16)


def _probs(logits, hp, wp, padding, S, K, T, bf16, rows=None):
    """(masked probabilities rounded to the operand type, unmasked p, valid);
    ``rows``: the canvas's live rows (``row_valid``)."""
    p = group_softmax_rowmax(logits, S, K, T, bf16)
    valid = row_valid(logits.shape[0], hp, wp, padding, logits.device, rows)
    return _round(p * valid, bf16), p, valid


def _shifted(x: torch.Tensor, wp: int, padding: int) -> torch.Tensor:
    """x padded with shift = p * Wp + p zero rows at both ends: row r holds
    x[r - shift], so the slice [off_d, off_d + N) is x[n + o_d]."""
    shift = padding * wp + padding
    return F.pad(x, (0, 0, shift, shift))


def _softmax_vjp(p: torch.Tensor, dq: torch.Tensor, S: int, K: int, T: float,
                 bf16: bool) -> torch.Tensor:
    t = p * dq
    return (t - p * _group_sum(_round(t, bf16), S, K)) / T


def fused_fwd_plain(l1: torch.Tensor, l2: torch.Tensor, hp: int, wp: int, padding: int,
                    S: int, K: int, T: float = 1.0,
                    dot_dtype: torch.dtype = torch.bfloat16,
                    rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Logits [N, C] x2 -> J [D, C, C] fp32; ``rows1``: l1's live rows."""
    bf16 = dot_dtype == torch.bfloat16
    n = l1.shape[0]
    pm1 = _probs(l1, hp, wp, padding, S, K, T, bf16, rows1)[0]
    pm2 = _probs(l2, hp, wp, padding, S, K, T, bf16)[0]
    a_pad = _shifted(pm1, wp, padding)
    return torch.stack([a_pad[off:off + n].T @ pm2 for off in _offsets(wp, padding)])


def fused_bwd_side_plain(src: torch.Tensor, own: torch.Tensor, g: torch.Tensor, hp: int,
                         wp: int, padding: int, S: int, K: int, T: float = 1.0,
                         dot_dtype: torch.dtype = torch.bfloat16,
                         transpose_g: bool = False,
                         rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """d(own logits) [N, C] in own's dtype (fp32, or bf16 rounded once), what
    one backward kernel launch computes: dl2 (src = l1, own = l2, transpose_g
    False) or dl1 (src = l2, own = l1, transpose_g True) for the cotangent g
    [D, C, C] of J; ``rows1``: l1's live rows."""
    bf16 = dot_dtype == torch.bfloat16
    n = src.shape[0]
    pm_src = _probs(src, hp, wp, padding, S, K, T, bf16, None if transpose_g else rows1)[0]
    _, p_own, v_own = _probs(own, hp, wp, padding, S, K, T, bf16, rows1 if transpose_g else None)
    g = _round(g.float(), bf16)
    offsets = _offsets(wp, padding)
    padded = _shifted(pm_src, wp, padding)
    if transpose_g:  # pm2[m - o_d] is row m + max_off - off_d of the padded copy
        max_off = offsets[-1]
        dq = sum(padded[max_off - off:max_off - off + n] @ g[d].T
                 for d, off in enumerate(offsets))
    else:
        dq = sum(padded[off:off + n] @ g[d] for d, off in enumerate(offsets))
    return _softmax_vjp(p_own, dq * v_own, S, K, T, bf16).to(own.dtype)


def fused_bwd_plain(l1: torch.Tensor, l2: torch.Tensor, g: torch.Tensor, hp: int, wp: int,
                    padding: int, S: int, K: int, T: float = 1.0,
                    dot_dtype: torch.dtype = torch.bfloat16,
                    rows1: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dl1, dl2) [N, C], each in its logits' dtype, for the cotangent g
    [D, C, C] of J; ``rows1``: l1's live rows."""
    args = (hp, wp, padding, S, K, T, dot_dtype)
    return (fused_bwd_side_plain(l2, l1, g, *args, transpose_g=True, rows1=rows1),
            fused_bwd_side_plain(l1, l2, g, *args, transpose_g=False, rows1=rows1))


class _DisplacedJointSoftmaxPlain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l1, l2, geometry, rows1):
        ctx.save_for_backward(l1, l2)
        ctx.geometry, ctx.rows1 = geometry, rows1
        return fused_fwd_plain(l1, l2, *geometry, rows1=rows1)

    @staticmethod
    def backward(ctx, g):
        l1, l2 = ctx.saved_tensors
        dl1, dl2 = fused_bwd_plain(l1, l2, g, *ctx.geometry, rows1=ctx.rows1)
        return dl1, dl2, None, None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = build.load(KERNEL_SOURCE)
        vp, ll, i, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        geo = [ll, i, i, i, i, i, i, f, i, i, i, i]  # ... the temperature, the two windows
        lib.mi_fused_fwd_bf16.argtypes = [vp, vp, vp, vp, vp, vp] + geo + [ll, i, i, i, vp]
        lib.mi_fused_bwd_bf16.argtypes = [vp, vp, vp, vp, vp, vp, vp] + geo + [i, i, i, i, vp]
        lib.mi_fused_fwd_fp32.argtypes = [vp, vp, vp, vp] + geo + [ll, i, vp]
        lib.mi_fused_bwd_fp32.argtypes = [vp, vp, vp, vp, vp] + geo + [i, vp]
        lib.mi_fused_fwd_bf16in.argtypes = lib.mi_fused_fwd_bf16.argtypes
        lib.mi_fused_bwd_bf16in.argtypes = lib.mi_fused_bwd_bf16.argtypes
        for fn in (lib.mi_fused_fwd_bf16, lib.mi_fused_bwd_bf16, lib.mi_fused_fwd_fp32,
                   lib.mi_fused_bwd_fp32, lib.mi_fused_fwd_bf16in, lib.mi_fused_bwd_bf16in):
            fn.restype = i
        lib.mi_fused_error_string.argtypes = [i]
        lib.mi_fused_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().mi_fused_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _check_layout(n: int, c: int, hp: int, wp: int, padding: int, S: int, K: int, T: float,
                  *tensors: torch.Tensor) -> None:
    if c % LANES or not LANES <= c <= MAX_LANES:
        raise ValueError(f"the fused kernels take logits in {LANES}-lane blocks (C a multiple "
                         f"of {LANES}, at most {MAX_LANES}), got {c} lanes")
    if padding < 0 or hp <= 2 * padding or wp <= 2 * padding or n % (hp * wp):
        raise ValueError(f"{n} rows are no stack of {hp} x {wp} canvases with border {padding}")
    if S < 1 or K < 1 or S * K > c or not T > 0:
        raise ValueError(f"S={S}, K={K}, T={T}: need S*K <= {c} live lanes and T > 0")
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the fused kernels read rows as 16-byte vectors: pointer misaligned")


def launch_setup(n: int, wp: int, padding: int, sm_count: int, backward: bool,
                 lanes: int = LANES, live: Optional[int] = None
                 ) -> Tuple[Union[JointPlan, WidePlan], ScratchSpec]:
    """The bf16 kernels' launch plan and scratch at C = ``lanes`` = 128 t,
    ``live`` = S*K of them live (all by default): at t = 1 the joint's plan
    at 128 lanes and its scratch (the forward's two [N, 128] bf16 copies,
    which hold the masked probabilities here, or the backward's source copy
    and H); at t > 1 the joint's wide plan and scratch for the live lanes
    (rows of W = 64 ceil(live / 64) lanes), the backward's with the [N, C]
    fp32 dq its product writes."""
    if lanes == LANES:
        plan = launch_plan(n, LANES, padding, wp, sm_count)
        return plan, bf16_scratch(plan, backward)
    plan = wide_plan(n, live or lanes, padding, wp, sm_count)
    spec = wide_scratch(plan, backward)
    if backward:
        spec["dq"] = ((n, lanes), torch.float32)
    return plan, spec


def _windows(hp: int, padding: int, rows1: Optional[Tuple[int, int]],
             l1_first: bool = True) -> Tuple[int, int, int, int]:
    """The kernels' two live-row windows, the first operand's then the
    second's (forward: l1, l2; backward: the source side, the own side)."""
    w1, w2 = window(hp, padding, rows1), window(hp, padding)
    return w1 + w2 if l1_first else w2 + w1


def mi_fused_fwd(l1: torch.Tensor, l2: torch.Tensor, hp: int, wp: int, padding: int,
                 S: int, K: int, T: float = 1.0, bf16: bool = True,
                 rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Kernel launch: J [D, C, C] fp32 from flat logit canvases [N, C], C =
    128 t (fp32, or bf16 with bf16 products); ``rows1``: l1's live rows."""
    _check_operand(l1, "l1")
    _check_operand(l2, "l2", l1.shape, (l1.dtype,))
    if l1.device != l2.device:
        raise ValueError(f"l1 on {l1.device}, l2 on {l2.device}")
    _check_modes(l1, bf16)
    n, c = l1.shape
    _check_layout(n, c, hp, wp, padding, S, K, T, l1, l2)
    d = (2 * padding + 1) ** 2
    lib = _library()
    with torch.cuda.device(l1.device):
        sms = _sm_count(l1.device.index)
        out = torch.empty((d, c, c), dtype=torch.float32, device=l1.device)
        stream = torch.cuda.current_stream(l1.device).cuda_stream
        geometry = (n, c, hp, wp, padding, S, K, float(T)) + _windows(hp, padding, rows1)
        if bf16:
            plan, spec = launch_setup(n, wp, padding, sms, backward=False, lanes=c, live=S * K)
            buf = alloc_scratch(spec, l1.device)
            fn = lib.mi_fused_fwd_bf16in if l1.dtype == torch.bfloat16 else lib.mi_fused_fwd_bf16
            rc = fn(l1.data_ptr(), l2.data_ptr(), buf["a16"].data_ptr(), buf["b16"].data_ptr(),
                    buf["partial"].data_ptr(), out.data_ptr(), *geometry,
                    plan.fwd_rows_per_chunk, plan.fwd_chunks, plan.fwd_dx_group, plan.fwd_smem,
                    stream)
        else:
            rows, chunks = fwd_chunking(n, c, padding, sms)
            partial = torch.empty((chunks, d, c, c), dtype=torch.float32, device=l1.device)
            rc = lib.mi_fused_fwd_fp32(l1.data_ptr(), l2.data_ptr(), partial.data_ptr(),
                                       out.data_ptr(), *geometry, rows, chunks, stream)
    name = kernel_name(FWD, l1.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


def mi_fused_bwd(src: torch.Tensor, own: torch.Tensor, g: torch.Tensor, hp: int, wp: int,
                 padding: int, S: int, K: int, T: float = 1.0, transpose_g: bool = False,
                 bf16: bool = True, rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Kernel launch: d(own logits) [N, C] in the logits' dtype (fp32, or
    bf16 with bf16 products); g [D, C, C] fp32, C = 128 t; ``rows1``: l1's
    live rows (the source side's for dl2, the own side's for dl1).

    transpose_g=False: dl2 (src = l1, own = l2), dq[n] = sum_d pm1[n + o_d] @ g[d]
    transpose_g=True:  dl1 (src = l2, own = l1), dq[m] = sum_d pm2[m - o_d] @ g[d]^T
    """
    _check_operand(src, "src")
    _check_operand(own, "own", src.shape, (src.dtype,))
    n, c = src.shape
    d = (2 * padding + 1) ** 2
    _check_operand(g, "g", (d, c, c), (torch.float32,))
    if not src.device == own.device == g.device:
        raise ValueError(f"src on {src.device}, own on {own.device}, g on {g.device}")
    _check_modes(src, bf16)
    _check_layout(n, c, hp, wp, padding, S, K, T, src, own, g)
    lib = _library()
    with torch.cuda.device(src.device):
        out = torch.empty((n, c), dtype=src.dtype, device=src.device)
        stream = torch.cuda.current_stream(src.device).cuda_stream
        geometry = ((n, c, hp, wp, padding, S, K, float(T))
                    + _windows(hp, padding, rows1, l1_first=not transpose_g) + (int(transpose_g),))
        if bf16:
            plan, spec = launch_setup(n, wp, padding, _sm_count(src.device.index), backward=True,
                                      lanes=c, live=S * K)
            buf = alloc_scratch(spec, src.device)
            fn = lib.mi_fused_bwd_bf16in if src.dtype == torch.bfloat16 else lib.mi_fused_bwd_bf16
            rc = fn(src.data_ptr(), own.data_ptr(), g.data_ptr(), buf["s16"].data_ptr(),
                    buf["h16"].data_ptr(), _ptr(buf, "dq"), out.data_ptr(), *geometry,
                    plan.bwd_stages, plan.bwd_slabs, plan.bwd_smem, stream)
        else:
            dq = torch.empty((n, c), dtype=torch.float32, device=src.device)
            rc = lib.mi_fused_bwd_fp32(src.data_ptr(), own.data_ptr(), g.data_ptr(),
                                       dq.data_ptr(), out.data_ptr(), *geometry, stream)
    name = kernel_name(BWD_DL1 if transpose_g else BWD_DL2, src.dtype)
    _check(rc, name)
    LAUNCHES[(name, padding)] += 1
    return out


class _DisplacedJointSoftmaxCUDA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, l1, l2, geometry, rows1):
        ctx.save_for_backward(l1, l2)
        ctx.geometry, ctx.rows1 = geometry, rows1
        *args, dot_dtype = geometry
        return mi_fused_fwd(l1, l2, *args, bf16=dot_dtype == torch.bfloat16, rows1=rows1)

    @staticmethod
    def backward(ctx, g):
        l1, l2 = ctx.saved_tensors
        *args, dot_dtype = ctx.geometry
        bf16 = dot_dtype == torch.bfloat16
        g = g.contiguous()
        dl1 = dl2 = None
        if ctx.needs_input_grad[0]:
            dl1 = mi_fused_bwd(l2, l1, g, *args, transpose_g=True, bf16=bf16, rows1=ctx.rows1)
        if ctx.needs_input_grad[1]:
            dl2 = mi_fused_bwd(l1, l2, g, *args, transpose_g=False, bf16=bf16, rows1=ctx.rows1)
        return dl1, dl2, None, None


def displaced_joint_softmax(l1: torch.Tensor, l2: torch.Tensor, padding: int, S: int, K: int,
                            T: float = 1.0,
                            dot_dtype: torch.dtype = torch.bfloat16,
                            rows1: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Pre-padded logit canvases [B, Hp, Wp, C] x2, C = 128 t -> [Tt, Tt, C, C]
    raw displaced sums of the masked row-max group-softmax probabilities
    (``displaced_joint_softmax_pallas``); gradients flow to the logits. The
    kernels for CUDA tensors, the plain version for CPU tensors. ``rows1``:
    l1's live rows [y_lo, y_hi) of each canvas (None: its interior, as
    l2's; a band's halo'd canvas under the H split)."""
    if l1.dim() != 4 or l1.shape != l2.shape:
        raise ValueError(f"expected two equal [B, Hp, Wp, C] shapes, got {l1.shape}, {l2.shape}")
    if dot_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dot_dtype must be bfloat16 or float32, got {dot_dtype}")
    _, hp, wp, c = l1.shape
    _check_layout(l1.numel() // c, c, hp, wp, padding, S, K, T)
    geometry = (hp, wp, padding, S, K, float(T), dot_dtype)
    rows1 = None if rows1 is None else window(hp, padding, rows1)
    a, b = l1.reshape(-1, c), l2.reshape(-1, c)
    if a.is_cuda or b.is_cuda:
        joint = _DisplacedJointSoftmaxCUDA.apply(a, b, geometry, rows1)
    elif a.device.type == "cpu" and b.device.type == "cpu":
        joint = _DisplacedJointSoftmaxPlain.apply(a, b, geometry, rows1)
    else:
        raise ValueError(f"unsupported devices {l1.device}, {l2.device}")
    t = 2 * padding + 1
    return joint.reshape(t, t, c, c)
