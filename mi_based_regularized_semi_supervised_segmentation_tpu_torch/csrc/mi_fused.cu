// Fused displaced-MI joint from logits: the row's group softmax, the interior
// mask and the displaced joint, and the two backward products with the
// softmax VJP, for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/mi_fused.py (Kernel.backend=pallas_fused):
//   * mi_fused.py:215 _fused_fwd / _fwd_kernel
//       -> C = 128: joint_prep<SoftmaxRows> + joint_fwd_partial + joint_fwd_reduce
//          C = 128 t: wide_prep + joint_fwd_wide + joint_fwd_reduce
//   * mi_fused.py:254 _fused_bwd / _bwd_kernel (dl2)
//       -> C = 128: joint_prep<SoftmaxRows> + joint_bwd<VjpRows>, g[d] as is
//          C = 128 t: wide_prep + joint_bwd_wide<StoreWide> + wide_vjp
//   * mi_fused.py:275 _fused_bwd / _bwd_kernel (dl1, transpose_g)
//       -> the same kernels, g[D-1-d]^T
//
// What is computed. l1, l2 are [N, C] logits, C = 128 t lanes (t = 1 .. 8),
// fp32 or (the model's bf16 compute, Precision.compute_dtype=bfloat16) bf16,
// read as fp32: the row-major flattening of [B, Hp, Wp, C] canvases with a
// border of width p; lanes from S*K on are dead (float32 min, or -inf in
// bf16: no step reads a dead lane's value). For a row n:
//   valid(n) = 0 <= n < N and (y, x) of n lies in [y_lo, y_hi) x [p, Wp - p)
//   z = l / T on live lanes, -inf on dead ones; m = max of z over the ROW
//   e = exp(z - m); den = per-group sum of e (of bf16-rounded e in bf16 mode)
//   p = e / (den + 1e-16);  pm = p * valid, rounded to bf16 in bf16 mode
// (m is the row's max, not the group's: a group far below it underflows to
// all-zero probabilities, as on the TPU.) With o_d = (dy - p) * Wp + (dx - p),
// d = dy * (2p + 1) + dx:
//   J[d, k1, k2] = sum_n pm1[n + o_d, k1] * pm2[n, k2]
// Backward, g = dL/dJ (rounded to bf16 in bf16 mode):
//   dq2[n] = valid2(n) * sum_d pm1[n + o_d] @ g[d]
//   dq1[m] = valid1(m) * sum_d pm2[m - o_d] @ g[d]^T
//   t = p * dq;  s = per-group sum of t (of bf16-rounded t in bf16 mode)
//   dl = (t - p * s) / T, and 0 on dead lanes, written in the logits' type
//   (bf16 logits: rounded once, the TPU kernel's out_dtype = l.dtype)
// Products are accumulated in fp32; the fp32 operand mode is the parity mode.
// [y_lo, y_hi) is each operand's own window of live rows (Geometry::lo0 ..):
// [p, Hp - p) for l2, and for l1 unless it holds a band of the map under the
// spatial H split, whose canvas carries a halo of p rows from the
// neighbouring bands, live except at the map's ends (the caller sets it).
// The rows a halo carries are then read by the shifted operand and receive
// their dl1, which the halo's backward sends home. The interior window gives
// the kernels' unsplit output bit for bit.
//
// What bounds it on an H100 (989 TF/s dense bf16, 3.35 TB/s HBM). Each launch
// does the products of the matching mi_joint launch: at the headline Up_conv2
// tap (N = 529,000, p = 3, 49 displacements) 2*N*C*C*49 flops, 8.5e11 at C =
// 128 (0.86 ms) and 4x that at C = 256, against ~0.27 GB of logits read and J
// (or d(logits)) written a 128-lane block, so the work is bound by operations.
// At Up_conv3 (N = 129,960, p = 1) the bytes bound it at 128 lanes
// (~0.04-0.06 ms). The 2*N*C exps that the function needs are far below
// either bound.
//
// What the bf16 design (the training path) does about it: each row's softmax
// is formed once per call, in a conversion pass, and the products run on the
// joint's wgmma kernels (joint_core.cuh, one copy shared with mi_joint.cu;
// the launch plan and scratch are the joint's at 128 lanes, from
// ops/mi_joint.py). The products take bf16 operands anyway, so the pass
// writes pm = bf16(p * valid) into bf16 scratch of [N, 128] lane blocks: bit
// for bit the operands the tensor cores would have read from a softmax formed
// while staging, and no fp32 probability tensor exists.
//   * C = 128, SoftmaxRows, joint_prep's row policy. A row's softmax is a
//     chain of shuffles, exps, divisions and group sums, and the pass is bound
//     by the instructions it issues, not by its bytes (at Up_conv2 271 MB of
//     logits in and 135 MB of bf16 out per operand). So a warp forms 4 rows at
//     once (4 lanes of each a thread: four independent chains) while the next
//     4 rows' loads are in flight; each thread's lane-to-group map is computed
//     once, not per row; one lane a row tests the interior mask (two integer
//     divisions) and a ballot shares it; T = 1, the only temperature the heads
//     emit, divides nothing (x / 1 is x); group sums read 16 bytes at a time
//     when K % 4 == 0. The rounding points are the TPU kernel's (row_softmax).
//   * Forward at C = 128: SoftmaxRows over l1 and l2 in one launch, then the
//     joint's joint_fwd_partial and joint_fwd_reduce unchanged: 3 launches.
//   * Backward at C = 128, once per side: SoftmaxRows over the source side's
//     logits with the joint's conversion of g (transposed, and for dl1 in
//     reversed displacement order) in one launch, then joint_bwd with the
//     VjpRows epilogue: 2 launches. After its last wgmma wait the block moves
//     its 256 x 128 fp32 accumulators (dq before the mask) to shared memory,
//     over the ring and slabs it no longer reads (152 KB of the 197-227 KB),
//     reads its own rows' logits (4 rows a warp at once, the next 4 in
//     flight), recomputes their unmasked probabilities with the same device
//     code and writes dl = (t - p*s) / T, t = p * (valid * dq). dq never
//     reaches device memory, and the epilogue holds nothing live across the
//     main loop. The SM's tensor cores idle while it runs (one block an SM):
//     it is what the backward costs over the joint's.
//   * C = 128 t, t > 1. The max runs over the whole row and a group may
//     straddle two lane blocks (K = 30: group 4 covers lanes 120-149), so the
//     softmax and its VJP read whole rows: wide_softmax, one row a warp at a
//     time, a thread holding 4 lanes of each block (loads of 16 bytes a lane,
//     neighbouring lanes on neighbouring addresses), the row's exps,
//     probabilities and rounded terms in the warp's rows of shared memory
//     (3 C floats a warp), the group sums one lane a group (S of them) and
//     each lane's group index from a table formed once a block. The rounding
//     points stay row_softmax's.
//   * Forward at C = 128 t: wide_prep writes pm1 and pm2 as rows of W =
//     64 ceil(S*K / 64) bf16 lanes (the quarters that hold a live lane; the
//     rest are zero and not computed), one launch; then the joint's wide
//     kernels (joint_core.cuh): joint_fwd_wide over the W x W quarter tiles
//     and one chunk sum into J [D, C, C], zeros past W: 3 launches.
//   * Backward at C = 128 t: the VJP needs each row's dq over all lanes,
//     since its group sums straddle the 128-lane blocks. wide_prep writes pm
//     of the source side as rows of W lanes and g as H [ceil(S*K / 128), D,
//     128, W] (one launch); joint_bwd_wide sums each output block's dq over
//     the displacements and the source's live quarters in its accumulators
//     and stores it once (StoreWide) into an [N, C] fp32 dq scratch; then
//     wide_vjp forms each own row's probabilities again and writes dl: 3
//     launches. dq makes one round trip through device memory (4 N C bytes
//     each way) that the 128-lane epilogue avoids.
//   * Edge rows: rows outside [0, N) of the shifted source are zero-filled by
//     the joint's cp.async; border rows are zero through the mask in the pass;
//     own rows that are border rows get dl = 0.
// The fp32 parity mode (CUDA-core FMAs, not on the training path) forms each
// staged row's whole-row softmax while staging it (wide_softmax), once per
// displacement and lane-block pair: the forward's block computes one 128 x
// 128 tile of J (grid D t^2 x chunks), the backward's one 128-lane block of
// dq (grid rows x t, the source's blocks summed in turn), then wide_vjp.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase prints it), no spills on
// the bf16 path: joint_bwd<6, VjpRows> 232 registers (<6, StoreRows> 219),
// 1 block per SM; joint_prep<SoftmaxRows> 128 registers and 16 KB of static
// shared memory (the warps' scratch rows); wide_prep 48-54 and wide_vjp 48
// registers with 3 C floats a warp of dynamic shared memory (25 KB a block
// at C = 256). The
// fp32 mode: fused_fwd_partial_fp32 128 registers, fused_dq_fp32 128 with 40
// (96 for the transpose) bytes of spill stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "joint_core.cuh"

namespace {

constexpr int C = LANES;      // lanes of a row at t = 1 (the 128-lane kernels)
constexpr int MAX_BLOCKS = 8; // 128-lane blocks a row may have: C <= 1024
constexpr int KT = 32;        // rows per staged slice in the fp32 forward
constexpr int ROWS = 128;     // own rows per block in the fp32 backward
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAD_F = 4;      // fp32 row padding (16 bytes)
constexpr int LD = C + PAD_F;
constexpr int LDQ = C + 8;    // VjpRows' dq rows: conflict-free float2 stores

struct Geometry {
  long long n;  // rows of the flattened canvas
  int c;        // lanes of a row: 128 t
  int hp, wp, p;
  int sk, k;    // live lanes (S*K), lanes per group (K)
  float t;      // temperature
  // live rows [lo, hi) of each canvas, of operand 0 (the forward's l1, the
  // backward's source side) and operand 1 (l2, the own side)
  int lo0, hi0, lo1, hi1;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Live row of operand `op`'s canvas (the conv zero-padding semantics, its
// window of rows); rows outside [0, N) are invalid, never clamped. The row
// index is 64-bit; the division runs in 32 bits when N allows it (64-bit
// division is emulated).
__device__ __forceinline__ bool row_valid(long long n, const Geometry& g, int op) {
  if (n < 0 || n >= g.n) return false;
  const unsigned hw = (unsigned)g.hp * (unsigned)g.wp;
  const unsigned rem = g.n <= 0xffffffffLL ? (unsigned)n % hw : (unsigned)(n % (long long)hw);
  const int y = (int)(rem / (unsigned)g.wp);
  const int x = (int)rem - y * g.wp;
  const int lo = op ? g.lo1 : g.lo0, hi = op ? g.hi1 : g.hi0;  // selects, no indexing
  return y >= lo && y < hi && x >= g.p && x < g.wp - g.p;
}

// The groups of this thread's lanes j0..j0+3 (j0 = 4 * lane), the same for
// every row of a call: computed once, so a row costs no integer division.
struct LaneMap {
  int j0;
  int begin[4];  // first lane of lane j0 + i's group; -1 for a dead lane
  bool vec;      // K % 4 == 0: every group starts on a 16-byte boundary
};

__device__ __forceinline__ LaneMap lane_map(int lane, const Geometry& g) {
  LaneMap m;
  m.j0 = lane * 4;
  m.vec = (g.k & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = m.j0 + i;
    m.begin[i] = j < g.sk ? j - j % g.k : -1;
  }
  return m;
}

// For this thread's lanes of each of R rows: the sum of each live lane's
// group over the warp's 128-float row r of `rows` (rows r * C apart, written
// and synced by the caller), in fp32 with four running sums (of elements q,
// q + 1, q + 2, q + 3 of each step of 4, the tail into the first); 0 on dead
// lanes. The R rows' sums are independent chains, interleaved.
template <int R>
__device__ __forceinline__ void group_sums(const float* rows, const LaneMap& m, int k,
                                           float (&out)[R][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = m.begin[i];
    if (b < 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[r][i] = 0.f;
    } else if (i > 0 && b == m.begin[i - 1]) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[r][i] = out[r][i - 1];
    } else {
      float s0[R], s1[R], s2[R], s3[R];
#pragma unroll
      for (int r = 0; r < R; ++r) s0[r] = s1[r] = s2[r] = s3[r] = 0.f;
      const int end = b + k;
      int q = b;
      if (m.vec) {
        for (; q < end; q += 4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 x = *reinterpret_cast<const float4*>(rows + r * C + q);
            s0[r] += x.x;
            s1[r] += x.y;
            s2[r] += x.z;
            s3[r] += x.w;
          }
        }
      } else {
        for (; q + 3 < end; q += 4) {
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float* row = rows + r * C;
            s0[r] += row[q];
            s1[r] += row[q + 1];
            s2[r] += row[q + 2];
            s3[r] += row[q + 3];
          }
        }
        for (; q < end; ++q) {
#pragma unroll
          for (int r = 0; r < R; ++r) s0[r] += rows[r * C + q];
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) out[r][i] = (s0[r] + s1[r]) + (s2[r] + s3[r]);
    }
  }
}

// x / T, or x itself when the call's T is 1 (UNIT_T; x / 1 is x exactly)
template <bool UNIT_T>
__device__ __forceinline__ float by_t(float x, float t) {
  return UNIT_T ? x : x / t;
}

// Unmasked probabilities of R rows, lanes j0..j0+3 of each (the whole warp
// calls it on the same rows). scratch: the warp's R x 128 floats.
template <bool BF16, int R, bool UNIT_T = false>
__device__ __forceinline__ void row_softmax(const float4 (&v)[R], const LaneMap& lm,
                                            const Geometry& g, float* scratch,
                                            float4 (&out)[R]) {
  float z[R][4], m[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float x[4] = {v[r].x, v[r].y, v[r].z, v[r].w};
    m[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[r][i] = lm.begin[i] >= 0 ? by_t<UNIT_T>(x[i], g.t) : -INFINITY;
      m[r] = fmaxf(m[r], z[r][i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], off));
  float e[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 4; ++i) e[r][i] = lm.begin[i] >= 0 ? expf(z[r][i] - m[r]) : 0.f;
    *reinterpret_cast<float4*>(scratch + r * C + lm.j0) =
        BF16 ? make_float4(round_bf16(e[r][0]), round_bf16(e[r][1]), round_bf16(e[r][2]),
                           round_bf16(e[r][3]))
             : make_float4(e[r][0], e[r][1], e[r][2], e[r][3]);
  }
  __syncwarp();
  float den[R][4];
  group_sums<R>(scratch, lm, g.k, den);
  __syncwarp();  // the caller's next rows rewrite scratch
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = lm.begin[i] >= 0 ? e[r][i] / (den[r][i] + 1e-16f) : 0.f;
    out[r] = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// d(logits) of R rows from their probabilities p and masked upstream dq.
// Multiplies and subtractions are rounded one by one (no FMA contraction),
// as the plain version computes them.
template <bool BF16, int R, bool UNIT_T = false>
__device__ __forceinline__ void row_softmax_vjp(const float4 (&pv)[R], const float4 (&qv)[R],
                                                const LaneMap& lm, const Geometry& g,
                                                float* scratch, float4 (&out)[R]) {
  float p[R][4], t[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float pr[4] = {pv[r].x, pv[r].y, pv[r].z, pv[r].w};
    const float qr[4] = {qv[r].x, qv[r].y, qv[r].z, qv[r].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[r][i] = pr[i];
      t[r][i] = __fmul_rn(pr[i], qr[i]);
    }
    *reinterpret_cast<float4*>(scratch + r * C + lm.j0) =
        BF16 ? make_float4(round_bf16(t[r][0]), round_bf16(t[r][1]), round_bf16(t[r][2]),
                           round_bf16(t[r][3]))
             : make_float4(t[r][0], t[r][1], t[r][2], t[r][3]);
  }
  __syncwarp();
  float s[R][4];
  group_sums<R>(scratch, lm, g.k, s);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float dl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dl[i] = lm.begin[i] >= 0
                  ? by_t<UNIT_T>(__fsub_rn(t[r][i], __fmul_rn(p[r][i], s[r][i])), g.t)
                  : 0.f;
    out[r] = make_float4(dl[0], dl[1], dl[2], dl[3]);
  }
}

// 4 consecutive logits as float: 16 bytes of fp32 or 8 bytes of bf16 (the
// model's bf16 compute: its dead lanes are -inf, which no step reads before
// it tests the lane)
__device__ __forceinline__ float4 load4(const float* l) {
  return *reinterpret_cast<const float4*>(l);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* l) {
  const uint2 w = *reinterpret_cast<const uint2*>(l);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

// 4 consecutive d(logits): fp32, or bf16 (each value rounded once)
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
}

// lanes 4 * lane .. 4 * lane + 3 of 128-lane row `row`
template <typename L>
__device__ __forceinline__ float4 load_row4(const L* l, long long row, int lane) {
  return load4(l + row * C + 4 * lane);
}
template <typename L>
__device__ __forceinline__ void store_row4(L* o, long long row, int lane, float4 v) {
  store4(o + row * C + 4 * lane, v);
}

// ===========================================================================
// bf16 mode (the training path): the two policies of the joint's kernels
// ===========================================================================

constexpr int ROW_GROUP = 4;  // rows a warp forms at once (independent chains)

// joint_prep's row policy: dst_i[r] = bf16(softmax(src_i[r]) * valid(r)),
// i = 0, 1 (src1 may be null); one warp for ROW_GROUP consecutive rows of the
// operand pair, grid-stride over the groups, the next group's logits loaded
// before this group is formed. L: the logits' type (float or bf16).
template <typename L>
struct SoftmaxRows {
  const L* src0;
  __nv_bfloat16* dst0;
  const L* src1;
  __nv_bfloat16* dst1;
  Geometry geo;

  __device__ __forceinline__ void operator()(long long first, long long stride) const {
    __shared__ __align__(16) float scratch[PREP_THREADS / 32][ROW_GROUP * C];
    float* ws = scratch[threadIdx.x >> 5];
    if (geo.t == 1.f)
      run<true>(first, stride, ws);
    else
      run<false>(first, stride, ws);
  }

  template <bool UNIT_T>
  __device__ __forceinline__ void run(long long first, long long stride, float* ws) const {
    const int lane = threadIdx.x & 31;
    const LaneMap lm = lane_map(lane, geo);
    const long long rows = src1 ? 2 * geo.n : geo.n;
    const long long groups = (rows + ROW_GROUP - 1) / ROW_GROUP;
    const long long step = stride >> 5;
    // rows ROW_GROUP * grp + i of the operand pair: which are valid (bit i;
    // lane i tests row i), and the logits of the valid ones
    auto fetch = [&](long long grp, unsigned& valid, float4 (&v)[ROW_GROUP]) {
      bool mine = false;
      if (lane < ROW_GROUP) {
        const long long u = grp * ROW_GROUP + lane;
        mine = u < rows && row_valid(u >= geo.n ? u - geo.n : u, geo, u >= geo.n);
      }
      valid = __ballot_sync(0xffffffffu, mine);
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) {
        const long long u = grp * ROW_GROUP + i;
        const bool second = u >= geo.n;
        v[i] = (valid >> i) & 1u ? load_row4(second ? src1 : src0, second ? u - geo.n : u, lane)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    long long grp = first >> 5;
    unsigned valid;
    float4 v[ROW_GROUP];
    fetch(grp, valid, v);
    for (; grp < groups; grp += step) {  // grp is uniform across the warp
      unsigned next_valid;
      float4 next[ROW_GROUP], q[ROW_GROUP];
      fetch(grp + step, next_valid, next);
      row_softmax<true, ROW_GROUP, UNIT_T>(v, lm, geo, ws, q);
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) {
        const long long u = grp * ROW_GROUP + i;
        if (u >= rows) break;
        const bool second = u >= geo.n;
        const long long r = second ? u - geo.n : u;
        const float4 x = (valid >> i) & 1u ? q[i] : make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<uint2*>((second ? dst1 : dst0) + r * LANES + 4 * lane) =
            make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
      }
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) v[i] = next[i];
      valid = next_valid;
    }
  }
};

// blocks of joint_prep<SoftmaxRows>: a warp for each group of rows, at most
// 8192 blocks (grid-stride beyond), and enough threads for the units of H
unsigned softmax_prep_blocks(long long rows, long long units_g) {
  const long long warps = (rows + ROW_GROUP - 1) / ROW_GROUP;
  const long long for_rows = (warps + PREP_THREADS / 32 - 1) / (PREP_THREADS / 32);
  const long long for_g = (units_g + PREP_THREADS - 1) / PREP_THREADS;
  const long long want = for_rows > for_g ? for_rows : for_g;
  return (unsigned)(want < 8192 ? want : 8192);
}

// joint_bwd's epilogue: out[n] = d(own logits) of the block's own rows, the
// softmax VJP at dq = valid(n) * (the block's accumulators), in the logits'
// type L (float, or bf16 rounded once from the fp32 result).
template <typename L>
struct VjpRows {
  const L* own;
  L* out;
  Geometry geo;

  __device__ __forceinline__ void operator()(float (&acc)[2][64], unsigned char* smem,
                                             long long n0, long long N, int tid) const {
    float* dq = reinterpret_cast<float*>(smem);   // [BW_TILE][LDQ]
    float* scratch = dq + BW_TILE * LDQ;          // [8 warps][ROW_GROUP * C]
    const int lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    __syncthreads();  // every warp is done with the ring and the slabs
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float* row = dq + (wg * 128 + h * 64 + wq * 16 + g + half * 8) * LDQ;
#pragma unroll
        for (int c8 = 0; c8 < 16; ++c8)
          *reinterpret_cast<float2*>(row + c8 * 8 + 2 * t4) =
              make_float2(acc[h][4 * c8 + 2 * half], acc[h][4 * c8 + 2 * half + 1]);
      }
    __syncthreads();
    if (geo.t == 1.f)
      rows<true>(dq, scratch + warp * ROW_GROUP * C, n0, N, lane, warp);
    else
      rows<false>(dq, scratch + warp * ROW_GROUP * C, n0, N, lane, warp);
  }

  // warp w takes rows [32 w, 32 w + 32), ROW_GROUP at once; a group's logits
  // are loaded while the group before it is formed
  template <bool UNIT_T>
  __device__ __forceinline__ void rows(const float* dq, float* ws, long long n0, long long N,
                                       int lane, int warp) const {
    const LaneMap lm = lane_map(lane, geo);
    // bit i: row 32 w + i is valid (lane i tests it)
    const unsigned valid =
        __ballot_sync(0xffffffffu, row_valid(n0 + warp * 32 + lane, geo, 1));
    auto fetch = [&](int r0, float4 (&v)[ROW_GROUP]) {
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) {
        const int b = r0 + i - warp * 32;
        v[i] = b < 32 && (valid >> b) & 1u ? load_row4(own, n0 + r0 + i, lane)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    float4 v[ROW_GROUP];
    fetch(warp * 32, v);
#pragma unroll 1
    for (int r0 = warp * 32; r0 < (warp + 1) * 32; r0 += ROW_GROUP) {
      if (n0 + r0 >= N) break;  // uniform across the warp; later rows are out too
      float4 next[ROW_GROUP], pv[ROW_GROUP], qv[ROW_GROUP], res[ROW_GROUP];
      fetch(r0 + ROW_GROUP, next);
      row_softmax<true, ROW_GROUP, UNIT_T>(v, lm, geo, ws, pv);
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i)
        qv[i] = reinterpret_cast<const float4*>(dq + (r0 + i) * LDQ)[lane];
      row_softmax_vjp<true, ROW_GROUP, UNIT_T>(pv, qv, lm, geo, ws, res);
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) {
        const long long n = n0 + r0 + i;
        if (n >= N) break;
        // an invalid row has dq = 0, hence dl = 0
        store_row4(out, n, lane,
                   (valid >> (r0 + i - warp * 32)) & 1u ? res[i] : make_float4(0.f, 0.f, 0.f, 0.f));
      }
#pragma unroll
      for (int i = 0; i < ROW_GROUP; ++i) v[i] = next[i];
    }
  }
};
static_assert((BW_TILE * LDQ + 8 * ROW_GROUP * C) * 4 <= bwd_smem_bytes(0, 4),
              "VjpRows' dq tile and scratch rows fit in joint_bwd's smallest shared memory");


// ===========================================================================
// rows of C = 128 t lanes (t > 1 on the bf16 path; any t in the fp32 parity
// mode): the softmax over the whole row, one row a warp at a time
// ===========================================================================

// Dynamic shared memory of the whole-row kernels: each lane's group index (C
// ints, -1 for a dead lane; computed once a block), then `per_warp` rows of C
// floats for each of the block's WARPS warps.
__host__ __device__ constexpr size_t wide_smem_bytes(int c, int per_warp) {
  return (size_t)c * 4 + (size_t)WARPS * per_warp * c * 4;
}

// A warp's view of that memory. e: the row's exps, then its unmasked
// probabilities; r: what the group sums read (the exps, bf16-rounded in bf16
// mode; in the VJP t = p * dq), the same row as e where nothing is rounded
// and e is not needed beside it (the fp32 staging); s: the S group sums.
struct WideScratch {
  const int* gidx;
  float* e;
  float* r;
  float* s;
};

__device__ __forceinline__ WideScratch wide_scratch(unsigned char* smem, const Geometry& g,
                                                    int warp, int per_warp) {
  float* rows = reinterpret_cast<float*>(smem + (size_t)g.c * 4) + (size_t)warp * per_warp * g.c;
  return {reinterpret_cast<const int*>(smem), rows, per_warp == 3 ? rows + g.c : rows,
          rows + (per_warp - 1) * g.c};
}

// every thread of the block calls it before any warp reads the table
__device__ __forceinline__ void init_groups(unsigned char* smem, const Geometry& g) {
  int* gidx = reinterpret_cast<int*>(smem);
  for (int j = threadIdx.x; j < g.c; j += blockDim.x) gidx[j] = j < g.sk ? j / g.k : -1;
  __syncthreads();
}

// the sum of the k floats at x (16-byte aligned when k % 4 == 0) in
// group_sums' four running sums
__device__ __forceinline__ float group_sum(const float* x, int k) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int q = 0;
  if ((k & 3) == 0) {
    for (; q < k; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(x + q);
      s0 += v.x;
      s1 += v.y;
      s2 += v.z;
      s3 += v.w;
    }
  } else {
    for (; q + 3 < k; q += 4) {
      s0 += x[q];
      s1 += x[q + 1];
      s2 += x[q + 2];
      s3 += x[q + 3];
    }
    for (; q < k; ++q) s0 += x[q];
  }
  return (s0 + s1) + (s2 + s3);
}

// lane l's group sums: groups l, l + 32, ... of the warp's row r (written by
// every lane before the call's first syncwarp)
__device__ __forceinline__ void wide_group_sums(const Geometry& g, const WideScratch& w,
                                                int lane) {
  __syncwarp();
  for (int s = lane; s < g.sk / g.k; s += 32) w.s[s] = group_sum(w.r + s * g.k, g.k);
  __syncwarp();
}

// Unmasked probabilities of one row of C lanes (the whole warp calls it on
// the same row; a lane holds lanes 4 lane .. 4 lane + 3 of each 128-lane
// block): afterwards w.e[j] = p_j, each written by the lane that reads it.
// The max runs over the whole row, the group sums over whole groups (a group
// may straddle two blocks); the rounding points are row_softmax's.
template <bool BF16, bool UNIT_T, typename L>
__device__ __forceinline__ void wide_softmax(const L* row, const Geometry& g,
                                             const WideScratch& w, int lane) {
  const int t = g.c / LANES;
  float m = -INFINITY;
  for (int b = 0; b < t; ++b) {
    const int j = b * LANES + 4 * lane;
    const float4 v = load4(row + j);
    const float x[4] = {v.x, v.y, v.z, v.w};
    float z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      z[i] = j + i < g.sk ? by_t<UNIT_T>(x[i], g.t) : -INFINITY;
      m = fmaxf(m, z[i]);
    }
    *reinterpret_cast<float4*>(w.e + j) = make_float4(z[0], z[1], z[2], z[3]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  for (int b = 0; b < t; ++b) {
    const int j = b * LANES + 4 * lane;
    const float4 z = *reinterpret_cast<const float4*>(w.e + j);
    const float zi[4] = {z.x, z.y, z.z, z.w};
    float e[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) e[i] = j + i < g.sk ? expf(zi[i] - m) : 0.f;
    *reinterpret_cast<float4*>(w.e + j) = make_float4(e[0], e[1], e[2], e[3]);
    if (BF16)
      *reinterpret_cast<float4*>(w.r + j) =
          make_float4(round_bf16(e[0]), round_bf16(e[1]), round_bf16(e[2]), round_bf16(e[3]));
    else if (w.r != w.e)
      *reinterpret_cast<float4*>(w.r + j) = make_float4(e[0], e[1], e[2], e[3]);
  }
  wide_group_sums(g, w, lane);
  for (int b = 0; b < t; ++b) {
    const int j = b * LANES + 4 * lane;
    const float4 e = *reinterpret_cast<const float4*>(w.e + j);
    const float ei[4] = {e.x, e.y, e.z, e.w};
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = j + i < g.sk ? ei[i] / (w.s[w.gidx[j + i]] + 1e-16f) : 0.f;
    *reinterpret_cast<float4*>(w.e + j) = make_float4(p[0], p[1], p[2], p[3]);
  }
}

// The bf16 operands of a C-lane call in one launch, grid-stride:
//   rows: dst_i[r, 0:w] = bf16(softmax(src_i[r]) * valid(r)) (w =
//         wide_lanes(S*K): the quarters that hold a live lane; i = 0, 1,
//         src1 may be null), one warp a row;
//   g:    H [nob, D, 128, w] for joint_bwd_wide (convert_g_wide; g may be
//         null).
template <bool UNIT_T, typename L>
__device__ __forceinline__ void wide_prep_rows(const L* src0, __nv_bfloat16* dst0, const L* src1,
                                               __nv_bfloat16* dst1, const Geometry& geo, int w,
                                               const WideScratch& ws, int lane) {
  const int t = geo.c / LANES;
  const long long rows = src1 ? 2 * geo.n : geo.n;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long u = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5); u < rows; u += step) {
    const bool second = u >= geo.n;
    const long long r = second ? u - geo.n : u;
    const bool valid = row_valid(r, geo, second);  // uniform across the warp
    if (valid) wide_softmax<true, UNIT_T>((second ? src1 : src0) + r * geo.c, geo, ws, lane);
    __nv_bfloat16* dst = (second ? dst1 : dst0) + r * w;
    for (int b = 0; b < t; ++b) {
      const int j = b * LANES + 4 * lane;
      if (j >= w) break;  // w is a multiple of 64: a lane's 4 are all in or all out
      const float4 x = valid ? *reinterpret_cast<const float4*>(ws.e + j)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<uint2*>(dst + j) = make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
    }
  }
}

template <typename L>
__global__ void __launch_bounds__(THREADS)
wide_prep(const L* __restrict__ src0, __nv_bfloat16* __restrict__ dst0, const L* __restrict__ src1,
          __nv_bfloat16* __restrict__ dst1, Geometry geo, int w, int nob,
          const float* __restrict__ g, __nv_bfloat16* __restrict__ h, int D, int transpose_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_groups(smem, geo);
  const int lane = threadIdx.x & 31;
  const WideScratch ws = wide_scratch(smem, geo, threadIdx.x >> 5, 3);
  if (geo.t == 1.f)
    wide_prep_rows<true>(src0, dst0, src1, dst1, geo, w, ws, lane);
  else
    wide_prep_rows<false>(src0, dst0, src1, dst1, geo, w, ws, lane);
  if (g == nullptr) return;
  convert_g_wide(blockIdx.x * (long long)blockDim.x + threadIdx.x,
                 (long long)gridDim.x * blockDim.x, g, h, geo.c, D, w, nob, transpose_g);
}

// d(own logits) of C-lane rows from the unmasked dq [N, C] fp32, one warp a
// row: the own row's probabilities formed again (wide_softmax), t = p * dq
// (rounded to bf16 before its group sum in bf16 mode), dl = (t - p * s) / T
// in the logits' type; 0 on dead lanes and on border rows.
template <bool BF16, bool UNIT_T, typename L>
__device__ __forceinline__ void wide_vjp_rows(const L* own, const float* dq, L* out,
                                              const Geometry& geo, const WideScratch& w,
                                              int lane) {
  const int t = geo.c / LANES;
  const long long step = (long long)gridDim.x * WARPS;
  for (long long r = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5); r < geo.n; r += step) {
    L* o = out + r * geo.c + 4 * lane;
    if (!row_valid(r, geo, 1)) {  // uniform across the warp
      for (int b = 0; b < t; ++b) store4(o + b * LANES, make_float4(0.f, 0.f, 0.f, 0.f));
      continue;
    }
    wide_softmax<BF16, UNIT_T>(own + r * geo.c, geo, w, lane);
    const float* q_row = dq + r * geo.c + 4 * lane;
    for (int b = 0; b < t; ++b) {
      const float4 p = *reinterpret_cast<const float4*>(w.e + b * LANES + 4 * lane);
      const float4 q = *reinterpret_cast<const float4*>(q_row + b * LANES);
      const float4 tv = make_float4(__fmul_rn(p.x, q.x), __fmul_rn(p.y, q.y),
                                    __fmul_rn(p.z, q.z), __fmul_rn(p.w, q.w));
      *reinterpret_cast<float4*>(w.r + b * LANES + 4 * lane) =
          BF16 ? make_float4(round_bf16(tv.x), round_bf16(tv.y), round_bf16(tv.z),
                             round_bf16(tv.w))
               : tv;
    }
    wide_group_sums(geo, w, lane);
    for (int b = 0; b < t; ++b) {
      const int j = b * LANES + 4 * lane;
      const float4 p = *reinterpret_cast<const float4*>(w.e + j);
      const float4 q = *reinterpret_cast<const float4*>(q_row + b * LANES);
      const float pi[4] = {p.x, p.y, p.z, p.w}, qi[4] = {q.x, q.y, q.z, q.w};
      float dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dl[i] = j + i < geo.sk
                    ? by_t<UNIT_T>(__fsub_rn(__fmul_rn(pi[i], qi[i]),
                                             __fmul_rn(pi[i], w.s[w.gidx[j + i]])), geo.t)
                    : 0.f;
      store4(o + b * LANES, make_float4(dl[0], dl[1], dl[2], dl[3]));
    }
  }
}

template <typename L, bool BF16>
__global__ void __launch_bounds__(THREADS)
wide_vjp(const L* __restrict__ own, const float* __restrict__ dq, L* __restrict__ out,
         Geometry geo) {
  extern __shared__ __align__(16) unsigned char smem[];
  init_groups(smem, geo);
  const WideScratch w = wide_scratch(smem, geo, threadIdx.x >> 5, 3);
  if (geo.t == 1.f)
    wide_vjp_rows<BF16, true>(own, dq, out, geo, w, threadIdx.x & 31);
  else
    wide_vjp_rows<BF16, false>(own, dq, out, geo, w, threadIdx.x & 31);
}

// ===========================================================================
// fp32 parity mode: CUDA-core FMAs, synchronous staging, each staged row's
// whole-row softmax formed while staging it (not on the training path)
// ===========================================================================

// One warp stages tall row `row` of operand `op`'s logits l as masked fp32
// probabilities: this lane's 4 of lanes [128 b, 128 b + 128) of the row's
// softmax into dst (zeros where the row is invalid or not `live`).
__device__ __forceinline__ void stage_row(const float* __restrict__ l, long long row, bool live,
                                          int op, int b, const Geometry& g,
                                          const WideScratch& w, int lane, float* dst) {
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && row_valid(row, g, op)) {  // uniform across the warp
    wide_softmax<false, false>(l + row * g.c, g, w, lane);
    q = *reinterpret_cast<const float4*>(w.e + b * LANES + 4 * lane);
  }
  *reinterpret_cast<float4*>(dst) = q;
}

// partial[chunk, d, 128 bi + k1, 128 bj + k2] = sum over the chunk's rows n of
// pm1[n + o_d, 128 bi + k1] * pm2[n, 128 bj + k2]; grid (D t^2, n_chunks),
// blockIdx.x = d + D (bi t + bj), THREADS threads, dynamic shared memory
// fp32_fwd_smem(C)
constexpr size_t FP32_FWD_TILES = 2 * (size_t)KT * LD * 4;
__host__ __device__ constexpr size_t fp32_fwd_smem(int c) {
  return FP32_FWD_TILES + wide_smem_bytes(c, 2);
}

__global__ void __launch_bounds__(THREADS)
fused_fwd_partial_fp32(const float* __restrict__ l1, const float* __restrict__ l2,
                       float* __restrict__ partial, Geometry geo, long long rows_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  float(*As)[LD] = reinterpret_cast<float(*)[LD]>(smem);  // As[kk][m] = pm1[n0 + kk + o, m]
  float(*Bs)[LD] = As + KT;                                // Bs[kk][j] = pm2[n0 + kk, j]
  init_groups(smem + FP32_FWD_TILES, geo);

  const int t = geo.c / LANES;
  const int D = gridDim.x / (t * t);
  const int d = blockIdx.x % D;
  const int bi = blockIdx.x / D / t, bj = blockIdx.x / D % t;
  const int chunk = blockIdx.y;
  const int T = 2 * geo.p + 1;
  const long long o = (long long)(d / T - geo.p) * geo.wp + (d % T - geo.p);
  const long long n_begin = (long long)chunk * rows_per_chunk;
  const long long n_end = min(geo.n, n_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const WideScratch w = wide_scratch(smem + FP32_FWD_TILES, geo, warp, 2);
  // thread (ty, tx) owns rows ty + 16*i, cols tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float facc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  for (long long n0 = n_begin; n0 < n_end; n0 += KT) {
    // stage: rows r < KT are the shifted l1 rows, the rest the l2 rows
    for (int r = warp; r < 2 * KT; r += WARPS) {
      const int kk = r % KT;
      const long long n = n0 + kk;
      if (r < KT)
        stage_row(l1, n + o, n < n_end, 0, bi, geo, w, lane, &As[kk][lane * 4]);
      else
        stage_row(l2, n, n < n_end, 1, bj, geo, w, lane, &Bs[kk][lane * 4]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KT; ++kk) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
    }
    __syncthreads();
  }

  const long long c = geo.c;
  float* out = partial + ((long long)chunk * D + d) * c * c + (long long)bi * LANES * c + bj * LANES;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[(ty + 16 * i) * c + tx + 16 * j] = facc[i][j];
}

// lanes [128 bj, 128 bj + 128) of the own rows n of the block (bj =
// blockIdx.y), before the mask:
//   dq[n, j] = sum_d sum_k pm_src[n + sign*o_d, k] * G_d[k, j]
//   G_d = g[d] (TRANSPOSE = false) or g[d]^T (TRANSPOSE = true)
// summed over the source's lane blocks in turn; grid (ceil(N / ROWS), t),
// THREADS threads, dynamic shared memory fp32_bwd_smem(C)
constexpr size_t FP32_BWD_TILES = 2 * (size_t)ROWS * LD * 4;
__host__ __device__ constexpr size_t fp32_bwd_smem(int c) {
  return FP32_BWD_TILES + wide_smem_bytes(c, 2);
}

template <bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
fused_dq_fp32(const float* __restrict__ src, const float* __restrict__ g, float* __restrict__ dq,
              Geometry geo, int sign) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);  // Ss[m][k] = pm_src[n0 + m + sign*o, 128 bi + k]
  float* Gs = Ss + ROWS * LD;                  // Gs[r][c]: the (bi, bj) block of G_d (or G_d^T)
  init_groups(smem + FP32_BWD_TILES, geo);

  const long long c = geo.c;
  const int t = geo.c / LANES;
  const int bj = blockIdx.y;
  const long long n0 = (long long)blockIdx.x * ROWS;
  const int T = 2 * geo.p + 1;
  const int D = T * T;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const WideScratch w = wide_scratch(smem + FP32_BWD_TILES, geo, warp, 2);
  const int ty = tid / 16, tx = tid % 16;
  float facc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  for (int d = 0; d < D; ++d) {
    const long long o = sign * ((long long)(d / T - geo.p) * geo.wp + (d % T - geo.p));
    const float* gd = g + (long long)d * c * c;
    for (int bi = 0; bi < t; ++bi) {
      for (int r = warp; r < ROWS; r += WARPS)
        stage_row(src, n0 + r + o, true, 0, bi, geo, w, lane, Ss + r * LD + lane * 4);
      for (int idx = tid; idx < LANES * LANES / 4; idx += THREADS) {
        const int r = idx / (LANES / 4), c4 = idx % (LANES / 4) * 4;
        const float* s = TRANSPOSE ? gd + (bj * LANES + r) * c + bi * LANES + c4
                                   : gd + (bi * LANES + r) * c + bj * LANES + c4;
        *reinterpret_cast<float4*>(Gs + r * LD + c4) = *reinterpret_cast<const float4*>(s);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < LANES; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = Ss[(ty + 16 * i) * LD + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = TRANSPOSE ? Gs[(tx + 16 * j) * LD + kk] : Gs[kk * LD + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long n = n0 + ty + 16 * i;
    if (n >= geo.n) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) dq[n * c + bj * LANES + tx + 16 * j] = facc[i][j];
  }
}

// ===========================================================================
// host side
// ===========================================================================

Geometry make_geometry(long long n_rows, int c, int hp, int wp, int p, int s, int k, float t,
                       int lo0, int hi0, int lo1, int hi1) {
  Geometry geo;
  geo.lo0 = lo0;
  geo.hi0 = hi0;
  geo.lo1 = lo1;
  geo.hi1 = hi1;
  geo.n = n_rows;
  geo.c = c;
  geo.hp = hp;
  geo.wp = wp;
  geo.p = p;
  geo.sk = s * k;
  geo.k = k;
  geo.t = t;
  return geo;
}

bool lanes_ok(int c) { return c % LANES == 0 && c >= LANES && c <= MAX_BLOCKS * LANES; }

// each window a non-empty range of a canvas's rows
bool windows_ok(int hp, int lo0, int hi0, int lo1, int hi1) {
  return 0 <= lo0 && lo0 < hi0 && hi0 <= hp && 0 <= lo1 && lo1 < hi1 && hi1 <= hp;
}

// blocks of a whole-row kernel: a warp a row, and enough threads for the
// units of H; at most 8192 (grid-stride beyond)
unsigned wide_blocks(long long rows, long long units_g) {
  const long long for_rows = (rows + WARPS - 1) / WARPS;
  const long long for_g = (units_g + THREADS - 1) / THREADS;
  const long long want = for_rows > for_g ? for_rows : for_g;
  return (unsigned)(want < 1 ? 1 : want < 8192 ? want : 8192);
}

template <typename L>
cudaError_t launch_wide_prep(const L* src0, __nv_bfloat16* dst0, const L* src1,
                             __nv_bfloat16* dst1, const Geometry& geo, const float* g,
                             __nv_bfloat16* h, int D, int transpose_g, cudaStream_t st) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(wide_prep<L>, smem_set);
  if (err != cudaSuccess) return err;
  const int w = wide_lanes(geo.sk), nob = wide_out_blocks(geo.sk);
  const unsigned blocks = wide_blocks(src1 ? 2 * geo.n : geo.n, g ? h_units_wide(D, w, nob) : 0);
  wide_prep<L><<<blocks, THREADS, wide_smem_bytes(geo.c, 3), st>>>(
      src0, dst0, src1, dst1, geo, w, nob, g, h, D, transpose_g);
  return cudaGetLastError();
}

template <typename L, bool BF16>
cudaError_t launch_wide_vjp(const L* own, const float* dq, L* out, const Geometry& geo,
                            cudaStream_t st) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(wide_vjp<L, BF16>, smem_set);
  if (err != cudaSuccess) return err;
  wide_vjp<L, BF16><<<wide_blocks(geo.n, 0), THREADS, wide_smem_bytes(geo.c, 3), st>>>(
      own, dq, out, geo);
  return cudaGetLastError();
}

template <bool TRANSPOSE>
cudaError_t launch_dq_fp32(const float* src, const float* g, float* dq, const Geometry& geo,
                           cudaStream_t st) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(fused_dq_fp32<TRANSPOSE>, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((geo.n + ROWS - 1) / ROWS), (unsigned)(geo.c / LANES));
  fused_dq_fp32<TRANSPOSE><<<grid, THREADS, fp32_bwd_smem(geo.c), st>>>(src, g, dq, geo,
                                                                        TRANSPOSE ? -1 : 1);
  return cudaGetLastError();
}

// Logits [N, C], C = 128 t (t <= MAX_BLOCKS), fp32 (rows of 4 C bytes) or bf16
// (the *_bf16in entry points: 2 C bytes, dead lanes -inf), pointers 16-byte
// aligned. lo0, hi0 / lo1, hi1: the live rows of operand 0's / 1's canvases
// (forward: l1 / l2; backward: src / own). The bf16 entry points take the
// joint's launch plan at 128 lanes (t = 1), or its wide plan for S*K live
// lanes (ops/mi_joint.py:wide_plan; t > 1). Every entry point refuses
// (cudaErrorInvalidValue) a plan that disagrees with the kernels, a lane
// count that is no such C, or a window that is empty or leaves [0, Hp).

// bf16 products: J[D, C, C] from logits l1, l2. a16, b16: bf16 scratch of
// N x 128 (t = 1) or N x W (W = wide_lanes(S*K)); partial: scratch of
// n_chunks x D x 128 x 128 (t = 1) or x W x W floats.
template <typename L>
int fused_fwd_bf16(const L* l1, const L* l2, void* a16, void* b16, float* partial, float* out,
                   long long n_rows, int c, int hp, int wp, int p, int s, int k, float t,
                   int lo0, int hi0, int lo1, int hi1, long long rows_per_chunk, int n_chunks,
                   int dx_group, int smem_bytes, void* stream) {
  const int w = wide_lanes(s * k);
  if (!lanes_ok(c) || !windows_ok(hp, lo0, hi0, lo1, hi1) || s < 1 || k < 1 || s * k > c ||
      !(c == LANES ? fwd_plan_ok(LANES, p, dx_group, smem_bytes)
                   : wide_fwd_plan_ok(s * k, w, p, dx_group, smem_bytes)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* A16 = static_cast<__nv_bfloat16*>(a16);
  auto* B16 = static_cast<__nv_bfloat16*>(b16);
  const Geometry geo = make_geometry(n_rows, c, hp, wp, p, s, k, t, lo0, hi0, lo1, hi1);
  if (c == LANES) {
    const SoftmaxRows<L> rows{l1, A16, l2, B16, geo};
    joint_prep<<<softmax_prep_blocks(2 * n_rows, 0), PREP_THREADS, 0, st>>>(rows, nullptr,
                                                                           nullptr, C, 0, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)run_fwd(dx_group, n_chunks, smem_bytes, st, A16, B16, partial, out, n_rows, C, p,
                        wp, rows_per_chunk);
  }
  const cudaError_t err = launch_wide_prep(l1, A16, l2, B16, geo, nullptr, nullptr, 0, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)run_fwd_wide(dx_group, n_chunks, smem_bytes, st, A16, B16, partial, out, n_rows, c,
                           p, wp, w, rows_per_chunk);
}

// bf16 products: d(own logits) [N, C] in the logits' type: transpose_g = 0
// gives dl2 (src = l1, own = l2), transpose_g = 1 gives dl1 (src = l2, own =
// l1); g [D, C, C] fp32. t = 1: s16 scratch of N x 128 bf16 (pm of src), h16
// of D x 128 x 128 bf16, dq null, `slabs` unused. t > 1: s16 of N x W, h16 of
// ceil(S*K / 128) x D x 128 x W, dq of N x C floats, `slabs` source slab
// buffers of joint_bwd_wide.
template <typename L>
int fused_bwd_bf16(const L* src, const L* own, const float* g, void* s16, void* h16, float* dq,
                   L* out, long long n_rows, int c, int hp, int wp, int p, int s, int k, float t,
                   int lo0, int hi0, int lo1, int hi1, int transpose_g, int stages, int slabs,
                   int smem_bytes, void* stream) {
  if (!lanes_ok(c) || !windows_ok(hp, lo0, hi0, lo1, hi1) || s < 1 || k < 1 || s * k > c ||
      !(c == LANES ? bwd_plan_ok(LANES, p, stages, smem_bytes)
                   : dq != nullptr && wide_bwd_plan_ok(p, stages, slabs, smem_bytes)))
    return (int)cudaErrorInvalidValue;
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  const Geometry geo = make_geometry(n_rows, c, hp, wp, p, s, k, t, lo0, hi0, lo1, hi1);
  if (c == LANES) {
    const SoftmaxRows<L> rows{src, S16, nullptr, nullptr, geo};
    joint_prep<<<softmax_prep_blocks(n_rows, h_units(D)), PREP_THREADS, 0, st>>>(
        rows, g, H16, C, D, transpose_g);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)run_bwd(stages, n_rows, p, wp, smem_bytes, st, S16, H16,
                        VjpRows<L>{own, out, geo});
  }
  // dq of the live output blocks in one product, then one VJP pass over
  // whole rows (its group sums straddle the blocks)
  const int w = wide_lanes(s * k), nob = wide_out_blocks(s * k);
  cudaError_t err = launch_wide_prep<L>(src, S16, nullptr, nullptr, geo, g, H16, D, transpose_g,
                                        st);
  if (err == cudaSuccess)
    err = run_bwd_wide(stages, n_rows, p, wp, w, nob, slabs, smem_bytes, st, S16, H16,
                       StoreWide<float>{dq, c, nob * LANES});
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wide_vjp<L, true>(own, dq, out, geo, st);
}

}  // namespace

extern "C" {

const char* mi_fused_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// fp32 logits
int mi_fused_fwd_bf16(const float* l1, const float* l2, void* a16, void* b16, float* partial,
                      float* out, long long n_rows, int c, int hp, int wp, int p, int s, int k,
                      float t, int lo0, int hi0, int lo1, int hi1, long long rows_per_chunk,
                      int n_chunks, int dx_group, int smem_bytes, void* stream) {
  return fused_fwd_bf16(l1, l2, a16, b16, partial, out, n_rows, c, hp, wp, p, s, k, t, lo0, hi0,
                        lo1, hi1, rows_per_chunk, n_chunks, dx_group, smem_bytes, stream);
}

int mi_fused_bwd_bf16(const float* src, const float* own, const float* g, void* s16, void* h16,
                      float* dq, float* out, long long n_rows, int c, int hp, int wp, int p,
                      int s, int k, float t, int lo0, int hi0, int lo1, int hi1, int transpose_g,
                      int stages, int slabs, int smem_bytes, void* stream) {
  return fused_bwd_bf16(src, own, g, s16, h16, dq, out, n_rows, c, hp, wp, p, s, k, t, lo0, hi0,
                        lo1, hi1, transpose_g, stages, slabs, smem_bytes, stream);
}

// bf16 logits (Precision.compute_dtype=bfloat16): the same, reading 8 bytes
// of 4 logits a lane; d(logits) are written as bf16
int mi_fused_fwd_bf16in(const void* l1, const void* l2, void* a16, void* b16, float* partial,
                        float* out, long long n_rows, int c, int hp, int wp, int p, int s, int k,
                        float t, int lo0, int hi0, int lo1, int hi1, long long rows_per_chunk,
                        int n_chunks, int dx_group, int smem_bytes, void* stream) {
  return fused_fwd_bf16(static_cast<const __nv_bfloat16*>(l1),
                        static_cast<const __nv_bfloat16*>(l2), a16, b16, partial, out, n_rows,
                        c, hp, wp, p, s, k, t, lo0, hi0, lo1, hi1, rows_per_chunk, n_chunks,
                        dx_group, smem_bytes, stream);
}

int mi_fused_bwd_bf16in(const void* src, const void* own, const float* g, void* s16, void* h16,
                        float* dq, void* out, long long n_rows, int c, int hp, int wp, int p,
                        int s, int k, float t, int lo0, int hi0, int lo1, int hi1,
                        int transpose_g, int stages, int slabs, int smem_bytes, void* stream) {
  return fused_bwd_bf16(static_cast<const __nv_bfloat16*>(src),
                        static_cast<const __nv_bfloat16*>(own), g, s16, h16, dq,
                        static_cast<__nv_bfloat16*>(out), n_rows, c, hp, wp, p, s, k, t, lo0,
                        hi0, lo1, hi1, transpose_g, stages, slabs, smem_bytes, stream);
}

// fp32 parity mode: J[D, C, C] from logits l1, l2; partial is scratch of
// n_chunks * D * C * C floats.
int mi_fused_fwd_fp32(const float* l1, const float* l2, float* partial, float* out,
                      long long n_rows, int c, int hp, int wp, int p, int s, int k, float t,
                      int lo0, int hi0, int lo1, int hi1, long long rows_per_chunk, int n_chunks,
                      void* stream) {
  if (!lanes_ok(c) || !windows_ok(hp, lo0, hi0, lo1, hi1)) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;
  cudaError_t err = allow_smem(fused_fwd_partial_fp32, smem_set);
  if (err != cudaSuccess) return (int)err;
  const Geometry geo = make_geometry(n_rows, c, hp, wp, p, s, k, t, lo0, hi0, lo1, hi1);
  const int T = 2 * p + 1;
  const int D = T * T;
  const int blocks = c / LANES;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  fused_fwd_partial_fp32<<<dim3(D * blocks * blocks, n_chunks), THREADS, fp32_fwd_smem(c), st>>>(
      l1, l2, partial, geo, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_fwd_reduce<false><<<reduce_blocks((long long)D * c * c), 256, 0, st>>>(partial, out, D, c,
                                                                              c, n_chunks);
  return (int)cudaGetLastError();
}

// fp32 parity mode: d(own logits) [N, C], as mi_fused_bwd_bf16; dq is
// scratch of N x C floats.
int mi_fused_bwd_fp32(const float* src, const float* own, const float* g, float* dq, float* out,
                      long long n_rows, int c, int hp, int wp, int p, int s, int k, float t,
                      int lo0, int hi0, int lo1, int hi1, int transpose_g, void* stream) {
  if (!lanes_ok(c) || !windows_ok(hp, lo0, hi0, lo1, hi1)) return (int)cudaErrorInvalidValue;
  const Geometry geo = make_geometry(n_rows, c, hp, wp, p, s, k, t, lo0, hi0, lo1, hi1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = transpose_g ? launch_dq_fp32<true>(src, g, dq, geo, st)
                                      : launch_dq_fp32<false>(src, g, dq, geo, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_wide_vjp<float, false>(own, dq, out, geo, st);
}

}  // extern "C"
