// Fused displaced-MI joint from logits: the row's group softmax, the interior
// mask and the displaced joint in one pass, and the two backward products
// with the softmax VJP, for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/mi_fused.py (Kernel.backend=pallas_fused):
//   * _fused_fwd / _fwd_kernel                    -> fused_fwd_partial + fused_fwd_reduce
//   * _fused_bwd / _bwd_kernel (dl2)              -> fused_bwd, sign +1, g as is
//   * _fused_bwd / _bwd_kernel (dl1, transpose_g) -> fused_bwd, sign -1, g transposed
//
// What is computed. l1, l2 are [N, 128] fp32 logits: the row-major
// flattening of [B, Hp, Wp, 128] canvases with a border of width p; lanes
// from S*K on are dead. For a row n:
//   valid(n) = 0 <= n < N and (y, x) of n lies in [p, Hp - p) x [p, Wp - p)
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
//   dl = (t - p * s) / T, and 0 on dead lanes
// Products are accumulated in fp32; the fp32 operand mode is the parity mode.
//
// What bounds it on an H100 (989 TF/s dense bf16, 3.35 TB/s HBM). Each launch
// does the products of the matching mi_joint launch: at the headline Up_conv2
// tap (N = 529,000, p = 3, 49 displacements) 2*N*128*128*49 = 8.5e11 flops
// against ~0.27 GB of logits read and J (or d(logits)) written, so the work is
// bound by operations (0.86 ms). At Up_conv3 (N = 129,960, p = 1) the bytes
// bound it (~0.04-0.06 ms). The 2*N*128 exps that the function needs are far
// below either bound.
//
// What the design does about it. Probabilities never go to device memory:
// each kernel reads logits and forms the masked probabilities while staging
// them into shared memory, one warp per 128-lane row (max by shuffles, the
// group sums over a per-warp row of shared memory), then runs the products of
// csrc/mi_joint.cu on the tensor cores (WMMA 16x16x16 bf16; CUDA-core FMAs in
// fp32 mode). The forward is the split-K product per displacement: block
// (d, chunk) stages 32-row slices of the shifted l1 and of l2, keeps the
// 128x128 tile in registers and writes a partial tile; a second pass sums the
// chunks in a fixed order. The backward gives each block 128 own rows: it
// walks the displacements, staging the 128 full source rows as probabilities
// and g[d] as stored (the transposed read is a column-major fragment load),
// then moves the fp32 accumulators to shared memory, recomputes its own rows'
// probabilities and applies the mask and the softmax VJP. The simple price:
// the forward recomputes each row's softmax once per displacement (about
// 49 x 2 x N rows at Up_conv2); staging per dy and looping over dx would cut
// that 7x.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int C = 128;        // lanes per row: the head's lane width
constexpr int KT = 32;        // rows per staged slice in the forward
constexpr int ROWS = 128;     // own rows per block in the backward
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int PAD_H = 8;      // bf16 row padding (16 bytes)
constexpr int PAD_F = 4;      // fp32 row padding (16 bytes)
constexpr int LDQ = C + PAD_F;

struct Geometry {
  long long n;  // rows of the flattened canvas
  int hp, wp, p;
  int sk, k;    // live lanes (S*K), lanes per group (K)
  float t;      // temperature
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 4 values to shared memory as the operand type (bf16 bits or fp32).
template <bool BF16>
__device__ __forceinline__ void store4(void* dst, float4 v) {
  if constexpr (BF16) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
  } else {
    *reinterpret_cast<float4*>(dst) = v;
  }
}

// Interior row of the canvas (the conv zero-padding semantics); rows outside
// [0, N) are invalid, never clamped. The row index is 64-bit; the division
// runs in 32 bits when N allows it (64-bit division is emulated).
__device__ __forceinline__ bool row_valid(long long n, const Geometry& g) {
  if (n < 0 || n >= g.n) return false;
  const unsigned hw = (unsigned)g.hp * (unsigned)g.wp;
  const unsigned rem = g.n <= 0xffffffffLL ? (unsigned)n % hw : (unsigned)(n % (long long)hw);
  const int y = (int)(rem / (unsigned)g.wp);
  const int x = (int)rem - y * g.wp;
  return y >= g.p && y < g.hp - g.p && x >= g.p && x < g.wp - g.p;
}

// For this thread's lanes j0..j0+3: the sum of each live lane's group over
// the warp's 128-float row `row` (written and synced by the caller), in fp32
// with four running sums; 0 on dead lanes.
__device__ __forceinline__ void group_sums(const float* row, int j0, const Geometry& g,
                                           float out[4]) {
  int cur = -1;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + i;
    out[i] = 0.f;
    if (j < g.sk) {
      const int grp = j / g.k;
      if (grp != cur) {
        cur = grp;
        const int end = grp * g.k + g.k;
        int q = grp * g.k;
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (; q + 3 < end; q += 4) {
          s0 += row[q];
          s1 += row[q + 1];
          s2 += row[q + 2];
          s3 += row[q + 3];
        }
        for (; q < end; ++q) s0 += row[q];
        sum = (s0 + s1) + (s2 + s3);
      }
      out[i] = sum;
    }
  }
}

// Unmasked probabilities of one row, lanes 4*lane..4*lane+3 (the whole warp
// calls it on the same row). scratch: the warp's 128 floats.
template <bool BF16>
__device__ __forceinline__ float4 row_softmax(float4 v, int lane, const Geometry& g,
                                              float* scratch) {
  const int j0 = lane * 4;
  float z[4] = {v.x, v.y, v.z, v.w};
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    z[i] = (j0 + i < g.sk) ? z[i] / g.t : -INFINITY;
    m = fmaxf(m, z[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  float e[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    e[i] = (j0 + i < g.sk) ? expf(z[i] - m) : 0.f;
    scratch[j0 + i] = BF16 ? round_bf16(e[i]) : e[i];
  }
  __syncwarp();
  float den[4];
  group_sums(scratch, j0, g, den);
  __syncwarp();  // the caller's next row rewrites scratch
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = (j0 + i < g.sk) ? e[i] / (den[i] + 1e-16f) : 0.f;
  return make_float4(p[0], p[1], p[2], p[3]);
}

// d(logits) of one row from its probabilities p and masked upstream dq.
// Multiplies and subtractions are rounded one by one (no FMA contraction),
// as the plain version computes them.
template <bool BF16>
__device__ __forceinline__ float4 row_softmax_vjp(float4 pv, float4 qv, int lane,
                                                  const Geometry& g, float* scratch) {
  const int j0 = lane * 4;
  const float p[4] = {pv.x, pv.y, pv.z, pv.w};
  const float q[4] = {qv.x, qv.y, qv.z, qv.w};
  float t[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[i] = __fmul_rn(p[i], q[i]);
    scratch[j0 + i] = BF16 ? round_bf16(t[i]) : t[i];
  }
  __syncwarp();
  float s[4];
  group_sums(scratch, j0, g, s);
  __syncwarp();
  float dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    dl[i] = (j0 + i < g.sk) ? __fsub_rn(t[i], __fmul_rn(p[i], s[i])) / g.t : 0.f;
  return make_float4(dl[0], dl[1], dl[2], dl[3]);
}

// One warp stages tall row `row` of logits l as masked probabilities into the
// 128-lane shared row dst (zeros where the row is invalid or not `live`).
// (Issuing a warp's 8 row loads at once raised the registers from 128 to 177
// and cut the blocks per SM from 2 to 1, which made both kernels slower.)
template <bool BF16>
__device__ __forceinline__ void stage_row(const float* __restrict__ l, long long row, bool live,
                                          const Geometry& g, int lane, float* scratch, void* dst) {
  float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && row_valid(row, g)) {  // uniform across the warp
    const float4 v = reinterpret_cast<const float4*>(l + row * C)[lane];
    q = row_softmax<BF16>(v, lane, g, scratch);
  }
  store4<BF16>(dst, q);
}

// ---------------------------------------------------------------------------
// forward: partial[chunk, d, k1, k2] = sum over the chunk's rows n of
//          pm1[n + o_d, k1] * pm2[n, k2]
// grid (D, n_chunks), THREADS threads
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_fwd_partial(const float* __restrict__ l1, const float* __restrict__ l2,
                  float* __restrict__ partial, Geometry geo, long long rows_per_chunk) {
  constexpr int LD = BF16 ? C + PAD_H : C + PAD_F;
  using Elem = typename std::conditional<BF16, unsigned short, float>::type;
  __shared__ __align__(128) Elem As[KT][LD];  // As[kk][m] = pm1[n0 + kk + o, m]
  __shared__ __align__(128) Elem Bs[KT][LD];  // Bs[kk][j] = pm2[n0 + kk, j]
  __shared__ __align__(16) float scratch[WARPS][C];

  const int D = gridDim.x;
  const int d = blockIdx.x;
  const int chunk = blockIdx.y;
  const int T = 2 * geo.p + 1;
  const long long o = (long long)(d / T - geo.p) * geo.wp + (d % T - geo.p);
  const long long n_begin = (long long)chunk * rows_per_chunk;
  const long long n_end = min(geo.n, n_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;

  // BF16: warp w owns rows [wm*32, +32) x cols [wn*64, +64) as 2x4 fragments.
  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  // FP32: thread (ty, tx) owns rows ty + 16*i, cols tx + 16*j.
  const int ty = tid / 16, tx = tid % 16;
  float facc[BF16 ? 1 : 8][BF16 ? 1 : 8];
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }

  for (long long n0 = n_begin; n0 < n_end; n0 += KT) {
    // stage: rows r < KT are the shifted l1 rows, the rest the l2 rows
    for (int r = warp; r < 2 * KT; r += WARPS) {
      const int kk = r % KT;
      const long long n = n0 + kk;
      if (r < KT)
        stage_row<BF16>(l1, n + o, n < n_end, geo, lane, scratch[warp], &As[kk][lane * 4]);
      else
        stage_row<BF16>(l2, n, n < n_end, geo, lane, scratch[warp], &Bs[kk][lane * 4]);
    }
    __syncthreads();
    if constexpr (BF16) {
#pragma unroll
      for (int kk = 0; kk < KT; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], reinterpret_cast<const __nv_bfloat16*>(&As[kk][wm * 32 + i * 16]), LD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::load_matrix_sync(fb[j], reinterpret_cast<const __nv_bfloat16*>(&Bs[kk][wn * 64 + j * 16]), LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
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
    }
    __syncthreads();
  }

  float* out = partial + ((long long)chunk * D + d) * (long long)C * C;
  if constexpr (BF16) {
    // Each warp writes its fragments through a 16x16 staging area in its own
    // slice of As (8 x 1 KB; the operand tiles are no longer needed).
    float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = wm * 32 + i * 16 + e / 16;
          const int c = wn * 64 + j * 16 + e % 16;
          out[r * C + c] = stage[e];
        }
        __syncwarp();
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) out[(ty + 16 * i) * C + tx + 16 * j] = facc[i][j];
  }
}

// out[e] = sum_chunk partial[chunk, e], e over D*C*C, in chunk order
__global__ void fused_fwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                 long long per_chunk, int n_chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per_chunk;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partial[(long long)k * per_chunk + e];
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// backward: for own rows n of the block,
//   dq[n, j] = valid_own(n) * sum_d sum_k pm_src[n + sign*o_d, k] * G_d[k, j]
//   G_d = g[d] (TRANSPOSE = false) or g[d]^T (TRANSPOSE = true)
//   out[n] = softmax VJP of the own row's probabilities at dq
// grid (ceil(N / ROWS)), THREADS threads, dynamic shared memory (bwd_smem)
// ---------------------------------------------------------------------------
template <bool BF16>
__host__ __device__ constexpr int bwd_ld() { return BF16 ? C + PAD_H : C + PAD_F; }

template <bool BF16>
__host__ __device__ constexpr size_t bwd_smem() {
  // source rows + g[d] (the fp32 dq tile reuses them) + the warps' scratch rows
  return 2 * (size_t)ROWS * bwd_ld<BF16>() * (BF16 ? 2 : 4) + (size_t)WARPS * C * 4;
}

template <bool BF16, bool TRANSPOSE>
__global__ void __launch_bounds__(THREADS)
fused_bwd(const float* __restrict__ src, const float* __restrict__ own,
          const float* __restrict__ g, float* __restrict__ out, Geometry geo, int sign) {
  constexpr int LD = bwd_ld<BF16>();
  using Elem = typename std::conditional<BF16, unsigned short, float>::type;
  static_assert(2 * ROWS * LD * sizeof(Elem) >= ROWS * LDQ * sizeof(float),
                "the dq tile must fit in the operand buffers");
  extern __shared__ __align__(128) unsigned char smem[];
  Elem* Ss = reinterpret_cast<Elem*>(smem);  // Ss[m][k] = pm_src[n0 + m + sign*o, k]
  Elem* Gs = Ss + ROWS * LD;                 // Gs[r][c] = g[d][r][c]
  float* dq = reinterpret_cast<float*>(smem);  // [ROWS][LDQ], after the loop
  float* scratch = reinterpret_cast<float*>(smem + 2 * ROWS * LD * sizeof(Elem));

  const long long n0 = (long long)blockIdx.x * ROWS;
  const int T = 2 * geo.p + 1;
  const int D = T * T;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  float* wscratch = scratch + warp * C;

  const int wm = warp / 2, wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
  const int ty = tid / 16, tx = tid % 16;
  float facc[BF16 ? 1 : 8][BF16 ? 1 : 8];
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;
  }

  for (int d = 0; d < D; ++d) {
    const long long o = sign * ((long long)(d / T - geo.p) * geo.wp + (d % T - geo.p));
    for (int r = warp; r < ROWS; r += WARPS)
      stage_row<BF16>(src, n0 + r + o, true, geo, lane, wscratch, Ss + r * LD + lane * 4);
    const float4* gd = reinterpret_cast<const float4*>(g + (long long)d * C * C);
    for (int idx = tid; idx < C * C / 4; idx += THREADS)
      store4<BF16>(Gs + (idx / (C / 4)) * LD + (idx % (C / 4)) * 4, gd[idx]);
    __syncthreads();
    if constexpr (BF16) {
      using BLayout = typename std::conditional<TRANSPOSE, wmma::col_major, wmma::row_major>::type;
      const __nv_bfloat16* sb = reinterpret_cast<const __nv_bfloat16*>(Ss);
      const __nv_bfloat16* gb = reinterpret_cast<const __nv_bfloat16*>(Gs);
#pragma unroll 2
      for (int kk = 0; kk < C; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], sb + (wm * 32 + i * 16) * LD + kk, LD);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn * 64 + j * 16;
          // B[k][j] = g[d][k][j] (row-major) or g[d][j][k] (column-major)
          wmma::load_matrix_sync(fb[j], TRANSPOSE ? gb + col * LD + kk : gb + kk * LD + col, LD);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < C; ++kk) {
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
    }
    __syncthreads();
  }

  // the fp32 accumulators to shared memory (over the operand buffers)
  if constexpr (BF16) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(dq + (wm * 32 + i * 16) * LDQ + wn * 64 + j * 16, acc[i][j], LDQ,
                                wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dq[(ty + 16 * i) * LDQ + tx + 16 * j] = facc[i][j];
  }
  __syncthreads();

  // own rows: probabilities from the logits again, the mask, the softmax VJP
  for (int r = warp; r < ROWS; r += WARPS) {
    const long long n = n0 + r;
    if (n >= geo.n) break;  // uniform across the warp; later rows are out too
    float4 res = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row_valid(n, geo)) {  // an invalid row has dq = 0, hence dl = 0
      const float4 v = reinterpret_cast<const float4*>(own + n * C)[lane];
      const float4 pv = row_softmax<BF16>(v, lane, geo, wscratch);
      const float4 qv = reinterpret_cast<const float4*>(dq + r * LDQ)[lane];
      res = row_softmax_vjp<BF16>(pv, qv, lane, geo, wscratch);
    }
    reinterpret_cast<float4*>(out + n * C)[lane] = res;
  }
}

template <bool BF16, bool TRANSPOSE>
cudaError_t launch_bwd(const float* src, const float* own, const float* g, float* out,
                       const Geometry& geo, cudaStream_t s) {
  constexpr size_t bytes = bwd_smem<BF16>();
  cudaError_t err = cudaFuncSetAttribute(fused_bwd<BF16, TRANSPOSE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((geo.n + ROWS - 1) / ROWS));
  fused_bwd<BF16, TRANSPOSE><<<grid, THREADS, bytes, s>>>(src, own, g, out, geo,
                                                          TRANSPOSE ? -1 : 1);
  return cudaGetLastError();
}

Geometry make_geometry(long long n_rows, int hp, int wp, int p, int s, int k, float t) {
  Geometry geo;
  geo.n = n_rows;
  geo.hp = hp;
  geo.wp = wp;
  geo.p = p;
  geo.sk = s * k;
  geo.k = k;
  geo.t = t;
  return geo;
}

}  // namespace

extern "C" {

const char* mi_fused_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// J[D, 128, 128] from logits l1, l2 [N, 128]; partial is scratch of
// n_chunks * D * 128 * 128 floats. Rows of 512 bytes, pointers 16-byte aligned.
int mi_fused_fwd(const float* l1, const float* l2, float* partial, float* out, long long n_rows,
                 int hp, int wp, int p, int s, int k, float t, long long rows_per_chunk,
                 int n_chunks, int bf16, void* stream) {
  const Geometry geo = make_geometry(n_rows, hp, wp, p, s, k, t);
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(D, n_chunks);
  if (bf16)
    fused_fwd_partial<true><<<grid, THREADS, 0, st>>>(l1, l2, partial, geo, rows_per_chunk);
  else
    fused_fwd_partial<false><<<grid, THREADS, 0, st>>>(l1, l2, partial, geo, rows_per_chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_chunk = (long long)D * C * C;
  const int blocks = (int)((per_chunk + 255) / 256);
  fused_fwd_reduce<<<blocks, 256, 0, st>>>(partial, out, per_chunk, n_chunks);
  return (int)cudaGetLastError();
}

// d(own logits) [N, 128]: transpose_g = 0 gives dl2 (src = l1, own = l2),
// transpose_g = 1 gives dl1 (src = l2, own = l1); g [D, 128, 128].
int mi_fused_bwd(const float* src, const float* own, const float* g, float* out,
                 long long n_rows, int hp, int wp, int p, int s, int k, float t, int transpose_g,
                 int bf16, void* stream) {
  const Geometry geo = make_geometry(n_rows, hp, wp, p, s, k, t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16)
    err = transpose_g ? launch_bwd<true, true>(src, own, g, out, geo, st)
                      : launch_bwd<true, false>(src, own, g, out, geo, st);
  else
    err = transpose_g ? launch_bwd<false, true>(src, own, g, out, geo, st)
                      : launch_bwd<false, false>(src, own, g, out, geo, st);
  return (int)err;
}

}  // extern "C"
