// Displaced-MI joint distribution and its two backward products, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/mi_joint.py:
//   * mi_joint.py:178 _joint_fwd_call / _band_kernel_fwd
//       -> joint_prep + joint_fwd_partial + joint_fwd_reduce
//   * mi_joint.py:230 _joint_bwd_call / _band_kernel_bwd (dx_tf)
//       -> joint_prep + joint_bwd, g[d] as is
//   * mi_joint.py:249 _joint_bwd_call / _band_kernel_bwd(transpose_g) (dx)
//       -> joint_prep + joint_bwd, g[D-1-d]^T (the same kernel)
//
// What is computed. Both inputs are [N, C] matrices (fp32, or bf16 when the
// model computes in bf16): the row-major
// flattening of [B, Hp, Wp, C] canvases that already carry a zero border of
// width p. A spatial displacement (dy, dx), dy, dx in [0, 2p], becomes the row
// offset o_d = (dy - p) * Wp + (dx - p), d = dy * (2p + 1) + dx, and rows
// outside [0, N) read as zero (and only those):
//   J[d, k1, k2]  = sum_n A[n + o_d, k1] * B[n, k2]
//   dx_tf[n, k2]  = sum_d sum_k1 A[n + o_d, k1] * g[d, k1, k2]
//   dx[m, k1]     = sum_d sum_k2 B[m - o_d, k2] * g[d, k1, k2]
//                 = sum_d sum_k2 B[m + o_d, k2] * g[D-1-d, k1, k2]   (o_{D-1-d} = -o_d)
// The training path rounds operands (and g) to bf16, round-to-nearest, and
// sums in fp32 (the TPU kernel's dot_dtype=bf16); the fp32 parity mode keeps
// fp32 operands. bf16 operands (Precision.compute_dtype=bfloat16) are
// already the tensor cores' operands: at C = 128 the kernels read them in
// place (the forward launches no conversion pass, the backward's pass
// converts g only), and the backward writes bf16, each fp32 sum over all
// displacements rounded once (the TPU kernel's dx.astype(x.dtype)).
//
// What bounds it on an H100 (989 TF/s dense bf16, 3.35 TB/s HBM). At the
// headline Up_conv2 tap (N = 10*230*230 = 529,000 rows, C = 128, p = 3, 49
// displacements) each of the three products is 2*N*C*C*49 = 8.5e11 flops
// against ~0.54 GB of fp32 operands: 0.86 ms of tensor-core time and 0.16 ms
// of memory time, so the work is bound by operations. At Up_conv3
// (N = 129,960, p = 1, 9 displacements) the two limits are about equal
// (~0.04 ms).
//
// What the bf16 design does about it (C <= 128 lanes a launch, zero-padded to
// 128; the kernels are in joint_core.cuh, one copy shared with mi_fused.cu,
// whose fused path differs only in how joint_prep converts a row and what
// joint_bwd's epilogue writes). A head wider than 128 lanes (C = 128 t) is
// tiled in the wrapper (ops/mi_joint.py: lane_tiled_fwd / lane_tiled_bwd):
// J block (i, j) is one forward launch on lane blocks A_i, B_j; dx_tf_j =
// sum_i of a backward launch on A_i with g_ij, dx_i = sum_j of one on B_j with
// g_ij^T. Each lane block is copied contiguous (.contiguous()) once per call,
// so the kernels keep one row stride of 128 lanes:
//   * joint_prep rounds the operands to bf16 once per call, into [N, 128]
//     scratch, and g into H[d][j][k], already transposed and, for dx, in
//     reversed displacement order. The main kernels then copy bf16 bytes
//     only, and both backward products are one kernel with one layout. The
//     pass is bound by memory: at Up_conv2 it reads 271 MB and writes 135 MB
//     per operand (two operands in the forward, one in each backward).
//   * Shared-memory tiles are rows of 16-byte chunks XOR-swizzled by row
//     (chunk c of row r at c ^ (r & 7), the 128-byte swizzle), so ldmatrix
//     reads any 8 consecutive rows, at any row offset, without bank
//     conflicts, and wgmma reads the same tiles through a descriptor.
//   * Loads are cp.async (16 bytes a thread, zero fill for rows outside
//     [0, N), which are never read) into a ring of stages with one barrier
//     per stage.
//   * joint_bwd (wgmma): a block owns 256 output rows and all 128 lanes: two
//     warpgroups, each two m64n128 fp32 accumulators (128 registers a
//     thread). For each dy it stages one (256 + 2p)-row slab of the source
//     (double-buffered) and reads each dx's A fragments from it by ldmatrix
//     at row offset dx, so the source is staged once per dy, not once per
//     displacement; a row offset that is no multiple of 8 cannot be described
//     to wgmma in shared memory, so A comes from registers. H streams through
//     a 6-stage ring of 16 KB (64 lanes of K), 4 stages in flight, B of
//     wgmma.m64n128k16 in shared memory. L2 traffic per launch at Up_conv2:
//     per block 49 x 32 KB of H and 7 slabs of 67 KB, 2067 blocks, 4.3 GB.
//   * joint_fwd_partial (wgmma): split-K over rows. A block owns one chunk of
//     rows, one dy, TG displacements along x (7 at Up_conv2, 3 at Up_conv3)
//     and one 64 x 64 quarter of J. Per 64 rows it stages a 64-lane slice of
//     B and the (64 + TG - 1)-row slab of A that all its dx read (6 stages,
//     4 in flight). Its two warpgroups split the dx and keep one m64n64 fp32
//     accumulator each per dx; A, the shifted operand, comes from registers
//     (ldmatrix.trans at row offset dx), B from shared memory N-contiguous
//     (wgmma's transposed B). Each block writes its partial tiles;
//     joint_fwd_reduce sums the chunks in a fixed order, so the result is
//     deterministic (no atomics). L2 traffic per launch at Up_conv2: about
//     4.0 GB.
// The launch plan (grid, stages, shared memory, chunking) is computed in
// ops/mi_joint.py:launch_plan; the entry points refuse a plan that disagrees
// with the kernels.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase prints it), no spills:
// joint_bwd<6, StoreRows> 221 registers and 232,448 bytes of dynamic shared memory at
// p = 3 (230,400 at p = 1), 1 block per SM; joint_fwd_partial<7> 208
// registers, joint_fwd_partial<3> 128, each with 104,448 bytes, 1 block per
// SM; joint_prep and joint_fwd_reduce 32 registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "joint_core.cuh"

namespace {

// ===========================================================================
// fp32 parity mode: CUDA-core FMAs, synchronous staging (not on the training
// path)
// ===========================================================================

constexpr int TILE = 128;    // output tile edge
constexpr int KT = 32;       // reduction slice staged per step
constexpr int THREADS = 256; // 8 warps
constexpr int PAD_F = 4;     // fp32 row padding (16 bytes)

// Load 4 consecutive columns [col, col + 4) of row `row` of an [nrows, ncols]
// matrix, with zeros outside the matrix.
__device__ __forceinline__ float4 load4(const float* __restrict__ m, long long row,
                                        long long nrows, int col, int ncols, bool vec4) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < 0 || row >= nrows) return v;
  const float* p = m + row * (long long)ncols + col;
  if (vec4 && col + 4 <= ncols) return *reinterpret_cast<const float4*>(p);
  if (col + 0 < ncols) v.x = p[0];
  if (col + 1 < ncols) v.y = p[1];
  if (col + 2 < ncols) v.z = p[2];
  if (col + 3 < ncols) v.w = p[3];
  return v;
}

// partial[chunk, d, k1, k2] = sum over the chunk's rows n of A[n + o_d, k1] * B[n, k2]
// grid (D, n_chunks, tiles*tiles), THREADS threads
__global__ void __launch_bounds__(THREADS)
joint_fwd_partial_fp32(const float* __restrict__ A, const float* __restrict__ B,
                       float* __restrict__ partial, long long N, int C, int p, int wp,
                       long long rows_per_chunk, int vec4) {
  constexpr int LD = TILE + PAD_F;
  __shared__ __align__(128) float As[KT][LD];  // As[kk][m] = A[n0 + kk + o, m]
  __shared__ __align__(128) float Bs[KT][LD];  // Bs[kk][j] = B[n0 + kk, j]

  const int D = gridDim.x;
  const int d = blockIdx.x;
  const int chunk = blockIdx.y;
  const int ntile = (C + TILE - 1) / TILE;
  const int col1 = (blockIdx.z / ntile) * TILE;  // k1 tile origin
  const int col2 = (blockIdx.z % ntile) * TILE;  // k2 tile origin
  const int T = 2 * p + 1;
  const long long o = (long long)(d / T - p) * wp + (d % T - p);
  const long long n_begin = (long long)chunk * rows_per_chunk;
  const long long n_end = min(N, n_begin + rows_per_chunk);
  const int tid = threadIdx.x;
  const bool v4 = vec4 != 0;

  // thread (ty, tx) owns rows ty + 16*i, cols tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  float facc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  for (long long n0 = n_begin; n0 < n_end; n0 += KT) {
    for (int idx = tid; idx < KT * (TILE / 4); idx += THREADS) {
      const int kk = idx / (TILE / 4);
      const int q = (idx % (TILE / 4)) * 4;
      const long long n = n0 + kk;
      const bool live = n < n_end;
      *reinterpret_cast<float4*>(&As[kk][q]) =
          live ? load4(A, n + o, N, col1 + q, C, v4) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&Bs[kk][q]) =
          live ? load4(B, n, N, col2 + q, C, v4) : make_float4(0.f, 0.f, 0.f, 0.f);
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

  float* out = partial + ((long long)chunk * D + d) * (long long)C * C;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = col1 + ty + 16 * i;
      const int c = col2 + tx + 16 * j;
      if (r < C && c < C) out[(long long)r * C + c] = facc[i][j];
    }
}

// out[n, j] = sum_d sum_k S[n + sign*o_d, k] * G_d[k, j]
//             G_d = g[d] (transpose_g = 0) or g[d]^T (transpose_g = 1)
// grid (ceil(N / TILE), tiles), THREADS threads
__global__ void __launch_bounds__(THREADS)
joint_bwd_fp32(const float* __restrict__ S, const float* __restrict__ g, float* __restrict__ out,
               long long N, int C, int p, int wp, int sign, int transpose_g, int vec4) {
  __shared__ __align__(128) float Ss[TILE][KT + 1];      // Ss[m][kk] = S[n0 + m + sign*o, kc + kk]
  __shared__ __align__(128) float Gs[KT][TILE + PAD_F];  // Gs[kk][j] = G_d[kc + kk, col + j]

  const long long n0 = (long long)blockIdx.x * TILE;
  const int col = blockIdx.y * TILE;
  const int T = 2 * p + 1;
  const int D = T * T;
  const int tid = threadIdx.x;
  const bool v4 = vec4 != 0;
  const long long CC = (long long)C * C;

  const int ty = tid / 16, tx = tid % 16;
  float facc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[i][j] = 0.f;

  for (int d = 0; d < D; ++d) {
    const long long o = sign * ((long long)(d / T - p) * wp + (d % T - p));
    const float* gd = g + d * CC;
    for (int kc = 0; kc < C; kc += KT) {
      for (int idx = tid; idx < TILE * (KT / 4); idx += THREADS) {
        const int m = idx / (KT / 4);
        const int q = (idx % (KT / 4)) * 4;
        float4 s = load4(S, n0 + m + o, N, kc + q, C, v4);
        Ss[m][q + 0] = s.x;
        Ss[m][q + 1] = s.y;
        Ss[m][q + 2] = s.z;
        Ss[m][q + 3] = s.w;
      }
      if (!transpose_g) {
        for (int idx = tid; idx < KT * (TILE / 4); idx += THREADS) {
          const int kk = idx / (TILE / 4);
          const int q = (idx % (TILE / 4)) * 4;
          *reinterpret_cast<float4*>(&Gs[kk][q]) =
              (kc + kk < C) ? load4(gd, kc + kk, C, col + q, C, v4) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        // Gs[kk][j] = g[d][col + j][kc + kk]: read along k, scatter down a column
        for (int idx = tid; idx < TILE * (KT / 4); idx += THREADS) {
          const int j = idx / (KT / 4);
          const int q = (idx % (KT / 4)) * 4;
          float4 v = (col + j < C) ? load4(gd, col + j, C, kc + q, C, v4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          Gs[q + 0][j] = v.x;
          Gs[q + 1][j] = v.y;
          Gs[q + 2][j] = v.z;
          Gs[q + 3][j] = v.w;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < KT; ++kk) {
        float a[8], b[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = Ss[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = Gs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long r = n0 + ty + 16 * i;
      const int c = col + tx + 16 * j;
      if (r < N && c < C) out[r * C + c] = facc[i][j];
    }
}

}  // namespace

extern "C" {

const char* mi_joint_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The bf16 entry points take the launch plan's numbers and refuse
// (cudaErrorInvalidValue) a plan whose shared memory or stages disagree with
// the kernel's. The *_bf16 ones take fp32 operands and round them to bf16 in
// the conversion pass; the *_bf16in ones take bf16 operands (the model's
// bf16 compute), which are already what the tensor cores read.

// bf16 products: J[D, C, C] fp32 from A, B [N, C] fp32. a16, b16: scratch of
// N x 128 bf16; partial: scratch of n_chunks x D x 128 x 128 floats.
int mi_joint_fwd_bf16(const float* a, const float* b, void* a16, void* b16, float* partial,
                      float* out, long long n_rows, int c, int p, int wp,
                      long long rows_per_chunk, int n_chunks, int dx_group, int smem_bytes,
                      void* stream) {
  if (!fwd_plan_ok(c, p, dx_group, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* A16 = static_cast<__nv_bfloat16*>(a16);
  auto* B16 = static_cast<__nv_bfloat16*>(b16);
  const CastRows<float> rows{a, A16, b, B16, n_rows, c, cast_vec<float>(c, a, b)};
  joint_prep<<<prep_blocks(2 * n_rows * (LANES / 8)), PREP_THREADS, 0, s>>>(rows, nullptr,
                                                                           nullptr, c, 0, 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)run_fwd(dx_group, n_chunks, smem_bytes, s, A16, B16, partial, out, n_rows, c, p,
                      wp, rows_per_chunk);
}

// bf16 operands: J[D, C, C] fp32 from A, B [N, C] bf16. With a16 == b16 ==
// null, A and B must be rows of 128 lanes, 16-byte aligned, and the kernels
// read them as they are: no conversion pass (2 launches). Otherwise a16, b16
// are N x 128 bf16 scratch that the pass pads the rows into (3 launches).
int mi_joint_fwd_bf16in(const void* a, const void* b, void* a16, void* b16, float* partial,
                        float* out, long long n_rows, int c, int p, int wp,
                        long long rows_per_chunk, int n_chunks, int dx_group, int smem_bytes,
                        void* stream) {
  if (!fwd_plan_ok(c, p, dx_group, smem_bytes)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* A = static_cast<const __nv_bfloat16*>(a);
  auto* B = static_cast<const __nv_bfloat16*>(b);
  if (a16 == nullptr || b16 == nullptr) {
    if (a16 != b16 || c != LANES || !aligned16(a) || !aligned16(b))
      return (int)cudaErrorInvalidValue;
  } else {
    auto* A16 = static_cast<__nv_bfloat16*>(a16);
    auto* B16 = static_cast<__nv_bfloat16*>(b16);
    const CastRows<__nv_bfloat16> rows{A, A16, B, B16, n_rows, c,
                                       cast_vec<__nv_bfloat16>(c, a, b)};
    joint_prep<<<prep_blocks(2 * n_rows * (LANES / 8)), PREP_THREADS, 0, s>>>(rows, nullptr,
                                                                             nullptr, c, 0, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    A = A16;
    B = B16;
  }
  return (int)run_fwd(dx_group, n_chunks, smem_bytes, s, A, B, partial, out, n_rows, c, p, wp,
                      rows_per_chunk);
}

// bf16 products: out[N, C] fp32 = sum_d src[n + o_d] @ g[d] (transpose_g = 0)
// or sum_d src[n - o_d] @ g[d]^T (transpose_g = 1), src fp32. s16: scratch of
// N x 128 bf16; h16: scratch of D x 128 x 128 bf16.
int mi_joint_bwd_bf16(const float* src, const float* g, void* s16, void* h16, float* out,
                      long long n_rows, int c, int p, int wp, int transpose_g, int stages,
                      int smem_bytes, void* stream) {
  if (!bwd_plan_ok(c, p, stages, smem_bytes)) return (int)cudaErrorInvalidValue;
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  const CastRows<float> rows{src, S16, nullptr, nullptr, n_rows, c,
                             cast_vec<float>(c, src, nullptr)};
  joint_prep<<<prep_blocks(n_rows * (LANES / 8) + h_units(D)), PREP_THREADS, 0, s>>>(
      rows, g, H16, c, D, transpose_g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)run_bwd(stages, n_rows, p, wp, smem_bytes, s, S16, H16, StoreRows<float>{out, c});
}

// bf16 operands: the same product from src [N, C] bf16; g stays fp32 (the
// cotangent of the fp32 J). out is [N, C] bf16 (out_bf16 = 1: each fp32 sum
// over all displacements rounded once) or fp32 (out_bf16 = 0: a lane block of
// a wider head, summed with the others in fp32 by the caller). With s16 ==
// null, src must be rows of 128 lanes, 16-byte aligned: the conversion pass
// then converts g alone; otherwise it also pads src into s16 [N, 128] bf16.
int mi_joint_bwd_bf16in(const void* src, const float* g, void* s16, void* h16, void* out,
                        int out_bf16, long long n_rows, int c, int p, int wp, int transpose_g,
                        int stages, int smem_bytes, void* stream) {
  if (!bwd_plan_ok(c, p, stages, smem_bytes)) return (int)cudaErrorInvalidValue;
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* S = static_cast<const __nv_bfloat16*>(src);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  if (S16 == nullptr && (c != LANES || !aligned16(src))) return (int)cudaErrorInvalidValue;
  const long long rows_n = S16 == nullptr ? 0 : n_rows;  // no rows to convert
  const CastRows<__nv_bfloat16> rows{S, S16, nullptr, nullptr, rows_n, c,
                                     cast_vec<__nv_bfloat16>(c, src, nullptr)};
  joint_prep<<<prep_blocks(rows_n * (LANES / 8) + h_units(D)), PREP_THREADS, 0, s>>>(
      rows, g, H16, c, D, transpose_g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* operand = S16 == nullptr ? S : S16;
  if (out_bf16)
    return (int)run_bwd(stages, n_rows, p, wp, smem_bytes, s, operand, H16,
                        StoreRows<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), c});
  return (int)run_bwd(stages, n_rows, p, wp, smem_bytes, s, operand, H16,
                      StoreRows<float>{static_cast<float*>(out), c});
}

// fp32 parity mode: J[D, C, C] from A, B [N, C]; partial is scratch of
// n_chunks * D * C * C floats.
int mi_joint_fwd_fp32(const float* a, const float* b, float* partial, float* out,
                      long long n_rows, int c, int p, int wp, long long rows_per_chunk,
                      int n_chunks, void* stream) {
  const int T = 2 * p + 1;
  const int D = T * T;
  const int ntile = (c + TILE - 1) / TILE;
  const int vec4 = (c % 4 == 0) && aligned16(a) && aligned16(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(D, n_chunks, ntile * ntile);
  joint_fwd_partial_fp32<<<grid, THREADS, 0, s>>>(a, b, partial, n_rows, c, p, wp, rows_per_chunk,
                                                  vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  joint_fwd_reduce<<<reduce_blocks((long long)D * c * c), 256, 0, s>>>(partial, out, D, c, c,
                                                                       n_chunks);
  return (int)cudaGetLastError();
}

// fp32 parity mode: out[N, C] = sum_d S[n + sign*o_d] @ (g[d] or g[d]^T)
int mi_joint_bwd_fp32(const float* src, const float* g, float* out, long long n_rows, int c,
                      int p, int wp, int transpose_g, void* stream) {
  const int ntile = (c + TILE - 1) / TILE;
  const int vec4 = (c % 4 == 0) && aligned16(src) && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((n_rows + TILE - 1) / TILE), ntile);
  joint_bwd_fp32<<<grid, THREADS, 0, s>>>(src, g, out, n_rows, c, p, wp, transpose_g ? -1 : 1,
                                          transpose_g, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
