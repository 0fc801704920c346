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
// What is computed. Both inputs are [N, C] fp32 matrices: the row-major
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
// fp32 operands.
//
// What bounds it on an H100 (989 TF/s dense bf16, 3.35 TB/s HBM). At the
// headline Up_conv2 tap (N = 10*230*230 = 529,000 rows, C = 128, p = 3, 49
// displacements) each of the three products is 2*N*C*C*49 = 8.5e11 flops
// against ~0.54 GB of fp32 operands: 0.86 ms of tensor-core time and 0.16 ms
// of memory time, so the work is bound by operations. At Up_conv3
// (N = 129,960, p = 1, 9 displacements) the two limits are about equal
// (~0.04 ms).
//
// What the bf16 design does about it (C <= 128, zero-padded to 128 lanes):
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
// joint_bwd<6> 221 registers and 232,448 bytes of dynamic shared memory at
// p = 3 (230,400 at p = 1), 1 block per SM; joint_fwd_partial<7> 208
// registers, joint_fwd_partial<3> 128, each with 104,448 bytes, 1 block per
// SM; joint_prep and joint_fwd_reduce 32 registers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// out[d, k1, k2] = sum over chunks, in chunk order, of partial[chunk, d, k1, k2];
// partial tiles are ld x ld (ld = C in the fp32 mode, 128 in the bf16 mode)
__global__ void joint_fwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                 int D, int C, int ld, int n_chunks) {
  const long long cc = (long long)C * C;
  const long long per = (long long)D * cc;
  const long long stride = (long long)D * ld * ld;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    const long long d = e / cc;
    const int r = (int)(e % cc);
    const float* src = partial + (d * ld + r / C) * ld + r % C;
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += src[k * stride];
    out[e] = s;
  }
}

// ===========================================================================
// bf16 mode (the training path): tensor cores, cp.async ring, swizzled tiles
// ===========================================================================

constexpr int LANES = 128;                     // C, zero-padded to 128 lanes
constexpr int ROW_BYTES = LANES * 2;           // one bf16 row: 16 chunks of 16 bytes
constexpr int MMA_THREADS = 256;               // 8 warps
constexpr int BW_TILE = 256;                   // joint_bwd: output rows per block
constexpr int BW_KC = 64;                      // joint_bwd: K lanes per H stage
constexpr int BW_NKC = LANES / BW_KC;          // H stages per displacement
constexpr int BW_H_BYTES = LANES * BW_KC * 2;  // one H stage: [128 j][64 k] bf16
constexpr int FW_KT = 64;                      // joint_fwd_partial: rows per stage
constexpr int FW_HALF = 64;                    // its J tile: 64 k1 x 64 k2
constexpr int FW_ROW_BYTES = FW_HALF * 2;      // one staged row: 8 chunks
constexpr int FW_STAGES = 6;

__host__ __device__ constexpr int bwd_smem_bytes(int p, int stages) {
  return 2 * (BW_TILE + 2 * p) * ROW_BYTES + stages * BW_H_BYTES;
}
__host__ __device__ constexpr int fwd_stage_bytes(int tg) {  // B slice, then A slab
  return (FW_KT * FW_ROW_BYTES + (FW_KT + tg - 1) * FW_ROW_BYTES + 1023) / 1024 * 1024;
}
__host__ __device__ constexpr int fwd_smem_bytes(int tg) { return FW_STAGES * fwd_stage_bytes(tg); }

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// shared byte offset of 16-byte chunk c of row r in a tile of `row_bytes` rows
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((c ^ (r & 7)) << 4));
}

// 16-byte asynchronous copy, global -> shared; with !valid the source is not
// read and the destination is zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.x4.trans.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// ---- wgmma (sm_90a): D[64 x N] += A[64 x 16] (registers) * B[16 x N] (shared)
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// shared-memory matrix descriptor of a K-major operand tile in the 128-byte
// swizzle (rows of 64 bf16, chunk c of row r at c ^ (r & 7), 8-row groups
// 1024 bytes apart; the tile starts 1024-byte aligned, a k16 slice at +32 B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// A: this warp's 16 rows of the warpgroup's 64, in the mma.m16n8k16 A
// fragment layout; B: descriptor of [128 n][16 k]; d: the m64n128 f32
// fragment (d[4c + e]: row g + 8 * (e >> 1), col 8c + 2t + (e & 1));
// scale-d 1 (accumulate), no negation, B not transposed
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

// shared-memory descriptor of an N-contiguous (MN-major) B tile in the
// 128-byte swizzle: rows of 64 bf16 along N, one row per k, 8-row groups 1024
// bytes apart (the tile starts 1024-byte aligned; a k16 slice at +2048 B)
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, N-contiguous:
// trans-b 1)
__device__ __forceinline__ void wgmma_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

// bf16 copies for the tensor-core kernels, in one launch (grid-stride over
// 16-byte destination chunks):
//   rows: dst_i[r, 0:128] = bf16_rn(src_i[r, 0:C]), zero beyond C (i = 0, 1;
//         src1 may be null)
//   g:    H[d, j, k] = bf16_rn(transpose_g ? g[D-1-d, j, k] : g[d, k, j]),
//         zero beyond C (g may be null)
// so that joint_bwd computes out[n, j] = sum_d sum_k S[n + o_d, k] H[d, j, k]
// for both backward products.
__global__ void joint_prep(const float* __restrict__ src0, __nv_bfloat16* __restrict__ dst0,
                           const float* __restrict__ src1, __nv_bfloat16* __restrict__ dst1,
                           long long n, int C, int vec4, const float* __restrict__ g,
                           __nv_bfloat16* __restrict__ h, int D, int transpose_g) {
  const long long units0 = n * (LANES / 8);
  const long long units1 = src1 ? units0 : 0;
  const long long units_g = g ? (long long)D * LANES * (LANES / 8) : 0;
  const long long total = units0 + units1 + units_g;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float v[8];
    __nv_bfloat16* dst;
    if (i < units0 + units1) {
      const bool second = i >= units0;
      const long long u = second ? i - units0 : i;
      const long long r = u / (LANES / 8);
      const int c0 = (int)(u % (LANES / 8)) * 8;
      const float* s = (second ? src1 : src0) + r * C + c0;
      if (vec4 && c0 + 8 <= C) {
        const float4 x = *reinterpret_cast<const float4*>(s);
        const float4 y = *reinterpret_cast<const float4*>(s + 4);
        v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c0 + e < C ? s[e] : 0.f;
      }
      dst = (second ? dst1 : dst0) + r * LANES + c0;
    } else {
      const long long u = i - units0 - units1;
      const int d = (int)(u / (LANES * (LANES / 8)));
      const int j = (int)(u / (LANES / 8)) % LANES;
      const int k0 = (int)(u % (LANES / 8)) * 8;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int k = k0 + e;
        v[e] = (j < C && k < C)
                   ? (transpose_g ? g[((long long)(D - 1 - d) * C + j) * C + k]
                                  : g[((long long)d * C + k) * C + j])
                   : 0.f;
      }
      dst = h + ((long long)d * LANES + j) * LANES + k0;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  }
}

// out[n, j] = sum_d sum_k S[n + o_d, k] * H[d, j, k], rows outside [0, N) of S
// reading as zero; S [N, 128] bf16, H [D, 128, 128] bf16, out [N, C] fp32.
// grid (ceil(N / BW_TILE)), 256 threads = two warpgroups of 128 output rows
// each (two m64n128 fp32 accumulators, 128 registers a thread). Dynamic
// shared memory bwd_smem_bytes(p, STAGES): STAGES H stages first (1024-byte
// aligned: the wgmma B operand), then two source slabs of BW_TILE + 2p rows.
// K-loop step s = (d, kc): dy = s / (2T), dx = (s / 2) % T, kc = s % 2; the
// step's A fragments come by ldmatrix from the slab of its dy at row offset
// dx, and wgmma reads them from registers. STAGES - 2 steps are in flight: a
// step's H stage is refilled two steps later, once both warpgroups have
// waited for the wgmmas that read it (wgmma.wait_group 1 after each step).
template <int STAGES>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_bwd(const __nv_bfloat16* __restrict__ S, const __nv_bfloat16* __restrict__ H,
          float* __restrict__ out, long long N, int C, int p, int wp) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int T = 2 * p + 1;
  const int slab_rows = BW_TILE + 2 * p;
  const uint32_t slab_bytes = (uint32_t)slab_rows * ROW_BYTES;
  const uint32_t h_s = smem_addr(smem);
  const uint32_t slab_s = h_s + STAGES * BW_H_BYTES;
  if (h_s & 1023) __trap();  // the swizzled wgmma operand needs a 1024-byte aligned base

  const long long n0 = (long long)blockIdx.x * BW_TILE;
  const long long n_hi = min(n0 + BW_TILE, N);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int steps_per_dy = T * BW_NKC;
  const int steps = T * steps_per_dy;

  auto load_slab = [&](int dy) {
    const long long lo = n0 + (long long)(dy - p) * wp - p;
    const long long hi = n_hi + (long long)(dy - p) * wp + p;
    const uint32_t base = slab_s + (dy & 1) * slab_bytes;
    for (int idx = tid; idx < slab_rows * (ROW_BYTES / 16); idx += MMA_THREADS) {
      const int r = idx >> 4, c = idx & 15;
      const long long row = lo + r;
      const bool valid = row >= 0 && row < N && row < hi;
      cp_async16(base + swz(r, c, ROW_BYTES), S + (valid ? row : 0) * LANES + c * 8, valid);
    }
  };
  auto prefetch = [&](int s) {
    if (s < steps) {
      if (s % steps_per_dy == 0) load_slab(s / steps_per_dy);
      const __nv_bfloat16* src =
          H + (long long)(s / BW_NKC) * LANES * LANES + (s % BW_NKC) * BW_KC;
      const uint32_t base = h_s + (s % STAGES) * BW_H_BYTES;
      for (int idx = tid; idx < LANES * (BW_KC / 8); idx += MMA_THREADS) {
        const int j = idx >> 3, c = idx & 7;
        cp_async16(base + swz(j, c, BW_KC * 2), src + j * LANES + c * 8, true);
      }
    }
    cp_async_commit();
  };

  float acc[2][64];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[h][e] = 0.f;

  // A fragments (ldmatrix x4, 16 rows x 16 k): lane -> row lane & 15,
  // chunk lane >> 4; warp wq of warpgroup wg holds rows wg*128 + h*64 + wq*16
  const int a_row = wg * 128 + wq * 16 + (lane & 15);
  const int a_chunk = lane >> 4;

  auto step = [&](int s, uint32_t (&a)[BW_KC / 16][2][4]) {
    cp_async_wait<STAGES - 3>();
    // cp.async wrote through the generic proxy; wgmma reads through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    prefetch(s + STAGES - 2);
    const int dy = s / steps_per_dy;
    const int dx = (s / BW_NKC) % T;
    const int kc = s % BW_NKC;
    const uint32_t a_base = slab_s + (dy & 1) * slab_bytes;
    const uint32_t b_base = h_s + (s % STAGES) * BW_H_BYTES;
#pragma unroll
    for (int kk = 0; kk < BW_KC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dx + a_row + h * 64;
        ldsm4(a_base + swz(r, kc * (BW_KC / 8) + kk * 2 + a_chunk, ROW_BYTES), a[kk][h]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BW_KC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) wgmma_m64n128k16(acc[h], a[kk][h], desc_sw128(b_base + kk * 32));
    wgmma_commit();
    wgmma_wait<1>();
  };

  uint32_t a0[BW_KC / 16][2][4], a1[BW_KC / 16][2][4];
#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) prefetch(s);
#pragma unroll 1
  for (int s = 0; s < steps; s += 2) {  // steps = 2 T^2 is even
    step(s, a0);
    step(s + 1, a1);
  }
  wgmma_wait<0>();
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const bool even = (C & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = n0 + wg * 128 + h * 64 + wq * 16 + g + half * 8;
      if (row >= N) continue;
#pragma unroll
      for (int c8 = 0; c8 < 16; ++c8) {
        const int col = c8 * 8 + 2 * t4;
        const float v0 = acc[h][4 * c8 + 2 * half], v1 = acc[h][4 * c8 + 2 * half + 1];
        float* o = out + row * C + col;
        if (col + 1 < C) {
          if (even) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            o[0] = v0;
            o[1] = v1;
          }
        } else if (col < C) {
          o[0] = v0;
        }
      }
    }
}

// partial[chunk, d, k1, k2] (128 x 128 tiles) = sum over the chunk's rows n of
// A[n + o_d, k1] * B[n, k2], rows outside [0, N) of A reading as zero; A, B
// [N, 128] bf16. grid (4 * groups * T, n_chunks), groups = T / TG:
// blockIdx.x = quarter + 4 * (group + groups * dy); the block covers dx in
// [group*TG, +TG) and the 64 x 64 quarter (k1 half q >> 1, k2 half q & 1).
// FW_STAGES stages of fwd_stage_bytes(TG), 1024-byte aligned: a B slice
// (FW_KT rows x 64 k2, N-contiguous: the wgmma B operand) and the A slab
// (FW_KT + TG - 1 rows x 64 k1) that all the block's dx read. The two
// warpgroups split the TG displacements ((TG + 1) / 2 and the rest; they
// share the SM's tensor cores, so the uneven split costs no tensor time),
// each keeping one m64n64 fp32 accumulator per displacement; A (k1 x n, the
// shifted operand) comes by ldmatrix.trans at row offset dx, from registers.
// STAGES - 2 stages are in flight, as in joint_bwd.
template <int J, typename Prefetch>
__device__ __forceinline__ void fwd_wg_loop(uint32_t smem_s, uint32_t stage_bytes,
                                            uint32_t b_bytes, int n_stages, int j0, int wq,
                                            int lane, float* partial_d, long long tile_stride,
                                            int k1_0, int k2_0, const Prefetch& prefetch) {
  constexpr int JA = J > 0 ? J : 1;
  float acc[JA][32];
#pragma unroll
  for (int j = 0; j < JA; ++j)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[j][e] = 0.f;
  const int a_row = ((lane >> 4) << 3) + (lane & 7);
  const int a_chunk = wq * 2 + ((lane >> 3) & 1);
  uint32_t a0[JA][4], a1[JA][4];
  auto kstep = [&](uint32_t a_base, uint32_t b_base, int kk, uint32_t (&a)[JA][4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
      ldsm4_t(a_base + swz(kk * 16 + j0 + j + a_row, a_chunk, FW_ROW_BYTES), a[j]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < J; ++j) wgmma_m64n64k16_tb(acc[j], a[j], desc_sw128_mn(b_base + kk * 2048));
    wgmma_commit();
    wgmma_wait<1>();
  };
#pragma unroll 1
  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<FW_STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    prefetch(st + FW_STAGES - 2);
    if constexpr (J > 0) {
      const uint32_t b_base = smem_s + (st % FW_STAGES) * stage_bytes;
      const uint32_t a_base = b_base + b_bytes;
      kstep(a_base, b_base, 0, a0);
      kstep(a_base, b_base, 1, a1);
      kstep(a_base, b_base, 2, a0);
      kstep(a_base, b_base, 3, a1);
    }
  }
  if constexpr (J > 0) {
    wgmma_wait<0>();
    const int g = lane >> 2, t4 = lane & 3;
    const int k1 = k1_0 + wq * 16 + g;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float* P = partial_d + (long long)(j0 + j) * tile_stride;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int k2 = k2_0 + c8 * 8 + 2 * t4;
        *reinterpret_cast<float2*>(P + k1 * LANES + k2) =
            make_float2(acc[j][4 * c8], acc[j][4 * c8 + 1]);
        *reinterpret_cast<float2*>(P + (k1 + 8) * LANES + k2) =
            make_float2(acc[j][4 * c8 + 2], acc[j][4 * c8 + 3]);
      }
    }
  }
}

template <int TG>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_fwd_partial(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                  float* __restrict__ partial, long long N, int p, int wp,
                  long long rows_per_chunk) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int A_ROWS = FW_KT + TG - 1;
  constexpr uint32_t B_BYTES = FW_KT * FW_ROW_BYTES;
  constexpr uint32_t STAGE_BYTES = fwd_stage_bytes(TG);
  constexpr int J0 = (TG + 1) / 2, J1 = TG - J0;
  const uint32_t smem_s = smem_addr(smem);
  if (smem_s & 1023) __trap();

  const int T = 2 * p + 1;
  const int D = T * T;
  const int groups = T / TG;
  const int q = blockIdx.x & 3;
  const int grp = (blockIdx.x >> 2) % groups;
  const int dy = (blockIdx.x >> 2) / groups;
  const int h1 = q >> 1, h2 = q & 1;
  const int dx0 = grp * TG;
  const long long chunk = blockIdx.y;
  const long long n_begin = chunk * rows_per_chunk;
  const long long n_end = min(N, n_begin + rows_per_chunk);
  const long long shift = (long long)(dy - p) * wp - p + dx0;
  const int n_stages = n_end > n_begin ? (int)((n_end - n_begin + FW_KT - 1) / FW_KT) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  auto prefetch = [&](int st) {
    if (st < n_stages) {
      const long long r0 = n_begin + (long long)st * FW_KT;
      const int live = (int)min((long long)FW_KT, n_end - r0);
      const uint32_t b_base = smem_s + (st % FW_STAGES) * STAGE_BYTES;
      const uint32_t a_base = b_base + B_BYTES;
      for (int idx = tid; idx < A_ROWS * (FW_ROW_BYTES / 16); idx += MMA_THREADS) {
        const int r = idx >> 3, c = idx & 7;
        const long long row = r0 + shift + r;
        const bool valid = r < live + TG - 1 && row >= 0 && row < N;
        cp_async16(a_base + swz(r, c, FW_ROW_BYTES),
                   A + (valid ? row : 0) * LANES + h1 * FW_HALF + c * 8, valid);
      }
      for (int idx = tid; idx < FW_KT * (FW_ROW_BYTES / 16); idx += MMA_THREADS) {
        const int r = idx >> 3, c = idx & 7;
        const bool valid = r < live;
        cp_async16(b_base + swz(r, c, FW_ROW_BYTES),
                   B + (valid ? r0 + r : 0) * LANES + h2 * FW_HALF + c * 8, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int st = 0; st < FW_STAGES - 2; ++st) prefetch(st);

  float* partial_d = partial + (chunk * D + dy * T + dx0) * (long long)LANES * LANES;
  const long long tile = (long long)LANES * LANES;
  if (warp < 4) {
    fwd_wg_loop<J0>(smem_s, STAGE_BYTES, B_BYTES, n_stages, 0, warp, lane, partial_d, tile,
                    h1 * FW_HALF, h2 * FW_HALF, prefetch);
  } else {
    fwd_wg_loop<J1>(smem_s, STAGE_BYTES, B_BYTES, n_stages, J0, warp - 4, lane, partial_d, tile,
                    h1 * FW_HALF, h2 * FW_HALF, prefetch);
  }
  cp_async_wait<0>();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned prep_blocks(long long units) {
  const long long b = (units + 255) / 256;
  return (unsigned)(b < (1 << 20) ? b : (1 << 20));
}

unsigned reduce_blocks(long long elems) {
  return (unsigned)((elems + 255) / 256);
}

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use on an H100

// Raise a kernel's dynamic shared-memory limit to the card's maximum, once.
template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  done = err == cudaSuccess;
  return err;
}

template <int STAGES>
cudaError_t launch_bwd(unsigned blocks, int smem_bytes, cudaStream_t s, const __nv_bfloat16* S,
                       const __nv_bfloat16* H, float* out, long long n, int c, int p, int wp) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_bwd<STAGES>, smem_set);
  if (err != cudaSuccess) return err;
  joint_bwd<STAGES><<<blocks, MMA_THREADS, smem_bytes, s>>>(S, H, out, n, c, p, wp);
  return cudaGetLastError();
}

template <int TG>
cudaError_t launch_fwd(dim3 grid, int smem_bytes, cudaStream_t s, const __nv_bfloat16* A,
                       const __nv_bfloat16* B, float* partial, long long n, int p, int wp,
                       long long rows_per_chunk) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_fwd_partial<TG>, smem_set);
  if (err != cudaSuccess) return err;
  joint_fwd_partial<TG><<<grid, MMA_THREADS, smem_bytes, s>>>(A, B, partial, n, p, wp,
                                                              rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* mi_joint_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The bf16 entry points take the launch plan's numbers and refuse
// (cudaErrorInvalidValue) a plan whose shared memory or stages disagree with
// the kernel's.

// bf16: J[D, C, C] from A, B [N, C] fp32. a16, b16: scratch of N x 128 bf16;
// partial: scratch of n_chunks x D x 128 x 128 floats.
int mi_joint_fwd_bf16(const float* a, const float* b, void* a16, void* b16, float* partial,
                      float* out, long long n_rows, int c, int p, int wp,
                      long long rows_per_chunk, int n_chunks, int dx_group, int smem_bytes,
                      void* stream) {
  const int T = 2 * p + 1;
  if (c < 1 || c > LANES || (dx_group != 1 && dx_group != 3 && dx_group != 5 && dx_group != 7) ||
      T % dx_group != 0 || smem_bytes != fwd_smem_bytes(dx_group))
    return (int)cudaErrorInvalidValue;
  const int D = T * T;
  const int groups = T / dx_group;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* A16 = static_cast<__nv_bfloat16*>(a16);
  auto* B16 = static_cast<__nv_bfloat16*>(b16);
  const int vec4 = (c % 4 == 0) && aligned16(a) && aligned16(b);
  joint_prep<<<prep_blocks(2 * n_rows * (LANES / 8)), 256, 0, s>>>(a, A16, b, B16, n_rows, c, vec4,
                                                                  nullptr, nullptr, 0, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(4 * groups * T, n_chunks);
  switch (dx_group) {
    case 1: err = launch_fwd<1>(grid, smem_bytes, s, A16, B16, partial, n_rows, p, wp, rows_per_chunk); break;
    case 3: err = launch_fwd<3>(grid, smem_bytes, s, A16, B16, partial, n_rows, p, wp, rows_per_chunk); break;
    case 5: err = launch_fwd<5>(grid, smem_bytes, s, A16, B16, partial, n_rows, p, wp, rows_per_chunk); break;
    default: err = launch_fwd<7>(grid, smem_bytes, s, A16, B16, partial, n_rows, p, wp, rows_per_chunk);
  }
  if (err != cudaSuccess) return (int)err;
  joint_fwd_reduce<<<reduce_blocks((long long)D * c * c), 256, 0, s>>>(partial, out, D, c, LANES,
                                                                       n_chunks);
  return (int)cudaGetLastError();
}

// bf16: out[N, C] = sum_d src[n + o_d] @ g[d] (transpose_g = 0) or
// sum_d src[n - o_d] @ g[d]^T (transpose_g = 1). s16: scratch of N x 128 bf16;
// h16: scratch of D x 128 x 128 bf16.
int mi_joint_bwd_bf16(const float* src, const float* g, void* s16, void* h16, float* out,
                      long long n_rows, int c, int p, int wp, int transpose_g, int stages,
                      int smem_bytes, void* stream) {
  const int T = 2 * p + 1;
  // a slab buffer is refilled STAGES - 2 steps ahead of its dy's first step:
  // only after the last step of the dy two before it
  if (c < 1 || c > LANES || (stages != 4 && stages != 6) || T * BW_NKC < stages - 2 ||
      smem_bytes != bwd_smem_bytes(p, stages))
    return (int)cudaErrorInvalidValue;
  const int D = T * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  const int vec4 = (c % 4 == 0) && aligned16(src);
  const long long units = n_rows * (LANES / 8) + (long long)D * LANES * (LANES / 8);
  joint_prep<<<prep_blocks(units), 256, 0, s>>>(src, S16, nullptr, nullptr, n_rows, c, vec4, g,
                                                H16, D, transpose_g);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_rows + BW_TILE - 1) / BW_TILE);
  err = stages == 6 ? launch_bwd<6>(blocks, smem_bytes, s, S16, H16, out, n_rows, c, p, wp)
                    : launch_bwd<4>(blocks, smem_bytes, s, S16, H16, out, n_rows, c, p, wp);
  return (int)err;
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
