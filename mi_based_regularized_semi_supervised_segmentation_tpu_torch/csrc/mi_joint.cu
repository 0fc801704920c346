// Displaced-MI joint distribution and its two backward products, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/mi_joint.py:
//   * _joint_fwd_call / _band_kernel_fwd           -> joint_fwd_partial + joint_fwd_reduce
//   * _joint_bwd_call / _band_kernel_bwd (dx_tf)   -> joint_bwd, sign +1, g as is
//   * _joint_bwd_call / _band_kernel_bwd (dx)      -> joint_bwd, sign -1, g transposed
//
// What is computed. Both inputs are [N, C] fp32 matrices: the row-major
// flattening of [B, Hp, Wp, C] canvases that already carry a zero border of
// width p. A spatial displacement (dy, dx), dy, dx in [0, 2p], becomes the row
// offset o_d = (dy - p) * Wp + (dx - p), d = dy * (2p + 1) + dx, and rows
// outside [0, N) read as zero (and only those):
//   J[d, k1, k2]  = sum_n A[n + o_d, k1] * B[n, k2]
//   dx_tf[n, k2]  = sum_d sum_k1 A[n + o_d, k1] * g[d, k1, k2]
//   dx[m, k1]     = sum_d sum_k2 B[m - o_d, k2] * g[d, k1, k2]
// Operands are rounded to bf16 and products accumulated in fp32 (the TPU
// kernel's dot_dtype=bf16), or kept in fp32 (the parity mode).
//
// What bounds it on an H100 (989 TF/s dense bf16, 3.35 TB/s HBM). At the
// headline Up_conv2 tap (N = 10*230*230 = 529,000 rows, C = 128, p = 3, 49
// displacements) each of the three products is 2*N*C*C*49 = 8.5e11 flops
// against ~0.54 GB of fp32 operands: 0.86 ms of tensor-core time and 0.16 ms
// of memory time, so the work is bound by operations. At Up_conv3
// (N = 129,960, p = 1, 9 displacements) the two limits are about equal
// (~0.04 ms).
//
// What the design does about it. The products run on the tensor cores
// through WMMA 16x16x16 bf16 fragments (the fp32 mode uses CUDA-core FMAs).
// The forward is a split-K GEMM per displacement: block (d, chunk) stages
// 32-row slices of the shifted A and of B through shared memory (converting
// to bf16 on the way) and keeps the full 128x128 tile in registers; each
// block writes its partial tile and a second pass sums the chunks in a fixed
// order, so the result is deterministic. blockIdx.x runs over the
// displacements, so the 49 blocks that share one chunk of rows are scheduled
// together and read the overlapping shifted slices from L2. The backward is
// one GEMM per 128-row tile with K = D*C: the block walks the displacements,
// staging the shifted 128x32 source slab and a 32x128 slice of g[d] (or
// g[d]^T), and writes its [128, C] output once. Only the diagonal 20x20
// subhead blocks of each 128x128 joint are used downstream; computing just
// those is left for a later change (this kernel computes what the TPU kernel
// computes).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int TILE = 128;    // output tile edge
constexpr int KT = 32;       // reduction slice staged per step
constexpr int THREADS = 256; // 8 warps
constexpr int PAD_H = 8;     // bf16 row padding (16 bytes)
constexpr int PAD_F = 4;     // fp32 row padding (16 bytes)

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t a = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  uint32_t b = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return a | (b << 16);
}

__device__ __forceinline__ unsigned short to_bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

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

// ---------------------------------------------------------------------------
// forward: partial[chunk, d, k1, k2] = sum over the chunk's rows n of
//          A[n + o_d, k1] * B[n, k2]
// grid (D, n_chunks, tiles*tiles), THREADS threads
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
joint_fwd_partial(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ partial, long long N, int C, int p, int wp,
                  long long rows_per_chunk, int vec4) {
  constexpr int LD = BF16 ? TILE + PAD_H : TILE + PAD_F;
  using Elem = typename std::conditional<BF16, unsigned short, float>::type;
  __shared__ __align__(128) Elem As[KT][LD];  // As[kk][m] = A[n0 + kk + o, m]
  __shared__ __align__(128) Elem Bs[KT][LD];  // Bs[kk][j] = B[n0 + kk, j]

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

  // BF16: warp w owns rows [wm*32, +32) x cols [wn*64, +64) as 2x4 fragments.
  const int warp = tid / 32, lane = tid % 32;
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
    // stage: KT rows x TILE cols of each operand, as float4 groups
    for (int idx = tid; idx < KT * (TILE / 4); idx += THREADS) {
      const int kk = idx / (TILE / 4);
      const int q = (idx % (TILE / 4)) * 4;
      const long long n = n0 + kk;
      const bool live = n < n_end;
      float4 a = live ? load4(A, n + o, N, col1 + q, C, v4) : make_float4(0.f, 0.f, 0.f, 0.f);
      float4 b = live ? load4(B, n, N, col2 + q, C, v4) : make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (BF16) {
        *reinterpret_cast<uint2*>(&As[kk][q]) = make_uint2(pack_bf16x2(a.x, a.y), pack_bf16x2(a.z, a.w));
        *reinterpret_cast<uint2*>(&Bs[kk][q]) = make_uint2(pack_bf16x2(b.x, b.y), pack_bf16x2(b.z, b.w));
      } else {
        *reinterpret_cast<float4*>(&As[kk][q]) = a;
        *reinterpret_cast<float4*>(&Bs[kk][q]) = b;
      }
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
          const int r = col1 + wm * 32 + i * 16 + e / 16;
          const int c = col2 + wn * 64 + j * 16 + e % 16;
          if (r < C && c < C) out[(long long)r * C + c] = stage[e];
        }
        __syncwarp();
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = col1 + ty + 16 * i;
        const int c = col2 + tx + 16 * j;
        if (r < C && c < C) out[(long long)r * C + c] = facc[i][j];
      }
  }
}

// out[e] = sum_chunk partial[chunk, e], e over D*C*C, in chunk order
__global__ void joint_fwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                 long long per_chunk, int n_chunks) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per_chunk;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < n_chunks; ++k) s += partial[(long long)k * per_chunk + e];
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// backward: out[n, j] = sum_d sum_k S[n + sign*o_d, k] * G_d[k, j]
//           G_d = g[d] (transpose_g = 0) or g[d]^T (transpose_g = 1)
// grid (ceil(N / TILE), tiles), THREADS threads
// ---------------------------------------------------------------------------
template <bool BF16>
__global__ void __launch_bounds__(THREADS)
joint_bwd(const float* __restrict__ S, const float* __restrict__ g, float* __restrict__ out,
          long long N, int C, int p, int wp, int sign, int transpose_g, int vec4) {
  constexpr int LDS = BF16 ? KT + PAD_H : KT + 1;
  constexpr int LDG = BF16 ? TILE + PAD_H : TILE + PAD_F;
  using Elem = typename std::conditional<BF16, unsigned short, float>::type;
  __shared__ __align__(128) Elem Ss[TILE][LDS];  // Ss[m][kk] = S[n0 + m + sign*o, kc + kk]
  __shared__ __align__(128) Elem Gs[KT][LDG];    // Gs[kk][j] = G_d[kc + kk, col + j]

  const long long n0 = (long long)blockIdx.x * TILE;
  const int col = blockIdx.y * TILE;
  const int T = 2 * p + 1;
  const int D = T * T;
  const int tid = threadIdx.x;
  const bool v4 = vec4 != 0;
  const long long CC = (long long)C * C;

  const int warp = tid / 32, lane = tid % 32;
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
    const long long o = sign * ((long long)(d / T - p) * wp + (d % T - p));
    const float* gd = g + d * CC;
    for (int kc = 0; kc < C; kc += KT) {
      // source slab: TILE rows x KT cols
      for (int idx = tid; idx < TILE * (KT / 4); idx += THREADS) {
        const int m = idx / (KT / 4);
        const int q = (idx % (KT / 4)) * 4;
        float4 s = load4(S, n0 + m + o, N, kc + q, C, v4);
        if constexpr (BF16) {
          *reinterpret_cast<uint2*>(&Ss[m][q]) = make_uint2(pack_bf16x2(s.x, s.y), pack_bf16x2(s.z, s.w));
        } else {
          Ss[m][q + 0] = s.x;
          Ss[m][q + 1] = s.y;
          Ss[m][q + 2] = s.z;
          Ss[m][q + 3] = s.w;
        }
      }
      // cotangent slice: KT rows (k) x TILE cols (j)
      if (!transpose_g) {
        for (int idx = tid; idx < KT * (TILE / 4); idx += THREADS) {
          const int kk = idx / (TILE / 4);
          const int q = (idx % (TILE / 4)) * 4;
          float4 v = (kc + kk < C) ? load4(gd, kc + kk, C, col + q, C, v4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (BF16) {
            *reinterpret_cast<uint2*>(&Gs[kk][q]) = make_uint2(pack_bf16x2(v.x, v.y), pack_bf16x2(v.z, v.w));
          } else {
            *reinterpret_cast<float4*>(&Gs[kk][q]) = v;
          }
        }
      } else {
        // Gs[kk][j] = g[d][col + j][kc + kk]: read along k, scatter down a column
        for (int idx = tid; idx < TILE * (KT / 4); idx += THREADS) {
          const int j = idx / (KT / 4);
          const int q = (idx % (KT / 4)) * 4;
          float4 v = (col + j < C) ? load4(gd, col + j, C, kc + q, C, v4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
          if constexpr (BF16) {
            Gs[q + 0][j] = to_bf16_bits(v.x);
            Gs[q + 1][j] = to_bf16_bits(v.y);
            Gs[q + 2][j] = to_bf16_bits(v.z);
            Gs[q + 3][j] = to_bf16_bits(v.w);
          } else {
            Gs[q + 0][j] = v.x;
            Gs[q + 1][j] = v.y;
            Gs[q + 2][j] = v.z;
            Gs[q + 3][j] = v.w;
          }
        }
      }
      __syncthreads();
      if constexpr (BF16) {
#pragma unroll
        for (int kk = 0; kk < KT; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], reinterpret_cast<const __nv_bfloat16*>(&Ss[wm * 32 + i * 16][kk]), LDS);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wmma::load_matrix_sync(fb[j], reinterpret_cast<const __nv_bfloat16*>(&Gs[kk][wn * 64 + j * 16]), LDG);
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
          for (int i = 0; i < 8; ++i) a[i] = Ss[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < 8; ++j) b[j] = Gs[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) facc[i][j] = fmaf(a[i], b[j], facc[i][j]);
        }
      }
      __syncthreads();
    }
  }

  if constexpr (BF16) {
    float* stage = reinterpret_cast<float*>(&Ss[0][0]) + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const long long r = n0 + wm * 32 + i * 16 + e / 16;
          const int c = col + wn * 64 + j * 16 + e % 16;
          if (r < N && c < C) out[r * C + c] = stage[e];
        }
        __syncwarp();
      }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long r = n0 + ty + 16 * i;
        const int c = col + tx + 16 * j;
        if (r < N && c < C) out[r * C + c] = facc[i][j];
      }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

extern "C" {

const char* mi_joint_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// J[D, C, C] from A, B [N, C]; partial is scratch of n_chunks * D * C * C floats.
int mi_joint_fwd(const float* a, const float* b, float* partial, float* out, long long n_rows,
                 int c, int p, int wp, long long rows_per_chunk, int n_chunks, int bf16,
                 void* stream) {
  const int T = 2 * p + 1;
  const int D = T * T;
  const int ntile = (c + TILE - 1) / TILE;
  const int vec4 = (c % 4 == 0) && aligned16(a) && aligned16(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(D, n_chunks, ntile * ntile);
  if (bf16)
    joint_fwd_partial<true><<<grid, THREADS, 0, s>>>(a, b, partial, n_rows, c, p, wp, rows_per_chunk, vec4);
  else
    joint_fwd_partial<false><<<grid, THREADS, 0, s>>>(a, b, partial, n_rows, c, p, wp, rows_per_chunk, vec4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long per_chunk = (long long)D * c * c;
  const int blocks = (int)((per_chunk + 255) / 256);
  joint_fwd_reduce<<<blocks, 256, 0, s>>>(partial, out, per_chunk, n_chunks);
  return (int)cudaGetLastError();
}

// out[N, C] = sum_d S[n + sign*o_d] @ (g[d] or g[d]^T), g [D, C, C]
int mi_joint_bwd(const float* src, const float* g, float* out, long long n_rows, int c, int p,
                 int wp, int sign, int transpose_g, int bf16, void* stream) {
  const int ntile = (c + TILE - 1) / TILE;
  const int vec4 = (c % 4 == 0) && aligned16(src) && aligned16(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((unsigned)((n_rows + TILE - 1) / TILE), ntile);
  if (bf16)
    joint_bwd<true><<<grid, THREADS, 0, s>>>(src, g, out, n_rows, c, p, wp, sign, transpose_g, vec4);
  else
    joint_bwd<false><<<grid, THREADS, 0, s>>>(src, g, out, n_rows, c, p, wp, sign, transpose_g, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
