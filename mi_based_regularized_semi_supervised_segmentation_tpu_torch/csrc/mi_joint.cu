// Displaced-MI joint distribution and its two backward products, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's
// ops/pallas/mi_joint.py:
//   * mi_joint.py:178 _joint_fwd_call / _band_kernel_fwd
//       -> joint_prep + joint_fwd_partial + joint_fwd_reduce; at p = 0
//          joint_gram_fwd + joint_fwd_reduce; a tap's tiles joint_prep +
//          joint_fwd_pieces; C > 128 joint_prep_wide + joint_fwd_wide +
//          joint_fwd_reduce
//   * mi_joint.py:230 _joint_bwd_call / _band_kernel_bwd (dx_tf)
//       -> joint_prep + joint_bwd, g[d] as is; at p = 0 joint_gram_bwd; a
//          tap's tiles joint_prep_pieces + joint_bwd_pieces; C > 128
//          joint_prep_wide + joint_bwd_wide
//   * mi_joint.py:249 _joint_bwd_call / _band_kernel_bwd(transpose_g) (dx)
//       -> joint_prep + joint_bwd, g[D-1-d]^T (the same kernels)
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
// joint_bwd's epilogue writes; wider heads below):
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
//
// Three regimes that the design above served badly have their own launches.
//
// Heads wider than 128 lanes at p > 0 (IICRegParameters.DecoderParams
// num_clusters or num_subheads past S*K = 128: C = 150 at 5 x 30 clusters,
// 200 at 10 x 20), and above 256 lanes at p = 0. In 128-lane blocks such a
// head wastes most of its last block (at C = 150, 16 quarter tiles of J of
// which 9 hold a live lane, 4 K stages an output block of which 3 are live)
// and needs a launch per block pair. So each product is one launch on rows
// of W = 64 q lanes, q = ceil(C / 64) quarters (joint_core.cuh:
// joint_fwd_wide, joint_bwd_wide):
//   * one conversion pass an operand (CastWide: [N, W] bf16, zeros past C;
//     none for bf16 rows of W lanes) and g into H [ceil(C / 128), D, 128, W];
//   * joint_fwd_wide: joint_fwd_partial's block over the q^2 live quarter
//     tiles of J (9 at C = 150), staging its quarters of A and B at the wide
//     rows' stride; joint_fwd_reduce<true> sums the chunks into J [D, C, C];
//   * joint_bwd_wide: grid (row tiles, 128-lane output blocks); a block's
//     K loop runs over the displacements and the source's q quarters (3 at
//     C = 150), each (dy, quarter) slab of 256 + 2p rows staged once for its
//     T steps in a ring of slab buffers (2 at p = 3, 3 at p = 1), so the
//     quarters sum in the block's fp32 accumulators and the result is
//     written once in the operands' type (StoreWide), rounded once as at
//     128 lanes. An output block is the m64n128 accumulators' 128 lanes; a
//     last block of one quarter computes its 64 lanes alone, on m64n64
//     accumulators (C = 150: lanes 128-191 for 22 live ones).
//
// The joint at p = 0 (the pretrain decoder's IIC: N = 150,528 rows of
// C = 200 lanes, fp32). J = A^T B, dx_tf = A g and dx = B g^T are three
// plain GEMMs of 2*N*C^2 = 12 GFLOP (0.012 ms on the tensor cores) on
// 240.8 MB of fp32 operands read once (0.0719 ms): bound by bytes. Run
// through the design above it paid a conversion pass per 128-lane block
// pair, four launches a product, and a warpgroup idle (one displacement).
// Here each product is one launch over all C <= 256 lanes (cp = 128 or
// 256, zero-padded) that reads the operands in their own type and converts
// them in registers (no pass, no scratch copy):
//   * joint_gram_fwd: split-K over chunks of rows, one block per SM (66
//     chunks x 2 slabs at cp = 256). Block (slab, chunk) owns J's 128 rows
//     k1 of its slab and all cp columns k2: warpgroup w 64 rows k1 in cp/64
//     m64n64 accumulators (128 registers a thread at cp = 256). A stage of
//     32 rows (the slab's 128 lanes of A, cp of B) is loaded into registers
//     one stage ahead, 16 bytes a thread and unit, so a stage's loads are in
//     flight while the last one computes; it is stored as bf16 into one of
//     three shared buffers of [32][64] sub-tiles in the 128-byte swizzle (A
//     read by ldmatrix.trans, B by wgmma's descriptor). The two slab blocks
//     of a chunk are neighbours in the grid, so B's second read comes from
//     L2. joint_fwd_reduce sums the chunk partials (17 MB at cp = 256) in
//     chunk order.
//   * joint_gram_bwd: persistent blocks (one per SM) over tiles of rows.
//     Each block converts g (C x C fp32, read from L2) once into bf16 H
//     sub-tiles that stay in shared memory (128 KB at cp = 256), then for
//     each tile of 64 rows (128 at cp = 128) loads the next tile's S into
//     registers while it multiplies the current one: A fragments by ldmatrix
//     from the staged bf16 rows, B = H by descriptor, one m64n128
//     accumulator a warpgroup (the two split the 256 output lanes, or the
//     128 rows at cp = 128); the epilogue writes the C live lanes in the
//     operands' type, each fp32 sum rounded once.
//
// The tiles below the map (LossParams.patch_sizes < the map): every tile
// is its own canvas on its own zero border, gathered by
// ops/iic_local.py into one flat buffer piece after piece (169 pieces of
// 14,440 rows at Up_conv2, 36 of 11,560 at Up_conv3 at patch 32). One call
// a tile paid per piece three to five launches whose grids are far below
// the card's 132 SMs, a 100 MB chunk-partial round trip, and the host's
// plan, scratch and ctypes call (615 calls a step). Here each product takes
// every piece of a tap in one launch, the same kernels' bodies
// (joint_core.cuh: fwd_block, joint_bwd_tile) driven by a device table of
// (first row, rows, wp, first backward block) per piece:
//   * joint_fwd_pieces: grid (quarters x displacement groups x dy,
//     pieces): a block takes one whole piece as its one chunk, so it writes
//     its finished sums straight into J[piece] (C x C, no partials, no
//     chunk sum), and the blocks of one piece are neighbours (its operands
//     stay in L2).
//   * joint_bwd_pieces: each piece's 256-row tiles in turn; a block finds
//     its piece by binary search on the first blocks, reads only that
//     piece's rows (the rest read as zero, as a canvas of its own) and its
//     H[piece] (joint_prep_pieces converts each piece's g, reversed within
//     the piece for dx), and writes its rows of the flat gradient.
//   The bound counts each piece's live work: at patch 32 a tile's 32^2 live
//   pixels of its 38^2 canvas (chip_smoke.py:_live_bound).
// The launch plans (grid, stages, shared memory, chunking, the piece table)
// are computed in ops/mi_joint.py (launch_plan, gram_plan, pieces_plan); the
// entry points refuse a plan that disagrees with the kernels.
//
// ptxas (sm_90a, -O3; chip_smoke.py's build phase prints it), no spills:
// joint_bwd<6, StoreRows> 219 registers and 232,448 bytes of dynamic shared
// memory at p = 3 (230,400 at p = 1), 1 block per SM; joint_fwd_partial<7> 208
// registers, joint_fwd_partial<3> 128, each with 104,448 bytes, 1 block per
// SM; joint_fwd_pieces<7> 210, joint_bwd_pieces 231; joint_gram_fwd<256>
// 223 (fp32 operands) / 206 (bf16) with 73,728 bytes, joint_gram_bwd<256>
// 192 / 161 with 163,840 bytes; joint_prep and joint_fwd_reduce 32. The wide
// kernels' counts are in PERF.md (their shared memory: joint_fwd_wide the
// forward's, joint_bwd_wide 165,376 bytes at p = 3 and 197,376 at p = 1).

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

// ===========================================================================
// the grouped joint: every tile piece of a tap in one launch (bf16 products).
// Piece i is rows [first, first + rows) of the flat operands, a canvas of
// width wp; rows outside it read as zero. The table holds, per piece, four
// int64: first row, rows, wp, and the first block of its backward.
// ===========================================================================

constexpr int PIECE_FIELDS = 4;

// J[piece, d, k1, k2] (C x C fp32) from A, B [rows, 128] bf16; grid
// (4 * groups * T, n_pieces): one chunk a piece, so each block writes its
// finished sums straight into J (no partials, no chunk sum)
template <int TG>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_fwd_pieces(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                 const long long* __restrict__ pieces, float* __restrict__ out, int C, int p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const long long* e = pieces + (long long)PIECE_FIELDS * blockIdx.y;
  const long long first = e[0], rows = e[1];
  const int wp = (int)e[2];
  const int D = (2 * p + 1) * (2 * p + 1);
  float* J = out + (long long)blockIdx.y * D * C * C;
  const bool even = (C & 1) == 0;
  const auto store = [J, C, even](int d, int k1, int k2, float v0, float v1) {
    if (k1 >= C || k2 >= C) return;
    float* o = J + ((long long)d * C + k1) * C + k2;
    if (k2 + 1 < C && even) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      if (k2 + 1 < C) o[1] = v1;
    }
  };
  fwd_block<TG>(A + first * LANES, B + first * LANES, rows, p, wp, 0, rows, blockIdx.x, store,
                smem);
}

// out[first + n, j] for each piece: joint_bwd's product on the piece's rows
// of S [rows, 128] bf16 and its H[piece] [D, 128, 128]; grid (the pieces'
// blocks summed), each block finding its piece in the table by its first
// block
template <int STAGES, typename Out>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_bwd_pieces(const __nv_bfloat16* __restrict__ S, const __nv_bfloat16* __restrict__ H,
                 const long long* __restrict__ pieces, int n_pieces, int p, Out* __restrict__ out,
                 int C) {
  extern __shared__ __align__(1024) unsigned char smem[];
  int lo = 0, hi = n_pieces - 1;  // the last piece whose first block is at or before ours
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pieces[(long long)PIECE_FIELDS * mid + 3] <= (long long)blockIdx.x) lo = mid;
    else hi = mid - 1;
  }
  const long long* e = pieces + (long long)PIECE_FIELDS * lo;
  const long long first = e[0], rows = e[1];
  const int wp = (int)e[2];
  const long long n0 = ((long long)blockIdx.x - e[3]) * BW_TILE;
  const int D = (2 * p + 1) * (2 * p + 1);
  joint_bwd_tile<STAGES>(S + first * LANES, H + (long long)lo * D * LANES * LANES, rows, p, wp,
                         n0, StoreRows<Out>{out + first * C, C}, smem);
}

// the conversion pass of the grouped backward: S rows as joint_prep's, and
// H[piece, d] from g[piece] (each piece's displacements reversed on their own)
template <typename RowConv>
__global__ void __launch_bounds__(PREP_THREADS)
joint_prep_pieces(RowConv rows, const float* __restrict__ g, __nv_bfloat16* __restrict__ h, int C,
                  int d_total, int per, int transpose_g) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  rows(first, stride);
  convert_g(first, stride, g, h, C, d_total, per, transpose_g);
}

template <int TG>
cudaError_t launch_fwd_pieces(int n_pieces, int smem_bytes, cudaStream_t s,
                              const __nv_bfloat16* A, const __nv_bfloat16* B,
                              const long long* pieces, float* out, int c, int p) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_fwd_pieces<TG>, smem_set);
  if (err != cudaSuccess) return err;
  const int T = 2 * p + 1;
  const dim3 grid(4 * (T / TG) * T, n_pieces);
  joint_fwd_pieces<TG><<<grid, MMA_THREADS, smem_bytes, s>>>(A, B, pieces, out, c, p);
  return cudaGetLastError();
}

cudaError_t run_fwd_pieces(int dx_group, int n_pieces, int smem_bytes, cudaStream_t s,
                           const __nv_bfloat16* A, const __nv_bfloat16* B,
                           const long long* pieces, float* out, int c, int p) {
  switch (dx_group) {
    case 1: return launch_fwd_pieces<1>(n_pieces, smem_bytes, s, A, B, pieces, out, c, p);
    case 3: return launch_fwd_pieces<3>(n_pieces, smem_bytes, s, A, B, pieces, out, c, p);
    case 5: return launch_fwd_pieces<5>(n_pieces, smem_bytes, s, A, B, pieces, out, c, p);
    default: return launch_fwd_pieces<7>(n_pieces, smem_bytes, s, A, B, pieces, out, c, p);
  }
}

template <int STAGES, typename Out>
cudaError_t launch_bwd_pieces(int blocks, int n_pieces, int p, int smem_bytes, cudaStream_t s,
                              const __nv_bfloat16* S, const __nv_bfloat16* H,
                              const long long* pieces, Out* out, int c) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_bwd_pieces<STAGES, Out>, smem_set);
  if (err != cudaSuccess) return err;
  joint_bwd_pieces<STAGES, Out><<<blocks, MMA_THREADS, smem_bytes, s>>>(S, H, pieces, n_pieces,
                                                                        p, out, c);
  return cudaGetLastError();
}

template <typename Out>
cudaError_t run_bwd_pieces(int stages, int blocks, int n_pieces, int p, int smem_bytes,
                           cudaStream_t s, const __nv_bfloat16* S, const __nv_bfloat16* H,
                           const long long* pieces, Out* out, int c) {
  return stages == 6
             ? launch_bwd_pieces<6>(blocks, n_pieces, p, smem_bytes, s, S, H, pieces, out, c)
             : launch_bwd_pieces<4>(blocks, n_pieces, p, smem_bytes, s, S, H, pieces, out, c);
}

// ===========================================================================
// the joint at p = 0 over all lanes (bf16 products): J = A^T B, dx_tf = A g,
// dx = B g^T, C <= 256 lanes zero-padded to CP = 128 or 256, the operands
// converted to bf16 inside the kernels (no conversion pass).
// ===========================================================================

constexpr int GR_KT = 32;                  // forward: rows per stage
constexpr int GR_BUFS = 3;                 // forward: bf16 stage buffers
constexpr int GR_SUB_BYTES = GR_KT * 128;  // forward: one [32 rows][64 lanes] bf16 sub-tile
constexpr int GR_MAX_LANES = 256;

__host__ __device__ constexpr int gram_fwd_smem_bytes(int cp) {
  return GR_BUFS * (2 + cp / 64) * GR_SUB_BYTES;
}
__host__ __device__ constexpr int gram_bwd_rows(int cp) { return cp == 128 ? 128 : 64; }
__host__ __device__ constexpr int gram_bwd_smem_bytes(int cp) {
  return (cp / 128) * (cp / 64) * BW_H_BYTES + gram_bwd_rows(cp) * cp * 2;
}

// 8 lanes of a row of Src, lanes from `live` on zero, as 16 bytes of bf16;
// vec: whole 16-byte loads where 8 lanes are live (cast_vec)
template <typename Src>
struct Lanes8;

template <>
struct Lanes8<float> {
  float v[8];
  __device__ __forceinline__ void load(const float* s, int live, bool vec) {
    if (vec && live >= 8) {
      load8(s, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = e < live ? s[e] : 0.f;
    }
  }
  __device__ __forceinline__ uint4 bf16() const {
    return make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                      pack_bf16x2(v[6], v[7]));
  }
};

template <>
struct Lanes8<__nv_bfloat16> {
  uint4 w;
  __device__ __forceinline__ void load(const __nv_bfloat16* s, int live, bool vec) {
    if (vec && live >= 8) {
      w = *reinterpret_cast<const uint4*>(s);
    } else {
      uint32_t h[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) h[e] = e < live ? __bfloat16_as_ushort(s[e]) : 0u;
      w = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16),
                     h[6] | (h[7] << 16));
    }
  }
  __device__ __forceinline__ uint4 bf16() const { return w; }
};

// partial[chunk, k1, k2] (CP x CP fp32) = sum over the chunk's rows n of
// A[n, k1] * B[n, k2]. grid (CP / 128, n_chunks): block (slab, chunk) owns
// k1 in [128 slab, +128) and every k2; warpgroup w the 64 k1 from 64 w, in
// CP / 64 m64n64 accumulators (A^T by ldmatrix.trans from registers, B in
// shared memory N-contiguous). Each stage of GR_KT rows is loaded into
// registers one stage ahead (A's 128 lanes and B's CP, 16 bytes a thread and
// unit), converted, and stored into one of GR_BUFS bf16 buffers of sub-tiles
// [32 rows][64 lanes] (A's two, then B's CP / 64); a buffer is rewritten
// three stages after the wgmmas that read it, which wgmma.wait_group 1 and
// the stage's barrier have retired.
template <int CP, typename Src>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_gram_fwd(const Src* __restrict__ A, const Src* __restrict__ B, float* __restrict__ partial,
               long long N, int C, long long rows_per_chunk, int vec) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int NB = CP / 64;
  constexpr int STAGE = (2 + NB) * GR_SUB_BYTES;
  constexpr int A_UNITS = GR_KT * 16 / MMA_THREADS;       // units of A a thread and stage
  constexpr int UNITS = A_UNITS + GR_KT * (CP / 8) / MMA_THREADS;
  const uint32_t smem_s = smem_addr(smem);
  if (smem_s & 1023) __trap();
  const int slab = blockIdx.x;
  const long long chunk = blockIdx.y;
  const long long n_begin = chunk * rows_per_chunk;
  const long long n_end = min(N, n_begin + rows_per_chunk);
  const int n_stages = n_end > n_begin ? (int)((n_end - n_begin + GR_KT - 1) / GR_KT) : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const bool v = vec != 0;

  // unit i of thread tid: row r of the stage, 8-lane chunk c of A's slab or of B
  auto unit = [&](int i, int& r, int& c) {
    const int k = tid + (i < A_UNITS ? i : i - A_UNITS) * MMA_THREADS;
    const int per_row = i < A_UNITS ? 16 : CP / 8;
    r = k / per_row;
    c = k % per_row;
  };
  Lanes8<Src> u[UNITS];
  auto load = [&](int st) {
    const long long r0 = n_begin + (long long)st * GR_KT;
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      int r, c;
      unit(i, r, c);
      const int lane0 = (i < A_UNITS ? slab * 128 : 0) + c * 8;
      const long long row = r0 + r;
      const bool in = row < n_end;
      u[i].load((i < A_UNITS ? A : B) + (in ? row : 0) * C + lane0, in ? C - lane0 : 0, v);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      int r, c;
      unit(i, r, c);
      const int tile = (i < A_UNITS ? 0 : 2) + (c >> 3);
      *reinterpret_cast<uint4*>(smem + buf * STAGE + tile * GR_SUB_BYTES + swz(r, c & 7, 128)) =
          u[i].bf16();
    }
  };

  float acc[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[nb][e] = 0.f;
  const int a_row = ((lane >> 4) << 3) + (lane & 7);
  const int a_chunk = wq * 2 + ((lane >> 3) & 1);
  uint32_t a0[4], a1[4];
  auto kstep = [&](uint32_t stage_s, int kk, uint32_t (&a)[4]) {
    ldsm4_t(stage_s + wg * GR_SUB_BYTES + swz(kk * 16 + a_row, a_chunk, 128), a);
    wgmma_fence();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      wgmma_m64n64k16_tb(acc[nb], a, desc_sw128_mn(stage_s + (2 + nb) * GR_SUB_BYTES + kk * 2048));
    wgmma_commit();
    wgmma_wait<1>();
  };

  if (n_stages > 0) load(0);
#pragma unroll 1
  for (int st = 0; st < n_stages; ++st) {
    store(st % GR_BUFS);
    if (st + 1 < n_stages) load(st + 1);
    // the stores went through the generic proxy; wgmma reads B through the async one
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t stage_s = smem_s + (st % GR_BUFS) * STAGE;
    kstep(stage_s, 0, a0);
    kstep(stage_s, 1, a1);
  }
  wgmma_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
  const int k1 = slab * 128 + wg * 64 + wq * 16 + g;
  float* P = partial + chunk * (long long)CP * CP;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8) {
      const int k2 = nb * 64 + c8 * 8 + 2 * t4;
      *reinterpret_cast<float2*>(P + (long long)k1 * CP + k2) =
          make_float2(acc[nb][4 * c8], acc[nb][4 * c8 + 1]);
      *reinterpret_cast<float2*>(P + (long long)(k1 + 8) * CP + k2) =
          make_float2(acc[nb][4 * c8 + 2], acc[nb][4 * c8 + 3]);
    }
}

// out[n, j] (C lanes, in Src's type, each fp32 sum rounded once) = sum_k
// S[n, k] * G[j, k], G = g (transpose_g = 1) or g^T (0). Persistent blocks
// (grid at most the SM count) over tiles of gram_bwd_rows(CP) rows. Each
// block first converts all of G to bf16 into shared memory, as joint_bwd's H
// stages ([128 j][64 k] sub-tiles, the wgmma B operand), and keeps it; a tile
// of S is loaded into registers one tile ahead, converted and stored as rows
// of CP bf16, whose A fragments come by ldmatrix. At CP = 128 the two
// warpgroups take 64 rows each of a 128-row tile and all 128 j; at CP = 256
// both take the 64-row tile, warpgroup w the j from 128 w; each holds one
// m64n128 fp32 accumulator.
template <int CP, typename Src>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_gram_bwd(const Src* __restrict__ S, const float* __restrict__ g, Src* __restrict__ out,
               long long N, int C, int transpose_g, int vec) {
  extern __shared__ __align__(1024) unsigned char smem[];
  constexpr int BM = gram_bwd_rows(CP);
  constexpr int KC = CP / 64;                 // H sub-tiles along k
  constexpr int ROW_B = CP * 2;               // a staged bf16 row of S
  constexpr int H_BYTES = (CP / 128) * KC * BW_H_BYTES;
  constexpr int UNITS = BM * (CP / 8) / MMA_THREADS;
  const uint32_t smem_s = smem_addr(smem);
  if (smem_s & 1023) __trap();
  unsigned char* s_tile = smem + H_BYTES;
  const uint32_t s_s = smem_s + H_BYTES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const long long tiles = (N + BM - 1) / BM;
  const bool v = vec != 0;

  Lanes8<Src> u[UNITS];
  auto load = [&](long long t) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int k = tid + i * MMA_THREADS;
      const int r = k / (CP / 8), c = k % (CP / 8);
      const long long row = t * BM + r;
      const bool in = row < N;
      u[i].load(S + (in ? row : 0) * C + c * 8, in ? C - c * 8 : 0, v);
    }
  };
  long long t = blockIdx.x;
  if (t < tiles) load(t);

  // G into shared memory: threads run along j where g is read down a column
  // (transpose_g = 0), along k where it is read along a row
  for (int idx = tid; idx < CP * (CP / 8); idx += MMA_THREADS) {
    const int j = transpose_g ? idx / (CP / 8) : idx % CP;
    const int k0 = (transpose_g ? idx % (CP / 8) : idx / CP) * 8;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + e;
      x[e] = (j < C && k < C) ? (transpose_g ? g[(long long)j * C + k] : g[(long long)k * C + j])
                              : 0.f;
    }
    *reinterpret_cast<uint4*>(smem + ((j >> 7) * KC + (k0 >> 6)) * BW_H_BYTES +
                              swz(j & 127, (k0 & 63) >> 3, 128)) =
        make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]), pack_bf16x2(x[4], x[5]),
                   pack_bf16x2(x[6], x[7]));
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const int r_off = CP == 128 ? wg * 64 : 0;
  const int jb = CP == 128 ? 0 : wg;
  const uint32_t h_s = smem_s + jb * KC * BW_H_BYTES;
  const int a_row = r_off + wq * 16 + (lane & 15);
  const int a_chunk = lane >> 4;
  const int gr = lane >> 2, t4 = lane & 3;
  const bool even = (C & 1) == 0;
  float acc[64];
  uint32_t a0[4], a1[4];
  auto kstep = [&](int kk, uint32_t (&a)[4]) {
    ldsm4(s_s + swz(a_row, kk * 2 + a_chunk, ROW_B), a);
    wgmma_fence();
    wgmma_m64n128k16(acc, a, desc_sw128(h_s + (kk >> 2) * BW_H_BYTES + (kk & 3) * 32));
    wgmma_commit();
    wgmma_wait<1>();
  };
#pragma unroll 1
  for (; t < tiles; t += gridDim.x) {
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int k = tid + i * MMA_THREADS;
      *reinterpret_cast<uint4*>(s_tile + swz(k / (CP / 8), k % (CP / 8), ROW_B)) = u[i].bf16();
    }
    if (t + gridDim.x < tiles) load(t + gridDim.x);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < CP / 16; kk += 2) {
      kstep(kk, a0);
      kstep(kk + 1, a1);
    }
    wgmma_wait<0>();
    __syncthreads();  // every warp has read the tile before the next one is stored
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long row = t * BM + r_off + wq * 16 + gr + half * 8;
      if (row >= N) continue;
#pragma unroll
      for (int c8 = 0; c8 < 16; ++c8) {
        const int col = jb * 128 + c8 * 8 + 2 * t4;
        const float v0 = acc[4 * c8 + 2 * half], v1 = acc[4 * c8 + 2 * half + 1];
        Src* o = out + row * C + col;
        if (col + 1 < C) {
          if (even) {
            store2(o, v0, v1);
          } else {
            store1(o, v0);
            store1(o + 1, v1);
          }
        } else if (col < C) {
          store1(o, v0);
        }
      }
    }
  }
}

bool gram_plan_ok(int c, int cp, int smem_bytes, bool forward) {
  return c >= 1 && c <= GR_MAX_LANES && cp == (c <= LANES ? LANES : GR_MAX_LANES) &&
         smem_bytes == (forward ? gram_fwd_smem_bytes(cp) : gram_bwd_smem_bytes(cp));
}

template <int CP, typename Src>
cudaError_t launch_gram_fwd(int n_chunks, int smem_bytes, cudaStream_t s, const Src* A,
                            const Src* B, float* partial, float* out, long long n, int c,
                            long long rows_per_chunk) {
  static bool smem_set = false;
  cudaError_t err = allow_smem(joint_gram_fwd<CP, Src>, smem_set);
  if (err != cudaSuccess) return err;
  joint_gram_fwd<CP, Src><<<dim3(CP / 128, n_chunks), MMA_THREADS, smem_bytes, s>>>(
      A, B, partial, n, c, rows_per_chunk, cast_vec<Src>(c, A, B));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  joint_fwd_reduce<false><<<reduce_blocks((long long)c * c), 256, 0, s>>>(partial, out, 1, c,
                                                                          CP, n_chunks);
  return cudaGetLastError();
}

template <typename Src>
cudaError_t run_gram_fwd(int cp, int n_chunks, int smem_bytes, cudaStream_t s, const void* a,
                         const void* b, float* partial, float* out, long long n, int c,
                         long long rows_per_chunk) {
  const Src* A = static_cast<const Src*>(a);
  const Src* B = static_cast<const Src*>(b);
  return cp == LANES ? launch_gram_fwd<LANES>(n_chunks, smem_bytes, s, A, B, partial, out, n, c,
                                              rows_per_chunk)
                     : launch_gram_fwd<GR_MAX_LANES>(n_chunks, smem_bytes, s, A, B, partial,
                                                     out, n, c, rows_per_chunk);
}

template <int CP, typename Src>
cudaError_t launch_gram_bwd(int blocks, int smem_bytes, cudaStream_t s, const Src* S,
                            const float* g, Src* out, long long n, int c, int transpose_g) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_gram_bwd<CP, Src>, smem_set);
  if (err != cudaSuccess) return err;
  joint_gram_bwd<CP, Src><<<blocks, MMA_THREADS, smem_bytes, s>>>(
      S, g, out, n, c, transpose_g, cast_vec<Src>(c, S, nullptr));
  return cudaGetLastError();
}

template <typename Src>
cudaError_t run_gram_bwd(int cp, int blocks, int smem_bytes, cudaStream_t s, const void* src,
                         const float* g, void* out, long long n, int c, int transpose_g) {
  const Src* S = static_cast<const Src*>(src);
  Src* O = static_cast<Src*>(out);
  return cp == LANES
             ? launch_gram_bwd<LANES>(blocks, smem_bytes, s, S, g, O, n, c, transpose_g)
             : launch_gram_bwd<GR_MAX_LANES>(blocks, smem_bytes, s, S, g, O, n, c, transpose_g);
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

// bf16 operands: the same product from src [N, C] bf16 into out [N, C] bf16
// (each fp32 sum over all displacements rounded once); g stays fp32 (the
// cotangent of the fp32 J). With s16 == null, src must be rows of 128 lanes,
// 16-byte aligned: the conversion pass then converts g alone; otherwise it
// also pads src into s16 [N, 128] bf16.
int mi_joint_bwd_bf16in(const void* src, const float* g, void* s16, void* h16, void* out,
                        long long n_rows, int c, int p, int wp, int transpose_g, int stages,
                        int smem_bytes, void* stream) {
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
  return (int)run_bwd(stages, n_rows, p, wp, smem_bytes, s, operand, H16,
                      StoreRows<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), c});
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
  joint_fwd_reduce<false><<<reduce_blocks((long long)D * c * c), 256, 0, s>>>(partial, out, D, c,
                                                                             c, n_chunks);
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


// The grouped joint (bf16 products): every piece of the table [n_pieces, 4]
// int64 (first row, rows, wp, first backward block) in one launch of the
// product. Forward: J [n_pieces, D, C, C] fp32 from A, B [total, C] (fp32,
// or bf16 with src_bf16); a16, b16: [total, 128] bf16 scratch the
// conversion pass fills (null: bf16 rows of 128 lanes read in place).
int mi_joint_fwd_pieces(const void* a, const void* b, int src_bf16, void* a16, void* b16,
                        const long long* pieces, int n_pieces, float* out, long long total_rows,
                        int c, int p, int dx_group, int smem_bytes, void* stream) {
  if (!fwd_plan_ok(c, p, dx_group, smem_bytes) || n_pieces < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
  if (a16 == nullptr || b16 == nullptr) {
    if (a16 != b16 || !src_bf16 || c != LANES || !aligned16(a) || !aligned16(b))
      return (int)cudaErrorInvalidValue;
  } else {
    auto* A16 = static_cast<__nv_bfloat16*>(a16);
    auto* B16 = static_cast<__nv_bfloat16*>(b16);
    const unsigned blocks = prep_blocks(2 * total_rows * (LANES / 8));
    if (src_bf16) {
      const CastRows<__nv_bfloat16> rows{A, A16, B, B16, total_rows, c,
                                         cast_vec<__nv_bfloat16>(c, a, b)};
      joint_prep<<<blocks, PREP_THREADS, 0, s>>>(rows, nullptr, nullptr, c, 0, 0);
    } else {
      const auto* af = static_cast<const float*>(a);
      const auto* bf = static_cast<const float*>(b);
      const CastRows<float> rows{af, A16, bf, B16, total_rows, c, cast_vec<float>(c, a, b)};
      joint_prep<<<blocks, PREP_THREADS, 0, s>>>(rows, nullptr, nullptr, c, 0, 0);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    A = A16;
    B = B16;
  }
  return (int)run_fwd_pieces(dx_group, n_pieces, smem_bytes, s, A, B, pieces, out, c, p);
}

// Backward: out [total, C] in the operands' type (each fp32 sum over the
// piece's displacements rounded once) from src [total, C] and g
// [n_pieces, D, C, C] fp32, piece by piece as mi_joint_bwd_bf16 computes one
// canvas; s16: [total, 128] bf16 scratch (null: bf16 rows of 128 lanes read
// in place); h16: [n_pieces, D, 128, 128] bf16 scratch.
int mi_joint_bwd_pieces(const void* src, int src_bf16, const float* g, void* s16, void* h16,
                        const long long* pieces, int n_pieces, int blocks, void* out,
                        long long total_rows, int c, int p, int transpose_g, int stages,
                        int smem_bytes, void* stream) {
  if (!bwd_plan_ok(c, p, stages, smem_bytes) || n_pieces < 1) return (int)cudaErrorInvalidValue;
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  if (S16 == nullptr && (!src_bf16 || c != LANES || !aligned16(src)))
    return (int)cudaErrorInvalidValue;
  const long long rows_n = S16 == nullptr ? 0 : total_rows;
  const unsigned prep = prep_blocks(rows_n * (LANES / 8) + h_units(n_pieces * D));
  if (src_bf16) {
    const auto* sb = static_cast<const __nv_bfloat16*>(src);
    const CastRows<__nv_bfloat16> rows{sb, S16, nullptr, nullptr, rows_n, c,
                                       cast_vec<__nv_bfloat16>(c, src, nullptr)};
    joint_prep_pieces<<<prep, PREP_THREADS, 0, s>>>(rows, g, H16, c, n_pieces * D, D,
                                                    transpose_g);
  } else {
    const auto* sf = static_cast<const float*>(src);
    const CastRows<float> rows{sf, S16, nullptr, nullptr, rows_n, c,
                               cast_vec<float>(c, src, nullptr)};
    joint_prep_pieces<<<prep, PREP_THREADS, 0, s>>>(rows, g, H16, c, n_pieces * D, D,
                                                    transpose_g);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* S =
      S16 == nullptr ? static_cast<const __nv_bfloat16*>(src) : S16;
  if (src_bf16)
    return (int)run_bwd_pieces(stages, blocks, n_pieces, p, smem_bytes, s, S, H16, pieces,
                               static_cast<__nv_bfloat16*>(out), c);
  return (int)run_bwd_pieces(stages, blocks, n_pieces, p, smem_bytes, s, S, H16, pieces,
                             static_cast<float*>(out), c);
}

// The joint at p = 0 over all lanes (bf16 products), C <= 256, operands
// [N, C] fp32 or bf16 (src_bf16) converted inside the kernels. Forward: J
// [C, C] fp32; partial: n_chunks x cp x cp floats of scratch (cp = 128 or
// 256, the lanes the kernels compute).
int mi_joint_gram_fwd(const void* a, const void* b, int src_bf16, float* partial, float* out,
                      long long n_rows, int c, int cp, long long rows_per_chunk, int n_chunks,
                      int smem_bytes, void* stream) {
  if (!gram_plan_ok(c, cp, smem_bytes, true) || rows_per_chunk % GR_KT != 0 ||
      rows_per_chunk * n_chunks < n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(src_bf16 ? run_gram_fwd<__nv_bfloat16>(cp, n_chunks, smem_bytes, s, a, b, partial,
                                                      out, n_rows, c, rows_per_chunk)
                        : run_gram_fwd<float>(cp, n_chunks, smem_bytes, s, a, b, partial, out,
                                              n_rows, c, rows_per_chunk));
}

// Backward: out [N, C] in src's type = src @ g (transpose_g = 0: dx_tf) or
// src @ g^T (1: dx), g [C, C] fp32; `blocks` persistent blocks.
int mi_joint_gram_bwd(const void* src, int src_bf16, const float* g, void* out, long long n_rows,
                      int c, int cp, int transpose_g, int blocks, int smem_bytes, void* stream) {
  if (!gram_plan_ok(c, cp, smem_bytes, false) || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(src_bf16 ? run_gram_bwd<__nv_bfloat16>(cp, blocks, smem_bytes, s, src, g, out,
                                                      n_rows, c, transpose_g)
                        : run_gram_bwd<float>(cp, blocks, smem_bytes, s, src, g, out, n_rows, c,
                                              transpose_g));
}

// The wide joint (bf16 products), C > 128 lanes at p > 0 and C > 256 at
// p = 0: rows of W = wide_lanes(C) lanes, one launch a product over the live
// quarters. Forward: J [D, C, C] fp32 from A, B [N, C] (fp32, or bf16 with
// src_bf16); a16, b16: [N, W] bf16 scratch the conversion pass fills (null:
// bf16 rows of W = C lanes, 16-byte aligned, read in place: no pass);
// partial: n_chunks x D x W x W floats.
int mi_joint_fwd_wide(const void* a, const void* b, int src_bf16, void* a16, void* b16,
                      float* partial, float* out, long long n_rows, int c, int p, int wp,
                      long long rows_per_chunk, int n_chunks, int dx_group, int smem_bytes,
                      void* stream) {
  const int w = wide_lanes(c);
  if (!wide_fwd_plan_ok(c, w, p, dx_group, smem_bytes) || rows_per_chunk % FW_KT != 0 ||
      rows_per_chunk * n_chunks < n_rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(a);
  const __nv_bfloat16* B = static_cast<const __nv_bfloat16*>(b);
  if (a16 == nullptr || b16 == nullptr) {
    if (a16 != b16 || !src_bf16 || c != w || !aligned16(a) || !aligned16(b))
      return (int)cudaErrorInvalidValue;
  } else {
    auto* A16 = static_cast<__nv_bfloat16*>(a16);
    auto* B16 = static_cast<__nv_bfloat16*>(b16);
    const unsigned blocks = prep_blocks(2 * n_rows * (w / 8));
    if (src_bf16) {
      const CastWide<__nv_bfloat16> rows{A, A16, B, B16, n_rows, c, w,
                                         cast_vec<__nv_bfloat16>(c, a, b)};
      joint_prep_wide<<<blocks, PREP_THREADS, 0, s>>>(rows, nullptr, nullptr, c, 0, w, 0, 0);
    } else {
      const auto* af = static_cast<const float*>(a);
      const auto* bf = static_cast<const float*>(b);
      const CastWide<float> rows{af, A16, bf, B16, n_rows, c, w, cast_vec<float>(c, a, b)};
      joint_prep_wide<<<blocks, PREP_THREADS, 0, s>>>(rows, nullptr, nullptr, c, 0, w, 0, 0);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    A = A16;
    B = B16;
  }
  return (int)run_fwd_wide(dx_group, n_chunks, smem_bytes, s, A, B, partial, out, n_rows, c, p,
                           wp, w, rows_per_chunk);
}

// Backward: out [N, C] in src's type (fp32, or bf16 with src_bf16: each fp32
// sum over all displacements and quarters rounded once) = sum_d src[n + o_d]
// @ g[d] (transpose_g = 0) or sum_d src[n - o_d] @ g[d]^T (1), g [D, C, C]
// fp32; s16: [N, W] bf16 scratch (null: bf16 rows of W = C lanes read in
// place); h16: [ceil(C / 128), D, 128, W] bf16 scratch; `slabs` source slab
// buffers.
int mi_joint_bwd_wide(const void* src, int src_bf16, const float* g, void* s16, void* h16,
                      void* out, long long n_rows, int c, int p, int wp, int transpose_g,
                      int stages, int slabs, int smem_bytes, void* stream) {
  const int w = wide_lanes(c);
  const int nob = wide_out_blocks(c);
  if (c < 1 || !wide_bwd_plan_ok(p, stages, slabs, smem_bytes)) return (int)cudaErrorInvalidValue;
  const int T = 2 * p + 1;
  const int D = T * T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* S16 = static_cast<__nv_bfloat16*>(s16);
  auto* H16 = static_cast<__nv_bfloat16*>(h16);
  if (S16 == nullptr && (!src_bf16 || c != w || !aligned16(src)))
    return (int)cudaErrorInvalidValue;
  const long long rows_n = S16 == nullptr ? 0 : n_rows;  // no rows to convert
  const unsigned prep = prep_blocks(rows_n * (w / 8) + h_units_wide(D, w, nob));
  if (src_bf16) {
    const auto* sb = static_cast<const __nv_bfloat16*>(src);
    const CastWide<__nv_bfloat16> rows{sb, S16, nullptr, nullptr, rows_n, c, w,
                                       cast_vec<__nv_bfloat16>(c, src, nullptr)};
    joint_prep_wide<<<prep, PREP_THREADS, 0, s>>>(rows, g, H16, c, D, w, nob, transpose_g);
  } else {
    const auto* sf = static_cast<const float*>(src);
    const CastWide<float> rows{sf, S16, nullptr, nullptr, rows_n, c, w,
                               cast_vec<float>(c, src, nullptr)};
    joint_prep_wide<<<prep, PREP_THREADS, 0, s>>>(rows, g, H16, c, D, w, nob, transpose_g);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* S = S16 == nullptr ? static_cast<const __nv_bfloat16*>(src) : S16;
  if (src_bf16)
    return (int)run_bwd_wide(stages, n_rows, p, wp, w, nob, slabs, smem_bytes, s, S, H16,
                             StoreWide<__nv_bfloat16>{static_cast<__nv_bfloat16*>(out), c, c});
  return (int)run_bwd_wide(stages, n_rows, p, wp, w, nob, slabs, smem_bytes, s, S, H16,
                           StoreWide<float>{static_cast<float*>(out), c, c});
}

}  // extern "C"
