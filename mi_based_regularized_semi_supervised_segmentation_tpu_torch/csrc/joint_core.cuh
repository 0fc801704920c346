// The bf16 tensor-core core of the displaced-MI joint, for Hopper (sm_90a):
// the conversion pass (joint_prep), the backward product (joint_bwd), the
// split-K forward (joint_fwd_partial) and its chunk sum (joint_fwd_reduce),
// with their launchers and the checks of a launch plan. One copy, included by
// mi_joint.cu (the joint on probability maps) and mi_fused.cu (the fused
// softmax + mask + joint on logits). The two differ only in two policies,
// both template parameters:
//   * how joint_prep converts the rows of an operand (RowConv): the bf16 cast
//     of C lanes (CastRows, below), or the row-max group softmax times the
//     interior mask (mi_fused.cu);
//   * what joint_bwd writes after its last wgmma (Epilogue): the product in
//     the operands' type (StoreRows, below), or the softmax VJP of the
//     block's own rows (mi_fused.cu).
// Each takes fp32 or bf16 operands (the model's compute dtype); the products
// run on bf16 either way and sum in fp32. joint_bwd's body is a device
// function of a block's rows (joint_bwd_tile), and the forward's has a copy
// that hands each finished sum to a store (fwd_block), so that mi_joint.cu's
// grouped kernels run them on each piece of a flat buffer of canvases.
// Rows are 128 lanes (C <= 128, zero-padded to 128) for all of these. Rows
// of more lanes (C > 128) take the wide kernels at the end of the file
// (joint_fwd_wide, joint_bwd_wide): rows of W = 64 q lanes, q = ceil(C / 64)
// quarters, zero beyond C, each product one launch over the live quarters.
// The design and its bounds are described in mi_joint.cu.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int LANES = 128;                     // a row of C <= 128 lanes, zero-padded
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
constexpr int PREP_THREADS = 256;              // joint_prep: 8 warps a block
constexpr int SMEM_MAX = 232448;               // dynamic shared memory a block may use on an H100
constexpr int WIDE_Q = 64;                     // the wide kernels' lane quarter (= FW_HALF = BW_KC)
constexpr int WIDE_ROW_BYTES = WIDE_Q * 2;     // joint_bwd_wide: a staged slab row, one quarter

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

// D[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, K-major as
// wgmma_m64n128k16's: the first 64 rows n of such a tile)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
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

// ---------------------------------------------------------------------------
// joint_prep: the bf16 operands of the tensor-core kernels, in one launch of
// PREP_THREADS-thread blocks, grid-stride:
//   rows: the RowConv policy writes dst_i[r, 0:128] (i = 0, 1) from its
//         sources (fp32 or bf16; none when the operands are bf16 rows of 128
//         lanes already);
//   g:    H[d, j, k] = bf16_rn(transpose_g ? g[D-1-d, j, k] : g[d, k, j]),
//         zero beyond C (g may be null)
// so that joint_bwd computes out[n, j] = sum_d sum_k S[n + o_d, k] H[d, j, k]
// for both backward products.
// ---------------------------------------------------------------------------

// a float or bf16 element as float
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 8 consecutive elements from 16 bytes (two float4, or one uint4 of bf16)
__device__ __forceinline__ void load8(const float* s, float (&v)[8]) {
  const float4 x = *reinterpret_cast<const float4*>(s);
  const float4 y = *reinterpret_cast<const float4*>(s + 4);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* s, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(s);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// RowConv of the joint: dst_i[r, 0:128] = bf16_rn(src_i[r, 0:C]), zero
// beyond C (i = 0, 1; src1 may be null), one 16-byte destination chunk a
// thread and step. Src is float, or bf16 (then a copy that pads the rows to
// 128 lanes: a bf16 value converts to float and back exactly). vec: C fills
// whole 16-byte chunks of Src and both sources are 16-byte aligned.
template <typename Src>
struct CastRows {
  const Src* src0;
  __nv_bfloat16* dst0;
  const Src* src1;
  __nv_bfloat16* dst1;
  long long n;
  int C;
  int vec;

  __device__ __forceinline__ void operator()(long long first, long long stride) const {
    const long long units0 = n * (LANES / 8);
    const long long total = src1 ? 2 * units0 : units0;
    for (long long i = first; i < total; i += stride) {
      const bool second = i >= units0;
      const long long u = second ? i - units0 : i;
      const long long r = u / (LANES / 8);
      const int c0 = (int)(u % (LANES / 8)) * 8;
      const Src* s = (second ? src1 : src0) + r * C + c0;
      float v[8];
      if (vec && c0 + 8 <= C) {
        load8(s, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c0 + e < C ? to_float(s[e]) : 0.f;
      }
      *reinterpret_cast<uint4*>((second ? dst1 : dst0) + r * LANES + c0) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                     pack_bf16x2(v[6], v[7]));
    }
  }
};

// CastRows' vec for C lanes of Src at the two row bases (b may be null)
template <typename Src>
int cast_vec(int C, const void* a, const void* b) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b);
  return C % (16 / (int)sizeof(Src)) == 0 && (bits & 15u) == 0;
}

// H[d] from g for d in [0, D): each run of `per` displacements (a piece's;
// per = D for one call) reversed on its own with transpose_g
__device__ __forceinline__ void convert_g(long long first, long long stride,
                                          const float* __restrict__ g,
                                          __nv_bfloat16* __restrict__ h, int C, int D, int per,
                                          int transpose_g) {
  const long long units_g = (long long)D * LANES * (LANES / 8);
  for (long long u = first; u < units_g; u += stride) {
    const int d = (int)(u / (LANES * (LANES / 8)));
    const int j = (int)(u / (LANES / 8)) % LANES;
    const int k0 = (int)(u % (LANES / 8)) * 8;
    const int base = d / per * per;
    const int src_d = base + per - 1 - (d - base);
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + e;
      v[e] = (j < C && k < C) ? (transpose_g ? g[((long long)src_d * C + j) * C + k]
                                             : g[((long long)d * C + k) * C + j])
                              : 0.f;
    }
    *reinterpret_cast<uint4*>(h + ((long long)d * LANES + j) * LANES + k0) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  }
}

template <typename RowConv>
__global__ void __launch_bounds__(PREP_THREADS)
joint_prep(RowConv rows, const float* __restrict__ g, __nv_bfloat16* __restrict__ h, int C, int D,
           int transpose_g) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  rows(first, stride);
  if (g == nullptr) return;
  convert_g(first, stride, g, h, C, D, D, transpose_g);
}

// units of H that joint_prep converts (16-byte chunks)
__host__ __device__ constexpr long long h_units(int D) { return (long long)D * LANES * (LANES / 8); }

// ---------------------------------------------------------------------------
// joint_bwd: out[n, j] = sum_d sum_k S[n + o_d, k] * H[d, j, k], rows outside
// [0, N) of S reading as zero; S [N, 128] bf16, H [D, 128, 128] bf16; what is
// written is the Epilogue's.
// grid (ceil(N / BW_TILE)), 256 threads = two warpgroups of 128 output rows
// each (two m64n128 fp32 accumulators, 128 registers a thread). Dynamic
// shared memory bwd_smem_bytes(p, STAGES): STAGES H stages first (1024-byte
// aligned: the wgmma B operand), then two source slabs of BW_TILE + 2p rows.
// K-loop step s = (d, kc): dy = s / (2T), dx = (s / 2) % T, kc = s % 2; the
// step's A fragments come by ldmatrix from the slab of its dy at row offset
// dx, and wgmma reads them from registers. STAGES - 2 steps are in flight: a
// step's H stage is refilled two steps later, once both warpgroups have
// waited for the wgmmas that read it (wgmma.wait_group 1 after each step).
// The Epilogue runs after every wgmma of the thread's warpgroup has completed
// and every cp.async of the thread has landed; it may reuse all of the
// dynamic shared memory once the block has passed a barrier.
// ---------------------------------------------------------------------------

// two adjacent outputs, and one, as float or as bf16 (each fp32 sum rounded
// once)
__device__ __forceinline__ void store2(float* o, float v0, float v1) {
  *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

// Epilogue of the joint: the fp32 accumulators to out [N, C] (lanes < C), as
// Out (float, or bf16 for bf16 operands).
template <typename Out>
struct StoreRows {
  Out* out;
  int C;

  __device__ __forceinline__ void operator()(float (&acc)[2][64], unsigned char*, long long n0,
                                             long long N, int tid) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, wq = warp & 3;
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
          Out* o = out + row * C + col;
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
};

// one block's BW_TILE output rows from n0 (joint_bwd's body; the grouped
// backward of mi_joint.cu calls it on a piece's rows)
template <int STAGES, typename Epilogue>
__device__ __forceinline__ void joint_bwd_tile(const __nv_bfloat16* __restrict__ S,
                                               const __nv_bfloat16* __restrict__ H, long long N,
                                               int p, int wp, long long n0, const Epilogue& epi,
                                               unsigned char* smem) {
  const int T = 2 * p + 1;
  const int slab_rows = BW_TILE + 2 * p;
  const uint32_t slab_bytes = (uint32_t)slab_rows * ROW_BYTES;
  const uint32_t h_s = smem_addr(smem);
  const uint32_t slab_s = h_s + STAGES * BW_H_BYTES;
  if (h_s & 1023) __trap();  // the swizzled wgmma operand needs a 1024-byte aligned base

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
  epi(acc, smem, n0, N, tid);
}

template <int STAGES, typename Epilogue>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_bwd(const __nv_bfloat16* __restrict__ S, const __nv_bfloat16* __restrict__ H, long long N,
          int p, int wp, Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem[];
  joint_bwd_tile<STAGES>(S, H, N, p, wp, (long long)blockIdx.x * BW_TILE, epi, smem);
}

// ---------------------------------------------------------------------------
// joint_fwd_partial: partial[chunk, d, k1, k2] (128 x 128 tiles) = sum over
// the chunk's rows n of A[n + o_d, k1] * B[n, k2], rows outside [0, N) of A
// reading as zero; A, B [N, 128] bf16. grid (4 * groups * T, n_chunks),
// groups = T / TG: blockIdx.x = quarter + 4 * (group + groups * dy); the block
// covers dx in [group*TG, +TG) and the 64 x 64 quarter (k1 half q >> 1, k2
// half q & 1). FW_STAGES stages of fwd_stage_bytes(TG), 1024-byte aligned: a
// B slice (FW_KT rows x 64 k2, N-contiguous: the wgmma B operand) and the A
// slab (FW_KT + TG - 1 rows x 64 k1) that all the block's dx read. The two
// warpgroups split the TG displacements ((TG + 1) / 2 and the rest; they
// share the SM's tensor cores, so the uneven split costs no tensor time),
// each keeping one m64n64 fp32 accumulator per displacement; A (k1 x n, the
// shifted operand) comes by ldmatrix.trans at row offset dx, from registers.
// STAGES - 2 stages are in flight, as in joint_bwd.
// ---------------------------------------------------------------------------
// LD: the partial tiles' row stride, LANES for joint_fwd_partial; 0 takes
// it from ld (joint_fwd_wide's W), so the 128-lane kernel compiles as it did
template <int J, int LD, typename Prefetch>
__device__ __forceinline__ void fwd_wg_loop(uint32_t smem_s, uint32_t stage_bytes,
                                            uint32_t b_bytes, int n_stages, int j0, int wq,
                                            int lane, float* partial_d, long long tile_stride,
                                            int ld_rt, int k1_0, int k2_0,
                                            const Prefetch& prefetch) {
  constexpr int JA = J > 0 ? J : 1;
  const int ld = LD > 0 ? LD : ld_rt;
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
        *reinterpret_cast<float2*>(P + k1 * ld + k2) =
            make_float2(acc[j][4 * c8], acc[j][4 * c8 + 1]);
        *reinterpret_cast<float2*>(P + (k1 + 8) * ld + k2) =
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
    fwd_wg_loop<J0, LANES>(smem_s, STAGE_BYTES, B_BYTES, n_stages, 0, warp, lane, partial_d,
                           tile, LANES, h1 * FW_HALF, h2 * FW_HALF, prefetch);
  } else {
    fwd_wg_loop<J1, LANES>(smem_s, STAGE_BYTES, B_BYTES, n_stages, J0, warp - 4, lane, partial_d,
                           tile, LANES, h1 * FW_HALF, h2 * FW_HALF, prefetch);
  }
  cp_async_wait<0>();
}

// fwd_wg_loop and joint_fwd_partial's body again, each finished sum handed
// to store(d, k1, k2, v(k1, k2), v(k1, k2 + 1)): the grouped forward's
// (mi_joint.cu: joint_fwd_pieces writes J[piece] itself). A copy, not the
// same code: built on this body, joint_fwd_partial ran 13-45% slower at
// Up_conv3 on the card, by how its partial stores compiled, so it keeps
// its own.
template <int J, typename Prefetch, typename Store>
__device__ __forceinline__ void fwd_wg_loop_to(uint32_t smem_s, uint32_t stage_bytes,
                                            uint32_t b_bytes, int n_stages, int j0, int wq,
                                            int lane, int d0, int k1_0, int k2_0,
                                            const Prefetch& prefetch, const Store& store) {
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
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int k2 = k2_0 + c8 * 8 + 2 * t4;
        store(d0 + j0 + j, k1, k2, acc[j][4 * c8], acc[j][4 * c8 + 1]);
        store(d0 + j0 + j, k1 + 8, k2, acc[j][4 * c8 + 2], acc[j][4 * c8 + 3]);
      }
    }
  }
}

// One block of the forward over rows [n_begin, n_end) of A, B [N, 128]
// bf16: the quarter, displacement group and dy of block index bx, each
// finished sum handed to the store (joint_fwd_partial's body with
// fwd_wg_loop_to; the grouped forward calls it on a piece's rows).
template <int TG, typename Store>
__device__ __forceinline__ void fwd_block(const __nv_bfloat16* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ B, long long N,
                                          int p, int wp, long long n_begin, long long n_end,
                                          int bx, const Store& store, unsigned char* smem) {
  constexpr int A_ROWS = FW_KT + TG - 1;
  constexpr uint32_t B_BYTES = FW_KT * FW_ROW_BYTES;
  constexpr uint32_t STAGE_BYTES = fwd_stage_bytes(TG);
  constexpr int J0 = (TG + 1) / 2, J1 = TG - J0;
  const uint32_t smem_s = smem_addr(smem);
  if (smem_s & 1023) __trap();

  const int T = 2 * p + 1;
  const int groups = T / TG;
  const int q = bx & 3;
  const int grp = (bx >> 2) % groups;
  const int dy = (bx >> 2) / groups;
  const int h1 = q >> 1, h2 = q & 1;
  const int dx0 = grp * TG;
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

  const int d0 = dy * T + dx0;
  if (warp < 4) {
    fwd_wg_loop_to<J0>(smem_s, STAGE_BYTES, B_BYTES, n_stages, 0, warp, lane, d0,
                       h1 * FW_HALF,
                    h2 * FW_HALF, prefetch, store);
  } else {
    fwd_wg_loop_to<J1>(smem_s, STAGE_BYTES, B_BYTES, n_stages, J0, warp - 4, lane, d0,
                       h1 * FW_HALF,
                    h2 * FW_HALF, prefetch, store);
  }
  cp_async_wait<0>();
}

// out[d, k1, k2] = sum over chunks, in chunk order, of partial[chunk, d, k1, k2];
// partial tiles are ld x ld (ld = C in the fp32 mode, 128 in the bf16 mode, W
// on the wide kernels). PAD: entries with k1 or k2 >= ld are written as 0
// (the fused wide path's lanes past the live quarters, C > W)
template <bool PAD>
__global__ void joint_fwd_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                 int D, int C, int ld, int n_chunks) {
  const long long cc = (long long)C * C;
  const long long per = (long long)D * cc;
  const long long stride = (long long)D * ld * ld;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < per;
       e += (long long)gridDim.x * blockDim.x) {
    const long long d = e / cc;
    const int r = (int)(e % cc);
    float s = 0.f;
    if (!PAD || (r / C < ld && r % C < ld)) {
      const float* src = partial + (d * ld + r / C) * ld + r % C;
      for (int k = 0; k < n_chunks; ++k) s += src[k * stride];
    }
    out[e] = s;
  }
}

// ---------------------------------------------------------------------------
// The wide kernels: rows of W = 64 q lanes (q = ceil(C / 64) quarters, at
// least 2; lanes from C on zero), for C > 128, one launch a product.
//   joint_fwd_wide: joint_fwd_partial's block on quarter tiles (k1 quarter i,
//     k2 quarter j) of a W x W joint, grid (q^2 * groups * T, n_chunks),
//     blockIdx.x = tile + q^2 (group + groups dy), tile = i q + j; its
//     chunk partials [n_chunks, D, W, W] go to joint_fwd_reduce<true>, which
//     writes J [D, C, C] (zeros past W).
//   joint_bwd_wide: out[n, 128 ob + j] = sum_d sum_k S[n + o_d, k] H[ob, d,
//     j, k], S [N, W], H [nob, D, 128, W] (nob = ceil(C / 128) output blocks
//     of 128 lanes), grid (ceil(N / BW_TILE), nob); a last block that holds
//     one quarter (W - 128 ob = 64: C = 150 takes lanes 128-191) computes
//     those 64 lanes alone, with m64n64 accumulators. A block's K loop runs
//     over the displacements and the source's q quarters: step s = (dy, kc,
//     dx), dy = s / (qT), kc = (s / T) % q, dx = s % T; the source's slab
//     (dy, kc), BW_TILE + 2p rows of quarter kc, is staged once and read by
//     the T steps of its dx, in a ring of n_slabs buffers (a buffer is
//     refilled STAGES - 2 steps ahead of its slab's first step: only after
//     the last step of the slab n_slabs before it, so T (n_slabs - 1) >=
//     STAGES - 2); H streams through STAGES stages of [128 j][64 k] as in
//     joint_bwd. All of a block's q K stages sum in its fp32 accumulators,
//     written once by the Epilogue (StoreWide: in the operands' type, each
//     sum rounded once).
// ---------------------------------------------------------------------------

// W of a wide row for C live lanes, and the backward's 128-lane output blocks
__host__ __device__ constexpr int wide_lanes(int c) {
  return WIDE_Q * ((c + WIDE_Q - 1) / WIDE_Q < 2 ? 2 : (c + WIDE_Q - 1) / WIDE_Q);
}
__host__ __device__ constexpr int wide_out_blocks(int c) { return (c + LANES - 1) / LANES; }
__host__ __device__ constexpr int wide_bwd_smem_bytes(int p, int stages, int slabs) {
  return stages * BW_H_BYTES + slabs * (BW_TILE + 2 * p) * WIDE_ROW_BYTES;
}

// u / d for a grid-stride unit index: in 32 bits where u allows it (64-bit
// division is emulated)
__device__ __forceinline__ long long div_unit(long long u, unsigned d) {
  return u <= 0xffffffffLL ? (long long)((unsigned)u / d) : u / d;
}

// RowConv of the wide joint: dst_i[r, 0:W] = bf16_rn(src_i[r, 0:C]), zero
// beyond C (i = 0, 1; src1 may be null), one 16-byte destination chunk a
// thread and step; vec as CastRows'
template <typename Src>
struct CastWide {
  const Src* src0;
  __nv_bfloat16* dst0;
  const Src* src1;
  __nv_bfloat16* dst1;
  long long n;
  int C;
  int W;
  int vec;

  __device__ __forceinline__ void operator()(long long first, long long stride) const {
    const unsigned per_row = W / 8;
    const long long units0 = n * per_row;
    const long long total = src1 ? 2 * units0 : units0;
    for (long long i = first; i < total; i += stride) {
      const bool second = i >= units0;
      const long long u = second ? i - units0 : i;
      const long long r = div_unit(u, per_row);
      const int c0 = (int)(u - r * per_row) * 8;
      const Src* s = (second ? src1 : src0) + r * C + c0;
      float v[8];
      if (vec && c0 + 8 <= C) {
        load8(s, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = c0 + e < C ? to_float(s[e]) : 0.f;
      }
      *reinterpret_cast<uint4*>((second ? dst1 : dst0) + r * W + c0) =
          make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                     pack_bf16x2(v[6], v[7]));
    }
  }
};

// H[ob, d, j, k] = bf16_rn(transpose_g ? g[D-1-d, J, k] : g[d, k, J]), J =
// 128 ob + j, zero where J or k >= C; g [D, C, C], H [nob, D, 128, W]
__device__ __forceinline__ void convert_g_wide(long long first, long long stride,
                                               const float* __restrict__ g,
                                               __nv_bfloat16* __restrict__ h, int C, int D, int W,
                                               int nob, int transpose_g) {
  const unsigned per_j = W / 8;
  const long long units = (long long)nob * D * LANES * per_j;
  for (long long u = first; u < units; u += stride) {
    const long long v = div_unit(u, per_j);
    const int k0 = (int)(u - v * per_j) * 8;
    const int j = (int)(v % LANES);
    const long long dd = v / LANES;
    const int d = (int)(dd % D), ob = (int)(dd / D);
    const int jj = ob * LANES + j;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int k = k0 + e;
      x[e] = (jj < C && k < C) ? (transpose_g ? g[((long long)(D - 1 - d) * C + jj) * C + k]
                                              : g[((long long)d * C + k) * C + jj])
                               : 0.f;
    }
    *reinterpret_cast<uint4*>(h + v * W + k0) =
        make_uint4(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]), pack_bf16x2(x[4], x[5]),
                   pack_bf16x2(x[6], x[7]));
  }
}

// the wide joint's conversion pass: rows by the RowConv, then g into H
// (g may be null)
template <typename RowConv>
__global__ void __launch_bounds__(PREP_THREADS)
joint_prep_wide(RowConv rows, const float* __restrict__ g, __nv_bfloat16* __restrict__ h, int C,
                int D, int W, int nob, int transpose_g) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  rows(first, stride);
  if (g == nullptr) return;
  convert_g_wide(first, stride, g, h, C, D, W, nob, transpose_g);
}

// units of H that joint_prep_wide converts (16-byte chunks)
__host__ __device__ constexpr long long h_units_wide(int D, int W, int nob) {
  return (long long)nob * D * LANES * (W / 8);
}

// Epilogue of the wide backward: output block col0 / 128's fp32 accumulators
// to lanes [col0, col0 + 128) of out [N, ld] below lim, as Out
template <typename Out>
struct StoreWide {
  Out* out;
  int ld;
  int lim;

  template <int NA>  // accumulator floats a row half: 64 (128 lanes) or 32 (64 lanes)
  __device__ __forceinline__ void operator()(float (&acc)[2][NA], long long n0, long long N,
                                             int tid, int col0) const {
    const int lane = tid & 31, warp = tid >> 5;
    const int wg = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const bool pairs = ((ld | col0) & 1) == 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long row = n0 + wg * 128 + h * 64 + wq * 16 + g + half * 8;
        if (row >= N) continue;
#pragma unroll
        for (int c8 = 0; c8 < NA / 4; ++c8) {
          const int col = col0 + c8 * 8 + 2 * t4;
          const float v0 = acc[h][4 * c8 + 2 * half], v1 = acc[h][4 * c8 + 2 * half + 1];
          Out* o = out + row * ld + col;
          if (col + 1 < lim) {
            if (pairs) {
              store2(o, v0, v1);
            } else {
              store1(o, v0);
              store1(o + 1, v1);
            }
          } else if (col < lim) {
            store1(o, v0);
          }
        }
      }
  }
};

template <int TG>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_fwd_wide(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
               float* __restrict__ partial, long long N, int p, int wp, int W,
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
  const int q = W / WIDE_Q;
  const int tile = blockIdx.x % (q * q);
  const int rest = blockIdx.x / (q * q);
  const int h1 = tile / q, h2 = tile - (tile / q) * q;
  const int grp = rest % groups;
  const int dy = rest / groups;
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
                   A + (valid ? row : 0) * W + h1 * FW_HALF + c * 8, valid);
      }
      for (int idx = tid; idx < FW_KT * (FW_ROW_BYTES / 16); idx += MMA_THREADS) {
        const int r = idx >> 3, c = idx & 7;
        const bool valid = r < live;
        cp_async16(b_base + swz(r, c, FW_ROW_BYTES),
                   B + (valid ? r0 + r : 0) * W + h2 * FW_HALF + c * 8, valid);
      }
    }
    cp_async_commit();
  };
#pragma unroll 1
  for (int st = 0; st < FW_STAGES - 2; ++st) prefetch(st);

  const long long tile_stride = (long long)W * W;
  float* partial_d = partial + (chunk * D + dy * T + dx0) * tile_stride;
  if (warp < 4) {
    fwd_wg_loop<J0, 0>(smem_s, STAGE_BYTES, B_BYTES, n_stages, 0, warp, lane, partial_d,
                       tile_stride, W, h1 * FW_HALF, h2 * FW_HALF, prefetch);
  } else {
    fwd_wg_loop<J1, 0>(smem_s, STAGE_BYTES, B_BYTES, n_stages, J0, warp - 4, lane, partial_d,
                       tile_stride, W, h1 * FW_HALF, h2 * FW_HALF, prefetch);
  }
  cp_async_wait<0>();
}

// one block of joint_bwd_wide: BW_TILE rows from n0, NJ output lanes (128,
// or 64 in a last block of one quarter) from 128 ob
template <int STAGES, int NJ, typename Epilogue>
__device__ __forceinline__ void bwd_wide_block(const __nv_bfloat16* __restrict__ S,
                                               const __nv_bfloat16* __restrict__ H, long long N,
                                               int p, int wp, int W, int n_slabs, long long n0,
                                               int ob, const Epilogue& epi, unsigned char* smem) {
  const int T = 2 * p + 1;
  const int D = T * T;
  const int q = W / WIDE_Q;
  const int slab_rows = BW_TILE + 2 * p;
  const uint32_t slab_bytes = (uint32_t)slab_rows * WIDE_ROW_BYTES;
  const uint32_t h_s = smem_addr(smem);
  const uint32_t slab_s = h_s + STAGES * BW_H_BYTES;
  if (h_s & 1023) __trap();  // the swizzled wgmma operand needs a 1024-byte aligned base

  const long long n_hi = min(n0 + BW_TILE, N);
  const __nv_bfloat16* Hb = H + (long long)ob * D * LANES * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int steps = T * q * T;

  auto load_slab = [&](int u) {  // slab u = dy q + kc
    const int dy = u / q, kc = u - (u / q) * q;
    const long long lo = n0 + (long long)(dy - p) * wp - p;
    const long long hi = n_hi + (long long)(dy - p) * wp + p;
    const uint32_t base = slab_s + (uint32_t)(u % n_slabs) * slab_bytes;
    const __nv_bfloat16* src = S + kc * WIDE_Q;
    for (int idx = tid; idx < slab_rows * (WIDE_ROW_BYTES / 16); idx += MMA_THREADS) {
      const int r = idx >> 3, c = idx & 7;
      const long long row = lo + r;
      const bool valid = row >= 0 && row < N && row < hi;
      cp_async16(base + swz(r, c, WIDE_ROW_BYTES), src + (valid ? row : 0) * W + c * 8, valid);
    }
  };
  auto prefetch = [&](int s) {
    if (s < steps) {
      const int u = s / T, dx = s - (s / T) * T;
      if (dx == 0) load_slab(u);
      const int dy = u / q, kc = u - (u / q) * q;
      const __nv_bfloat16* src = Hb + (long long)(dy * T + dx) * LANES * W + kc * BW_KC;
      const uint32_t base = h_s + (s % STAGES) * BW_H_BYTES;
      for (int idx = tid; idx < NJ * (BW_KC / 8); idx += MMA_THREADS) {
        const int j = idx >> 3, c = idx & 7;
        cp_async16(base + swz(j, c, BW_KC * 2), src + (long long)j * W + c * 8, true);
      }
    }
    cp_async_commit();
  };

  float acc[2][NJ / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < NJ / 2; ++e) acc[h][e] = 0.f;

  // A fragments as joint_bwd's, from the slab of one quarter (8 chunks a row)
  const int a_row = wg * 128 + wq * 16 + (lane & 15);
  const int a_chunk = lane >> 4;

  auto step = [&](int s, uint32_t (&a)[BW_KC / 16][2][4]) {
    cp_async_wait<STAGES - 3>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    prefetch(s + STAGES - 2);
    const int u = s / T, dx = s - (s / T) * T;
    const uint32_t a_base = slab_s + (uint32_t)(u % n_slabs) * slab_bytes;
    const uint32_t b_base = h_s + (s % STAGES) * BW_H_BYTES;
#pragma unroll
    for (int kk = 0; kk < BW_KC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = dx + a_row + h * 64;
        ldsm4(a_base + swz(r, kk * 2 + a_chunk, WIDE_ROW_BYTES), a[kk][h]);
      }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BW_KC / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (NJ == LANES)
          wgmma_m64n128k16(acc[h], a[kk][h], desc_sw128(b_base + kk * 32));
        else
          wgmma_m64n64k16(acc[h], a[kk][h], desc_sw128(b_base + kk * 32));
      }
    wgmma_commit();
    wgmma_wait<1>();
  };

  uint32_t a0[BW_KC / 16][2][4], a1[BW_KC / 16][2][4];
#pragma unroll 1
  for (int s = 0; s < STAGES - 2; ++s) prefetch(s);
  int s = 0;
#pragma unroll 1
  for (; s + 1 < steps; s += 2) {
    step(s, a0);
    step(s + 1, a1);
  }
  if (s < steps) step(s, a0);  // an odd count (T and q odd): the last step's wgmma
                               // reads a0 after the one before it read a1
  wgmma_wait<0>();
  cp_async_wait<0>();
  epi(acc, n0, N, tid, ob * LANES);
}

template <int STAGES, typename Epilogue>
__global__ void __launch_bounds__(MMA_THREADS, 1)
joint_bwd_wide(const __nv_bfloat16* __restrict__ S, const __nv_bfloat16* __restrict__ H,
               long long N, int p, int wp, int W, int n_slabs, Epilogue epi) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const long long n0 = (long long)blockIdx.x * BW_TILE;
  const int ob = blockIdx.y;
  if (W - ob * LANES <= WIDE_Q)  // uniform across the block
    bwd_wide_block<STAGES, WIDE_Q>(S, H, N, p, wp, W, n_slabs, n0, ob, epi, smem);
  else
    bwd_wide_block<STAGES, LANES>(S, H, N, p, wp, W, n_slabs, n0, ob, epi, smem);
}

// ---------------------------------------------------------------------------
// host side: launch plans and launchers
// ---------------------------------------------------------------------------

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned prep_blocks(long long units) {
  const long long b = (units + PREP_THREADS - 1) / PREP_THREADS;
  return (unsigned)(b < (1 << 20) ? b : (1 << 20));
}

unsigned reduce_blocks(long long elems) {
  return (unsigned)((elems + 255) / 256);
}

// The launch plan's numbers (ops/mi_joint.py:launch_plan) against the
// kernels': a forward plan's displacement group and shared memory; a backward
// plan's ring depth and shared memory. A slab buffer of joint_bwd is refilled
// STAGES - 2 steps ahead of its dy's first step: only after the last step of
// the dy two before it.
bool fwd_plan_ok(int c, int p, int dx_group, int smem_bytes) {
  const int T = 2 * p + 1;
  return c >= 1 && c <= LANES && p >= 0 &&
         (dx_group == 1 || dx_group == 3 || dx_group == 5 || dx_group == 7) &&
         T % dx_group == 0 && smem_bytes == fwd_smem_bytes(dx_group);
}

bool bwd_plan_ok(int c, int p, int stages, int smem_bytes) {
  const int T = 2 * p + 1;
  return c >= 1 && c <= LANES && p >= 0 && (stages == 4 || stages == 6) &&
         T * BW_NKC >= stages - 2 && smem_bytes == bwd_smem_bytes(p, stages);
}

// Raise a kernel's dynamic shared-memory limit to the card's maximum, once.
template <typename K>
cudaError_t allow_smem(K kernel, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  done = err == cudaSuccess;
  return err;
}

template <int STAGES, typename Epilogue>
cudaError_t launch_bwd(long long n, int p, int wp, int smem_bytes, cudaStream_t s,
                       const __nv_bfloat16* S, const __nv_bfloat16* H, const Epilogue& epi) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_bwd<STAGES, Epilogue>, smem_set);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((n + BW_TILE - 1) / BW_TILE);
  joint_bwd<STAGES, Epilogue><<<blocks, MMA_THREADS, smem_bytes, s>>>(S, H, n, p, wp, epi);
  return cudaGetLastError();
}

// joint_bwd at a checked plan's ring depth
template <typename Epilogue>
cudaError_t run_bwd(int stages, long long n, int p, int wp, int smem_bytes, cudaStream_t s,
                    const __nv_bfloat16* S, const __nv_bfloat16* H, const Epilogue& epi) {
  return stages == 6 ? launch_bwd<6>(n, p, wp, smem_bytes, s, S, H, epi)
                     : launch_bwd<4>(n, p, wp, smem_bytes, s, S, H, epi);
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

// joint_fwd_partial at a checked plan's displacement group: the chunk
// partials [n_chunks, D, 128, 128] of A and B ([N, 128] bf16 each)
cudaError_t run_fwd_partial(int dx_group, int n_chunks, int smem_bytes, cudaStream_t s,
                            const __nv_bfloat16* A, const __nv_bfloat16* B, float* partial,
                            long long n, int p, int wp, long long rows_per_chunk) {
  const int T = 2 * p + 1;
  const dim3 grid(4 * (T / dx_group) * T, n_chunks);
  switch (dx_group) {
    case 1: return launch_fwd<1>(grid, smem_bytes, s, A, B, partial, n, p, wp, rows_per_chunk);
    case 3: return launch_fwd<3>(grid, smem_bytes, s, A, B, partial, n, p, wp, rows_per_chunk);
    case 5: return launch_fwd<5>(grid, smem_bytes, s, A, B, partial, n, p, wp, rows_per_chunk);
    default: return launch_fwd<7>(grid, smem_bytes, s, A, B, partial, n, p, wp, rows_per_chunk);
  }
}

// the partials, then their chunk sum into out [D, C, C]
cudaError_t run_fwd(int dx_group, int n_chunks, int smem_bytes, cudaStream_t s,
                    const __nv_bfloat16* A, const __nv_bfloat16* B, float* partial, float* out,
                    long long n, int c, int p, int wp, long long rows_per_chunk) {
  const int T = 2 * p + 1;
  const int D = T * T;
  const cudaError_t err =
      run_fwd_partial(dx_group, n_chunks, smem_bytes, s, A, B, partial, n, p, wp, rows_per_chunk);
  if (err != cudaSuccess) return err;
  joint_fwd_reduce<false><<<reduce_blocks((long long)D * c * c), 256, 0, s>>>(partial, out, D, c,
                                                                              LANES, n_chunks);
  return cudaGetLastError();
}

// the wide kernels' plans (ops/mi_joint.py:wide_plan): W for C live lanes, a
// forward's displacement group and shared memory (those of the 128-lane
// forward), a backward's ring depth, slab buffers and shared memory
bool wide_fwd_plan_ok(int c, int w, int p, int dx_group, int smem_bytes) {
  const int T = 2 * p + 1;
  return c >= 1 && w == wide_lanes(c) && p >= 0 &&
         (dx_group == 1 || dx_group == 3 || dx_group == 5 || dx_group == 7) &&
         T % dx_group == 0 && smem_bytes == fwd_smem_bytes(dx_group);
}

bool wide_bwd_plan_ok(int p, int stages, int slabs, int smem_bytes) {
  const int T = 2 * p + 1;
  return p >= 0 && (stages == 4 || stages == 6) && slabs >= 2 && T * (slabs - 1) >= stages - 2 &&
         smem_bytes == wide_bwd_smem_bytes(p, stages, slabs) && smem_bytes <= SMEM_MAX;
}

template <int TG>
cudaError_t launch_fwd_wide(dim3 grid, int smem_bytes, cudaStream_t s, const __nv_bfloat16* A,
                            const __nv_bfloat16* B, float* partial, long long n, int p, int wp,
                            int w, long long rows_per_chunk) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_fwd_wide<TG>, smem_set);
  if (err != cudaSuccess) return err;
  joint_fwd_wide<TG><<<grid, MMA_THREADS, smem_bytes, s>>>(A, B, partial, n, p, wp, w,
                                                           rows_per_chunk);
  return cudaGetLastError();
}

// joint_fwd_wide at a checked plan over rows of w lanes, then the chunk sum
// into out [D, c_out, c_out] (zeros past w)
cudaError_t run_fwd_wide(int dx_group, int n_chunks, int smem_bytes, cudaStream_t s,
                         const __nv_bfloat16* A, const __nv_bfloat16* B, float* partial,
                         float* out, long long n, int c_out, int p, int wp, int w,
                         long long rows_per_chunk) {
  const int T = 2 * p + 1;
  const int D = T * T;
  const int q = w / WIDE_Q;
  const dim3 grid(q * q * (T / dx_group) * T, n_chunks);
  const auto launch = [&](auto tg) {
    return launch_fwd_wide<decltype(tg)::value>(grid, smem_bytes, s, A, B, partial, n, p, wp, w,
                                                rows_per_chunk);
  };
  const cudaError_t err = dx_group == 1   ? launch(std::integral_constant<int, 1>{})
                          : dx_group == 3 ? launch(std::integral_constant<int, 3>{})
                          : dx_group == 5 ? launch(std::integral_constant<int, 5>{})
                                          : launch(std::integral_constant<int, 7>{});
  if (err != cudaSuccess) return err;
  joint_fwd_reduce<true><<<reduce_blocks((long long)D * c_out * c_out), 256, 0, s>>>(
      partial, out, D, c_out, w, n_chunks);
  return cudaGetLastError();
}

template <int STAGES, typename Epilogue>
cudaError_t launch_bwd_wide(long long n, int p, int wp, int w, int nob, int slabs, int smem_bytes,
                            cudaStream_t s, const __nv_bfloat16* S, const __nv_bfloat16* H,
                            const Epilogue& epi) {
  static bool smem_set = false;
  const cudaError_t err = allow_smem(joint_bwd_wide<STAGES, Epilogue>, smem_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((n + BW_TILE - 1) / BW_TILE), nob);
  joint_bwd_wide<STAGES, Epilogue><<<grid, MMA_THREADS, smem_bytes, s>>>(S, H, n, p, wp, w, slabs,
                                                                         epi);
  return cudaGetLastError();
}

// joint_bwd_wide at a checked plan's ring depth
template <typename Epilogue>
cudaError_t run_bwd_wide(int stages, long long n, int p, int wp, int w, int nob, int slabs,
                         int smem_bytes, cudaStream_t s, const __nv_bfloat16* S,
                         const __nv_bfloat16* H, const Epilogue& epi) {
  return stages == 6 ? launch_bwd_wide<6>(n, p, wp, w, nob, slabs, smem_bytes, s, S, H, epi)
                     : launch_bwd_wide<4>(n, p, wp, w, nob, slabs, smem_bytes, s, S, H, epi);
}

}  // namespace

