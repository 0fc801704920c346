// Per-sample nearest rotation by three integer shears, and the per-row roll it
// is built from, for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas/rotate.py:
//   * rotate_shear_pallas / _rotate_kernel          -> rotate_shear_kernel
//   * _lane_roll_rows / _lane_shear_kernel          -> lane_roll_rows_vec_kernel
//     (three launches, with two transposes between     (lane_roll_rows_kernel
//     them, make rotate_shear_pallas_lanes)             for unaligned rows)
//
// What is computed. The image b, [H, W], sits at (py, px) on a zero canvas
// [Hc, Wc] centred at (cy, cx) = (py + (H-1)/2, px + (W-1)/2). The TPU kernel
// rolls the canvas three times: row Y by s_x[b, Y] along x, column X by
// s_y[b, X] along y, row Y by s_x[b, Y] again, where a roll by s moves
// element i to (i + s) mod n (jnp.roll), and
//   theta = -deg2rad(angle[b]),  a = -tan(theta / 2),  b = sin(theta)
//   s_x[Y] = rint(a * (Y - cy)) mod Wc,   s_y[X] = rint(b * (X - cx)) mod Hc
// all in fp32, rint half to even, mod a floor modulo. (It builds each roll
// from log2(n) static rolls because a TPU vector roll takes a static shift;
// their sum is one roll by s mod n.) So the output pixel (y, x), at canvas
// (Y, X) = (y + py, x + px), is the input pixel found by inverting the rolls:
//   X3 = (X  - s_x[Y])  mod Wc
//   Y2 = (Y  - s_y[X3]) mod Hc
//   X1 = (X3 - s_x[Y2]) mod Wc
//   out[b, y, x] = in[b, Y2 - py, X1 - px], or 0 outside the image.
// A permutation moves 32-bit words, so one launch moves the fp32 image and,
// given, the int32 labels of the same sample by the same index; zero fill is
// the 0 bit pattern of both.
//
// The shifts are derived here, from angle[b], and reproduce the wrapper's
// torch ops (ops/rotate.py:shear_tables) bit for bit: theta = -(angle *
// (float)(pi/180)); tanf(theta * 0.5f) and sinf(theta) from CUDA's math
// library (no fast math in ops/build.py); __fmul_rn for a * (Y - cy), so that
// nothing is contracted (Y - cy is exact); __float2int_rn, half to even as
// torch.round. The C entry point can instead launch the same kernel to write
// only the shifts it derives (s_x_out, s_y_out: one block a sample, no pixel),
// so that chip_smoke.py holds them against shear_tables over a sweep of
// angles. That sweep passed on the card, so this design shipped: no table
// and no torch op on the CUDA route, one launch a call.
//
// What bounds it on an H100 (3.35 TB/s HBM). It moves bytes only: each plane
// read once and written once, 4 * 2 * P * B * H * W bytes for P planes (the
// zero canvas never exists): 4.19 MB for the labeled pair at B = 4 and 5.24
// MB for the unlabeled batch at B = 10 of 256^2 images, 1.25 and 1.57 us,
// near one launch's latency. The roll reads and writes the canvas and reads
// its shifts: 4 * (2 * B * R * Wc + B * R) bytes.
//
// What the design does about it. rotate_shear_kernel: a block computes its
// sample's slopes once (tanf, sinf); a thread then derives the three shifts
// of each of its 4 consecutive output pixels along x in registers (no
// dependent table loads: the pixel's source address is ready after a few
// dozen ALU instructions), gathers each plane through the read-only path
// (the source, a few MB, is L2-resident) and stores 16 bytes a plane where W
// % 4 == 0, scalars otherwise. A block takes a 32 x 16 pixel tile (512
// blocks at B = 4, about 4 a SM): a square tile's rotated source spans fewer
// cache lines than a 128 x 4 strip's, and measured faster at B = 10.
// lane_roll_rows_vec_kernel: one warp a row, 8 rows a block; the row is staged
// in shared memory by one 1-D bulk copy (cp.async.bulk, completing on an
// mbarrier), which measured faster than 16-byte loads by all lanes; after
// __syncwarp each lane writes whole
// float4s, each built from the two aligned float4s of shared memory that hold
// its rolled source (consecutive lanes read consecutive 16-byte words: no bank
// conflict). A row whose width is no multiple of 4, is wider than the staging
// buffer, or whose base is not 16-byte aligned takes the scalar kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kDegToRad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr int kPix = 4;                    // output pixels a thread, along x
constexpr int kRotX = 8, kRotY = 16;       // rotation block: kRotX * kPix x kRotY pixels
constexpr int kRollRows = 8;               // roll: rows (one warp each) a block
constexpr int kRollMaxVecWidth = 1024;     // kRollRows staged rows in 32 KB

__device__ __forceinline__ int floor_mod(int v, int n) {
  const int r = v % n;
  return r < 0 ? r + n : r;
}

// v mod n: one add or subtract for v in [-n, 2n), which is every call of the
// rotation at |angle| <= max_angle; the division otherwise.
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0) v += n;
  else if (v >= n) v -= n;
  return (unsigned)v < (unsigned)n ? v : floor_mod(v, n);
}

struct Shear {
  float a, b;    // x-shear and y-shear slopes
  float cy, cx;  // canvas centre
  // the raw shifts, rint(a (Y - cy)) and rint(b (X - cx)); torch.round's half to even
  __device__ __forceinline__ int sx(int y) const {
    return __float2int_rn(__fmul_rn(a, (float)y - cy));
  }
  __device__ __forceinline__ int sy(int x) const {
    return __float2int_rn(__fmul_rn(b, (float)x - cx));
  }
};

template <bool kLabels, bool kVec>
__global__ void __launch_bounds__(kRotX * kRotY)
rotate_shear_kernel(const float* __restrict__ img, const int* __restrict__ lab,
                    const float* __restrict__ angles, float* __restrict__ out_img,
                    int* __restrict__ out_lab, int* __restrict__ s_x_out,
                    int* __restrict__ s_y_out, int h, int w, int py, int px, int hc, int wc) {
  __shared__ float2 slope;
  const int b = blockIdx.z;
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    const float theta = -__fmul_rn(__ldg(angles + b), kDegToRad);
    slope = make_float2(-tanf(__fmul_rn(theta, 0.5f)), sinf(theta));
  }
  __syncthreads();
  const Shear sh{slope.x, slope.y, (float)py + 0.5f * (float)(h - 1),
                 (float)px + 0.5f * (float)(w - 1)};
  if (s_x_out != nullptr) {  // a shifts launch: one block a sample, no pixel
    const int t = threadIdx.y * kRotX + threadIdx.x;
    for (int i = t; i < hc; i += kRotX * kRotY)
      s_x_out[(long long)b * hc + i] = floor_mod(sh.sx(i), wc);
    for (int j = t; j < wc; j += kRotX * kRotY)
      s_y_out[(long long)b * wc + j] = floor_mod(sh.sy(j), hc);
    return;
  }
  const int y = blockIdx.y * kRotY + threadIdx.y;
  const int x0 = (blockIdx.x * kRotX + threadIdx.x) * kPix;
  if (y >= h || x0 >= w) return;
  const int Y = y + py;
  const int rY = sh.sx(Y);  // the first and the last x shear of this canvas row
  const long long plane = (long long)b * h * w;
  float vi[kPix];
  int vl[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    int src = -1;
    if (kVec || x0 + k < w) {
      const int x3 = wrap(x0 + k + px - rY, wc);
      const int y2 = wrap(Y - sh.sy(x3), hc);
      const int x1 = wrap(x3 - sh.sx(y2), wc);
      const int iy = y2 - py, ix = x1 - px;
      if ((unsigned)iy < (unsigned)h && (unsigned)ix < (unsigned)w) src = iy * w + ix;
    }
    vi[k] = src >= 0 ? __ldg(img + plane + src) : 0.f;
    if (kLabels) vl[k] = src >= 0 ? __ldg(lab + plane + src) : 0;
  }
  const long long o = plane + (long long)y * w + x0;
  if (kVec) {
    *reinterpret_cast<float4*>(out_img + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
    if (kLabels) *reinterpret_cast<int4*>(out_lab + o) = make_int4(vl[0], vl[1], vl[2], vl[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kPix; ++k) {
      if (x0 + k < w) {
        out_img[o + k] = vi[k];
        if (kLabels) out_lab[o + k] = vl[k];
      }
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One warp a row: stage the row in shared memory, then write float4s of the
// rolled row. Needs wc % 4 == 0, 16-byte aligned in and out, and
// kRollRows * (wc * 4 + 8) bytes of shared memory (the rows, a barrier each).
__global__ void __launch_bounds__(kRollRows * 32)
lane_roll_rows_vec_kernel(const float* __restrict__ in, const int* __restrict__ shifts,
                          float* __restrict__ out, long long nrows, int wc) {
  extern __shared__ __align__(16) unsigned char roll_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRollRows + warp;
  if (row >= nrows) return;  // the whole warp: no block-wide barrier follows
  const int nq = wc >> 2;
  float4* buf = reinterpret_cast<float4*>(roll_smem) + (long long)warp * nq;
  const float4* src = reinterpret_cast<const float4*>(in + row * wc);
  const int s = floor_mod(__ldg(shifts + row), wc);
  // the row, by one bulk copy that completes on this warp's barrier
  uint64_t* bar = reinterpret_cast<uint64_t*>(roll_smem + (long long)kRollRows * wc * 4) + warp;
  const uint32_t bar_a = smem_addr(bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                 "r"(wc * 4) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(buf)), "l"(src), "r"(wc * 4), "r"(bar_a) : "memory");
  }
  __syncwarp();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar_a) : "memory");
  }
  // out[4q + k] = row[(4q + k - s) mod wc] = row[t + k], t = (4q - s) mod wc =
  // 4 qa + r with r = (-s) mod 4 the same for every q: elements r.. of float4
  // qa, then the first r of the next one (qb, wrapping to 0).
  const int t0 = wc - s;  // (0 - s) mod wc, in (0, wc]
  const int r = t0 & 3;
  float4* dst = reinterpret_cast<float4*>(out + row * wc);
  for (int q = lane; q < nq; q += 32) {
    int t = 4 * q + t0;
    if (t >= wc) t -= wc;
    const int qa = t >> 2;
    const int qb = qa + 1 == nq ? 0 : qa + 1;
    const float4 u = buf[qa];
    float4 o = u;
    if (r != 0) {
      const float4 v = buf[qb];
      if (r == 1) o = make_float4(u.y, u.z, u.w, v.x);
      else if (r == 2) o = make_float4(u.z, u.w, v.x, v.y);
      else o = make_float4(u.w, v.x, v.y, v.z);
    }
    dst[q] = o;
  }
}

// Any width and alignment: one warp a row, scalar loads and stores.
__global__ void __launch_bounds__(kRollRows * 32)
lane_roll_rows_kernel(const float* __restrict__ in, const int* __restrict__ shifts,
                      float* __restrict__ out, long long nrows, int wc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRollRows + warp;
  if (row >= nrows) return;
  const int s = floor_mod(__ldg(shifts + row), wc);
  const float* src = in + row * wc;
  float* dst = out + row * wc;
  for (int c = lane; c < wc; c += 32) {
    int k = c - s;
    if (k < 0) k += wc;
    dst[c] = __ldg(src + k);
  }
}

bool host_aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

const char* rotate_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// out_img [B, H, W] (and out_lab, when lab is given) = the 3-shear rotation of
// img (and lab) by angles [B] (degrees) on the canvas (py, px, hc, wc). With
// s_x_out [B, hc] and s_y_out [B, wc] given, the launch writes only the shifts
// it derives, reduced mod the canvas, and moves no pixel (img, lab, out_img
// and out_lab are not read and may be null).
int rotate_shear_f32(const float* img, const int* lab, const float* angles, float* out_img,
                     int* out_lab, int* s_x_out, int* s_y_out, int batch, int h, int w, int py,
                     int px, int hc, int wc, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  const bool shifts = s_x_out != nullptr;
  if ((lab == nullptr) != (out_lab == nullptr) || shifts != (s_y_out != nullptr) ||
      batch > 65535 || (h + kRotY - 1) / kRotY > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = w % kPix == 0 && host_aligned16(out_img) &&
                   (out_lab == nullptr || host_aligned16(out_lab));
  const dim3 block(kRotX, kRotY);
  const dim3 grid(shifts ? 1u : (unsigned)((w + kRotX * kPix - 1) / (kRotX * kPix)),
                  shifts ? 1u : (unsigned)((h + kRotY - 1) / kRotY), (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto launch = [&](auto kernel) {
    kernel<<<grid, block, 0, s>>>(img, lab, angles, out_img, out_lab, s_x_out, s_y_out, h, w, py,
                                  px, hc, wc);
  };
  if (lab != nullptr) {
    if (vec) launch(rotate_shear_kernel<true, true>);
    else launch(rotate_shear_kernel<true, false>);
  } else {
    if (vec) launch(rotate_shear_kernel<false, true>);
    else launch(rotate_shear_kernel<false, false>);
  }
  return (int)cudaGetLastError();
}

// out[b, r, c] = in[b, r, (c - shifts[b, r]) mod wc]; in, out [B, rows, wc].
int lane_roll_rows_f32(const float* in, const int* shifts, float* out, int batch, int rows,
                       int wc, void* stream) {
  if (batch == 0 || rows == 0 || wc == 0) return 0;
  const long long nrows = (long long)batch * rows;
  const unsigned grid = (unsigned)((nrows + kRollRows - 1) / kRollRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = wc % 4 == 0 && wc <= kRollMaxVecWidth && host_aligned16(in) &&
                   host_aligned16(out);
  const size_t smem = kRollRows * (wc * sizeof(float) + sizeof(uint64_t));
  if (vec)
    lane_roll_rows_vec_kernel<<<grid, kRollRows * 32, smem, s>>>(in, shifts, out, nrows, wc);
  else
    lane_roll_rows_kernel<<<grid, kRollRows * 32, 0, s>>>(in, shifts, out, nrows, wc);
  return (int)cudaGetLastError();
}

}  // extern "C"
