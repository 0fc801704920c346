// Per-sample nearest rotation by three integer shears, and the per-row roll it
// is built from, for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes).
//
// Replaces the Pallas TPU kernels of the JAX package's ops/pallas/rotate.py:
//   * rotate_shear_pallas / _rotate_kernel          -> rotate_shear_kernel
//   * _lane_roll_rows / _lane_shear_kernel          -> lane_roll_rows_kernel
//     (three launches, with two transposes between them, make
//     rotate_shear_pallas_lanes)
//
// What is computed. The image b, [H, W] fp32, sits at (py, px) on a zero
// canvas [Hc, Wc]. The TPU kernel rolls the canvas three times: row Y by
// s_x[b, Y] along x, column X by s_y[b, X] along y, row Y by s_x[b, Y] again,
// where a roll by s moves element i to (i + s) mod n (jnp.roll). It builds
// each roll from log2(n) static rolls because a TPU vector roll takes a static
// shift; their sum is one roll by s mod n. So the output pixel (y, x), at
// canvas (Y, X) = (y + py, x + px), is the input pixel found by inverting the
// three rolls:
//   X3 = (X  - s_x[Y])  mod Wc
//   Y2 = (Y  - s_y[X3]) mod Hc
//   X1 = (X3 - s_x[Y2]) mod Wc
//   out[b, y, x] = in[b, Y2 - py, X1 - px], or 0 outside the image.
// The shift tables come from the wrapper (ops/rotate.py:shear_tables), already
// reduced mod the canvas; the kernel reduces again with a floor modulo, so any
// integer shift is taken as the roll it means. Nothing is rounded here.
//
// What bounds it on an H100 (3.35 TB/s HBM). It moves bytes only: the B*H*W
// fp32 input read once and the output written once (the zero canvas never
// exists), 2.1 MB at B = 4 and 5.2 MB at B = 10 for 256^2 images, i.e. 0.6 and
// 1.6 us, below one launch's latency. The roll reads and writes the canvas:
// 2 * B * Hc * Wc * 4 bytes.
//
// What the design does about it. One thread per output pixel, 32 of them
// along x in a warp, so the stores are coalesced; the loads are a gather
// through the read-only path, and the three table reads of a row hit L1. The
// roll runs one block per (b, row): neighbouring threads read neighbouring
// columns (shifted by one per-row offset) and write neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int floor_mod(int s, int n) { return ((s % n) + n) % n; }

__global__ void rotate_shear_kernel(const float* __restrict__ in, const int* __restrict__ s_x,
                                    const int* __restrict__ s_y, float* __restrict__ out, int h,
                                    int w, int py, int px, int hc, int wc) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= w || y >= h) return;
  const int* sx = s_x + (long long)b * hc;
  const int* sy = s_y + (long long)b * wc;
  const int Y = y + py;
  const int X = x + px;
  const int x3 = floor_mod(X - __ldg(sx + Y), wc);
  const int y2 = floor_mod(Y - __ldg(sy + x3), hc);
  const int x1 = floor_mod(x3 - __ldg(sx + y2), wc);
  const int iy = y2 - py;
  const int ix = x1 - px;
  float v = 0.f;
  if (iy >= 0 && iy < h && ix >= 0 && ix < w) v = __ldg(in + ((long long)b * h + iy) * w + ix);
  out[((long long)b * h + y) * w + x] = v;
}

__global__ void lane_roll_rows_kernel(const float* __restrict__ in, const int* __restrict__ shifts,
                                      float* __restrict__ out, int rows, int wc) {
  const long long row = (long long)blockIdx.y * rows + blockIdx.x;  // b * rows + r
  const int s = floor_mod(__ldg(shifts + row), wc);
  const float* src = in + row * wc;
  float* dst = out + row * wc;
  for (int c = threadIdx.x; c < wc; c += blockDim.x) {
    int k = c - s;
    if (k < 0) k += wc;
    dst[c] = __ldg(src + k);
  }
}

}  // namespace

extern "C" {

const char* rotate_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// out [B, H, W] = the 3-shear rotation of in [B, H, W]; s_x [B, Hc], s_y [B, Wc].
int rotate_shear_f32(const float* in, const int* s_x, const int* s_y, float* out, int batch,
                     int h, int w, int py, int px, int hc, int wc, void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  dim3 block(32, 8);
  dim3 grid((unsigned)((w + 31) / 32), (unsigned)((h + 7) / 8), (unsigned)batch);
  rotate_shear_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      in, s_x, s_y, out, h, w, py, px, hc, wc);
  return (int)cudaGetLastError();
}

// out[b, r, c] = in[b, r, (c - shifts[b, r]) mod wc]; in, out [B, rows, wc].
int lane_roll_rows_f32(const float* in, const int* shifts, float* out, int batch, int rows,
                       int wc, void* stream) {
  if (batch == 0 || rows == 0 || wc == 0) return 0;
  const int threads = wc >= 256 ? 256 : 128;
  dim3 grid((unsigned)rows, (unsigned)batch);
  lane_roll_rows_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, shifts, out, rows, wc);
  return (int)cudaGetLastError();
}

}  // extern "C"
