// Design alternatives to the two kernels of csrc/rotate.cu, for comparison on
// the card by scripts/torch_rotate_variants.py (not used by the port):
//   * roll_bulk<ROWS>:   the shipped row roll (a warp a row, the row staged by
//                        one cp.async.bulk copy) at 1, 2, 4 or 8 rows a block;
//   * roll_direct<ROWS>: the same without shared memory, each lane loading the
//                        two aligned float4s of its rolled source from global;
//   * rot_staged:        the rotation with each block's source bounding box
//                        (a block min / max of its computed source
//                        coordinates) loaded coalesced into shared memory,
//                        then gathered from there; a box above 48 x 48
//                        gathers from global instead.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>
namespace {
constexpr float kDegToRad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr int kPix = 4, kRotX = 8, kRotY = 16;
__device__ __forceinline__ int floor_mod(int v, int n) { const int r = v % n; return r < 0 ? r + n : r; }
__device__ __forceinline__ int wrap(int v, int n) {
  if (v < 0) v += n; else if (v >= n) v -= n;
  return (unsigned)v < (unsigned)n ? v : floor_mod(v, n);
}
struct Shear {
  float a, b, cy, cx;
  __device__ __forceinline__ int sx(int y) const { return __float2int_rn(__fmul_rn(a, (float)y - cy)); }
  __device__ __forceinline__ int sy(int x) const { return __float2int_rn(__fmul_rn(b, (float)x - cx)); }
};
__device__ __forceinline__ uint32_t smem_addr(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 32) roll_bulk(const float* __restrict__ in, const int* __restrict__ shifts,
                                                      float* __restrict__ out, long long nrows, int wc) {
  extern __shared__ __align__(16) unsigned char roll_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + warp;
  if (row >= nrows) return;
  const int nq = wc >> 2;
  float4* buf = reinterpret_cast<float4*>(roll_smem) + (long long)warp * nq;
  const float4* src = reinterpret_cast<const float4*>(in + row * wc);
  const int s = floor_mod(__ldg(shifts + row), wc);
  uint64_t* bar = reinterpret_cast<uint64_t*>(roll_smem + (long long)ROWS * wc * 4) + warp;
  const uint32_t bar_a = smem_addr(bar);
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a), "r"(wc * 4) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(smem_addr(buf)), "l"(src), "r"(wc * 4), "r"(bar_a) : "memory");
  }
  __syncwarp();
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar_a) : "memory");
  }
  const int t0 = wc - s, r = t0 & 3;
  float4* dst = reinterpret_cast<float4*>(out + row * wc);
  for (int q = lane; q < nq; q += 32) {
    int t = 4 * q + t0; if (t >= wc) t -= wc;
    const int qa = t >> 2, qb = qa + 1 == nq ? 0 : qa + 1;
    const float4 u = buf[qa]; float4 o = u;
    if (r != 0) { const float4 v = buf[qb];
      if (r == 1) o = make_float4(u.y, u.z, u.w, v.x); else if (r == 2) o = make_float4(u.z, u.w, v.x, v.y); else o = make_float4(u.w, v.x, v.y, v.z); }
    dst[q] = o;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(ROWS * 32) roll_direct(const float* __restrict__ in, const int* __restrict__ shifts,
                                                        float* __restrict__ out, long long nrows, int wc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + warp;
  if (row >= nrows) return;
  const int nq = wc >> 2;
  const float4* src = reinterpret_cast<const float4*>(in + row * wc);
  const int s = floor_mod(__ldg(shifts + row), wc);
  const int t0 = wc - s, r = t0 & 3;
  float4 u[8], v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = lane + 32 * k;
    if (q < nq) {
      int t = 4 * q + t0; if (t >= wc) t -= wc;
      const int qa = t >> 2, qb = qa + 1 == nq ? 0 : qa + 1;
      u[k] = __ldg(src + qa);
      if (r != 0) v[k] = __ldg(src + qb);
    }
  }
  float4* dst = reinterpret_cast<float4*>(out + row * wc);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int q = lane + 32 * k;
    if (q < nq) {
      float4 o = u[k];
      if (r == 1) o = make_float4(u[k].y, u[k].z, u[k].w, v[k].x);
      else if (r == 2) o = make_float4(u[k].z, u[k].w, v[k].x, v[k].y);
      else if (r == 3) o = make_float4(u[k].w, v[k].x, v[k].y, v[k].z);
      dst[q] = o;
    }
  }
}

// rotation with the block's source box staged in shared memory (fallback: direct gather)
template <bool kLabels>
__global__ void __launch_bounds__(kRotX * kRotY)
rot_staged(const float* __restrict__ img, const int* __restrict__ lab, const float* __restrict__ angles,
           float* __restrict__ out_img, int* __restrict__ out_lab, int h, int w, int py, int px, int hc, int wc) {
  constexpr int kCap = 48 * 48;
  __shared__ float2 slope;
  __shared__ int box[4];
  __shared__ float simg[kCap];
  __shared__ int slab[kLabels ? kCap : 1];
  const int b = blockIdx.z;
  const int t = threadIdx.y * kRotX + threadIdx.x;
  if (t == 0) {
    const float theta = -__fmul_rn(__ldg(angles + b), kDegToRad);
    slope = make_float2(-tanf(__fmul_rn(theta, 0.5f)), sinf(theta));
    box[0] = box[1] = INT_MAX; box[2] = box[3] = INT_MIN;
  }
  __syncthreads();
  const Shear sh{slope.x, slope.y, (float)py + 0.5f * (float)(h - 1), (float)px + 0.5f * (float)(w - 1)};
  const int y = blockIdx.y * kRotY + threadIdx.y;
  const int x0 = (blockIdx.x * kRotX + threadIdx.x) * kPix;
  const bool live = y < h && x0 < w;
  const int Y = y + py;
  const int rY = sh.sx(Y);
  int sy_[kPix], sx_[kPix];
  int ymin = INT_MAX, xmin = INT_MAX, ymax = INT_MIN, xmax = INT_MIN;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    sy_[k] = -1; sx_[k] = -1;
    if (live && x0 + k < w) {
      const int x3 = wrap(x0 + k + px - rY, wc);
      const int y2 = wrap(Y - sh.sy(x3), hc);
      const int x1 = wrap(x3 - sh.sx(y2), wc);
      const int iy = y2 - py, ix = x1 - px;
      if ((unsigned)iy < (unsigned)h && (unsigned)ix < (unsigned)w) {
        sy_[k] = iy; sx_[k] = ix;
        ymin = min(ymin, iy); ymax = max(ymax, iy); xmin = min(xmin, ix); xmax = max(xmax, ix);
      }
    }
  }
  ymin = __reduce_min_sync(0xffffffffu, ymin); xmin = __reduce_min_sync(0xffffffffu, xmin);
  ymax = __reduce_max_sync(0xffffffffu, ymax); xmax = __reduce_max_sync(0xffffffffu, xmax);
  if ((t & 31) == 0) { atomicMin(&box[0], ymin); atomicMin(&box[1], xmin); atomicMax(&box[2], ymax); atomicMax(&box[3], xmax); }
  __syncthreads();
  const int by = box[0], bx = box[1];
  const int bh = box[2] - by + 1, bw = box[3] - bx + 1;
  const bool staged = box[2] >= by && bh * bw <= kCap;
  const long long plane = (long long)b * h * w;
  if (staged) {
    for (int i = t; i < bh * bw; i += kRotX * kRotY) {
      const int rr = i / bw, cc = i - rr * bw;
      const long long g = plane + (long long)(by + rr) * w + bx + cc;
      simg[i] = __ldg(img + g);
      if (kLabels) slab[i] = __ldg(lab + g);
    }
  }
  __syncthreads();
  if (!live) return;
  float vi[kPix]; int vl[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const bool ok = sy_[k] >= 0;
    if (staged) {
      const int i = (sy_[k] - by) * bw + sx_[k] - bx;
      vi[k] = ok ? simg[i] : 0.f;
      if (kLabels) vl[k] = ok ? slab[i] : 0;
    } else {
      const int src = sy_[k] * w + sx_[k];
      vi[k] = ok ? __ldg(img + plane + src) : 0.f;
      if (kLabels) vl[k] = ok ? __ldg(lab + plane + src) : 0;
    }
  }
  const long long o = plane + (long long)y * w + x0;
  *reinterpret_cast<float4*>(out_img + o) = make_float4(vi[0], vi[1], vi[2], vi[3]);
  if (kLabels) *reinterpret_cast<int4*>(out_lab + o) = make_int4(vl[0], vl[1], vl[2], vl[3]);
}
}  // namespace

extern "C" int roll_var(int v, const float* in, const int* shifts, float* out, int batch, int rows, int wc, void* stream) {
  const long long nrows = (long long)batch * rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rpb = 1 << (v & 3);  // 1, 2, 4, 8 rows a block
  const unsigned grid = (unsigned)((nrows + rpb - 1) / rpb);
  const size_t smem = rpb * (wc * sizeof(float) + sizeof(uint64_t));
  const bool bulk = v < 4;
  switch (rpb) {
    case 1: if (bulk) roll_bulk<1><<<grid, 32, smem, s>>>(in, shifts, out, nrows, wc); else roll_direct<1><<<grid, 32, 0, s>>>(in, shifts, out, nrows, wc); break;
    case 2: if (bulk) roll_bulk<2><<<grid, 64, smem, s>>>(in, shifts, out, nrows, wc); else roll_direct<2><<<grid, 64, 0, s>>>(in, shifts, out, nrows, wc); break;
    case 4: if (bulk) roll_bulk<4><<<grid, 128, smem, s>>>(in, shifts, out, nrows, wc); else roll_direct<4><<<grid, 128, 0, s>>>(in, shifts, out, nrows, wc); break;
    default: if (bulk) roll_bulk<8><<<grid, 256, smem, s>>>(in, shifts, out, nrows, wc); else roll_direct<8><<<grid, 256, 0, s>>>(in, shifts, out, nrows, wc); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int rot_staged_f32(const float* img, const int* lab, const float* angles, float* oi, int* ol, int batch, int h, int w,
                              int py, int px, int hc, int wc, void* stream) {
  const dim3 block(kRotX, kRotY);
  const dim3 grid((unsigned)((w + kRotX * kPix - 1) / (kRotX * kPix)), (unsigned)((h + kRotY - 1) / kRotY), (unsigned)batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lab) rot_staged<true><<<grid, block, 0, s>>>(img, lab, angles, oi, ol, h, w, py, px, hc, wc);
  else rot_staged<false><<<grid, block, 0, s>>>(img, lab, angles, oi, ol, h, w, py, px, hc, wc);
  return (int)cudaGetLastError();
}
