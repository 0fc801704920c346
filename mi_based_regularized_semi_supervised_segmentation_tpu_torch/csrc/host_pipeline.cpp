// Native host-side data pipeline of the PyTorch port: PNG decode + fused
// paired augmentation. A copy of the JAX package's native/src/host_pipeline.cpp
// (same entry points, same arithmetic), built by ops/build.py:build_host with
// g++ -O3 -march=native -fPIC -shared -std=c++17 ... -lz into
// build/torch_host/ and bound with ctypes by data/native.py.
//
//  - misst_decode_png_gray8: minimal decoder for the exact format the
//    preprocessing emits (8-bit grayscale, non-interlaced PNG), zlib inflate
//    + filter reconstruction. No libpng dependency.
//  - misst_augment_pair: fused rotate(nearest)+flip+crop+intensity-jitter on
//    an image/label pair in one pass, no intermediate buffers.
//
// Not bit-compatible with the numpy path (data/augment.py), and neither is
// the JAX package's copy. The angle, brightness and contrast arrive as float32
// and the jitter is computed in double with a double mean, where numpy scales
// the float32 image by the float64 draws in float32 and sums its mean in
// float32 (outputs differ by up to ~1.2e-7); the angle's float32 rounding and
// angle * pi / 180 (numpy: deg2rad) move a nearest-neighbour tie to the other
// pixel once in a while (2 label pixels in 50 draws at 256^2 -> 224). ISO
// C++17 (not gnu++17) keeps floating-point contraction off, which these bits
// rely on.
//
// Threading is the caller's: ctypes releases the GIL around each call, and
// every entry point is re-entrant.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// PNG decode (8-bit grayscale, non-interlaced)
// ---------------------------------------------------------------------------

static uint32_t read_be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

static inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  if (pb <= pc) return uint8_t(b);
  return uint8_t(c);
}

// Returns 0 on success. out must hold max_h*max_w bytes; h/w are written.
int misst_decode_png_gray8(const uint8_t* data, int64_t len, uint8_t* out,
                           int32_t* out_h, int32_t* out_w, int64_t out_cap) {
  static const uint8_t magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (len < 8 || std::memcmp(data, magic, 8) != 0) return 1;
  int64_t pos = 8;
  int32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= len) {
    uint32_t chunk_len = read_be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 8 + chunk_len + 4 > uint64_t(len)) return 2;
    if (!std::memcmp(type, "IHDR", 4)) {
      if (chunk_len < 13) return 3;
      w = int32_t(read_be32(body));
      h = int32_t(read_be32(body + 4));
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + chunk_len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 8 + chunk_len + 4;  // skip CRC
  }
  if (w <= 0 || h <= 0 || bit_depth != 8 || color_type != 0 || interlace != 0)
    return 4;  // only 8-bit grayscale non-interlaced
  if (int64_t(w) * h > out_cap) return 5;

  const int64_t stride = w;
  std::vector<uint8_t> raw((stride + 1) * h);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return 6;
  if (raw_len != raw.size()) return 7;

  // undo per-scanline filters (bpp = 1)
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = raw.data() + y * (stride + 1) + 1;
    uint8_t* dst = out + y * stride;
    const uint8_t* up = (y > 0) ? out + (y - 1) * stride : nullptr;
    switch (filter) {
      case 0:
        std::memcpy(dst, src, stride);
        break;
      case 1:
        dst[0] = src[0];
        for (int64_t x = 1; x < stride; ++x) dst[x] = uint8_t(src[x] + dst[x - 1]);
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          dst[x] = uint8_t(src[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          int left = (x > 0) ? dst[x - 1] : 0;
          int above = up ? up[x] : 0;
          dst[x] = uint8_t(src[x] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          int left = (x > 0) ? dst[x - 1] : 0;
          int above = up ? up[x] : 0;
          int corner = (x > 0 && up) ? up[x - 1] : 0;
          dst[x] = uint8_t(src[x] + paeth(left, above, corner));
        }
        break;
      default:
        return 8;
    }
  }
  *out_h = h;
  *out_w = w;
  return 0;
}

// ---------------------------------------------------------------------------
// Fused paired augmentation
// ---------------------------------------------------------------------------

// img: float32 [h, w] in [0,1]; gt: int32 [h, w] (may be null).
// Applies: rotation by angle_deg (nearest, zero fill) -> optional v/h flips
// -> crop (crop x crop at crop_y/crop_x of the center-padded canvas) ->
// brightness/contrast jitter (image only; skipped when brightness < 0).
// out_img: float32 [crop, crop]; out_gt: int32 [crop, crop] (if gt given).
int misst_augment_pair(const float* img, const int32_t* gt, int32_t h, int32_t w,
                       float angle_deg, int32_t vflip, int32_t hflip,
                       int32_t crop_y, int32_t crop_x, int32_t crop,
                       float brightness, float contrast,
                       float* out_img, int32_t* out_gt) {
  const double theta = angle_deg * M_PI / 180.0;
  const double cos_t = std::cos(theta), sin_t = std::sin(theta);
  const double cy = (h - 1) / 2.0, cx = (w - 1) / 2.0;
  const bool rotate = std::fabs(angle_deg) >= 1e-6;

  // padded canvas geometry (matches numpy _pad_to: centered zero pad)
  const int32_t ph = h >= crop ? h : crop;
  const int32_t pw = w >= crop ? w : crop;
  const int32_t top = (ph - h) / 2, left = (pw - w) / 2;

  double mean_acc = 0.0;
  for (int32_t oy = 0; oy < crop; ++oy) {
    for (int32_t ox = 0; ox < crop; ++ox) {
      // position on the padded, flipped, rotated canvas
      int64_t yy = oy + crop_y, xx = ox + crop_x;
      // un-pad
      int64_t fy = yy - top, fx = xx - left;
      float vi = 0.0f;
      int32_t vg = 0;
      if (fy >= 0 && fy < h && fx >= 0 && fx < w) {
        // un-flip
        int64_t ry = vflip ? (h - 1 - fy) : fy;
        int64_t rx = hflip ? (w - 1 - fx) : fx;
        if (rotate) {
          const double ycd = ry - cy, xcd = rx - cx;
          const double sx = cos_t * xcd - sin_t * ycd + cx;
          const double sy = sin_t * xcd + cos_t * ycd + cy;
          const int64_t ix = int64_t(std::nearbyint(sx));
          const int64_t iy = int64_t(std::nearbyint(sy));
          if (ix >= 0 && ix < w && iy >= 0 && iy < h) {
            vi = img[iy * w + ix];
            if (gt) vg = gt[iy * w + ix];
          }
        } else {
          vi = img[ry * w + rx];
          if (gt) vg = gt[ry * w + rx];
        }
      }
      out_img[oy * crop + ox] = vi;
      if (out_gt) out_gt[oy * crop + ox] = vg;
      mean_acc += vi;
    }
  }
  if (brightness >= 0.0f) {
    const double n = double(crop) * crop;
    // brightness scales first; mean computed after brightness (matches numpy)
    const double mean = (mean_acc * brightness) / n;
    for (int64_t i = 0; i < int64_t(crop) * crop; ++i) {
      double v = out_img[i] * brightness;
      v = (v - mean) * contrast + mean;
      out_img[i] = float(v < 0.0 ? 0.0 : v);
    }
  }
  return 0;
}

}  // extern "C"
