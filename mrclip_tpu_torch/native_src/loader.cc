// Native batch image loader: threaded file read + PNG decode + bilinear
// resize into a caller-provided contiguous batch buffer.
//
// TPU-native replacement for the reference's torch DataLoader worker
// processes (src/open_clip_train/data.py) on the host side: one C++ thread
// pool fills [N, H, W, C] uint8 without the GIL; the device-side fused
// augmentation (mrclip_tpu/ops/image_ops.py) takes it from there.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" int mrclip_png_decode(const uint8_t* data, long size, uint8_t* out,
                                 long out_capacity, int out_channels,
                                 int* width, int* height);

namespace {

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf->resize(size);
  size_t got = std::fread(buf->data(), 1, size, f);
  std::fclose(f);
  return got == (size_t)size;
}

// --- PIL-equivalent separable resampling (Imaging/Resample.c semantics) ---
//
// The reference eval path is torchvision Resize on PIL images, which is
// PIL's antialiased separable convolution: filter support scales with the
// downscale factor and coefficients are normalized per output pixel. The
// bicubic kernel is Keys a=-0.5, matching PIL/torchvision BICUBIC
// (reference transform.py:366-397 uses InterpolationMode.BICUBIC).

inline float filter_bilinear(float x) {
  x = std::fabs(x);
  return x < 1.f ? 1.f - x : 0.f;
}

inline float filter_bicubic(float x) {
  const float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.f) return ((a + 2.f) * x - (a + 3.f)) * x * x + 1.f;
  if (x < 2.f) return (((x - 5.f) * x + 8.f) * x - 4.f) * a;
  return 0.f;
}

enum Interp { kBilinear = 0, kBicubic = 1 };

// Per-output-pixel bounds + normalized coefficients for one axis, resampling
// the source box [box0, box1) to out_size. Returns the coeff row stride.
int precompute_coeffs(int in_size, float box0, float box1, int out_size,
                      int interp, std::vector<int>* bounds,
                      std::vector<float>* kk) {
  const float support_base = interp == kBicubic ? 2.f : 1.f;
  float scale = (box1 - box0) / out_size;
  float filterscale = scale < 1.f ? 1.f : scale;
  float support = support_base * filterscale;
  int ksize = (int)std::ceil(support) * 2 + 1;
  bounds->resize((size_t)out_size * 2);
  kk->assign((size_t)out_size * ksize, 0.f);
  for (int xx = 0; xx < out_size; ++xx) {
    float center = box0 + (xx + 0.5f) * scale;
    int xmin = (int)(center - support + 0.5f);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5f);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    float* k = kk->data() + (size_t)xx * ksize;
    float ww = 0.f;
    for (int x = 0; x < xmax; ++x) {
      float w = interp == kBicubic
                    ? filter_bicubic((x + xmin - center + 0.5f) / filterscale)
                    : filter_bilinear((x + xmin - center + 0.5f) / filterscale);
      k[x] = w;
      ww += w;
    }
    if (ww != 0.f)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    (*bounds)[(size_t)xx * 2] = xmin;
    (*bounds)[(size_t)xx * 2 + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clamp_u8(float v) {
  return v <= 0.f ? 0 : (v >= 255.f ? 255 : (uint8_t)(v + 0.5f));
}

// Antialiased resize of the source window [src_y0, src_y0+win_h) x
// [src_x0, src_x0+win_w) of `src` into a dst sub-rectangle of a row-major
// [H, out_row_w] canvas. The window form expresses all three eval resize
// modes (squash / shortest-edge+crop / longest+pad) as one resample.
void resize_window(const uint8_t* src, int sh, int sw, int c, float src_y0,
                   float src_x0, float win_h, float win_w, uint8_t* dst,
                   int out_row_w, int dst_y0, int dst_x0, int dh, int dw,
                   int interp) {
  std::vector<int> xb, yb;
  std::vector<float> xk, yk;
  int xks = precompute_coeffs(sw, src_x0, src_x0 + win_w, dw, interp, &xb, &xk);
  int yks = precompute_coeffs(sh, src_y0, src_y0 + win_h, dh, interp, &yb, &yk);

  // horizontal pass over only the source rows the vertical pass will touch
  int ymin_all = sh, ymax_all = 0;
  for (int y = 0; y < dh; ++y) {
    if (yb[(size_t)y * 2] < ymin_all) ymin_all = yb[(size_t)y * 2];
    int hi = yb[(size_t)y * 2] + yb[(size_t)y * 2 + 1];
    if (hi > ymax_all) ymax_all = hi;
  }
  if (ymax_all <= ymin_all) return;
  int rows = ymax_all - ymin_all;
  std::vector<float> tmp((size_t)rows * dw * c);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* srow = src + ((size_t)(ymin_all + y) * sw) * c;
    float* trow = tmp.data() + (size_t)y * dw * c;
    for (int x = 0; x < dw; ++x) {
      int x0 = xb[(size_t)x * 2], xn = xb[(size_t)x * 2 + 1];
      const float* k = xk.data() + (size_t)x * xks;
      // accumulate all channels per tap so the source reads are contiguous
      // (same per-element tap order as a per-channel loop -> bit-identical)
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      const uint8_t* p = srow + (size_t)x0 * c;
      for (int i = 0; i < xn; ++i, p += c)
        for (int ch = 0; ch < c; ++ch) acc[ch] += p[ch] * k[i];
      // PIL rounds the horizontal pass to uint8 before the vertical pass
      // (Resample.c 8bpc path); mirror that for bit-level closeness.
      for (int ch = 0; ch < c; ++ch)
        trow[(size_t)x * c + ch] = (float)clamp_u8(acc[ch]);
    }
  }
  // vertical pass into the destination canvas: sweep whole tmp rows per tap
  // (contiguous, auto-vectorizable) instead of striding down columns
  const int rowlen = dw * c;
  std::vector<float> accrow((size_t)rowlen);
  for (int y = 0; y < dh; ++y) {
    int y0 = yb[(size_t)y * 2] - ymin_all, yn = yb[(size_t)y * 2 + 1];
    const float* k = yk.data() + (size_t)y * yks;
    std::memset(accrow.data(), 0, sizeof(float) * rowlen);
    for (int i = 0; i < yn; ++i) {
      const float kv = k[i];
      const float* trow = tmp.data() + (size_t)(y0 + i) * rowlen;
      for (int j = 0; j < rowlen; ++j) accrow[j] += kv * trow[j];
    }
    uint8_t* row = dst + ((size_t)(dst_y0 + y) * out_row_w + dst_x0) * c;
    for (int j = 0; j < rowlen; ++j) row[j] = clamp_u8(accrow[j]);
  }
}

// Resize modes for mrclip_load_batch (mirror transforms.EvalTransform /
// reference transform.py:366-397).
enum ResizeMode {
  kSquash = 0,   // full-image stretch to the canvas
  kCover = 1,    // shortest-edge resize + center crop (eval default)
  kContain = 2,  // longest-edge resize + centered zero padding
};

void resize_into_canvas(const uint8_t* src, int h, int w, int c, uint8_t* dst,
                        int out_h, int out_w, int mode, int interp) {
  if (mode == kCover) {
    // Replicate the reference's exact two-stage geometry (torchvision
    // Resize -> CenterCrop on PIL): resize to ROUNDED integer dims (so the
    // effective per-axis scale is rh/h, not the ideal cover scale), then
    // integer-offset center crop. Expressed as one source-window resample:
    // output row y samples src at (y + top + 0.5) * h/rh, i.e. box
    // [top*h/rh, (top+out_h)*h/rh).
    float scale = (float)out_h / h;
    float sw_scale = (float)out_w / w;
    if (sw_scale > scale) scale = sw_scale;  // cover: max scale
    int rh = (int)(h * scale + 0.5f), rw = (int)(w * scale + 0.5f);
    if (rh < out_h) rh = out_h;
    if (rw < out_w) rw = out_w;
    int top = (rh - out_h) / 2, left = (rw - out_w) / 2;
    float y0 = (float)top * h / rh, x0 = (float)left * w / rw;
    float win_h = (float)out_h * h / rh, win_w = (float)out_w * w / rw;
    resize_window(src, h, w, c, y0, x0, win_h, win_w, dst, out_w, 0, 0, out_h,
                  out_w, interp);
  } else if (mode == kContain) {
    float scale = (float)out_h / h;
    float sw_scale = (float)out_w / w;
    if (sw_scale < scale) scale = sw_scale;  // contain: min scale
    int dh = (int)(h * scale + 0.5f);
    int dw = (int)(w * scale + 0.5f);
    if (dh > out_h) dh = out_h;
    if (dw > out_w) dw = out_w;
    resize_window(src, h, w, c, 0.f, 0.f, (float)h, (float)w, dst, out_w,
                  (out_h - dh) / 2, (out_w - dw) / 2, dh, dw, interp);
  } else {  // kSquash
    resize_window(src, h, w, c, 0.f, 0.f, (float)h, (float)w, dst, out_w, 0,
                  0, out_h, out_w, interp);
  }
}

}  // namespace

extern "C" {

// Decode `n` PNG files into out[N, out_h, out_w, channels] uint8, resizing
// each image by `mode`: 0 = full-image squash, 1 = shortest-edge resize +
// center crop (the EvalTransform default; reference transform.py:366-397),
// 2 = longest-edge resize + centered zero padding. `interp`: 0 = bilinear,
// 1 = bicubic (PIL-equivalent antialiased resampling either way; the
// reference eval default is bicubic). `status[i]` gets 0 on success, the
// decoder's error code otherwise (row left zeroed).
void mrclip_load_batch(const char** paths, int n, uint8_t* out, int out_h,
                       int out_w, int channels, int mode, int interp,
                       int num_threads, int* status) {
  std::atomic<int> next{0};
  const size_t out_stride = (size_t)out_h * out_w * channels;

  auto worker = [&]() {
    std::vector<uint8_t> file_buf;
    std::vector<uint8_t> pixels;
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = -100;
      uint8_t* dst = out + (size_t)i * out_stride;
      std::memset(dst, 0, out_stride);
      if (!read_file(paths[i], &file_buf)) continue;

      if (file_buf.size() < 24) continue;
      uint32_t pw = (file_buf[16] << 24) | (file_buf[17] << 16) | (file_buf[18] << 8) | file_buf[19];
      uint32_t ph = (file_buf[20] << 24) | (file_buf[21] << 16) | (file_buf[22] << 8) | file_buf[23];
      if ((size_t)pw * ph > (size_t)8192 * 8192) continue;
      if (pixels.size() < (size_t)pw * ph * channels)
        pixels.resize((size_t)pw * ph * channels);
      int w = 0, h = 0;
      int rc = mrclip_png_decode(file_buf.data(), (long)file_buf.size(),
                                 pixels.data(), (long)pixels.size(), channels,
                                 &w, &h);
      status[i] = rc;
      if (rc != 0) continue;
      resize_into_canvas(pixels.data(), h, w, channels, dst, out_h, out_w,
                         mode, interp);
    }
  };

  int t = num_threads > 0 ? num_threads : (int)std::thread::hardware_concurrency();
  if (t > n) t = n;
  if (t <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"

namespace {

// Bilinear sample with out-of-bounds -> 0 (torchvision affine fill).
inline void sample_bilinear(const uint8_t* src, int sh, int sw, int c,
                            float fy, float fx, uint8_t* out_px) {
  int y0 = (int)std::floor(fy);
  int x0 = (int)std::floor(fx);
  float wy = fy - y0, wx = fx - x0;
  for (int ch = 0; ch < c; ++ch) {
    float acc = 0.f;
    for (int dy = 0; dy < 2; ++dy) {
      int yy = y0 + dy;
      float rowf = 0.f;
      if (yy >= 0 && yy < sh) {
        for (int dx = 0; dx < 2; ++dx) {
          int xx = x0 + dx;
          float v = (xx >= 0 && xx < sw) ? src[(yy * sw + xx) * c + ch] : 0.f;
          rowf += v * (dx ? wx : 1.f - wx);
        }
      }
      acc += rowf * (dy ? wy : 1.f - wy);
    }
    out_px[ch] = (uint8_t)(acc + 0.5f);
  }
}

// --- color ops (torchvision-equivalent math on uint8, float internally) ---

inline float luma(const uint8_t* px) {
  // torchvision rgb_to_grayscale weights
  return 0.2989f * px[0] + 0.587f * px[1] + 0.114f * px[2];
}

void rgb_to_hsv(float r, float g, float b, float* h, float* s, float* v) {
  float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
  float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
  float d = mx - mn;
  *v = mx;
  *s = mx > 0.f ? d / mx : 0.f;
  if (d <= 0.f) {
    *h = 0.f;
    return;
  }
  float hh;
  if (mx == r)
    hh = (g - b) / d;
  else if (mx == g)
    hh = 2.f + (b - r) / d;
  else
    hh = 4.f + (r - g) / d;
  hh /= 6.f;
  if (hh < 0.f) hh += 1.f;
  *h = hh;
}

void hsv_to_rgb(float h, float s, float v, float* r, float* g, float* b) {
  float i = std::floor(h * 6.f);
  float f = h * 6.f - i;
  float p = v * (1.f - s);
  float q = v * (1.f - f * s);
  float t = v * (1.f - (1.f - f) * s);
  switch (((int)i % 6 + 6) % 6) {
    case 0: *r = v; *g = t; *b = p; break;
    case 1: *r = q; *g = v; *b = p; break;
    case 2: *r = p; *g = v; *b = t; break;
    case 3: *r = p; *g = q; *b = v; break;
    case 4: *r = t; *g = p; *b = v; break;
    default: *r = v; *g = p; *b = q; break;
  }
}

// Color jitter + grayscale on an RGB uint8 canvas. `cp` = 6 floats per image:
// (brightness_factor, contrast_factor, saturation_factor, hue_shift_turns,
// apply_jitter, apply_gray); factor 1 / shift 0 = identity. Fixed op order
// brightness -> contrast -> saturation -> hue (matches the device backend;
// the host/PIL backend randomizes the order per sample).
void color_jitter_u8(uint8_t* img, int h, int w, const float* cp) {
  bool jitter = cp[4] > 0.5f;
  bool gray = cp[5] > 0.5f;
  if (!jitter && !gray) return;
  size_t n = (size_t)h * w;
  if (jitter) {
    float fb = cp[0], fc = cp[1], fs = cp[2], fh = cp[3];
    if (fb != 1.f) {
      for (size_t i = 0; i < n * 3; ++i) img[i] = clamp_u8(img[i] * fb);
    }
    if (fc != 1.f) {
      // torchvision adjust_contrast: blend with the mean of the grayscale
      double acc = 0.0;
      for (size_t i = 0; i < n; ++i) acc += luma(img + i * 3);
      float mean = (float)(acc / n);
      for (size_t i = 0; i < n * 3; ++i)
        img[i] = clamp_u8(mean + fc * (img[i] - mean));
    }
    if (fs != 1.f) {
      for (size_t i = 0; i < n; ++i) {
        uint8_t* px = img + i * 3;
        float l = luma(px);
        for (int c = 0; c < 3; ++c) px[c] = clamp_u8(l + fs * (px[c] - l));
      }
    }
    if (fh != 0.f) {
      for (size_t i = 0; i < n; ++i) {
        uint8_t* px = img + i * 3;
        float hh, ss, vv, r, g, b;
        rgb_to_hsv(px[0] / 255.f, px[1] / 255.f, px[2] / 255.f, &hh, &ss, &vv);
        hh += fh;
        hh -= std::floor(hh);
        hsv_to_rgb(hh, ss, vv, &r, &g, &b);
        px[0] = clamp_u8(r * 255.f);
        px[1] = clamp_u8(g * 255.f);
        px[2] = clamp_u8(b * 255.f);
      }
    }
  }
  if (gray) {
    for (size_t i = 0; i < n; ++i) {
      uint8_t* px = img + i * 3;
      uint8_t l = clamp_u8(luma(px));
      px[0] = px[1] = px[2] = l;
    }
  }
}

// Separable 3x3 gaussian blur, sigma per image. Rows are treated as flat
// [w*c] arrays so both passes are contiguous 3-tap stencils (taps at +-c
// horizontally, +-row vertically) the compiler auto-vectorizes; edge pixels
// replicate, identical to the per-pixel clamped formulation.
void blur3(uint8_t* img, int h, int w, int c, float sigma, float* tmp) {
  float k1 = std::exp(-0.5f / (sigma * sigma));
  float k0 = 1.f, norm = k0 + 2 * k1;
  k0 /= norm; k1 /= norm;
  const int rowlen = w * c;
  // horizontal
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = img + (size_t)y * rowlen;
    float* t = tmp + (size_t)y * rowlen;
    for (int ch = 0; ch < c; ++ch)  // x = 0: left tap replicates
      t[ch] = (k0 + k1) * s[ch] + k1 * s[c + ch];
    for (int j = c; j < rowlen - c; ++j)
      t[j] = k1 * s[j - c] + k0 * s[j] + k1 * s[j + c];
    for (int j = rowlen - c; j < rowlen; ++j)  // x = w-1: right tap replicates
      t[j] = k1 * s[j - c] + (k0 + k1) * s[j];
  }
  // vertical
  for (int y = 0; y < h; ++y) {
    const float* tm = tmp + (size_t)(y > 0 ? y - 1 : 0) * rowlen;
    const float* t0 = tmp + (size_t)y * rowlen;
    const float* tp = tmp + (size_t)(y < h - 1 ? y + 1 : h - 1) * rowlen;
    uint8_t* d = img + (size_t)y * rowlen;
    for (int j = 0; j < rowlen; ++j)
      d[j] = (uint8_t)(k1 * tm[j] + k0 * t0[j] + k1 * tp[j] + 0.5f);
  }
}

}  // namespace

extern "C" {

// Decode PNGs and apply a full train-time augmentation per image:
// a 2x3 output->input affine matrix (composing resized-crop, rotation,
// translation, scale, flip — computed by the Python side against the
// DECODED image size normalized to [0,1] coords), then 3x3 gaussian blur.
// `matrices`: [n, 6] row-major (a, b, tx, c, d, ty) in NORMALIZED input
// coords: src_x = (a*x + b*y + tx) * (sw-1), src_y = (c*x + d*y + ty) * (sh-1)
// where (x, y) are normalized output coords in [0, 1].
// `color_params` (nullable): [n, 6] per-image
// (brightness, contrast, saturation, hue_shift, apply_jitter, apply_gray)
// applied after the blur (reference transform.py:349-357 ordering).
void mrclip_augment_batch(const char** paths, int n, uint8_t* out, int out_h,
                          int out_w, int channels, const float* matrices,
                          const float* blur_sigmas, const float* color_params,
                          int num_threads, int* status) {
  std::atomic<int> next{0};
  const size_t out_stride = (size_t)out_h * out_w * channels;

  auto worker = [&]() {
    std::vector<uint8_t> file_buf;
    std::vector<uint8_t> pixels;
    std::vector<float> tmp((size_t)out_h * out_w * channels);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      status[i] = -100;
      uint8_t* dst = out + (size_t)i * out_stride;
      std::memset(dst, 0, out_stride);
      if (!read_file(paths[i], &file_buf)) continue;
      // size the decode buffer from IHDR (big-endian w/h at offsets 16/20)
      if (file_buf.size() < 24) continue;
      uint32_t pw = (file_buf[16] << 24) | (file_buf[17] << 16) | (file_buf[18] << 8) | file_buf[19];
      uint32_t ph = (file_buf[20] << 24) | (file_buf[21] << 16) | (file_buf[22] << 8) | file_buf[23];
      if ((size_t)pw * ph > (size_t)8192 * 8192) continue;
      if (pixels.size() < (size_t)pw * ph * channels)
        pixels.resize((size_t)pw * ph * channels);
      int w = 0, h = 0;
      int rc = mrclip_png_decode(file_buf.data(), (long)file_buf.size(),
                                 pixels.data(), (long)pixels.size(), channels,
                                 &w, &h);
      status[i] = rc;
      if (rc != 0) continue;

      const float* m = matrices + (size_t)i * 6;
      const float sx_step = (out_w > 1 ? m[0] / (out_w - 1) : 0.f) * (w - 1);
      const float sy_step = (out_w > 1 ? m[3] / (out_w - 1) : 0.f) * (h - 1);
      const uint8_t* src = pixels.data();
      for (int y = 0; y < out_h; ++y) {
        float ny = out_h > 1 ? (float)y / (out_h - 1) : 0.f;
        // incremental source coords along the row
        float sx = (m[1] * ny + m[2]) * (w - 1);
        float sy = (m[4] * ny + m[5]) * (h - 1);
        uint8_t* row = dst + (size_t)y * out_w * channels;
        for (int x = 0; x < out_w; ++x, sx += sx_step, sy += sy_step) {
          int x0 = (int)std::floor(sx);
          int y0 = (int)std::floor(sy);
          uint8_t* px = row + (size_t)x * channels;
          if (x0 >= 0 && y0 >= 0 && x0 + 1 < w && y0 + 1 < h) {
            // interior fast path: no bounds checks
            float wx = sx - x0, wy = sy - y0;
            const uint8_t* p00 = src + ((size_t)y0 * w + x0) * channels;
            const uint8_t* p10 = p00 + (size_t)w * channels;
            float w00 = (1.f - wx) * (1.f - wy), w01 = wx * (1.f - wy);
            float w10 = (1.f - wx) * wy, w11 = wx * wy;
            for (int ch = 0; ch < channels; ++ch)
              px[ch] = (uint8_t)(w00 * p00[ch] + w01 * p00[channels + ch] +
                                 w10 * p10[ch] + w11 * p10[channels + ch] + 0.5f);
          } else {
            sample_bilinear(src, h, w, channels, sy, sx, px);
          }
        }
      }
      if (blur_sigmas && blur_sigmas[i] > 0.f)
        blur3(dst, out_h, out_w, channels, blur_sigmas[i], tmp.data());
      if (color_params && channels == 3)
        color_jitter_u8(dst, out_h, out_w, color_params + (size_t)i * 6);
    }
  };

  int t = num_threads > 0 ? num_threads : (int)std::thread::hardware_concurrency();
  if (t > n) t = n;
  if (t <= 1) {
    worker();
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(t);
  for (int k = 0; k < t; ++k) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
