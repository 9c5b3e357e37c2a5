// Minimal PNG decoder for the MRI data path (8-bit gray / gray+alpha /
// RGB / RGBA, non-interlaced), built directly on zlib.
//
// The reference pipeline decodes slice PNGs with PIL inside torch DataLoader
// worker processes (src/open_clip_train/data.py:65-75). Here decode is a
// native routine callable from the loader's thread pool with no GIL and no
// per-process setup: inflate IDAT, undo the per-row filters, expand to the
// requested channel count.

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Decode an in-memory PNG. Returns 0 on success. Output is tightly-packed
// uint8 rows with `out_channels` channels (1 or 3); gray->RGB replication
// and alpha dropping happen here so Python never touches pixels.
// `out_capacity` is the writable byte size of `out`: header-declared
// dimensions are untrusted, so the decoder refuses (-8) rather than
// overflow the caller's buffer.
int mrclip_png_decode(const uint8_t* data, long size, uint8_t* out,
                      long out_capacity, int out_channels, int* width,
                      int* height) {
  if (size < 8 || std::memcmp(data, kPngSig, 8) != 0) return -1;

  long pos = 8;
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  // IDAT segments are inflated straight out of `data` (no concat copy);
  // collect their (offset, length) spans here.
  std::vector<std::pair<long, uint32_t>> idat;

  while (pos + 8 <= size) {
    uint32_t len = be32(data + pos);
    const uint8_t* type = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + (long)len > size) return -2;

    if (std::memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return -2;  // truncated IHDR: fields would read OOB
      w = be32(body);
      h = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      if (bit_depth != 8 || interlace != 0) return -3;  // unsupported flavor
      if (color_type != 0 && color_type != 2 && color_type != 4 && color_type != 6)
        return -3;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat.emplace_back(pos + 8, len);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  if (w == 0 || h == 0 || idat.empty()) return -4;
  // Dimension sanity before any allocation: a hostile header must neither
  // overflow size math / uInt avail_out nor exhaust memory via bad_alloc
  // (which would unwind through extern "C" into std::terminate).
  if ((uint64_t)w * h > (uint64_t)1 << 28) return -3;
  if ((uint64_t)w * h * out_channels > (uint64_t)out_capacity) return -8;

  const int in_ch = (color_type == 0) ? 1 : (color_type == 2) ? 3 : (color_type == 4) ? 2 : 4;
  const size_t stride = (size_t)w * in_ch;
  std::vector<uint8_t> raw((stride + 1) * h);

  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return -5;
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int zret = Z_OK;
  for (size_t s = 0; s < idat.size() && zret == Z_OK; ++s) {
    zs.next_in = const_cast<uint8_t*>(data) + idat[s].first;
    zs.avail_in = (uInt)idat[s].second;
    // Z_FINISH is only valid once all input is present; stream segments
    // before the last use Z_NO_FLUSH.
    zret = inflate(&zs, s + 1 == idat.size() ? Z_FINISH : Z_NO_FLUSH);
  }
  const bool filled = (zs.avail_out == 0);
  inflateEnd(&zs);
  // Z_STREAM_END alone is not enough: a complete-but-short zlib stream
  // would leave zero-initialized rows that silently train as black.
  if (zret != Z_STREAM_END || !filled) return -6;

  // Undo row filters in place (working row layout: filter byte + row bytes).
  // `prev` points at the previous row's already-unfiltered pixels inside
  // `raw` (no per-row copy); a zero row stands in above the first row.
  std::vector<uint8_t> zero_row(stride, 0);
  const uint8_t* prev = zero_row.data();
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* row = raw.data() + y * (stride + 1);
    const uint8_t filter = row[0];
    uint8_t* cur = row + 1;
    switch (filter) {
      case 0:
        break;
      case 1:  // Sub
        for (size_t i = in_ch; i < stride; ++i) cur[i] += cur[i - in_ch];
        break;
      case 2:  // Up
        for (size_t i = 0; i < stride; ++i) cur[i] += prev[i];
        break;
      case 3:  // Average
        for (size_t i = 0; i < (size_t)in_ch; ++i) cur[i] += prev[i] / 2;
        for (size_t i = in_ch; i < stride; ++i)
          cur[i] += (uint8_t)(((int)cur[i - in_ch] + prev[i]) / 2);
        break;
      case 4:  // Paeth
        for (size_t i = 0; i < (size_t)in_ch; ++i)
          cur[i] += (uint8_t)paeth(0, prev[i], 0);
        for (size_t i = in_ch; i < stride; ++i)
          cur[i] += (uint8_t)paeth(cur[i - in_ch], prev[i], prev[i - in_ch]);
        break;
      default:
        return -7;
    }
    prev = cur;

    // Channel conversion into the output buffer.
    uint8_t* dst = out + (size_t)y * w * out_channels;
    if (in_ch == 3 && out_channels == 3) {
      std::memcpy(dst, cur, stride);  // RGB -> RGB rows copy straight through
    } else if (in_ch == 1 && out_channels == 3) {
      for (uint32_t x = 0; x < w; ++x) {  // gray -> RGB (the MRI common case)
        const uint8_t v = cur[x];
        dst[x * 3 + 0] = v;
        dst[x * 3 + 1] = v;
        dst[x * 3 + 2] = v;
      }
    } else {
      for (uint32_t x = 0; x < w; ++x) {
        const uint8_t* px = cur + (size_t)x * in_ch;
        uint8_t r, g, b;
        if (in_ch <= 2) {
          r = g = b = px[0];
        } else {
          r = px[0];
          g = px[1];
          b = px[2];
        }
        if (out_channels == 1) {
          dst[x] = r;
        } else {
          dst[x * 3 + 0] = r;
          dst[x * 3 + 1] = g;
          dst[x * 3 + 2] = b;
        }
      }
    }
  }

  *width = (int)w;
  *height = (int)h;
  return 0;
}

}  // extern "C"
