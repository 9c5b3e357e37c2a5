// Undo the PNG row filters of one 8-bit, non-interlaced image, on the host.
// Plain C interface; no device code (nvcc only drives the host compiler).
//
// Not the port of a TPU kernel: the JAX package decodes PNGs through PIL
// (mrclip_tpu/data/csv_dataset.py, Image.open), whose decoder unfilters in
// C. The port reads PNGs with its own codec (mrclip_tpu_torch/data/png.py)
// and inflates with Python's zlib; this is the part numpy cannot vectorise:
// the Average and Paeth filters take the pixel to the left after it has
// been reconstructed, so a row is a sequential scan.
//
// raw: height rows of (1 + rowbytes) bytes, each a filter type byte (0 None,
// 1 Sub, 2 Up, 3 Average, 4 Paeth) then the filtered bytes; out: height x
// rowbytes reconstructed bytes; bpp: bytes per pixel (1 to 4). Returns 0, or
// the 1-based row index of the first row with an unknown filter type.

#include <cstdint>
#include <cstdlib>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

extern "C" int png_unfilter(const uint8_t* raw, uint8_t* out, int height, int rowbytes, int bpp) {
    for (int y = 0; y < height; ++y) {
        const uint8_t* f = raw + (size_t)y * (rowbytes + 1);
        const int type = f[0];
        ++f;
        uint8_t* o = out + (size_t)y * rowbytes;
        const uint8_t* up = y ? o - rowbytes : nullptr;
        switch (type) {
            case 0:
                for (int i = 0; i < rowbytes; ++i) o[i] = f[i];
                break;
            case 1:
                for (int i = 0; i < rowbytes; ++i) o[i] = (uint8_t)(f[i] + (i >= bpp ? o[i - bpp] : 0));
                break;
            case 2:
                for (int i = 0; i < rowbytes; ++i) o[i] = (uint8_t)(f[i] + (up ? up[i] : 0));
                break;
            case 3:
                for (int i = 0; i < rowbytes; ++i) {
                    int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
                    o[i] = (uint8_t)(f[i] + ((a + b) >> 1));
                }
                break;
            case 4:
                for (int i = 0; i < rowbytes; ++i) {
                    int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
                    int c = (up && i >= bpp) ? up[i - bpp] : 0;
                    o[i] = (uint8_t)(f[i] + paeth(a, b, c));
                }
                break;
            default:
                return y + 1;
        }
    }
    return 0;
}
