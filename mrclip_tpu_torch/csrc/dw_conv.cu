// Depthwise convolution (stride 1, SAME zero padding, NHWC) for Hopper
// (sm_90a), plain C interface: the port of MRCLIP_DW_IMPL=pallas.
//
//   K8, dw_conv_fwd: replaces mrclip_tpu/ops/dw_conv.py::_fwd_kernel
//       (:57, driven by _core_fwd :113);
//   K9, dw_conv_bwd: replaces mrclip_tpu/ops/dw_conv.py::_bwd_kernel
//       (:75, driven by _core_bwd :128).
//
// With P = K/2 and w the [K*K, C] fp32 table (tap t = i*K + j):
//
//   y[b,p,q,c]  = sum_t x[b, p+i-P, q+j-P, c] * w[t,c]     (zero outside)
//   dx[b,p,q,c] = sum_t dy[b, p-i+P, q-j+P, c] * w[t,c]    (taps flipped)
//   dw[t,c]     = sum_{b,p,q} x[b, p+i-P, q+j-P, c] * dy[b,p,q,c]
//
// y and dx accumulate in fp32 in tap order, each product rounded and then
// added (__fmul_rn / __fadd_rn: nvcc's default --fmad=true would contract
// acc + x*w into one FFMA), and round once to the input type T:
// bit-identical to the plain versions in mrclip_tpu_torch/ops/dw_conv.py.
// dy arrives already rounded to T. dw may fuse (fmaf): its bar is 1e-3 of
// its largest value.
//
// Bounds, as chip_smoke.py's dw_bound reckons them on an H100 SXM, at
// MobileCLIP-S1 stage 0, b256 (x [256, 64, 64, 64] bf16, 67.1M elements):
// K8 reads x and writes y once (268 MB, 80 us at 3.35 TB/s) against one FMA
// per tap and element (K = 7: 6.58 GFLOP, 98 us at 67 TFLOP/s): bytes at
// K = 3, operations at K = 7. K9 reads x and dy and writes dx (403 MB, 120
// us) against two FMAs per tap and element (196 us). y and dx cannot fuse,
// so their own floor is two FP32 instructions per tap and element, and K9's
// three (dx unfused, dw fused): at ~33.5 T FP32 instructions/s (132 SMs x
// 128 lanes x ~1.98 GHz) 196 us for K8 and 295 us for K9 at stage 0, 7x7.
//
// Design. The TPU kernels hold one whole image per program in VMEM and carry
// dw across the sequential grid in a revisited block. One output element
// per thread would issue K^2 loads of x (2 bytes each, through L1) and K^2
// of w for its K^2 multiplies and adds, and be bound by load issue, far
// from either bound; and a dw pass apart from the dx pass reads dy and x
// again. Here:
//  * A block of 8 warps owns a tile of TH x TW output pixels x 64 channels of
//    one image, chosen per shape by the wrapper (ops/dw_conv.py::plan): 16 x
//    16 on MobileCLIP-S1's 64, 32 and 16 maps, 8 x 8 on the 8 x 8 map, and
//    halved in height where a block would take more shared memory than lets
//    three K8 or two K9 blocks share an SM (fp32, and edges). It stages its
//    input tile with the halo, (TH+K-1) x (TW+K-1) x 64, into shared memory
//    once, by 16-byte cp.async where C and the pointers allow it (WIDE; one
//    copy per 8 bf16 or 4 fp32 channels), element by element where they do
//    not (odd C, a view whose storage offset breaks 16-byte alignment), and
//    its [K*K, 64] slice of the fp32 weight table beside it. Pixels outside
//    the image and channels past C are zero-filled, so edge tiles run the
//    interior loop, without a predicate per tap. An added 0 * w leaves every
//    finite sum as the skipped tap would (the sum starts at +0 and cannot
//    reach -0), but turns an Inf or NaN weight into NaN at the edge where
//    the plain version skips the tap.
//  * Each thread owns a channel pair (one 32-bit shared-memory word in bf16,
//    a float2 in fp32; a warp reads one pixel's 64 channels, conflict-free)
//    and a strip of S = 8 consecutive outputs along W. For each tap row it
//    loads the S+K-1 inputs of that row into a register window and the K
//    weights of the row, then for each tap j and each of its outputs adds the
//    rounded product: each output still takes its taps in the order i*K + j.
//    Shared-memory loads per tap and output fall from 2 to (S+K-1)/(2*S*K) +
//    1/(2S): 0.19 at K = 7 (bf16 adds one integer instruction per element
//    to widen a pair word), so the FP32 pipes, not load issue, set the pace.
//    One tap row's window is live at a time: with the rows unrolled the K = 7
//    instantiations spilled (tools/dw_conv_variants.py).
//  * Outputs go out as one pair store per thread (a warp writes 128 or 256
//    contiguous bytes of a pixel), elementwise in the narrow form.
//  * K9 is one pass over x and dy, as the TPU kernel: a block stages dy with
//    its halo and x without one (x[a, b] meets dy[a-i+P, b-j+P] for tap
//    (i, j)), writes the tile's dx with the flipped stencil above, and from
//    the same shared memory K*floor(8/K) warps add x * dy into dw: a thread
//    owns (channel pair, tap row i) and keeps K pairs of accumulators in
//    registers while its block walks a fixed run of tiles (a (part, channel
//    slice) grid of about 512 blocks, ops/dw_conv.py::_DW_BLOCKS). At the end
//    the row groups of a tap row add in order through shared memory and each
//    block writes its partial [K*K, 64]; a second kernel adds the partials in
//    order. No atomics: two runs on the same input give the same bits. K9 is
//    two device kernels.
// Any C works, and any H and W, also at most P (the CPE's 7x7 on a 2x2 map).
// Offsets are 32-bit: the caller refuses tensors of 2^31 elements or more.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdw_conv.so dw_conv.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileC = 64;     // channels of a block: 32 lanes x a pair
constexpr int kStrip = 8;      // outputs along W of a thread's strip

// A channel pair as shared memory holds it, and its widening to fp32.
template <typename T> struct Pair;
template <> struct Pair<float> {
  using Word = float2;
  static __device__ __forceinline__ float2 get(float2 v) { return v; }
  static __device__ __forceinline__ void put(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
  static __device__ __forceinline__ void put1(float* p, float a) { *p = a; }
};
template <> struct Pair<__nv_bfloat16> {
  using Word = uint32_t;  // the lower channel in the low half
  static __device__ __forceinline__ float2 get(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
  }
  static __device__ __forceinline__ void put(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
  static __device__ __forceinline__ void put1(__nv_bfloat16* p, float a) {
    *p = __float2bfloat16(a);
  }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The tile geometry of one launch.
struct Geo {
  int h, wd, c;    // image
  int th, tw;      // output tile
  int tiles_h, tiles_w;
};

// Stage rows x cols pixels x 64 channels of one image `img`, whose pixel
// (r0, c0) lands at dst[0], channels [ch0, ch0 + 64); zero outside the image
// and past C. WIDE: 16-byte cp.async (C a multiple of 16 bytes' elements and
// `img` 16-byte aligned); else element by element. Not waited for.
template <typename T, bool WIDE>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ img, int r0, int c0,
                                      int rows, int cols, int ch0, const Geo& g) {
  if constexpr (WIDE) {
    constexpr int kVec = 16 / sizeof(T);
    constexpr int kChunks = kTileC / kVec;  // 8 bf16, 16 fp32: a power of two
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    const int n = rows * cols * kChunks;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int pix = idx / kChunks, e = (idx % kChunks) * kVec;
      const int rr = pix / cols, gr = r0 + rr, gc = c0 + pix - rr * cols;
      const bool in = gr >= 0 && gr < g.h && gc >= 0 && gc < g.wd && ch0 + e < g.c;
      const T* src = in ? img + (gr * g.wd + gc) * g.c + ch0 + e : img;
      cp_async16(base + (pix * kTileC + e) * sizeof(T), src, in ? 16 : 0);
    }
  } else {
    const int n = rows * cols * kTileC;
    for (int idx = threadIdx.x; idx < n; idx += kThreads) {
      const int pix = idx / kTileC, e = idx % kTileC;
      const int rr = pix / cols, gr = r0 + rr, gc = c0 + pix - rr * cols;
      const bool in = gr >= 0 && gr < g.h && gc >= 0 && gc < g.wd && ch0 + e < g.c;
      dst[idx] = in ? img[(gr * g.wd + gc) * g.c + ch0 + e] : T(0.f);
    }
  }
}

// The [K*K, 64] fp32 slice of the weight table for channels [ch0, ch0+64).
template <int K>
__device__ __forceinline__ void stage_weights(float* dst, const float* __restrict__ w,
                                              int ch0, int c) {
  for (int idx = threadIdx.x; idx < K * K * kTileC; idx += kThreads) {
    const int t = idx / kTileC, e = idx % kTileC;
    dst[idx] = ch0 + e < c ? __ldg(w + t * c + ch0 + e) : 0.f;
  }
}

// y (FLIP = false) or dx (FLIP = true, src = dy) of one tile, whose staged
// input `tile` [(TH+K-1), (TW+K-1), 64] starts at pixel (p0 - P, q0 - P);
// `out` is the image's output. Every warp takes (row, strip) items in turn.
template <typename T, int K, bool FLIP, bool WIDE>
__device__ __forceinline__ void stencil_tile(const typename Pair<T>::Word* tile,
                                             const float2* wsm, T* __restrict__ out,
                                             int p0, int q0, int ch0, const Geo& g) {
  using W = typename Pair<T>::Word;
  constexpr int kWin = kStrip + K - 1;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ns = g.tw / kStrip, tcols = g.tw + K - 1;
  const int ch = ch0 + 2 * lane;
  for (int it = warp; it < g.th * ns; it += kWarps) {
    const int r = it / ns, s = it - r * ns;
    float ax[kStrip], ay[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) ax[o] = ay[o] = 0.f;
#pragma unroll 1  // one row's window live at a time: unrolled, K = 7 spilled
    for (int i = 0; i < K; ++i) {
      const W* row = tile + ((FLIP ? r + K - 1 - i : r + i) * tcols + s * kStrip) * 32 + lane;
      float2 win[kWin], wt[K];
#pragma unroll
      for (int u = 0; u < kWin; ++u) win[u] = Pair<T>::get(row[u * 32]);
#pragma unroll
      for (int j = 0; j < K; ++j) wt[j] = wsm[(i * K + j) * 32 + lane];
#pragma unroll
      for (int j = 0; j < K; ++j) {
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          const float2 v = win[FLIP ? o + K - 1 - j : o + j];
          ax[o] = __fadd_rn(ax[o], __fmul_rn(v.x, wt[j].x));
          ay[o] = __fadd_rn(ay[o], __fmul_rn(v.y, wt[j].y));
        }
      }
    }
    const int p = p0 + r;
    if (p >= g.h) continue;
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      const int q = q0 + s * kStrip + o;
      if (q >= g.wd) break;
      T* dst = out + (p * g.wd + q) * g.c + ch;
      if constexpr (WIDE) {  // C even: the pair is whole or past C
        if (ch < g.c) Pair<T>::put(dst, ax[o], ay[o]);
      } else {
        if (ch < g.c) Pair<T>::put1(dst, ax[o]);
        if (ch + 1 < g.c) Pair<T>::put1(dst + 1, ay[o]);
      }
    }
  }
}

// Tile t of the launch: image, first output row and column.
__device__ __forceinline__ void tile_origin(int t, const Geo& g, int& bi, int& p0, int& q0) {
  const int per_image = g.tiles_h * g.tiles_w;
  bi = t / per_image;
  const int rest = t - bi * per_image;
  const int ty = rest / g.tiles_w;
  p0 = ty * g.th;
  q0 = (rest - ty * g.tiles_w) * g.tw;
}

// Shared memory: the weight slice, then the staged input (K8) or dy with its
// halo and x (K9), or K9's row-group sums; the caller's plan sizes it
// (ops/dw_conv.py::smem_bytes).
template <int K>
constexpr int kWeightBytes = K * K * kTileC * 4;
// K9's warps of one dw tap row: K * kDwGroups<K> warps add into dw
template <int K>
constexpr int kDwGroups = kWarps / K > 0 ? kWarps / K : 1;

// K8: block (tile, channel slice).
template <typename T, int K, bool WIDE>
__global__ void __launch_bounds__(kThreads, 3)
dw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
              Geo g) {
  using W = typename Pair<T>::Word;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  T* tile = reinterpret_cast<T*>(smem + kWeightBytes<K>);
  const int ch0 = blockIdx.y * kTileC;
  int bi, p0, q0;
  tile_origin(blockIdx.x, g, bi, p0, q0);
  const int img = bi * g.h * g.wd * g.c;
  stage<T, WIDE>(tile, x + img, p0 - P, q0 - P, g.th + K - 1, g.tw + K - 1, ch0, g);
  stage_weights<K>(wsm, w, ch0, g.c);
  if constexpr (WIDE) cp_async_wait_all();
  __syncthreads();
  stencil_tile<T, K, false, WIDE>(reinterpret_cast<const W*>(tile),
                                  reinterpret_cast<const float2*>(wsm), y + img, p0, q0, ch0, g);
}

// K9's pass: block (part, channel slice) walks tiles [part * per_part, ...):
// for each, dx by the flipped stencil and x * dy into the dw registers; then
// its partial[part, t, 64 channels].
template <typename T, int K, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
dw_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w, const T* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ partial, Geo g, int tiles,
              int per_part) {
  using W = typename Pair<T>::Word;
  constexpr int P = K / 2;
  extern __shared__ __align__(16) unsigned char smem[];
  float* wsm = reinterpret_cast<float*>(smem);
  T* dy_s = reinterpret_cast<T*>(smem + kWeightBytes<K>);
  const int dy_elems = (g.th + K - 1) * (g.tw + K - 1) * kTileC;
  T* x_s = dy_s + dy_elems;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ch0 = blockIdx.y * kTileC;
  const int ti = warp % K, grp = warp / K;  // the dw row: tap row ti, group grp
  const bool dw_warp = warp < K * kDwGroups<K>;
  const int ns = g.tw / kStrip, tcols = g.tw + K - 1;
  float2 acc[K];
#pragma unroll
  for (int j = 0; j < K; ++j) acc[j] = make_float2(0.f, 0.f);

  stage_weights<K>(wsm, w, ch0, g.c);
  const int t0 = blockIdx.x * per_part, t1 = min(tiles, t0 + per_part);
  for (int t = t0; t < t1; ++t) {
    int bi, p0, q0;
    tile_origin(t, g, bi, p0, q0);
    const int img = bi * g.h * g.wd * g.c;
    stage<T, WIDE>(dy_s, dy + img, p0 - P, q0 - P, g.th + K - 1, g.tw + K - 1, ch0, g);
    stage<T, WIDE>(x_s, x + img, p0, q0, g.th, g.tw, ch0, g);
    if constexpr (WIDE) cp_async_wait_all();
    __syncthreads();
    stencil_tile<T, K, true, WIDE>(reinterpret_cast<const W*>(dy_s),
                                   reinterpret_cast<const float2*>(wsm), dx + img, p0, q0, ch0,
                                   g);
    if (dw_warp) {
      const W* xs = reinterpret_cast<const W*>(x_s);
      const W* ds = reinterpret_cast<const W*>(dy_s);
      for (int it = grp; it < g.th * ns; it += kDwGroups<K>) {
        const int a = it / ns, s = it - a * ns;
        const W* xrow = xs + (a * g.tw + s * kStrip) * 32 + lane;
        const W* drow = ds + ((a + K - 1 - ti) * tcols + s * kStrip) * 32 + lane;
        float2 xv[kStrip], dv[kStrip + K - 1];
#pragma unroll
        for (int o = 0; o < kStrip; ++o) xv[o] = Pair<T>::get(xrow[o * 32]);
#pragma unroll
        for (int u = 0; u < kStrip + K - 1; ++u) dv[u] = Pair<T>::get(drow[u * 32]);
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            acc[j].x = fmaf(xv[o].x, dv[o + K - 1 - j].x, acc[j].x);
            acc[j].y = fmaf(xv[o].y, dv[o + K - 1 - j].y, acc[j].y);
          }
        }
      }
    }
    __syncthreads();  // the next tile's copies overwrite dy_s and x_s
  }
  // the row groups of each tap row added in order, then one partial per block
  float2* red = reinterpret_cast<float2*>(dy_s);  // [kDwGroups<K> - 1][K][K][32]
  if (dw_warp && grp > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) red[(((grp - 1) * K + ti) * K + j) * 32 + lane] = acc[j];
  }
  __syncthreads();
  if (!dw_warp || grp > 0) return;
  for (int gi = 1; gi < kDwGroups<K>; ++gi) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float2 v = red[(((gi - 1) * K + ti) * K + j) * 32 + lane];
      acc[j].x += v.x;
      acc[j].y += v.y;
    }
  }
  const int ch = ch0 + 2 * lane;
  float* dst = partial + (blockIdx.x * K * K + ti * K) * g.c + ch;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (ch < g.c) dst[j * g.c] = acc[j].x;
    if (ch + 1 < g.c) dst[j * g.c + 1] = acc[j].y;
  }
}

// K9's second kernel: dw[t, c] = sum over parts, in order.
__global__ void __launch_bounds__(kThreads)
dw_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw, int parts,
                    int n) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int part = 0; part < parts; ++part) s += partial[part * n + idx];
  dw[idx] = s;
}

Geo make_geo(int h, int wd, int c, int th, int tw) {
  return Geo{h, wd, c, th, tw, (h + th - 1) / th, (wd + tw - 1) / tw};
}

bool bad_tile(int th, int tw) { return th < 1 || tw < kStrip || tw % kStrip != 0; }

// The launches as the caller's plan (ops/dw_conv.py::plan) cuts them:
// `tiles` tiles per channel slice, `bytes` of dynamic shared memory a block.
template <typename T, int K, bool WIDE>
int launch_fwd(const void* x, const float* w, void* y, const Geo& g, int tiles, int bytes,
               cudaStream_t s) {
  auto kernel = dw_fwd_kernel<T, K, WIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(tiles, (g.c + kTileC - 1) / kTileC);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(x), w, static_cast<T*>(y), g);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K, bool WIDE>
int launch_bwd(const void* x, const float* w, const void* dy, void* dx, float* partial,
               float* dw, const Geo& g, int tiles, int parts, int per_part, int bytes,
               cudaStream_t s) {
  auto kernel = dw_bwd_kernel<T, K, WIDE>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(parts, (g.c + kTileC - 1) / kTileC);
  kernel<<<grid, kThreads, bytes, s>>>(static_cast<const T*>(x), w, static_cast<const T*>(dy),
                                       static_cast<T*>(dx), partial, g, tiles, per_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * K * g.c;
  dw_wgrad_sum_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, s>>>(partial, dw, parts, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MRCLIP_DISPATCH_T(CALL, K)                                                   \
  if (is_bf16) return wide ? CALL(__nv_bfloat16, K, true) : CALL(__nv_bfloat16, K, false); \
  return wide ? CALL(float, K, true) : CALL(float, K, false);

#define MRCLIP_DISPATCH(CALL)                                 \
  switch (k) {                                                \
    case 3: { MRCLIP_DISPATCH_T(CALL, 3) }                    \
    case 5: { MRCLIP_DISPATCH_T(CALL, 5) }                    \
    case 7: { MRCLIP_DISPATCH_T(CALL, 7) }                    \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

// K8. Returns the cudaError_t of the launch (0 = success). x and y
// [b, h, wd, c] contiguous in the input type (bf16 if is_bf16, else fp32),
// w [k*k, c] fp32 contiguous; k in {3, 5, 7} (checked by the caller). The
// caller's plan gives the output tile th x tw (tw a multiple of 8), wide
// (16-byte copies: c a multiple of 16 bytes' elements, x and y 16-byte
// aligned), the tiles per channel slice (b x ceil(h/th) x ceil(wd/tw)) and
// the block's shared memory in bytes.
extern "C" int dw_conv_fwd(const void* x, const void* w, void* y, int h, int wd, int c, int k,
                           int is_bf16, int th, int tw, int wide, int tiles, int smem,
                           void* stream) {
  if (bad_tile(th, tw) || tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const Geo g = make_geo(h, wd, c, th, tw);
#define MRCLIP_FWD(T, K, WIDE) launch_fwd<T, K, WIDE>(x, wf, y, g, tiles, smem, s)
  MRCLIP_DISPATCH(MRCLIP_FWD)
#undef MRCLIP_FWD
}

// K9. Returns the cudaError_t of its two launches. x, dy, dx [b, h, wd, c]
// contiguous in the input type; w [k*k, c] fp32; partial an fp32
// [parts, k*k, c] scratch; dw [k*k, c] fp32; th, tw, wide, tiles and smem
// as K8's (wide also asks dy and dx 16-byte aligned); parts blocks per
// channel slice walk per_part tiles each (the last maybe fewer).
extern "C" int dw_conv_bwd(const void* x, const void* w, const void* dy, void* dx,
                           void* partial, void* dw, int h, int wd, int c, int k, int is_bf16,
                           int th, int tw, int wide, int tiles, int parts, int per_part,
                           int smem, void* stream) {
  if (bad_tile(th, tw) || tiles < 1 || parts < 1 || per_part < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
  const Geo g = make_geo(h, wd, c, th, tw);
#define MRCLIP_BWD(T, K, WIDE) \
  launch_bwd<T, K, WIDE>(x, wf, dy, dx, pf, dwf, g, tiles, parts, per_part, smem, s)
  MRCLIP_DISPATCH(MRCLIP_BWD)
#undef MRCLIP_BWD
}

#undef MRCLIP_DISPATCH
#undef MRCLIP_DISPATCH_T
