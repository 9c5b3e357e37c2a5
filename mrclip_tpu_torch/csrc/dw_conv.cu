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
// added (__fmul_rn / __fadd_rn, no FMA contraction), and round once to the
// input type T: bit-identical to the plain versions in
// mrclip_tpu_torch/ops/dw_conv.py. dy arrives already rounded to T.
//
// The TPU kernels hold one whole image per program in VMEM and carry dw
// across the sequential grid in a revisited block. Here blocks run in no
// order, so:
//  * K8 and K9's dx pass compute one output element per thread, the channel
//    index fastest, so a warp's loads of an NHWC row are one contiguous
//    span; the K^2 neighbours come through L1 and the weight table stays in
//    L1/L2 (49 x C x 4 bytes at most 125 KB);
//  * K9's dw is a deterministic two-pass reduction, as K3's: blocks of 32
//    channels x 8 thread rows each sum the products over a fixed range of
//    image rows into their own partial [K*K, C] (fp32 FMA, every tap in a
//    register, then the 8 thread rows added in order through shared
//    memory), and a second pass adds the partials in order. No atomics:
//    two runs on the same input give the same bits.
// Any C works (lanes past C idle), and any H and W, also at most P (a tap
// that reaches no output is skipped, as SAME padding has it). Offsets are
// 32-bit: the caller refuses tensors of 2^31 elements or more.
//
// Bound on an H100 SXM, MobileCLIP-S1 stage 0 at b256 (x [256, 64, 64, 64]
// bf16, 67.1M elements): K8 reads x and writes y once (268 MB, 80 us at
// 3.35 TB/s) and does K^2 multiply-adds per element (K = 7: 6.58 GFLOP, 98
// us at 67 TFLOP/s fp32), bytes-bound at K = 3 and operations-bound at
// K = 7. K9 reads x and dy, writes dx (403 MB, 120 us) and does 2 K^2
// multiply-adds per element (K = 7: 196 us). This version issues one load
// per tap of x (K^2 per element, served by L1) and a separate multiply and
// add where the bound counts one FMA, so it sits above those bounds; a
// shared-memory tile with its halo and a register window sliding along the
// row are the next steps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libdw_conv.so dw_conv.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rope.cuh"  // load_f, store_f

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;    // channels of a dw block
constexpr int kRowsY = 8;     // thread rows of a dw block

// K8 (FLIP = false) and K9's dx pass (FLIP = true, `src` = dy): one output
// element per thread.
template <typename T, int K, bool FLIP>
__global__ void __launch_bounds__(kThreads)
dw_stencil_kernel(const T* __restrict__ src, const float* __restrict__ w,
                  T* __restrict__ out, int h, int wd, int c, int total) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  constexpr int P = K / 2;
  const int ch = idx % c;
  int rest = idx / c;
  const int q = rest % wd;
  rest /= wd;
  const int p = rest % h;
  const T* img = src + (rest - p) * wd * c + ch;  // (rest - p) = b * h
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int r = FLIP ? p - i + P : p + i - P;
    if (r < 0 || r >= h) continue;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int s = FLIP ? q - j + P : q + j - P;
      if (s < 0 || s >= wd) continue;
      const float v = load_f(img + (r * wd + s) * c);
      acc = __fadd_rn(acc, __fmul_rn(v, __ldg(w + (i * K + j) * c + ch)));
    }
  }
  store_f(out + idx, acc);
}

// K9's first dw pass: block (channel tile, part) sums x shifted * dy over
// the image rows [part * rows_per_part, ...) into partial[part, t, c].
template <typename T, int K>
__global__ void __launch_bounds__(kLanes * kRowsY)
dw_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        float* __restrict__ partial, int rows, int h, int wd,
                        int c, int rows_per_part) {
  constexpr int P = K / 2;
  __shared__ float red[kRowsY][kLanes];
  const int ch = blockIdx.x * kLanes + threadIdx.x;
  const int r0 = blockIdx.y * rows_per_part;
  const int r1 = min(rows, r0 + rows_per_part);
  float acc[K * K];
#pragma unroll
  for (int t = 0; t < K * K; ++t) acc[t] = 0.f;
  if (ch < c && r1 > r0) {
    const int npos = (r1 - r0) * wd;
    for (int e = threadIdx.y; e < npos; e += kRowsY) {
      const int row = r0 + e / wd;  // row = b * h + p
      const int q = e % wd;
      const int p = row % h;
      const float g = load_f(dy + (row * wd + q) * c + ch);
      const T* img = x + (row - p) * wd * c + ch;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const int r = p + i - P;
        if (r < 0 || r >= h) continue;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const int s = q + j - P;
          if (s < 0 || s >= wd) continue;
          acc[i * K + j] = fmaf(load_f(img + (r * wd + s) * c), g, acc[i * K + j]);
        }
      }
    }
  }
  // the 8 thread rows of each channel added in order
#pragma unroll
  for (int t = 0; t < K * K; ++t) {
    red[threadIdx.y][threadIdx.x] = acc[t];
    __syncthreads();
    if (threadIdx.y == 0 && ch < c) {
      float s = 0.f;
#pragma unroll
      for (int y = 0; y < kRowsY; ++y) s += red[y][threadIdx.x];
      partial[(blockIdx.y * K * K + t) * c + ch] = s;
    }
    __syncthreads();
  }
}

// K9's second dw pass: dw[t, c] = sum over parts, in order.
__global__ void __launch_bounds__(kThreads)
dw_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                    int parts, int n) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int part = 0; part < parts; ++part) s += partial[part * n + idx];
  dw[idx] = s;
}

unsigned grid_for(int total) { return ((unsigned)total + kThreads - 1) / kThreads; }

template <typename T, int K>
int launch_fwd(const void* x, const float* w, void* y, int b, int h, int wd,
               int c, cudaStream_t s) {
  const int total = b * h * wd * c;
  dw_stencil_kernel<T, K, false><<<grid_for(total), kThreads, 0, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), h, wd, c, total);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int K>
int launch_bwd(const void* x, const float* w, const void* dy, void* dx,
               float* partial, float* dw, int b, int h, int wd, int c,
               int parts, cudaStream_t s) {
  const int total = b * h * wd * c;
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  dw_stencil_kernel<T, K, true><<<grid_for(total), kThreads, 0, s>>>(
      dyt, w, static_cast<T*>(dx), h, wd, c, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = b * h;
  const int rows_per_part = (rows + parts - 1) / parts;
  const dim3 grid((c + kLanes - 1) / kLanes, parts);
  dw_wgrad_partial_kernel<T, K><<<grid, dim3(kLanes, kRowsY), 0, s>>>(
      xt, dyt, partial, rows, h, wd, c, rows_per_part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n = K * K * c;
  dw_wgrad_sum_kernel<<<grid_for(n), kThreads, 0, s>>>(partial, dw, parts, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define MRCLIP_DISPATCH(CALL)                                 \
  switch (k) {                                                \
    case 3: return is_bf16 ? CALL(__nv_bfloat16, 3) : CALL(float, 3); \
    case 5: return is_bf16 ? CALL(__nv_bfloat16, 5) : CALL(float, 5); \
    case 7: return is_bf16 ? CALL(__nv_bfloat16, 7) : CALL(float, 7); \
    default: return static_cast<int>(cudaErrorInvalidValue);  \
  }

// K8. Returns the cudaError_t of the launch (0 = success). x and y
// [b, h, wd, c] contiguous in the input type (bf16 if is_bf16, else fp32),
// w [k*k, c] fp32 contiguous; k in {3, 5, 7} (checked by the caller).
extern "C" int dw_conv_fwd(const void* x, const void* w, void* y, int b, int h,
                           int wd, int c, int k, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
#define MRCLIP_FWD(T, K) launch_fwd<T, K>(x, wf, y, b, h, wd, c, s)
  MRCLIP_DISPATCH(MRCLIP_FWD)
#undef MRCLIP_FWD
}

// K9. Returns the cudaError_t of its three launches. x, dy, dx [b, h, wd, c]
// contiguous in the input type; w [k*k, c] fp32; partial an fp32
// [parts, k*k, c] scratch; dw [k*k, c] fp32.
extern "C" int dw_conv_bwd(const void* x, const void* w, const void* dy,
                           void* dx, void* partial, void* dw, int b, int h,
                           int wd, int c, int k, int parts, int is_bf16,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* pf = static_cast<float*>(partial);
  float* dwf = static_cast<float*>(dw);
#define MRCLIP_BWD(T, K) launch_bwd<T, K>(x, wf, dy, dx, pf, dwf, b, h, wd, c, parts, s)
  MRCLIP_DISPATCH(MRCLIP_BWD)
#undef MRCLIP_BWD
}

#undef MRCLIP_DISPATCH
