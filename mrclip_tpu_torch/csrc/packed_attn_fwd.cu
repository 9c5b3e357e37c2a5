// Packed fused-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel
// (batched-head mode, rope=False, driven by _pfwd_impl). Per (sample, head):
//
//   o   = softmax(q k^T / sqrt(D)  [+ causal mask: key j > query i]) v
//   lse = log(sum_j exp(s_ij))     (fp32; the backward recomputes P from it)
//
// q, k and v arrive in the natural packed layout [B, N, H*D] that the in_proj
// produces, with a batch stride and a row stride each, so they can be the
// three column slices of one [B, N, 3*H*D] tensor without copies. o is
// written contiguous [B, N, H*D] in the input type, lse contiguous [B, H, N].
//
// Bound on an H100 SXM: memory. For one ViT-B/16 image (N=197, H=12, D=64,
// bf16) the function must read q, k, v (0.91 MB) and write o (0.30 MB) and
// lse (9.5 KB): 1.21 MB, against 4*N*N*D*H = 119 MFLOP. That is about 98
// FLOP/byte, under the card's ~295 bf16 FLOP/byte ridge, so the least time is
// the bytes over 3.35 TB/s: about 0.36 us per sample.
//
// What the design does about it: the N x N scores live only in registers
// (online max and sum-exp in fp32), q is read once, o and lse are written
// once, and each K/V tile is staged once per 64-row query tile through shared
// memory (repeat reads of K/V across the few query tiles of a head hit L2).
// This first version runs both products on the fp32 FMA pipes, one thread per
// query row, so it is limited by their issue rate (67 TFLOP/s peak: at best
// ~1.8 us per sample on the shape above), not by the bytes. Moving the two
// products onto the tensor cores (mma.sync / wgmma) is the step that brings
// it to the memory bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpacked_attn_fwd.so packed_attn_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;  // query rows per block, one thread each
constexpr int kKeys = 64;  // keys per shared-memory K/V tile
constexpr int kChunk = 8;  // keys scored together per online-softmax update

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    packed_attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           float* __restrict__ lse, int n, int nk, int heads,
                           long long q_bs, long long q_rs, long long k_bs,
                           long long k_rs, long long v_bs, long long v_rs,
                           float scale, int causal) {
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row = tile * kRows + threadIdx.x;
  const bool live = row < n;

  float qr[D];
  float acc[D];
  const T* qp = q + b * q_bs + (long long)row * q_rs + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? load_f(qp + d) : 0.f;
    acc[d] = 0.f;
  }

  float m = -INFINITY;  // running row max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)
  // In a causal tile every key past the tile's last row is masked for all
  // of its rows, so the walk stops there.
  const int kv_end = causal ? min(nk, (tile + 1) * kRows) : nk;
  const T* kb = k + b * k_bs + h * D;
  const T* vb = v + b * v_bs + h * D;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    const int len = min(kKeys, kv_end - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = threadIdx.x; i < len * D; i += kRows) {
      const int j = i / D;
      const int d = i % D;
      ks[j][d] = load_f(kb + (long long)(k0 + j) * k_rs + d);
      vs[j][d] = load_f(vb + (long long)(k0 + j) * v_rs + d);
    }
    __syncthreads();

    for (int j0 = 0; j0 < len; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int j = j0 + c;
        float x = -INFINITY;  // kv tail and causal mask: weight exactly 0
        if (j < len && !(causal && k0 + j > row)) {
          const float4* kr = reinterpret_cast<const float4*>(ks[j]);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4 + 0], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
          x = dot * scale;
        }
        s[c] = x;
        cmax = fmaxf(cmax, x);
      }
      const float m_new = fmaxf(m, cmax);
      if (m_new == -INFINITY) continue;  // no attendable key seen yet
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (j0 + c < len) {  // rows past the tile hold stale data
          const float p = expf(s[c] - m_new);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(vs[j0 + c]);
#pragma unroll
          for (int d4 = 0; d4 < D / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4 + 0] = fmaf(p, vv.x, acc[4 * d4 + 0]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = m_new;
    }
  }

  if (!live) return;
  const float inv = 1.f / l;
  T* op = o + (b * n + row) * (long long)(heads * D) + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store_f(op + d, acc[d] * inv);
  lse[(b * heads + h) * n + row] = m + logf(l);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int batch, int n, int nk, int heads, long long q_bs, long long q_rs,
           long long k_bs, long long k_rs, long long v_bs, long long v_rs,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  packed_attn_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, n, nk, heads, q_bs,
      q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). The caller has
// checked shapes, strides, types and devices; element strides are 1.
extern "C" int packed_attn_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int is_bf16, int batch,
                               int n, int nk, int heads, int head_dim,
                               long long q_bs, long long q_rs, long long k_bs,
                               long long k_rs, long long v_bs, long long v_rs,
                               float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MRCLIP_LAUNCH(T, D)                                                  \
  return launch<T, D>(q, k, v, o, l, batch, n, nk, heads, q_bs, q_rs, k_bs, \
                      k_rs, v_bs, v_rs, scale, causal, s)
  if (head_dim == 64) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 64);
    MRCLIP_LAUNCH(float, 64);
  }
  if (head_dim == 32) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 32);
    MRCLIP_LAUNCH(float, 32);
  }
#undef MRCLIP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
