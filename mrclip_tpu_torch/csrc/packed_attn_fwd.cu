// Packed fused-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel
// (batched-head mode, driven by _pfwd_impl), both of its branches:
//   K1, packed_attn_fwd:      rope=False;
//   K2, packed_attn_rope_fwd: rope=True, the EVA02 towers' axial 2D rope
//       applied inside the kernel (the rope branch, fused_attn.py:330-343).
// Per (sample, head):
//
//   o   = softmax(q k^T / sqrt(D)  [+ causal mask: key j > query i]) v
//   lse = log(sum_j exp(s_ij))     (fp32; the backward recomputes P from it)
//
// K2 first rotates q and k by the [N, 2D] sin||cos table (row i holds the
// sin of query/key position i in columns [0, D) and its cos in [D, 2D), in
// the input type; identity rows sin 0 / cos 1 over the CLS prefix):
//
//   x_r = round_T(x * cos + rot(x) * sin),  rot(x)[2i] = -x[2i+1],
//                                           rot(x)[2i+1] = x[2i]
//
// in fp32 with each product and sum rounded once (no FMA contraction), then
// rounded once to the input type T, as the TPU's _rope_rotate casts back to
// x.dtype before the score product (rope.cuh's rotate_pair_f32, in both
// kernels below). The TPU did the pair swap as a 0/+-1 matmul (_rot_matrix)
// to avoid lane shuffles; here both members of a pair sit in one thread, so
// it is a register swap. The rotated tensors never reach device memory. K2
// takes self-attention only (Nk = N).
//
// q, k and v arrive in the natural packed layout [B, N, H*D] that the in_proj
// produces, with a batch stride and a row stride each, so they can be the
// three column slices of one [B, N, 3*H*D] tensor without copies. o is
// written contiguous [B, N, H*D] in the input type, lse contiguous [B, H, N].
//
// Two kernels, chosen by type:
//   bf16: attn_mma_fwd.cuh's tensor-core forward that K4 runs (K1 is the
//     same instantiation, with the packed strides): wgmma_fwd_kernel, on
//     Hopper's wgmma, at D = 64 with at most 256 keys, wgmma_wide_fwd_kernel
//     at D = 72-112 up to 272 keys and at D = 64 from 257 to 272 (every
//     main-path shape of K1 and K2), mma_fwd_kernel otherwise; K2 sets the
//     ROPE flag of wgmma_fwd_kernel or mma_fwd_kernel: each rotates the
//     staged K rows once per (sample, head) and each staged Q sub-tile in
//     shared memory.
//     Its 16-byte copies need the views' base pointers and batch and row
//     strides to be multiples of 16 bytes, which the wrapper checks;
//   fp32: packed_attn_fwd_kernel below, on the FMA pipes (TF32 products
//     would miss the fp32 bar of 1e-4), which takes any element-aligned
//     strides: the thread's q row rotates at load, each K row while it is
//     staged into shared memory.
//
// Bound on an H100 SXM: memory. For one ViT-B/16 image (N=197, H=12, D=64,
// bf16) the function must read q, k, v (0.91 MB) and write o (0.30 MB) and
// lse (9.5 KB): 1.21 MB, against 4*N*N*D*H = 119 MFLOP. That is about 98
// FLOP/byte, under the card's ~295 bf16 FLOP/byte ridge, so the least time is
// the bytes over 3.35 TB/s: about 0.36 us per sample. K2 adds the table
// (N * 2D elements, read once per call) and 6 operations per rotated
// element of q and k, about 1% of the score and output products at D = 64.
//
// What the design does about it: in both kernels the N x N scores live only
// in registers (online max and sum-exp in fp32), q is read once, o and lse
// are written once. The bf16 kernel runs both products on the tensor cores
// and reads K and V once per (sample, head) (attn_mma_fwd.cuh says how).
// The fp32 kernel stages each K/V tile once per 64-row query tile through
// shared memory (repeat reads of K/V across the few query tiles of a head
// hit L2) and runs both products on the fp32 FMA pipes, one thread per
// query row, so it is limited by their issue rate (67 TFLOP/s peak), not by
// the bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpacked_attn_fwd.so packed_attn_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_mma_fwd.cuh"  // launch_mma_fwd, Strides (bf16 on the tensor cores)
#include "rope.cuh"          // load_f, store_f, round_to, rotate_pair

namespace {

constexpr int kRows = 64;  // query rows per block, one thread each (fp32)
constexpr int kChunk = 8;  // keys scored together per online-softmax update

// The fp32 forward (bf16 runs attn_mma_fwd.cuh's kernels), any D that is a
// multiple of 4; K/V tiles of kKeys keys (attn_tile.cuh's kStage<D>: 64 up
// to D = 80, 32 past it, so the two tiles stay under 48 KB). A thread keeps
// its q and o rows in registers: at 255 registers D = 104 spills 8 bytes and
// D = 112 36 (sm_90a, -Xptxas -v).
template <int D, bool ROPE>
__global__ void __launch_bounds__(kRows)
    packed_attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, const float* __restrict__ tab,
                           float* __restrict__ o, float* __restrict__ lse, int n,
                           int nk, int heads,
                           long long q_bs, long long q_rs, long long k_bs,
                           long long k_rs, long long v_bs, long long v_rs,
                           float scale, int causal) {
  constexpr int kKeys = kStage<D>;
  __shared__ __align__(16) float ks[kKeys][D];
  __shared__ __align__(16) float vs[kKeys][D];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int row = tile * kRows + threadIdx.x;
  const bool live = row < n;

  float qr[D];
  float acc[D];
  const float* qp = q + b * q_bs + (long long)row * q_rs + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? load_f(qp + d) : 0.f;
    acc[d] = 0.f;
  }
  if constexpr (ROPE) {
    if (live) {
      const float* t = tab + (long long)row * (2 * D);
#pragma unroll
      for (int d = 0; d < D; d += 2) rotate_pair<float, D>(qr[d], qr[d + 1], t, d);
    }
  }

  float m = -INFINITY;  // running row max of the scaled scores
  float l = 0.f;        // running sum of exp(s - m)
  // In a causal tile every key past the tile's last row is masked for all
  // of its rows, so the walk stops there.
  const int kv_end = causal ? min(nk, (tile + 1) * kRows) : nk;
  const float* kb = k + b * k_bs + h * D;
  const float* vb = v + b * v_bs + h * D;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    const int len = min(kKeys, kv_end - k0);
    __syncthreads();  // every thread is done with the previous tile
    if constexpr (ROPE) {  // one (key, pair) per step: k rotates on the way in
      for (int i = threadIdx.x; i < len * (D / 2); i += kRows) {
        const int j = i / (D / 2);
        const int d = 2 * (i % (D / 2));
        const float* kr = kb + (long long)(k0 + j) * k_rs + d;
        const float* vr = vb + (long long)(k0 + j) * v_rs + d;
        float k_0 = load_f(kr), k_1 = load_f(kr + 1);
        rotate_pair<float, D>(k_0, k_1, tab + (long long)(k0 + j) * (2 * D), d);
        ks[j][d] = k_0;
        ks[j][d + 1] = k_1;
        vs[j][d] = load_f(vr);
        vs[j][d + 1] = load_f(vr + 1);
      }
    } else {
      for (int i = threadIdx.x; i < len * D; i += kRows) {
        const int j = i / D;
        const int d = i % D;
        ks[j][d] = load_f(kb + (long long)(k0 + j) * k_rs + d);
        vs[j][d] = load_f(vb + (long long)(k0 + j) * v_rs + d);
      }
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
  float* op = o + (b * n + row) * (long long)(heads * D) + h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) store_f(op + d, acc[d] * inv);
  lse[(b * heads + h) * n + row] = m + logf(l);
}

template <int D, bool ROPE>
int launch(const void* q, const void* k, const void* v, const void* tab,
           void* o, float* lse, int batch, int n, int nk, int heads,
           long long q_bs, long long q_rs, long long k_bs, long long k_rs,
           long long v_bs, long long v_rs, float scale, int causal,
           cudaStream_t stream) {
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  packed_attn_fwd_kernel<D, ROPE><<<grid, kRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(tab),
      static_cast<float*>(o), lse, n, nk, heads, q_bs, q_rs, k_bs, k_rs, v_bs,
      v_rs, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Both entry points, by type and head dim (64 | 32, and for K1 72 | 80 | 88 |
// 104 | 112): bf16 on the tensor cores, one key block of all nk keys (K4's form:
// o [B, N, H*D] contiguous, lse [B, H, N] at (b * heads + h) * n + row),
// fp32 on the FMA kernel.
template <bool ROPE>
int dispatch(const void* q, const void* k, const void* v, const void* tab,
             void* o, void* lse, int is_bf16, int batch, int n, int nk,
             int heads, int head_dim, long long q_bs, long long q_rs,
             long long k_bs, long long k_rs, long long v_bs, long long v_rs,
             float scale, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const long long o_rs = (long long)heads * head_dim;
  const Strides st{q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, n * o_rs, o_rs};
#define MRCLIP_LAUNCH_MMA(D)                                                   \
  return launch_mma_fwd<D, false, false, ROPE>(q, k, v, tab, o, l, nullptr,   \
                                               batch, n, nk, heads, st, scale, \
                                               causal, 1, nk, 1, s)
#define MRCLIP_LAUNCH(D)                                                 \
  return launch<D, ROPE>(q, k, v, tab, o, l, batch, n, nk, heads, q_bs, \
                         q_rs, k_bs, k_rs, v_bs, v_rs, scale, causal, s)
  if (head_dim == 64) {
    if (is_bf16) MRCLIP_LAUNCH_MMA(64);
    MRCLIP_LAUNCH(64);
  }
  if (head_dim == 32) {
    if (is_bf16) MRCLIP_LAUNCH_MMA(32);
    MRCLIP_LAUNCH(32);
  }
  if constexpr (!ROPE) {  // the rope tables are D = 32 and 64 only
    if (head_dim == 72) {
      if (is_bf16) MRCLIP_LAUNCH_MMA(72);
      MRCLIP_LAUNCH(72);
    }
    if (head_dim == 80) {
      if (is_bf16) MRCLIP_LAUNCH_MMA(80);
      MRCLIP_LAUNCH(80);
    }
    if (head_dim == 88) {
      if (is_bf16) MRCLIP_LAUNCH_MMA(88);
      MRCLIP_LAUNCH(88);
    }
    if (head_dim == 104) {
      if (is_bf16) MRCLIP_LAUNCH_MMA(104);
      MRCLIP_LAUNCH(104);
    }
    if (head_dim == 112) {
      if (is_bf16) MRCLIP_LAUNCH_MMA(112);
      MRCLIP_LAUNCH(112);
    }
  }
#undef MRCLIP_LAUNCH_MMA
#undef MRCLIP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). The caller has
// checked shapes, strides, types and devices; element strides are 1, and in
// bf16 the base pointers and batch and row strides are multiples of 16
// bytes.
extern "C" int packed_attn_fwd(const void* q, const void* k, const void* v,
                               void* o, void* lse, int is_bf16, int batch,
                               int n, int nk, int heads, int head_dim,
                               long long q_bs, long long q_rs, long long k_bs,
                               long long k_rs, long long v_bs, long long v_rs,
                               float scale, int causal, void* stream) {
  return dispatch<false>(q, k, v, nullptr, o, lse, is_bf16, batch, n, nk,
                         heads, head_dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs,
                         scale, causal, stream);
}

// K2: as packed_attn_fwd with q and k rotated by `tab` ([N, 2*head_dim]
// sin||cos, contiguous, the input type) inside the kernel; self-attention,
// so k and v have n rows.
extern "C" int packed_attn_rope_fwd(const void* q, const void* k,
                                    const void* v, const void* tab, void* o,
                                    void* lse, int is_bf16, int batch, int n,
                                    int heads, int head_dim, long long q_bs,
                                    long long q_rs, long long k_bs,
                                    long long k_rs, long long v_bs,
                                    long long v_rs, float scale, int causal,
                                    void* stream) {
  return dispatch<true>(q, k, v, tab, o, lse, is_bf16, batch, n, n, heads,
                        head_dim, q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, scale,
                        causal, stream);
}
