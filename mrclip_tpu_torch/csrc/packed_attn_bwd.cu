// Packed fused-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mrclip_tpu/ops/fused_attn.py::_packed_bwd_kernel
// (batched-head mode, delta taken in the kernel: the JAX package's default
// 'kernel' mode, driven by _pbwd_impl), both of its branches:
//   K3,  packed_attn_bwd:      rope=False;
//   K3r, packed_attn_rope_bwd: rope=True (fused_attn.py:418-428, 464-473),
//        the backward of K2 (packed_attn_rope_fwd).
// Per (sample, head), with P recomputed from the forward's fp32 log-sum-exp:
//
//   S  = q k^T * scale  [+ causal mask: key j > query i]
//   P  = exp(S - lse)                 (fp32)
//   dV = P^T dO                       (P cast to the input type first)
//   dP = dO V^T                       (fp32)
//   delta = rowsum(dO * O)            (fp32)
//   dS = P * (dP - delta) * scale     (cast to the input type)
//   dQ = dS K,  dK = dS^T Q           (fp32 sums, stored once in the input type)
//
// The rounding order is the TPU kernel's (fused_attn.py:444-463), so kernel
// and plain version differ by summation order only.
//
// K3r: q and k above are the rotated q_r = round_T(q * cos + rot(q) * sin)
// (and k_r), recomputed from the unrotated q and k the forward kept, with
// the [N, 2D] sin||cos table in the input type (see packed_attn_fwd.cu), as
// the TPU kernel re-rotates in VMEM; dQ and dK, summed in fp32 against the
// rotated operands, are un-rotated once before the store, in the TPU's order
// (_rope_unrotate_grad, fused_attn.py:244-251):
//
//   dx = g * cos - rot(round_T(g * sin))
//
// every product and sum rounded once in fp32. dV and delta (from the
// unrotated O and dO) are K3's.
//
// Layout: q, k, v, o and dO arrive as packed [B, N|Nk, H*D] views with a
// batch stride and a row stride each (the column slices of one in_proj
// output need no copy); dq, dk and dv leave the same way, so the caller may
// hand in the three column slices of one [B, N, 3*H*D] gradient buffer that
// the in_proj backward then reads whole. lse is [B, H, N] fp32; delta is an
// fp32 [B, H, N] scratch that the first pass writes and the second reads,
// at (b * heads + h) * n + row.
//
// Two kernel pairs, chosen by type:
//   bf16: attn_mma_bwd.cuh's mma_bwd_dq_kernel and mma_bwd_dkv_kernel, the
//     tensor-core backward that K5 runs (K3 is the same instantiation, with
//     the packed strides and heads = H; K3r sets its ROPE flag, which
//     rotates the staged operand in shared memory and the register operand
//     in registers, and un-rotates dQ and dK in the accumulator's
//     registers). Its 16-byte copies and 32-bit fragment loads and stores
//     need the views' base pointers and batch and row strides, and the
//     table's base pointer, to be multiples of 16 bytes, which the wrapper
//     checks;
//   fp32: the FMA kernels below (TF32 products would miss the fp32 bar of
//     1e-4), which take any element-aligned strides.
//
// The fp32 kernels: two passes, no atomics, deterministic.
//   pass A: one block per (64-query tile, head, sample) walks the key tiles,
//           takes delta from its rows of dO and O, and writes dQ and delta;
//   pass B: one block per (64-key tile, head, sample) walks the query tiles
//           and writes dK and dV.
// Both recompute S and dP. Four threads share a row (pass A) or a key
// (pass B); each owns the float4 groups g = sub + 4*y of the head dimension,
// so the four lanes read four neighbouring 16-byte words of a shared-memory
// row (no bank conflicts) and two shuffles finish each dot product. A causal
// tile skips the key (pass A) or query (pass B) tiles wholly above the
// diagonal; ragged edges are masked in the kernel. In K3r each lane owns
// whole float4 groups, so both members of every rotation pair sit in one
// lane: the rotation is a register swap, done on the lane's own row at load
// and on each staged row of the other operand.
//
// Bound on an H100 SXM, counted per attended (query, key) pair: 10*D
// operations (five products) and 8 tensors of B*H*N*D elements read or
// written. ViT-B/16 vision at b256 (N=197, H=12, D=64, bf16): 76.3 GFLOP,
// 0.077 ms at 989 TFLOP/s, against 620 MB, 0.185 ms at 3.35 TB/s: bound by
// bytes. attn_mma_bwd.cuh says how the bf16 kernels meet it (every product
// on the tensor cores, one operand pair read once into registers, the other
// staged once per (sample, head)). The fp32 kernels run every product on
// the FMA pipes (67 TFLOP/s) and recompute S and dP in both passes (14*D
// FMA-operations per pair), so they are limited by their issue rate and by
// shared-memory reads, far above the bound. K3r adds the table (N * 2D
// elements, read once per call) and a few operations per element of q, k,
// dq and dk, about 1% of the products at D = 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libpacked_attn_bwd.so packed_attn_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include "attn_mma_bwd.cuh"  // launch_mma_bwd (bf16 on the tensor cores), Strides
#include "attn_tile.cuh"  // kTile, kSub, lane_sum, load_row, store_row, dot_part, axpy
#include "rope.cuh"  // load_f, rotate_pair, unrotate_pair

namespace {

// This lane's float4 groups of one row, rotated (or un-rotated) in place by
// the row's table entries t.
template <int D, bool UNROTATE>
__device__ __forceinline__ void rope_row(float4 (&r)[D / 16], const float* t,
                                         int sub) {
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    const int d = 4 * (sub + kSub * y);
    if constexpr (UNROTATE) {
      unrotate_pair<float, D>(r[y].x, r[y].y, t, d);
      unrotate_pair<float, D>(r[y].z, r[y].w, t, d + 2);
    } else {
      rotate_pair<float, D>(r[y].x, r[y].y, t, d);
      rotate_pair<float, D>(r[y].z, r[y].w, t, d + 2);
    }
  }
}

// Stage rows [0, len) of two packed tensors (this head's D columns)
// into shared memory; rows past len are zero. With ROPE the rows of `a`
// rotate on the way in, row r by table row r0 + r.
template <int D, bool ROPE>
__device__ __forceinline__ void stage(float (*a_s)[D], float (*b_s)[D],
                                      const float* a, long long a_rs,
                                      const float* b, long long b_rs, int len,
                                      const float* tab, int r0) {
  if constexpr (ROPE) {  // one (row, pair) per step
    for (int i = threadIdx.x; i < kTile * (D / 2); i += kThreads) {
      const int r = i / (D / 2);
      const int d = 2 * (i % (D / 2));
      float a0 = 0.f, a1 = 0.f, b0 = 0.f, b1 = 0.f;
      if (r < len) {
        const float* ar = a + (long long)r * a_rs + d;
        const float* br = b + (long long)r * b_rs + d;
        a0 = load_f(ar);
        a1 = load_f(ar + 1);
        rotate_pair<float, D>(a0, a1, tab + (long long)(r0 + r) * (2 * D), d);
        b0 = load_f(br);
        b1 = load_f(br + 1);
      }
      a_s[r][d] = a0;
      a_s[r][d + 1] = a1;
      b_s[r][d] = b0;
      b_s[r][d + 1] = b1;
    }
  } else {
    for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      const bool in = r < len;
      a_s[r][d] = in ? load_f(a + (long long)r * a_rs + d) : 0.f;
      b_s[r][d] = in ? load_f(b + (long long)r * b_rs + d) : 0.f;
    }
  }
}

// Pass A (fp32): dQ and delta for one 64-row query tile of one (sample,
// head).
template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ tab,
                       const float* __restrict__ o,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, float* __restrict__ dq,
                       int n, int nk, int heads, Strides st, float scale,
                       int causal) {
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int sub = threadIdx.x % kSub;
  const int row = tile * kTile + threadIdx.x / kSub;
  const bool live = row < n;
  const long long hd = (long long)h * D;

  float4 qr[D / 16], dor[D / 16], acc[D / 16];
  load_row<float, D>(qr, q + b * st.q_bs + row * st.q_rs + hd, sub, live);
  if constexpr (ROPE) {
    if (live) rope_row<D, false>(qr, tab + (long long)row * (2 * D), sub);
  }
  load_row<float, D>(dor, dout + b * st.do_bs + row * st.do_rs + hd, sub, live);
  // delta = rowsum(dO * O), the TPU kernel's in-VMEM reduction; o is read
  // into the accumulator's registers, which start at zero after it.
  load_row<float, D>(acc, o + b * st.o_bs + row * st.o_rs + hd, sub, live);
  float part = 0.f;
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    part = fmaf(dor[y].x, acc[y].x, part);
    part = fmaf(dor[y].y, acc[y].y, part);
    part = fmaf(dor[y].z, acc[y].z, part);
    part = fmaf(dor[y].w, acc[y].w, part);
    acc[y] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float dl = lane_sum(part);
  if (live && sub == 0) delta[(b * heads + h) * n + row] = dl;
  const float lse_r = live ? lse[(b * heads + h) * n + row] : 0.f;

  // In a causal tile every key past the tile's last row is masked for all
  // of its rows, so the walk stops there.
  const int kv_end = causal ? min(nk, (tile + 1) * kTile) : nk;
  const float* kb = k + b * st.k_bs + hd;
  const float* vb = v + b * st.v_bs + hd;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int len = min(kTile, kv_end - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage<D, ROPE>(ks, vs, kb + (long long)k0 * st.k_rs, st.k_rs,
                      vb + (long long)k0 * st.v_rs, st.v_rs, len, tab, k0);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      // every lane takes part in the shuffles, masked or not
      const float s = lane_sum(dot_part<D>(qr, ks[j], sub));
      const float dp = lane_sum(dot_part<D>(dor, vs[j], sub));
      if (!live || (causal && k0 + j > row)) continue;  // P is exactly 0
      const float p = expf(s * scale - lse_r);
      const float ds = p * (dp - dl) * scale;
      axpy<D>(acc, ds, ks[j], sub);
    }
  }
  if (!live) return;
  if constexpr (ROPE) {
    rope_row<D, true>(acc, tab + (long long)row * (2 * D), sub);
  }
  float* out = dq + b * st.dq_bs + row * st.dq_rs + hd;
  store_row<float, D>(out, acc, sub);
}

// Pass B (fp32): dK and dV for one 64-key tile of one (sample, head).
template <int D, bool ROPE>
__global__ void __launch_bounds__(kThreads)
    attn_bwd_dkv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ tab,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dk, float* __restrict__ dv, int n,
                        int nk, int heads, Strides st, float scale,
                        int causal) {
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int sub = threadIdx.x % kSub;
  const int key = tile * kTile + threadIdx.x / kSub;
  const bool live = key < nk;
  const long long hd = (long long)h * D;

  float4 kr[D / 16], vr[D / 16], dk_acc[D / 16], dv_acc[D / 16];
  load_row<float, D>(kr, k + b * st.k_bs + key * st.k_rs + hd, sub, live);
  if constexpr (ROPE) {
    if (live) rope_row<D, false>(kr, tab + (long long)key * (2 * D), sub);
  }
  load_row<float, D>(vr, v + b * st.v_bs + key * st.v_rs + hd, sub, live);
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    dk_acc[y] = make_float4(0.f, 0.f, 0.f, 0.f);
    dv_acc[y] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // Causal: queries before this tile's first key see none of its keys
  // (query tiles start at multiples of kTile too).
  const int q_begin = causal ? tile * kTile : 0;
  const float* qb = q + b * st.q_bs + hd;
  const float* db = dout + b * st.do_bs + hd;
  const float* lb = lse + (b * heads + h) * n;
  const float* deltab = delta + (b * heads + h) * n;
  for (int q0 = q_begin; q0 < n; q0 += kTile) {
    const int len = min(kTile, n - q0);
    __syncthreads();
    stage<D, ROPE>(qs, dos, qb + (long long)q0 * st.q_rs, st.q_rs,
                      db + (long long)q0 * st.do_rs, st.do_rs, len, tab, q0);
    if (threadIdx.x < kTile) {
      const bool in = threadIdx.x < len;
      lse_s[threadIdx.x] = in ? lb[q0 + threadIdx.x] : 0.f;
      delta_s[threadIdx.x] = in ? deltab[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      // every lane takes part in the shuffles, masked or not
      const float s = lane_sum(dot_part<D>(kr, qs[i], sub));
      const float dp = lane_sum(dot_part<D>(vr, dos[i], sub));
      if (!live || (causal && key > q0 + i)) continue;  // P is exactly 0
      const float p = expf(s * scale - lse_s[i]);
      const float ds = p * (dp - delta_s[i]) * scale;
      axpy<D>(dv_acc, p, dos[i], sub);
      axpy<D>(dk_acc, ds, qs[i], sub);
    }
  }
  if (!live) return;
  if constexpr (ROPE) {
    rope_row<D, true>(dk_acc, tab + (long long)key * (2 * D), sub);
  }
  store_row<float, D>(dk + b * st.dk_bs + key * st.dk_rs + hd, dk_acc, sub);
  store_row<float, D>(dv + b * st.dv_bs + key * st.dv_rs + hd, dv_acc, sub);
}

// fp32: the two FMA passes.
template <int D, bool ROPE>
int launch_fma(const void* q, const void* k, const void* v, const void* tab,
               const void* o, const void* dout, const float* lse, float* delta,
               void* dq, void* dk, void* dv, int batch, int n, int nk,
               int heads, const Strides& st, float scale, int causal,
               cudaStream_t stream) {
  const float* t = static_cast<const float*>(tab);
  const dim3 grid_a((n + kTile - 1) / kTile, heads, batch);
  attn_bwd_dq_kernel<D, ROPE><<<grid_a, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), t, static_cast<const float*>(o),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq), n,
      nk, heads, st, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b((nk + kTile - 1) / kTile, heads, batch);
  attn_bwd_dkv_kernel<D, ROPE><<<grid_b, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), t, static_cast<const float*>(dout), lse,
      delta, static_cast<float*>(dk), static_cast<float*>(dv), n, nk, heads,
      st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

// Both entry points, by type and head dim (64 | 32): bf16 on the tensor
// cores (K5's form: delta at (b * heads + h) * n + row of the [B, H, N]
// scratch), fp32 on the FMA kernels.
template <bool ROPE>
int dispatch(const void* q, const void* k, const void* v, const void* tab,
             const void* o, const void* dout, const void* lse, void* delta,
             void* dq, void* dk, void* dv, int is_bf16, int batch, int n,
             int nk, int heads, int head_dim, const long long* strides,
             float scale, int causal, void* stream) {
  static_assert(sizeof(Strides) == 16 * sizeof(long long), "Strides layout");
  Strides st;
  memcpy(&st, strides, sizeof(st));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define MRCLIP_LAUNCH_MMA(D)                                                \
  return launch_mma_bwd<D, false, ROPE>(q, k, v, tab, o, dout, l, nullptr, \
                                        dl, dq, dk, dv, batch, n, nk,      \
                                        heads, st, scale, causal, s)
#define MRCLIP_LAUNCH(D)                                                  \
  return launch_fma<D, ROPE>(q, k, v, tab, o, dout, l, dl, dq, dk, dv,   \
                             batch, n, nk, heads, st, scale, causal, s)
  if (head_dim == 64) {
    if (is_bf16) MRCLIP_LAUNCH_MMA(64);
    MRCLIP_LAUNCH(64);
  }
  if (head_dim == 32) {
    if (is_bf16) MRCLIP_LAUNCH_MMA(32);
    MRCLIP_LAUNCH(32);
  }
#undef MRCLIP_LAUNCH_MMA
#undef MRCLIP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the two launches (0 = success). `strides`
// holds 16 element strides, (batch, row) for q, k, v, o, dO, dq, dk, dv in
// that order. The caller has checked shapes, strides, types and devices;
// element strides are 1, and in bf16 the base pointers and batch and row
// strides are multiples of 16 bytes.
extern "C" int packed_attn_bwd(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* delta, void* dq,
                               void* dk, void* dv, int is_bf16, int batch,
                               int n, int nk, int heads, int head_dim,
                               const long long* strides, float scale,
                               int causal, void* stream) {
  return dispatch<false>(q, k, v, nullptr, o, dout, lse, delta, dq, dk, dv,
                         is_bf16, batch, n, nk, heads, head_dim, strides,
                         scale, causal, stream);
}

// K3r: as packed_attn_bwd for packed_attn_rope_fwd's attention, q and k
// rotated by `tab` ([N, 2*head_dim] sin||cos, contiguous, the input type)
// inside the kernel and dq, dk un-rotated before the store; self-attention,
// so k and v have n rows.
extern "C" int packed_attn_rope_bwd(const void* q, const void* k,
                                    const void* v, const void* tab,
                                    const void* o, const void* dout,
                                    const void* lse, void* delta, void* dq,
                                    void* dk, void* dv, int is_bf16,
                                    int batch, int n, int heads, int head_dim,
                                    const long long* strides, float scale,
                                    int causal, void* stream) {
  return dispatch<true>(q, k, v, tab, o, dout, lse, delta, dq, dk, dv,
                        is_bf16, batch, n, n, heads, head_dim, strides, scale,
                        causal, stream);
}
