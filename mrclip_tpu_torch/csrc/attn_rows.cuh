// Attention kernels shared by grouped_attn.cu (K4, K5: attn_impl='fused')
// and flash_attn.cu (K10, K10b: attn_impl='flash'), one template flag apart.
//
//   FLASH = false, K4/K5, the TPU's single-tile fused_attention
//     (mrclip_tpu/ops/fused_attn.py::_fwd_kernel :101, _bwd_kernel :118).
//     q, k, v, o, dO, dq, dk, dv are contiguous [B*H, N, D] tiles (the
//     grouped layout); lse [B*H, N] fp32 is the forward's residual; delta =
//     rowsum(dO * O) is taken inside the backward, as the TPU kernel does.
//   FLASH = true, K10/K10b, jax's Pallas TPU flash attention as
//     mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded calls it
//     (_flash_attention_kernel_single_batch[_single_step], the dkv and dq
//     kernels of _flash_attention_bwd). q, k, v are [B, N, H, D] views with
//     a batch and a row stride each (the column slices of one in_proj
//     output, unpadded and uncopied); the residuals are the row sum l and
//     row max m, [B, H, N] fp32; di = rowsum(O * dO) comes from outside.
//
// Both walk one 64-row query tile per block with four lanes per row
// (attn_tile.cuh), stage 64-key tiles of K and V through shared memory in
// fp32, and keep every score in registers. The grid is (batch, tile, head).
// These kernels are the fp32 forward and backward only (TF32 products would
// miss the fp32 bar of the plain versions, 1e-4): bf16 runs on the tensor
// cores, the forward in attn_mma_fwd.cuh and the backward in
// attn_mma_bwd.cuh, which hold the launchers that choose by type.
//
// Forward, per query row, over key blocks: K4 has one block of all Nk keys;
// K10 the blocks jax walks, width blk_k = pick_block(Np_k) of the padded
// length (256 or 128), skipping a causal block that lies wholly above the
// diagonal of the row's jax query block (below_or_on_diag). Each block takes
// two walks over its keys:
//   pass A: the block's max (and, where it is the only block, the sum of
//           exp(s - max) kept online);
//   pass B: one block (K4, or K10 when Np_k = blk_k, jax's single-step
//           kernel): o = sum_j round_T(exp(s_j - m) / l) v_j, P normalised
//           then rounded to the input type as the TPU does;
//           several blocks (K10 otherwise): jax's update with the
//           unnormalised P rounded before P.V,
//             m' = max(m, m_blk); l_corr = exp(m - m') l
//             l' = sum_j exp(s_j - m') + l_corr;  inv = 1 / l'
//             acc = acc * (l_corr * inv) + (sum_j round_T(exp(s_j - m')) v_j) * inv
//           each product and sum rounded once (no FMA contraction), so a
//           block whose keys are all masked for a row still multiplies its
//           acc by l * (1 / l), as jax's does.
// Masked scores (causal key > query; jax's padded kv columns, which the
// unpadded inputs here do not have) add -1e30 (K4) or -0.7 * FLT_MAX (K10)
// on the TPU; every visited block of every row holds an unmasked key (key 0
// is in the first block), so their exp is exactly 0 and the kernels skip
// them: the values of every real row are the padded kernels'.
//
// Backward, two passes like K3 (packed_attn_bwd.cu), no atomics:
//   pass A per query tile: dQ (and, for K5, delta) over the key tiles;
//   pass B per key tile: dK and dV over the query tiles;
// with P = exp(S - lse) (K5) or exp(S - m) * (1 / l) (K10b) recomputed, P
// rounded to the input type before P^T dO, dS = (dP - delta) P scale
// rounded before dS K and dS^T Q, every product summed in fp32 and each
// gradient stored once. The causal tiles wholly above the diagonal are
// skipped (their P is exactly 0).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attn_tile.cuh"  // kTile, kSub, kThreads, lane_sum, load_row, ...
#include "rope.cuh"       // load_f, store_f, round_to

namespace {

// Element strides (batch, row) of the eight tensors; head h sits at column
// offset h * D of a row.
struct Strides {
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  long long do_bs, do_rs, dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
};

// Rows [0, len) of one tensor (this head's D columns) into shared memory as
// fp32. CONTIG: the rows are one contiguous span (row stride D, the grouped
// layout), copied with 16-byte loads; otherwise element by element along
// each strided row.
template <typename T, int D, bool CONTIG>
__device__ __forceinline__ void stage_tile(float (*dst)[D], const T* src,
                                           long long rs, int len) {
  if constexpr (CONTIG) {
    constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    float4* d4 = reinterpret_cast<float4*>(&dst[0][0]);
    for (int i = threadIdx.x; i < len * D / kVec; i += kThreads) {
      const uint4 w = s4[i];
      if constexpr (sizeof(T) == 4) {
        d4[i] = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                            __uint_as_float(w.z), __uint_as_float(w.w));
      } else {  // bf16 -> fp32 is a 16-bit shift, exact
        d4[2 * i] = make_float4(
            __uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
            __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
        d4[2 * i + 1] = make_float4(
            __uint_as_float(w.z << 16), __uint_as_float(w.z & 0xffff0000u),
            __uint_as_float(w.w << 16), __uint_as_float(w.w & 0xffff0000u));
      }
    }
  } else {
    for (int i = threadIdx.x; i < len * D; i += kThreads) {
      const int r = i / D;
      const int d = i % D;
      dst[r][d] = load_f(src + (long long)r * rs + d);
    }
  }
}

// Forward in fp32 (K4: stat_a = lse; K10: stat_a = l, stat_b = m), one
// 64-row query tile of one (sample, head). K4 passes nblk = 1 and blk_k =
// nk. bf16 runs attn_mma_fwd.cuh's kernels.
template <typename T, int D, bool FLASH>
__global__ void __launch_bounds__(kThreads)
    rows_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    float* __restrict__ stat_a, float* __restrict__ stat_b,
                    int n, int nk, int heads, Strides st, float scale,
                    int causal, int blk_q, int blk_k, int nblk) {
  static_assert(sizeof(T) == 4, "the bf16 forward is attn_mma_fwd.cuh's");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const long long b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int sub = threadIdx.x % kSub;
  const int row = tile * kTile + threadIdx.x / kSub;
  const bool live = row < n;
  const long long hd = (long long)h * D;
  const bool single = nblk == 1;

  float4 qr[D / 16], acc[D / 16], cur[D / 16];
  load_row<T, D>(qr, q + b * st.q_bs + row * st.q_rs + hd, sub, live);
  zero_row<D>(acc);
  const T* kb = k + b * st.k_bs + hd;
  const T* vb = v + b * st.v_bs + hd;
  // keys past the tile's last row are masked for all its rows (causal)
  const int last = min(n, (tile + 1) * kTile) - 1;
  const int qblk = tile * kTile / blk_q;  // jax's query block (64 | blk_q)

  float m = -INFINITY, l = 0.f;
  for (int c = 0; c < nblk; ++c) {
    const int kb0 = c * blk_k;
    // jax's below_or_on_diag: later blocks lie above the diagonal too
    if (FLASH && causal && !((qblk + 1) * blk_q - 1 > kb0)) break;
    const int kb1 = min(nk, kb0 + blk_k);
    const int kend = causal ? min(kb1, last + 1) : kb1;

    // pass A: the block's max; its online sum of exp(s - max)
    float mc = -INFINITY, lc = 0.f;
    for (int k0 = kb0; k0 < kend; k0 += kTile) {
      const int len = min(kTile, kend - k0);
      __syncthreads();  // every thread is done with the previous tile
      stage_tile<T, D, !FLASH>(ks, kb + (long long)k0 * st.k_rs, st.k_rs, len);
      __syncthreads();
      for (int j = 0; j < len; ++j) {
        // every lane takes part in the shuffles, masked or not
        const float s = __fmul_rn(lane_sum(dot_part<D>(qr, ks[j], sub)), scale);
        if (!live || (causal && k0 + j > row)) continue;
        if (s > mc) {
          lc = __fadd_rn(__fmul_rn(lc, expf(mc - s)), 1.f);
          mc = s;
        } else {
          lc = __fadd_rn(lc, expf(s - mc));
        }
      }
    }

    const float m_next = single ? mc : fmaxf(m, mc);
    // a dead row (never live) has m = m_next = -inf: keep its lanes finite
    const float l_corr = single || !live ? 0.f : __fmul_rn(expf(m - m_next), l);

    // pass B: P.V over the block
    zero_row<D>(cur);
    float ls = 0.f;
    for (int k0 = kb0; k0 < kend; k0 += kTile) {
      const int len = min(kTile, kend - k0);
      __syncthreads();
      stage_tile<T, D, !FLASH>(ks, kb + (long long)k0 * st.k_rs, st.k_rs, len);
      stage_tile<T, D, !FLASH>(vs, vb + (long long)k0 * st.v_rs, st.v_rs, len);
      __syncthreads();
      for (int j = 0; j < len; ++j) {
        const float s = __fmul_rn(lane_sum(dot_part<D>(qr, ks[j], sub)), scale);
        if (!live || (causal && k0 + j > row)) continue;
        float p = expf(s - m_next);
        if (single) {
          p = round_to(__fdiv_rn(p, lc), q);
        } else {
          ls = __fadd_rn(ls, p);
          p = round_to(p, q);
        }
        axpy<D>(cur, p, vs[j], sub);
      }
    }

    if (single) {
#pragma unroll
      for (int y = 0; y < D / 16; ++y) acc[y] = cur[y];
      m = mc;
      l = lc;
    } else {
      const float l_new = __fadd_rn(ls, l_corr);
      const float inv = l_new == 0.f ? 1.f : __fdiv_rn(1.f, l_new);
      const float f = __fmul_rn(l_corr, inv);
#pragma unroll
      for (int y = 0; y < D / 16; ++y) {
        acc[y].x = __fadd_rn(__fmul_rn(acc[y].x, f), __fmul_rn(cur[y].x, inv));
        acc[y].y = __fadd_rn(__fmul_rn(acc[y].y, f), __fmul_rn(cur[y].y, inv));
        acc[y].z = __fadd_rn(__fmul_rn(acc[y].z, f), __fmul_rn(cur[y].z, inv));
        acc[y].w = __fadd_rn(__fmul_rn(acc[y].w, f), __fmul_rn(cur[y].w, inv));
      }
      m = m_next;
      l = l_new;
    }
  }

  if (!live) return;
  store_row<T, D>(o + b * st.o_bs + row * st.o_rs + hd, acc, sub);
  if (sub == 0) {
    const long long i = (b * heads + h) * n + row;
    if constexpr (FLASH) {
      stat_a[i] = l;
      stat_b[i] = m;
    } else {
      stat_a[i] = __fadd_rn(m, logf(l));
    }
  }
}

// P of one (query, key) pair from its unscaled score s and the query row's
// statistics: K5 exp(s * scale - lse); K10b exp(s * scale - m) * (1 / l).
template <bool FLASH>
__device__ __forceinline__ float prob(float s, float scale, float lse_or_m,
                                      float inv_l) {
  const float p = expf(__fsub_rn(__fmul_rn(s, scale), lse_or_m));
  return FLASH ? __fmul_rn(p, inv_l) : p;
}

// dS = (dP - delta) * P * scale, rounded to the input type.
template <typename T>
__device__ __forceinline__ float dscore(float p, float dp, float delta,
                                        float scale, const T* tag) {
  return round_to(__fmul_rn(__fmul_rn(__fsub_rn(dp, delta), p), scale), tag);
}

// Pass A: dQ for one 64-row query tile of one (sample, head). K5 also takes
// delta = rowsum(dO * O) here and writes it for pass B; K10b reads di from
// `delta`.
template <typename T, int D, bool FLASH>
__global__ void __launch_bounds__(kThreads)
    rows_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ o,
                       const T* __restrict__ dout,
                       const float* __restrict__ stat_a,
                       const float* __restrict__ stat_b,
                       float* __restrict__ delta, T* __restrict__ dq, int n,
                       int nk, int heads, Strides st, float scale,
                       int causal) {
  static_assert(sizeof(T) == 4, "the bf16 backward is attn_mma_bwd.cuh's");
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const long long b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int sub = threadIdx.x % kSub;
  const int row = tile * kTile + threadIdx.x / kSub;
  const bool live = row < n;
  const long long hd = (long long)h * D;
  const long long si = (b * heads + h) * n + row;

  float4 qr[D / 16], dor[D / 16], acc[D / 16];
  load_row<T, D>(qr, q + b * st.q_bs + row * st.q_rs + hd, sub, live);
  load_row<T, D>(dor, dout + b * st.do_bs + row * st.do_rs + hd, sub, live);
  float dl, stat, inv_l = 1.f;
  if constexpr (FLASH) {
    dl = live ? delta[si] : 0.f;
    stat = live ? stat_b[si] : 0.f;
    inv_l = live ? __fdiv_rn(1.f, stat_a[si]) : 0.f;
  } else {
    // delta = rowsum(dO * O), the TPU kernel's in-VMEM reduction; o is read
    // into the accumulator's registers, which start at zero after it.
    load_row<T, D>(acc, o + b * st.o_bs + row * st.o_rs + hd, sub, live);
    float part = 0.f;
#pragma unroll
    for (int y = 0; y < D / 16; ++y) {
      part = fmaf(dor[y].x, acc[y].x, part);
      part = fmaf(dor[y].y, acc[y].y, part);
      part = fmaf(dor[y].z, acc[y].z, part);
      part = fmaf(dor[y].w, acc[y].w, part);
    }
    dl = lane_sum(part);
    if (live && sub == 0) delta[si] = dl;
    stat = live ? stat_a[si] : 0.f;
  }
  zero_row<D>(acc);

  const int kv_end = causal ? min(nk, (tile + 1) * kTile) : nk;
  const T* kb = k + b * st.k_bs + hd;
  const T* vb = v + b * st.v_bs + hd;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    const int len = min(kTile, kv_end - k0);
    __syncthreads();  // every thread is done with the previous tile
    stage_tile<T, D, !FLASH>(ks, kb + (long long)k0 * st.k_rs, st.k_rs, len);
    stage_tile<T, D, !FLASH>(vs, vb + (long long)k0 * st.v_rs, st.v_rs, len);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      // every lane takes part in the shuffles, masked or not
      const float s = lane_sum(dot_part<D>(qr, ks[j], sub));
      const float dp = lane_sum(dot_part<D>(dor, vs[j], sub));
      if (!live || (causal && k0 + j > row)) continue;  // P is exactly 0
      const float p = prob<FLASH>(s, scale, stat, inv_l);
      axpy<D>(acc, dscore(p, dp, dl, scale, q), ks[j], sub);
    }
  }
  if (!live) return;
  store_row<T, D>(dq + b * st.dq_bs + row * st.dq_rs + hd, acc, sub);
}

// Pass B: dK and dV for one 64-key tile of one (sample, head).
template <typename T, int D, bool FLASH>
__global__ void __launch_bounds__(kThreads)
    rows_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ stat_a,
                        const float* __restrict__ stat_b,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int n, int nk, int heads,
                        Strides st, float scale, int causal) {
  static_assert(sizeof(T) == 4, "the bf16 backward is attn_mma_bwd.cuh's");
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float stat_s[kTile];   // lse (K5) or m (K10b)
  __shared__ float inv_s[kTile];    // 1 / l (K10b)
  __shared__ float delta_s[kTile];  // delta (K5) or di (K10b)

  const long long b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int sub = threadIdx.x % kSub;
  const int key = tile * kTile + threadIdx.x / kSub;
  const bool live = key < nk;
  const long long hd = (long long)h * D;

  float4 kr[D / 16], vr[D / 16], dk_acc[D / 16], dv_acc[D / 16];
  load_row<T, D>(kr, k + b * st.k_bs + key * st.k_rs + hd, sub, live);
  load_row<T, D>(vr, v + b * st.v_bs + key * st.v_rs + hd, sub, live);
  zero_row<D>(dk_acc);
  zero_row<D>(dv_acc);

  // Causal: queries before this tile's first key see none of its keys.
  const int q_begin = causal ? tile * kTile : 0;
  const T* qb = q + b * st.q_bs + hd;
  const T* db = dout + b * st.do_bs + hd;
  const long long sb = (b * heads + h) * n;
  for (int q0 = q_begin; q0 < n; q0 += kTile) {
    const int len = min(kTile, n - q0);
    __syncthreads();
    stage_tile<T, D, !FLASH>(qs, qb + (long long)q0 * st.q_rs, st.q_rs, len);
    stage_tile<T, D, !FLASH>(dos, db + (long long)q0 * st.do_rs, st.do_rs, len);
    if (threadIdx.x < len) {
      const long long i = sb + q0 + threadIdx.x;
      stat_s[threadIdx.x] = FLASH ? stat_b[i] : stat_a[i];
      inv_s[threadIdx.x] = FLASH ? __fdiv_rn(1.f, stat_a[i]) : 1.f;
      delta_s[threadIdx.x] = delta[i];
    }
    __syncthreads();
    for (int i = 0; i < len; ++i) {
      // every lane takes part in the shuffles, masked or not
      const float s = lane_sum(dot_part<D>(kr, qs[i], sub));
      const float dp = lane_sum(dot_part<D>(vr, dos[i], sub));
      if (!live || (causal && key > q0 + i)) continue;  // P is exactly 0
      const float p = prob<FLASH>(s, scale, stat_s[i], inv_s[i]);
      axpy<D>(dv_acc, round_to(p, q), dos[i], sub);
      axpy<D>(dk_acc, dscore(p, dp, delta_s[i], scale, q), qs[i], sub);
    }
  }
  if (!live) return;
  store_row<T, D>(dk + b * st.dk_bs + key * st.dk_rs + hd, dk_acc, sub);
  store_row<T, D>(dv + b * st.dv_bs + key * st.dv_rs + hd, dv_acc, sub);
}

// Launches both fp32 backward passes; returns the first cudaError_t.
template <typename T, int D, bool FLASH>
int launch_rows_bwd(const void* q, const void* k, const void* v, const void* o,
                    const void* dout, const float* stat_a, const float* stat_b,
                    float* delta, void* dq, void* dk, void* dv, int batch, int n,
                    int nk, int heads, const Strides& st, float scale, int causal,
                    cudaStream_t stream) {
  const dim3 grid_a(batch, (n + kTile - 1) / kTile, heads);
  rows_bwd_dq_kernel<T, D, FLASH><<<grid_a, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), stat_a, stat_b, delta, static_cast<T*>(dq),
      n, nk, heads, st, scale, causal);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(batch, (nk + kTile - 1) / kTile, heads);
  rows_bwd_dkv_kernel<T, D, FLASH><<<grid_b, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), stat_a, stat_b,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), n, nk, heads, st,
      scale, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
