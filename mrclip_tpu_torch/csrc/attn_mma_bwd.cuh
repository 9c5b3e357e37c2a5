// Tensor-core backward of the bf16 attention of packed_attn_bwd.cu (K3,
// attn_impl='fusedp'; K3r, the same with the EVA02 rope), grouped_attn.cu
// (K5, attn_impl='fused') and flash_attn.cu (K10b, attn_impl='flash'), and
// the backward launcher of K5 and K10b (fp32 stays on FMA kernels: TF32
// products would miss the fp32 bar of the plain versions, 1e-4; K3 and K3r
// on packed_attn_bwd.cu's, K5 and K10b on attn_rows.cuh's).
//
// Replaces, in bf16:
//   K3:   mrclip_tpu/ops/fused_attn.py::_packed_bwd_kernel (:382, batched
//         heads, driven by _pbwd_impl :573);
//   K3r:  the same with its rope branch (:418-428, :464-473);
//   K5:   mrclip_tpu/ops/fused_attn.py::_bwd_kernel (:118), driven by
//         _core_bwd (:193);
//   K10b: jax's _flash_attention_dkv_kernel (:796) and
//         _flash_attention_dq_kernel (:1146), driven by _flash_attention_bwd
//         (:254), which mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded
//         reaches.
// One template, FLASH flag as in attn_rows.cuh, ROPE flag as in
// attn_mma_fwd.cuh. K3 and K5 run one instantiation (FLASH = false, ROPE =
// false): the packed [B, N, H*D] views and the grouped [B*H, N, D] tiles
// differ only in their strides. Per (sample, head), the values of the plain
// versions (fused_attention_packed_bwd_ref, fused_attention_bwd_ref,
// flash_attention_bwd_ref):
//   P  = exp(S scale - lse) (K3, K5), exp(S scale - m) * (1 / l) (K10b);
//   dV = round(P)^T dO;  dP = dO V^T;
//   dS = round(P (dP - delta) scale), delta = rowsum(dO O) in fp32 (K3,
//        K5, taken here) or di (K10b, from outside);
//   dQ = dS K;  dK = dS^T Q;  every product summed in fp32, each gradient
//        rounded to bf16 once.
// K3r (ROPE, self-attention): q and k above are round(q cos + rot(q) sin)
// (and k's), rotated inside from the unrotated q and k the forward kept by
// the [N, 2D] sin||cos table, as K2 rotates them (rope.cuh's
// rotate_pair_f32, one rounding: bit-identical to the plain version); dQ and
// dK, summed in fp32 against the rotated operands, are un-rotated in the
// accumulator's registers before their one rounding:
// dx = g cos - rot(round(g sin)) (rope.cuh's unrotate_pair_f32). dV and
// delta (from the unrotated O and dO) are K3's.
// P uses the forward's final statistics, so the backward has no block-
// dependent rounding and N > 256 (jax's several key blocks) needs no MULTI
// form: past 256 rows the staged operands are walked in chunks.
//
// Bound on an H100 SXM at ViT-B/16 vision b256 (N = 197, H = 12, D = 64):
// K3/K5 read q, k, v, o, dO and write dq, dk, dv once (8 x 77.5 MB) plus lse,
// 0.1857 ms at 3.35 TB/s; K10b reads q, k, v, dO, l, m, di and writes dq,
// dk, dv, 0.1640 ms; against 10 D operations per attended pair of the five
// products (76.3 GFLOP, 77 us at 989 TFLOP/s): bound by bytes. The kernels
// do 14 D per pair (S and dP in both passes, 107 GFLOP). Design:
//   - two passes, no atomics: each gradient element is written once by one
//     thread, so two runs give the same bits;
//   - dq pass, grid (batch or groups, row blocks, heads), four warps of 16
//     query rows: Q and dO fragments read once from device memory into
//     registers (32-bit loads in the mma A layout; K3/K5 also read O so,
//     take delta = rowsum(dO O) over the quad of lanes that share a row and
//     write it for the dkv pass); K and V staged in bf16 by 16-byte
//     cp.async into padded rows (ldmatrix meets no bank conflict); per 32
//     keys S = Q K^T and dP = dO V^T on mma.sync m16n8k16, P and dS in fp32
//     in the accumulator's registers, dS rounded to bf16 there as the A
//     fragment of dQ += dS K (K by ldmatrix.trans);
//   - dkv pass, grid (batch or groups, key blocks, heads), four warps of 16
//     keys: K and V fragments read once into registers; Q and dO staged as
//     above with the query rows' statistics (lse or m, in log2 units, 1 / l,
//     delta or di) in fp32 shared memory; per 16 queries S^T = K Q^T, P^T
//     rounded as the A fragment of dV += P^T dO, dP^T = V dO^T, dS^T rounded
//     as the A fragment of dK += dS^T Q;
//   - resident kernels (every main-path shape: the staged rows, Nk for the
//     dq pass and N for the dkv pass, are at most 256): every row staged
//     once, before a block walks up to four 64-row (64-key) sub-tiles, as
//     the forward keeps K and V (a sub-tile per block, restaging for each,
//     took 21-28% longer at vision b256); chunked kernels past 256 rows: one
//     sub-tile a block, chunks of 256 rows staged in turn, two blocks an SM
//     (the dkv pass's chunk allows no more at D = 64, and the registers
//     beyond 168 keep both passes' chunk loops from spilling); neither is
//     double-buffered: the resident kernels stage once, and a second
//     256-row buffer would leave one chunked block an SM;
//   - registers: three resident blocks of an SM allow 168 a thread, and dK,
//     dV, K and V held take 96. 16 queries a dkv step and 32 keys a dq step
//     keep every kernel from spilling: 32 queries spilled 36 bytes in
//     K10b's dkv pass (1.3-1.5% faster at vision b256, up to 3% slower at
//     the text shapes), 64 keys spilled in both dq passes and ran 2-7%
//     slower, two dkv blocks an SM ran 6-8% slower. The staging sits
//     outside the resident kernels' sub-tile loop, where its pointers would
//     stay live beside those 96 (they spilled there). Readings: one call of
//     tools/attn_bwd_variants.py on the H100, PERF.md;
//   - causal: a warp skips the key (query) steps wholly above (below) its
//     diagonal; on the diagonal and the ragged edges masked pairs get a
//     score of -inf, so their P is exactly 0; rows past n (keys past nk) are
//     read as 0 and store nothing;
//   - K3r: the staged operand (K in the dq pass, Q in the dkv pass) is
//     rotated in shared memory by the forward's rotate_rows, each thread
//     its own 16-byte pieces after its cp.async wait, before the barrier
//     that precedes ldmatrix: once per (sample, head) in the resident
//     kernels, once per chunk in the chunked ones. The register operand (Q
//     in the dq pass, K in the dkv pass) is rotated in registers after
//     load_frag_a: each 32-bit A-fragment register is one rope pair of one
//     row, so a lane rotates its own words by one sin and one cos word of
//     the table. dQ and dK are un-rotated the same way in the C layout,
//     whose (c0, c1) and (c2, c3) are one pair of rows g and g + 8; the
//     dkv pass stores dV first, so that its registers are free for dK's;
//   - gradients rounded to bf16 and stored from the accumulators by 32-bit
//     stores. The 16-byte copies and 32-bit loads and stores need the
//     views' base pointers and batch and row strides (and K3r's table) to
//     be multiples of 16 bytes, which the wrappers check.
// What holds it back: each mma.sync reads its B fragment from shared memory
// (16 warp rows per fragment), so shared-memory reads (about 6.7 GB at
// vision b256) and the two recomputed products, not device memory, set its
// pace; a warp's S -> P -> dS -> product chain runs in series.
// Dynamic shared memory: 2 ch (D + 8) * 2 bytes for a chunk of ch rows (dkv:
// plus 12 ch of statistics), 59,904 and 62,400 at N = 197, D = 64: three
// resident blocks share an SM.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attn_mma_fwd.cuh"  // mma_bf16, ldsm_x4, tile_scores, tile_pv, stage_rows, ...

namespace {

constexpr int kDqKeys = 32;      // keys per step of the dq pass
constexpr int kDkvQueries = 16;  // queries per step of the dkv pass

template <int D>
constexpr int mma_bwd_dq_smem(int ch) {  // K and V chunks
  return 2 * ch * (D + 8) * 2;
}

template <int D>
constexpr int mma_bwd_dkv_smem(int ch) {  // Q and dO chunks, three fp32 stats
  return 2 * ch * (D + 8) * 2 + 3 * ch * 4;
}

// This warp's A fragments (mma m16n8k16, row-major) of rows [r0, r0 + 16)
// of one (sample, head)'s D columns, read from device memory by 32-bit
// loads (row stride rs elements); rows >= n read 0.
template <int D>
__device__ __forceinline__ void load_frag_a(uint32_t (&f)[D / 16][4], const bf16* base,
                                            long long rs, int r0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool in0 = r0 + g < n, in1 = r0 + g + 8 < n;
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + (r0 + g) * rs + 2 * t);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(base + (r0 + g + 8) * rs + 2 * t);
#pragma unroll
  for (int ds = 0; ds < D / 16; ++ds) {
    f[ds][0] = in0 ? __ldg(p0 + 8 * ds) : 0u;
    f[ds][1] = in1 ? __ldg(p1 + 8 * ds) : 0u;
    f[ds][2] = in0 ? __ldg(p0 + 8 * ds + 4) : 0u;
    f[ds][3] = in1 ? __ldg(p1 + 8 * ds + 4) : 0u;
  }
}

// Rows [r0, r0 + 16) of an accumulator (C layout) rounded to bf16 and
// stored, rows >= n not.
template <int D>
__device__ __forceinline__ void store_frag_c(bf16* base, long long rs, const float (&acc)[D / 8][4],
                                             int r0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + g + 8 * i;
    if (row >= n) continue;
    uint32_t* p = reinterpret_cast<uint32_t*>(base + row * rs + 2 * t);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) p[4 * j] = pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// K3r: this warp's A fragments of rows [r0, r0 + 16) (load_frag_a's)
// rotated in registers by the [n, 2D] table. In the m16n8k16 A layout each
// 32-bit register holds the pair (2i, 2i + 1) of one row, so a lane rotates
// its own words (rotate_word), reading the pair's sin and cos words of the
// table. No branch: a row past n reads row n - 1's table and keeps its 0,
// so that every table load can be issued before the first is used.
template <int D>
__device__ __forceinline__ void rotate_frag_a(uint32_t (&f)[D / 16][4],
                                              const bf16* __restrict__ tab, int r0, int n,
                                              int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool in0 = r0 + g < n, in1 = r0 + g + 8 < n;
  // the sin words of rows g and g + 8 at column 2t; the cos words D / 2 on
  const uint32_t* t0 =
      reinterpret_cast<const uint32_t*>(tab + min(r0 + g, n - 1) * (2 * D)) + t;
  const uint32_t* t1 =
      reinterpret_cast<const uint32_t*>(tab + min(r0 + g + 8, n - 1) * (2 * D)) + t;
#pragma unroll
  for (int ds = 0; ds < D / 16; ++ds) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // rows g (e even), g + 8 (odd); columns + 8 from e = 2
      const uint32_t* w = (e & 1 ? t1 : t0) + 8 * ds + 4 * (e >> 1);
      const uint32_t y = rotate_word(f[ds][e], __ldg(w), __ldg(w + D / 2));
      f[ds][e] = (e & 1 ? in1 : in0) ? y : 0u;
    }
  }
}

// K3r: rows [r0, r0 + 16) of a gradient accumulator (C layout: (c0, c1)
// and (c2, c3) are columns (2t, 2t + 1) of rows g and g + 8, one rope pair
// each) un-rotated in place by the table, rope.cuh's unrotate_pair_f32
// (g * sin rounded to bf16), before store_frag_c rounds it once. No branch,
// as rotate_frag_a: a row past n (which stores nothing) reads row n - 1's
// table.
template <int D>
__device__ __forceinline__ void unrotate_frag_c(float (&acc)[D / 8][4],
                                                const bf16* __restrict__ tab, int r0, int n,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(r0 + g + 8 * i, n - 1);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(tab + row * (2 * D)) + t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const uint32_t sn = __ldg(w + 4 * j), cs = __ldg(w + D / 2 + 4 * j);
      unrotate_pair_f32(acc[j][2 * i], acc[j][2 * i + 1], bf16_lo(sn), bf16_hi(sn), bf16_lo(cs),
                        bf16_hi(cs), tab);
    }
  }
}

// The dkv pass's transposed scores (rows: keys, this lane's `key` and key +
// 8; columns: queries from s0): queries at or past c1 and causal pairs (key
// > query) to -inf.
template <int KEYS>
__device__ __forceinline__ void mask_scores_t(float (&s)[KEYS / 8][4], int s0, int c1, int key,
                                              bool causal, int t) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = s0 + 8 * j + 2 * t + (e & 1);
      if (col >= c1 || (causal && key + (e & 2) * 4 > col)) s[j][e] = -INFINITY;
    }
  }
}

// dq pass, kDqKeys keys from shared row `kr` of the staged K and V: acc +=
// dS K. st2: this lane's rows' lse (K3, K5) or m (K10b) in log2 units; inv:
// 1 / l (K10b); dl: delta or di.
template <int D, bool FLASH, bool FULL>
__device__ __forceinline__ void dq_tile(float (&acc)[D / 8][4], const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&dof)[D / 16][4], const float (&st2)[2],
                                        const float (&inv)[2], const float (&dl)[2], uint32_t sk,
                                        uint32_t sv, int kr, int groups, int s0, int c1, int r0,
                                        bool mask, bool causal, float sl2, float scale, int lane) {
  float p[kDqKeys / 8][4], dp[kDqKeys / 8][4];
  tile_scores<D, FULL, kDqKeys>(p, qf, sk, kr, groups, lane);
  if (mask) mask_scores<kDqKeys>(p, s0, c1, r0, causal, lane & 3);
  tile_scores<D, FULL, kDqKeys>(dp, dof, sv, kr, groups, lane);
#pragma unroll
  for (int j = 0; j < kDqKeys / 8; ++j) {
    if (FULL || j < 2 * groups) {  // tile_pv reads no further
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float pr = ex2(fmaf(p[j][e], sl2, -st2[i]));
        if constexpr (FLASH) pr *= inv[i];
        p[j][e] = pr * (dp[j][e] - dl[i]) * scale;  // dS, rounded by tile_pv
      }
    }
  }
  tile_pv<D, FULL, kDqKeys>(acc, p, sk, kr, groups, lane);
}

// dkv pass, kDkvQueries queries from shared row `qr` of the staged Q, dO and
// their statistics (s_st: lse or m in log2 units, s_inv: 1 / l, s_dl: delta or
// di): dva += P^T dO, dka += dS^T Q for this lane's keys `key`, key + 8.
template <int D, bool FLASH, bool FULL>
__device__ __forceinline__ void dkv_tile(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                         const uint32_t (&kf)[D / 16][4],
                                         const uint32_t (&vf)[D / 16][4], const float* s_st,
                                         const float* s_inv, const float* s_dl, uint32_t sq,
                                         uint32_t sdo, int qr, int groups, int s0, int c1, int key,
                                         bool mask, bool causal, float sl2, float scale,
                                         int lane) {
  constexpr int kJ = kDkvQueries / 8;
  const int t = lane & 3;
  float p[kJ][4], dp[kJ][4];
  tile_scores<D, FULL, kDkvQueries>(p, kf, sq, qr, groups, lane);
  if (mask) mask_scores_t<kDkvQueries>(p, s0, c1, key, causal, t);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (FULL || j < 2 * groups) {
      const int i = qr + 8 * j + 2 * t;  // this lane's two queries: i, i + 1
      const float2 st = *reinterpret_cast<const float2*>(s_st + i);
      p[j][0] = ex2(fmaf(p[j][0], sl2, -st.x));
      p[j][1] = ex2(fmaf(p[j][1], sl2, -st.y));
      p[j][2] = ex2(fmaf(p[j][2], sl2, -st.x));
      p[j][3] = ex2(fmaf(p[j][3], sl2, -st.y));
      if constexpr (FLASH) {
        const float2 il = *reinterpret_cast<const float2*>(s_inv + i);
        p[j][0] *= il.x;
        p[j][1] *= il.y;
        p[j][2] *= il.x;
        p[j][3] *= il.y;
      }
    }
  }
  tile_pv<D, FULL, kDkvQueries>(dva, p, sdo, qr, groups, lane);
  tile_scores<D, FULL, kDkvQueries>(dp, vf, sdo, qr, groups, lane);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (FULL || j < 2 * groups) {
      const float2 dl = *reinterpret_cast<const float2*>(s_dl + qr + 8 * j + 2 * t);
      p[j][0] = p[j][0] * (dp[j][0] - dl.x) * scale;
      p[j][1] = p[j][1] * (dp[j][1] - dl.y) * scale;
      p[j][2] = p[j][2] * (dp[j][2] - dl.x) * scale;
      p[j][3] = p[j][3] * (dp[j][3] - dl.y) * scale;
    }
  }
  tile_pv<D, FULL, kDkvQueries>(dka, p, sq, qr, groups, lane);
}

// dq pass, this warp's rows: Q (ROPE: rotated by `tab`) and dO fragments,
// and the rows' statistics (st2: lse (K3, K5) or m (K10b) in log2 units;
// inv: 1 / l (K10b); dl: delta, taken here and written for the dkv pass
// (K3, K5), or di (K10b)).
template <int D, bool FLASH, bool ROPE>
__device__ __forceinline__ void dq_rows(uint32_t (&qf)[D / 16][4], uint32_t (&dof)[D / 16][4],
                                        float (&st2)[2], float (&inv)[2], float (&dl)[2],
                                        const bf16* q, const bf16* tab, const bf16* o,
                                        const bf16* dout, const float* stat_a,
                                        const float* stat_b, float* delta, const Strides& st,
                                        long long b, long long hd, long long sb, int wrow0, int n,
                                        int lane) {
  const int r0 = wrow0 + (lane >> 2), t = lane & 3;
  load_frag_a<D>(qf, q + b * st.q_bs + hd, st.q_rs, wrow0, n, lane);
  load_frag_a<D>(dof, dout + b * st.do_bs + hd, st.do_rs, wrow0, n, lane);
  if constexpr (ROPE) rotate_frag_a<D>(qf, tab, wrow0, n, lane);
  if constexpr (FLASH) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      if (row < n) {
        st2[i] = stat_b[sb + row] * kLog2e;
        inv[i] = __fdiv_rn(1.f, stat_a[sb + row]);
        dl[i] = delta[sb + row];
      }
    }
  } else {
    // delta = rowsum(dO * O) in fp32: O read in the A layout, each lane's
    // products summed, then over the quad that shares a row
    uint32_t of[D / 16][4];
    load_frag_a<D>(of, o + b * st.o_bs + hd, st.o_rs, wrow0, n, lane);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int ds = 0; ds < D / 16; ++ds) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        part[e & 1] = fmaf(bf16_lo(dof[ds][e]), bf16_lo(of[ds][e]), part[e & 1]);
        part[e & 1] = fmaf(bf16_hi(dof[ds][e]), bf16_hi(of[ds][e]), part[e & 1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + 8 * i;
      dl[i] = lane_sum(part[i]);
      if (row < n) {
        st2[i] = stat_a[sb + row] * kLog2e;
        if (t == 0) delta[sb + row] = dl[i];
      }
    }
  }
}

// dq pass, this warp's rows against the staged keys [c0, wend) of a chunk
// ending at c1: acc += dS K, kDqKeys keys a step.
template <int D, bool FLASH>
__device__ __forceinline__ void dq_walk(float (&acc)[D / 8][4], const uint32_t (&qf)[D / 16][4],
                                        const uint32_t (&dof)[D / 16][4], const float (&st2)[2],
                                        const float (&inv)[2], const float (&dl)[2], uint32_t sk,
                                        uint32_t sv, int c0, int c1, int wend, int wrow0,
                                        bool causal, float sl2, float scale, int lane) {
  const int r0 = wrow0 + (lane >> 2);
  for (int s0 = c0; s0 < wend; s0 += kDqKeys) {
    const bool mask = !(s0 + kDqKeys <= c1 && (!causal || s0 + kDqKeys - 1 <= wrow0));
    if (s0 + kDqKeys <= wend)
      dq_tile<D, FLASH, true>(acc, qf, dof, st2, inv, dl, sk, sv, s0 - c0, kDqKeys / 16, s0, c1,
                              r0, mask, causal, sl2, scale, lane);
    else
      dq_tile<D, FLASH, false>(acc, qf, dof, st2, inv, dl, sk, sv, s0 - c0, (wend - s0 + 15) / 16,
                               s0, c1, r0, true, causal, sl2, scale, lane);
  }
}

// dq pass: dQ (and, for K3 and K5, delta) for the query rows of one block
// of one (sample, head): K3/K5 stat_a = lse, delta written; K10b stat_a =
// l, stat_b = m, delta = di read. ROPE (K3r, self-attention): Q rotated in
// registers, each staged K row in shared memory, dQ un-rotated before its
// store. CHUNKED = false (Nk <= kMaxChunk): every key staged (and rotated)
// once, before the block walks its `iters` sub-tiles of kMmaRows rows;
// CHUNKED: one sub-tile, the keys staged in chunks of `ch` (a multiple of
// 16, at most kMaxChunk), two blocks an SM.
template <int D, bool FLASH, bool CHUNKED, bool ROPE>
__global__ void __launch_bounds__(kMmaThreads, CHUNKED ? 2 : 3)
    mma_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ tab,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                      float* __restrict__ delta, bf16* __restrict__ dq, int n, int nk, int heads,
                      Strides st, float scale, int causal, int ch, int iters) {
  static_assert(D == 32 || D == 64, "head dim");
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t sk_a = static_cast<uint32_t>(__cvta_generic_to_shared(mma_smem));
  const uint32_t sv_a = sk_a + ch * (D + 8) * 2;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long hd = (long long)h * D;
  const bf16* kb = k + b * st.k_bs + hd;
  const bf16* vb = v + b * st.v_bs + hd;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;

  if constexpr (!CHUNKED) {  // every key, for all the sub-tiles
    stage_rows<D>(sk_a, kb, st.k_rs, nk);
    if constexpr (ROPE) cp_async_commit();  // K apart: it rotates while V lands
    stage_rows<D>(sv_a, vb, st.v_rs, nk);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    const int row0 = (blockIdx.y * iters + it) * kMmaRows;
    if (row0 >= n) break;
    const int wrow0 = row0 + 16 * warp;
    // keys past the sub-tile's last row are masked for all its rows
    // (causal); keys from w_keys on for every row of this warp (a warp
    // whose rows all lie past n computes nothing)
    const int last = min(n, row0 + kMmaRows) - 1;
    const int kend = causal ? min(nk, last + 1) : nk;
    const int w_keys = wrow0 >= n ? INT_MIN : causal ? min(n - 1, wrow0 + 15) + 1 : INT_MAX;

    uint32_t qf[D / 16][4], dof[D / 16][4];
    float st2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    if constexpr (CHUNKED) {
      for (int c0 = 0; c0 < kend; c0 += ch) {
        const int c1 = min(kend, c0 + ch);
        if (c0 > 0 || it > 0) __syncthreads();  // every warp is done with the last chunk
        stage_rows<D>(sk_a, kb + c0 * st.k_rs, st.k_rs, c1 - c0);
        stage_rows<D>(sv_a, vb + c0 * st.v_rs, st.v_rs, c1 - c0);
        cp_async_commit();
        if (c0 == 0 && wrow0 < n)  // under the copies
          dq_rows<D, FLASH, ROPE>(qf, dof, st2, inv, dl, q, tab, o, dout, stat_a, stat_b, delta,
                                  st, b, hd, sb, wrow0, n, lane);
        cp_async_wait<0>();
        if constexpr (ROPE) rotate_rows<D>(sk_a, tab, c0, c1 - c0);
        __syncthreads();
        dq_walk<D, FLASH>(acc, qf, dof, st2, inv, dl, sk_a, sv_a, c0, c1, min(c1, w_keys), wrow0,
                          causal, sl2, scale, lane);
      }
    } else {
      if (wrow0 < n)  // the first sub-tile's under the copies
        dq_rows<D, FLASH, ROPE>(qf, dof, st2, inv, dl, q, tab, o, dout, stat_a, stat_b, delta, st,
                                b, hd, sb, wrow0, n, lane);
      if (it == 0) {
        if constexpr (ROPE) {
          cp_async_wait<1>();
          rotate_rows<D>(sk_a, tab, 0, nk);
        }
        cp_async_wait<0>();
        __syncthreads();
      }
      dq_walk<D, FLASH>(acc, qf, dof, st2, inv, dl, sk_a, sv_a, 0, kend, min(kend, w_keys),
                        wrow0, causal, sl2, scale, lane);
    }
    if (wrow0 < n) {
      if constexpr (ROPE) unrotate_frag_c<D>(acc, tab, wrow0, n, lane);
      store_frag_c<D>(dq + b * st.dq_bs + hd, st.dq_rs, acc, wrow0, n, lane);
    }
  }
}

// dkv pass: query rows [c0, c1) of Q and dO staged by cp.async (committed
// here), their statistics (as dq_rows's, in fp32) stored beside them; the
// stats of the rows up to the next multiple of 16 too, as 0 (1 for 1 / l):
// their P is 0 only if their statistics are finite.
template <int D, bool FLASH>
__device__ __forceinline__ void stage_queries(uint32_t sq, uint32_t sdo, float* s_st, float* s_inv,
                                              float* s_dl, const bf16* qb, const bf16* db,
                                              const Strides& st, const float* stat_a,
                                              const float* stat_b, const float* delta,
                                              long long sb, int c0, int c1) {
  stage_rows<D>(sq, qb + c0 * st.q_rs, st.q_rs, c1 - c0);
  stage_rows<D>(sdo, db + c0 * st.do_rs, st.do_rs, c1 - c0);
  cp_async_commit();
  for (int i = threadIdx.x; i < ((c1 - c0 + 15) & ~15); i += kMmaThreads) {
    const bool in = c0 + i < c1;
    const long long idx = sb + c0 + i;
    s_st[i] = in ? (FLASH ? stat_b[idx] : stat_a[idx]) * kLog2e : 0.f;
    if constexpr (FLASH) s_inv[i] = in ? __fdiv_rn(1.f, stat_a[idx]) : 1.f;
    s_dl[i] = in ? delta[idx] : 0.f;
  }
}

// dkv pass, this warp's keys wk0 .. wk0 + 15 against the staged query rows
// [c0, c1): dka += dS^T Q, dva += P^T dO, kDkvQueries queries a step.
template <int D, bool FLASH>
__device__ __forceinline__ void dkv_walk(float (&dka)[D / 8][4], float (&dva)[D / 8][4],
                                         const uint32_t (&kf)[D / 16][4],
                                         const uint32_t (&vf)[D / 16][4], const float* s_st,
                                         const float* s_inv, const float* s_dl, uint32_t sq,
                                         uint32_t sdo, int c0, int c1, int wk0, bool causal,
                                         float sl2, float scale, int lane) {
  const int key = wk0 + (lane >> 2);
  // causal: these keys see no query before wk0 (c0 and wk0 are multiples
  // of 16 apart)
  const int qs = causal ? max(c0, wk0) : c0;
  for (int s0 = qs; s0 < c1; s0 += kDkvQueries) {
    if (s0 + kDkvQueries <= c1)
      dkv_tile<D, FLASH, true>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq, sdo, s0 - c0,
                               kDkvQueries / 16, s0, c1, key, causal && s0 < wk0 + 16, causal,
                               sl2, scale, lane);
    else
      dkv_tile<D, FLASH, false>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq, sdo, s0 - c0,
                                (c1 - s0 + 15) / 16, s0, c1, key, true, causal, sl2, scale, lane);
  }
}

// dkv pass: dK and dV for the keys of one block of one (sample, head),
// statistics as for the dq pass (delta from it for K3 and K5, di for
// K10b). ROPE (K3r): K rotated in registers, each staged Q row in shared
// memory, dK un-rotated before its store. CHUNKED = false (N <= kMaxChunk):
// every query row staged (and rotated) once, before the block walks its
// `iters` sub-tiles of kMmaRows keys; CHUNKED: one sub-tile, the query
// rows staged in chunks of `ch`, two blocks an SM.
template <int D, bool FLASH, bool CHUNKED, bool ROPE>
__global__ void __launch_bounds__(kMmaThreads, CHUNKED ? 2 : 3)
    mma_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ tab,
                       const bf16* __restrict__ dout, const float* __restrict__ stat_a,
                       const float* __restrict__ stat_b, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int nk, int heads,
                       Strides st, float scale, int causal, int ch, int iters) {
  static_assert(D == 32 || D == 64, "head dim");
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t sq_a = static_cast<uint32_t>(__cvta_generic_to_shared(mma_smem));
  const uint32_t sdo_a = sq_a + ch * (D + 8) * 2;
  float* s_st = reinterpret_cast<float*>(mma_smem + 2 * ch * (D + 8) * 2);
  float* s_inv = s_st + ch;
  float* s_dl = s_inv + ch;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long hd = (long long)h * D;
  const bf16* qb = q + b * st.q_bs + hd;
  const bf16* db = dout + b * st.do_bs + hd;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;

  if constexpr (!CHUNKED)  // every query row, for all the sub-tiles
    stage_queries<D, FLASH>(sq_a, sdo_a, s_st, s_inv, s_dl, qb, db, st, stat_a, stat_b, delta,
                            sb, 0, n);
  for (int it = 0; it < iters; ++it) {
    const int kr0 = (blockIdx.y * iters + it) * kMmaRows;
    if (kr0 >= nk) break;
    const int wk0 = kr0 + 16 * warp;  // this warp's keys: wk0 .. wk0 + 15
    const bool live = wk0 < nk;

    uint32_t kf[D / 16][4], vf[D / 16][4];
    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      dka[j][0] = dka[j][1] = dka[j][2] = dka[j][3] = 0.f;
      dva[j][0] = dva[j][1] = dva[j][2] = dva[j][3] = 0.f;
    }

    if constexpr (CHUNKED) {
      // causal: queries before the sub-tile's first key see none of its keys
      const int q_begin = causal ? kr0 : 0;
      for (int c0 = q_begin; c0 < n; c0 += ch) {
        const int c1 = min(n, c0 + ch);
        if (c0 > q_begin || it > 0) __syncthreads();  // every warp is done with the last chunk
        stage_queries<D, FLASH>(sq_a, sdo_a, s_st, s_inv, s_dl, qb, db, st, stat_a, stat_b,
                                delta, sb, c0, c1);
        if (c0 == q_begin && live) {  // under the copies
          load_frag_a<D>(kf, k + b * st.k_bs + hd, st.k_rs, wk0, nk, lane);
          load_frag_a<D>(vf, v + b * st.v_bs + hd, st.v_rs, wk0, nk, lane);
          if constexpr (ROPE) rotate_frag_a<D>(kf, tab, wk0, nk, lane);
        }
        cp_async_wait<0>();
        if constexpr (ROPE) rotate_rows<D>(sq_a, tab, c0, c1 - c0);
        __syncthreads();
        if (live)
          dkv_walk<D, FLASH>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq_a, sdo_a, c0, c1, wk0,
                             causal, sl2, scale, lane);
      }
    } else {
      if (live) {  // the first sub-tile's under the copies
        load_frag_a<D>(kf, k + b * st.k_bs + hd, st.k_rs, wk0, nk, lane);
        load_frag_a<D>(vf, v + b * st.v_bs + hd, st.v_rs, wk0, nk, lane);
        if constexpr (ROPE) rotate_frag_a<D>(kf, tab, wk0, nk, lane);
      }
      if (it == 0) {
        cp_async_wait<0>();
        if constexpr (ROPE) rotate_rows<D>(sq_a, tab, 0, n);
        __syncthreads();
      }
      if (live)
        dkv_walk<D, FLASH>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq_a, sdo_a, 0, n, wk0, causal,
                           sl2, scale, lane);
    }
    if (live) {  // dV first: its registers are free before dK's un-rotation
      store_frag_c<D>(dv + b * st.dv_bs + hd, st.dv_rs, dva, wk0, nk, lane);
      if constexpr (ROPE) unrotate_frag_c<D>(dka, tab, wk0, nk, lane);
      store_frag_c<D>(dk + b * st.dk_bs + hd, st.dk_rs, dka, wk0, nk, lane);
    }
  }
}

// Launches the bf16 backward, dq pass first (K3's and K5's delta). Each
// pass runs its resident kernel where one chunk holds every row it stages
// (Nk for the dq pass, N for the dkv pass, up to kMaxChunk), a block
// walking up to kMaxRows / kMmaRows sub-tiles, else its chunked kernel, one
// sub-tile a block. `tab`: K3r's [n, 2D] rope table (ROPE), else unused.
// Returns the first cudaError_t.
template <int D, bool FLASH, bool ROPE = false>
int launch_mma_bwd(const void* q, const void* k, const void* v, const void* tab, const void* o,
                   const void* dout, const float* stat_a, const float* stat_b, float* delta,
                   void* dq, void* dk, void* dv, int batch, int n, int nk, int heads,
                   const Strides& st, float scale, int causal, cudaStream_t stream) {
  static std::atomic<unsigned long long> done[4];  // the four kernels' allow_smem
  constexpr int kMost = kMaxRows / kMmaRows;      // sub-tiles of a resident block
  const bf16 *qp = static_cast<const bf16*>(q), *kp = static_cast<const bf16*>(k);
  const bf16 *vp = static_cast<const bf16*>(v), *dop = static_cast<const bf16*>(dout);
  const bf16* tp = static_cast<const bf16*>(tab);
  // resident: the rows staged, rounded up to 16, and the sub-tiles a block
  // walks; chunked: kMaxChunk and one
  auto plan = [&](int len, int tiles, int& ch, int& it) {
    const bool resident = len <= kMaxChunk;
    ch = resident ? (len + 15) & ~15 : kMaxChunk;
    it = resident ? (tiles < kMost ? tiles : kMost) : 1;
    return resident;
  };
  int ch = 0, it = 0;

  const int tiles_q = (n + kMmaRows - 1) / kMmaRows;
  auto dq_pass = [&](auto kernel, std::atomic<unsigned long long>& flag) {
    const cudaError_t e = allow_smem(kernel, mma_bwd_dq_smem<D>(kMaxChunk), flag);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(batch, (tiles_q + it - 1) / it, heads), kMmaThreads, mma_bwd_dq_smem<D>(ch),
             stream>>>(qp, kp, vp, tp, static_cast<const bf16*>(o), dop, stat_a, stat_b, delta,
                       static_cast<bf16*>(dq), n, nk, heads, st, scale, causal, ch, it);
    return cudaGetLastError();
  };
  cudaError_t err = plan(nk, tiles_q, ch, it)
                        ? dq_pass(mma_bwd_dq_kernel<D, FLASH, false, ROPE>, done[0])
                        : dq_pass(mma_bwd_dq_kernel<D, FLASH, true, ROPE>, done[1]);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_k = (nk + kMmaRows - 1) / kMmaRows;
  auto dkv_pass = [&](auto kernel, std::atomic<unsigned long long>& flag) {
    const cudaError_t e = allow_smem(kernel, mma_bwd_dkv_smem<D>(kMaxChunk), flag);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(batch, (tiles_k + it - 1) / it, heads), kMmaThreads, mma_bwd_dkv_smem<D>(ch),
             stream>>>(qp, kp, vp, tp, dop, stat_a, stat_b, delta, static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), n, nk, heads, st, scale, causal, ch, it);
    return cudaGetLastError();
  };
  err = plan(n, tiles_k, ch, it) ? dkv_pass(mma_bwd_dkv_kernel<D, FLASH, false, ROPE>, done[2])
                                 : dkv_pass(mma_bwd_dkv_kernel<D, FLASH, true, ROPE>, done[3]);
  return static_cast<int>(err);
}

// Launches the backward, the kernels chosen by type at compile time: bf16 on
// the tensor cores (launch_mma_bwd), fp32 on the FMA rows kernels. `delta`:
// K5's fp32 [batch * heads, n] scratch, written by the dq pass; K10b's di,
// read. Returns the first cudaError_t.
template <typename T, int D, bool FLASH>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* stat_a, const float* stat_b, float* delta, void* dq, void* dk,
               void* dv, int batch, int n, int nk, int heads, const Strides& st, float scale,
               int causal, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_mma_bwd<D, FLASH>(q, k, v, nullptr, o, dout, stat_a, stat_b, delta, dq, dk,
                                    dv, batch, n, nk, heads, st, scale, causal, stream);
  else
    return launch_rows_bwd<T, D, FLASH>(q, k, v, o, dout, stat_a, stat_b, delta, dq, dk, dv,
                                        batch, n, nk, heads, st, scale, causal, stream);
}

}  // namespace
