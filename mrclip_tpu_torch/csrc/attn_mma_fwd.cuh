// Tensor-core forward of the bf16 attention of packed_attn_fwd.cu (K1,
// attn_impl='fusedp'; K2, the same with the EVA02 rope), grouped_attn.cu
// (K4, attn_impl='fused') and flash_attn.cu (K10, attn_impl='flash'), and
// the forward launcher of K4 and K10 (fp32 stays on FMA kernels: TF32
// products would miss the fp32 bar of the plain version, 1e-4; K1 and K2 on
// packed_attn_fwd.cu's, K4 and K10 on attn_rows.cuh's).
//
// Replaces, in bf16:
//   K1:  mrclip_tpu/ops/fused_attn.py::_packed_fwd_kernel (:300, batched
//        heads, driven by _pfwd_impl :534);
//   K2:  the same with its rope branch (:330-343);
//   K4:  mrclip_tpu/ops/fused_attn.py::_fwd_kernel (:101), driven by
//        _run_fwd (:167);
//   K10: jax's _flash_attention_kernel_single_batch (and its single-step
//        form), which mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded
//        (:41) reaches.
// K1 and K4 run one instantiation (FLASH = false, ROPE = false): the packed
// [B, N, H*D] views and the grouped [B*H, N, D] tiles differ only in their
// strides. The values are those of attn_rows.cuh's rounding orders (FLASH
// flag): with one key block (K1, K2, K4; K10 when the padded length Np_k <=
// 256) P is normalised, then rounded to bf16 before P.V; with several (K10,
// MULTI) jax's update with the unnormalised P rounded before P.V and each
// product and sum of the update rounded once. Scores carry log2(e) so that
// one ex2 gives each exp; m is stored back in natural units.
//
// Bound on an H100 SXM at ViT-B/16 vision b256 (N = 197, H = 12, D = 64):
// q, k, v read and o written once, 310 MB plus the stats: 93.2 us (K1, K2,
// K4) and 93.9 us (K10) at 3.35 TB/s, against 30.5 GFLOP of products (31 us
// at 989 TFLOP/s): bound by bytes.
//
// Two kernels, chosen by shape in launch_mma_fwd, the launcher all four
// reach:
//   wgmma_fwd_kernel<FLASH, ROPE, G>, on Hopper's warpgroup products
//     (wgmma.cuh): K1, K4, K10 and K2 (ROPE) with one key block of nk <=
//     256 keys at D = 64: every main-path shape of the four (N = 197, 98,
//     77, 64). G = ceil(nk / 16) is a template argument, one instantiation
//     per G (1..16) and ROPE: runtime branches between the products made
//     ptxas copy the accumulators and wait after every wgmma, and hold 255
//     registers with spills.
//   mma_fwd_kernel<D, FLASH, MULTI, ROPE>, on Ampere's mma.sync, below: K10
//     over several jax key blocks (MULTI, N > 256), K1, K2 and K4 past 256
//     keys (the chunked walk; K2's rope rotated in shared memory), and D =
//     32.
//
// wgmma_fwd_kernel: one warpgroup (128 threads) per block walks up to four
// sub-tiles of 64 query rows of one (sample, head), grid (batch or groups,
// row blocks, heads), K and V staged once:
//   - K and V by 16-byte cp.async into shared memory in the 128-byte
//     swizzle that the wgmma descriptors read, rows nk .. 16 G - 1
//     zero-filled; V's copy overlaps the first sub-tile's S and softmax. Q
//     by sub-tile into rows padded for ldmatrix, two tiles, the next one's
//     copy overlapping this one; each warp's ldmatrix fragments of its 16
//     rows are the register A operand of S;
//   - K2 (ROPE) rotates as the plain version does (rope.cuh's
//     rotate_pair_f32, one rounding: bit-identical), each thread the
//     16-byte pieces it copied itself once its cp.async wait has landed
//     them, before the barrier that publishes them, the table rows read by
//     16-byte loads (L1/L2: 50 KB at N = 197): K once per (sample, head) in
//     the swizzled tile while V still lands, then fence.proxy.async
//     (rotate_swz); each Q sub-tile in its padded rows (rotate_rows), so
//     the barrier that already publishes the tile publishes the rotation
//     too. Rotating each warp's Q A fragments in registers instead
//     (rotate_frag_a, 32-bit table loads, eight 16-byte rows a load) read
//     0.2326 ms against 0.2050 at EVA02 vision b256 on the H100; loading
//     every piece's table words before K lands spilled (PERF.md, section
//     6). Either rotation alone costs about as much as both: the first
//     table reads of a block come from L2 under the copies' load;
//   - S = Q K^T once: wgmma m64n64k16 over the whole 64-key tiles and
//     m64n16k16 over the 16-key groups of the tail (N = 197 computes 208
//     keys, not 256); each row's scores stay whole in registers (8 G fp32 a
//     thread); a causal sub-tile computes all G groups too, its keys past
//     its last row set to -inf: a skip inside the batch is a runtime branch
//     between products, and a second, half-width body for the causal
//     sub-tiles that need no more (a build tried on the H100) gained
//     nothing at text b256, N = 98, where the products do not bound the
//     kernel (PERF.md, section 6);
//   - an exact softmax from the registers: keys >= nk and causal pairs to
//     -inf, the row max m over every key (reduced over the quad of lanes
//     that share a row), one ex2 per score, l = sum p, then P = p * (1 / l)
//     rounded to bf16 into the A fragments of P V: the TPU's order (P
//     normalised, then rounded); the normalisation is a multiply where
//     mma_fwd_kernel takes a second exp, fp32 ulps before the rounding;
//   - O = P V on wgmma m64n64k16, one 16-key group a step, V read MN-major
//     (transpose bit, no copy); o rounded to bf16 and stored through the
//     warp's rows of the Q tile by 16-byte stores; lse = m + log l (K1, K4,
//     K2) or l and m (K10); rows >= n store nothing.
// Sub-tile waste at N = 197: 197 rows compute 256 rows of each product,
// and 197 keys 208. Shared memory: 1 KB of alignment slack, K and V 2 KB
// each per 16-key group, two Q tiles of 9 KB: 72,704 bytes at N = 197 (G =
// 13), 85,000 at 256 keys; two blocks an SM (__launch_bounds__(128, 2)).
// Registers (-Xptxas -v in build.py's log, sm_90a): 74 (G = 1) to 185 (G
// = 16), 164 at G = 13, 104 at G = 7, 88 at G = 5, the same for K10; K2
// 90 (G <= 5) to 182, 160 at G = 13; no spill, no serialized wgmma.
//
// mma_fwd_kernel (MULTI, past 256 keys, D = 32) keeps every product on
// the tensor cores and reads K and V from device memory once per (sample,
// head) where a block holds them:
//   - four warps of 16 query rows walk sub-tiles of 64 rows; where one chunk
//     holds every key (D = 32 up to 256 keys) K and V stay staged and a
//     block walks up to 256 query rows, so K and V leave device memory once
//     per (sample, head) (one block per 64 rows read them four times at N =
//     197 and took nearly twice as long on the H100); the grid is
//     (batch or groups, row blocks, heads);
//   - Q, K and V staged in bf16 in dynamic shared memory by 16-byte
//     cp.async (one row's head slice is D * 2 bytes, so the same copy takes
//     the contiguous grouped layout and the strided [B, N, H, D] views and
//     [B, N, H*D] column slices; the wrappers refuse a bf16 view whose base
//     pointer or batch or row stride is not a multiple of 16 bytes), rows
//     padded by 16 bytes so that ldmatrix meets no bank conflict, rows past
//     the last key zero-filled by the copy itself;
//   - K2 (ROPE): each thread rotates in place the 16-byte pieces of Q and K
//     it copied itself, once its cp.async wait has landed them and before
//     the barrier that precedes ldmatrix, by rope.cuh's rotate_pair_f32
//     (fp32, each product and sum rounded once, one rounding to bf16:
//     bit-identical to the plain version's rotated q and k), the table row
//     of each query or key position read from device memory by 16-byte
//     loads, two pieces' in flight (L1/L2: 50 KB at N = 197, D = 64). No
//     shared memory beyond K1's: the rotated rows replace the
//     staged ones. K is rotated once per (sample, head) where it stays
//     staged, and again for each chunk copied again past 256 keys; V's copy
//     still overlaps the rotation and pass A; zero-filled rows are left
//     alone;
//   - a chunk is up to 256 keys, the whole K and V of one jax key block;
//     V's copy overlaps pass A. K1, K2 and K4 past 256 keys walk chunks of
//     256, copied again in pass B. Whole chunks, not double-buffered 64-key
//     tiles: jax's blocks are at most 256 keys, so one copy per block
//     serves both passes and the recompute of pass B reads shared memory
//     only;
//   - S = Q K^T on mma.sync m16n8k16 (bf16 in, fp32 out) with Q's fragments
//     loaded once by ldmatrix, 64 keys at a time, scaled in fp32; keys past
//     the chunk and causal pairs (key > query) set to -inf, so their exp is
//     exactly 0; row max and sum reduced over the quad of lanes that share a
//     row, once per 64 keys;
//   - pass A: the max and the online sum (one block) or the block's max
//     (several); pass B: S recomputed on the tensor cores from shared
//     memory, P rounded to bf16 in the accumulator's registers, which are
//     the A fragments of P.V (V read by ldmatrix.trans), P.V summed in fp32.
//     The TPU's order (P normalised, then rounded) needs a row's final max
//     and sum before any P.V; holding a whole walk's scores in registers
//     instead (S computed once) on mma.sync, at three blocks an SM, took
//     three instantiations per kernel and spilled, and timed within the
//     run-to-run spread of this form on the H100 (PERF.md, section 6):
//     wgmma_fwd_kernel does so on wgmma at two blocks an SM;
//   - o rounded to bf16 and stored by 16-byte stores through the warp's
//     rows of the Q tile; lse = m + log l (K1, K2, K4) or l and m (K10), one
//     lane per row; rows >= n store nothing, a warp whose rows all lie past
//     n computes nothing.
// Dynamic shared memory: (64 + 2 ch) * (D + 8) * 2 bytes for a chunk of ch
// keys, 69,120 at N = 197, D = 64, so three blocks share an SM. Registers
// (-Xptxas -v in build.py's log, sm_90a; three blocks of 128 threads per SM
// cap them at 168): K1/K4 127 (D = 32) and 167 (D = 64); K2 144 and 167;
// K10 128 and 168 with one key block, 167 and 168 with several, the last
// spilling 60 bytes (the N = 577 path, off the main paths). The rotation
// pass takes two pieces per step: four spilled at D = 64, one timed slower
// on the H100.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "attn_rows.cuh"  // Strides, rows_fwd_kernel (fp32), lane_sum
#include "wgmma.cuh"      // wgmma_m64n64k16, wgmma_m64n16k16, wgmma_desc, swz128, ...

namespace {

constexpr int kMmaRows = 64;  // query rows per sub-tile, 16 per warp
constexpr int kMmaThreads = 128;
constexpr int kMaxChunk = 256;  // keys staged at once
constexpr int kMaxRows = 256;   // query rows per block while K and V stay staged
constexpr int kWgKeys = 256;    // wgmma_fwd_kernel: the most keys, all scores in registers
constexpr int kWgDim = 64;      // wgmma_fwd_kernel's head dim: one 128-byte row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Shared-memory bytes: the Q tile and `ch` rows each of K and V, rows of D
// + 8 elements.
template <int D>
constexpr int mma_smem_bytes(int ch) {
  return (kMmaRows + 2 * ch) * (D + 8) * 2;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr)
                 : "memory");
  }
}

// d += a b: m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, len) of one (sample, head)'s D columns (row stride rs elements)
// into shared rows of D + 8 elements at `dst`, by 16-byte copies; rows
// [len, len rounded up to 16) are zero-filled (no source bytes).
template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src, long long rs,
                                           int len) {
  constexpr int kChunks = D / 8;  // 16-byte pieces per row
  const int rows = (len + 15) & ~15;
  for (int i = threadIdx.x; i < rows * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < len;
    cp_async16(dst + (r * (D + 8) + c * 8) * 2, src + (in ? r * rs + c * 8 : 0), in ? 16 : 0);
  }
}

// The two bf16 of a 32-bit word as fp32: dim 2i in the low half.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint4 lds16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1,%2,%3,%4};\n" ::"r"(addr), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// One 32-bit word (the pair (2i, 2i+1) of one row, dim 2i in the low half)
// rotated by the words of its sin and cos: rope.cuh's rotate_pair_f32,
// then one rounding to bf16 (nearest even, as round_to).
__device__ __forceinline__ uint32_t rotate_word(uint32_t x, uint32_t sn, uint32_t cs) {
  float x0 = bf16_lo(x), x1 = bf16_hi(x);
  rotate_pair_f32(x0, x1, bf16_lo(sn), bf16_hi(sn), bf16_lo(cs), bf16_hi(cs));
  return pack_bf16(x0, x1);
}

// One 16-byte piece (4 pairs) rotated by its 8 sin and 8 cos, a word at a
// time.
__device__ __forceinline__ uint4 rotate_piece(const uint4& x, const uint4& sn, const uint4& cs) {
  return make_uint4(rotate_word(x.x, sn.x, cs.x), rotate_word(x.y, sn.y, cs.y),
                    rotate_word(x.z, sn.z, cs.z), rotate_word(x.w, sn.w, cs.w));
}

// K2, K3r: rows [0, len) that stage_rows staged at shared address `dst` rotated
// in place, row r by table row p0 + r. Each thread takes the 16-byte
// pieces it copied itself, so its own cp.async wait has landed them; the
// caller's __syncthreads then publishes them to ldmatrix. A piece reads its
// 8 sin and 8 cos as two 16-byte loads (the wrapper checks that the
// table's base pointer is a multiple of 16 bytes), two pieces' loads in
// flight at once. The zero-filled rows past len stay as they are, and no
// table row past p0 + len - 1 is read.
template <int D>
__device__ __forceinline__ void rotate_rows(uint32_t dst, const bf16* __restrict__ tab, int p0,
                                            int len) {
  constexpr int kChunks = D / 8;                    // 16-byte pieces per row, as stage_rows
  constexpr int kStep = kMmaThreads / kChunks;      // rows between a thread's pieces
  constexpr uint32_t kRowBytes = kStep * (D + 8) * 2;
  const int c = threadIdx.x % kChunks;              // the thread's piece of every row it takes
  int r = threadIdx.x / kChunks;
  uint32_t a = dst + (r * (D + 8) + c * 8) * 2;
  const uint4* t = reinterpret_cast<const uint4*>(tab + ((p0 + r) * (2 * D) + c * 8));
  for (; r < len; r += 2 * kStep, a += 2 * kRowBytes, t += 2 * kStep * (2 * D / 8)) {
    const uint4 x0 = lds16(a), s0 = __ldg(t), k0 = __ldg(t + D / 8);
    if (r + kStep < len) {  // the next piece's loads in flight beside this one's
      const uint32_t a1 = a + kRowBytes;
      const uint4* t1 = t + kStep * (2 * D / 8);
      const uint4 x1 = lds16(a1), s1 = __ldg(t1), k1 = __ldg(t1 + D / 8);
      sts16(a, rotate_piece(x0, s0, k0));
      sts16(a1, rotate_piece(x1, s1, k1));
    } else {
      sts16(a, rotate_piece(x0, s0, k0));
    }
  }
}

// K3r: this warp's A fragments of rows [r0, r0 + 16) rotated in registers
// by the [n, 2D] table. In mma.sync's m16n8k16 A layout, which is also
// wgmma's register A (attn_mma_bwd.cuh's load_frag_a, or ldmatrix), each
// 32-bit register holds the pair (2i, 2i + 1) of one row, so a lane rotates
// its own words (rotate_word), reading the pair's sin and cos words of the
// table. No branch: a row past n reads row n - 1's table and is set to 0,
// so that every table load can be issued before the first is used. K2's
// wgmma form rotates its Q sub-tile with rotate_rows instead (faster on the
// H100: the header's note).
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

// This warp's raw scores q.k over KEYS keys from shared row `kr` of K:
// n-fragment j holds keys kr + 8j + 2t + {0, 1} of rows g (regs 0, 1) and
// g + 8 (regs 2, 3). FULL: all KEYS / 16 groups of 16 keys; else groups
// from `groups` on are not computed and read 0. The backward
// (attn_mma_bwd.cuh) takes the same product with other operands and
// widths: Q K^T and dO V^T over 32 keys, K Q^T and V dO^T over 16 queries.
template <int D, bool FULL, int KEYS = 64>
__device__ __forceinline__ void tile_scores(float (&s)[KEYS / 8][4],
                                            const uint32_t (&qf)[D / 16][4], uint32_t sk, int kr,
                                            int groups, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  // this lane's ldmatrix row: keys 0-7 / 8-15 of a group, dims 0-7 / 8-15
  const uint32_t base = sk + ((kr + (mi >> 1) * 8 + rr) * (D + 8) + (mi & 1) * 8) * 2;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ds = 0; ds < D / 16; ++ds) {
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      if (FULL || kk < groups) {
        uint32_t b[4];
        ldsm_x4<false>(b, base + (16 * kk * (D + 8) + 16 * ds) * 2);
        mma_bf16(s[2 * kk], qf[ds], b[0], b[1]);
        mma_bf16(s[2 * kk + 1], qf[ds], b[2], b[3]);
      }
    }
  }
}

// acc += P V over the KEYS keys of `p` (probabilities in the accumulator
// layout of tile_scores, rounded to bf16 here: the C fragments of keys
// 16kk..+7 and +8..+15 are the A fragment) from shared row `kr` of V. The
// backward's dV, dQ and dK products are this one with P^T, dS or dS^T.
template <int D, bool FULL, int KEYS = 64>
__device__ __forceinline__ void tile_pv(float (&acc)[D / 8][4], const float (&p)[KEYS / 8][4],
                                        uint32_t sv, int kr, int groups, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  // this lane's ldmatrix.trans row: keys 0-7 / 8-15, dims 0-7 | 8-15
  const uint32_t base = sv + ((kr + (mi & 1) * 8 + rr) * (D + 8) + (mi >> 1) * 8) * 2;
#pragma unroll
  for (int kk = 0; kk < KEYS / 16; ++kk) {
    if (FULL || kk < groups) {
      const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                             pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                             pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                             pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4<true>(b, base + (16 * kk * (D + 8) + 16 * dp) * 2);
        mma_bf16(acc[2 * dp], a, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
      }
    }
  }
}

// Keys at or past c1 and causal pairs (key > query row) to -inf.
template <int KEYS = 64>
__device__ __forceinline__ void mask_scores(float (&s)[KEYS / 8][4], int s0, int c1, int r0,
                                            bool causal, int t) {
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = s0 + 8 * j + 2 * t + (e & 1);
      if (key >= c1 || (causal && key > r0 + (e & 2) * 4)) s[j][e] = -INFINITY;
    }
  }
}

// One sub-tile of 64 keys, pass A: the rows' max m (base 2: s * sl2) and,
// with one key block, the online sum l of 2^(s sl2 - m) (MULTI: the
// block's max mb only). `mask`: some key of the 64 is masked.
template <int D, bool MULTI, bool FULL>
__device__ __forceinline__ void pass_a_tile(float (&m)[2], float (&l)[2], float (&mb)[2],
                                            const uint32_t (&qf)[D / 16][4], uint32_t sk, int kr,
                                            int groups, int s0, int c1, int r0, bool mask,
                                            bool causal, float sl2, int lane) {
  float s[8][4];
  tile_scores<D, FULL>(s, qf, sk, kr, groups, lane);
  if (mask) mask_scores(s, s0, c1, r0, causal, lane & 3);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
    mx = quad_max(mx) * sl2;  // scale > 0: the max of the scaled scores
    if constexpr (MULTI) {
      mb[i] = fmaxf(mb[i], mx);
    } else {
      const float m_new = fmaxf(m[i], mx);
      if (m_new != -INFINITY) {
        float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (FULL || j < 2 * groups) {  // keys not computed: exp 0
            sum0 += ex2(fmaf(s[j][2 * i], sl2, -m_new));
            sum1 += ex2(fmaf(s[j][2 * i + 1], sl2, -m_new));
          }
        }
        l[i] = fmaf(l[i], ex2(m[i] - m_new), sum0 + sum1);
      }
      m[i] = m_new;
    }
  }
}

// One sub-tile of 64 keys, pass B: p = 2^(s sl2 - mo) (one block: mo = m
// + log2 l, P normalised; MULTI: mo = the new max, P unnormalised and its
// sum added to ls), rounded to bf16, acc += P V.
template <int D, bool MULTI, bool FULL>
__device__ __forceinline__ void pass_b_tile(float (&acc)[D / 8][4], float (&ls)[2],
                                            const float (&mo)[2],
                                            const uint32_t (&qf)[D / 16][4], uint32_t sk,
                                            uint32_t sv, int kr, int groups, int s0, int c1,
                                            int r0, bool mask, bool causal, float sl2, int lane) {
  float s[8][4];
  tile_scores<D, FULL>(s, qf, sk, kr, groups, lane);
  if (mask) mask_scores(s, s0, c1, r0, causal, lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (FULL || j < 2 * groups) {  // tile_pv reads no further
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], sl2, -mo[e >> 1]));
        if constexpr (MULTI) ls[e >> 1] += s[j][e];
      }
    }
  }
  tile_pv<D, FULL>(acc, s, sv, kr, groups, lane);
}

// Forward of the query rows of one block of one (sample, head): K4 and K1
// (FLASH = false: stat_a = lse) or K10 (stat_a = l, stat_b = m); MULTI:
// jax's walk over nblk > 1 key blocks. K4 and K1 pass nblk = 1 and blk_k =
// nk. ROPE (K2, self-attention): q and k rotated in shared memory by the
// [n, 2D] table `tab`. The block walks `iters` sub-tiles of kMmaRows rows;
// `ch` is the staged chunk, in keys (a multiple of 16, at most kMaxChunk).
// Where one chunk holds every key, K and V are staged (and K rotated) once
// for all the sub-tiles.
template <int D, bool FLASH, bool MULTI, bool ROPE>
__global__ void __launch_bounds__(kMmaThreads, 3)
    mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ tab,
                   bf16* __restrict__ o, float* __restrict__ stat_a,
                   float* __restrict__ stat_b, int n, int nk, int heads, Strides st, float scale,
                   int causal, int blk_q, int blk_k, int nblk, int ch, int iters) {
  static_assert(D == 32 || D == 64, "head dim");
  static_assert(FLASH || !MULTI, "K4 walks one key block");
  static_assert(!(FLASH && ROPE), "the rope forward is K2's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sq = reinterpret_cast<bf16*>(mma_smem);
  const uint32_t sq_a = static_cast<uint32_t>(__cvta_generic_to_shared(sq));
  const uint32_t sk_a = sq_a + kMmaRows * (D + 8) * 2;
  const uint32_t sv_a = sk_a + ch * (D + 8) * 2;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long hd = (long long)h * D;
  const bf16* kb = k + b * st.k_bs + hd;
  const bf16* vb = v + b * st.v_bs + hd;
  const float sl2 = scale * kLog2e;
  const bool resident = nblk == 1 && nk <= ch;

  for (int it = 0; it < iters; ++it) {
    const int row0 = (blockIdx.y * iters + it) * kMmaRows;
    if (row0 >= n) break;
    const int wrow0 = row0 + 16 * warp;
    const int r0 = wrow0 + g;  // this lane's rows: r0 and r0 + 8
    __syncthreads();  // every warp is done with the Q tile (its staged o)
    stage_rows<D>(sq_a, q + b * st.q_bs + row0 * st.q_rs + hd, st.q_rs,
                  min(kMmaRows, n - row0));
    cp_async_commit();

    // keys past the sub-tile's last row are masked for all its rows
    // (causal); keys from w_keys on for every row of this warp (a warp
    // whose rows all lie past n computes nothing)
    const int last = min(n, row0 + kMmaRows) - 1;
    const int w_keys = wrow0 >= n ? INT_MIN : causal ? min(n - 1, wrow0 + 15) + 1 : INT_MAX;
    const int qblk = row0 / blk_q;  // jax's query block (kMmaRows | blk_q)

    uint32_t qf[D / 16][4];
    bool have_q = false;
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m to base 2

    for (int c = 0; c < nblk; ++c) {
      const int kb0 = c * blk_k;
      // jax's below_or_on_diag: later blocks lie above the diagonal too
      if (FLASH && causal && !((qblk + 1) * blk_q - 1 > kb0)) break;
      const int kb1 = min(nk, kb0 + blk_k);
      const int kend = causal ? min(kb1, last + 1) : kb1;
      const int nch = kend > kb0 ? (kend - kb0 + ch - 1) / ch : 0;

      // pass A: the block's max; one block: the online sum
      float mb[2] = {-INFINITY, -INFINITY};
      for (int ci = 0; ci < nch; ++ci) {
        const int c0 = kb0 + ci * ch, c1 = min(kend, c0 + ch);
        if (!resident || it == 0) {
          __syncthreads();  // every warp is done with the staged chunk
          const int s1 = resident ? kb1 : c1;  // resident: every key, for later sub-tiles
          stage_rows<D>(sk_a, kb + c0 * st.k_rs, st.k_rs, s1 - c0);
          cp_async_commit();
          if (nch == 1) {  // V's copy overlaps pass A
            stage_rows<D>(sv_a, vb + c0 * st.v_rs, st.v_rs, s1 - c0);
            cp_async_commit();
            cp_async_wait<1>();
          } else {
            cp_async_wait<0>();
          }
          if constexpr (ROPE) rotate_rows<D>(sk_a, tab, c0, s1 - c0);
        } else {
          cp_async_wait<0>();  // the sub-tile's Q
        }
        if constexpr (ROPE) {
          if (!have_q) rotate_rows<D>(sq_a, tab, row0, min(kMmaRows, n - row0));
        }
        __syncthreads();
        if (!have_q) {  // Q's copy came before the first chunk's K
          const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
          for (int ds = 0; ds < D / 16; ++ds)
            ldsm_x4<false>(qf[ds], sq_a + ((16 * warp + (mi & 1) * 8 + rr) * (D + 8) +
                                           16 * ds + (mi >> 1) * 8) * 2);
          have_q = true;
        }
        const int wend = min(c1, w_keys);
        for (int s0 = c0; s0 < wend; s0 += 64) {
          const bool mask = !(s0 + 64 <= c1 && (!causal || s0 + 63 <= wrow0));
          if (s0 + 64 <= wend)
            pass_a_tile<D, MULTI, true>(m, l, mb, qf, sk_a, s0 - c0, 4, s0, c1, r0, mask,
                                        causal, sl2, lane);
          else
            pass_a_tile<D, MULTI, false>(m, l, mb, qf, sk_a, s0 - c0, (wend - s0 + 15) / 16, s0,
                                         c1, r0, true, causal, sl2, lane);
        }
      }

      // pass B: P.V over the block, S recomputed from shared memory
      float mo[2], ls[2] = {0.f, 0.f};
      float cur[D / 8][4];  // MULTI: this block's P.V
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (MULTI) {
          mo[i] = fmaxf(m[i], mb[i]);
        } else {
          l[i] = lane_sum(l[i]);
          mo[i] = m[i] + log2f(l[i]);  // 2^(s sl2 - mo) = exp(s scale - m) / l
        }
      }
      if constexpr (MULTI) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) cur[j][0] = cur[j][1] = cur[j][2] = cur[j][3] = 0.f;
      }
      for (int ci = 0; ci < nch; ++ci) {
        const int c0 = kb0 + ci * ch, c1 = min(kend, c0 + ch);
        if (nch > 1) {
          __syncthreads();
          stage_rows<D>(sk_a, kb + c0 * st.k_rs, st.k_rs, c1 - c0);
          stage_rows<D>(sv_a, vb + c0 * st.v_rs, st.v_rs, c1 - c0);
          cp_async_commit();
        }
        cp_async_wait<0>();
        if constexpr (ROPE) {
          if (nch > 1) rotate_rows<D>(sk_a, tab, c0, c1 - c0);  // the chunk copied again
        }
        __syncthreads();
        const int wend = min(c1, w_keys);
        for (int s0 = c0; s0 < wend; s0 += 64) {
          const bool mask = !(s0 + 64 <= c1 && (!causal || s0 + 63 <= wrow0));
          const bool full = s0 + 64 <= wend;
          const int groups = full ? 4 : (wend - s0 + 15) / 16;
          if constexpr (MULTI) {  // the block's P.V apart, for jax's update
            if (full)
              pass_b_tile<D, true, true>(cur, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                         r0, mask, causal, sl2, lane);
            else
              pass_b_tile<D, true, false>(cur, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                          r0, true, causal, sl2, lane);
          } else {
            if (full)
              pass_b_tile<D, false, true>(acc, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                          r0, mask, causal, sl2, lane);
            else
              pass_b_tile<D, false, false>(acc, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0,
                                           c1, r0, true, causal, sl2, lane);
          }
        }
      }

      if constexpr (MULTI) {
        // jax's update, each product and sum rounded once (no contraction)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float l_blk = lane_sum(ls[i]);
          const float l_corr = mo[i] == -INFINITY ? 0.f : __fmul_rn(ex2(m[i] - mo[i]), l[i]);
          const float l_new = __fadd_rn(l_blk, l_corr);
          const float inv = l_new == 0.f ? 1.f : __fdiv_rn(1.f, l_new);
          const float f = __fmul_rn(l_corr, inv);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
#pragma unroll
            for (int e = 2 * i; e < 2 * i + 2; ++e)
              acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], f), __fmul_rn(cur[j][e], inv));
          }
          m[i] = mo[i];
          l[i] = l_new;
        }
      }
    }

    // o through this warp's 16 rows of the Q tile, 16 bytes per store
    __syncwarp();
    bf16* so = sq + 16 * warp * (D + 8);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(so + g * (D + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * (D + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const int row = wrow0 + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o + b * st.o_bs + row * st.o_rs + hd + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * (D + 8) + 8 * c8);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= n) continue;
        const long long idx = (b * heads + h) * n + row;
        const float m_nat = m[i] * kLn2;
        if constexpr (FLASH) {
          stat_a[idx] = l[i];
          stat_b[idx] = m_nat;
        } else {
          stat_a[idx] = __fadd_rn(m_nat, logf(l[i]));
        }
      }
    }
  }
}

// Lets `kernel` take `bytes` of dynamic shared memory (above the default 48
// KB), once per device: `done` holds a bit per device, one flag per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int bytes, std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// Lets mma_fwd_kernel<D, FLASH, MULTI, ROPE> take the largest chunk's
// shared memory (above the default 48 KB for D = 64).
template <int D, bool FLASH, bool MULTI, bool ROPE>
cudaError_t allow_mma_smem() {
  static std::atomic<unsigned long long> done{0};
  return allow_smem(mma_fwd_kernel<D, FLASH, MULTI, ROPE>, mma_smem_bytes<D>(kMaxChunk), done);
}

// Shared-memory bytes of wgmma_fwd_kernel for `kr` staged key rows (a
// multiple of 16): alignment slack, K and V in 128-byte rows, two Q tiles.
constexpr int wg_smem_bytes(int kr) {
  return 1024 + 2 * kr * 128 + 2 * kMmaRows * (kWgDim + 8) * 2;
}

// Rows [0, len) of one (sample, head)'s 64 columns (row stride rs elements)
// into the 128-byte-swizzled tile at `dst` by 16-byte copies; rows [len,
// rows) zero-filled.
__device__ __forceinline__ void stage_swz(uint32_t dst, const bf16* src, long long rs, int len,
                                          int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += kMmaThreads) {
    const int r = i >> 3, c = i & 7;
    const bool in = r < len;
    cp_async16(dst + swz128(r, c), src + (in ? r * rs + c * 8 : 0), in ? 16 : 0);
  }
}

// K2, K3r: rows [0, len) that stage_swz staged at `dst` rotated in place,
// row r by table row r (rotate_rows's arithmetic in the swizzled tile).
// Each thread takes the 16-byte pieces it copied itself (piece c =
// threadIdx % 8 of rows threadIdx / 8 + 16 m), so its own cp.async wait has
// landed them, four pieces' loads in flight at once; the caller's
// fence_proxy_async and barrier publish the rotated rows to wgmma. The
// zero-filled rows past len stay as they are.
__device__ __forceinline__ void rotate_swz(uint32_t dst, const bf16* __restrict__ tab, int len) {
  constexpr int kStep = kMmaThreads / 8;  // rows between a thread's pieces
  const int c = threadIdx.x & 7;
  for (int r0 = threadIdx.x >> 3; r0 < len; r0 += 4 * kStep) {
    uint4 x[4], sn[4], cs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {  // a row past len reloads the thread's first
      const int r = r0 + u * kStep < len ? r0 + u * kStep : r0;
      const uint4* t = reinterpret_cast<const uint4*>(tab + r * (2 * kWgDim) + c * 8);
      x[u] = lds16(dst + swz128(r, c));
      sn[u] = __ldg(t);
      cs[u] = __ldg(t + kWgDim / 8);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (r0 + u * kStep < len)
        sts16(dst + swz128(r0 + u * kStep, c), rotate_piece(x[u], sn[u], cs[u]));
    }
  }
}

// K1 and K4 (FLASH = false: stat_a = lse), K10 with one key block (FLASH =
// true: stat_a = l, stat_b = m) and K2 (ROPE: q and k rotated by the [n,
// 2D] table `tab`, self-attention), D = 64, nk <= 16 G. One warpgroup walks
// `iters` sub-tiles of 64 query rows with K and V staged once, computing G
// 16-key groups of scores for each; the header's note says how.
template <bool FLASH, bool ROPE, int G>
__global__ void __launch_bounds__(kMmaThreads, 2)
    wgmma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ tab,
                     bf16* __restrict__ o, float* __restrict__ stat_a,
                     float* __restrict__ stat_b, int n, int nk, int heads, Strides st,
                     float scale, int causal, int iters) {
  static_assert(!(FLASH && ROPE), "the rope forward is K2's");
  constexpr int D = kWgDim;
  constexpr int kN64 = G / 4;  // whole 64-key tiles of S (n64), then G % 4 groups (n16)
  constexpr uint32_t kQBytes = kMmaRows * (D + 8) * 2;
  constexpr uint32_t kKBytes = 16 * G * 128;  // G groups of 16 rows, 128 bytes each
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sk = (raw + 1023) & ~1023u;  // the swizzle's 1024-byte alignment
  const uint32_t sv = sk + kKBytes;
  const uint32_t sq0 = sv + kKBytes;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long hd = (long long)h * D;
  const bf16* qb = q + b * st.q_bs + hd;
  const float sl2 = scale * kLog2e;
  const int row_first = blockIdx.y * iters * kMmaRows;
  const int tiles = min(iters, (n - row_first + kMmaRows - 1) / kMmaRows);

  // the first sub-tile's Q with K, then V, whose copy overlaps S and softmax;
  // key rows nk .. 16 G - 1 zero-filled
  stage_rows<D>(sq0, qb + row_first * st.q_rs, st.q_rs, min(kMmaRows, n - row_first));
  stage_swz(sk, k + b * st.k_bs + hd, st.k_rs, nk, 16 * G);
  cp_async_commit();
  stage_swz(sv, v + b * st.v_bs + hd, st.v_rs, nk, 16 * G);
  cp_async_commit();

  for (int it = 0; it < tiles; ++it) {
    const int row0 = row_first + it * kMmaRows;
    const uint32_t sq = sq0 + (it & 1) * kQBytes;
    const bool next = it + 1 < tiles;
    if (it == 0) {
      cp_async_wait<1>();  // Q and K
      if constexpr (ROPE) rotate_swz(sk, tab, nk);  // K2: K rotated once, while V lands
      fence_proxy_async();
    } else {
      cp_async_wait<0>();
    }
    // K2: this sub-tile's Q rows rotated in place, each thread its own
    // pieces (its cp.async wait landed them), published by the barrier
    if constexpr (ROPE) rotate_rows<D>(sq, tab, row0, min(kMmaRows, n - row0));
    __syncthreads();  // Q (and K) landed; every warp is done with the other Q tile
    if (next) {  // the next sub-tile's Q copy overlaps this one
      const int r1 = row0 + kMmaRows;
      stage_rows<D>(sq0 + ((it + 1) & 1) * kQBytes, qb + r1 * st.q_rs, st.q_rs,
                    min(kMmaRows, n - r1));
      cp_async_commit();
    }

    uint32_t qf[D / 16][4];  // this warp's 16 rows, the A fragments of S
    {
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int ds = 0; ds < D / 16; ++ds)
        ldsm_x4<false>(qf[ds], sq + ((16 * warp + (mi & 1) * 8 + rr) * (D + 8) + 16 * ds +
                                     (mi >> 1) * 8) * 2);
    }

    // S = Q K^T, straight-line: runtime branches between the products made
    // ptxas copy accumulators and wait after every wgmma. Group gg (keys
    // 16 gg .. 16 gg + 15) in s[8 gg .. 8 gg + 7]; in the descriptor's
    // 16-byte units a group is 128 further, a k16 step 2.
    float s[8 * G];
    const uint64_t dk = wgmma_desc(sk, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < kN64; ++tt) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_m64n64k16<0>(s + 32 * tt, qf[ks], dk + 512 * tt + 2 * ks, ks);
    }
#pragma unroll
    for (int gg = 4 * kN64; gg < G; ++gg) {
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_m64n16k16(s + 8 * gg, qf[ks], dk + 128 * gg + 2 * ks, ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<8 * G>(s);

    // exact softmax from the registers: keys past nk and causal pairs to
    // -inf, the row max m over every key, p = 2^(s sl2 - m) once, l = sum p
    const int wrow0 = row0 + 16 * warp, r0 = wrow0 + g;  // this lane's rows: r0, r0 + 8
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2 * G; ++j) {  // 8-key chunk j: keys 8 j + 2 t + {0, 1}
      float* x = s + 4 * j;
      if (8 * j + 8 > nk || (causal && 8 * j + 7 > wrow0)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t + (e & 1);
          if (key >= nk || (causal && key > r0 + 8 * (e >> 1))) x[e] = -INFINITY;
        }
      }
      m[0] = fmaxf(m[0], fmaxf(x[0], x[1]));
      m[1] = fmaxf(m[1], fmaxf(x[2], x[3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]) * sl2;  // scale > 0
#pragma unroll
    for (int j = 0; j < 8 * G; ++j) {
      s[j] = ex2(fmaf(s[j], sl2, -m[(j >> 1) & 1]));
      l[(j >> 1) & 1] += s[j];
    }
    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = lane_sum(l[i]);
      inv[i] = 1.f / l[i];
    }

    // P = p / l rounded to bf16: the A fragments of P V (a group's chunks
    // 2 gg and 2 gg + 1), all written before the fence that the products'
    // register reads need
    uint32_t pa[G][4];
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i] * inv[i & 1], s[8 * kk + 2 * i + 1] * inv[i & 1]);
    }
    if (it == 0) {  // V landed for all
      if (next) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();
      __syncthreads();
    }

    // O = P V, one 16-key group a step (2048 bytes of V, 128 in the
    // descriptor)
    float acc[D / 2];
    const uint64_t dv = wgmma_desc(sv, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G; ++kk) wgmma_m64n64k16<1>(acc, pa[kk], dv + 128 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);

    // o through this warp's 16 rows of the Q tile, 16 bytes per store
    bf16* so = reinterpret_cast<bf16*>(wg_smem + (sq - raw)) + 16 * warp * (D + 8);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(so + g * (D + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * (D + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const int row = wrow0 + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o + b * st.o_bs + row * st.o_rs + hd + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * (D + 8) + 8 * c8);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= n) continue;
        const long long idx = (b * heads + h) * n + row;
        const float m_nat = m[i] * kLn2;
        if constexpr (FLASH) {
          stat_a[idx] = l[i];
          stat_b[idx] = m_nat;
        } else {
          stat_a[idx] = __fadd_rn(m_nat, logf(l[i]));
        }
      }
    }
  }
}

// Launches wgmma_fwd_kernel<FLASH, ROPE, G> for the least G >= `groups`
// (16-key groups of nk, 1 .. kWgKeys / 16).
template <bool FLASH, bool ROPE, int G = 1>
int launch_wgmma_fwd(const void* q, const void* k, const void* v, const void* tab, void* o,
                     float* stat_a, float* stat_b, int batch, int n, int nk, int heads,
                     const Strides& st, float scale, int causal, int groups,
                     cudaStream_t stream) {
  if constexpr (G < kWgKeys / 16) {
    if (groups > G)
      return launch_wgmma_fwd<FLASH, ROPE, G + 1>(q, k, v, tab, o, stat_a, stat_b, batch, n, nk,
                                                  heads, st, scale, causal, groups, stream);
  }
  static std::atomic<unsigned long long> done{0};
  const int smem = wg_smem_bytes(16 * G);
  const cudaError_t err = allow_smem(wgmma_fwd_kernel<FLASH, ROPE, G>, smem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kMmaRows - 1) / kMmaRows;
  const int iters = tiles < kMaxRows / kMmaRows ? tiles : kMaxRows / kMmaRows;
  const dim3 grid(batch, (tiles + iters - 1) / iters, heads);
  wgmma_fwd_kernel<FLASH, ROPE, G><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(tab), static_cast<bf16*>(o), stat_a, stat_b, n, nk, heads, st,
      scale, causal, iters);
  return static_cast<int>(cudaGetLastError());
}

// `tab`: K2's [n, 2D] rope table (ROPE), else unused. One key block of at
// most kWgKeys keys at D = 64 takes wgmma_fwd_kernel (K2 too, in its ROPE
// form), the rest mma_fwd_kernel.
template <int D, bool FLASH, bool MULTI, bool ROPE = false>
int launch_mma_fwd(const void* q, const void* k, const void* v, const void* tab, void* o,
                   float* stat_a, float* stat_b, int batch, int n, int nk, int heads,
                   const Strides& st, float scale, int causal, int blk_q, int blk_k, int nblk,
                   cudaStream_t stream) {
  if constexpr (D == kWgDim && !MULTI) {
    if (nblk == 1 && nk <= kWgKeys)
      return launch_wgmma_fwd<FLASH, ROPE>(q, k, v, tab, o, stat_a, stat_b, batch, n, nk, heads,
                                           st, scale, causal, (nk + 15) / 16, stream);
  }
  const cudaError_t err = allow_mma_smem<D, FLASH, MULTI, ROPE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one jax block (at most 256 keys when there are several) per chunk
  const int keys = blk_k < nk ? blk_k : nk;
  const int ch = keys >= kMaxChunk ? kMaxChunk : (keys + 15) & ~15;
  // K and V resident: one block walks up to kMaxRows query rows
  const int tiles = (n + kMmaRows - 1) / kMmaRows;
  const int most = nblk == 1 && nk <= ch ? kMaxRows / kMmaRows : 1;
  const int iters = tiles < most ? tiles : most;
  const dim3 grid(batch, (tiles + iters - 1) / iters, heads);
  mma_fwd_kernel<D, FLASH, MULTI, ROPE><<<grid, kMmaThreads, mma_smem_bytes<D>(ch), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(tab), static_cast<bf16*>(o), stat_a, stat_b, n, nk, heads, st,
      scale, causal, blk_q, blk_k, nblk, ch, iters);
  return static_cast<int>(cudaGetLastError());
}

// Launches the forward, the kernel chosen by type at compile time: bf16 on
// the tensor cores (mma_fwd_kernel), fp32 on the FMA rows kernel. Returns
// the cudaError_t of the launch.
template <typename T, int D, bool FLASH>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* stat_a,
               float* stat_b, int batch, int n, int nk, int heads, const Strides& st,
               float scale, int causal, int blk_q, int blk_k, int nblk, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    if constexpr (FLASH) {
      if (nblk > 1)
        return launch_mma_fwd<D, true, true>(q, k, v, nullptr, o, stat_a, stat_b, batch, n,
                                             nk, heads, st, scale, causal, blk_q, blk_k, nblk,
                                             stream);
    }
    return launch_mma_fwd<D, FLASH, false>(q, k, v, nullptr, o, stat_a, stat_b, batch, n, nk,
                                           heads, st, scale, causal, blk_q, blk_k, nblk, stream);
  } else {
    const dim3 grid(batch, (n + kTile - 1) / kTile, heads);
    rows_fwd_kernel<T, D, FLASH><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), stat_a, stat_b, n, nk, heads, st, scale, causal, blk_q, blk_k, nblk);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace
