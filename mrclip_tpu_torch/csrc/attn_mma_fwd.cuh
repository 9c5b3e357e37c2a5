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
// Four kernels, chosen by shape in launch_mma_fwd, the launcher all four
// reach, by fwd_route (the one source of the choice; the libraries' C entry
// attn_fwd_route answers it for the wrappers' launch counts by route):
//   wgmma_fwd_kernel<FLASH, ROPE, G>, on Hopper's warpgroup products
//     (wgmma.cuh): K1, K4, K10 and K2 (ROPE) with one key block of nk <=
//     256 keys at D = 64: every main-path shape of the four at D = 64 (N =
//     197, 98, 77, 64). G = ceil(nk / 16) is a template argument, one
//     instantiation per G (1..16) and ROPE: runtime branches between the
//     products made ptxas copy the accumulators and wait after every wgmma,
//     and hold 255 registers with spills.
//   wgmma_wide_fwd_kernel<D, FLASH, MULTI, G>, on warpgroup products too,
//     below: K1, K4 and K10 without rope at D = 72, 80, 88, 104 and 112 up
//     to kWideKeys = 272 keys (ViT-SO400M's towers, N 256 and 64; the
//     vision towers of ViT-H/g/bigG-14, EVA01-g-14 and EVA02-E-14 at 224
//     px, N 257), and at D = 64 from 257 to 272 keys (ViT-L-14's vision);
//     K10 past 256 keys in jax's three key blocks of 128 (MULTI).
//   wgmma_long_fwd_kernel<D, FLASH, ONE>, on warpgroup products with K and
//     V streamed by TMA, below: K1, K4 and K10 without rope, not causal, at
//     D = 64-112 past kWideKeys keys (N = 576, 577, 729, 730, 1024: the
//     336-512 px towers); ONE: K10 in one pass over jax's 128-key blocks.
//   mma_fwd_kernel<D, FLASH, MULTI, ROPE>, on Ampere's mma.sync, below:
//     causal past 272 keys (no tower's), K2 past 256 keys (the chunked walk;
//     its rope rotated in shared memory), D = 32.
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
// The wide head dims (D = 72, 80, 88, 104, 112) take mma_fwd_kernel past
// 272 keys only: mma.sync m16n8k16 steps D by 16, so 72, 88 and 104 are
// padded to P = pad16(D) = 80, 96 and 112 columns in both products (112
// takes 104's layout with no pad column), each by one 16-byte piece a row
// that stage_rows zero-fills (no source bytes); only the first D columns of
// o are stored. Rows of P + 8 elements (176, 208, 240 bytes: an odd number
// of 16-byte units) keep ldmatrix free of bank conflicts. Two blocks an SM
// (__launch_bounds__(128, 2): 212-255 registers; K10's several-block form
// spills 32 bytes at 104 and 40 at 112) and chunks of at most
// mma_max_chunk<D>() keys (288, 240, 208, 208), which leave shared memory
// for two blocks.
//
// wgmma_wide_fwd_kernel (D = 64-112, nk <= 272), designed for Hopper where
// mma_fwd_kernel took 1.41-2.6x SDPA's forward at N = 257 (PERF.md, section
// 6). Bound at EVA02-E-14's vision b256 (N = 257, H = 16, D = 112): q, k, v
// read and o written once, 947 MB: 0.2828 ms at 3.35 TB/s, against 121
// GFLOP (0.122 ms at 989 TFLOP/s): bytes; ViT-H-14's (D = 80) 0.2024 ms.
// What held mma_fwd_kernel back, and what this one does about each:
//   1. the instruction: both products run on wgmma (A in registers, B read
//      from shared memory through a descriptor), as wgmma_fwd_kernel;
//   2. re-staging: K and V of one (sample, head) go into shared memory once
//      and one block walks every 64-row sub-tile of it (N = 257: five), so
//      they leave device memory once, where mma_fwd_kernel's 240- and
//      208-key chunks read them about ten times at 88-112;
//   3. recomputed scores: S is computed once, each row's scores whole in
//      registers (8 G fp32 a thread: 136 at 272 keys), as wgmma_fwd_kernel;
//   4. registers: 110 (G = 4) to 225 (D = 112, G = 17) for K1/K4, to 216
//      for K10's one-block form, 203-254 for its several-block form
//      (-Xptxas -v in build.py's log, sm_90a), no spill;
//   5. padding: only Q K^T's depth is padded (k-steps of 16 over P); P V
//      runs with n = D itself (m64nDk16, wgmma.cuh's wgmma_m64nNk16_mn).
// Layout (wgmma.cuh): K and V in P / 16 slabs of 16 columns, each slab 16 G
// rows of 32 bytes in the 32-byte swizzle, 512-byte aligned, rows nk .. 16
// G - 1 and the pad columns zero-filled by the copies themselves (no source
// bytes). Q K^T reads K K-major, k-step s from slab s (SBO 256; LBO not
// read), on m64n64k16 over whole 64-key tiles and m64n16k16 over the 16-key
// groups of the tail (G = 17: four n64 tiles and one n16 group); P V reads V
// MN-major (transpose bit), n = D across the slabs (LBO = 16 G * 32, SBO
// 256; n = 72 reads half of the fifth slab). No shared memory is wasted on
// a part-filled 64-column slab, which the 128-byte swizzle would take: at D
// = 80 that keeps K, V and two Q tiles within two blocks an SM (110,592
// bytes at 272 keys). Q by sub-tile into rows of P + 8 elements for
// ldmatrix, the A fragments of S in registers, two tiles a warpgroup, the
// next one's copy overlapping this one; V's copy overlaps the first S.
// Softmax and outputs as wgmma_fwd_kernel's (keys >= nk and causal pairs to
// -inf, one ex2 a score, P = p * (1 / l) rounded to bf16, the TPU's order);
// K10's several-block form keeps mma_fwd_kernel's MULTI arithmetic on the
// scores in registers, block by block (multi_block), skipping a causal block
// as jax does; its block sums taken key by key in that kernel's order, it
// reads bit-equal to mma_fwd_kernel on the same inputs (o, l and m at N =
// 257, D = 64-112, on the H100: both products accumulate the same k16 steps
// in the same order). Summed in pairs, it differed by an fp32 ulp of l here
// and there, and EVA02-E-14's chaotic 64-layer gradient (chip_smoke.py phase
// 18) moved from 0.992665 to 0.988593 at its least tensor.
// Geometry, by wide_smem_bytes and wide_wgs (shared memory: 1 KB of
// alignment slack, K and V 2 * P / 16 * 16 G * 32 bytes, two Q tiles of 64 *
// (P + 8) * 2 bytes a warpgroup): one warpgroup a block, two blocks an SM,
// where two such blocks fit (D <= 80 at 272 keys: 89,088 bytes at D = 64,
// 110,592 at 72 and 80), else two warpgroups a block sharing K and V, one
// block an SM (D = 88, 104, 112 at 257 keys: 158,720 and 184,320 bytes), the
// warpgroups taking alternate sub-tiles (N = 257: three and two). K1 with
// one warpgroup at 88-112 read 19-20% slower, with two at <= 80 19-26%
// slower (tools/attn_wide_fwd_variants.py, PERF.md). Blocks are ordered
// head first, so that the blocks of neighbouring heads, whose rows lie side
// by side in the packed [B, N, H*D] slices (and at D = 72, 88 and 104, 144,
// 176 and 208 bytes, share a 32-byte sector), run together: sample first
// read K1 1-23% slower, K4's contiguous tiles within 1%.
// G (16-key groups) is a template argument: 4, 16 or 17 (the least that
// holds nk; N = 257 computes 272 keys, 64 and 256 exactly), 17 alone at D =
// 64 and for K10's several blocks. What still bounds it at 88-112: one block
// an SM, so the next (sample, head)'s 104-122 KB of K and V cannot load
// while this one's products run.
//
// wgmma_long_fwd_kernel (D = 64-112 past kWideKeys keys, not causal),
// designed for Hopper where mma_fwd_kernel took 2.2-3.0x SDPA's forward at
// the 336-512 px towers' lengths (N 577-1024, b32: PERF.md, section 6).
// Bound at SO400M-378's vision b32 (N = 729, H = 16, D = 72): 78.4 GFLOP of
// products, 79.2 us at 989 TFLOP/s (operations; 215 MB of q, k, v, o:
// 64.2 us); the two passes compute about 134 GFLOP over the 64-key tiles
// and take two exponentials a score, about 0.16 ms of the SFU. It keeps
// mma_fwd_kernel's arithmetic:
// K1 and K4 two passes (pass A the row max and the online sum, pass B S
// again and P = 2^(s sl2 - (m + log2 l)) rounded to bf16, the TPU's order;
// bit-equal to it at D = 64, where both walk 64-key tiles from key 0),
// K10 jax's key blocks of blk_k (128 or 256 keys) one after the other, a
// pass A for the block's max and a pass B for its unnormalised P, its sum
// key by key and its P V apart, then jax's update (o, l and m bit-equal to
// mma_fwd_kernel at every checked shape on the H100). Where a block is 128
// keys (N = 577) and D is at most 88, K10 runs in one pass (ONE): a thread
// holds both tiles' scores (64 fp32), takes the block's max from them and
// runs P and P V from the same registers, the same bits as the two passes
// (the same products, maxima and sums in the same order), 8-10% faster at
// D 64 and 80 (tools/attn_long_fwd_variants.py, variant k10_two_pass). At
// D 104 and 112 it spilled (44 and 128 bytes) and read 4% slower; as a
// runtime branch in the one instantiation it cost the 256-key blocks (N
// 729, 1024) 10%, hence an instantiation of its own; blocks of 256 would
// need 128 fp32 of scores a thread. What held
// mma_fwd_kernel back, and what this one does about it:
//   1. re-staging: a block of four warps took 64 rows and copied K twice
//      and V once by cp.async, in 208-288-key chunks that did not overlap
//      the products. Here one producer thread (a warpgroup that gives its
//      registers to the consumers by setmaxnreg, 40 against 232) loads by
//      TMA (cp.async.bulk.tensor, 4-D maps (D, heads, rows, batch) with the
//      views' strides, boxes of 16 columns x 64 rows in the 32-byte swizzle:
//      wgmma.cuh's slabs; the pad columns of D = 72, 88, 104 and the rows
//      past nk zero-filled by the hardware), and two consumer warpgroups of
//      64 rows share it. K stays resident in shared memory from its one load
//      (122-143 KB at every long tower's shape, beside a ring of three V
//      tiles and the Q tiles; long_smem_bytes), and a block walks the row
//      blocks of its head in turn, as few blocks a head as still give every
//      SM two, so K leaves L2 once a block and V once a row block. Where K
//      does not fit, both stream through the ring (K twice a row block).
//   2. the instruction: both products on wgmma (S = Q K^T over P / 16
//      k-steps of m64n64k16, A in registers; P V on m64nDk16 with V
//      MN-major), each batch straight-line; a warpgroup waits for each
//      batch before the softmax that reads it.
// What the timings showed (tools/attn_long_fwd_variants.py and, for the
// overlap, an A/B of two builds in one process; device ms at b32, D 72 N
// 729, PERF.md section 6): K and V streamed, one row block a block: K1
// 0.4556 and K10 0.4517 against the mma.sync route's 0.8012 and 0.6299;
// the warpgroups taking turns to issue their products (ping-pong on named
// barriers) read the same at 72 and 104 and 6-11% slower at 64 and 80;
// K resident and the row-block walk 0.4088 against 0.4808 streamed in the
// same run (15%; 19% at D 104 N 577, 7% at 64 N 577); each warpgroup
// issuing the next tile's S before this tile's softmax (FA3's overlap
// within a warpgroup, two score tiles in registers) 7-12% slower than
// waiting, at all five long shapes; two ring stages 30-45% slower, four as
// three. K1 and K10 read alike though K1 takes twice the exponentials:
// the products reach about a third of the tensor cores' rate, SDPA's own
// rate per product at these shapes, and the two passes (Q K^T twice) are
// what keeps K1 and K10 1.3-1.9x over SDPA's one-pass forward (1.4-2.4x
// faster than mma_fwd_kernel). At N = 257 the long kernel read K10 @ 104
// and 112 b256 0.8897 and 0.8781 ms against wgmma_wide_fwd_kernel's 0.6700
// and 0.6529: those stay on the wide route.
// Registers: 168 a thread at launch, no spill (-Xptxas -v).
#pragma once

#include <cuda.h>  // CUtensorMap (the encode is reached through the runtime: no -lcuda)
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
constexpr int kMaxChunk = 256;  // keys staged at once (D <= 64)
constexpr int kMaxRows = 256;   // query rows per block while K and V stay staged
// Past D = 64 the staged chunk is sized to leave two blocks an SM (228 KB of
// shared memory, 1 KB of it reserved a block), up to kMaxResident rows: N =
// 257 (ViT-L/H/g/bigG-14's vision towers) in one chunk where that fits.
constexpr int kTwoBlocksSmem = 113 * 1024;
constexpr int kMaxResident = 320;
constexpr int kWgKeys = 256;    // wgmma_fwd_kernel: the most keys, all scores in registers
constexpr int kWgDim = 64;      // wgmma_fwd_kernel's head dim: one 128-byte row
constexpr int kWideKeys = 272;  // wgmma_wide_fwd_kernel: the most keys, 17 groups of 16
constexpr int kWideTiles = 8;   // wgmma_wide_fwd_kernel: the most sub-tiles a block walks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

// Shared-memory bytes: the Q tile and `ch` rows each of K and V, rows of
// pad16(D) + 8 elements.
template <int D>
constexpr int mma_smem_bytes(int ch) {
  return (kMmaRows + 2 * ch) * (pad16(D) + 8) * 2;
}

// The most keys mma_fwd_kernel stages at once: kMaxChunk at D <= 64 (whose
// main-path shapes run wgmma; its mma.sync walks past 256 keys stay as
// they were measured), else as many as leave two blocks an SM (288 at D =
// 72 and 80, 240 at 88, 208 at 104 and 112), at most kMaxResident.
template <int D>
constexpr int mma_max_chunk() {
  if (D <= 64) return kMaxChunk;
  const int fit = ((kTwoBlocksSmem / ((pad16(D) + 8) * 2) - kMmaRows) / 2) & ~15;
  return fit < kMaxResident ? fit : kMaxResident;
}

// Sub-tiles a block walks where its staged rows serve them all: at most
// `most`, spread evenly over the fewest blocks (5 as 3 + 2, not 4 + 1).
inline int even_iters(int tiles, int most) {
  const int blocks = (tiles + most - 1) / most;
  return (tiles + blocks - 1) / blocks;
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
// into shared rows of pad16(D) + 8 elements at `dst`, by 16-byte copies;
// rows [len, len rounded up to 16) and the pad columns [D, pad16(D)) (D =
// 72, 88, 104) are zero-filled (no source bytes).
// stage_rows_by: the same copied by THREADS threads, this one `tid`.
template <int D, int THREADS>
__device__ __forceinline__ void stage_rows_by(uint32_t dst, const bf16* src, long long rs,
                                              int len, int tid) {
  constexpr int P = pad16(D);
  constexpr int kChunks = P / 8;  // 16-byte pieces per shared row
  const int rows = (len + 15) & ~15;
  for (int i = tid; i < rows * kChunks; i += THREADS) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < len && (P == D || c < D / 8);
    cp_async16(dst + (r * (P + 8) + c * 8) * 2, src + (in ? r * rs + c * 8 : 0), in ? 16 : 0);
  }
}

template <int D>
__device__ __forceinline__ void stage_rows(uint32_t dst, const bf16* src, long long rs,
                                           int len) {
  stage_rows_by<D, kMmaThreads>(dst, src, rs, len, threadIdx.x);
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
  static_assert(pad16(D) == D, "rope takes D = 32 and 64");
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
__global__ void __launch_bounds__(kMmaThreads, D > 64 ? 2 : 3)
    mma_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ tab,
                   bf16* __restrict__ o, float* __restrict__ stat_a,
                   float* __restrict__ stat_b, int n, int nk, int heads, Strides st, float scale,
                   int causal, int blk_q, int blk_k, int nblk, int ch, int iters) {
  static_assert(D == 32 || D == 64 || D == 72 || D == 80 || D == 88 || D == 104 || D == 112,
                "head dim");
  static_assert(!ROPE || D <= 64, "rope takes D = 32 and 64");
  constexpr int P = pad16(D);  // shared rows and fragments: D padded to 16 columns
  static_assert(FLASH || !MULTI, "K4 walks one key block");
  static_assert(!(FLASH && ROPE), "the rope forward is K2's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sq = reinterpret_cast<bf16*>(mma_smem);
  const uint32_t sq_a = static_cast<uint32_t>(__cvta_generic_to_shared(sq));
  const uint32_t sk_a = sq_a + kMmaRows * (P + 8) * 2;
  const uint32_t sv_a = sk_a + ch * (P + 8) * 2;

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

    uint32_t qf[P / 16][4];
    bool have_q = false;
    float acc[P / 8][4];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
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
          for (int ds = 0; ds < P / 16; ++ds)
            ldsm_x4<false>(qf[ds], sq_a + ((16 * warp + (mi & 1) * 8 + rr) * (P + 8) +
                                           16 * ds + (mi >> 1) * 8) * 2);
          have_q = true;
        }
        const int wend = min(c1, w_keys);
        for (int s0 = c0; s0 < wend; s0 += 64) {
          const bool mask = !(s0 + 64 <= c1 && (!causal || s0 + 63 <= wrow0));
          if (s0 + 64 <= wend)
            pass_a_tile<P, MULTI, true>(m, l, mb, qf, sk_a, s0 - c0, 4, s0, c1, r0, mask,
                                        causal, sl2, lane);
          else
            pass_a_tile<P, MULTI, false>(m, l, mb, qf, sk_a, s0 - c0, (wend - s0 + 15) / 16, s0,
                                         c1, r0, true, causal, sl2, lane);
        }
      }

      // pass B: P.V over the block, S recomputed from shared memory
      float mo[2], ls[2] = {0.f, 0.f};
      float cur[P / 8][4];  // MULTI: this block's P.V
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
        for (int j = 0; j < P / 8; ++j) cur[j][0] = cur[j][1] = cur[j][2] = cur[j][3] = 0.f;
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
              pass_b_tile<P, true, true>(cur, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                         r0, mask, causal, sl2, lane);
            else
              pass_b_tile<P, true, false>(cur, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                          r0, true, causal, sl2, lane);
          } else {
            if (full)
              pass_b_tile<P, false, true>(acc, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0, c1,
                                          r0, mask, causal, sl2, lane);
            else
              pass_b_tile<P, false, false>(acc, ls, mo, qf, sk_a, sv_a, s0 - c0, groups, s0,
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
          for (int j = 0; j < P / 8; ++j) {
#pragma unroll
            for (int e = 2 * i; e < 2 * i + 2; ++e)
              acc[j][e] = __fadd_rn(__fmul_rn(acc[j][e], f), __fmul_rn(cur[j][e], inv));
          }
          m[i] = mo[i];
          l[i] = l_new;
        }
      }
    }

    // o through this warp's 16 rows of the Q tile, 16 bytes per store; the
    // first D columns only
    __syncwarp();
    bf16* so = sq + 16 * warp * (P + 8);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(so + g * (P + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[j][0], acc[j][1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * (P + 8) + 8 * j + 2 * t) =
          pack_bf16(acc[j][2], acc[j][3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const int row = wrow0 + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o + b * st.o_bs + row * st.o_rs + hd + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * (P + 8) + 8 * c8);
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
  return allow_smem(mma_fwd_kernel<D, FLASH, MULTI, ROPE>, mma_smem_bytes<D>(mma_max_chunk<D>()),
                    done);
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

// Shared-memory bytes of wgmma_wide_fwd_kernel: alignment slack, K and V in
// pad16(D) / 16 slabs of 16 G rows of 32 bytes each, two Q tiles (rows of
// pad16(D) + 8 elements) for each of `wgs` warpgroups.
__host__ __device__ constexpr int wide_smem_bytes(int d, int g, int wgs) {
  return 1024 + 2 * (pad16(d) / 16) * (16 * g) * 32 + wgs * 2 * kMmaRows * (pad16(d) + 8) * 2;
}

// Warpgroups of wgmma_wide_fwd_kernel a block: one where two blocks of one
// fit an SM's shared memory (D <= 80, or few keys), else two sharing K and
// V (one block an SM: 88-112 at N = 257).
template <int D, int G>
__host__ __device__ constexpr int wide_wgs() {
  return wide_smem_bytes(D, G, 1) <= kTwoBlocksSmem ? 1 : 2;
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Rows [0, len) of one (sample, head)'s D columns (row stride rs elements)
// into the 32-byte-swizzled slabs at `dst` (wgmma.cuh: `rows` rows a slab)
// by 16-byte copies from THREADS threads, this one `tid`; rows [len, rows)
// and the pad columns [D, pad16(D)) zero-filled (no source bytes).
template <int D, int THREADS>
__device__ __forceinline__ void stage_slabs(uint32_t dst, const bf16* src, long long rs, int len,
                                            int rows, int tid) {
  constexpr int kPieces = pad16(D) / 8;  // 16-byte pieces of a row, two a slab
  for (int i = tid; i < rows * kPieces; i += THREADS) {
    const int r = i / kPieces, c = i % kPieces;
    const bool in = r < len && c < D / 8;
    cp_async16(dst + (c >> 1) * (rows * 32) + swz32(r, c & 1), src + (in ? r * rs + c * 8 : 0),
               in ? 16 : 0);
  }
}

// K10 over jax's key block of 16-key groups [G0, G1) of the scores `s`
// (MULTI; wgmma_wide_fwd_kernel's registers): the block's row max mb, the
// new max mo, p = 2^(s sl2 - mo) UNnormalised and rounded to bf16 for its
// P V (into acc for the first block), then jax's update with each product
// and sum rounded once (mma_fwd_kernel's MULTI form), where `visit` (a
// live warp, a block jax visits); a block of no visit still runs its
// products, on zero P where the warp is dead.
template <int D, int G0, int G1>
__device__ __forceinline__ void multi_block(float (&acc)[D / 2], float* s, float (&m)[2],
                                            float (&l)[2], uint64_t dv, float sl2, bool visit) {
  float mo[2], ls[2] = {0.f, 0.f};
  uint32_t pa[G1 - G0][4];
  if (visit) {
    float mb[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j8 = 2 * G0; j8 < 2 * G1; ++j8) {
      mb[0] = fmaxf(mb[0], fmaxf(s[4 * j8], s[4 * j8 + 1]));
      mb[1] = fmaxf(mb[1], fmaxf(s[4 * j8 + 2], s[4 * j8 + 3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) mo[i] = fmaxf(m[i], quad_max(mb[i]) * sl2);
#pragma unroll
    for (int kk = G0; kk < G1; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* x = s + 8 * kk + 2 * i;
        x[0] = ex2(fmaf(x[0], sl2, -mo[i & 1]));
        x[1] = ex2(fmaf(x[1], sl2, -mo[i & 1]));
        ls[i & 1] += x[0];  // key by key, mma_fwd_kernel's order
        ls[i & 1] += x[1];
        pa[kk - G0][i] = pack_bf16(x[0], x[1]);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < G1 - G0; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
  }
  float cur[D / 2];  // this block's P V
  float* dst = G0 == 0 ? acc : cur;
  wgmma_fence();
#pragma unroll
  for (int kk = G0; kk < G1; ++kk) wgmma_m64nNk16_mn<D>(dst, pa[kk - G0], dv + 32 * kk, kk - G0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(dst);
  if (!visit) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_blk = lane_sum(ls[i]);
    const float l_corr = mo[i] == -INFINITY ? 0.f : __fmul_rn(ex2(m[i] - mo[i]), l[i]);
    const float l_new = __fadd_rn(l_blk, l_corr);
    const float inv = l_new == 0.f ? 1.f : __fdiv_rn(1.f, l_new);
    const float f = __fmul_rn(l_corr, inv);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e) {
        float& a = acc[4 * jj + e];
        if constexpr (G0 == 0) {
          a = __fmul_rn(a, inv);  // jax: 0 * f + acc * inv
        } else {
          a = __fadd_rn(__fmul_rn(a, f), __fmul_rn(cur[4 * jj + e], inv));
        }
      }
    }
    m[i] = mo[i];
    l[i] = l_new;
  }
}

// K1 and K4 (FLASH = false: stat_a = lse) and K10 (FLASH: stat_a = l,
// stat_b = m) without rope at D = 64-112 and nk <= 16 G <= kWideKeys: one
// key block (MULTI = false), or jax's key blocks of 128 (MULTI: K10 at nk =
// 257 .. 272). Each of the block's warpgroups walks every WGS-th of its
// `iters` sub-tiles of 64 query rows of one (sample, head), K and V staged
// once for all; the header's note says how.
template <int D, bool FLASH, bool MULTI, int G>
__global__ void __launch_bounds__(wide_wgs<D, G>() * kMmaThreads, wide_wgs<D, G>() == 1 ? 2 : 1)
    wgmma_wide_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ stat_a, float* __restrict__ stat_b, int n, int nk,
                          int heads, Strides st, float scale, int causal, int blk_q, int iters) {
  static_assert(FLASH || !MULTI, "K1 and K4 walk one key block");
  constexpr int P = pad16(D);  // Q K^T's depth; P V's n is D itself
  constexpr int WGS = wide_wgs<D, G>();
  constexpr int kThreads = WGS * kMmaThreads;
  constexpr int R = 16 * G;                  // staged key rows
  constexpr uint32_t kSlab = R * 32;         // one 16-column slab of K or V
  constexpr uint32_t kKBytes = P / 16 * kSlab;
  constexpr uint32_t kQBytes = kMmaRows * (P + 8) * 2;
  constexpr int kN64 = G / 4;                // whole 64-key tiles of S (n64), then G % 4 groups (n16)
  constexpr int kBlk = 8;                    // MULTI: groups of one jax key block of 128
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + kKBytes;

  const int wg = threadIdx.x / kMmaThreads, tid = threadIdx.x % kMmaThreads;
  const uint32_t sq0 = sv + kKBytes + wg * 2 * kQBytes;  // this warpgroup's two Q tiles
  const long long b = blockIdx.x / heads;  // heads fastest: neighbouring heads share
  const int h = blockIdx.x % heads;        // sectors of each row (odd D / 8)
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long hd = (long long)h * D;
  const bf16* qb = q + b * st.q_bs + hd;
  const float sl2 = scale * kLog2e;
  const int row_first = blockIdx.y * iters * kMmaRows;
  const int tiles = min(iters, (n - row_first + kMmaRows - 1) / kMmaRows);
  const int mine = tiles > wg ? (tiles - wg + WGS - 1) / WGS : 0;  // sub-tiles wg, wg + WGS, ...

  // each warpgroup's first Q tile with K, then V, whose copy overlaps the
  // first S and softmax; key rows nk .. R - 1 zero-filled
  if (mine > 0) {
    const int r0 = row_first + wg * kMmaRows;
    stage_rows_by<D, kMmaThreads>(sq0, qb + r0 * st.q_rs, st.q_rs, min(kMmaRows, n - r0), tid);
  }
  stage_slabs<D, kThreads>(sk, k + b * st.k_bs + hd, st.k_rs, nk, R, threadIdx.x);
  cp_async_commit();
  stage_slabs<D, kThreads>(sv, v + b * st.v_bs + hd, st.v_rs, nk, R, threadIdx.x);
  cp_async_commit();
  cp_async_wait<1>();
  fence_proxy_async();
  __syncthreads();  // K and the first Q tiles landed

  const uint64_t dk = wgmma_desc(sk, 16, 256, kSwizzle32);
  const uint64_t dv = wgmma_desc(sv, kSlab, 256, kSwizzle32);
  for (int j = 0; j < mine; ++j) {
    const int row0 = row_first + (j * WGS + wg) * kMmaRows;
    const uint32_t sq = sq0 + (j & 1) * kQBytes;
    const bool next = j + 1 < mine;
    if (j > 0) {
      cp_async_wait<0>();
      bar_sync(2 + wg, kMmaThreads);  // Q landed; the warpgroup is done with the other tile
    }
    if (next) {  // the next sub-tile's Q copy overlaps this one
      const int r1 = row0 + WGS * kMmaRows;
      stage_rows_by<D, kMmaThreads>(sq0 + ((j + 1) & 1) * kQBytes, qb + r1 * st.q_rs, st.q_rs,
                                    min(kMmaRows, n - r1), tid);
      cp_async_commit();
    }

    uint32_t qf[P / 16][4];  // this warp's 16 rows, the A fragments of S
    {
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int ds = 0; ds < P / 16; ++ds)
        ldsm_x4<false>(qf[ds], sq + ((16 * warp + (mi & 1) * 8 + rr) * (P + 8) + 16 * ds +
                                     (mi >> 1) * 8) * 2);
    }

    // S = Q K^T, straight-line, over P / 16 k-steps (slab ks is step ks);
    // in the descriptor's 16-byte units a slab is kSlab / 16 further, a
    // 16-key group 32, a 64-key tile 128
    float s[8 * G];
    wgmma_fence();
#pragma unroll
    for (int tt = 0; tt < kN64; ++tt) {
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
        wgmma_m64n64k16<0>(s + 32 * tt, qf[ks], dk + ks * (kSlab / 16) + 128 * tt, ks);
    }
#pragma unroll
    for (int gg = 4 * kN64; gg < G; ++gg) {
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
        wgmma_m64n16k16(s + 8 * gg, qf[ks], dk + ks * (kSlab / 16) + 32 * gg, ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<8 * G>(s);

    // keys past nk and causal pairs to -inf
    const int wrow0 = row0 + 16 * warp, r0 = wrow0 + g;  // this lane's rows: r0, r0 + 8
#pragma unroll
    for (int j8 = 0; j8 < 2 * G; ++j8) {  // 8-key chunk j8: keys 8 j8 + 2 t + {0, 1}
      if (8 * j8 + 8 > nk || (causal && 8 * j8 + 7 > wrow0)) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j8 + 2 * t + (e & 1);
          if (key >= nk || (causal && key > r0 + 8 * (e >> 1))) s[4 * j8 + e] = -INFINITY;
        }
      }
    }
    if (j == 0) {  // V landed for the whole block (its copy overlapped S)
      if (next) {
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      fence_proxy_async();
      bar_sync(1, kThreads);
    }

    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m to base 2
    float acc[D / 2];
    if constexpr (!MULTI) {
      // the exact softmax: the row max m over every key, p = 2^(s sl2 - m)
      // once, l = sum p, P = p * (1 / l) rounded to bf16: the A fragments
      // of P V (a group's chunks 2 gg and 2 gg + 1). Every warp takes it:
      // skipping the warps whose rows all lie past n (N = 257's fifth
      // sub-tile) held s and P apart and spilled at D = 104 and 112
#pragma unroll
      for (int j8 = 0; j8 < 2 * G; ++j8) {
        m[0] = fmaxf(m[0], fmaxf(s[4 * j8], s[4 * j8 + 1]));
        m[1] = fmaxf(m[1], fmaxf(s[4 * j8 + 2], s[4 * j8 + 3]));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) m[i] = quad_max(m[i]) * sl2;  // scale > 0
#pragma unroll
      for (int jj = 0; jj < 8 * G; ++jj) {
        s[jj] = ex2(fmaf(s[jj], sl2, -m[(jj >> 1) & 1]));
        l[(jj >> 1) & 1] += s[jj];
      }
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] = lane_sum(l[i]);
        inv[i] = 1.f / l[i];
      }
      uint32_t pa[G][4];
#pragma unroll
      for (int kk = 0; kk < G; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = pack_bf16(s[8 * kk + 2 * i] * inv[i & 1], s[8 * kk + 2 * i + 1] * inv[i & 1]);
      }
      // O = P V on m64nDk16, one 16-key group a step (V read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G; ++kk) wgmma_m64nNk16_mn<D>(acc, pa[kk], dv + 32 * kk, kk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
    } else {
      // jax's walk over its key blocks of 128 keys, S computed once
      // (multi_block); a causal block wholly above the diagonal of the
      // sub-tile's jax query block is skipped as jax skips it, and a warp
      // whose 16 rows all lie past n (N = 257's fifth sub-tile) takes no
      // softmax (here it spills nothing and gains 14% at D = 112)
      const bool live = wrow0 < n;
      const int qblk = row0 / blk_q;  // kMmaRows divides blk_q
      constexpr int kB1 = G < kBlk ? G : kBlk, kB2 = G < 2 * kBlk ? G : 2 * kBlk;
      multi_block<D, 0, kB1>(acc, s, m, l, dv, sl2, live);
      if constexpr (G > kBlk)
        multi_block<D, kBlk, kB2>(acc, s, m, l, dv, sl2,
                                  live && (!causal || (qblk + 1) * blk_q - 1 > 16 * kBlk));
      if constexpr (G > 2 * kBlk)
        multi_block<D, 2 * kBlk, G>(acc, s, m, l, dv, sl2,
                                    live && (!causal || (qblk + 1) * blk_q - 1 > 32 * kBlk));
      static_assert(G <= 3 * kBlk, "three jax key blocks at most");
    }

    // o through this warp's 16 rows of the Q tile, 16 bytes per store; the
    // first D columns only
    bf16* so = reinterpret_cast<bf16*>(wg_smem + (sq - raw)) + 16 * warp * (P + 8);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(so + g * (P + 8) + 8 * jj + 2 * t) =
          pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * (P + 8) + 8 * jj + 2 * t) =
          pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const int row = wrow0 + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o + b * st.o_bs + row * st.o_rs + hd + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * (P + 8) + 8 * c8);
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
  if (mine == 0) {  // a warpgroup with no sub-tile still publishes its share of V
    cp_async_wait<0>();
    fence_proxy_async();
    bar_sync(1, kThreads);
  }
}

// Launches wgmma_wide_fwd_kernel<D, FLASH, MULTI, G>: one block a (sample,
// head) where it has at most kWideTiles sub-tiles (every routed shape),
// else the sub-tiles spread evenly over the fewest blocks.
template <int D, bool FLASH, bool MULTI, int G>
int launch_wide_fwd_g(const void* q, const void* k, const void* v, void* o, float* stat_a,
                      float* stat_b, int batch, int n, int nk, int heads, const Strides& st,
                      float scale, int causal, int blk_q, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  constexpr int kSmem = wide_smem_bytes(D, G, wide_wgs<D, G>());
  const cudaError_t err = allow_smem(wgmma_wide_fwd_kernel<D, FLASH, MULTI, G>, kSmem, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + kMmaRows - 1) / kMmaRows;
  const int iters = even_iters(tiles, kWideTiles);
  const dim3 grid(batch * heads, (tiles + iters - 1) / iters);
  wgmma_wide_fwd_kernel<D, FLASH, MULTI, G>
      <<<grid, wide_wgs<D, G>() * kMmaThreads, kSmem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
          static_cast<bf16*>(o), stat_a, stat_b, n, nk, heads, st, scale, causal, blk_q, iters);
  return static_cast<int>(cudaGetLastError());
}

// The wide route's instantiations: G = 4, 16 or 17 16-key groups, the
// least that holds nk (64, 256, 272 keys: the routed main-path shapes N =
// 64, 256 and 257 compute 64, 256 and 272; a G = 8 step for 65-128 keys
// cost build time and served no main path); K10 with one key block holds
// at most 256 keys (G = 4, 16); D = 64 and jax's several key blocks (K10)
// take the wide route only past 256 keys, so G = 17 alone. MULTI walks
// jax's blocks of 128 keys: nblk = 3 at nk = 257 .. 272.
template <int D, bool FLASH, bool MULTI>
int launch_wide_fwd(const void* q, const void* k, const void* v, void* o, float* stat_a,
                    float* stat_b, int batch, int n, int nk, int heads, const Strides& st,
                    float scale, int causal, int blk_q, int blk_k, int nblk,
                    cudaStream_t stream) {
  const int groups = (nk + 15) / 16;
#define MRCLIP_WIDE(G)                                                                           \
  return launch_wide_fwd_g<D, FLASH, MULTI, G>(q, k, v, o, stat_a, stat_b, batch, n, nk, heads, \
                                               st, scale, causal, blk_q, stream)
  if constexpr (MULTI) {
    if (blk_k != 128 || nblk != 3 || groups > 17) return static_cast<int>(cudaErrorInvalidValue);
    MRCLIP_WIDE(17);
  } else if constexpr (D == kWgDim) {
    if constexpr (FLASH) {  // one jax block holds at most 256 keys: wgmma_fwd_kernel's
      return static_cast<int>(cudaErrorInvalidValue);
    } else {
      if (groups <= 16 || groups > 17) return static_cast<int>(cudaErrorInvalidValue);
      MRCLIP_WIDE(17);
    }
  } else {
    if (groups <= 4) MRCLIP_WIDE(4);
    if (groups <= 16) MRCLIP_WIDE(16);
    if constexpr (!FLASH) {
      if (groups <= 17) MRCLIP_WIDE(17);
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MRCLIP_WIDE
}

// wgmma_long_fwd_kernel's ring: the mbarriers (a full and an empty one a
// stage) and the TMA loads that fill it.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of TMA transactions this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed (a
// barrier just initialised counts the phase before its first as done).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of the 4-D tensor map `map` at coordinates (c0, c1, c2, c3) into
// shared memory at `dst`, its bytes counted on the barrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

constexpr int kLongRows = 2 * kMmaRows;  // query rows a block: two consumer warpgroups
constexpr int kLongKeys = 64;            // keys a tile of the ring
constexpr int kLongStages = 3;           // tiles in flight
constexpr int kLongConsumers = 2 * kMmaThreads;
constexpr int kLongThreads = kLongConsumers + kMmaThreads;  // and a producer warpgroup
// Registers a thread after setmaxnreg: 12 warps a block cap each at 168,
// which spilled K10's several-block form at D = 104 and 112; the producer
// gives the consumers its share (128 x 40 + 256 x 232 <= 65,536)
constexpr int kLongProducerRegs = 40;
constexpr int kLongConsumerRegs = 232;
// K10's one-pass form (ONE): a jax block of at most kLongHeld tiles (128
// keys: N 577) whose scores a thread holds at once (32 fp32 a tile), up to
// head dim kLongOneDim (past it the form spilled, 44 bytes at D = 104 and
// 128 at 112)
constexpr int kLongHeld = 2;
constexpr int kLongOneDim = 88;

// wgmma_long_fwd_kernel: issues S = Q K^T of the K tile at `sk` (P / 16
// slabs of kLongKeys rows) into `s`, straight-line over the k-steps (slab
// ks is step ks), as one commit group.
template <int P>
__device__ __forceinline__ void long_issue_scores(float (&s)[32], const uint32_t (&qf)[P / 16][4],
                                                  uint32_t sk) {
  const uint64_t dk = wgmma_desc(sk, 16, 256, kSwizzle32);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < P / 16; ++ks)
    wgmma_m64n64k16<0>(s, qf[ks], dk + ks * (kLongKeys * 32 / 16), ks);
  wgmma_commit();
}

// Issues acc += P V of the V tile at `sv` on m64nDk16, one 16-key group a
// step, V read MN-major, as one commit group.
template <int D>
__device__ __forceinline__ void long_issue_pv(float* acc, const uint32_t (&pa)[kLongKeys / 16][4],
                                              uint32_t sv) {
  const uint64_t dv = wgmma_desc(sv, kLongKeys * 32, 256, kSwizzle32);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kLongKeys / 16; ++kk) wgmma_m64nNk16_mn<D>(acc, pa[kk], dv + 32 * kk, 1);
  wgmma_commit();
}

// The tile's scores once their products landed: keys at or past nk (the
// tile starts at key s0) to -inf.
__device__ __forceinline__ void long_mask(float (&s)[32], int s0, int nk, int t) {
  fence_regs<32>(s);
  if (s0 + kLongKeys > nk) {
#pragma unroll
    for (int j8 = 0; j8 < kLongKeys / 8; ++j8) {  // 8-key chunk j8: keys 8 j8 + 2 t + {0, 1}
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (s0 + 8 * j8 + 2 * t + (e & 1) >= nk) s[4 * j8 + e] = -INFINITY;
    }
  }
}

// Pass A over one tile's scores: the rows' max m (base 2: s sl2) and the
// online sum l of 2^(s sl2 - m) (K1, K4; mma_fwd_kernel's pass_a_tile), or
// the key block's max mb (FLASH).
template <bool FLASH>
__device__ __forceinline__ void long_stats(const float (&s)[32], float (&m)[2], float (&l)[2],
                                           float (&mb)[2], float sl2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) mx = fmaxf(mx, fmaxf(s[4 * j8 + 2 * i], s[4 * j8 + 2 * i + 1]));
    mx = quad_max(mx) * sl2;  // scale > 0: the max of the scaled scores
    if constexpr (FLASH) {
      mb[i] = fmaxf(mb[i], mx);
    } else {
      const float m_new = fmaxf(m[i], mx);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {  // masked keys: ex2(-inf) = 0
        sum0 += ex2(fmaf(s[4 * j8 + 2 * i], sl2, -m_new));
        sum1 += ex2(fmaf(s[4 * j8 + 2 * i + 1], sl2, -m_new));
      }
      l[i] = fmaf(l[i], ex2(m[i] - m_new), sum0 + sum1);
      m[i] = m_new;
    }
  }
}

// Pass B over one tile's scores: p = 2^(s sl2 - mo) rounded to bf16 into
// the A fragments of P V (a 16-key group's chunks 2 kk and 2 kk + 1); FLASH
// adds p to the block's sum ls key by key (mma_fwd_kernel's order).
template <bool FLASH>
__device__ __forceinline__ void long_probs(uint32_t (&pa)[kLongKeys / 16][4], float (&s)[32],
                                           const float (&mo)[2], float (&ls)[2], float sl2) {
#pragma unroll
  for (int jj = 0; jj < 32; ++jj) {
    s[jj] = ex2(fmaf(s[jj], sl2, -mo[(jj >> 1) & 1]));
    if constexpr (FLASH) ls[(jj >> 1) & 1] += s[jj];
  }
#pragma unroll
  for (int kk = 0; kk < kLongKeys / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  }
}

// K10's update of (acc, m, l) by a key block's P V `cur`, its max mo and
// its row sums ls (this lane's part): jax's, each product and sum rounded
// once (mma_fwd_kernel's MULTI form, acc starting at 0).
template <int D>
__device__ __forceinline__ void long_flash_update(float* acc, const float* cur, float (&m)[2],
                                                  float (&l)[2], const float (&mo)[2],
                                                  const float (&ls)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_blk = lane_sum(ls[i]);
    const float l_corr = mo[i] == -INFINITY ? 0.f : __fmul_rn(ex2(m[i] - mo[i]), l[i]);
    const float l_new = __fadd_rn(l_blk, l_corr);
    const float inv = l_new == 0.f ? 1.f : __fdiv_rn(1.f, l_new);
    const float f = __fmul_rn(l_corr, inv);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
#pragma unroll
      for (int e = 2 * i; e < 2 * i + 2; ++e)
        acc[4 * jj + e] = __fadd_rn(__fmul_rn(acc[4 * jj + e], f), __fmul_rn(cur[4 * jj + e], inv));
    }
    m[i] = mo[i];
    l[i] = l_new;
  }
}

// The ring's stage after `stage` (and its phase parity after `phase`), in a
// ring of STAGES stages.
template <int STAGES = kLongStages>
__device__ __forceinline__ void ring_next(int& stage, uint32_t& phase) {
  if (++stage == STAGES) {
    stage = 0;
    phase ^= 1;
  }
}

// Shared-memory bytes of wgmma_long_fwd_kernel with `tiles` K tiles
// resident (0: K streamed through the ring beside V): alignment slack, the
// resident K tiles, the ring (a stage: V's tile, and K's when streamed;
// kLongKeys rows of pad16(D) / 16 slabs of 32 bytes each), a Q tile (rows
// of pad16(D) + 8 elements) a warpgroup, a full and an empty barrier a
// stage and one a resident K tile.
__host__ __device__ constexpr int long_smem_bytes(int d, int tiles) {
  return 1024 + (tiles + kLongStages * (tiles ? 1 : 2)) * (pad16(d) / 16) * kLongKeys * 32 +
         2 * kMmaRows * (pad16(d) + 8) * 2 + (2 * kLongStages + tiles) * 8;
}

constexpr int kMaxSmem = 232448;  // the most dynamic shared memory a block takes (227 KB)

// K1 and K4 (FLASH = false: stat_a = lse) and K10 (FLASH: stat_a = l,
// stat_b = m) without rope, not causal, at D = 64-112 past kWideKeys keys;
// ONE (K10 with K resident, jax blocks of at most kLongHeld tiles): one pass
// a block.
// A block takes `iters` row blocks of kLongRows query rows of one (sample,
// head) in turn, two consumer warpgroups of 64 rows, and walks the keys per
// segment (the whole key range for K1 and K4; each of jax's `segs` key
// blocks of `seg_keys` keys for K10) twice: pass A over K, pass B over K
// and V, in tiles of kLongKeys keys that one producer thread loads by TMA.
// `resident`: K's tiles stay in shared memory from their one load for every
// pass and row block, V's go through a ring of kLongStages stages; else
// both go through the ring, K twice a row block. The header's note says
// how.
template <int D, bool FLASH, bool ONE>
__global__ void __launch_bounds__(kLongThreads, 1)
    wgmma_long_fwd_kernel(__grid_constant__ const CUtensorMap tm_k,
                          __grid_constant__ const CUtensorMap tm_v, const bf16* __restrict__ q,
                          bf16* __restrict__ o, float* __restrict__ stat_a,
                          float* __restrict__ stat_b, int n, int nk, int heads, Strides st,
                          float scale, int seg_keys, int segs, int iters, int resident) {
  constexpr int P = pad16(D);                     // Q K^T's depth; P V's n is D itself
  constexpr int kSlabs = P / 16;
  constexpr uint32_t kSlab = kLongKeys * 32;      // one 16-column slab of a tile
  constexpr uint32_t kTileBytes = kSlabs * kSlab;  // K's (or V's) tile
  constexpr uint32_t kQBytes = kMmaRows * (P + 8) * 2;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const int ktiles = (nk + kLongKeys - 1) / kLongKeys;
  const int kept = resident ? ktiles : 0;                         // K tiles resident
  const uint32_t stage_bytes = resident ? kTileBytes : 2 * kTileBytes;  // V, or K then V
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t kres = (raw + 1023) & ~1023u;           // resident K tile j at kres + j kTileBytes
  const uint32_t ring = kres + kept * kTileBytes;        // stage s at ring + s stage_bytes
  const uint32_t sq0 = ring + kLongStages * stage_bytes;
  const uint32_t full = sq0 + 2 * kQBytes;               // full[s] at full + 8 s
  const uint32_t empty = full + 8 * kLongStages;         // empty[s] at empty + 8 s
  const uint32_t kbar = empty + 8 * kLongStages;         // resident K tile j's at kbar + 8 j

  // blocks of one (sample, head) side by side, so that those reading its K
  // and V run together and find them in L2; the block's row blocks from
  // first_rb on
  const int rows_blocks = (n + kLongRows - 1) / kLongRows;
  const int per_head = (rows_blocks + iters - 1) / iters;
  const int first_rb = (blockIdx.x % per_head) * iters;
  const int my_iters = min(iters, rows_blocks - first_rb);
  const int bh = blockIdx.x / per_head;
  const int head = bh % heads;
  const long long smp = bh / heads;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLongStages; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(empty + 8 * s, kLongConsumers / 32);  // every consumer warp
    }
    for (int j = 0; j < kept; ++j) mbar_init(kbar + 8 * j, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wid >= kLongConsumers / 32) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLongProducerRegs));
    if (threadIdx.x == kLongConsumers) {
      for (int j = 0; j < kept; ++j) {  // resident K, once, in key order
        mbar_expect_tx(kbar + 8 * j, kTileBytes);
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(kres + j * kTileBytes + c * kSlab, &tm_k, kbar + 8 * j, 16 * c, head,
                      j * kLongKeys, static_cast<int>(smp));
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0; it < my_iters; ++it) {
        for (int sg = 0; sg < segs; ++sg) {
          const int kb0 = sg * seg_keys, kb1 = min(nk, kb0 + seg_keys);
          for (int pass = resident ? 1 : 0; pass < 2; ++pass) {  // A: K; B: K (streamed) and V
            for (int s0 = kb0; s0 < kb1; s0 += kLongKeys) {
              mbar_wait(empty + 8 * stage, phase ^ 1);
              const uint32_t bar = full + 8 * stage, dst = ring + stage * stage_bytes;
              mbar_expect_tx(bar, pass && !resident ? 2 * kTileBytes : kTileBytes);
              if (!resident) {
                for (int c = 0; c < kSlabs; ++c)
                  tma_load_4d(dst + c * kSlab, &tm_k, bar, 16 * c, head, s0,
                              static_cast<int>(smp));
              }
              if (pass) {
                const uint32_t dv = dst + (resident ? 0 : kTileBytes);
                for (int c = 0; c < kSlabs; ++c)
                  tma_load_4d(dv + c * kSlab, &tm_v, bar, 16 * c, head, s0, static_cast<int>(smp));
              }
              ring_next(stage, phase);
            }
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kLongConsumerRegs));
  const int wg = wid >> 2, warp = wid & 3, tid = threadIdx.x & (kMmaThreads - 1);
  const int g = lane >> 2, t = lane & 3;
  const long long hd = (long long)head * D;
  const uint32_t sq = sq0 + wg * kQBytes;
  const float sl2 = scale * kLog2e;
  int stage = 0;  // the ring's oldest stage this warpgroup holds, and its phase
  uint32_t phase = 0;
  const auto release = [&]() {  // this warp is done with `stage`
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    ring_next(stage, phase);
  };
  // K tile j (key j kLongKeys on) of pass A once it has landed; streamed,
  // the ring's stage `stage`, released once its S has landed
  const auto k_ready = [&](int j) {
    if (resident) {
      mbar_wait(kbar + 8 * j, 0);
      return kres + j * kTileBytes;
    }
    mbar_wait(full + 8 * stage, phase);
    return ring + stage * stage_bytes;
  };

  for (int it = 0; it < my_iters; ++it) {
    // this warpgroup's 64 query rows' Q as the A fragments of S (once every
    // warp has stored its o rows of the last row block through the tile)
    const int row0 = (first_rb + it) * kLongRows + wg * kMmaRows;
    bar_sync(1 + wg, kMmaThreads);
    stage_rows_by<D, kMmaThreads>(sq, q + smp * st.q_bs + row0 * st.q_rs + hd, st.q_rs,
                                  min(kMmaRows, n - row0), tid);
    cp_async_commit();
    cp_async_wait<0>();
    bar_sync(1 + wg, kMmaThreads);
    uint32_t qf[P / 16][4];
    {
      const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
      for (int ds = 0; ds < P / 16; ++ds)
        ldsm_x4<false>(qf[ds], sq + ((16 * warp + (mi & 1) * 8 + rr) * (P + 8) + 16 * ds +
                                     (mi >> 1) * 8) * 2);
    }

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // m to base 2

    for (int sg = 0; sg < segs; ++sg) {
      const int kb0 = sg * seg_keys, kb1 = min(nk, kb0 + seg_keys);
      const int j0 = kb0 / kLongKeys, tiles = (kb1 - kb0 + kLongKeys - 1) / kLongKeys;
      if constexpr (ONE) {
        // K10 in one pass, the block's scores in registers: S of every
        // tile, the block's max mb, then P and P V tile by tile, as pass B
        // would from the same S (the same bits)
        float sb[kLongHeld][32];
#pragma unroll
        for (int i = 0; i < kLongHeld; ++i) {
          if (i < tiles) {
            long_issue_scores<P>(sb[i], qf, k_ready(j0 + i));
          } else {
#pragma unroll
            for (int jj = 0; jj < 32; ++jj) sb[i][jj] = -INFINITY;
          }
        }
        wgmma_wait<0>();
        float mb[2] = {-INFINITY, -INFINITY}, mo[2], ls[2] = {0.f, 0.f}, cur[D / 2];
#pragma unroll
        for (int i = 0; i < kLongHeld; ++i) {
          long_mask(sb[i], kb0 + i * kLongKeys, nk, t);
          long_stats<true>(sb[i], m, l, mb, sl2);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) mo[i] = fmaxf(m[i], mb[i]);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) cur[j] = 0.f;
#pragma unroll
        for (int i = 0; i < kLongHeld; ++i) {
          if (i < tiles) {  // V's tile in the ring's stage
            mbar_wait(full + 8 * stage, phase);
            uint32_t pa[kLongKeys / 16][4];
            long_probs<true>(pa, sb[i], mo, ls, sl2);
            long_issue_pv<D>(cur, pa, ring + stage * stage_bytes);
            wgmma_wait<0>();
            fence_regs<D / 2>(cur);
            release();
          }
        }
        long_flash_update<D>(acc, cur, m, l, mo, ls);
        continue;
      }
      // pass A: m and the online l (K1, K4), or the key block's max mb (K10)
      float mb[2] = {-INFINITY, -INFINITY};
      for (int i = 0; i < tiles; ++i) {
        float s[32];
        long_issue_scores<P>(s, qf, k_ready(j0 + i));
        wgmma_wait<0>();
        long_mask(s, kb0 + i * kLongKeys, nk, t);
        if (!resident) release();
        long_stats<FLASH>(s, m, l, mb, sl2);
      }

      // pass B: S again, p = 2^(s sl2 - mo) rounded to bf16, P V. K1, K4:
      // mo = m + log2 l (P normalised, then rounded: the TPU's order); K10:
      // mo = the new max, P unnormalised, its sum ls taken key by key and
      // the block's P V apart (cur), for jax's update
      float mo[2], ls[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (FLASH) {
          mo[i] = fmaxf(m[i], mb[i]);
        } else {
          l[i] = lane_sum(l[i]);
          mo[i] = m[i] + log2f(l[i]);
        }
      }
      float cur[FLASH ? D / 2 : 1];
      if constexpr (FLASH) {
#pragma unroll
        for (int j = 0; j < D / 2; ++j) cur[j] = 0.f;
      }
      float* dst = FLASH ? cur : acc;
      for (int i = 0; i < tiles; ++i) {  // K resident, or K then V in the ring's stage
        mbar_wait(full + 8 * stage, phase);
        const uint32_t kv = ring + stage * stage_bytes;
        float s[32];
        long_issue_scores<P>(s, qf, resident ? kres + (j0 + i) * kTileBytes : kv);
        wgmma_wait<0>();
        long_mask(s, kb0 + i * kLongKeys, nk, t);
        uint32_t pa[kLongKeys / 16][4];
        long_probs<FLASH>(pa, s, mo, ls, sl2);
        long_issue_pv<D>(dst, pa, resident ? kv : kv + kTileBytes);
        wgmma_wait<0>();
        fence_regs<D / 2>(dst);
        release();
      }

      if constexpr (FLASH) long_flash_update<D>(acc, cur, m, l, mo, ls);
    }

    // o through this warp's 16 rows of the Q tile, 16 bytes per store; the
    // first D columns only; rows >= n store nothing
    const int wrow0 = row0 + 16 * warp, r0 = wrow0 + g;  // this lane's rows: r0, r0 + 8
    bf16* so = reinterpret_cast<bf16*>(wg_smem + (sq - raw)) + 16 * warp * (P + 8);
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      *reinterpret_cast<uint32_t*>(so + g * (P + 8) + 8 * jj + 2 * t) =
          pack_bf16(acc[4 * jj], acc[4 * jj + 1]);
      *reinterpret_cast<uint32_t*>(so + (g + 8) * (P + 8) + 8 * jj + 2 * t) =
          pack_bf16(acc[4 * jj + 2], acc[4 * jj + 3]);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * (D / 8); i += 32) {
      const int r = i / (D / 8), c8 = i % (D / 8);
      const int row = wrow0 + r;
      if (row < n)
        *reinterpret_cast<uint4*>(o + smp * st.o_bs + row * st.o_rs + hd + 8 * c8) =
            *reinterpret_cast<const uint4*>(so + r * (P + 8) + 8 * c8);
    }
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + 8 * i;
        if (row >= n) continue;
        const long long idx = (smp * heads + head) * n + row;
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

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (no -lcuda
// on the link line); null where libcuda lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The TMA map of one operand, K or V, as a 4-D tensor (D, heads, rows,
// batch) with the view's row and batch strides (elements) and contiguous
// heads: a box is 16 columns of kLongKeys rows of one (sample, head), in the
// 32-byte swizzle of wgmma.cuh's slabs; columns past D (the pad of D = 72,
// 88, 104) and rows past `rows` are zero-filled. Every stride is a multiple
// of 16 bytes (the wrappers' check_rows_aligned_16). False where libcuda
// refuses it.
inline bool long_tensor_map(CUtensorMap* map, const void* base, int d, int heads, int rows,
                            int batch, long long rs, long long bs) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, static_cast<cuuint64_t>(rs) * 2,
                                 static_cast<cuuint64_t>(bs) * 2};
  const cuuint32_t box[4] = {16, 1, kLongKeys, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// long_tensor_map through a cache of the last kMapCache maps this host
// thread encoded, keyed by all that a map encodes (the pointer, the shape
// and the strides: no data), so that the served path's repeated launches
// encode none.
constexpr int kMapCache = 16;

inline bool cached_tensor_map(CUtensorMap* map, const void* base, int d, int heads, int rows,
                              int batch, long long rs, long long bs) {
  struct Key {
    const void* base;
    int d, heads, rows, batch;
    long long rs, bs;
  };
  thread_local Key keys[kMapCache];
  thread_local CUtensorMap maps[kMapCache];
  thread_local int filled = 0, next = 0;
  for (int i = 0; i < filled; ++i) {
    const Key& k = keys[i];
    if (k.base == base && k.d == d && k.heads == heads && k.rows == rows && k.batch == batch &&
        k.rs == rs && k.bs == bs) {
      *map = maps[i];
      return true;
    }
  }
  if (!long_tensor_map(map, base, d, heads, rows, batch, rs, bs)) return false;
  keys[next] = Key{base, d, heads, rows, batch, rs, bs};
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  if (filled < kMapCache) ++filled;
  return true;
}

// The current device's SM count, asked once a device.
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> known[kDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && (*sms = known[dev].load(std::memory_order_relaxed)) > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && dev < kDevices) known[dev].store(*sms, std::memory_order_relaxed);
  return err;
}

// One launch of wgmma_long_fwd_kernel<D, FLASH, ONE> (launch_long_fwd's).
template <int D, bool FLASH, bool ONE>
cudaError_t launch_long(const CUtensorMap& tm_k, const CUtensorMap& tm_v, const void* q, void* o,
                        float* stat_a, float* stat_b, int n, int nk, int heads, const Strides& st,
                        float scale, int seg_keys, int segs, int iters, int resident,
                        long long blocks, int smem, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const cudaError_t err = allow_smem(wgmma_long_fwd_kernel<D, FLASH, ONE>, kMaxSmem, done);
  if (err != cudaSuccess) return err;
  wgmma_long_fwd_kernel<D, FLASH, ONE><<<static_cast<unsigned>(blocks), kLongThreads, smem, stream>>>(
      tm_k, tm_v, static_cast<const bf16*>(q), static_cast<bf16*>(o), stat_a, stat_b, n, nk, heads,
      st, scale, seg_keys, segs, iters, resident);
  return cudaGetLastError();
}

// Launches wgmma_long_fwd_kernel<D, FLASH, ONE>: K resident where its tiles
// fit the shared memory beside the ring and the Q tiles (every long tower's
// shape), else streamed; the row blocks of a (sample, head) spread over the
// fewest blocks that still give every SM two (K resident: one block walks
// them in turn, K loaded once); K1 and K4 walk the keys as one segment, K10
// jax's nblk blocks of blk_k keys, in one pass (ONE) where K is resident,
// a block is at most kLongHeld tiles and D at most kLongOneDim.
template <int D, bool FLASH>
int launch_long_fwd(const void* q, const void* k, const void* v, void* o, float* stat_a,
                    float* stat_b, int batch, int n, int nk, int heads, const Strides& st,
                    float scale, int blk_k, int nblk, cudaStream_t stream) {
  if (FLASH && (blk_k % kLongKeys != 0 || nblk < 1)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm_k, tm_v;
  if (!cached_tensor_map(&tm_k, k, D, heads, nk, batch, st.k_rs, st.k_bs) ||
      !cached_tensor_map(&tm_v, v, D, heads, nk, batch, st.v_rs, st.v_bs))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ktiles = (nk + kLongKeys - 1) / kLongKeys;
  const bool resident = long_smem_bytes(D, ktiles) <= kMaxSmem;
  const int rows_blocks = (n + kLongRows - 1) / kLongRows;
  const long long heads_total = (long long)heads * batch;
  int iters = 1;
  if (resident) {
    const long long want = (2LL * sms + heads_total - 1) / heads_total;
    const int per_head = want < rows_blocks ? static_cast<int>(want) : rows_blocks;
    iters = even_iters(rows_blocks, (rows_blocks + per_head - 1) / per_head);
  }
  const long long blocks = (long long)((rows_blocks + iters - 1) / iters) * heads_total;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = long_smem_bytes(D, resident ? ktiles : 0);
  const int seg_keys = FLASH ? blk_k : nk, segs = FLASH ? nblk : 1;
  if constexpr (FLASH && D <= kLongOneDim) {
    if (resident && blk_k <= kLongHeld * kLongKeys)
      return static_cast<int>(launch_long<D, true, true>(tm_k, tm_v, q, o, stat_a, stat_b, n, nk,
                                                         heads, st, scale, seg_keys, segs, iters,
                                                         1, blocks, smem, stream));
  }
  return static_cast<int>(launch_long<D, FLASH, false>(tm_k, tm_v, q, o, stat_a, stat_b, n, nk,
                                                       heads, st, scale, seg_keys, segs, iters,
                                                       resident ? 1 : 0, blocks, smem, stream));
}

// The forward's kernels, by route: fp32 on the FMA kernels; bf16 on
// wgmma_fwd_kernel (D = 64, one key block of at most kWgKeys keys; K2 too),
// wgmma_wide_fwd_kernel (no rope, D = 64-112, at most kWideKeys keys: past
// 256 keys at D = 64, jax's blocks of 128 for K10), wgmma_long_fwd_kernel
// (no rope, not causal, D = 64-112, past kWideKeys keys) or mma_fwd_kernel
// (D = 32, causal past kWideKeys keys, K2 past 256 keys). The one source of
// the choice: the launchers below and the C entry attn_fwd_route read it.
enum FwdRoute { kRouteFma = 0, kRouteMmaSync = 1, kRouteWgmma = 2, kRouteWide = 3, kRouteLong = 4 };

inline int fwd_route(bool bf16_in, int d, bool rope, int nk, int nblk, bool causal) {
  if (!bf16_in) return kRouteFma;
  if (d == kWgDim && nblk == 1 && nk <= kWgKeys) return kRouteWgmma;
  if (rope || d == 32) return kRouteMmaSync;
  if (nk <= kWideKeys) return kRouteWide;  // K10 past 256 keys: nblk = 3 blocks of 128
  if (causal) return kRouteMmaSync;
  return kRouteLong;
}

// `tab`: K2's [n, 2D] rope table (ROPE), else unused. Launches the kernel of
// fwd_route's choice; a shape on a route launches that route's kernel or
// returns an error.
template <int D, bool FLASH, bool MULTI, bool ROPE = false>
int launch_mma_fwd(const void* q, const void* k, const void* v, const void* tab, void* o,
                   float* stat_a, float* stat_b, int batch, int n, int nk, int heads,
                   const Strides& st, float scale, int causal, int blk_q, int blk_k, int nblk,
                   cudaStream_t stream) {
  const int route = fwd_route(true, D, ROPE, nk, nblk, causal != 0);
  if constexpr (D == kWgDim && !MULTI) {
    if (route == kRouteWgmma)
      return launch_wgmma_fwd<FLASH, ROPE>(q, k, v, tab, o, stat_a, stat_b, batch, n, nk, heads,
                                           st, scale, causal, (nk + 15) / 16, stream);
  }
  if constexpr (!ROPE && D != 32) {
    if (route == kRouteWide)
      return launch_wide_fwd<D, FLASH, MULTI>(q, k, v, o, stat_a, stat_b, batch, n, nk, heads, st,
                                              scale, causal, blk_q, blk_k, nblk, stream);
  }
  if constexpr (!ROPE && D != 32 && FLASH == MULTI) {
    if (route == kRouteLong)
      return launch_long_fwd<D, FLASH>(q, k, v, o, stat_a, stat_b, batch, n, nk, heads, st, scale,
                                       blk_k, nblk, stream);
  }
  if (route != kRouteMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_mma_smem<D, FLASH, MULTI, ROPE>();
  if (err != cudaSuccess) return static_cast<int>(err);
  // one jax block (at most 256 keys when there are several) per chunk, or
  // as much of it as mma_max_chunk allows
  const int keys = blk_k < nk ? blk_k : nk;
  constexpr int kMost = mma_max_chunk<D>();
  const int ch = keys >= kMost ? kMost : (keys + 15) & ~15;
  // K and V resident: one block walks up to kMaxRows query rows
  const int tiles = (n + kMmaRows - 1) / kMmaRows;
  const int iters = nblk == 1 && nk <= ch ? even_iters(tiles, kMaxRows / kMmaRows) : 1;
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

// The forward route of a shape (FwdRoute: 0 the FMA kernels, 1 mma.sync,
// 2 wgmma at D = 64, 3 the wide wgmma kernel, 4 the long wgmma kernel) for
// the wrappers' launch counts and the card's checks: fwd_route itself.
extern "C" int attn_fwd_route(int is_bf16, int head_dim, int rope, int nk, int nblk,
                              int causal) {
  return fwd_route(is_bf16 != 0, head_dim, rope != 0, nk, nblk, causal != 0);
}
