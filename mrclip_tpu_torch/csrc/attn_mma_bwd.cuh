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
// products (76.3 GFLOP, 77 us at 989 TFLOP/s): bound by bytes. Both
// designs below take two passes without atomics, so each gradient element
// is written once by one thread and two runs give the same bits; they
// compute S and dP in both passes (14 D a pair) and move 13 tensors' bytes,
// not 8 (about 1.0 GB, 0.30 ms at 3.35 TB/s at vision b256).
//
// Four families of kernels, chosen in launch_mma_bwd by bwd_route (the one
// source of the choice; the libraries' C entry attn_bwd_route answers it for
// the wrappers' launch counts by route):
//   wgmma_bwd_dq_kernel and wgmma_bwd_dkv_kernel<FLASH, ROPE, CAUSAL,
//     TAIL>, on Hopper's warpgroup products (wgmma.cuh): bf16 K3, K3r, K5
//     and K10b at D = 64 with n and nk at most 256 (kWgKeys);
//   wgmma_wide_bwd_dq_kernel and wgmma_wide_bwd_dkv_kernel<D, FLASH,
//     TAIL>, on warpgroup products too, below: K3, K5 and K10b without rope
//     and not causal at D = 72, 80, 88, 104 and 112 with n and nk at most
//     kWideKeys = 272, one of them past 64 (ViT-SO400M's vision, the vision
//     towers of ViT-H/g/bigG-14, EVA01-g-14 and EVA02-E-14), and at D = 64
//     from 257 to 272 rows (ViT-L-14's vision);
//   wgmma_long_bwd_dq_kernel and wgmma_long_bwd_dkv_kernel<D, FLASH>, on
//     warpgroup products fed by TMA, below: K3, K5 and K10b without rope and
//     not causal at D = 64-112 with n or nk past kWideKeys (the 336-512 px
//     towers: ViT-L-14-336, SO400M-14-SigLIP-378/384, ViT-H-14-378, the
//     CLIPA-336 towers, ViT-B/L-16-SigLIP-384/512);
//   mma_bwd_dq_kernel and mma_bwd_dkv_kernel<D, FLASH, CHUNKED, ROPE>, on
//     Ampere's mma.sync: D = 32, K3r past 256 rows, causal past the D = 64
//     wgmma route (no config: every wide-head and long tower and SO400M's
//     text are not causal), and the wide head dims where n and nk are each
//     one 64-row sub-tile (SO400M's text, N = 64: there the wide kernels
//     read 6-26% slower than these, PERF.md, section 6).
//
// wgmma kernels: one warpgroup (128 threads) per block walks every 64-row
// (dq pass) or 64-key (dk/dv pass) sub-tile of its (sample, head), grid
// (batch or groups, 1, heads); the staged operands are read from device
// memory once per (sample, head):
//   - the staged rows, rounded up to 16 G rows, are walked as `full` whole
//     64-row steps in a runtime loop (m64n64k16 products), then one
//     straight-line step of TAIL = (G - 1) % 4 + 1 16-row groups
//     (m64n16k16 for S and dP; N = 197 computes 208 keys, not 256). TAIL
//     and CAUSAL are template arguments, not runtime branches between
//     products (in the wgmma forward ptxas then copied accumulators and
//     waited after every wgmma): 8 instantiations a pass, 16 with ROPE
//     (packed_attn_bwd.cu), 8 with FLASH (flash_attn.cu). A
//     TAIL of 0 (a loop's last pass ending the walk) is not used. Built
//     (tools/attn_bwd_sanitize.py's `tail0` edit), every such instantiation
//     is wrong at two or more whole steps (N = 113-128, 177-192, 241-256):
//     K3, K3r and K10b at N = 128, 192 and 256 on the H100 err by 0.64-0.97
//     of the largest plain gradient, the committed kernels by at most
//     0.0031. The cause is the compiler's register allocation (nvcc
//     12.9), not a missing wait or fence: in the TAIL-0 SASS every dk/dv
//     loop, and K3r's dq loop, packs P^T and dS^T (dS) into the registers
//     that hold the loop-carried A operands K and V (Q and dO), so the
//     loop's next pass multiplies those; each pass ends in the same wgmma
//     wait in both builds, and none of the 64 committed instantiations'
//     loops writes a carried A operand (the tool reads every one's SASS and
//     fails if one does). compute-sanitizer (2025.2.1) refuses the card
//     ("Device not supported"), so racecheck and synccheck did not run;
//   - dq pass: K and V staged by 16-byte cp.async in the 128-byte swizzle
//     (wgmma.cuh), rows nk .. 16 G - 1 zero; K is read K-major for S = Q
//     K^T and MN-major (transpose bit, the same tile) for dQ += dS K, V
//     K-major for dP = dO V^T. Q and dO are this warp's A fragments, read
//     from device memory by 32-bit loads (dq_rows, with O to take delta =
//     rowsum(dO O) and write it for the dk/dv pass; K10b reads m, l and di
//     instead, takes 1 / l by __fdiv_rn and writes nothing but dQ). Per
//     step, S and dP are two commit groups: P = 2^(S sl2 - lse) (K10b:
//     2^(S sl2 - m) (1 / l), the plain version's order) is taken while dP
//     is still on the tensor cores, then dS = P (dP - delta) scale in the
//     accumulator's registers, rounded to bf16 into the A fragments of dQ
//     += dS K;
//   - dk/dv pass: Q and dO staged in the swizzle with the rows' lse and
//     delta (K10b: m, di and 1 / l, 4 bytes a row more) in fp32 shared
//     memory; K and V by sub-tile into rows of D + 8 elements by cp.async,
//     the next sub-tile's copy under this one's products, this warp's A
//     fragments read by ldmatrix. Per step S^T = K
//     Q^T and dP^T = V dO^T are two commit groups; P^T and dV += round(P^T)
//     dO are issued while dP^T is computed, then dS^T and dK += round(dS^T)
//     Q (dO and Q read MN-major); dV is stored first;
//   - causal (the text towers): keys past the row (queries before the key)
//     to -inf, so P is 0; whole 64-row steps that are masked for every row
//     of the sub-tile are skipped (dq: steps past its last row, and the
//     tail step past it; dk/dv: steps before its first key); rows past n
//     and keys past nk compute what they read and store nothing;
//   - K3r: the staged operand (K, Q) rotated in the swizzled tile by each
//     thread's own 16-byte pieces once its cp.async wait has landed them
//     (rotate_swz), then fence.proxy.async and the barrier; the register
//     operand (Q, K) by rotate_frag_a (wgmma's A layout is mma.sync's);
//     dQ and dK un-rotated in the accumulator's registers (mma.sync's C
//     layout, chunk after chunk);
//   - shared memory: 1 KB of alignment slack and two tiles of 128-byte rows
//     (dk/dv: plus 8 bytes a row of statistics, 12 for K10b, and two 9 KB
//     sub-tiles): 54,272 and 74,368 bytes at N = 197 (K10b's dk/dv 75,200),
//     at most 88,064 at 256 rows; two blocks an SM (the dq pass's
//     registers allow three).
// What holds them back (PERF.md): the two passes' bytes (13 tensors, 0.30
// ms at peak bandwidth at vision b256) at about 60% of peak bandwidth, and
// within a warpgroup each step's products, exponentials and products in
// series; the text shapes are latency-bound at 2 sub-tiles a block.
// chip_smoke.py's phase 3 holds them against the plain versions at the
// route's edges (N 48 to 256, Nk != N) and asserts by the profiler's names
// which kernels each shape runs; tools/attn_bwd_variants.py times them
// beside the mma.sync route (the route disabled by a text edit).
//
// wgmma_wide_bwd_* (D = 64-112, n and nk <= 272, one of them past 64, not
// causal), designed for Hopper where mma_bwd_* took 1.02-1.71x SDPA's backward at b256 (PERF.md,
// section 6). Bound at EVA02-E-14's vision b256 (N = 257, H = 16, D = 112):
// the 8 tensors once, 0.5644 ms at 3.35 TB/s; the two passes' 13, 0.92 ms.
// What held mma_bwd_* back, and what these do about each:
//   1. the instruction: all four products of a pass run on wgmma. dq pass:
//      S = Q K^T and dP = dO V^T with Q and dO the register A (dq_rows) and
//      K and V read K-major, dQ += dS K with K read MN-major at n = D
//      (wgmma_m64nNk16_mn); dk/dv pass: S^T = K Q^T and dP^T = V dO^T with
//      K and V the A operands read from shared memory through a descriptor
//      (wgmma_m64n64k16_ss) and Q and dO K-major, dV += P^T dO and dK +=
//      dS^T Q with dO and Q read MN-major at n = D. Only the depth of Q K^T
//      and dO V^T (K Q^T, V dO^T) is padded to pad16(D);
//   2. re-staging: the staged pair (K and V; Q and dO with the rows'
//      statistics) goes into shared memory once per (sample, head) in the
//      32-byte-swizzled 16-column slabs of the wide forward (wgmma.cuh,
//      stage_slabs), and one block walks every 64-row sub-tile of it, where
//      mma_bwd_* re-staged it in 240- or 224-row chunks about five times at
//      104-112; blocks are ordered head first, as the forward's;
//   3. registers: the dk/dv pass holds dK and dV (D / 2 fp32 each a
//      thread) and a 64-query step's S^T and dP^T (64); K and V as register
//      A fragments would add 2 pad16(D) / 4 (56 at 112) and pass 255, so
//      they are read from shared memory: each warpgroup copies its
//      sub-tile's K and V (64 rows, keys past nk zero) into slabs of its own
//      before the walk, under the other warpgroup's (or block's) products.
//      No instantiation spills (build.py's log);
//   4. the tail: the staged rows, 16 (4 full + TAIL), are walked as `full`
//      whole 64-row steps in a runtime loop and one straight-line step of
//      TAIL 16-row groups (m64n16k16 for the scores; N = 257: four n64
//      steps and one n16), TAIL 1 or 4 (with_wide_tail: other counts
//      rounded up with zero rows), never 0 (with_tail's rule). On the walked side
//      N = 257 is five 64-row sub-tiles, the fifth holding one real row:
//      it costs a whole sub-tile's products, a fifth of each pass, and with
//      two warpgroups a block (three sub-tiles and two) the second
//      warpgroup idles for one sub-tile at the end. wgmma's m is 64, so a
//      narrower last sub-tile is not an instruction; nothing cheaper was
//      tried.
// Geometry, by wide_bwd_smem and wide_bwd_wgs: one warpgroup a block, two
// blocks an SM, where two such blocks fit an SM's shared memory at 272
// rows (dq pass to D = 88: 1 KB of slack and K and V, 70,656 to 105,472
// bytes; dk/dv pass to 80: also a sub-tile's K and V and 12 bytes a row of
// statistics, 111,808 at 80), else two warpgroups a block sharing the
// staged pair, taking alternate sub-tiles (N = 257: three and two), one
// block an SM (dq at 104 and 112: 122,880 bytes; dk/dv from 88: 157,888
// and 183,488). The dq pass's step is the D = 64 kernel's (dq_step over the
// slabs), the dk/dv pass's arithmetic too (dkv_probs, dkv_ds); each
// gradient element is written once by one thread, so two runs give the
// same bits.
//
// wgmma_long_bwd_* (D = 64-112, n or nk past kWideKeys, not causal, no
// rope), designed for Hopper where mma_bwd_* took 1.19-1.72x SDPA's
// backward (K3, K5, K10b at SO400M-384's vision b32, N 729, D 72: 1.53,
// 1.64, 1.49 ms; PERF.md, section 6). Bound there: the five products,
// 198.1 us at 989 TFLOP/s (operations); the two passes compute S and dP
// twice, seven products, 277 us. Past 272 rows the staged pair no longer
// fits an SM's shared memory beside a second block (N 729 at D 72: 2 x 729
// x 160 bytes of K and V), so neither pass keeps it resident; both stream
// it instead, each as wgmma_long_fwd_kernel streams V (attn_mma_fwd.cuh):
//   - a block: a producer warpgroup (setmaxnreg 40; one thread issues every
//     TMA box of the 4-D maps of long_tensor_map, cached_tensor_map) and
//     kLbConsumers = 2 consumer warpgroups (setmaxnreg 232) of 64 rows
//     (dq pass) or 64 keys (dk/dv pass) each, 128 of one (sample, head); a
//     head's blocks side by side, so that those reading one staged pair run
//     together and find it in L2. A block does not walk several row
//     blocks: nothing stays resident across them here, so a walk would
//     save only the prologue;
//   - a ring of kLbStages = 3 stages of 64-row tiles in 32-byte-swizzled
//     16-column slabs (wgmma.cuh), a full and an empty mbarrier a stage; the
//     two consumers share each tile and each of their warps releases it
//     once its last product that reads it has landed;
//   - dq pass: the stage holds a K and a V tile (keys past nk zero-filled by
//     TMA, and masked to -inf). Each consumer holds its rows' Q and dO as A
//     fragments with their statistics (dq_rows: delta taken and written for
//     K3 and K5) and runs the wide kernels' dq_step per tile: S = Q K^T and
//     dP = dO V^T as two commit groups, P while dP is computed, dS rounded
//     into A fragments, dQ += dS K with K read MN-major from the same tile.
//     Q and dO, the loop's carried A operands, are held live to the end of
//     each pass (hold_frag: TAIL 0's fault above cannot reach them);
//   - dk/dv pass: each consumer's K and V tiles are loaded once by TMA onto
//     a barrier of their own, the A operands of S^T and dP^T read from
//     shared memory (no loop-carried register A); the stage holds a Q and a
//     dO tile (rows past n zero-filled) and the rows' statistics in fp32,
//     which kLbStatWriters = 64 producer threads store (lse or m in log2
//     units, delta or di, 1 / l for K10b; 0, 0 and 1 past n, as
//     stage_queries: those queries are masked to -inf, so P = 0 whatever
//     TMA's zero rows give) before they arrive on the stage's full barrier,
//     one of them with the TMA's expect_tx; the wide kernels' wide_dkv_step
//     per tile; dV stored first;
//   - shared memory: dq 62,512 bytes at D 72 and 80 (3 stages of 20 KB),
//     87,088 at 104 and 112; dk/dv 105,024 at 72 and 80, 145,984 at 104 and
//     112 (3 stages, each consumer's K and V, the statistics; K10b's 768
//     bytes more); one block an SM (384 threads, 168 registers at launch);
//   - no atomics: each gradient element is written once by one thread, so
//     two runs give the same bits. tools/attn_long_bwd_variants.py times
//     the ring's depth, one consumer a block and the long kernels at N 257.
//
// mma.sync kernels (D = 32, past 256 rows):
//   - dq pass, grid (batch or groups, row blocks, heads), four warps of 16
//     query rows: Q and dO fragments read once from device memory into
//     registers (32-bit loads in the mma A layout; K5 also reads O so, takes
//     delta = rowsum(dO O) over the quad of lanes that share a row and
//     writes it for the dkv pass); K and V staged in bf16 by 16-byte
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
//   - resident kernels (the staged rows, Nk for the dq pass and N for the
//     dkv pass, at most 256): every row staged once, before a block walks
//     up to four 64-row (64-key) sub-tiles, as the forward keeps K and V (a
//     sub-tile per block, restaging for each, took 21-28% longer at vision
//     b256); chunked kernels past 256 rows: one sub-tile a block, chunks of
//     256 rows staged in turn, two blocks an SM (the dkv pass's chunk allows
//     no more at D = 64, and the registers beyond 168 keep both passes'
//     chunk loops from spilling); neither is double-buffered;
//   - registers: three resident blocks of an SM allow 168 a thread, and dK,
//     dV, K and V held take 96. 16 queries a dkv step and 32 keys a dq step
//     keep every kernel from spilling (wider steps spilled and ran slower,
//     two dkv blocks an SM ran 6-8% slower: PERF.md). The staging sits
//     outside the resident kernels' sub-tile loop;
//   - causal: a warp skips the key (query) steps wholly above (below) its
//     diagonal; on the diagonal and the ragged edges masked pairs get a
//     score of -inf, so their P is exactly 0; rows past n (keys past nk) are
//     read as 0 and store nothing;
//   - K3r (past 256 rows and at D = 32): the staged operand rotated in
//     shared memory by the forward's rotate_rows, the register operand by
//     rotate_frag_a (each 32-bit A-fragment register is one rope pair of one
//     row), dQ and dK un-rotated the same way in the C layout;
//   - gradients rounded to bf16 and stored from the accumulators by 32-bit
//     stores. The 16-byte copies and 32-bit loads and stores need the
//     views' base pointers and batch and row strides (and K3r's table) to
//     be multiples of 16 bytes, which the wrappers check.
// What holds them back: each mma.sync reads its B fragment from shared
// memory (16 warp rows per fragment), so shared-memory reads and the two
// recomputed products, not device memory, set the pace; a warp's S -> P ->
// dS -> product chain runs in series. Dynamic shared memory: 2 ch (D + 8) *
// 2 bytes for a chunk of ch rows (dkv: plus 12 ch of statistics).
// The wide head dims (D = 72, 80, 88, 104, 112; attn_mma_fwd.cuh's note): rows and
// fragments P = pad16(D) wide, the pad staged as zeros (stage_rows) or read
// as zeros (load_frag_a: the upper 8 columns of the last 16), so dQ, dK and
// dV carry zeros in the pad and store_frag_c writes the first D columns.
// dK and dV at P = 112 hold 2 x 14 x 4 fp32 accumulators a thread beside
// K's and V's 2 x 7 x 4 fragments: two blocks an SM (__launch_bounds__(128,
// 2), up to 255 registers: dq 169 / 183 / 201 / 207 resident and 202 / 212
// / 246 / 255 chunked, dkv 201 / 218 / 244 / 255 and 224 / 229 / 253 / 255
// at 80 / 88 / 104 / 112; none spilling but the chunked passes at 112, P =
// 112 with no zero column: dq 16 bytes, dkv 12 (K10b's 20; its chunked dq
// takes 236), and chunks of at most mma_bwd_max_chunk rows, which leave
// shared memory for two blocks: at N = 257 both passes are resident at D =
// 80, the dq pass at 88, neither at 104 or 112.

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
  return 2 * ch * (pad16(D) + 8) * 2;
}

template <int D>
constexpr int mma_bwd_dkv_smem(int ch) {  // Q and dO chunks, three fp32 stats
  return 2 * ch * (pad16(D) + 8) * 2 + 3 * ch * 4;
}

// The most rows the dq (DKV = false) or dkv pass stages at once: kMaxChunk
// at D <= 64, else as many as leave two blocks an SM (the forward's
// kTwoBlocksSmem; dq / dkv: 320 / 304 at D = 72 and 80, 272 / 256 at 88, 240 / 224
// at 104 and 112), at most kMaxResident.
template <int D, bool DKV>
constexpr int mma_bwd_max_chunk() {
  if (D <= 64) return kMaxChunk;
  const int fit = (kTwoBlocksSmem / (DKV ? mma_bwd_dkv_smem<D>(1) : mma_bwd_dq_smem<D>(1))) & ~15;
  return fit < kMaxResident ? fit : kMaxResident;
}

// This warp's A fragments (mma m16n8k16, row-major) of rows [r0, r0 + 16)
// of one (sample, head)'s D columns, read from device memory by 32-bit
// loads (row stride rs elements); rows >= n and the pad columns [D,
// pad16(D)) read 0.
template <int D>
__device__ __forceinline__ void load_frag_a(uint32_t (&f)[pad16(D) / 16][4], const bf16* base,
                                            long long rs, int r0, int n, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bool in0 = r0 + g < n, in1 = r0 + g + 8 < n;
  const uint32_t* p0 = reinterpret_cast<const uint32_t*>(base + (r0 + g) * rs + 2 * t);
  const uint32_t* p1 = reinterpret_cast<const uint32_t*>(base + (r0 + g + 8) * rs + 2 * t);
#pragma unroll
  for (int ds = 0; ds < pad16(D) / 16; ++ds) {
    const bool hi = 16 * ds + 8 < D;  // columns 16 ds + 8 .. + 15 (D is a multiple of 8)
    f[ds][0] = in0 ? __ldg(p0 + 8 * ds) : 0u;
    f[ds][1] = in1 ? __ldg(p1 + 8 * ds) : 0u;
    f[ds][2] = in0 && hi ? __ldg(p0 + 8 * ds + 4) : 0u;
    f[ds][3] = in1 && hi ? __ldg(p1 + 8 * ds + 4) : 0u;
  }
}

// Rows [r0, r0 + 16) of an accumulator (C layout, N 8-column chunks:
// pad16(D) / 8 for mma.sync, D / 8 for an m64nDk16 wgmma) rounded to bf16
// and stored, its first D columns; rows >= n not.
template <int D, int N>
__device__ __forceinline__ void store_frag_c(bf16* base, long long rs, const float (&acc)[N][4],
                                             int r0, int n, int lane) {
  static_assert(N >= D / 8, "the accumulator holds the D columns");
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
__device__ __forceinline__ void dq_rows(uint32_t (&qf)[pad16(D) / 16][4],
                                        uint32_t (&dof)[pad16(D) / 16][4],
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
    uint32_t of[pad16(D) / 16][4];
    load_frag_a<D>(of, o + b * st.o_bs + hd, st.o_rs, wrow0, n, lane);
    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int ds = 0; ds < pad16(D) / 16; ++ds) {
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
__global__ void __launch_bounds__(kMmaThreads, CHUNKED || D > 64 ? 2 : 3)
    mma_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ tab,
                      const bf16* __restrict__ o, const bf16* __restrict__ dout,
                      const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                      float* __restrict__ delta, bf16* __restrict__ dq, int n, int nk, int heads,
                      Strides st, float scale, int causal, int ch, int iters) {
  static_assert(D == 32 || D == 64 || D == 72 || D == 80 || D == 88 || D == 104 || D == 112,
                "head dim");
  static_assert(!ROPE || D <= 64, "rope takes D = 32 and 64");
  constexpr int P = pad16(D);  // shared rows and fragments: D padded to 16 columns
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t sk_a = static_cast<uint32_t>(__cvta_generic_to_shared(mma_smem));
  const uint32_t sv_a = sk_a + ch * (P + 8) * 2;

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

    uint32_t qf[P / 16][4], dof[P / 16][4];
    float st2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
    float acc[P / 8][4];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

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
        dq_walk<P, FLASH>(acc, qf, dof, st2, inv, dl, sk_a, sv_a, c0, c1, min(c1, w_keys), wrow0,
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
      dq_walk<P, FLASH>(acc, qf, dof, st2, inv, dl, sk_a, sv_a, 0, kend, min(kend, w_keys),
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
__global__ void __launch_bounds__(kMmaThreads, CHUNKED || D > 64 ? 2 : 3)
    mma_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ tab,
                       const bf16* __restrict__ dout, const float* __restrict__ stat_a,
                       const float* __restrict__ stat_b, const float* __restrict__ delta,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int nk, int heads,
                       Strides st, float scale, int causal, int ch, int iters) {
  static_assert(D == 32 || D == 64 || D == 72 || D == 80 || D == 88 || D == 104 || D == 112,
                "head dim");
  static_assert(!ROPE || D <= 64, "rope takes D = 32 and 64");
  constexpr int P = pad16(D);  // shared rows and fragments: D padded to 16 columns
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const uint32_t sq_a = static_cast<uint32_t>(__cvta_generic_to_shared(mma_smem));
  const uint32_t sdo_a = sq_a + ch * (P + 8) * 2;
  float* s_st = reinterpret_cast<float*>(mma_smem + 2 * ch * (P + 8) * 2);
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

    uint32_t kf[P / 16][4], vf[P / 16][4];
    float dka[P / 8][4], dva[P / 8][4];
#pragma unroll
    for (int j = 0; j < P / 8; ++j) {
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
          dkv_walk<P, FLASH>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq_a, sdo_a, c0, c1, wk0,
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
        dkv_walk<P, FLASH>(dka, dva, kf, vf, s_st, s_inv, s_dl, sq_a, sdo_a, 0, n, wk0, causal,
                           sl2, scale, lane);
    }
    if (live) {  // dV first: its registers are free before dK's un-rotation
      store_frag_c<D>(dv + b * st.dv_bs + hd, st.dv_rs, dva, wk0, nk, lane);
      if constexpr (ROPE) unrotate_frag_c<D>(dka, tab, wk0, nk, lane);
      store_frag_c<D>(dk + b * st.dk_bs + hd, st.dk_rs, dka, wk0, nk, lane);
    }
  }
}

// Shared-memory bytes of the wgmma backward for `rows` staged rows (a
// multiple of 16): alignment slack and two tiles of 128-byte rows (K and V,
// or Q and dO); the dk/dv pass also the rows' statistics in fp32 (lse and
// delta; FLASH: m, di and 1 / l) and a sub-tile of 64 rows each of K and V
// in rows of D + 8 elements.
constexpr int wg_bwd_smem(int rows, bool dkv, bool flash) {
  return 1024 + 2 * rows * 128 +
         (dkv ? (flash ? 3 : 2) * rows * 4 + 2 * kMmaRows * (kWgDim + 8) * 2 : 0);
}

// The accumulator of an m64nNk16 wgmma (d[4 j + e], N / 2 registers) as
// mma.sync's C fragments (acc[j][e]): the same registers, for store_frag_c
// and unrotate_frag_c.
template <int R>
__device__ __forceinline__ float (&as_frag_c(float (&d)[R]))[R / 4][4] {
  return *reinterpret_cast<float(*)[R / 4][4]>(&d);
}

// NG 16-row groups of a score-like product into d (8 NG fp32) over P / 16
// k16 steps: A the register fragments `a` (64 x P, this warp's rows), B the
// K-major tile at `desc`, a k16 step `step` further in the descriptor's
// 16-byte units and a 16-row group `group` (the 128-byte swizzle: 2 and
// 128; the wide kernels' slabs: a slab and 32). NG = 4: one m64n64k16 per
// k16 step; else m64n16k16 per group.
template <int P, int NG>
__device__ __forceinline__ void wg_scores(float* d, const uint32_t (&a)[P / 16][4], uint64_t desc,
                                          uint32_t step, uint32_t group) {
#pragma unroll
  for (int ks = 0; ks < P / 16; ++ks) {
    if constexpr (NG == 4) {
      wgmma_m64n64k16<0>(d, a[ks], desc + step * ks, ks);
    } else {
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
        wgmma_m64n16k16(d + 8 * gg, a[ks], desc + group * gg + step * ks, ks);
    }
  }
}

// acc (64 x 64) += A B over NG 16-row groups: A the bf16 fragments `a` of
// each group, B the MN-major rows of those groups in the 128-byte-swizzled
// tile at `desc` (the D = 64 dk/dv pass).
template <int NG>
__device__ __forceinline__ void wg_accumulate(float (&acc)[kWgDim / 2], const uint32_t (&a)[NG][4],
                                              uint64_t desc) {
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) wgmma_m64n64k16<1>(acc, a[kk], desc + 128 * kk, 1);
}

// The 8 NG values of x rounded to bf16 as the A fragments of NG k16 steps:
// the accumulator's 8-column chunks 2 kk and 2 kk + 1 are step kk's.
template <int NG>
__device__ __forceinline__ void pack_frag_a(uint32_t (&a)[NG][4], const float* x) {
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
  }
}

// The dq pass's P in place of the scores s of NG 16-key groups from key k0
// (the accumulator's layout): keys >= nk and, CAUSAL, keys past the row to
// -inf, then P = 2^(S sl2 - lse) (FLASH: 2^(S sl2 - m) (1 / l)). st2, inv:
// this lane's rows' lse (m) in log2 units and 1 / l; r0 the lane's first
// row, wrow0 the warp's.
template <int NG, bool FLASH, bool CAUSAL>
__device__ __forceinline__ void dq_probs(float* s, const float (&st2)[2], const float (&inv)[2],
                                         int k0, int nk, int wrow0, int r0, float sl2, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {  // 8-key chunk j: keys k0 + 8 j + 2 t + {0, 1}
    float* x = s + 4 * j;
    if (k0 + 8 * j + 8 > nk || (CAUSAL && k0 + 8 * j + 7 > wrow0)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        if (key >= nk || (CAUSAL && key > r0 + 8 * (e >> 1))) x[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // P
      x[e] = ex2(fmaf(x[e], sl2, -st2[e >> 1]));
      if constexpr (FLASH) x[e] *= inv[e >> 1];
    }
  }
}

// dS = P (dP - delta) scale in place of P (8 NG values); dl: this lane's
// rows' delta (di).
template <int NG>
__device__ __forceinline__ void dq_ds(float* s, const float* dp, const float (&dl)[2],
                                      float scale) {
#pragma unroll
  for (int j = 0; j < 8 * NG; ++j) s[j] = s[j] * (dp[j] - dl[(j >> 1) & 1]) * scale;  // dS
}

// dq pass, NG 16-key groups from key k0 of the staged K (desc dk) and V
// (dv): S = Q K^T and dP = dO V^T in one batch (wg_scores: a k16 step
// `step` further in the descriptors, a 16-key group `group`), P = 2^(S sl2
// - lse) (FLASH: 2^(S sl2 - m) (1 / l)) and dS = P (dP - delta) scale in
// the accumulator's registers (keys >= nk and, CAUSAL, keys past the row
// to -inf, so P = 0), dS rounded into the A fragments of acc += dS K at n
// = D, K read MN-major through dkm (the D = 64 kernel's 128-byte swizzle:
// dk itself; the wide kernels' slabs: LBO across the slabs). st2: this
// lane's rows' lse (m) in log2 units; inv: their 1 / l (FLASH); dl: their
// delta (di); r0: the lane's first row, wrow0 the warp's.
template <int D, int NG, bool FLASH, bool CAUSAL>
__device__ __forceinline__ void dq_step(float (&acc)[D / 2],
                                        const uint32_t (&qf)[pad16(D) / 16][4],
                                        const uint32_t (&dof)[pad16(D) / 16][4],
                                        const float (&st2)[2], const float (&inv)[2],
                                        const float (&dl)[2], uint64_t dk, uint64_t dv,
                                        uint64_t dkm, uint32_t step, uint32_t group, int k0,
                                        int wrow0, int r0, int nk, float sl2, float scale, int t) {
  float s[8 * NG], dp[8 * NG];
  wgmma_fence();
  wg_scores<pad16(D), NG>(s, qf, dk, step, group);
  wgmma_commit();
  wg_scores<pad16(D), NG>(dp, dof, dv, step, group);
  wgmma_commit();
  wgmma_wait<1>();  // S landed; P's exponentials run while dP is computed
  fence_regs<8 * NG>(s);
  dq_probs<NG, FLASH, CAUSAL>(s, st2, inv, k0, nk, wrow0, r0, sl2, t);
  wgmma_wait<0>();
  fence_regs<8 * NG>(dp);
  dq_ds<NG>(s, dp, dl, scale);
  uint32_t da[NG][4];
  pack_frag_a<NG>(da, s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) wgmma_m64nNk16_mn<D>(acc, da[kk], dkm + group * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs<D / 2>(acc);
}

// The dk/dv pass's P^T in place of the transposed scores s of NG 16-query
// groups from query c0 (rows: this lane's keys key0, key0 + 8; wk0 the
// warp's first): queries >= n and, CAUSAL, queries before the key to -inf,
// then P^T = 2^(S^T sl2 - lse) (FLASH: 2^(S^T sl2 - m) (1 / l)) by the
// staged statistics s_st (log2 units) and s_inv (1 / l).
template <int NG, bool FLASH, bool CAUSAL>
__device__ __forceinline__ void dkv_probs(float* s, const float* s_st, const float* s_inv, int c0,
                                          int n, int wk0, int key0, float sl2, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {  // 8-query chunk j: queries c0 + 8 j + 2 t + {0, 1}
    const int col = c0 + 8 * j + 2 * t;
    const float2 st = *reinterpret_cast<const float2*>(s_st + col);
    float* x = s + 4 * j;
    if (c0 + 8 * j + 8 > n || (CAUSAL && wk0 + 15 > c0 + 8 * j)) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = col + (e & 1);
        if (qc >= n || (CAUSAL && key0 + 8 * (e >> 1) > qc)) x[e] = -INFINITY;
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = ex2(fmaf(x[e], sl2, -(e & 1 ? st.y : st.x)));  // P^T
    if constexpr (FLASH) {
      const float2 il = *reinterpret_cast<const float2*>(s_inv + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= e & 1 ? il.y : il.x;
    }
  }
}

// dS^T = P^T (dP^T - delta) scale in place of dP^T (8 NG values), delta
// (di) of the staged queries s_dl.
template <int NG>
__device__ __forceinline__ void dkv_ds(float* dp, const float* s, const float* s_dl, int c0,
                                       float scale, int t) {
#pragma unroll
  for (int j = 0; j < 2 * NG; ++j) {
    const float2 dl = *reinterpret_cast<const float2*>(s_dl + c0 + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e)
      dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e & 1 ? dl.y : dl.x)) * scale;  // dS^T
  }
}

// dk/dv pass, NG 16-query groups from query c0 of the staged Q (desc dq)
// and dO (ddo) with their statistics (s_st: lse (FLASH: m) in log2 units,
// s_inv: 1 / l (FLASH), s_dl: delta (di)): S^T = K Q^T and dP^T = V dO^T
// in one batch; P^T and dS^T in the accumulator's registers (queries >= n
// and, CAUSAL, queries before the key to -inf); dva += round(P^T) dO and
// dka += round(dS^T) Q, dO and Q read MN-major. key0: this lane's first
// key, wk0 the warp's.
template <int NG, bool FLASH, bool CAUSAL>
__device__ __forceinline__ void dkv_step(float (&dka)[kWgDim / 2], float (&dva)[kWgDim / 2],
                                         const uint32_t (&kf)[kWgDim / 16][4],
                                         const uint32_t (&vf)[kWgDim / 16][4], const float* s_st,
                                         const float* s_inv, const float* s_dl, uint64_t dq,
                                         uint64_t ddo, int c0, int wk0, int key0, int n, float sl2,
                                         float scale, int t) {
  float s[8 * NG], dp[8 * NG];
  wgmma_fence();
  wg_scores<kWgDim, NG>(s, kf, dq, 2, 128);
  wgmma_commit();
  wg_scores<kWgDim, NG>(dp, vf, ddo, 2, 128);
  wgmma_commit();
  wgmma_wait<1>();  // S^T landed; P^T and dV's product run while dP^T is computed
  fence_regs<8 * NG>(s);
  dkv_probs<NG, FLASH, CAUSAL>(s, s_st, s_inv, c0, n, wk0, key0, sl2, t);
  uint32_t pa[NG][4], da[NG][4];
  pack_frag_a<NG>(pa, s);
  wgmma_fence();
  wg_accumulate<NG>(dva, pa, ddo);
  wgmma_commit();
  wgmma_wait<1>();  // dP^T landed (dV's product may still run)
  fence_regs<8 * NG>(dp);
  dkv_ds<NG>(dp, s, s_dl, c0, scale, t);
  pack_frag_a<NG>(da, dp);
  wgmma_fence();
  wg_accumulate<NG>(dka, da, dq);
  wgmma_commit();
  wgmma_wait<0>();
  hold_frag<4 * NG>(pa[0]);  // read by dV's product while dS^T was computed
  fence_regs<kWgDim / 2>(dva);
  fence_regs<kWgDim / 2>(dka);
}

// dq pass on wgmma (K3, K5, K10b (FLASH) and, with ROPE, K3r at D = 64, n
// and nk <= 256): dQ for the query rows of one block of one (sample, head);
// K3/K5/K3r: stat_a = lse, delta taken and written; K10b: stat_a = l,
// stat_b = m, delta = di read. The staged keys are 16 (4 full + TAIL)
// rows, TAIL 1 to 4: `full` whole 64-key steps in a loop, then one
// straight-line step of TAIL 16-key groups. The header's note says how.
template <bool FLASH, bool ROPE, bool CAUSAL, int TAIL>
__global__ void __launch_bounds__(kMmaThreads, 2)
    wgmma_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ tab,
                        const bf16* __restrict__ o, const bf16* __restrict__ dout,
                        const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                        float* __restrict__ delta, bf16* __restrict__ dq, int n, int nk,
                        int heads, Strides st, float scale, int full, int iters) {
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  constexpr int D = kWgDim;
  const int rows = 16 * (4 * full + TAIL);
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sk = (raw + 1023) & ~1023u;  // the swizzle's 1024-byte alignment
  const uint32_t sv = sk + rows * 128;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long hd = (long long)h * D;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;
  const int row_first = blockIdx.y * iters * kMmaRows;
  const int tiles = min(iters, (n - row_first + kMmaRows - 1) / kMmaRows);

  // K, then V (K3r: K rotates while V lands); key rows nk .. rows - 1 zero
  stage_swz(sk, k + b * st.k_bs + hd, st.k_rs, nk, rows);
  cp_async_commit();
  stage_swz(sv, v + b * st.v_bs + hd, st.v_rs, nk, rows);
  cp_async_commit();
  const uint64_t dk = wgmma_desc(sk, 16, 1024), dv = wgmma_desc(sv, 16, 1024);

  for (int it = 0; it < tiles; ++it) {
    const int row0 = row_first + it * kMmaRows;
    const int wrow0 = row0 + 16 * warp, r0 = wrow0 + (lane >> 2);
    uint32_t qf[D / 16][4], dof[D / 16][4];
    float st2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
    // the first sub-tile's under the copies; rows past n read 0
    dq_rows<D, FLASH, ROPE>(qf, dof, st2, inv, dl, q, tab, o, dout, stat_a, stat_b, delta, st, b,
                            hd, sb, wrow0, n, lane);
    if (it == 0) {
      if constexpr (ROPE) {
        cp_async_wait<1>();
        rotate_swz(sk, tab, nk);  // while V lands
      }
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    // causal: the 64-key steps past the sub-tile's last row are masked for
    // every row of it, so skipped, and so is a tail step past that row
    const int steps = CAUSAL ? min(full, row0 / kMmaRows + 1) : full;
    for (int tt = 0; tt < steps; ++tt)
      dq_step<D, 4, FLASH, CAUSAL>(acc, qf, dof, st2, inv, dl, dk + 512 * tt, dv + 512 * tt,
                                   dk + 512 * tt, 2, 128, 64 * tt, wrow0, r0, nk, sl2, scale,
                                   lane & 3);
    if (!CAUSAL || 64 * full < row0 + kMmaRows)
      dq_step<D, TAIL, FLASH, CAUSAL>(acc, qf, dof, st2, inv, dl, dk + 512 * full,
                                      dv + 512 * full, dk + 512 * full, 2, 128, 64 * full, wrow0,
                                      r0, nk, sl2, scale, lane & 3);
    if constexpr (ROPE) unrotate_frag_c<D>(as_frag_c(acc), tab, wrow0, n, lane);
    store_frag_c<D>(dq + b * st.dq_bs + hd, st.dq_rs, as_frag_c(acc), wrow0, n, lane);
  }
}

// dk/dv pass on wgmma: dK and dV for the keys of one block of one (sample,
// head), statistics as the dq pass's (delta from it, or di). The staged
// query rows are 16 (4 full + TAIL), walked as the dq pass walks its keys.
template <bool FLASH, bool ROPE, bool CAUSAL, int TAIL>
__global__ void __launch_bounds__(kMmaThreads, 2)
    wgmma_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ tab,
                         const bf16* __restrict__ dout, const float* __restrict__ stat_a,
                         const float* __restrict__ stat_b, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int n, int nk, int heads,
                         Strides st, float scale, int full, int iters) {
  static_assert(!(FLASH && ROPE), "the rope backward is K3r's");
  constexpr int D = kWgDim;
  const int rows = 16 * (4 * full + TAIL);
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sdo = sq + rows * 128;
  float* s_st = reinterpret_cast<float*>(wg_smem + (sdo + rows * 128 - raw));
  float* s_dl = s_st + rows;
  float* s_inv = s_dl + rows;  // FLASH only
  constexpr int kStats = FLASH ? 3 : 2;
  constexpr uint32_t kTileBytes = kMmaRows * (D + 8) * 2;
  const uint32_t sk = sdo + rows * 128 + kStats * rows * 4, sv = sk + kTileBytes;

  const long long b = blockIdx.x;
  const int h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long hd = (long long)h * D;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;
  const int key_first = blockIdx.y * iters * kMmaRows;
  const int tiles = min(iters, (nk - key_first + kMmaRows - 1) / kMmaRows);

  // Q and dO (rows n .. rows - 1 zero), the first sub-tile's K and V, and
  // the rows' statistics (0 past n: those queries are masked)
  const bf16* kb = k + b * st.k_bs + hd;
  const bf16* vb = v + b * st.v_bs + hd;
  stage_swz(sq, q + b * st.q_bs + hd, st.q_rs, n, rows);
  stage_swz(sdo, dout + b * st.do_bs + hd, st.do_rs, n, rows);
  stage_rows<D>(sk, kb + key_first * st.k_rs, st.k_rs, min(kMmaRows, nk - key_first));
  stage_rows<D>(sv, vb + key_first * st.v_rs, st.v_rs, min(kMmaRows, nk - key_first));
  cp_async_commit();
  for (int i = threadIdx.x; i < rows; i += kMmaThreads) {
    const bool in = i < n;
    if constexpr (FLASH) {  // 1 / l as stage_queries takes it
      s_st[i] = in ? stat_b[sb + i] * kLog2e : 0.f;
      s_inv[i] = in ? __fdiv_rn(1.f, stat_a[sb + i]) : 1.f;
    } else {
      s_st[i] = in ? stat_a[sb + i] * kLog2e : 0.f;
    }
    s_dl[i] = in ? delta[sb + i] : 0.f;
  }
  const uint64_t dq = wgmma_desc(sq, 16, 1024), ddo = wgmma_desc(sdo, 16, 1024);

  for (int it = 0; it < tiles; ++it) {
    const int kr0 = key_first + it * kMmaRows;
    const int wk0 = kr0 + 16 * warp, key0 = wk0 + (lane >> 2);  // the warp's keys: wk0 .. + 15
    // this sub-tile's K and V landed (and, first, Q and dO); keys past nk
    // read 0 (the rows of a 16-row group past it) or what an earlier
    // sub-tile left (the groups past that: their dK and dV rows are not
    // stored)
    cp_async_wait<0>();
    if constexpr (ROPE) {
      if (it == 0) rotate_swz(sq, tab, n);
    }
    fence_proxy_async();
    __syncthreads();
    uint32_t kf[D / 16][4], vf[D / 16][4];
    {
      const int mi = lane >> 3, rr = lane & 7;
      const uint32_t off = ((16 * warp + (mi & 1) * 8 + rr) * (D + 8) + (mi >> 1) * 8) * 2;
#pragma unroll
      for (int ds = 0; ds < D / 16; ++ds) {
        ldsm_x4<false>(kf[ds], sk + off + 32 * ds);
        ldsm_x4<false>(vf[ds], sv + off + 32 * ds);
      }
    }
    if (it + 1 < tiles) {  // the next sub-tile's K and V land under this one
      __syncthreads();  // every warp has its fragments
      const int kr1 = kr0 + kMmaRows;
      stage_rows<D>(sk, kb + kr1 * st.k_rs, st.k_rs, min(kMmaRows, nk - kr1));
      stage_rows<D>(sv, vb + kr1 * st.v_rs, st.v_rs, min(kMmaRows, nk - kr1));
      cp_async_commit();
    }
    if constexpr (ROPE) rotate_frag_a<D>(kf, tab, wk0, nk, lane);  // K3r; keys past nk to 0
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    // causal: the 64-query steps before the sub-tile's first key see none
    // of its keys, so they are skipped; the tail step's queries are the last
    for (int tt = CAUSAL ? kr0 / kMmaRows : 0; tt < full; ++tt)
      dkv_step<4, FLASH, CAUSAL>(dka, dva, kf, vf, s_st, s_inv, s_dl, dq + 512 * tt,
                                 ddo + 512 * tt, 64 * tt, wk0, key0, n, sl2, scale, lane & 3);
    dkv_step<TAIL, FLASH, CAUSAL>(dka, dva, kf, vf, s_st, s_inv, s_dl, dq + 512 * full,
                                  ddo + 512 * full, 64 * full, wk0, key0, n, sl2, scale, lane & 3);
    // dV first: its registers are free before dK's un-rotation
    store_frag_c<D>(dv + b * st.dv_bs + hd, st.dv_rs, as_frag_c(dva), wk0, nk, lane);
    if constexpr (ROPE) unrotate_frag_c<D>(as_frag_c(dka), tab, wk0, nk, lane);
    store_frag_c<D>(dk + b * st.dk_bs + hd, st.dk_rs, as_frag_c(dka), wk0, nk, lane);
  }
}

// fn(std::bool_constant<CAUSAL>(), std::integral_constant<int, TAIL>()):
// the instantiation of a wgmma backward pass over `groups` (>= 1) 16-row
// groups, TAIL = (groups - 1) % 4 + 1 of them in its straight-line last
// step. A last step of 4 groups, not a loop's last pass: where the loop of
// whole steps ends the walk (TAIL 0), the compiler gives the loop-carried
// A operands' registers to the packed P and dS, and every such instantiation
// is wrong at 2 or more whole steps (the header's note).
template <bool CAUSAL, typename Fn>
cudaError_t with_tail(int groups, Fn&& fn) {
  using C = std::bool_constant<CAUSAL>;
  switch ((groups - 1) % 4) {
    case 0: return fn(C(), std::integral_constant<int, 1>());
    case 1: return fn(C(), std::integral_constant<int, 2>());
    case 2: return fn(C(), std::integral_constant<int, 3>());
    default: return fn(C(), std::integral_constant<int, 4>());
  }
}

// Launches the wgmma backward (n and nk at most kWgKeys, D = 64), dq pass
// first; one block walks every 64-row (64-key) sub-tile of its (sample,
// head). Statistics as launch_mma_bwd's. Returns the first cudaError_t.
template <bool FLASH, bool ROPE>
int launch_wgmma_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* tab, const bf16* o,
                     const bf16* dout, const float* stat_a, const float* stat_b, float* delta,
                     bf16* dq, bf16* dk, bf16* dv, int batch, int n, int nk, int heads,
                     const Strides& st, float scale, int causal, cudaStream_t stream) {
  const int groups_k = (nk + 15) / 16, tiles_q = (n + kMmaRows - 1) / kMmaRows;
  auto dq_pass = [&](auto is_causal, auto tail) {
    constexpr bool kCausal = decltype(is_causal)::value;
    constexpr int kTail = decltype(tail)::value;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e = allow_smem(wgmma_bwd_dq_kernel<FLASH, ROPE, kCausal, kTail>,
                                     wg_bwd_smem(kWgKeys, false, FLASH), done);
    if (e != cudaSuccess) return e;
    wgmma_bwd_dq_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, 1, heads), kMmaThreads,
                                                       wg_bwd_smem(16 * groups_k, false, FLASH),
                                                       stream>>>(
        q, k, v, tab, o, dout, stat_a, stat_b, delta, dq, n, nk, heads, st, scale,
        (groups_k - 1) / 4, tiles_q);
    return cudaGetLastError();
  };
  cudaError_t err =
      causal ? with_tail<true>(groups_k, dq_pass) : with_tail<false>(groups_k, dq_pass);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups_q = (n + 15) / 16, tiles_k = (nk + kMmaRows - 1) / kMmaRows;
  auto dkv_pass = [&](auto is_causal, auto tail) {
    constexpr bool kCausal = decltype(is_causal)::value;
    constexpr int kTail = decltype(tail)::value;
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e = allow_smem(wgmma_bwd_dkv_kernel<FLASH, ROPE, kCausal, kTail>,
                                     wg_bwd_smem(kWgKeys, true, FLASH), done);
    if (e != cudaSuccess) return e;
    wgmma_bwd_dkv_kernel<FLASH, ROPE, kCausal, kTail><<<dim3(batch, 1, heads), kMmaThreads,
                                                        wg_bwd_smem(16 * groups_q, true, FLASH),
                                                        stream>>>(
        q, k, v, tab, dout, stat_a, stat_b, delta, dk, dv, n, nk, heads, st, scale,
        (groups_q - 1) / 4, tiles_k);
    return cudaGetLastError();
  };
  err = causal ? with_tail<true>(groups_q, dkv_pass) : with_tail<false>(groups_q, dkv_pass);
  return static_cast<int>(err);
}

// ---- wgmma_wide_bwd_dq_kernel and wgmma_wide_bwd_dkv_kernel: D = 64-112, n
// and nk <= kWideKeys, not causal (the header's note says how).

// Shared-memory bytes of the wide backward for `rows` staged rows (a
// multiple of 16): alignment slack and the staged pair (K and V, or Q and
// dO) in pad16(d) / 16 slabs of `rows` 32-byte rows each; the dk/dv pass
// also, for each of `wgs` warpgroups, K and V of a 64-key sub-tile in slabs
// of 64 rows, and the rows' statistics in fp32 (lse and delta; FLASH: m, di
// and 1 / l).
__host__ __device__ constexpr int wide_bwd_smem(int d, int rows, bool dkv, bool flash, int wgs) {
  return 1024 + 2 * (pad16(d) / 16) * rows * 32 +
         (dkv ? wgs * 2 * (pad16(d) / 16) * kMmaRows * 32 + (flash ? 3 : 2) * rows * 4 : 0);
}

// Warpgroups a block of a wide backward pass: one where two blocks fit an
// SM's shared memory at kWideKeys rows, else two sharing the staged pair and
// taking alternate sub-tiles (one block an SM): the dq pass at D = 104 and
// 112, the dk/dv pass from D = 88.
template <int D, bool DKV, bool FLASH>
__host__ __device__ constexpr int wide_bwd_wgs() {
  return wide_bwd_smem(D, kWideKeys, DKV, FLASH, 1) <= kTwoBlocksSmem ? 1 : 2;
}

// wg_scores over the wide kernels' slabs (a k16 step `slab` further in the
// descriptor's units, a group 32) with A read from shared memory too: the
// K-major 64-row slabs at `adesc` (a k16 step 128 further: 64 rows of 32
// bytes).
template <int P, int NG>
__device__ __forceinline__ void wide_scores_ss(float* d, uint64_t adesc, uint64_t desc,
                                               uint32_t slab) {
#pragma unroll
  for (int ks = 0; ks < P / 16; ++ks) {
    if constexpr (NG == 4) {
      wgmma_m64n64k16_ss(d, adesc + 128 * ks, desc + ks * slab, ks);
    } else {
#pragma unroll
      for (int gg = 0; gg < NG; ++gg)
        wgmma_m64n16k16_ss(d + 8 * gg, adesc + 128 * ks, desc + ks * slab + 32 * gg, ks);
    }
  }
}

// Wide dk/dv pass (dkv_step over the slabs, K and V read from shared
// memory), NG 16-query groups from query c0 of the staged Q and dO with
// their statistics (s_st, s_inv, s_dl as dkv_step's): S^T = K Q^T and
// dP^T = V dO^T in one batch, K and V the A operands read from this
// warpgroup's sub-tile slabs (ak, av), Q and dO K-major (bq, bdo); P^T and
// dS^T in the accumulator's registers (queries >= n to -inf); dva +=
// round(P^T) dO and dka += round(dS^T) Q, dO and Q read MN-major (bdom,
// bqm: n = D across the slabs).
template <int D, int NG, bool FLASH>
__device__ __forceinline__ void wide_dkv_step(float (&dka)[D / 2], float (&dva)[D / 2],
                                              uint64_t ak, uint64_t av, const float* s_st,
                                              const float* s_inv, const float* s_dl, uint64_t bq,
                                              uint64_t bdo, uint64_t bqm, uint64_t bdom,
                                              uint32_t slab, int c0, int n, float sl2,
                                              float scale, int t) {
  constexpr int P = pad16(D);
  float s[8 * NG], dp[8 * NG];
  wgmma_fence();
  wide_scores_ss<P, NG>(s, ak, bq, slab);
  wgmma_commit();
  wide_scores_ss<P, NG>(dp, av, bdo, slab);
  wgmma_commit();
  wgmma_wait<1>();  // S^T landed; P^T and dV's product run while dP^T is computed
  fence_regs<8 * NG>(s);
  dkv_probs<NG, FLASH, false>(s, s_st, s_inv, c0, n, 0, 0, sl2, t);
  uint32_t pa[NG][4], da[NG][4];
  pack_frag_a<NG>(pa, s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) wgmma_m64nNk16_mn<D>(dva, pa[kk], bdom + 32 * kk, 1);
  wgmma_commit();
  wgmma_wait<1>();  // dP^T landed (dV's product may still run)
  fence_regs<8 * NG>(dp);
  dkv_ds<NG>(dp, s, s_dl, c0, scale, t);
  pack_frag_a<NG>(da, dp);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NG; ++kk) wgmma_m64nNk16_mn<D>(dka, da[kk], bqm + 32 * kk, 1);
  wgmma_commit();
  wgmma_wait<0>();
  hold_frag<4 * NG>(pa[0]);  // read by dV's product while dS^T was computed
  fence_regs<D / 2>(dva);
  fence_regs<D / 2>(dka);
}

// Wide dq pass: dQ (and, for K3 and K5, delta) for every query row of one
// (sample, head), block blockIdx.x = sample * heads + head; K3/K5: stat_a =
// lse, delta taken and written; K10b: stat_a = l, stat_b = m, delta = di
// read. K and V (16 (4 full + TAIL) rows, rows nk .. on zero) staged once in
// slabs; each warpgroup walks every WGS-th 64-row sub-tile: `full` whole
// 64-key steps in a loop, then one straight-line step of TAIL groups.
template <int D, bool FLASH, int TAIL>
__global__ void __launch_bounds__(wide_bwd_wgs<D, false, FLASH>() * kMmaThreads,
                                  wide_bwd_wgs<D, false, FLASH>() == 1 ? 2 : 1)
    wgmma_wide_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ o,
                             const bf16* __restrict__ dout, const float* __restrict__ stat_a,
                             const float* __restrict__ stat_b, float* __restrict__ delta,
                             bf16* __restrict__ dq, int n, int nk, int heads, Strides st,
                             float scale, int full) {
  constexpr int P = pad16(D);  // S's and dP's depth; dQ's n is D itself
  constexpr int WGS = wide_bwd_wgs<D, false, FLASH>();
  constexpr int kThreads = WGS * kMmaThreads;
  const int rows = 16 * (4 * full + TAIL);
  const uint32_t slab = rows * 32;  // bytes of one 16-column slab
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sk = (raw + 1023) & ~1023u;
  const uint32_t sv = sk + P / 16 * slab;

  const int wg = threadIdx.x / kMmaThreads, tid = threadIdx.x % kMmaThreads;
  const long long b = blockIdx.x / heads;  // heads fastest, as the wide forward
  const int h = blockIdx.x % heads;
  const int warp = tid >> 5, lane = tid & 31;
  const long long hd = (long long)h * D;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;
  const int tiles = (n + kMmaRows - 1) / kMmaRows;

  stage_slabs<D, kThreads>(sk, k + b * st.k_bs + hd, st.k_rs, nk, rows, threadIdx.x);
  stage_slabs<D, kThreads>(sv, v + b * st.v_bs + hd, st.v_rs, nk, rows, threadIdx.x);
  cp_async_commit();
  if (wg >= tiles) {  // a warpgroup with no sub-tile still publishes its share
    cp_async_wait<0>();
    fence_proxy_async();
    bar_sync(1, kThreads);
    return;
  }
  // K and V K-major for S and dP (a k16 step one slab, `us` in the
  // descriptor's units), K MN-major for dQ += dS K (LBO: slab to slab)
  const uint64_t dk = wgmma_desc(sk, 16, 256, kSwizzle32), dv = wgmma_desc(sv, 16, 256, kSwizzle32);
  const uint64_t dkm = wgmma_desc(sk, slab, 256, kSwizzle32);
  const uint32_t us = slab / 16;
  for (int it = wg; it < tiles; it += WGS) {
    const int wrow0 = it * kMmaRows + 16 * warp;
    uint32_t qf[P / 16][4], dof[P / 16][4];
    float st2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
    // the first sub-tile's under the copies; rows past n read 0
    dq_rows<D, FLASH, false>(qf, dof, st2, inv, dl, q, nullptr, o, dout, stat_a, stat_b, delta,
                             st, b, hd, sb, wrow0, n, lane);
    if (it == wg) {
      cp_async_wait<0>();
      fence_proxy_async();
      bar_sync(1, kThreads);
    }
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int tt = 0; tt < full; ++tt)
      dq_step<D, 4, FLASH, false>(acc, qf, dof, st2, inv, dl, dk + 128 * tt, dv + 128 * tt,
                                  dkm + 128 * tt, us, 32, 64 * tt, 0, 0, nk, sl2, scale,
                                  lane & 3);
    dq_step<D, TAIL, FLASH, false>(acc, qf, dof, st2, inv, dl, dk + 128 * full, dv + 128 * full,
                                   dkm + 128 * full, us, 32, 64 * full, 0, 0, nk, sl2, scale,
                                   lane & 3);
    store_frag_c<D>(dq + b * st.dq_bs + hd, st.dq_rs, as_frag_c(acc), wrow0, n, lane);
  }
}

// Wide dk/dv pass: dK and dV for every key of one (sample, head),
// statistics as the dq pass's (delta from it, or di). Q and dO (16 (4 full +
// TAIL) rows, rows n .. on zero) staged once in slabs with the rows'
// statistics; each warpgroup walks every WGS-th 64-key sub-tile, its K and V
// copied into the warpgroup's own slabs, the A operands of S^T and dP^T.
template <int D, bool FLASH, int TAIL>
__global__ void __launch_bounds__(wide_bwd_wgs<D, true, FLASH>() * kMmaThreads,
                                  wide_bwd_wgs<D, true, FLASH>() == 1 ? 2 : 1)
    wgmma_wide_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ dout,
                              const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                              const float* __restrict__ delta, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int n, int nk, int heads, Strides st,
                              float scale, int full) {
  constexpr int P = pad16(D);
  constexpr int WGS = wide_bwd_wgs<D, true, FLASH>();
  constexpr int kThreads = WGS * kMmaThreads;
  constexpr uint32_t kTile = P / 16 * kMmaRows * 32;  // K or V of one 64-key sub-tile
  const int rows = 16 * (4 * full + TAIL);
  const uint32_t slab = rows * 32;
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t sq = (raw + 1023) & ~1023u;
  const uint32_t sdo = sq + P / 16 * slab;
  const uint32_t tiles0 = sdo + P / 16 * slab;  // each warpgroup's K and V sub-tile
  float* s_st = reinterpret_cast<float*>(wg_smem + (tiles0 + WGS * 2 * kTile - raw));
  float* s_dl = s_st + rows;
  float* s_inv = s_dl + rows;  // FLASH only

  const int wg = threadIdx.x / kMmaThreads, tid = threadIdx.x % kMmaThreads;
  const uint32_t sk = tiles0 + wg * 2 * kTile, sv = sk + kTile;
  const long long b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int warp = tid >> 5, lane = tid & 31;
  const long long hd = (long long)h * D;
  const long long sb = (b * heads + h) * n;
  const float sl2 = scale * kLog2e;
  const int tiles = (nk + kMmaRows - 1) / kMmaRows;
  const bf16* kb = k + b * st.k_bs + hd;
  const bf16* vb = v + b * st.v_bs + hd;

  // Q and dO, each warpgroup's first K and V (keys past nk zero), the rows'
  // statistics (0 past n: those queries are masked; 1 / l there 1)
  stage_slabs<D, kThreads>(sq, q + b * st.q_bs + hd, st.q_rs, n, rows, threadIdx.x);
  stage_slabs<D, kThreads>(sdo, dout + b * st.do_bs + hd, st.do_rs, n, rows, threadIdx.x);
  if (wg < tiles) {
    const int kr0 = wg * kMmaRows, len = min(kMmaRows, nk - kr0);
    stage_slabs<D, kMmaThreads>(sk, kb + kr0 * st.k_rs, st.k_rs, len, kMmaRows, tid);
    stage_slabs<D, kMmaThreads>(sv, vb + kr0 * st.v_rs, st.v_rs, len, kMmaRows, tid);
  }
  cp_async_commit();
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    const bool in = i < n;
    if constexpr (FLASH) {  // 1 / l as stage_queries takes it
      s_st[i] = in ? stat_b[sb + i] * kLog2e : 0.f;
      s_inv[i] = in ? __fdiv_rn(1.f, stat_a[sb + i]) : 1.f;
    } else {
      s_st[i] = in ? stat_a[sb + i] * kLog2e : 0.f;
    }
    s_dl[i] = in ? delta[sb + i] : 0.f;
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // Q and dO K-major for S^T and dP^T, MN-major for dK and dV; K and V the
  // K-major A of S^T and dP^T
  const uint64_t bq = wgmma_desc(sq, 16, 256, kSwizzle32), bdo = wgmma_desc(sdo, 16, 256, kSwizzle32);
  const uint64_t bqm = wgmma_desc(sq, slab, 256, kSwizzle32);
  const uint64_t bdom = wgmma_desc(sdo, slab, 256, kSwizzle32);
  const uint64_t ak = wgmma_desc(sk, 16, 256, kSwizzle32), av = wgmma_desc(sv, 16, 256, kSwizzle32);
  const uint32_t us = slab / 16;
  for (int it = wg; it < tiles; it += WGS) {
    const int kr0 = it * kMmaRows;
    if (it != wg) {  // this sub-tile's K and V, once the warpgroup is done with the last's
      bar_sync(2 + wg, kMmaThreads);
      const int len = min(kMmaRows, nk - kr0);
      stage_slabs<D, kMmaThreads>(sk, kb + kr0 * st.k_rs, st.k_rs, len, kMmaRows, tid);
      stage_slabs<D, kMmaThreads>(sv, vb + kr0 * st.v_rs, st.v_rs, len, kMmaRows, tid);
      cp_async_commit();
      cp_async_wait<0>();
      fence_proxy_async();
      bar_sync(2 + wg, kMmaThreads);
    }
    float dka[D / 2], dva[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
    for (int tt = 0; tt < full; ++tt)
      wide_dkv_step<D, 4, FLASH>(dka, dva, ak, av, s_st, s_inv, s_dl, bq + 128 * tt,
                                 bdo + 128 * tt, bqm + 128 * tt, bdom + 128 * tt, us, 64 * tt, n,
                                 sl2, scale, lane & 3);
    wide_dkv_step<D, TAIL, FLASH>(dka, dva, ak, av, s_st, s_inv, s_dl, bq + 128 * full,
                                  bdo + 128 * full, bqm + 128 * full, bdom + 128 * full, us,
                                  64 * full, n, sl2, scale, lane & 3);
    const int wk0 = kr0 + 16 * warp;
    store_frag_c<D>(dv + b * st.dv_bs + hd, st.dv_rs, as_frag_c(dva), wk0, nk, lane);
    store_frag_c<D>(dk + b * st.dk_bs + hd, st.dk_rs, as_frag_c(dka), wk0, nk, lane);
  }
}

// fn(std::false_type(), std::integral_constant<int, TAIL>()): the wide
// backward's instantiation over `groups` (>= 1) 16-row groups, walked as
// full = (groups - 1) / 4 whole 64-row steps and a straight-line last step
// of TAIL groups: 1 where one group follows the whole steps (N = 257), else
// 4, the staged rows rounded up with zero rows (at most two more groups).
// The routed main-path shapes take 17 and 16 groups (N = 257, 256);
// two TAILs, not with_tail's four, halve the wide instantiations' build.
// No TAIL 0: with_tail's rule.
template <typename Fn>
cudaError_t with_wide_tail(int groups, Fn&& fn) {
  if ((groups - 1) % 4 == 0) return fn(std::false_type(), std::integral_constant<int, 1>());
  return fn(std::false_type(), std::integral_constant<int, 4>());
}

// Launches the wide backward (D = 64-112, n and nk at most kWideKeys, not
// causal), dq pass first: one block a (sample, head), heads fastest.
// Statistics as launch_mma_bwd's. Returns the first cudaError_t.
template <int D, bool FLASH>
int launch_wide_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                    const float* stat_a, const float* stat_b, float* delta, bf16* dq, bf16* dk,
                    bf16* dv, int batch, int n, int nk, int heads, const Strides& st,
                    float scale, cudaStream_t stream) {
  const int groups_k = (nk + 15) / 16;
  auto dq_pass = [&](auto, auto tail) {
    constexpr int kTail = decltype(tail)::value;
    constexpr int kWgs = wide_bwd_wgs<D, false, FLASH>();
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e = allow_smem(wgmma_wide_bwd_dq_kernel<D, FLASH, kTail>,
                                     wide_bwd_smem(D, kWideKeys, false, FLASH, kWgs), done);
    if (e != cudaSuccess) return e;
    const int full = (groups_k - 1) / 4;
    wgmma_wide_bwd_dq_kernel<D, FLASH, kTail>
        <<<batch * heads, kWgs * kMmaThreads,
           wide_bwd_smem(D, 16 * (4 * full + kTail), false, FLASH, kWgs), stream>>>(
            q, k, v, o, dout, stat_a, stat_b, delta, dq, n, nk, heads, st, scale, full);
    return cudaGetLastError();
  };
  cudaError_t err = with_wide_tail(groups_k, dq_pass);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups_q = (n + 15) / 16;
  auto dkv_pass = [&](auto, auto tail) {
    constexpr int kTail = decltype(tail)::value;
    constexpr int kWgs = wide_bwd_wgs<D, true, FLASH>();
    static std::atomic<unsigned long long> done{0};
    const cudaError_t e = allow_smem(wgmma_wide_bwd_dkv_kernel<D, FLASH, kTail>,
                                     wide_bwd_smem(D, kWideKeys, true, FLASH, kWgs), done);
    if (e != cudaSuccess) return e;
    const int full = (groups_q - 1) / 4;
    wgmma_wide_bwd_dkv_kernel<D, FLASH, kTail>
        <<<batch * heads, kWgs * kMmaThreads,
           wide_bwd_smem(D, 16 * (4 * full + kTail), true, FLASH, kWgs), stream>>>(
            q, k, v, dout, stat_a, stat_b, delta, dk, dv, n, nk, heads, st, scale, full);
    return cudaGetLastError();
  };
  return static_cast<int>(with_wide_tail(groups_q, dkv_pass));
}

// ---- wgmma_long_bwd_dq_kernel and wgmma_long_bwd_dkv_kernel: D = 64-112,
// past kWideKeys rows on either side, not causal, without the rope (the
// header's note says how).

constexpr int kLbStages = 3;     // tiles in flight in a pass's ring
constexpr int kLbConsumers = 2;  // consumer warpgroups a block, 64 rows (keys) each
constexpr int kLbThreads = (kLbConsumers + 1) * kMmaThreads;  // and a producer warpgroup
constexpr int kLbRows = kLbConsumers * kMmaRows;              // query rows (keys) a block
constexpr int kLbMinBlocks = 1;
// Registers a consumer thread after setmaxnreg: the block's 65,536 /
// kLbMinBlocks less the producer's 40 a thread, over the consumers
constexpr int kLbConsumerRegs = 232;
constexpr int kLbStatWriters = kLongKeys;  // producer threads that stage a tile's row statistics

// Shared-memory bytes of the long dq pass: alignment slack, the ring (a
// stage: a K tile and a V tile, kLongKeys rows of pad16(d) / 16 slabs of 32
// bytes each) and a full and an empty barrier a stage.
__host__ __device__ constexpr int long_bwd_dq_smem(int d) {
  return 1024 + kLbStages * 2 * (pad16(d) / 16) * kLongKeys * 32 + 16 * kLbStages;
}

// Shared-memory bytes of the long dk/dv pass: alignment slack, the ring (a
// stage: a Q tile and a dO tile), each consumer's K and V tiles, the
// stages' row statistics (lse and delta; FLASH: m, di and 1 / l; kLongKeys
// fp32 each), a full and an empty barrier a stage and one a consumer.
__host__ __device__ constexpr int long_bwd_dkv_smem(int d, bool flash) {
  return 1024 + (kLbStages + kLbConsumers) * 2 * (pad16(d) / 16) * kLongKeys * 32 +
         kLbStages * (flash ? 3 : 2) * kLongKeys * 4 + 8 * (2 * kLbStages + kLbConsumers);
}

// Long dq pass: dQ (and, for K3 and K5, delta) for kLbRows query rows of
// one (sample, head), block blockIdx.x = (sample * heads + head) * row
// blocks + row block; K3/K5: stat_a = lse, delta taken and written; K10b:
// stat_a = l, stat_b = m, delta = di read. Each consumer warpgroup holds its
// 64 rows' Q and dO as A fragments (dq_rows) and walks every 64-key tile of
// K and V, which one producer thread loads by TMA (`tm_k`, `tm_v`: keys past
// nk zero-filled) into a ring of kLbStages stages that the consumers share:
// dq_step per tile (S and dP, P and dS, dQ += dS K with K read MN-major from
// the same tile), the stage released once its dQ product has landed.
template <int D, bool FLASH>
__global__ void __launch_bounds__(kLbThreads, kLbMinBlocks)
    wgmma_long_bwd_dq_kernel(__grid_constant__ const CUtensorMap tm_k,
                             __grid_constant__ const CUtensorMap tm_v,
                             const bf16* __restrict__ q, const bf16* __restrict__ o,
                             const bf16* __restrict__ dout, const float* __restrict__ stat_a,
                             const float* __restrict__ stat_b, float* __restrict__ delta,
                             bf16* __restrict__ dq, int n, int nk, int heads, Strides st,
                             float scale) {
  constexpr int P = pad16(D);  // S's and dP's depth; dQ's n is D itself
  constexpr int kSlabs = P / 16;
  constexpr uint32_t kSlab = kLongKeys * 32;   // one 16-column slab of a tile
  constexpr uint32_t kTile = kSlabs * kSlab;   // K's (or V's) tile
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t ring = (raw + 1023) & ~1023u;  // stage s: K at ring + 2 s kTile, V after it
  const uint32_t full = ring + kLbStages * 2 * kTile;
  const uint32_t empty = full + 8 * kLbStages;

  const int row_blocks = (n + kLbRows - 1) / kLbRows;  // a head's row blocks side by side
  const int bh = blockIdx.x / row_blocks, rb = blockIdx.x % row_blocks;
  const int head = bh % heads;
  const long long smp = bh / heads;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ktiles = (nk + kLongKeys - 1) / kLongKeys;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLbStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty + 8 * s, kLbConsumers * 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wid >= kLbConsumers * 4) {  // the producer warpgroup: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLongProducerRegs));
    if (threadIdx.x == kLbConsumers * kMmaThreads) {
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < ktiles; ++j) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage, dst = ring + stage * 2 * kTile;
        mbar_expect_tx(bar, 2 * kTile);
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + c * kSlab, &tm_k, bar, 16 * c, head, j * kLongKeys,
                      static_cast<int>(smp));
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + kTile + c * kSlab, &tm_v, bar, 16 * c, head, j * kLongKeys,
                      static_cast<int>(smp));
        ring_next<kLbStages>(stage, phase);
      }
    }
    return;
  }

  // the consumer warpgroups; rows past n read 0 and store nothing
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kLbConsumerRegs));
  const int wg = wid >> 2, warp = wid & 3;
  const long long hd = (long long)head * D;
  const long long sb = (smp * heads + head) * n;
  const float sl2 = scale * kLog2e;
  const int wrow0 = rb * kLbRows + wg * kMmaRows + 16 * warp;
  uint32_t qf[P / 16][4], dof[P / 16][4];
  float st2[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f}, dl[2] = {0.f, 0.f};
  dq_rows<D, FLASH, false>(qf, dof, st2, inv, dl, q, nullptr, o, dout, stat_a, stat_b, delta, st,
                           smp, hd, sb, wrow0, n, lane);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < ktiles; ++j) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t sk = ring + stage * 2 * kTile, sv = sk + kTile;
    // K and V K-major for S and dP (a k16 step one slab), K MN-major for dQ
    // += dS K (LBO: slab to slab)
    dq_step<D, 4, FLASH, false>(acc, qf, dof, st2, inv, dl, wgmma_desc(sk, 16, 256, kSwizzle32),
                                wgmma_desc(sv, 16, 256, kSwizzle32),
                                wgmma_desc(sk, kSlab, 256, kSwizzle32), kSlab / 16, 32,
                                j * kLongKeys, 0, 0, nk, sl2, scale, lane & 3);
    // Q and dO, the loop-carried A operands, live (their registers unshared)
    // to the end of each pass (the header's note: TAIL 0)
    hold_frag<4 * (P / 16)>(qf[0]);
    hold_frag<4 * (P / 16)>(dof[0]);
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    ring_next<kLbStages>(stage, phase);
  }
  store_frag_c<D>(dq + smp * st.dq_bs + hd, st.dq_rs, as_frag_c(acc), wrow0, n, lane);
}

// Long dk/dv pass: dK and dV for kLbRows keys of one (sample, head), block
// blockIdx.x = (sample * heads + head) * key blocks + key block; statistics
// as the dq pass's (delta from it, or di). Each consumer warpgroup's 64 keys
// of K and V are loaded once by TMA (`tm_k`, `tm_v`; keys past nk zero) into
// its own slabs, the shared-memory A operands of S^T and dP^T; the 64-row
// tiles of Q and dO (`tm_q`, `tm_do`; rows past n zero) come through a ring
// of kLbStages stages that both consumers read, each stage with its rows'
// statistics in fp32, which kLbStatWriters producer threads store (0 past
// n, 1 / l there 1: those queries are masked) before they arrive on the
// stage's full barrier beside the TMA's expect_tx: wide_dkv_step per tile.
template <int D, bool FLASH>
__global__ void __launch_bounds__(kLbThreads, kLbMinBlocks)
    wgmma_long_bwd_dkv_kernel(__grid_constant__ const CUtensorMap tm_q,
                              __grid_constant__ const CUtensorMap tm_do,
                              __grid_constant__ const CUtensorMap tm_k,
                              __grid_constant__ const CUtensorMap tm_v,
                              const float* __restrict__ stat_a, const float* __restrict__ stat_b,
                              const float* __restrict__ delta, bf16* __restrict__ dk,
                              bf16* __restrict__ dv, int n, int nk, int heads, Strides st,
                              float scale) {
  constexpr int P = pad16(D);
  constexpr int kSlabs = P / 16;
  constexpr uint32_t kSlab = kLongKeys * 32;
  constexpr uint32_t kTile = kSlabs * kSlab;  // a Q, dO, K or V tile
  constexpr int kStats = FLASH ? 3 : 2;       // fp32 statistics a row
  extern __shared__ __align__(16) unsigned char wg_smem[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(wg_smem));
  const uint32_t ring = (raw + 1023) & ~1023u;               // stage s: Q, then dO
  const uint32_t kv = ring + kLbStages * 2 * kTile;           // consumer w: K, then V
  const uint32_t stats = kv + kLbConsumers * 2 * kTile;       // stage s: kStats x kLongKeys
  const uint32_t full = stats + kLbStages * kStats * kLongKeys * 4;
  const uint32_t empty = full + 8 * kLbStages;
  const uint32_t kvbar = empty + 8 * kLbStages;               // consumer w's at kvbar + 8 w
  float* s_stats = reinterpret_cast<float*>(wg_smem + (stats - raw));

  const int key_blocks = (nk + kLbRows - 1) / kLbRows;  // a head's key blocks side by side
  const int bh = blockIdx.x / key_blocks, kb = blockIdx.x % key_blocks;
  const int head = bh % heads;
  const long long smp = bh / heads;
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qtiles = (n + kLongKeys - 1) / kLongKeys;
  const long long sb = (smp * heads + head) * n;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLbStages; ++s) {
      mbar_init(full + 8 * s, kLbStatWriters);     // the statistics' writers, one with expect_tx
      mbar_init(empty + 8 * s, kLbConsumers * 4);  // every consumer warp
    }
    for (int w = 0; w < kLbConsumers; ++w) mbar_init(kvbar + 8 * w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wid >= kLbConsumers * 4) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLongProducerRegs));
    const int p = threadIdx.x - kLbConsumers * kMmaThreads;
    if (p >= kLbStatWriters) return;
    if (p == 0) {  // each consumer's K and V, once
      for (int w = 0; w < kLbConsumers; ++w) {
        const uint32_t bar = kvbar + 8 * w, dst = kv + w * 2 * kTile;
        const int key0 = kb * kLbRows + w * kMmaRows;
        mbar_expect_tx(bar, 2 * kTile);
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + c * kSlab, &tm_k, bar, 16 * c, head, key0, static_cast<int>(smp));
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + kTile + c * kSlab, &tm_v, bar, 16 * c, head, key0,
                      static_cast<int>(smp));
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int j = 0; j < qtiles; ++j) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t bar = full + 8 * stage, dst = ring + stage * 2 * kTile;
      float* s_st = s_stats + stage * kStats * kLongKeys;
      const int i = j * kLongKeys + p;
      const bool in = i < n;
      if constexpr (FLASH) {  // 1 / l as stage_queries takes it
        s_st[p] = in ? stat_b[sb + i] * kLog2e : 0.f;
        s_st[2 * kLongKeys + p] = in ? __fdiv_rn(1.f, stat_a[sb + i]) : 1.f;
      } else {
        s_st[p] = in ? stat_a[sb + i] * kLog2e : 0.f;
      }
      s_st[kLongKeys + p] = in ? delta[sb + i] : 0.f;
      if (p == 0) {
        mbar_expect_tx(bar, 2 * kTile);
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + c * kSlab, &tm_q, bar, 16 * c, head, j * kLongKeys,
                      static_cast<int>(smp));
        for (int c = 0; c < kSlabs; ++c)
          tma_load_4d(dst + kTile + c * kSlab, &tm_do, bar, 16 * c, head, j * kLongKeys,
                      static_cast<int>(smp));
      } else {
        mbar_arrive(bar);  // release: the statistics' stores before it
      }
      ring_next<kLbStages>(stage, phase);
    }
    return;
  }

  // the consumer warpgroups; keys past nk compute what they read and store
  // nothing
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kLbConsumerRegs));
  const int wg = wid >> 2, warp = wid & 3;
  const long long hd = (long long)head * D;
  const float sl2 = scale * kLog2e;
  const uint32_t sk = kv + wg * 2 * kTile, sv = sk + kTile;
  const uint64_t ak = wgmma_desc(sk, 16, 256, kSwizzle32), av = wgmma_desc(sv, 16, 256, kSwizzle32);
  float dka[D / 2], dva[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kvbar + 8 * wg, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < qtiles; ++j) {
    mbar_wait(full + 8 * stage, phase);
    const uint32_t sq = ring + stage * 2 * kTile, sdo = sq + kTile;
    // the stage's statistics, indexed by query (wide_dkv_step reads query c0
    // + x at x of the stage)
    const int c0 = j * kLongKeys;
    const float* s_st = s_stats + stage * kStats * kLongKeys - c0;
    // Q and dO K-major for S^T and dP^T (a k16 step one slab), MN-major for
    // dK and dV (LBO: slab to slab)
    wide_dkv_step<D, 4, FLASH>(dka, dva, ak, av, s_st, s_st + 2 * kLongKeys, s_st + kLongKeys,
                               wgmma_desc(sq, 16, 256, kSwizzle32),
                               wgmma_desc(sdo, 16, 256, kSwizzle32),
                               wgmma_desc(sq, kSlab, 256, kSwizzle32),
                               wgmma_desc(sdo, kSlab, 256, kSwizzle32), kSlab / 16, c0, n, sl2,
                               scale, lane & 3);
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    ring_next<kLbStages>(stage, phase);
  }
  const int wk0 = kb * kLbRows + wg * kMmaRows + 16 * warp;
  store_frag_c<D>(dv + smp * st.dv_bs + hd, st.dv_rs, as_frag_c(dva), wk0, nk, lane);
  store_frag_c<D>(dk + smp * st.dk_bs + hd, st.dk_rs, as_frag_c(dka), wk0, nk, lane);
}

// Launches the long backward (D = 64-112, not causal, no rope), dq pass
// first: a block of kLbRows rows (keys) of one (sample, head), a head's
// blocks side by side (those reading one head's staged operand run together
// and find it in L2). The TMA maps (cached_tensor_map) need the views'
// row and batch strides and base pointers to be multiples of 16 bytes (the
// wrappers' check_rows_aligned_16) and contiguous heads D apart; a map that
// libcuda refuses returns cudaErrorInvalidValue. Statistics as
// launch_mma_bwd's. Returns the first cudaError_t.
template <int D, bool FLASH>
int launch_long_bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* dout,
                    const float* stat_a, const float* stat_b, float* delta, bf16* dq, bf16* dk,
                    bf16* dv, int batch, int n, int nk, int heads, const Strides& st,
                    float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  if (!cached_tensor_map(&tm_k, k, D, heads, nk, batch, st.k_rs, st.k_bs) ||
      !cached_tensor_map(&tm_v, v, D, heads, nk, batch, st.v_rs, st.v_bs) ||
      !cached_tensor_map(&tm_q, q, D, heads, n, batch, st.q_rs, st.q_bs) ||
      !cached_tensor_map(&tm_do, dout, D, heads, n, batch, st.do_rs, st.do_bs))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long heads_total = (long long)heads * batch;
  const long long dq_blocks = (n + kLbRows - 1) / kLbRows * heads_total;
  const long long dkv_blocks = (nk + kLbRows - 1) / kLbRows * heads_total;
  if (dq_blocks > INT_MAX || dkv_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<unsigned long long> done[2];
  cudaError_t err = allow_smem(wgmma_long_bwd_dq_kernel<D, FLASH>, long_bwd_dq_smem(D), done[0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_long_bwd_dq_kernel<D, FLASH>
      <<<static_cast<unsigned>(dq_blocks), kLbThreads, long_bwd_dq_smem(D), stream>>>(
          tm_k, tm_v, q, o, dout, stat_a, stat_b, delta, dq, n, nk, heads, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = allow_smem(wgmma_long_bwd_dkv_kernel<D, FLASH>, long_bwd_dkv_smem(D, FLASH), done[1]);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_long_bwd_dkv_kernel<D, FLASH>
      <<<static_cast<unsigned>(dkv_blocks), kLbThreads, long_bwd_dkv_smem(D, FLASH), stream>>>(
          tm_q, tm_do, tm_k, tm_v, stat_a, stat_b, delta, dk, dv, n, nk, heads, st, scale);
  return static_cast<int>(cudaGetLastError());
}

// The backward's kernels, by route (FwdRoute's values): fp32 on the FMA
// kernels; bf16 on wgmma_bwd_* (D = 64, n and nk at most kWgKeys; K3r and
// causal too), wgmma_long_bwd_* (no rope, not causal, D = 64-112, n or nk
// past kWideKeys), wgmma_wide_bwd_* (no rope, not causal, D = 64-112, n and
// nk at most kWideKeys, not both within one sub-tile) or mma_bwd_* (D = 32,
// rope or causal past the wgmma route, one sub-tile a side). The one source
// of the choice: launch_mma_bwd and the C entry attn_bwd_route read it.
inline int bwd_route(bool bf16_in, int d, bool rope, int n, int nk, bool causal) {
  if (!bf16_in) return kRouteFma;
  if (d == kWgDim && n <= kWgKeys && nk <= kWgKeys) return kRouteWgmma;
  if (rope || causal || d == 32) return kRouteMmaSync;
  if (n > kWideKeys || nk > kWideKeys) return kRouteLong;
  if (n <= kMmaRows && nk <= kMmaRows) return kRouteMmaSync;
  return kRouteWide;
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
  const int route = bwd_route(true, D, ROPE, n, nk, causal != 0);
  if constexpr (D == kWgDim) {
    if (route == kRouteWgmma)
      return launch_wgmma_bwd<FLASH, ROPE>(qp, kp, vp, tp, static_cast<const bf16*>(o), dop,
                                           stat_a, stat_b, delta, static_cast<bf16*>(dq),
                                           static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch,
                                           n, nk, heads, st, scale, causal, stream);
  }
  if constexpr (!ROPE && D != 32) {
    if (route == kRouteWide)
      return launch_wide_bwd<D, FLASH>(qp, kp, vp, static_cast<const bf16*>(o), dop, stat_a,
                                       stat_b, delta, static_cast<bf16*>(dq),
                                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, n,
                                       nk, heads, st, scale, stream);
    if (route == kRouteLong)
      return launch_long_bwd<D, FLASH>(qp, kp, vp, static_cast<const bf16*>(o), dop, stat_a,
                                       stat_b, delta, static_cast<bf16*>(dq),
                                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), batch, n,
                                       nk, heads, st, scale, stream);
  }
  if (route != kRouteMmaSync) return static_cast<int>(cudaErrorInvalidValue);
  // resident: the rows staged, rounded up to 16, and the sub-tiles a block
  // walks; chunked: the pass's most rows (mma_bwd_max_chunk) and one
  auto plan = [&](int len, int tiles, int most, int& ch, int& it) {
    const bool resident = len <= most;
    ch = resident ? (len + 15) & ~15 : most;
    it = resident ? even_iters(tiles, kMost) : 1;
    return resident;
  };
  constexpr int kDqMost = mma_bwd_max_chunk<D, false>(), kDkvMost = mma_bwd_max_chunk<D, true>();
  int ch = 0, it = 0;

  const int tiles_q = (n + kMmaRows - 1) / kMmaRows;
  auto dq_pass = [&](auto kernel, std::atomic<unsigned long long>& flag) {
    const cudaError_t e = allow_smem(kernel, mma_bwd_dq_smem<D>(kDqMost), flag);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(batch, (tiles_q + it - 1) / it, heads), kMmaThreads, mma_bwd_dq_smem<D>(ch),
             stream>>>(qp, kp, vp, tp, static_cast<const bf16*>(o), dop, stat_a, stat_b, delta,
                       static_cast<bf16*>(dq), n, nk, heads, st, scale, causal, ch, it);
    return cudaGetLastError();
  };
  cudaError_t err = plan(nk, tiles_q, kDqMost, ch, it)
                        ? dq_pass(mma_bwd_dq_kernel<D, FLASH, false, ROPE>, done[0])
                        : dq_pass(mma_bwd_dq_kernel<D, FLASH, true, ROPE>, done[1]);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tiles_k = (nk + kMmaRows - 1) / kMmaRows;
  auto dkv_pass = [&](auto kernel, std::atomic<unsigned long long>& flag) {
    const cudaError_t e = allow_smem(kernel, mma_bwd_dkv_smem<D>(kDkvMost), flag);
    if (e != cudaSuccess) return e;
    kernel<<<dim3(batch, (tiles_k + it - 1) / it, heads), kMmaThreads, mma_bwd_dkv_smem<D>(ch),
             stream>>>(qp, kp, vp, tp, dop, stat_a, stat_b, delta, static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), n, nk, heads, st, scale, causal, ch, it);
    return cudaGetLastError();
  };
  err = plan(n, tiles_k, kDkvMost, ch, it) ? dkv_pass(mma_bwd_dkv_kernel<D, FLASH, false, ROPE>, done[2])
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

// The backward route of a shape (0 the FMA kernels, 1 mma.sync, 2 wgmma at
// D = 64, 3 the wide wgmma kernels) for the wrappers' launch counts and the
// card's checks: bwd_route itself.
extern "C" int attn_bwd_route(int is_bf16, int head_dim, int rope, int n, int nk, int causal) {
  return bwd_route(is_bf16 != 0, head_dim, rope != 0, n, nk, causal != 0);
}
