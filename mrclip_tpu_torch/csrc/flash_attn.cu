// Flash attention for Hopper (sm_90a), plain C interface: the port of
// attn_impl='flash', mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded
// (:41), which pads q, k, v to 128 rows and calls jax's Pallas TPU flash
// attention (jax/experimental/pallas/ops/tpu/flash_attention.py, jax 0.9.0).
//
//   K10,  flash_attn_fwd: replaces _flash_attention_kernel_single_batch
//         (:342) and its single-step form (:484), driven by
//         _flash_attention_impl (:589);
//   K10b, flash_attn_bwd (flash_attn_bwd.cu, its own library, so that the
//         two build in parallel): replaces _flash_attention_dkv_kernel (:796)
//         and _flash_attention_dq_kernel (:1146), driven by
//         _flash_attention_bwd (:254); one call launches both passes.
//
// Per (sample, head), in jax's rounding order (attn_rows.cuh and
// attn_mma_fwd.cuh, FLASH = true):
// the keys are walked in blocks of width pick_block(Np_k) (256 if it divides
// the padded length Np_k, else 128); a causal block wholly above the
// diagonal of the query row's block is skipped. With one block (Np_k <= 256,
// every ViT-B and text sequence) o = round_T(exp(S - m) / l) V; with more
// (N = 257 pads to 384: three blocks of 128; N = 577 to 640: five) each
// block updates acc as jax does, with the UNnormalised P rounded to the
// input type T before P.V and the block's product scaled by 1 / l:
//
//   m' = max(m, m_blk)          l_corr = exp(m - m') l
//   l' = sum_j exp(S_j - m') + l_corr
//   acc = acc * (l_corr / l') + (sum_j round_T(exp(S_j - m')) V_j) / l'
//
// The residuals are l and m ([B, H, N] fp32, not lse). The backward
// recomputes P = exp(S - m) * (1 / l); dV = round_T(P)^T dO; dS = (dP - di)
// P scale rounded to T; dK = dS^T Q (dkv pass, fp32 accumulators) and
// dQ = dS K (dq pass), with di = rowsum(O * dO) in fp32 computed outside
// the kernel, as jax computes it.
//
// jax masks padded kv columns through segment ids and causal pairs by
// adding -0.7 * FLT_MAX to the score. Every visited block of a row holds
// one unmasked key (key 0 sits in the first block, and the blocks are
// visited in order), so a masked exp is exactly 0: the kernels skip masked
// keys and take the unpadded q, k, v, which gives jax's values on every
// real row. The padded query rows jax computes are sliced off there.
//
// Layout: q, k, v are [B, N, H, D] views with a batch and a row stride each
// and contiguous heads (the three column slices of one in_proj output go in
// uncopied, where jax's wrapper pads and transposes them to [B, H, Np, D]);
// o, dO and the gradients the same way. Base pointers and the batch and row
// strides are multiples of 16 bytes (checked by the caller), so a row's
// head slice is copied in 16-byte pieces.
//
// Bound on an H100 SXM, as K4/K5 (grouped_attn.cu): at ViT-B/16 vision b256
// (N = 197, H = 12, D = 64, bf16) the forward reads q, k, v and writes o
// (310 MB) and l, m (4.8 MB): 0.0940 ms at 3.35 TB/s against 30.5 GFLOP
// (0.031 ms at 989 TFLOP/s), bytes; the backward reads q, k, v, dO, l, m, di
// and writes dq, dk, dv (7 tensors, 542 MB): 0.1640 ms, bytes. bf16 runs on
// the tensor cores, FLASH = true, the strided views taken as they are: the
// forward in attn_mma_fwd.cuh (K and V staged in bf16 by 16-byte copies;
// one key block of at most 256 keys at D = 64 on wgmma, and at D = 72-112
// and up to 272 keys, jax's three 128-key blocks past 256, on the wide
// wgmma kernel),
// the backward in attn_mma_bwd.cuh (flash_attn_bwd.cu: a dq pass, then a
// dk/dv pass; the statistics m and 1 / l, and di, read per query row; N and
// Nk <= 256 at D = 64 on wgmma, wgmma_bwd_*<true, ...>; up to 272 at D =
// 72-112, and at 64 past 256, not causal, on the wide wgmma kernels; past
// 272 rows, causal past those and at D = 32 on mma.sync, 72, 88 and 104
// padded to 80, 96 and 112 columns). fp32
// runs on the
// FMA pipes (attn_rows.cuh) and sits far above its bound. The model's
// backward launches the forward again first (jax.checkpoint's recompute:
// only q, k, v are kept).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attn.so flash_attn.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_fwd.cuh"  // launch_fwd (bf16 on the tensor cores)
#include "attn_rows.cuh"     // Strides, read_strides

// K10. Returns the cudaError_t of the launch (0 = success). `strides` holds
// 16 element strides, (batch, row) for q, k, v, o, dO, dq, dk, dv (only the
// first four are read here). l and m are contiguous [batch, heads, n] fp32.
// blk_q and blk_k are jax's block widths of the padded lengths, nblk the
// number of key blocks (Np_k / blk_k).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              void* o, void* l, void* m, int is_bf16,
                              int batch, int n, int nk, int heads,
                              int head_dim, const long long* strides,
                              float scale, int causal, int blk_q, int blk_k,
                              int nblk, void* stream) {
  const Strides st = read_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(l);
  float* mp = static_cast<float*>(m);
#define MRCLIP_LAUNCH(T, D)                                                  \
  return launch_fwd<T, D, true>(q, k, v, o, lp, mp, batch, n, nk, heads, st, \
                                scale, causal, blk_q, blk_k, nblk, s)
  if (head_dim == 64) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 64);
    MRCLIP_LAUNCH(float, 64);
  }
  if (head_dim == 32) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 32);
    MRCLIP_LAUNCH(float, 32);
  }
  if (head_dim == 72) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 72);
    MRCLIP_LAUNCH(float, 72);
  }
  if (head_dim == 80) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 80);
    MRCLIP_LAUNCH(float, 80);
  }
  if (head_dim == 88) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 88);
    MRCLIP_LAUNCH(float, 88);
  }
  if (head_dim == 104) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 104);
    MRCLIP_LAUNCH(float, 104);
  }
  if (head_dim == 112) {
    if (is_bf16) MRCLIP_LAUNCH(__nv_bfloat16, 112);
    MRCLIP_LAUNCH(float, 112);
  }
#undef MRCLIP_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
