// Grouped-layout fused attention for Hopper (sm_90a), plain C interface:
// the port of attn_impl='fused'.
//
//   K4, grouped_attn_fwd: replaces mrclip_tpu/ops/fused_attn.py::_fwd_kernel
//       (:101, driven by _run_fwd :167);
//   K5, grouped_attn_bwd: replaces mrclip_tpu/ops/fused_attn.py::_bwd_kernel
//       (:118, driven by _core_bwd :193).
//
// Per group g (one (sample, head) of the [B*H, N, D] layout that
// fused_attention's prep produces, contiguous):
//
//   S   = q k^T * scale  [+ causal mask: key j > query i]
//   lse = m + log(l),  m = max_j S,  l = sum_j exp(S - m)          (fp32)
//   o   = round_T(exp(S - m) / l) v    (P normalised, then rounded to the
//                                       input type T, as the TPU kernel does)
//   dV  = round_T(P)^T dO,  P = exp(S - lse)
//   dS  = round_T((dP - delta) P scale),  dP = dO V^T,  delta = rowsum(dO O)
//   dQ  = dS K,  dK = dS^T Q           (fp32 sums, stored once in T)
//
// The TPU pads N and Nk to 128 rows and B*H to a multiple of 8 (Mosaic's
// tiling); padded key columns enter with -1e30, so their exp is exactly 0
// in fp32, and padded query rows are sliced off with zero cotangents. The
// kernels here take the unpadded tiles and skip keys >= Nk, which gives the
// same values on every real row. Cross-attention (Nk != N) is allowed.
//
// Design. bf16 runs on the tensor cores, FLASH = false: the forward in
// attn_mma_fwd.cuh (a block stages a group's K and V once in bf16 and walks
// its query rows; up to 256 keys at D = 64 on wgmma with each row's scores
// whole in registers and one exp per score, since the TPU rounds P only
// after normalising it; otherwise on mma.sync, the keys twice: max and
// online sum, then P.V with the scores recomputed); the backward in attn_mma_bwd.cuh (a dq pass that also
// takes delta, then a dk/dv pass; Q, dO or K, V fragments in registers, the
// other pair staged once per group where the group has at most 256 rows).
// fp32 takes one block per (group, 64-row query tile), four lanes per row,
// 64-key K/V tiles staged in fp32 (attn_rows.cuh): the forward walks the
// keys twice; the backward is K3's two passes (dQ + delta per query tile;
// dK, dV per key tile).
//
// Bound on an H100 SXM. Forward, ViT-B/16 vision at b256 (B*H = 3072
// groups, N = 197, D = 64, bf16): q, k, v read and o written once (4 x 77.5
// MB) plus lse (2.4 MB), 0.0933 ms at 3.35 TB/s, against 4*N*N*D operations
// per group (30.5 GFLOP, 0.031 ms at 989 TFLOP/s): bound by bytes. Backward:
// eight such tensors read or written and 10*D operations per pair (76.3
// GFLOP): 0.1857 ms, bytes. attn_mma_fwd.cuh and attn_mma_bwd.cuh say how
// the bf16 kernels meet them; the fp32 kernels run every product on the FMA
// pipes (67 TFLOP/s) and sit far above. The grouped layout costs the
// transposes around the kernels (q, k, v, dO in; o, dq, dk, dv out), which
// the packed K1/K3 do not need.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgrouped_attn.so grouped_attn.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_bwd.cuh"  // launch_bwd (bf16 on the tensor cores)
#include "attn_mma_fwd.cuh"  // launch_fwd (bf16 on the tensor cores)
#include "attn_rows.cuh"     // Strides

namespace {

// Strides of the contiguous grouped layout: group stride rows * D, row
// stride D, for q/o/dO/dq (n rows) and k/v/dk/dv (nk rows).
Strides grouped_strides(int n, int nk, int d) {
  const long long qs = (long long)n * d, ks = (long long)nk * d;
  return Strides{qs, d, ks, d, ks, d, qs, d, qs, d, qs, d, ks, d, ks, d};
}

}  // namespace

// K4. Returns the cudaError_t of the launch (0 = success). q [groups, n, d],
// k and v [groups, nk, d], o [groups, n, d] (input type), lse [groups, n]
// fp32; all contiguous and 16-byte aligned (checked by the caller).
extern "C" int grouped_attn_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int is_bf16, int groups,
                                int n, int nk, int head_dim, float scale,
                                int causal, void* stream) {
  const Strides st = grouped_strides(n, nk, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
#define MRCLIP_LAUNCH(T, D)                                                 \
  return launch_fwd<T, D, false>(q, k, v, o, l, nullptr, groups, n, nk, 1, \
                                 st, scale, causal, 1, nk, 1, s)
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

// K5. Returns the cudaError_t of the two launches. q, o, dout, dq
// [groups, n, d]; k, v, dk, dv [groups, nk, d]; lse [groups, n] fp32 from
// K4; delta an fp32 [groups, n] scratch. All contiguous and 16-byte aligned.
extern "C" int grouped_attn_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int is_bf16, int groups,
                                int n, int nk, int head_dim, float scale,
                                int causal, void* stream) {
  const Strides st = grouped_strides(n, nk, head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
#define MRCLIP_LAUNCH(T, D)                                                  \
  return launch_bwd<T, D, false>(q, k, v, o, dout, l, nullptr, dl, dq, dk,  \
                                 dv, groups, n, nk, 1, st, scale, causal, s)
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
