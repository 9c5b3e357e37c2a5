// Grouped-layout fused attention's backward for Hopper (sm_90a), plain C
// interface: K5, grouped_attn_bwd, the backward of attn_impl='fused';
// replaces mrclip_tpu/ops/fused_attn.py::_bwd_kernel (:118, driven by
// _core_bwd :193). Its own library beside grouped_attn.cu's forward (K4),
// so that nvcc builds the two in parallel; grouped_attn.cu's note gives the
// values, the layout and the bounds, attn_mma_bwd.cuh the bf16 kernels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgrouped_attn_bwd.so grouped_attn_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_bwd.cuh"  // launch_bwd (bf16 on the tensor cores)
#include "attn_rows.cuh"     // Strides, grouped_strides

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
