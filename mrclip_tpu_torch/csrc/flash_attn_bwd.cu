// Flash attention's backward for Hopper (sm_90a), plain C interface: K10b,
// flash_attn_bwd, the backward of attn_impl='flash'
// (mrclip_tpu/ops/flash_attn.py::flash_attention_unpadded, :41); replaces
// jax's _flash_attention_dkv_kernel (:796) and _flash_attention_dq_kernel
// (:1146), driven by _flash_attention_bwd (:254); one call launches both
// passes. Its own library beside flash_attn.cu's forward (K10), so that nvcc
// builds the two in parallel; flash_attn.cu's note gives jax's values, the
// layout and the bounds, attn_mma_bwd.cuh the bf16 kernels (FLASH = true).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attn_bwd.so flash_attn_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_mma_bwd.cuh"  // launch_bwd (bf16 on the tensor cores)
#include "attn_rows.cuh"     // Strides, read_strides

// K10b. Returns the cudaError_t of the two launches. l, m and di are
// contiguous [batch, heads, n] fp32; `strides` as for flash_attn.cu's
// flash_attn_fwd (o's pair is not read).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v,
                              const void* dout, const void* l, const void* m,
                              const void* di, void* dq, void* dk, void* dv,
                              int is_bf16, int batch, int n, int nk,
                              int heads, int head_dim,
                              const long long* strides, float scale,
                              int causal, void* stream) {
  const Strides st = read_strides(strides);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(l);
  const float* mp = static_cast<const float*>(m);
  float* dip = const_cast<float*>(static_cast<const float*>(di));  // read only
#define MRCLIP_LAUNCH(T, D)                                                   \
  return launch_bwd<T, D, true>(q, k, v, nullptr, dout, lp, mp, dip, dq, dk, \
                                dv, batch, n, nk, heads, st, scale, causal, s)
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
