// Element access and the EVA02 rope rotation shared by packed_attn_fwd.cu
// (K2: the fp32 FMA kernel) and packed_attn_bwd.cu (K3r's fp32 FMA kernel),
// and through attn_mma_fwd.cuh and attn_mma_bwd.cuh by their bf16
// tensor-core forms, so every kernel rotates bit-identically to the plain
// versions in mrclip_tpu_torch/ops/fused_attn.py; dw_conv.cu (K8, K9) takes
// the element access.
//
// A rope table row t holds the sin of its position in t[0, D) and the cos in
// t[D, 2D), in the input type T. Rows pair interleaved dims (2i, 2i+1):
// rot(x)[2i] = -x[2i+1], rot(x)[2i+1] = x[2i].

#pragma once

#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// x rounded to the input type and back: the TPU kernel's .astype(dt).
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// Pair (x0, x1) rotated by the sin (s0, s1) and cos (c0, c1) of its dims:
// x * cos + rot(x) * sin, every product and sum rounded once in fp32 (no FMA
// contraction), as the plain version computes it, before its one rounding
// to the input type.
__device__ __forceinline__ void rotate_pair_f32(float& x0, float& x1, float s0, float s1,
                                                float c0, float c1) {
  const float y0 = __fadd_rn(__fmul_rn(x0, c0), -__fmul_rn(x1, s0));
  const float y1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(x0, s1));
  x0 = y0;
  x1 = y1;
}

// Pair (x0, x1) at dims (d, d+1) rotated by its table row t:
// y = round_T(x * cos + rot(x) * sin) (rotate_pair_f32, then one rounding).
template <typename T, int D>
__device__ __forceinline__ void rotate_pair(float& x0, float& x1,
                                            const T* t, int d) {
  rotate_pair_f32(x0, x1, load_f(t + d), load_f(t + d + 1), load_f(t + D + d),
                  load_f(t + D + d + 1));
  x0 = round_to(x0, t);
  x1 = round_to(x1, t);
}

// The gradient pair (g0, g1) of a rotated row un-rotated by the sin (s0,
// s1) and cos (c0, c1) of its dims: dx = g * cos - rot(round_T(g * sin)),
// T the input type (of `like`, never read); fp32, each product and sum
// rounded once, the result unrounded until it is stored.
template <typename T>
__device__ __forceinline__ void unrotate_pair_f32(float& g0, float& g1, float s0, float s1,
                                                  float c0, float c1, const T* like) {
  const float gs0 = round_to(__fmul_rn(g0, s0), like);
  const float gs1 = round_to(__fmul_rn(g1, s1), like);
  const float x0 = __fadd_rn(__fmul_rn(g0, c0), gs1);
  const float x1 = __fsub_rn(__fmul_rn(g1, c1), gs0);
  g0 = x0;
  g1 = x1;
}

// The gradient pair (g0, g1) at dims (d, d+1) un-rotated by its table row
// t (unrotate_pair_f32).
template <typename T, int D>
__device__ __forceinline__ void unrotate_pair(float& g0, float& g1,
                                              const T* t, int d) {
  unrotate_pair_f32(g0, g1, load_f(t + d), load_f(t + d + 1), load_f(t + D + d),
                    load_f(t + D + d + 1), t);
}

}  // namespace
