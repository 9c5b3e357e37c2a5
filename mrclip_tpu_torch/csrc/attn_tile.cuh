// Row-tile helpers shared by the attention kernels that give each query
// row (or key) to four neighbouring lanes of a warp: packed_attn_bwd.cu (K3,
// K3r), grouped_attn.cu (K4, K5) and flash_attn.cu (K10, K10b).
//
// A row of head dim D is split into D/4 float4 groups; lane `sub` (0..3) of
// the four owns the groups g = sub + 4*y, so the four lanes read four
// neighbouring 16-byte words of a shared-memory row (no bank conflicts) and
// two shuffles finish each dot product.

#pragma once

#include <cuda_bf16.h>

#include "rope.cuh"  // load_f, store_f, round_to

namespace {

constexpr int kTile = 64;  // query rows or keys per block
constexpr int kSub = 4;    // threads sharing one row or key
constexpr int kThreads = kTile * kSub;

// Sum over the kSub lanes that share a row (neighbouring lanes of a warp).
__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// This lane's dims of one row: float4 groups g = sub + kSub*y.
template <typename T, int D>
__device__ __forceinline__ void load_row(float4 (&dst)[D / 16], const T* row,
                                         int sub, bool live) {
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    const int d = 4 * (sub + kSub * y);
    dst[y] = live ? make_float4(load_f(row + d), load_f(row + d + 1),
                                load_f(row + d + 2), load_f(row + d + 3))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_row(T* row, const float4 (&src)[D / 16],
                                          int sub) {
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    const int d = 4 * (sub + kSub * y);
    store_f(row + d, src[y].x);
    store_f(row + d + 1, src[y].y);
    store_f(row + d + 2, src[y].z);
    store_f(row + d + 3, src[y].w);
  }
}

// Partial dot of this lane's dims with a shared-memory row.
template <int D>
__device__ __forceinline__ float dot_part(const float4 (&a)[D / 16],
                                          const float* srow, int sub) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
  float acc = 0.f;
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    const float4 b = s4[sub + kSub * y];
    acc = fmaf(a[y].x, b.x, acc);
    acc = fmaf(a[y].y, b.y, acc);
    acc = fmaf(a[y].z, b.z, acc);
    acc = fmaf(a[y].w, b.w, acc);
  }
  return acc;
}

// acc += w * (this lane's dims of a shared-memory row)
template <int D>
__device__ __forceinline__ void axpy(float4 (&acc)[D / 16], float w,
                                     const float* srow, int sub) {
  const float4* s4 = reinterpret_cast<const float4*>(srow);
#pragma unroll
  for (int y = 0; y < D / 16; ++y) {
    const float4 b = s4[sub + kSub * y];
    acc[y].x = fmaf(w, b.x, acc[y].x);
    acc[y].y = fmaf(w, b.y, acc[y].y);
    acc[y].z = fmaf(w, b.z, acc[y].z);
    acc[y].w = fmaf(w, b.w, acc[y].w);
  }
}

template <int D>
__device__ __forceinline__ void zero_row(float4 (&r)[D / 16]) {
#pragma unroll
  for (int y = 0; y < D / 16; ++y) r[y] = make_float4(0.f, 0.f, 0.f, 0.f);
}

}  // namespace
