// Row-tile helpers shared by the attention kernels that give each query
// row (or key) to four neighbouring lanes of a warp: packed_attn_bwd.cu (K3,
// K3r), grouped_attn.cu (K4, K5) and flash_attn.cu (K10, K10b).
//
// A row of head dim D is split into D/4 float4 groups; lane `sub` (0..3) of
// the four owns the groups g = sub + 4*y, so the four lanes read four
// neighbouring 16-byte words of a shared-memory row (no bank conflicts) and
// two shuffles finish each dot product.
//
// Head dims that are not a multiple of 16 (72, 88, 104) are padded: a row in
// registers and in shared memory is pad16(D) columns wide, the columns from
// D on zero, so each lane keeps whole float4 groups and every product is
// the unpadded one (the zeros add nothing); only the first D columns are
// read from and written to device memory. The pad costs 11% (D = 72), 9%
// (D = 88) and 8% (D = 104) more FMAs; a lane layout that divides D (float2
// groups, 9, 11 or 13 a lane) would waste none, but halves the width of each shared-memory read
// and needs a second set of these helpers.

#pragma once

#include <cuda_bf16.h>

#include "rope.cuh"  // load_f, store_f, round_to

namespace {

constexpr int kTile = 64;  // query rows or keys per block
constexpr int kSub = 4;    // threads sharing one row or key
constexpr int kThreads = kTile * kSub;

// The head dim rounded up to a multiple of 16: the width of a row in the
// lanes' registers and in shared memory.
__host__ __device__ constexpr int pad16(int d) { return (d + 15) & ~15; }

// Rows of K and V (or Q and dO) staged at once by the fp32 kernels: their
// two fp32 tiles of kStage<D> x pad16(D) stay under the 48 KB of static
// shared memory (64 rows up to D = 80, 32 past it: 88, 104 and 112).
template <int D>
constexpr int kStage = pad16(D) <= 80 ? kTile : kTile / 2;

// Sum over the kSub lanes that share a row (neighbouring lanes of a warp).
__device__ __forceinline__ float lane_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// This lane's dims of one row of head dim D: float4 groups g = sub +
// kSub*y; the pad columns from D on read 0.
template <typename T, int D>
__device__ __forceinline__ void load_row(float4 (&dst)[pad16(D) / 16],
                                         const T* row, int sub, bool live) {
#pragma unroll
  for (int y = 0; y < pad16(D) / 16; ++y) {
    const int d = 4 * (sub + kSub * y);
    dst[y] = live && (D % 16 == 0 || d < D)
                 ? make_float4(load_f(row + d), load_f(row + d + 1),
                               load_f(row + d + 2), load_f(row + d + 3))
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The first D dims of one row from this lane's groups.
template <typename T, int D>
__device__ __forceinline__ void store_row(T* row,
                                          const float4 (&src)[pad16(D) / 16],
                                          int sub) {
#pragma unroll
  for (int y = 0; y < pad16(D) / 16; ++y) {
    const int d = 4 * (sub + kSub * y);
    if (D % 16 != 0 && d >= D) continue;
    store_f(row + d, src[y].x);
    store_f(row + d + 1, src[y].y);
    store_f(row + d + 2, src[y].z);
    store_f(row + d + 3, src[y].w);
  }
}

// Partial dot of this lane's dims with a shared-memory row. dot_part, axpy
// and zero_row take the padded width pad16(D) as their D.
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
