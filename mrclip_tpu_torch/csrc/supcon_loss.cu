// Fused multipositive (SupCon Eq. 2) contrastive loss for Hopper (sm_90a),
// plain C interface: three kernels behind three entry points.
//
// Replaces the TPU kernels of mrclip_tpu/ops/pallas_loss.py:
//   supcon_stats  <- _fwd_kernel     (driven by _stats): per query row i of
//                    z = scale * q k^T, the row max m_i, s_i = sum_j
//                    exp(z_ij - m_i), pos_sum_i = sum_{j in P(i)} z_ij and
//                    pos_cnt_i = |P(i)|, where P(i) = {j : label_q[i] ==
//                    label_k[j]};
//   supcon_grad_q <- _grad_q_kernel  (driven by _bwd): with
//                    coeff_ij = (exp(z_ij - m_i) / s_i - pos_ij / cnt_i)
//                               * gbar * scale,
//                    dq = coeff k and ds_i = sum_j coeff_ij (q_i . k_j) / scale;
//   supcon_grad_k <- _grad_k_kernel  (driven by _bwd): dk = coeff^T q.
// The [Nq, Nk] logits never reach device memory: each 64 x 64 tile is
// recomputed from q and k where it is needed. q and k are contiguous fp32
// [N, D], labels int32, and scale and gbar are read from device memory (no
// host synchronisation in a train step). All arithmetic is fp32 FMA, as the
// JAX package computes it (fp32 operands, no TF32).
//
// Design (a first, simple version):
//   - a 64 x 64 logit tile is computed by 256 threads, each a 4 x 4
//     micro-tile (rows ty + 16*i, columns tx + 16*j), from 16-wide slices of
//     D staged through shared memory; the sixteen threads of a row are one
//     half-warp, so row reductions are four shuffles;
//   - stats: one block per 64-row tile walks the key tiles with an online
//     max and sum-exp (the TPU kernel's accumulators, in registers);
//   - grad_q: one block per (64-row tile, 128-wide slice of D) walks the key
//     tiles, puts coeff in shared memory and adds coeff @ k[:, slice];
//     grad_k: one block per (64-key tile, slice of D) walks the row tiles
//     and adds coeff^T @ q[:, slice]. Each block of a wide D recomputes the
//     full-depth logit tile, so for D = 512 the logit products run four
//     times; no block needs atomics and the results are deterministic.
//   - ragged tiles are masked in the kernel, so any Nq, Nk and D work (the
//     TPU version shrinks its blocks to divisors instead).
//
// Bound on an H100 SXM (fp32, 67 TFLOP/s without the tensor cores): stats
// 2*Nq*Nk*D operations, grad_q and grad_k 4*Nq*Nk*D each; at B = 256, D =
// 512 that is 67 MFLOP (1.0 us) and 134 MFLOP (2.0 us), bound by operations
// (the inputs are 1 MB). The recomputation above and the fp32 FMA issue
// rate keep this version well above those bounds.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsupcon_loss.so supcon_loss.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;        // rows and keys of a logit tile
constexpr int kKC = 16;       // slice of D staged per step of the tile product
constexpr int kTD = 128;      // slice of D per block in the gradient kernels
constexpr int kKC2 = 32;      // rows/keys staged per step of the gradient product
constexpr int kThreads = 256; // 16 x 16
constexpr float kNegInit = -1e30f;  // the TPU kernel's initial running max

// Sum / max over the 16 threads of a row (one half-warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// qk[i][j] = q[r0 + ty + 16i] . k[c0 + tx + 16j] over the full depth D;
// rows and keys past the end read as zero.
__device__ __forceinline__ void qk_tile(const float* __restrict__ q,
                                        const float* __restrict__ k, int nq,
                                        int nk, int d, int r0, int c0,
                                        float (*qs)[kT + 1],
                                        float (*ks)[kT + 1],
                                        float (&qk)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) qk[i][j] = 0.f;
  for (int d0 = 0; d0 < d; d0 += kKC) {
    __syncthreads();  // the previous slice is consumed
    for (int idx = threadIdx.x; idx < kT * kKC; idx += kThreads) {
      const int r = idx / kKC;
      const int c = idx % kKC;
      const bool dc = d0 + c < d;
      qs[c][r] = (dc && r0 + r < nq) ? q[(long long)(r0 + r) * d + d0 + c] : 0.f;
      ks[c][r] = (dc && c0 + r < nk) ? k[(long long)(c0 + r) * d + d0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kKC; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[c][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[c][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) qk[i][j] = fmaf(a[i], b[j], qk[i][j]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    supcon_stats_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const int* __restrict__ lq, const int* __restrict__ lk,
                        const float* __restrict__ scale_p,
                        float* __restrict__ m_out, float* __restrict__ s_out,
                        float* __restrict__ pos_sum_out,
                        float* __restrict__ pos_cnt_out, int nq, int nk,
                        int d) {
  __shared__ float qs[kKC][kT + 1];
  __shared__ float ks[kKC][kT + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * kT;
  const float scale = *scale_p;

  int lab[4];
  float m[4], s[4], ps[4], pc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    lab[i] = row < nq ? lq[row] : 0;
    m[i] = kNegInit;
    s[i] = 0.f;
    ps[i] = 0.f;
    pc[i] = 0.f;
  }
  for (int c0 = 0; c0 < nk; c0 += kT) {
    float qk[4][4];
    qk_tile(q, k, nq, nk, d, r0, c0, qs, ks, qk);
    int klab[4];
    bool kin[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = c0 + tx + 16 * j;
      kin[j] = key < nk;
      klab[j] = kin[j] ? lk[key] : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float z[4];
      float bmax = -INFINITY, psum = 0.f, pcnt = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        z[j] = scale * qk[i][j];
        if (kin[j]) {
          bmax = fmaxf(bmax, z[j]);
          if (klab[j] == lab[i]) {
            psum += z[j];
            pcnt += 1.f;
          }
        }
      }
      const float m_new = fmaxf(m[i], row_max(bmax));
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (kin[j]) e += expf(z[j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
      ps[i] += row_sum(psum);
      pc[i] += row_sum(pcnt);
    }
  }
  if (tx != 0) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row < nq) {
      m_out[row] = m[i];
      s_out[row] = s[i];
      pos_sum_out[row] = ps[i];
      pos_cnt_out[row] = pc[i];
    }
  }
}

// coeff_ij of one logit tile into cs[row][key] (zero outside the matrix);
// returns this thread's per-row sums of coeff * qk in ds_part.
__device__ __forceinline__ void coeff_tile(
    const float (&qk)[4][4], const int* __restrict__ lq,
    const int* __restrict__ lk, const float* __restrict__ m,
    const float* __restrict__ s, const float* __restrict__ cnt, int nq,
    int nk, int r0, int c0, float scale, float gbar, float (*cs)[kT + 1],
    float (&ds_part)[4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    const bool rin = row < nq;
    const int lab = rin ? lq[row] : 0;
    const float mi = rin ? m[row] : 0.f;
    const float si = rin ? s[row] : 1.f;
    const float ci = rin ? cnt[row] : 1.f;
    ds_part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = c0 + tx + 16 * j;
      float coeff = 0.f;
      if (rin && key < nk) {
        const float z = scale * qk[i][j];
        const float p = expf(z - mi) / si;
        const float pos = lk[key] == lab ? 1.f : 0.f;
        coeff = (p - pos / ci) * gbar * scale;
        ds_part[i] = fmaf(coeff, qk[i][j], ds_part[i]);
      }
      cs[ty + 16 * i][tx + 16 * j] = coeff;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    supcon_grad_q_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const int* __restrict__ lq,
                         const int* __restrict__ lk,
                         const float* __restrict__ m,
                         const float* __restrict__ s,
                         const float* __restrict__ cnt,
                         const float* __restrict__ scale_p,
                         const float* __restrict__ gbar_p,
                         float* __restrict__ dq, float* __restrict__ ds_rows,
                         int nq, int nk, int d) {
  __shared__ float qs[kKC][kT + 1];
  __shared__ float ks[kKC][kT + 1];
  __shared__ float cs[kT][kT + 1];
  __shared__ __align__(16) float kd[kKC2][kTD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * kT;
  const int dd0 = blockIdx.y * kTD;
  const float scale = *scale_p;
  const float gbar = *gbar_p;

  float acc[4][8];
  float ds_acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ds_acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  for (int c0 = 0; c0 < nk; c0 += kT) {
    float qk[4][4], ds_part[4];
    qk_tile(q, k, nq, nk, d, r0, c0, qs, ks, qk);
    coeff_tile(qk, lq, lk, m, s, cnt, nq, nk, r0, c0, scale, gbar, cs,
               ds_part);
#pragma unroll
    for (int i = 0; i < 4; ++i) ds_acc[i] += row_sum(ds_part[i]) / scale;
    // dq[rows, slice] += coeff[rows, keys] @ k[keys, slice]
    for (int kk = 0; kk < kT; kk += kKC2) {
      __syncthreads();  // cs is written / the previous kd is consumed
      for (int idx = threadIdx.x; idx < kKC2 * kTD; idx += kThreads) {
        const int r = idx / kTD;
        const int c = idx % kTD;
        const int key = c0 + kk + r;
        kd[r][c] = (key < nk && dd0 + c < d) ? k[(long long)key * d + dd0 + c]
                                             : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kKC2; ++r) {
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = kd[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = cs[ty + 16 * i][kk + r];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= nq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = dd0 + tx + 16 * j;
      if (col < d) dq[(long long)row * d + col] = acc[i][j];
    }
    if (blockIdx.y == 0 && tx == 0) ds_rows[row] = ds_acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
    supcon_grad_k_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const int* __restrict__ lq,
                         const int* __restrict__ lk,
                         const float* __restrict__ m,
                         const float* __restrict__ s,
                         const float* __restrict__ cnt,
                         const float* __restrict__ scale_p,
                         const float* __restrict__ gbar_p,
                         float* __restrict__ dk, int nq, int nk, int d) {
  __shared__ float qs[kKC][kT + 1];
  __shared__ float ks[kKC][kT + 1];
  __shared__ float cs[kT][kT + 1];
  __shared__ __align__(16) float qd[kKC2][kTD];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int c0 = blockIdx.x * kT;
  const int dd0 = blockIdx.y * kTD;
  const float scale = *scale_p;
  const float gbar = *gbar_p;

  float acc[4][8];  // keys ty + 16i, dims dd0 + tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int r0 = 0; r0 < nq; r0 += kT) {
    float qk[4][4], ds_part[4];
    qk_tile(q, k, nq, nk, d, r0, c0, qs, ks, qk);
    coeff_tile(qk, lq, lk, m, s, cnt, nq, nk, r0, c0, scale, gbar, cs,
               ds_part);
    // dk[keys, slice] += coeff[rows, keys]^T @ q[rows, slice]
    for (int rr = 0; rr < kT; rr += kKC2) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < kKC2 * kTD; idx += kThreads) {
        const int r = idx / kTD;
        const int c = idx % kTD;
        const int row = r0 + rr + r;
        qd[r][c] = (row < nq && dd0 + c < d) ? q[(long long)row * d + dd0 + c]
                                             : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < kKC2; ++r) {
        float b[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = qd[r][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = cs[rr + r][ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = c0 + ty + 16 * i;
    if (key >= nk) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = dd0 + tx + 16 * j;
      if (col < d) dk[(long long)key * d + col] = acc[i][j];
    }
  }
}

inline int tiles(int n, int t) { return (n + t - 1) / t; }

}  // namespace

// Each returns the cudaError_t of its launch (0 = success). The caller has
// checked shapes, types, contiguity and devices; nq, nk and d are positive.
extern "C" int supcon_stats(const void* q, const void* k, const void* lq,
                            const void* lk, const void* scale, void* m,
                            void* s, void* pos_sum, void* pos_cnt, int nq,
                            int nk, int d, void* stream) {
  supcon_stats_kernel<<<tiles(nq, kT), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const int*>(lq), static_cast<const int*>(lk),
      static_cast<const float*>(scale), static_cast<float*>(m),
      static_cast<float*>(s), static_cast<float*>(pos_sum),
      static_cast<float*>(pos_cnt), nq, nk, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int supcon_grad_q(const void* q, const void* k, const void* lq,
                             const void* lk, const void* m, const void* s,
                             const void* cnt, const void* scale,
                             const void* gbar, void* dq, void* ds_rows, int nq,
                             int nk, int d, void* stream) {
  const dim3 grid(tiles(nq, kT), tiles(d, kTD));
  supcon_grad_q_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const int*>(lq), static_cast<const int*>(lk),
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(cnt), static_cast<const float*>(scale),
      static_cast<const float*>(gbar), static_cast<float*>(dq),
      static_cast<float*>(ds_rows), nq, nk, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int supcon_grad_k(const void* q, const void* k, const void* lq,
                             const void* lk, const void* m, const void* s,
                             const void* cnt, const void* scale,
                             const void* gbar, void* dk, int nq, int nk, int d,
                             void* stream) {
  const dim3 grid(tiles(nk, kT), tiles(d, kTD));
  supcon_grad_k_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const int*>(lq), static_cast<const int*>(lk),
      static_cast<const float*>(m), static_cast<const float*>(s),
      static_cast<const float*>(cnt), static_cast<const float*>(scale),
      static_cast<const float*>(gbar), static_cast<float*>(dk), nq, nk, d);
  return static_cast<int>(cudaGetLastError());
}
