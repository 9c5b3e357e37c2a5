// Fused multipositive (SupCon Eq. 2) contrastive loss for Hopper (sm_90a),
// plain C interface: three entry points, each one counted launch of its main
// kernel (and, where the caller's plan splits the walk, a merge kernel).
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
// The [Nq, Nk] logits never reach device memory. q and k are contiguous
// fp32 [N, D], labels int32, and scale and gbar are read from device memory
// (no host synchronisation in a train step). All arithmetic is fp32 FMA, as
// the JAX package computes it (fp32 operands, no TF32, no tensor cores).
//
// Bound on an H100 SXM (fp32, 67 TFLOP/s without the tensor cores): stats
// 2*Nq*Nk*D operations, grad_q and grad_k 4*Nq*Nk*D each; at B = 256, D =
// 512 that is 67 MFLOP (1.0 us) and 134 MFLOP (2.0 us), at B = 8192 1.026
// and 2.051 ms, bound by operations (the inputs are 1 MB and 32 MB).
//
// Design. How a call cuts its work (tiles, splits, copy width, scratch) is
// decided by ops/pallas_loss.py::plan; the entries take it as given and size
// each instantiation's shared memory from its tile. What the design does about the three causes that held the
// port's first version of these kernels at 6-9x its bound:
//   1. Too few blocks at the train batch: every kernel's grid is (tiles of
//      its own rows) x (splits of its walk) [x (512-wide slices of D),
//      gradients past D = 512 only]. At small batches the walk over keys
//      (stats, grad_q) or query rows (grad_k) is split so that the grid
//      fills the card (B = 256: 32-row tiles x 8 splits, 64 blocks each);
//      each split writes its partials to a scratch the wrapper allocates,
//      and a second kernel merges them in split order (supcon_stats_merge:
//      m = max m_k, s = sum s_k exp(m_k - m), pos_sum and pos_cnt summed;
//      supcon_sum_splits: dq, ds or dk partials added). No atomics: two
//      runs give the same bits.
//   2. Each logit was computed four times in the gradients (a block per
//      128-wide slice of D recomputed the full-depth tile): a gradient
//      block now owns 64 rows (32 at small batches) and their whole dq
//      (dk) of up to 512 columns in registers, keeps those rows resident in
//      shared memory for its walk, computes each 64 x 128 logit tile of
//      the walk once, turns it into coeff^T in shared memory and adds
//      coeff @ walk[tile, :] for all of D from 4-row chunks of the walk
//      (a ring of three). At D = 512 a kernel issues the bound's operations
//      plus masked edges; past 512, slices of 512 columns each recompute
//      the logits.
//   3. The inner loop was bound by shared-memory loads: one tile routine
//      (tile_product) serves all three kernels. A block of 256 threads
//      computes a TM x TN logit tile over the full depth; each thread a
//      register micro-tile of (TM/16) x (TN/16) (8 x 8 at K6's 128 x 128,
//      4 x 8 at K7's 64 x 128). q and k are staged in 32-column slices of
//      D, row-major with a 4-word pad (rows 36 words apart), by 16-byte
//      cp.async, double-buffered so that the next slice is in flight while
//      the current one is multiplied; a thread reads four depths of a row
//      with one 16-byte shared load. Such a load costs the SM 4 cycles a
//      warp when a quarter-warp reads 4 or more addresses, about 2.4 when
//      it reads one or two (tools/supcon_variants.py --shared-loads), so
//      each warp's lanes share one operand by quarter-warp: K6's rows
//      (a half-warp a row, whose sums are shuffles), K7's walk rows (8 own
//      rows x 4 walk rows a warp). A D that is not a multiple of 4 (or an
//      operand off 16-byte alignment) stages element by element through
//      the same buffers, in its own instantiation (WIDE false). Rows and
//      keys past the edge read as zero and are masked.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libsupcon_loss.so supcon_loss.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx over keys, ty over rows
constexpr int kKC = 32;        // columns of D staged per step of the tile product
constexpr int kStages = 2;     // the tile product's ring of staged slices
constexpr int kLd = kKC + 4;   // a staged row's stride, words
constexpr int kDS = 512;       // columns of D a gradient block accumulates
constexpr int kWK = 4;         // walk rows staged per step of the gradient product
constexpr int kWBufs = 3;      // its ring of staged chunks
constexpr int kLdA = kDS + 4;  // a resident row's stride, words
constexpr float kNegInit = -1e30f;  // the TPU kernel's initial running max
constexpr int kSmemMax = 232448;    // an H100 block's shared memory, bytes

__device__ __forceinline__ int tiles_of(int n, int t) { return (n + t - 1) / t; }

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

// 16-byte copy global -> shared; zero-fills (reads nothing) when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4-byte copy global -> shared; zero-fills (reads nothing) when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + T) x columns [c0, c0 + W) of x (n rows of d) into
// s[T][ld]; zero outside x. `wide`: d % 4 == 0 and x 16-byte aligned, so a
// 4-column group is wholly in or out, copied asynchronously; otherwise
// element by element (synchronous).
template <int T, int W>
__device__ __forceinline__ void stage(const float* __restrict__ x, int n, int d, int r0,
                                      int c0, int ld, bool wide, float* s) {
  if (wide) {
    constexpr int kVec = T * W / 4;
#pragma unroll
    for (int it = 0; it < (kVec + kThreads - 1) / kThreads; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      if (kVec % kThreads != 0 && idx >= kVec) break;
      const int r = idx / (W / 4);
      const int c = (idx % (W / 4)) * 4;
      const bool ok = r0 + r < n && c0 + c < d;
      cp_async16(s + r * ld + c, ok ? x + (long long)(r0 + r) * d + c0 + c : x, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < T * W; idx += kThreads) {
      const int r = idx / W;
      const int c = idx % W;
      s[r * ld + c] =
          (r0 + r < n && c0 + c < d) ? x[(long long)(r0 + r) * d + c0 + c] : 0.f;
    }
  }
}

// The copies of slice `sl` (columns [kKC sl, kKC sl + kKC) of d) of a tile
// product into one stage `dst`: a's TM rows (unless a is resident) and b's
// TN rows; then one cp.async group (empty past the last slice, so that each
// slice owns one group and the waits count alike).
template <int TM, int TN, bool RES>
__device__ __forceinline__ void stage_slice(const float* __restrict__ a, int na, int a0,
                                            const float* __restrict__ b, int nb, int b0,
                                            int d, int sl, bool wide, float* dst) {
  if (sl * kKC < d) {
    if (!RES) stage<TM, kKC>(a, na, d, a0, sl * kKC, kLd, wide, dst);
    stage<TN, kKC>(b, nb, d, b0, sl * kKC, kLd, wide, dst + (RES ? 0 : TM * kLd));
  }
  cp_async_commit();
}

// One stage of a tile product, words.
template <int TM, int TN, bool RES>
__host__ __device__ constexpr int stage_words() { return ((RES ? 0 : TM) + TN) * kLd; }

// acc[i][j] = a[a0 + ty + 16i] . b[b0 + tx + 16j] over the full depth d;
// rows of a past na and of b past nb read as zero. `buf` holds a ring of
// kStages stages; with RES, a's rows are resident in `ares` (kLdA words
// apart, all of d <= kDS). Slice sl + kStages - 1 is issued while slice sl
// is multiplied. `issued`: the caller has already issued slices 0 ..
// kStages - 2 (kStages - 1 groups, stage_slice). Every thread of the block
// calls it; on return the stages are free and no copy of it is in flight.
// Thread layout: each half-warp one ty, its 16 lanes tx (a row's sums are
// shuffles; a's loads are one address a quarter-warp), or with SQUAT each
// warp 8 ty x 4 tx (b's loads one address a quarter-warp: the cheaper
// operand is the one with more fragments).
template <int TM, int TN, bool SQUAT, bool RES>
__device__ __forceinline__ void tile_product(const float* __restrict__ a, int na, int a0,
                                             const float* __restrict__ b, int nb, int b0,
                                             int d, bool wide, float* buf, const float* ares,
                                             bool issued, float (&acc)[TM / 16][TN / 16]) {
  constexpr int MR = TM / 16, NR = TN / 16, kBuf = stage_words<TM, TN, RES>();
  constexpr int kLdAs = RES ? kLdA : kLd;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int tx = SQUAT ? lane / 8 + 4 * (warp / 2) : threadIdx.x % 16;
  const int ty = SQUAT ? lane % 8 + 8 * (warp % 2) : threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < NR; ++j) acc[i][j] = 0.f;
  const int slices = tiles_of(d, kKC);
  if (!issued)
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p)
      stage_slice<TM, TN, RES>(a, na, a0, b, nb, b0, d, p, wide, buf + p * kBuf);
  for (int sl = 0; sl < slices; ++sl) {
    const int ahead = sl + kStages - 1;
    stage_slice<TM, TN, RES>(a, na, a0, b, nb, b0, d, ahead, wide,
                             buf + (ahead % kStages) * kBuf);
    cp_async_wait<kStages - 1>();
    __syncthreads();  // slice sl has landed for every thread
    const float* cur = buf + (sl % kStages) * kBuf;
    const float* as = RES ? ares + sl * kKC : cur;
    const float* bs = cur + (RES ? 0 : TM * kLd);
#pragma unroll
    for (int c = 0; c < kKC; c += 4) {
      float4 av[MR];
#pragma unroll
      for (int i = 0; i < MR; ++i)
        av[i] = *reinterpret_cast<const float4*>(as + (ty + 16 * i) * kLdAs + c);
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * kLd + c);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          acc[i][j] = fmaf(av[i].x, bv.x, acc[i][j]);
          acc[i][j] = fmaf(av[i].y, bv.y, acc[i][j]);
          acc[i][j] = fmaf(av[i].z, bv.z, acc[i][j]);
          acc[i][j] = fmaf(av[i].w, bv.w, acc[i][j]);
        }
      }
    }
    __syncthreads();  // slice sl is consumed before its stage is refilled
  }
}

// K6. Block (row tile, split): rows [r0, r0 + TM) over key tiles [t0, t1)
// with the TPU kernel's online max / sum-exp / positive sum and count;
// writes them at out + split * nq (the outputs themselves when there is one
// split, else the merge's partials).
template <int TM, int TN, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    supcon_stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const int* __restrict__ lq, const int* __restrict__ lk,
                        const float* __restrict__ scale_p, float* __restrict__ m_out,
                        float* __restrict__ s_out, float* __restrict__ pos_sum_out,
                        float* __restrict__ pos_cnt_out, int nq, int nk, int d,
                        int per_split) {
  constexpr int MR = TM / 16, NR = TN / 16;
  extern __shared__ float4 smem4[];
  float* buf = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = blockIdx.x * TM;
  const int t0 = blockIdx.y * per_split;
  const int t1 = min(t0 + per_split, tiles_of(nk, TN));
  const float scale = *scale_p;

  int lab[MR];
  float m[MR], s[MR], ps[MR], pc[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int row = r0 + ty + 16 * i;
    lab[i] = row < nq ? lq[row] : 0;
    m[i] = kNegInit;
    s[i] = 0.f;
    ps[i] = 0.f;
    pc[i] = 0.f;
  }
  for (int t = t0; t < t1; ++t) {
    const int c0 = t * TN;
    float qk[MR][NR];
    tile_product<TM, TN, false, false>(q, nq, r0, k, nk, c0, d, WIDE, buf, nullptr,
                                      false, qk);
    int klab[NR];
    bool kin[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int key = c0 + tx + 16 * j;
      kin[j] = key < nk;
      klab[j] = kin[j] ? lk[key] : 0;
    }
#pragma unroll
    for (int i = 0; i < MR; ++i) {
      float z[NR];
      float bmax = -INFINITY, psum = 0.f, pcnt = 0.f;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
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
      for (int j = 0; j < NR; ++j)
        if (kin[j]) e += expf(z[j] - m_new);
      s[i] = s[i] * expf(m[i] - m_new) + row_sum(e);
      m[i] = m_new;
      ps[i] += row_sum(psum);
      pc[i] += row_sum(pcnt);
    }
  }
  if (tx != 0) return;
  const long long off = (long long)blockIdx.y * nq;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row < nq) {
      m_out[off + row] = m[i];
      s_out[off + row] = s[i];
      pos_sum_out[off + row] = ps[i];
      pos_cnt_out[off + row] = pc[i];
    }
  }
}

// K6's merge: part holds [4][splits][nq] (m, s, pos_sum, pos_cnt of each
// split); the splits are merged in order.
__global__ void __launch_bounds__(kThreads)
    supcon_stats_merge(const float* __restrict__ part, float* __restrict__ m_out,
                       float* __restrict__ s_out, float* __restrict__ pos_sum_out,
                       float* __restrict__ pos_cnt_out, int nq, int splits) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= nq) return;
  const long long plane = (long long)splits * nq;
  const float* pm = part;
  const float* pss = part + plane;
  const float* pps = part + 2 * plane;
  const float* ppc = part + 3 * plane;
  float m = pm[row];
  for (int sp = 1; sp < splits; ++sp) m = fmaxf(m, pm[(long long)sp * nq + row]);
  float s = 0.f, ps = 0.f, pc = 0.f;
  for (int sp = 0; sp < splits; ++sp) {
    const long long at = (long long)sp * nq + row;
    s += pss[at] * expf(pm[at] - m);
    ps += pps[at];
    pc += ppc[at];
  }
  m_out[row] = m;
  s_out[row] = s;
  pos_sum_out[row] = ps;
  pos_cnt_out[row] = pc;
}

// K7's merge: out[i] = part[0][i] + part[1][i] + ... in split order.
__global__ void __launch_bounds__(kThreads)
    supcon_sum_splits(const float* __restrict__ part, float* __restrict__ out,
                      long long n, int splits) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (long long)gridDim.x * kThreads) {
    float acc = part[i];
    for (int sp = 1; sp < splits; ++sp) acc += part[(long long)sp * n + i];
    out[i] = acc;
  }
}

// K7. The block owns TM rows of its side ("own": query rows for grad_q,
// keys for grad_k) and columns [ds0, ds0 + kDS) of their gradient, and
// walks tiles [t0, t1) of TN rows of the other side ("walk"). For each walk
// tile: the TM x TN logit tile over the full depth (tile_product, each warp
// 8 own rows x 4 walk rows of threads; with RES the own rows stay in shared
// memory for the whole walk), coeff^T into shared memory, then
// grad[own, cols] += coeff @ walk[tile, cols] from kWK-row chunks of the
// walk tile, a ring of kWBufs filled by cp.async (one barrier a chunk). The
// gradient accumulator sits in registers, a thread's own rows 4 rg + 32 h
// (+0..3) and columns ds0 + 4 cg + 128 jj (+0..3): per walk row two (one)
// 16-byte loads of coeff and four of the walk row feed 128 (64) FMAs. The
// own rows' labels and statistics sit in shared memory, not registers; the
// walk tile's are copied there beside its first chunk. grad_q also sums ds
// of its rows (slice 0), reduced across threads once, at the end. Writes
// at out + split * n_own * d (ds at ds_out + split * nq).
template <int TM, int TN, bool GRAD_K, bool RES, bool WIDE>
__global__ void __launch_bounds__(kThreads)
    supcon_grad_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const int* __restrict__ lq, const int* __restrict__ lk,
                       const float* __restrict__ m, const float* __restrict__ s,
                       const float* __restrict__ cnt, const float* __restrict__ scale_p,
                       const float* __restrict__ gbar_p, float* __restrict__ out,
                       float* __restrict__ ds_out, int nq, int nk, int d, int per_split) {
  constexpr int MR = TM / 16, NR = TN / 16;
  constexpr int kLdC = TM + 4;      // coeff^T row stride
  constexpr int kRows = TM / 32;    // 4-row groups of a thread's accumulator
  constexpr int kCols = kDS / 128;  // 4-column groups
  constexpr int kChunks = TN / kWK;
  extern __shared__ float4 smem4[];
  float* ares = reinterpret_cast<float*>(smem4);   // RES: TM x kLdA, the own rows
  float* buf = ares + (RES ? TM * kLdA : 0);       // kStages stages
  float* wbuf = buf + kStages * stage_words<TM, TN, RES>();  // kWBufs x kWK x kDS
  float* ct = wbuf + kWBufs * kWK * kDS;           // TN x kLdC: coeff^T
  int* olab = reinterpret_cast<int*>(ct + TN * kLdC);  // TM labels, then m, s, cnt
  float* om = ct + TN * kLdC + TM;
  float* os = om + TM;
  float* oc = os + TM;
  int* wlab = reinterpret_cast<int*>(oc + TM);     // TN labels, then m, s, cnt (grad_k)
  float* wm = oc + TM + TN;
  float* wsum = wm + TN;
  float* wc = wsum + TN;
  // the logit tile's thread layout (tile_product<..., true>)
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int ty = lane % 8 + 8 * (warp % 2);
  const int tx = lane / 8 + 4 * (warp / 2);
  // the gradient product's
  const int rg = threadIdx.x % 8;
  const int cg = threadIdx.x / 8;
  const float* own = GRAD_K ? k : q;
  const float* walk = GRAD_K ? q : k;
  const int n_own = GRAD_K ? nk : nq;
  const int n_walk = GRAD_K ? nq : nk;
  const int o0 = blockIdx.x * TM;
  const int t0 = blockIdx.y * per_split;
  const int t1 = min(t0 + per_split, tiles_of(n_walk, TN));
  const int ds0 = blockIdx.z * kDS;
  constexpr bool wd = WIDE;
  const float scale = *scale_p;
  const float gbar = *gbar_p;

  if (threadIdx.x < TM) {  // the own rows' labels and, for grad_q, statistics
    const int o = o0 + threadIdx.x;
    const bool in = o < n_own;
    olab[threadIdx.x] = in ? (GRAD_K ? lk[o] : lq[o]) : 0;
    om[threadIdx.x] = (!GRAD_K && in) ? m[o] : 0.f;
    os[threadIdx.x] = (!GRAD_K && in) ? s[o] : 1.f;
    oc[threadIdx.x] = (!GRAD_K && in) ? cnt[o] : 1.f;
  }  // read after tile_product's first barrier
  float acc[4 * kRows][4 * kCols];
  float ds_t[MR];
#pragma unroll
  for (int i = 0; i < MR; ++i) ds_t[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 4 * kRows; ++r)
#pragma unroll
    for (int c = 0; c < 4 * kCols; ++c) acc[r][c] = 0.f;
  if (RES) {  // the own rows, all of d, once
    stage<TM, kDS>(own, n_own, d, o0, 0, kLdA, wd, ares);
    cp_async_commit();
  }
#pragma unroll
  for (int p = 0; p < kStages - 1; ++p)
    stage_slice<TM, TN, RES>(own, n_own, o0, walk, n_walk, t0 * TN, d, p, wd,
                             buf + p * stage_words<TM, TN, RES>());
  for (int t = t0; t < t1; ++t) {
    const int w0 = t * TN;
    // the first chunk of walk rows and the walk rows' labels (and
    // statistics) fly while the logit tile is computed; their buffers were
    // consumed before the last chunk of the previous tile
    stage<kWK, kDS>(walk, n_walk, d, w0, ds0, kDS, wd, wbuf);
    if (threadIdx.x < TN) {
      const int w = w0 + threadIdx.x;
      const bool in = w < n_walk;
      const int at = in ? w : 0;
      cp_async4(wlab + threadIdx.x, (GRAD_K ? lq : lk) + at, in);
      if (GRAD_K) {
        cp_async4(wm + threadIdx.x, m + at, in);
        cp_async4(wsum + threadIdx.x, s + at, in);
        cp_async4(wc + threadIdx.x, cnt + at, in);
      }
    }
    cp_async_commit();
    float qk[MR][NR];
    tile_product<TM, TN, true, RES>(own, n_own, o0, walk, n_walk, w0, d, wd, buf, ares, true,
                                    qk);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int wl = tx + 16 * j;
      const bool win = w0 + wl < n_walk;
#pragma unroll
      for (int i = 0; i < MR; ++i) {
        const int ol = ty + 16 * i;
        float coeff = 0.f;
        if (o0 + ol < n_own && win) {
          const float mi = GRAD_K ? wm[wl] : om[ol];
          const float si = GRAD_K ? wsum[wl] : os[ol];
          const float ci = GRAD_K ? wc[wl] : oc[ol];
          const float p = expf(scale * qk[i][j] - mi) / si;
          const float pos = olab[ol] == wlab[wl] ? 1.f : 0.f;
          coeff = (p - pos / ci) * gbar * scale;
          if (!GRAD_K) ds_t[i] = fmaf(coeff, qk[i][j], ds_t[i]);
        }
        ct[(tx + 16 * j) * kLdC + ol] = coeff;
      }
    }
    for (int ch = 0; ch < kChunks; ++ch) {
      // chunk ch + 1 goes where chunk ch - 2 was, consumed before the
      // barrier of chunk ch - 1 that this thread has passed
      if (ch + 1 < kChunks) {
        stage<kWK, kDS>(walk, n_walk, d, w0 + (ch + 1) * kWK, ds0, kDS, wd,
                        wbuf + ((ch + 1) % kWBufs) * kWK * kDS);
        cp_async_commit();
        cp_async_wait<1>();
      } else if (t + 1 < t1) {  // the next tile's first slices fly during the last chunk
#pragma unroll
        for (int p = 0; p < kStages - 1; ++p)
          stage_slice<TM, TN, RES>(own, n_own, o0, walk, n_walk, w0 + TN, d, p, wd,
                                   buf + p * stage_words<TM, TN, RES>());
        cp_async_wait<kStages - 1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // chunk ch has landed (and, at ch = 0, coeff^T is written)
      const float* wb = wbuf + (ch % kWBufs) * kWK * kDS;
      const float* cw = ct + ch * kWK * kLdC;
#pragma unroll
      for (int w = 0; w < kWK; ++w) {
        float4 a[kRows];
#pragma unroll
        for (int h = 0; h < kRows; ++h)
          a[h] = *reinterpret_cast<const float4*>(cw + w * kLdC + 4 * rg + 32 * h);
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) {
          const float4 b = *reinterpret_cast<const float4*>(wb + w * kDS + 4 * cg + 128 * jj);
#pragma unroll
          for (int h = 0; h < kRows; ++h) {
            const float av[4] = {a[h].x, a[h].y, a[h].z, a[h].w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* r = acc[4 * h + e] + 4 * jj;
              r[0] = fmaf(av[e], b.x, r[0]);
              r[1] = fmaf(av[e], b.y, r[1]);
              r[2] = fmaf(av[e], b.z, r[2]);
              r[3] = fmaf(av[e], b.w, r[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // the last chunks, coeff^T and the walk labels are consumed
  }
  if (!GRAD_K) {  // ds of each own row: the 16 threads' sums, in order
    float* red = buf;  // free: the walk ended with a barrier, no copy in flight
#pragma unroll
    for (int i = 0; i < MR; ++i) red[(ty + 16 * i) * 16 + tx] = ds_t[i];
    __syncthreads();
    const int o = o0 + threadIdx.x;
    if (threadIdx.x < TM && blockIdx.z == 0 && o < nq) {
      float ds = 0.f;
      for (int x = 0; x < 16; ++x) ds += red[threadIdx.x * 16 + x];
      ds_out[(long long)blockIdx.y * nq + o] = ds / scale;
    }
  }
  float* dst = out + (long long)blockIdx.y * n_own * d;
#pragma unroll
  for (int h = 0; h < kRows; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + 4 * rg + 32 * h + e;
      if (o >= n_own) continue;
      float* row = dst + (long long)o * d;
      const float* r = acc[4 * h + e];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const int col = ds0 + 4 * cg + 128 * jj;
        if (wd) {
          if (col < d)
            *reinterpret_cast<float4*>(row + col) =
                make_float4(r[4 * jj], r[4 * jj + 1], r[4 * jj + 2], r[4 * jj + 3]);
        } else {
#pragma unroll
          for (int f = 0; f < 4; ++f)
            if (col + f < d) row[col + f] = r[4 * jj + f];
        }
      }
    }
}

// The shared memory each kernel lays out, bytes.
constexpr int stats_smem(int tm, int tn) { return kStages * (tm + tn) * kLd * 4; }
constexpr int grad_smem(int tm, int tn, bool res) {
  return ((res ? tm * kLdA + kStages * tn * kLd : kStages * (tm + tn) * kLd) +
          kWBufs * kWK * kDS + tn * (tm + 4) + 4 * tm + 4 * tn) * 4;
}

int refuse() { return static_cast<int>(cudaErrorInvalidValue); }

template <int TM, int TN>
int launch_stats(const float* q, const float* k, const int* lq, const int* lk,
                 const float* scale, float* const* dst, int nq, int nk, int d,
                 int splits, int per_split, int wide, cudaStream_t st) {
  constexpr int smem = stats_smem(TM, TN);
  static_assert(smem <= kSmemMax, "the statistics tile does not fit a block");
  auto kernel = wide ? supcon_stats_kernel<TM, TN, true> : supcon_stats_kernel<TM, TN, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + TM - 1) / TM, splits);
  kernel<<<grid, kThreads, smem, st>>>(q, k, lq, lk, scale, dst[0], dst[1], dst[2], dst[3],
                                       nq, nk, d, per_split);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int TN, bool GRAD_K, bool RES>
int launch_grad(const float* q, const float* k, const int* lq, const int* lk,
                const float* m, const float* s, const float* cnt, const float* scale,
                const float* gbar, float* out, float* ds_out, int nq, int nk, int d,
                int splits, int per_split, int dslices, int wide, cudaStream_t st) {
  constexpr int smem = grad_smem(TM, TN, RES);
  static_assert(smem <= kSmemMax, "the gradient tile does not fit a block");
  if (dslices * kDS < d || (RES && d > kDS)) return refuse();
  auto kernel = wide ? supcon_grad_kernel<TM, TN, GRAD_K, RES, true>
                     : supcon_grad_kernel<TM, TN, GRAD_K, RES, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(((GRAD_K ? nk : nq) + TM - 1) / TM, splits, dslices);
  kernel<<<grid, kThreads, smem, st>>>(q, k, lq, lk, m, s, cnt, scale, gbar, out, ds_out, nq,
                                       nk, d, per_split);
  return static_cast<int>(cudaGetLastError());
}

int sum_splits(const float* part, float* out, long long n, int splits, cudaStream_t st) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  supcon_sum_splits<<<static_cast<unsigned>(blocks < 65536 ? blocks : 65536), kThreads, 0,
                      st>>>(part, out, n, splits);
  return static_cast<int>(cudaGetLastError());
}

// One gradient call: the kernel into out / ds_out, or into the partials and
// then their sums.
template <bool GRAD_K>
int grad_call(const void* q, const void* k, const void* lq, const void* lk, const void* m,
              const void* s, const void* cnt, const void* scale, const void* gbar, void* out,
              void* ds_rows, void* part, void* part_ds, int nq, int nk, int d, int tm,
              int tn, int splits, int per_split, int dslices, int resident, int wide,
              void* stream) {
  if (splits < 1 || per_split < 1 || dslices < 1 || (splits > 1 && part == nullptr) ||
      (splits > 1 && !GRAD_K && part_ds == nullptr))
    return refuse();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(splits > 1 ? part : out);
  float* ods = static_cast<float*>(splits > 1 ? part_ds : ds_rows);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* lqi = static_cast<const int*>(lq);
  const auto* lki = static_cast<const int*>(lk);
  const auto* mf = static_cast<const float*>(m);
  const auto* sf = static_cast<const float*>(s);
  const auto* cf = static_cast<const float*>(cnt);
  const auto* scf = static_cast<const float*>(scale);
  const auto* gf = static_cast<const float*>(gbar);
  int err;
#define MRCLIP_GRAD(TM, TN, RES)                                                             \
  launch_grad<TM, TN, GRAD_K, RES>(qf, kf, lqi, lki, mf, sf, cf, scf, gf, o, ods, nq, nk, d,   \
                                   splits, per_split, dslices, wide, st)
  if (tm == 64 && tn == 128)
    err = resident ? MRCLIP_GRAD(64, 128, true) : MRCLIP_GRAD(64, 128, false);
  else if (tm == 32 && tn == 32)
    err = resident ? MRCLIP_GRAD(32, 32, true) : MRCLIP_GRAD(32, 32, false);
  else
    return refuse();
#undef MRCLIP_GRAD
  if (err != 0 || splits == 1) return err;
  const long long n_own = GRAD_K ? nk : nq;
  err = sum_splits(static_cast<const float*>(part), static_cast<float*>(out), n_own * d,
                   splits, st);
  if (err != 0 || GRAD_K) return err;
  return sum_splits(static_cast<const float*>(part_ds), static_cast<float*>(ds_rows), nq,
                    splits, st);
}

}  // namespace

// Each returns the cudaError_t of its launches (0 = success). The caller
// has checked shapes, types, contiguity and devices; nq, nk and d are
// positive. The caller's plan (ops/pallas_loss.py::plan) gives the tile
// (tm x tn; the gradients' tiles are square), `splits` blocks along the
// walk of per_split tiles each (the last maybe fewer), `dslices` 512-wide
// slices of D (gradients) and `wide` (16-byte copies: d % 4 == 0 and q, k
// 16-byte aligned). With more than one split, `part` (and `part_ds`) is the fp32 scratch of the
// partials: [4, splits, nq] for the statistics, [splits, n_own, d] (and
// [splits, nq]) for the gradients; else unused (may be null).
extern "C" int supcon_stats(const void* q, const void* k, const void* lq, const void* lk,
                            const void* scale, void* m, void* s, void* pos_sum,
                            void* pos_cnt, void* part, int nq, int nk, int d, int tm, int tn,
                            int splits, int per_split, int wide, void* stream) {
  if (splits < 1 || per_split < 1 || (splits > 1 && part == nullptr)) return refuse();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* outs[4] = {static_cast<float*>(m), static_cast<float*>(s),
                    static_cast<float*>(pos_sum), static_cast<float*>(pos_cnt)};
  float* dst[4];
  const long long plane = (long long)splits * nq;
  for (int i = 0; i < 4; ++i) dst[i] = splits > 1 ? static_cast<float*>(part) + i * plane : outs[i];
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* lqi = static_cast<const int*>(lq);
  const auto* lki = static_cast<const int*>(lk);
  const auto* scf = static_cast<const float*>(scale);
  int err;
  if (tm == 128 && tn == 128)
    err = launch_stats<128, 128>(qf, kf, lqi, lki, scf, dst, nq, nk, d, splits, per_split,
                                 wide, st);
  else if (tm == 32 && tn == 32)
    err = launch_stats<32, 32>(qf, kf, lqi, lki, scf, dst, nq, nk, d, splits, per_split, wide,
                               st);
  else
    return refuse();
  if (err != 0 || splits == 1) return err;
  supcon_stats_merge<<<(nq + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const float*>(part), outs[0], outs[1], outs[2], outs[3], nq, splits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int supcon_grad_q(const void* q, const void* k, const void* lq, const void* lk,
                             const void* m, const void* s, const void* cnt, const void* scale,
                             const void* gbar, void* dq, void* ds_rows, void* part,
                             void* part_ds, int nq, int nk, int d, int tm, int tn,
                             int splits, int per_split, int dslices, int resident, int wide,
                             void* stream) {
  return grad_call<false>(q, k, lq, lk, m, s, cnt, scale, gbar, dq, ds_rows, part, part_ds,
                          nq, nk, d, tm, tn, splits, per_split, dslices, resident, wide, stream);
}

extern "C" int supcon_grad_k(const void* q, const void* k, const void* lq, const void* lk,
                             const void* m, const void* s, const void* cnt, const void* scale,
                             const void* gbar, void* dk, void* part, int nq, int nk, int d,
                             int tm, int tn, int splits, int per_split, int dslices,
                             int resident, int wide, void* stream) {
  return grad_call<true>(q, k, lq, lk, m, s, cnt, scale, gbar, dk, nullptr, part, nullptr, nq,
                         nk, d, tm, tn, splits, per_split, dslices, resident, wide, stream);
}
