// Hopper's warpgroup matrix multiply (wgmma, sm_90a only) for the attention
// kernels: one warpgroup (four consecutive warps, 128 threads) multiplies a
// 64-row A, held in registers, by a B tile that it reads from shared memory
// through a matrix descriptor, and sums into fp32 registers, asynchronously.
//
// Register layouts (per warp w of the warpgroup, lane = 4 g + t): A holds
// rows 16w .. 16w + 15 in mma.sync's m16k16 layout, a[0] = (row g, k 2t,
// 2t + 1), a[1] = (g + 8, 2t), a[2] = (g, 2t + 8), a[3] = (g + 8, 2t + 8),
// the lower k in the low half; the accumulator of an n-wide product holds,
// for each 8-column chunk j, d[4j + e] = (row 16w + g + 8 (e >> 1), column
// 8j + 2t + (e & 1)): mma.sync's C layout, chunk after chunk.
//
// Shared-memory tiles are in the 128-byte swizzle: rows of 64 bf16 (128
// bytes), the 16-byte piece c of row r at r * 128 + ((c ^ (r % 8)) * 16),
// each tile 1024-byte aligned so that the hardware's swizzle (address bits
// 4-6 xor bits 7-9) matches the one the copies wrote.
//   - K-major B (B[k][n] = X[n][k], X's rows contiguous along k: K in
//     Q K^T): an 8-row group every 1024 bytes (SBO); a k16 step starts 32
//     bytes further along the row; LBO is not read.
//   - MN-major B (B[k][n] = X[k][n], rows contiguous along n: V in P V,
//     transpose bit 1): n spans one 128-byte row (64 columns), the two
//     8-row groups of a k16 step lie 1024 bytes apart (SBO); LBO, the step
//     to the next 64 columns, is not read at n = 64.
// Past 64 columns (the wide-head forward, head dims 64-112: one layout for
// every width) tiles are in the 32-byte swizzle instead: slabs of 16 bf16
// columns, slab s holding columns 16 s .. 16 s + 15 of every row as one
// 32-byte row, the 16-byte half c of row r at r * 32 + ((c ^ ((r >> 2) & 1))
// * 16) (address bit 4 xor bit 7), slabs 512-byte aligned, R rows apart:
//   - K-major B: the k16 step s is slab s (its descriptor starts there); an
//     8-row group every 256 bytes (SBO); LBO is not read. The 16-row group g
//     starts 512 bytes further (32 in the descriptor's units).
//   - MN-major B: n spans the slabs, 16 columns each, LBO = R * 32 apart;
//     the two 8-row groups of a k16 step 256 bytes apart (SBO). n need not
//     fill the last slab: n = 72 reads 4.5 slabs, and the unread half
//     holds the zero pad.
// The slab form wastes no shared memory at 72-112 columns, where the
// 128-byte swizzle's second slab of 64 columns would be a quarter to
// three quarters empty. A K-major A read from shared memory (the wide
// backward's K and V of a 64-row sub-tile) is laid out as a K-major B of 64
// rows: the k16 step s is slab s, SBO 256.
// The shared memory that a wgmma reads must be published to the async
// proxy: each thread's copies landed, fence.proxy.async, then a barrier.

#pragma once

#include <stdint.h>

namespace {

// Byte offset of the 16-byte piece `c` of row `r` in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// Byte offset of the 16-byte half `c` of row `r` in a 32-byte-swizzled slab.
__device__ __forceinline__ uint32_t swz32(int r, int c) {
  return static_cast<uint32_t>(r * 32 + ((c ^ ((r >> 2) & 1)) << 4));
}

constexpr uint64_t kSwizzle128 = 1;  // the descriptor's layout field (bits 62-63)
constexpr uint64_t kSwizzle32 = 3;

// Descriptor of a swizzled tile at shared address `addr`: start address,
// leading and stride byte offsets in 16-byte units, the layout in bits
// 62-63, base offset 0 (tiles aligned to their swizzle's repeat).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                               uint64_t layout = kSwizzle128) {
  return static_cast<uint64_t>((addr & 0x3ffffu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3fffu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3fffu) << 32 | layout << 62;
}

// This thread's generic-proxy writes to shared memory (cp.async, st.shared)
// made visible to the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Orders the registers written before it (A fragments, accumulators) ahead
// of the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across a wgmma_wait: an empty asm that "writes" each of them.
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps R 32-bit A-fragment registers alive (unreused) until here: placed
// after the wgmma_wait that covers the products that read them, where
// other work ran while those products were in flight.
template <int R>
__device__ __forceinline__ void hold_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= a b for a 64 x 16 A in registers and a 16 x 64 B at `desc`; `acc`
// 0 overwrites d. TRANS_B: 0 K-major B, 1 MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t (&a)[4], uint64_t desc,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(TRANS_B), "r"(acc));
}

// The same with a 16 x 16 K-major B: d holds 8 registers.
__device__ __forceinline__ void wgmma_m64n16k16(float* d, const uint32_t (&a)[4], uint64_t desc,
                                                int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

// d (+)= a b with A, too, read from shared memory through the descriptor
// `adesc`: a K-major 64 x 16 A (rows along k, laid out as a K-major B of 64
// rows), a K-major B of 64 (16) columns at `bdesc`. The wide backward's
// dk/dv pass takes K and V so (attn_mma_bwd.cuh).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t adesc, uint64_t bdesc,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n16k16_ss(float* d, uint64_t adesc, uint64_t bdesc,
                                                   int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(adesc), "l"(bdesc), "r"(acc));
}

#define MRCLIP_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

// d (+)= a b for a 64 x 16 A in registers and a 16 x N MN-major B at `desc`
// (transpose bit 1), N = 64, 72, 80, 88, 104 or 112 (the head dims of P V);
// d holds N / 2 registers; `acc` 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_m64nNk16_mn(float* d, const uint32_t (&a)[4], uint64_t desc,
                                                  int acc) {
  static_assert(N == 64 || N == 72 || N == 80 || N == 88 || N == 104 || N == 112, "n");
  if constexpr (N == 64) {
    wgmma_m64n64k16<1>(d, a, desc, acc);
  } else if constexpr (N == 72) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35"
        "}, {%36, %37, %38, %39}, %40, p, 1, 1, 1;\n}\n"
        : MRCLIP_D4(0), MRCLIP_D4(4), MRCLIP_D4(8), MRCLIP_D4(12), MRCLIP_D4(16), MRCLIP_D4(20),
          MRCLIP_D4(24), MRCLIP_D4(28), MRCLIP_D4(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  } else if constexpr (N == 80) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : MRCLIP_D4(0), MRCLIP_D4(4), MRCLIP_D4(8), MRCLIP_D4(12), MRCLIP_D4(16), MRCLIP_D4(20),
          MRCLIP_D4(24), MRCLIP_D4(28), MRCLIP_D4(32), MRCLIP_D4(36)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  } else if constexpr (N == 88) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %49, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43"
        "}, {%44, %45, %46, %47}, %48, p, 1, 1, 1;\n}\n"
        : MRCLIP_D4(0), MRCLIP_D4(4), MRCLIP_D4(8), MRCLIP_D4(12), MRCLIP_D4(16), MRCLIP_D4(20),
          MRCLIP_D4(24), MRCLIP_D4(28), MRCLIP_D4(32), MRCLIP_D4(36), MRCLIP_D4(40)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  } else if constexpr (N == 104) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51"
        "}, {%52, %53, %54, %55}, %56, p, 1, 1, 1;\n}\n"
        : MRCLIP_D4(0), MRCLIP_D4(4), MRCLIP_D4(8), MRCLIP_D4(12), MRCLIP_D4(16), MRCLIP_D4(20),
          MRCLIP_D4(24), MRCLIP_D4(28), MRCLIP_D4(32), MRCLIP_D4(36), MRCLIP_D4(40),
          MRCLIP_D4(44), MRCLIP_D4(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  } else if constexpr (N == 112) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55"
        "}, {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
        : MRCLIP_D4(0), MRCLIP_D4(4), MRCLIP_D4(8), MRCLIP_D4(12), MRCLIP_D4(16), MRCLIP_D4(20),
          MRCLIP_D4(24), MRCLIP_D4(28), MRCLIP_D4(32), MRCLIP_D4(36), MRCLIP_D4(40),
          MRCLIP_D4(44), MRCLIP_D4(48), MRCLIP_D4(52)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
  }
}

#undef MRCLIP_D4

}  // namespace
