// Hopper's building blocks of the bf16 flash kernels (flash_fwd.cu,
// flash_bwd.cu), as
// inline PTX for sm_90a: mbarriers, TMA tile loads (cp.async.bulk.tensor)
// that complete on an mbarrier, and warpgroup products (wgmma.mma_async)
// with bf16 operands and f32 accumulators.
//
// Shared-memory tiles are stored as TMA writes them with a 128-byte swizzle:
// rows of 64 bf16 (128 bytes), groups of 8 rows (1024 bytes, each group
// 1024-byte aligned) in which the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8). A head dim DP > 64 is kept as DP / 64 such column blocks, one
// after another. wgmma reads these tiles through a matrix descriptor
// (desc_sw128): the start address, the byte distance between 8-row groups
// (SBO) and, for operands whose contiguous axis is M or N, between 64-wide
// column blocks (LBO); each product below covers at most one column block.
//
// Accumulator layout of m64nNk16 (PTX ISA, "wgmma register fragments"): warp
// w of the warpgroup holds rows 16w..16w+15; within it lane l, g = l / 4,
// t = l % 4, holds d[j][0..1] = (row g, cols 8j + 2t, +1) and d[j][2..3] =
// (row g + 8, the same cols): the mma.m16n8 C layout of mma_bf16.cuh repeated
// over the N / 8 column groups j. An A operand from registers takes the
// mma.m16n8k16 A layout, so dfdt::c_to_a_split turns two neighbouring column
// groups of an accumulator into the A operand of one 16-deep k-step.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace dfdt {

// ---- mbarriers ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival once every cp.async this thread has issued so far has landed
// (the barrier's count includes it: .noinc)
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// one arrival that also announces `bytes` of TMA transactions to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// ---- TMA ----

__device__ __forceinline__ void tma_prefetch(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(map) : "memory");
}

// One box of a 4-D tensor map into shared memory at `dst`, completing on
// `bar`. Coordinates are in elements, innermost first; what lies outside the
// tensor arrives as zeros and still counts its bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of shared memory at `src` into a 4-D tensor map's box at these
// coordinates, as a bulk group; what lies outside the tensor is not written.
__device__ __forceinline__ void tma_store_4d(const void* map, uint32_t src, int c0, int c1, int c2,
                                             int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// makes this thread's shared-memory writes visible to the async proxy (TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- shared memory and barriers of a subset of the block ----

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// barrier `id` (1-15) among `threads` threads, whole warps
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- wgmma ----

// The matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr` (1024-byte aligned, or a k-step's 32-byte offset inside a row of
// such a tile): LBO and SBO in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// before the first product that reads registers written since the last one
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of products are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous product owns across its issue or its wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// d (+)= A B, 64 x 64 x 16: A and B from shared memory, both K-major (the
// reduction axis contiguous); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the same, 64 x 32 x 16
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[4][4], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 8][4], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  static_assert(N == 32 || N == 64, "S = Q K^T takes 32- or 64-key tiles");
  if constexpr (N == 64)
    wgmma_ss_n64(d, desc_a, desc_b, scale_d);
  else
    wgmma_ss_n32(d, desc_a, desc_b, scale_d);
}

// d += A B, 64 x 64 x 16: A (the A fragment of mma_bf16.cuh) from registers,
// B from shared memory with N contiguous (transposed: V for P V).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[8][4], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

}  // namespace dfdt
