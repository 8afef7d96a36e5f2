// The 3xTF32 building blocks of the f32 flash kernels (flash_fwd.cu,
// flash_bwd.cu), both on tf32 wgmma (wgmma_tma.cuh): the split of an f32
// operand into two tf32 terms, and the layout and the TMA loads of the f32
// tiles they keep in shared memory.
//
// 3xTF32. An f32 operand x is taken as two tf32 terms (10 explicit mantissa
// bits each): big, x truncated to tf32, and small = tf32(x - big), rounded
// to nearest (split_tf32). A product a.b is taken as small(a).big(b) +
// big(a).small(b), then + big(a).big(b), every term an exact tf32 product
// summed in f32; the dropped small.small term is below 2^-20 of |a.b|. So
// the sums carry about the error of a plain f32 dot product (one tf32 term
// alone keeps 2^-11 and misses the 1e-4 gate of the f32 forward), at three
// tensor-core products per f32 product: 495 / 3 = 165 TFLOP/s on an H100
// against 67 for f32 on the CUDA cores.
//
// f32 tiles in shared memory are stored as TMA writes them with a 128-byte
// swizzle: 32-column blocks of `rows` rows of 128 bytes, one after another,
// the 16-byte chunk c of row r at chunk c ^ (r % 8) (sw_f32). tf32 wgmma
// reads shared-memory operands K-major only (the reduction axis
// contiguous). Where an accumulator feeds the next product as its A
// operand (P or dS from registers), its columns are relabelled instead of
// moved: column 2t of an 8-column group is taken as k = t and 2t + 1 as
// k = t + 4 (the tf32 A layout, wgmma_tma.cuh), and the kernels store the B
// tile's rows transposed in that same order, so no shuffle and no shared
// memory stand between the two products.

#pragma once

#include <cuda.h>
#include <cstdint>

#include "wgmma_tma.cuh"

namespace dfdt {

// x rounded to tf32 (to nearest, ties away from zero), as f32 bits with the
// low 13 zero: the magnitude plus half of the 13 dropped bits, truncated.
// Two integer operations, where cvt.rna.tf32.f32 expands into five (a NaN
// test among them); only the small term, which is never NaN unless big is,
// goes through it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as big + small, two tf32 terms, as CUTLASS's 3xTF32 (FastF32): big = x
// truncated to tf32 (one instruction, and a NaN stays a NaN), small = x - big
// rounded to nearest. |small| < 2^-10 |x| and big + small keeps x to 2^-21
// relative. A NaN x gives a NaN big, so every product it enters (big.big is
// one) is NaN.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = to_tf32(x - __uint_as_float(big));
}

// Byte offset of element (r, c) of an f32 tile of `rows` rows as TMA stores
// it: 32-column blocks of rows * 128 bytes, each row 128-byte swizzled.
__device__ __forceinline__ uint32_t sw_f32(int r, int c, int rows) {
  return (c >> 5) * rows * 128 + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// Rows [row0, row0 + ROWS_) of a tensor map into shared memory at dst: its
// 32-column blocks one after another, each as ROWS_ / BN boxes of BN rows
// (every f32 map has boxes of 32 columns by BN rows), completing on bar.
template <int DP, int ROWS_, int BN>
__device__ __forceinline__ void load_f32(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int row0, int h, int b) {
#pragma unroll
  for (int cb = 0; cb < DP / 32; ++cb)
#pragma unroll
    for (int rb = 0; rb < ROWS_ / BN; ++rb)
      tma_load_4d(dst + cb * ROWS_ * 128 + rb * BN * 128, map, bar, cb * 32, row0 + rb * BN, h,
                  b);
}

// the f32 kernels take 16-byte rows: d % 4 == 0, every B/H/N stride a
// multiple of 4 elements and 16-byte aligned data
template <typename S>
__host__ inline bool f32_aligned(const void* p, S s, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 4 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.n % 4 == 0;
}

}  // namespace dfdt
