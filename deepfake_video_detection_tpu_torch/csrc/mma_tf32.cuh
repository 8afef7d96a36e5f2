// Warp-level building blocks of the f32 tensor-core flash forward
// (flash_fwd.cu): f32 products taken as 3xTF32 on the tensor cores with
// mma.m16n8k8 tf32 and f32 accumulators, as inline PTX for sm_90a, beside
// the cp.async, ldmatrix and tile wrappers of mma_bf16.cuh. The f32 backward
// (flash_bwd.cu, tf32 wgmma) shares the split (split_tf32) and the 16-byte
// row rule (f32_aligned).
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
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32), for
// lane l of a warp, g = l / 4, t = l % 4:
//   A 16x8 (4 regs): a0 = (row g, k t), a1 = (row g+8, k t),
//     a2 = (row g, k t+4), a3 = (row g+8, k t+4)
//   B 8x8 (2 regs): b0 = (k t, col g), b1 = (k t+4, col g)
//   C 16x8 (4 f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...)
// ldmatrix (b16) reads an 8 x 8 b16 matrix as 8 rows of 16 bytes, and lane l
// gets the 32-bit word l % 4 of row l / 4: on f32 rows that is element
// (row g, col t) of an 8 x 4 f32 block, so A fragments of a row-major tile
// and B fragments of a tile stored [n][k] (K for Q.K^T) load with no
// transpose. A tile stored [k][n] (V for P.V) would need ldmatrix.trans,
// which cuts each f32 word in half: its B fragments are read with 32-bit
// loads instead.
//
// From accumulator to A fragment. P (or dS) leaves a product as C fragments
// holding columns 2t, 2t+1, where A wants k = t, t + 4. The reduction index
// is relabelled instead of moved: accumulator column 2t is k = t and 2t + 1
// is k = t + 4, and the [k][n] operand's rows are read in that same order
// (row 2t for b0, 2t + 1 for b1). No shared memory, no shuffles.
//
// Shared-memory tiles hold f32 rows of DP (a multiple of 8) padded to
// LD = DP + 4 floats. LD / 4 is odd, so the 8 rows of an ldmatrix phase start
// in 8 distinct 4-bank groups; and 2 LD is 8 mod 16, so the 32-bit reads of
// rows 2t (+ 1) at column g hit 32 distinct banks.

#pragma once

#include <cstdint>

#include "mma_bf16.cuh"

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

// c += a * b on the tensor cores: (16x8 tf32) x (8x8 tf32) -> 16x8 f32
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 A or B fragment as its two tf32 terms
struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split_a(FragA& f, float a0, float a1, float a2, float a3) {
  split_tf32(a0, f.big[0], f.small[0]);
  split_tf32(a1, f.big[1], f.small[1]);
  split_tf32(a2, f.big[2], f.small[2]);
  split_tf32(a3, f.big[3], f.small[3]);
}
__device__ __forceinline__ void split_a(FragA& f, const uint32_t (&r)[4]) {
  split_a(f, __uint_as_float(r[0]), __uint_as_float(r[1]), __uint_as_float(r[2]),
          __uint_as_float(r[3]));
}
__device__ __forceinline__ void split_b(FragB& f, float b0, float b1) {
  split_tf32(b0, f.big[0], f.small[0]);
  split_tf32(b1, f.big[1], f.small[1]);
}

// c += a * b as 3xTF32: the two small terms first, then big.big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big[0], b.big[1]);
  mma_tf32(c, a.big, b.small[0], b.small[1]);
  mma_tf32(c, a.big, b.big[0], b.big[1]);
}

// The A fragment of k-step kk from the C fragment of 8-column tile kk, with
// column 2t as k = t and 2t + 1 as k = t + 4
template <int NT>
__device__ __forceinline__ void c_to_a_tf32(FragA& f, const float (&c)[NT][4], int kk) {
  split_a(f, c[kk][0], c[kk][2], c[kk][1], c[kk][3]);
}

// Byte offsets of this lane's ldmatrix row address (f32 rows of LD floats):
// the A fragment of the 16 x 8 block at (0, 0) of a row-major tile
template <int LD>
__device__ __forceinline__ uint32_t a_off_f32(int lane) {
  return 4 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4);
}
// B fragments of two 8-wide n-tiles, one 8-deep k-step, from a tile stored
// [n][k]: regs 0, 1 for rows 0-7, regs 2, 3 for rows 8-15
template <int LD>
__device__ __forceinline__ uint32_t bn_off_f32(int lane) {
  return 4 * (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 4);
}
// Float offset of this lane's 32-bit B reads from a tile stored [k][n]: row
// 2t (b0; b1 is the next row) at column g, in the relabelled k order
template <int LD>
__device__ __forceinline__ int bk_off_f32(int lane) {
  return 2 * (lane % 4) * LD + lane / 4;
}

// b0, b1 of k-step kk, n-tile jd from a [k][n] tile at y (bk_off_f32 added)
template <int LD>
__device__ __forceinline__ void load_b_kn(FragB& f, const float* y, int kk, int jd) {
  const float* p = y + kk * 8 * LD + jd * 8;
  split_b(f, p[0], p[LD]);
}

// the f32 tensor-core kernels take 16-byte rows: d % 4 == 0, every B/H/N
// stride a multiple of 4 elements and 16-byte aligned data
template <typename S>
__host__ inline bool f32_aligned(const void* p, S s, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 4 == 0 && s.b % 4 == 0 &&
         s.h % 4 == 0 && s.n % 4 == 0;
}

}  // namespace dfdt
