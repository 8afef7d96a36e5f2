// Warp-level building blocks of the bf16 tensor-core flash kernels
// (flash_fwd.cu, flash_bwd.cu), as inline PTX for sm_90a: 16- and 4-byte
// cp.async copies from global into shared memory (zero-filling what lies
// outside the tensor), ldmatrix fragment loads, and the m16n8k16 bf16 mma
// with f32 accumulators; and what the split route of both sources shares
// (a block's rows and run of streamed tiles, the f32 partial rows).
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), for lane
// l of a warp, g = l / 4, t = l % 4:
//   A 16x16 (4 regs of 2 bf16): a0 = (row g, cols 2t..2t+1), a1 = (row g+8,
//     same cols), a2 = (row g, cols 2t+8..2t+9), a3 = (row g+8, cols 2t+8..)
//   B 16x8 (2 regs): b0 = (k rows 2t..2t+1, col g), b1 = (k rows 2t+8.., col g)
//   C 16x8 (4 f32): c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g+8, ...)
// So the C fragments of two neighbouring 8-column tiles, rounded to bf16 in
// pairs, are the A fragment of one 16-deep k-step: an attention kernel feeds
// P (or dS) from its accumulators straight into the next product.
//
// Shared-memory tiles hold rows of DP bf16 padded to LD = DP + 8 elements:
// LD / 2 words is 4 mod 8, so the 8 rows one ldmatrix phase reads start in 8
// distinct 4-bank groups, free of bank conflicts for every DP that is a
// multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <cstdint>

namespace dfdt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; 16 zero bytes when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared; 4 zero bytes when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
// Addresses are 32-bit shared-window offsets (smem_u32), which take one
// register where a generic pointer takes two.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed on the way into the registers
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a * b on the tensor cores: (16x16 bf16) x (16x8 bf16) -> 16x8 f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16, `lo` in the low half (the lower column index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k-step kk from the C fragments of 8-column tiles 2kk, 2kk+1
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[NT][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// The same A fragment as two bf16 terms, hi = bf16(c) and lo = bf16(c - hi):
// hi + lo carries about 16 mantissa bits, so a product taken as hi.B + lo.B
// keeps c to ~2^-17 relative where one bf16 term keeps it to 2^-9.
template <int NT>
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float (&c)[NT][4], int kk) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* x = &c[2 * kk + (i >> 1)][2 * (i & 1)];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[0], x[1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x[0] - hf.x, x[1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// Byte offsets of this lane's ldmatrix row address (rows of LD bf16):
// the A fragment of the 16x16 block at (0, 0) of a row-major tile
template <int LD>
__device__ __forceinline__ uint32_t a_off(int lane) {
  return 2 * ((lane & 15) * LD + (lane >> 4) * 8);
}
// B fragments of two 8-wide n-tiles from a tile stored [n][k] (rows are the
// output columns, e.g. K for Q.K^T): regs 0, 1 for rows 0-7, regs 2, 3 for
// rows 8-15, each over 16 k columns
template <int LD>
__device__ __forceinline__ uint32_t bn_off(int lane) {
  return 2 * (((lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8);
}
// B fragments of two 8-wide n-tiles from a tile stored [k][n] (rows are the
// reduction index, e.g. V for P.V), by ldsm_x4_t: regs 0, 1 for columns 0-7,
// regs 2, 3 for columns 8-15, over 16 k rows
template <int LD>
__device__ __forceinline__ uint32_t bk_off(int lane) {
  return 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8);
}

// Rows [row0, row0 + ROWS) of one (b, h) slice, columns [0, DP) of T (bf16
// or f32), into shared memory (row stride LD) by 16-byte cp.async: rows >= n
// and columns >= d (d a multiple of 16 bytes' worth) are zero-filled. Rows in
// global memory must be 16-byte aligned.
template <int DP, int LD, int ROWS, int THREADS, typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, long long row_stride,
                                           int row0, int n, int d) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  constexpr int CPR = DP / EPC;        // chunks per row
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += THREADS) {
    const int r = idx / CPR;
    const int c = (idx % CPR) * EPC;
    const int gr = row0 + r;
    const bool ok = gr < n && c < d;
    cp_async16(dst + r * LD + c, ok ? src + gr * row_stride + c : src, ok);
  }
}

// The work of one block of a flash kernel: its ROWS rows from row0 of head
// bh, against streamed tiles [t0, t1) of BN rows, the run of split s of
// `splits`. Blocks go row tile fastest, then split, then head, so the blocks
// that share a head's streamed tiles run together and share them in L2. The
// splits are balanced: each takes floor or ceil of n_tiles / splits tiles,
// so none is empty while splits <= n_tiles. With splits = 1 (a literal in
// the unsplit kernels) this is the whole range and folds away.
struct Work {
  int row0, bh, s, t0, t1;
};

template <int ROWS, int BN>
__device__ __forceinline__ Work block_work(int n, int splits) {
  const int n_rt = (n + ROWS - 1) / ROWS;
  const int n_tiles = (n + BN - 1) / BN;
  const int rest = blockIdx.x / n_rt;
  Work w;
  w.row0 = (blockIdx.x % n_rt) * ROWS;
  w.s = rest % splits;
  w.bh = rest / splits;
  w.t0 = w.s * n_tiles / splits;
  w.t1 = (w.s + 1) * n_tiles / splits;
  return w;
}

// Write a warp's 16 x DP accumulator, row i times mul[i], as f32 rows (row
// stride row_stride: d for a split's partial, the caller's for an f32
// output), rows < n and columns < d (d even).
template <int DP>
__device__ __forceinline__ void store_rows_f32(float* dst, long long row_stride,
                                               const float (&acc)[DP / 8][4],
                                               const float (&mul)[2], int row0, int n, int d,
                                               int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + lane / 4 + 8 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const int c = jd * 8 + 2 * (lane % 4);
      if (c < d)
        *reinterpret_cast<float2*>(dst + gr * row_stride + c) =
            make_float2(acc[jd][2 * i] * mul[i], acc[jd][2 * i + 1] * mul[i]);
    }
  }
}

}  // namespace dfdt
