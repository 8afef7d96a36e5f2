// Flash attention forward for Hopper: O = softmax(Q K^T / sqrt(d)) V and the
// per-row logsumexp of the scaled scores.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_attn_kernel
// (K2, n_pad <= 512: the ViT blocks, N = 197 at 224 px) and computes the same
// function as ::_attn_kernel (K3, the streaming kernel for n_pad > 512), since
// it streams over any N. As in those kernels, keys >= N are masked to -1e30
// (not -inf), l is guarded by max(l, 1e-30), sums are taken in f32 whatever
// the input type, O is written in the input type and lse in f32.
//
// Routed by dtype in dfdt_flash_fwd, and bf16 by the split count S:
//
// bf16 (serving, and every path under --bf16: bf16 activations) runs
// flash_fwd_bf16_kernel on the tensor cores (S = 1: N <= 512, the ViT
// blocks). What bounds it on an H100: by
// the roofline, bytes. At the ViT-B/16 training shape (128, 12, 197, 64)
// one call moves 38.7 MB x 4 + lse (~0.047 ms at 3.35 TB/s) and does
// 4*N^2*d*B*H = 15.3 GFLOP (~0.015 ms at 989 TFLOP/s). In practice it is
// bound by instruction issue: per 16 x 64 tile a warp issues ~450
// instructions, most of them the softmax and the split of P below, and
// mma.sync cannot overlap them with the products (wgmma could). Design (as
// FlashAttention-2): one block of 4 warps per (64-row query tile, b*h),
// with the row tile fastest in the grid so the tiles of one head run
// together and share its K/V in L2; each warp owns 16 query rows. S = Q K^T
// and O += P V run as mma.m16n8k16 bf16 products with f32 accumulators
// (mma_bf16.cuh); the online softmax runs on the accumulator fragments in
// registers (row max and sum over the 4 lanes of a quad), with exp2f on
// scores times scale*log2(e) folded into one FMA, and lse converted back to
// the natural log on store. P goes from the accumulators straight into
// P.V as its A operand, with no trip through shared memory, split into two
// bf16 terms (hi = bf16(P), lo = bf16(P - hi), one more mma per step): one
// term keeps P to 2^-9 and moved a saturated long-clip loss by a bf16 ulp
// of its logit against the f32 plain version; two keep it to ~2^-17. Tiles
// stay bf16 in shared memory (rows padded to DP + 8 elements, so ldmatrix
// is conflict-free) and arrive by 16-byte cp.async: the Q tile once, K/V
// tiles of BN = 64 keys (32 above d = 128) through a 2-stage ring, so tile
// t+1 is in flight while tile t is computed. Q's fragments are re-read by ldmatrix
// at each k-step: holding them in registers cost a block per SM and was
// slower on the card. Dynamic shared memory: (64 + 4 BN) (DP + 8) * 2 bytes,
// 46,080 at d = 64, 101,376 at d = 256. Padding: only the tile that holds
// key N - 1 masks keys and skips its 16-key steps wholly at or past N (the
// other tiles run branch-free code), and a warp whose 16 rows all lie at or
// past N computes nothing (it still joins the block's barriers). d is
// padded in registers to the mma depth of 16 (DP = d rounded up to 16,
// zero-filled columns); d must be a multiple of 8 with 16-byte aligned rows,
// which the wrapper guarantees by a zero-padded copy where the caller's are
// not.
//
// The split route (bf16, chosen by the wrapper for N > 512: the TPU's
// streaming kernel K3's regime, the temporal transformer's long clips).
// There a call has few heads (B*H = 4-8), so one block per (row tile, b*h)
// left most SMs idle and each block walked 11-17 key tiles in series. The
// wrapper picks S key splits from the shape alone (ops/attention.py,
// _long_splits: the S that minimises waves of the card x tiles per split +
// S / 2, tuned on an H100); flash_fwd_split_bf16_kernel runs one block per
// (64-row query tile, key split, b*h), row tile fastest, each walking its
// own run of key tiles with the same tile body (two-term P included) and
// writing O_s = acc / l_s and lse_s in f32 to the caller's scratch,
// S*B*H*N*(d + 1)*4 bytes (4.3 MB at (2, 4, 1025, 64), S = 2). The splits
// are balanced and each keeps at least 2 tiles, so only the last one holds
// key N - 1 and masks. flash_fwd_combine_kernel then takes each row's
// partials in order: lse = log sum_s exp(lse_s), O = sum_s exp(lse_s - lse)
// O_s, O rounded once to bf16 and written through the caller's strides.
// Nothing depends on block order, so reruns are bit-identical. What bounds
// it: at these shapes not the card (the bytes and operations of (2, 4,
// 1025, 64) take 0.002 ms, below a launch's own cost) but the tile body,
// whose time per tile stops falling beyond about 2 blocks per SM, and the
// combine's latency (~0.003 ms). At d = 64 the split kernel takes 146
// registers (3 blocks per SM) and the same 46,080 bytes of shared memory;
// the combine 54 registers, none.
//
// f32 (the training CLI's and the evaluator's default without --bf16; the
// f32 gates are 1e-4 absolute on O, 1e-3 on lse) runs flash_fwd_tf32_kernel
// at every N (f32 has no split route): K2's regime and, at N > 512, K3's.
// Every product runs on the tensor cores as 3xTF32 (mma_tf32.cuh): each f32
// operand split into two tf32 terms, three mma.m16n8k8 tf32 products for
// one f32 product, f32 sums, so O keeps the error of f32 arithmetic (one
// tf32 term misses 1e-4). What bounds it on an H100: at (128, 12, 197, 64)
// it moves 311 MB (0.093 ms at 3.35 TB/s) and does 15.3 GFLOP, x 3 at
// 495 TFLOP/s tf32 = 0.093 ms: both alike. In practice it is bound by
// instruction issue: each operand element is split in registers (big
// truncated, a subtraction, small rounded by two integer operations: four
// instructions; cvt.rna.tf32.f32 for both terms, five each after ptxas,
// took 47 % more time), and every product is three mma.sync. Design: the bf16 kernel's (4 warps of
// 16 query rows, 64-row blocks, row tile fastest, the online softmax on the
// C fragments by the same softmax_tile), with f32 tiles in shared memory,
// rows padded to DP + 4 floats (DP = d rounded up to 32, 64, 128 or 256;
// conflict-free for both kinds of read below): the Q tile once, K/V tiles of
// 32 keys through a 2-stage 16-byte cp.async ring (64-key tiles took 2 blocks
// an SM and were slower). Q and K fragments load by ldmatrix on f32 rows
// with no transpose; V's by 32-bit loads, since ldmatrix.trans would cut
// each f32 word in half. P goes from the accumulators into P.V as its A
// operand with no shared memory: accumulator column 2t is taken as k = t and
// 2t + 1 as k = t + 4, and V's rows are read in that order. Dynamic shared
// memory (64 + 4 * 32) (DP + 4) * 4 bytes: 52,224 at d = 64. d must be a
// multiple of 4 with 16-byte aligned rows (the wrapper's zero-padded copy
// otherwise).
//
// Both: there is no grouping of heads per program (_short_group): it existed
// because a TPU grid runs in sequence, while this grid fills the 132 SMs in
// parallel (at N > 512 the f32 grid is as short of blocks as the bf16 one
// was before its split route). Q, K and V take element strides for the B, H
// and N axes (the last axis is contiguous), so the q/k/v views of a fused
// QKV projection go in without a copy; O is written through strides as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr float kNegBig = -1e30f;

struct Strides {
  long long b, h, n;
};

// ---- bf16: the tensor-core kernel ----

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DP> struct TcFwd {
  static constexpr int THREADS = 128;             // 4 warps of 16 query rows
  static constexpr int BM = 64;                   // query rows per block
  static constexpr int BN = DP <= 128 ? 64 : 32;  // keys per K/V tile
  static constexpr int LD = DP + 8;               // bf16 per shared-memory row
  static constexpr size_t smem = sizeof(__nv_bfloat16) * (BM + 4 * BN) * LD;
};

// The online-softmax update of one tile for one warp, on the C fragments
// s of its scores (both dtypes' tile bodies): LAST masks keys >= N to -1e30;
// the max is taken on the raw scores (sl2 > 0) and the scale folds into the
// exponent's FMA; m (log2 units), l and acc are rescaled, and s becomes P.
template <int NT, int DP, bool LAST>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&acc)[DP / 8][4],
                                             float (&m)[2], float (&l)[2], int key0, int N,
                                             float sl2, int tq) {
  float mx[2] = {kNegBig, kNegBig};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (LAST && key0 + j * 8 + 2 * tq + (e & 1) >= N) s[j][e] = kNegBig;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i] * sl2);  // log2 units
    alpha[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(fmaf(s[j][e], sl2, -m[e >> 1]));
      s[j][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int jd = 0; jd < DP / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jd][e] *= alpha[e >> 1];
}

// One K/V tile for one warp: S = Q K^T, the online-softmax update of m, l
// and acc, and acc += P V. LAST (the tile that holds key N - 1) masks keys
// >= N to -1e30 and skips the 16-key steps wholly at or past N; every other
// tile runs straight-line code, with no branch between its products.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void fwd_tile(float (&acc)[DP / 8][4], float (&m)[2], float (&l)[2],
                                         uint32_t wQ, uint32_t tK, uint32_t tV, int key0,
                                         int N, float sl2, int tq) {
  constexpr int LD = DP + 8, KD = DP / 16, NT = BN / 8;
  const int kv = LAST ? N - key0 : BN;  // live keys of this tile

  // S = Q K^T
  float s[NT][4] = {};
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    if (!LAST || np * 16 < kv) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t a[4], bk[4];
        dfdt::ldsm_x4(a, wQ + kd * 32);
        dfdt::ldsm_x4(bk, tK + 2 * (np * 16 * LD + kd * 16));
        dfdt::mma_bf16(s[2 * np], a, bk[0], bk[1]);
        dfdt::mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }
  }

  softmax_tile<NT, DP, LAST>(s, acc, m, l, key0, N, sl2, tq);

  // acc += P V, P split in registers into two bf16 A operands (hi + lo)
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (!LAST || kk * 16 < kv) {
      uint32_t hi[4], lo[4];
      dfdt::c_to_a_split<NT>(hi, lo, s, kk);
#pragma unroll
      for (int jd = 0; jd < KD; ++jd) {
        uint32_t bv[4];
        dfdt::ldsm_x4_t(bv, tV + 2 * (kk * 16 * LD + jd * 16));
        dfdt::mma_bf16(acc[2 * jd], hi, bv[0], bv[1]);
        dfdt::mma_bf16(acc[2 * jd + 1], hi, bv[2], bv[3]);
        dfdt::mma_bf16(acc[2 * jd], lo, bv[0], bv[1]);
        dfdt::mma_bf16(acc[2 * jd + 1], lo, bv[2], bv[3]);
      }
    }
  }
}

// Arguments of the bf16 kernels. The unsplit kernel writes o and lse; the
// split kernel writes its partials, which the combine kernel reads: part_o
// (B*H, S, N, d) f32, O_s normalised by its own l_s, and part_lse
// (B*H, S, N), lse_s in the natural log. The tensor-core kernels take them
// as separate parameters and build this in registers: a struct parameter
// cost 20 registers a thread at d = 64 (148 against 128, ptxas), one block
// per SM.
struct FwdArgs {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  float* lse;
  float *part_o, *part_lse;
  Strides sq, sk, sv, so;
  int H, N, d, splits;
  float scale;
};

// One block: query rows [row0, row0 + 64) of head bh against its run of key
// tiles [t0, t1) (all of them when !SPLIT), then O and lse (!SPLIT) or the
// split's O_s and lse_s (SPLIT).
template <int DP, bool SPLIT>
__device__ __forceinline__ void fwd_block(const FwdArgs& a) {
  using dfdt::bf16;
  using C = TcFwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  constexpr int KD = DP / 16;  // 16-deep k-steps over the head dim
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + C::BM * LD;  // two stages
  bf16* sV = sK + 2 * BN * LD;  // two stages

  const int N = a.N, d = a.d;
  const dfdt::Work w = dfdt::block_work<C::BM, BN>(N, SPLIT ? a.splits : 1);
  const int b = w.bh / a.H;
  const int h = w.bh % a.H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const bool active = row0 + warp * 16 < N;

  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  dfdt::tile_async<DP, LD, C::BM, C::THREADS>(sQ, a.q + b * a.sq.b + h * a.sq.h, a.sq.n, row0,
                                              N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, a.sk.n, w.t0 * BN, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, a.sv.n, w.t0 * BN, N, d);
  dfdt::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[2 * KD][4] = {};
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off<LD>(lane);

  for (int t = w.t0; t < w.t1; ++t) {
    const int st = (t - w.t0) & 1;
    if (t + 1 < w.t1) {
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sK + (st ^ 1) * BN * LD, kb, a.sk.n,
                                               (t + 1) * BN, N, d);
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sV + (st ^ 1) * BN * LD, vb, a.sv.n,
                                               (t + 1) * BN, N, d);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const uint32_t tK = dfdt::smem_u32(sK + st * BN * LD) + dfdt::bn_off<LD>(lane);
      const uint32_t tV = dfdt::smem_u32(sV + st * BN * LD) + dfdt::bk_off<LD>(lane);
      if ((t + 1) * BN <= N)
        fwd_tile<DP, BN, false>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
      else
        fwd_tile<DP, BN, true>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
    }
    __syncthreads();
  }
  if (!active) return;

  const int g = lane / 4;
  float inv[2], row_lse[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = fmaxf(l[i], 1e-30f);
    // one fast reciprocal per row; its error is far below the bf16 output's
    inv[i] = __fdividef(1.f, l_safe);
    row_lse[i] = m[i] * kLn2 + logf(l_safe);
  }
  const int wrow0 = row0 + warp * 16;
  if constexpr (SPLIT) {
    const long long plane = ((long long)w.bh * a.splits + w.s) * N;
    dfdt::store_rows_f32<DP>(a.part_o + plane * d, d, acc, inv, wrow0, N, d, lane);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = wrow0 + g + 8 * i;
      if (gr < N && tq == 0) a.part_lse[plane + gr] = row_lse[i];
    }
  } else {
    bf16* ob = a.o + b * a.so.b + h * a.so.h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int gr = wrow0 + g + 8 * i;
      if (gr >= N) continue;
#pragma unroll
      for (int jd = 0; jd < 2 * KD; ++jd) {
        const int c = jd * 8 + 2 * tq;
        if (c < d)
          *reinterpret_cast<__nv_bfloat162*>(ob + gr * a.so.n + c) =
              __floats2bfloat162_rn(acc[jd][2 * i] * inv[i], acc[jd][2 * i + 1] * inv[i]);
      }
      if (tq == 0) a.lse[(long long)w.bh * N + gr] = row_lse[i];
    }
  }
}

// N <= 512, or a grid that fills the card unsplit: one block per (64-row
// query tile, b*h) walks every key tile.
template <int DP>
__global__ void __launch_bounds__(TcFwd<DP>::THREADS)
flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                      int H, int N, int d, float scale) {
  const FwdArgs a{q, k, v, o, lse, nullptr, nullptr, sq, sk, sv, so, H, N, d, 1, scale};
  fwd_block<DP, false>(a);
}

// The split route: one block per (64-row query tile, key split, b*h).
template <int DP>
__global__ void __launch_bounds__(TcFwd<DP>::THREADS)
flash_fwd_split_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, float* __restrict__ part_o,
                            float* __restrict__ part_lse, Strides sq, Strides sk, Strides sv,
                            int H, int N, int d, int splits, float scale) {
  const FwdArgs a{q, k, v, nullptr, nullptr, part_o, part_lse, sq, sk, sv, Strides{},
                  H, N, d, splits, scale};
  fwd_block<DP, true>(a);
}

constexpr int kCombineThreads = 256;

// O and lse of each query row from its S partials, summed over s in order:
// lse = log sum_s exp(lse_s), O = sum_s exp(lse_s - lse) O_s. One thread per
// (row, 8 columns); rows = B*H*N.
__global__ void __launch_bounds__(kCombineThreads)
flash_fwd_combine_kernel(FwdArgs a, long long rows) {
  const int cpr = a.d / 8;
  const long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  if (i >= rows * cpr) return;
  const int c = (int)(i % cpr) * 8;
  const long long row = i / cpr;
  const int n = (int)(row % a.N);
  const long long bh = row / a.N;
  const long long first = bh * a.splits * a.N + n;  // (bh, s = 0, n)
  // unrolled, so the loads of several splits are in flight at once
  float mx = kNegBig;
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) mx = fmaxf(mx, a.part_lse[first + (long long)s * a.N]);
  float l = 0.f, acc[8] = {};
#pragma unroll 4
  for (int s = 0; s < a.splits; ++s) {
    const long long r = first + (long long)s * a.N;
    const float wgt = expf(a.part_lse[r] - mx);
    const float4* src = reinterpret_cast<const float4*>(a.part_o + r * a.d + c);
    const float4 x = src[0], y = src[1];
    l += wgt;
    acc[0] = fmaf(wgt, x.x, acc[0]);
    acc[1] = fmaf(wgt, x.y, acc[1]);
    acc[2] = fmaf(wgt, x.z, acc[2]);
    acc[3] = fmaf(wgt, x.w, acc[3]);
    acc[4] = fmaf(wgt, y.x, acc[4]);
    acc[5] = fmaf(wgt, y.y, acc[5]);
    acc[6] = fmaf(wgt, y.z, acc[6]);
    acc[7] = fmaf(wgt, y.w, acc[7]);
  }
  const float l_safe = fmaxf(l, 1e-30f);
  const float inv = 1.f / l_safe;
  __nv_bfloat16* dst = a.o + (bh / a.H) * a.so.b + (bh % a.H) * a.so.h + n * a.so.n + c;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    reinterpret_cast<__nv_bfloat162*>(dst)[j] =
        __floats2bfloat162_rn(acc[2 * j] * inv, acc[2 * j + 1] * inv);
  if (c == 0) a.lse[row] = mx + logf(l_safe);
}

template <int DP>
cudaError_t launch_bf16(const FwdArgs& a, int B, cudaStream_t stream) {
  using C = TcFwd<DP>;
  const int n_tiles = (a.N + C::BN - 1) / C::BN;
  if (a.splits > n_tiles) return cudaErrorInvalidValue;  // no split without keys
  const bool split = a.splits > 1;
  cudaError_t err = cudaFuncSetAttribute(
      split ? (const void*)flash_fwd_split_bf16_kernel<DP> : (const void*)flash_fwd_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * a.H * a.N;
  const long long blocks = (long long)B * a.H * ((a.N + C::BM - 1) / C::BM) * a.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (split)
    flash_fwd_split_bf16_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        a.q, a.k, a.v, a.part_o, a.part_lse, a.sq, a.sk, a.sv, a.H, a.N, a.d, a.splits, a.scale);
  else
    flash_fwd_bf16_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
        a.q, a.k, a.v, a.o, a.lse, a.sq, a.sk, a.sv, a.so, a.H, a.N, a.d, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long items = rows * (a.d / 8);
  flash_fwd_combine_kernel<<<(unsigned)((items + kCombineThreads - 1) / kCombineThreads),
                             kCombineThreads, 0, stream>>>(a, rows);
  return cudaGetLastError();
}

// the tensor-core kernel takes rows of 16-byte multiples: d % 8 == 0, every
// B/H/N stride a multiple of 8 elements and 16-byte aligned data
inline bool tc_aligned(const void* p, Strides s, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 8 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.n % 8 == 0;
}

// ---- f32: the 3xTF32 tensor-core kernel ----

template <int DP> struct TfFwd {
  static constexpr int THREADS = 128;  // 4 warps of 16 query rows
  static constexpr int BM = 64;        // query rows per block
  static constexpr int BN = 32;        // keys per K/V tile (64 was slower)
  static constexpr int LD = DP + 4;    // floats per shared-memory row
  static constexpr size_t smem = sizeof(float) * (BM + 4 * BN) * LD;
};

// One K/V tile for one warp, in f32 by 3xTF32 (mma_tf32.cuh): S = Q K^T,
// the online-softmax update, acc += P V. LAST as in fwd_tile.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void fwd_tile_tf32(float (&acc)[DP / 8][4], float (&m)[2],
                                              float (&l)[2], uint32_t wQ, uint32_t tK,
                                              const float* tV, int key0, int N, float sl2,
                                              int tq) {
  constexpr int LD = DP + 4, NT = BN / 8;
  const int kv = LAST ? N - key0 : BN;  // live keys of this tile

  // S = Q K^T, the k-steps outermost so each Q fragment is split once a tile
  float s[NT][4] = {};
#pragma unroll
  for (int kd = 0; kd < DP / 8; ++kd) {
    uint32_t r[4];
    dfdt::ldsm_x4(r, wQ + kd * 32);
    dfdt::FragA a;
    dfdt::split_a(a, r);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (!LAST || np * 16 < kv) {
        uint32_t bk[4];
        dfdt::ldsm_x4(bk, tK + 4 * (np * 16 * LD + kd * 8));
        dfdt::FragB b0, b1;
        dfdt::split_b(b0, __uint_as_float(bk[0]), __uint_as_float(bk[1]));
        dfdt::split_b(b1, __uint_as_float(bk[2]), __uint_as_float(bk[3]));
        dfdt::mma_3xtf32(s[2 * np], a, b0);
        dfdt::mma_3xtf32(s[2 * np + 1], a, b1);
      }
    }
  }

  softmax_tile<NT, DP, LAST>(s, acc, m, l, key0, N, sl2, tq);

  // acc += P V: P from the accumulators in the relabelled k order, V's B
  // fragments by 32-bit reads of rows 2t and 2t + 1
#pragma unroll
  for (int kk = 0; kk < NT; ++kk) {
    if (!LAST || kk * 8 < kv) {
      dfdt::FragA a;
      dfdt::c_to_a_tf32<NT>(a, s, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        dfdt::FragB b;
        dfdt::load_b_kn<LD>(b, tV, kk, jd);
        dfdt::mma_3xtf32(acc[jd], a, b);
      }
    }
  }
}

// One block per (64-row query tile, b*h), row tile fastest: Q once, then
// every K/V tile through the 2-stage cp.async ring; O and lse in f32.
template <int DP>
__global__ void __launch_bounds__(TfFwd<DP>::THREADS)
flash_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk, Strides sv, Strides so,
                      int H, int N, int d, float scale) {
  using C = TfFwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + C::BM * LD;   // two stages
  float* sV = sK + 2 * BN * LD;  // two stages

  const dfdt::Work w = dfdt::block_work<C::BM, BN>(N, 1);
  const int b = w.bh / H;
  const int h = w.bh % H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int tq = lane % 4;
  const bool active = row0 + warp * 16 < N;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  dfdt::tile_async<DP, LD, C::BM, C::THREADS>(sQ, q + b * sq.b + h * sq.h, sq.n, row0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, sk.n, 0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, sv.n, 0, N, d);
  dfdt::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float m[2] = {kNegBig, kNegBig};  // running max, log2 units, rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum
  float acc[DP / 8][4] = {};
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const int n_tiles = (N + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sK + (st ^ 1) * BN * LD, kb, sk.n,
                                                   (t + 1) * BN, N, d);
      dfdt::tile_async<DP, LD, BN, C::THREADS>(sV + (st ^ 1) * BN * LD, vb, sv.n,
                                                   (t + 1) * BN, N, d);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const uint32_t tK = dfdt::smem_u32(sK + st * BN * LD) + dfdt::bn_off_f32<LD>(lane);
      const float* tV = sV + st * BN * LD + dfdt::bk_off_f32<LD>(lane);
      if ((t + 1) * BN <= N)
        fwd_tile_tf32<DP, BN, false>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
      else
        fwd_tile_tf32<DP, BN, true>(acc, m, l, wQ, tK, tV, t * BN, N, sl2, tq);
    }
    __syncthreads();
  }
  if (!active) return;

  const int wrow0 = row0 + warp * 16;
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float l_safe = fmaxf(l[i], 1e-30f);
    inv[i] = 1.f / l_safe;
    const int gr = wrow0 + lane / 4 + 8 * i;
    if (gr < N && tq == 0) lse[(long long)w.bh * N + gr] = m[i] * kLn2 + logf(l_safe);
  }
  dfdt::store_rows_f32<DP>(o + b * so.b + h * so.h, so.n, acc, inv, wrow0, N, d, lane);
}

// q, k, v, o: (b, h, n) strides in st[0..3]
template <int DP>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, float* o, float* lse,
                        const Strides* st, int B, int H, int N, int d, float scale,
                        cudaStream_t stream) {
  using C = TfFwd<DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + C::BM - 1) / C::BM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::smem, stream>>>(
      q, k, v, o, lse, st[0], st[1], st[2], st[3], H, N, d, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (b, h, n) for q, k, v and o in that order.
// bf16 goes to the bf16 tensor-core kernels, f32 to the 3xTF32 one; both
// take 16-byte rows (cudaErrorMisalignedAddress otherwise). splits:
// 1, or (bf16 only) the key splits S of the split route, with `scratch` the
// caller's f32 buffer of S*B*H*N*(d + 1) elements for the partials.
extern "C" int dfdt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, int splits, void* scratch,
                              void* stream) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * kBlockM || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16) {
    if (!dfdt::f32_aligned(q, sq, d) || !dfdt::f32_aligned(k, sk, d) ||
        !dfdt::f32_aligned(v, sv, d) || so.b % 2 || so.h % 2 || so.n % 2)
      return (int)cudaErrorMisalignedAddress;
    const Strides st[4] = {sq, sk, sv, so};
    const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
                *fv = static_cast<const float*>(v);
    float* fo = static_cast<float*>(o);
    if (d <= 32) return (int)launch_tf32<32>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    if (d <= 64) return (int)launch_tf32<64>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    if (d <= 128) return (int)launch_tf32<128>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
    return (int)launch_tf32<256>(fq, fk, fv, fo, l, st, B, H, N, d, scale, s);
  }
  if (!tc_aligned(q, sq, d) || !tc_aligned(k, sk, d) || !tc_aligned(v, sv, d) ||
      so.b % 2 || so.h % 2 || so.n % 2)
    return (int)cudaErrorMisalignedAddress;
  using T = __nv_bfloat16;
  float* part_o = static_cast<float*>(scratch);
  FwdArgs a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<T*>(o), l, part_o,
            part_o ? part_o + (long long)splits * B * H * N * d : nullptr,
            sq, sk, sv, so, H, N, d, splits, scale};
#define DFDT_FWD_BF16(DP) \
  case DP / 16:           \
    return (int)launch_bf16<DP>(a, B, s);
  switch ((d + 15) / 16) {
    DFDT_FWD_BF16(16) DFDT_FWD_BF16(32) DFDT_FWD_BF16(48) DFDT_FWD_BF16(64)
    DFDT_FWD_BF16(80) DFDT_FWD_BF16(96) DFDT_FWD_BF16(112) DFDT_FWD_BF16(128)
    DFDT_FWD_BF16(144) DFDT_FWD_BF16(160) DFDT_FWD_BF16(176) DFDT_FWD_BF16(192)
    DFDT_FWD_BF16(208) DFDT_FWD_BF16(224) DFDT_FWD_BF16(240) DFDT_FWD_BF16(256)
  }
#undef DFDT_FWD_BF16
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dfdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
