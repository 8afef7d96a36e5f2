// Flash attention backward for Hopper: dQ, dK and dV of O = softmax(Q K^T s) V,
// s = 1/sqrt(d), from the forward's O and per-row logsumexp L.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_bwd_kernel
// (K4, n_pad <= 512: the ViT blocks in training, N = 197 at 224 px) and
// computes the same functions as ::_bwd_dq_kernel (K5) and ::_bwd_dkv_kernel
// (K6), the streaming FlashAttention-2 passes for n_pad > 512, since both
// kernels here stream over any N. As in those kernels: keys >= N get P = 0
// (the -1e30 mask), query rows >= N get P = 0 (the padded rows the TPU
// kernels zero explicitly), sums are taken in f32 whatever the input type
// (the bf16 kernels round P and dS to bf16 as product operands), and dQ,
// dK, dV are written in the input type.
//
// Why two passes and not K4's single program: K4 runs one program per group
// of heads that holds the whole (Np, Np) f32 score slab on chip. At Np = 256
// that is 256 KB per head, and a Hopper block has at most 227 KB of shared
// memory. So the design is FlashAttention-2's: a dQ pass (one block per
// 64-row query tile, streaming K/V tiles) and a dK/dV pass (one block per
// 64-key tile, streaming Q/dO tiles). Each recomputes S and P from L, so P is
// computed twice where K4 computed it once. Blocks write disjoint rows: no
// atomics, and repeated runs agree bit for bit.
//
// D = rowsum(dO * O) is fused into the dQ pass: each dQ block computes D for
// its own query rows before its loop and writes it to a scratch vector; the
// dK/dV pass, launched after it on the same stream, reads it. (On the split
// route every split block of a row tile computes D, the same sum in the
// same order, and split 0 writes it.)
//
// What bounds it on an H100: by the roofline, bytes. At the ViT-B/16
// training shape (128, 12, 197, 64) bf16 the function reads q, k, v, O, dO
// (5 x 38.7 MB) and lse, and writes dq, dk, dv (3 x 38.7 MB): ~312 MB,
// ~0.093 ms at 3.35 TB/s; its 10*N^2*d*B*H = 38 GFLOP take ~0.039 ms at
// 989 TFLOP/s. Routed by dtype in dfdt_flash_bwd, and bf16 by the split
// count S:
//
// bf16 (every path under --bf16) runs flash_bwd_dq_bf16_kernel
// and flash_bwd_dkv_bf16_kernel on the tensor cores (S = 1: N <= 512, the
// ViT blocks): blocks of 4 warps,
// each warp owning 16 rows of the block's 64 (query rows in the dQ pass,
// key rows in the dK/dV pass). Every product is an mma.m16n8k16 bf16 with
// f32 accumulators (mma_bf16.cuh): S = Q K^T, dP = dO V^T, dQ += dS K in the
// dQ pass; S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q in the
// dK/dV pass. P = exp2(S * scale*log2(e) - lse*log2(e)) and dS = P (dP - D)
// are formed on the accumulator fragments; P and dS are rounded to bf16 in
// registers and fed to the next product as its A operand, with no trip
// through shared memory (one bf16 term: unlike the forward's P, this
// rounding held every gradient gate of the port's paths on the card).
// Tiles stay bf16 in shared memory (rows padded to DP + 8 elements,
// conflict-free ldmatrix) and arrive by 16-byte cp.async;
// the streamed tiles of 32 rows (K/V in the dQ pass; Q/dO with their lse
// and D rows in the dK/dV pass) go through a 2-stage ring, tile t+1 in
// flight while tile t is computed. The row tile runs fastest in the grid, so
// the blocks of one head run together and share its streamed tiles in L2.
// The block's own A fragments (Q and dO, or K and V) stay in registers at
// d <= 64. Dynamic shared memory (128 + 128) (DP + 8) * 2 bytes plus the f32
// rows: 37,120 (dQ) and 37,376 (dK/dV) at d = 64. The 16 x DP accumulators
// fit the registers up to d = 128; at d = 256 the dK/dV pass's two of them
// (256 f32 a lane) spill. Padding: only the streamed tile that holds row
// N - 1 masks and skips its 16-row steps wholly at or past N (the other
// tiles run branch-free code), and a warp whose 16 rows all lie at or past
// N computes nothing (it still joins the barriers). d is padded in
// registers to the mma depth of 16 and must be a multiple of 8 with 16-byte
// aligned rows, which the wrapper guarantees by a zero-padded copy.
//
// The split route (bf16, chosen by the wrapper for N > 512: the TPU's
// streaming passes K5 and K6, the long-clip temporal transformer in
// training). With B*H = 4 heads the two passes had 44 blocks each on 132
// SMs, each walking 21 streamed tiles in series. The wrapper picks S splits
// from the shape alone (ops/attention.py, _long_splits: the S that
// minimises waves of the card x tiles per split + S / 2, tuned on an H100),
// and
// flash_bwd_dq_split_bf16_kernel and flash_bwd_dkv_split_bf16_kernel run
// one block per (64-row tile, split, b*h), row tile fastest: the dQ pass
// splits its key tiles, the dK/dV pass its query tiles, each block walking
// its own balanced run (at least 2 tiles, so only the last split holds row
// N - 1) with the same body as above and writing unscaled f32 partials of
// dQ, or of dK and dV, to the caller's scratch, 3*S*B*H*N*d*4 bytes
// (13.8 MB at (1, 4, 641, 64), S = 7). flash_bwd_reduce_kernel then sums
// each row's S partials in order, applies the scale (dQ, dK) and rounds
// once to bf16 through the caller's strides: no atomics, reruns are
// bit-identical. What bounds it: at these shapes not the card ((1, 4, 641,
// 64) needs 0.001 ms of bytes and operations, below a launch's own cost)
// but the two passes' tile body and the reduce's traffic (~0.004 ms). At
// d = 64 the split dQ pass takes 128 registers (4 blocks per SM), the
// split dK/dV pass 168 (3), with the same shared memory as the unsplit
// passes; the reduce 46 registers, none.
//
// f32 (the training CLI's default without --bf16; the f32 gate is atol =
// rtol = 1e-3) runs flash_bwd_dq_tf32_kernel and flash_bwd_dkv_tf32_kernel
// at every N (f32 has no split route): K4's regime and, at N > 512, K5's
// and K6's. The same two passes as the bf16 ones (blocks of 4 warps of 16
// rows, 64-row blocks, row tile fastest, D fused into the dQ pass, a 2-stage
// cp.async ring of 32-row streamed tiles, 16 above d = 128; P and dS formed
// on the accumulator fragments and fed to the next product with no shared
// memory; no atomics, so reruns are bit-identical), with every product on
// the tensor cores as 3xTF32 (mma_tf32.cuh): each f32 operand split into
// two tf32 terms, three mma.m16n8k8 tf32 products for one f32 product, f32
// sums. What bounds it on an H100: at (128, 12, 197, 64) it moves ~621 MB
// (0.185 ms at 3.35 TB/s) and does 38.2 GFLOP, x 3 at 495 TFLOP/s tf32 =
// 0.231 ms: operations. In practice instruction issue bounds it, as the
// forward (mma_tf32.cuh: the splits, three mma.sync a product; the split by
// truncation and integer rounding in place of cvt.rna.tf32.f32 took 35 %
// off). f32 tiles
// sit in shared memory in rows padded to DP + 4 floats (DP = d rounded up
// to 32, 64, 128 or 256); operands stored [n][k] (K for Q K^T, Q and dO in
// the dK/dV pass's S^T and dP^T) load by ldmatrix on f32 rows, operands
// stored [k][n] (K for dS K, dO for P^T dO, Q for dS^T Q) by 32-bit loads
// in the relabelled k order of the accumulator fragments. Dynamic shared
// memory (128 + 4 BN) (DP + 4) * 4 bytes plus the f32 rows: 69,888 (dQ)
// and 70,144 (dK/dV) at d = 64. d must be a multiple of 4 with 16-byte
// aligned rows (the wrapper's zero-padded copy otherwise).
//
// Both dtypes take element strides for the B, H and N axes (the last axis
// contiguous), so dO goes in as the strided view autograd hands over and
// q, k, v as views of a fused QKV projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

struct Strides {
  long long b, h, n;
};

// ---- bf16: the tensor-core kernels ----

constexpr float kLog2e = 1.4426950408889634f;

template <int DP> struct TcBwd {
  static constexpr int THREADS = 128;      // 4 warps of 16 rows
  static constexpr int ROWS = 64;          // rows a block owns
  static constexpr int BN = 32;            // rows per streamed tile
  static constexpr int LD = DP + 8;        // bf16 per shared-memory row
  static constexpr bool kHold = DP <= 64;  // the block's A fragments in registers
  static constexpr size_t tiles = sizeof(__nv_bfloat16) * (2 * ROWS + 4 * BN) * LD;
  static constexpr size_t dq_smem = tiles + sizeof(float) * ROWS;
  static constexpr size_t dkv_smem = tiles + sizeof(float) * 4 * BN;
};

// S = A0 B0^T and T = A1 B1^T for one warp: A0, A1 are the warp's 16 rows
// (held fragments, or read at a0/a1 in shared memory), B0, B1 the streamed
// tile's rows at b0/b1 (bn_off layout). In the LAST tile, 16-row steps at
// or past `live` are skipped and stay 0; other tiles run without a branch.
template <int DP, int BN, bool HOLD, bool LAST>
__device__ __forceinline__ void two_products(float (&s)[BN / 8][4], float (&t)[BN / 8][4],
                                             const uint32_t (&f0)[HOLD ? DP / 16 : 1][4],
                                             const uint32_t (&f1)[HOLD ? DP / 16 : 1][4],
                                             uint32_t a0, uint32_t a1, uint32_t b0,
                                             uint32_t b1, int live) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll
  for (int np = 0; np < BN / 16; ++np) {
    if (!LAST || np * 16 < live) {
#pragma unroll
      for (int kd = 0; kd < DP / 16; ++kd) {
        uint32_t x0[4], x1[4], y0[4], y1[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            x0[i] = f0[kd][i];
            x1[i] = f1[kd][i];
          }
        } else {
          dfdt::ldsm_x4(x0, a0 + kd * 32);
          dfdt::ldsm_x4(x1, a1 + kd * 32);
        }
        dfdt::ldsm_x4(y0, b0 + 2 * (np * 16 * LD + kd * 16));
        dfdt::ldsm_x4(y1, b1 + 2 * (np * 16 * LD + kd * 16));
        dfdt::mma_bf16(s[2 * np], x0, y0[0], y0[1]);
        dfdt::mma_bf16(s[2 * np + 1], x0, y0[2], y0[3]);
        dfdt::mma_bf16(t[2 * np], x1, y1[0], y1[1]);
        dfdt::mma_bf16(t[2 * np + 1], x1, y1[2], y1[3]);
      }
    }
  }
}

// acc += X Y for one warp: X is 16 x BN, the bf16 rounding of the C
// fragments x; Y the streamed tile at y (bk_off layout, BN x DP). In the
// LAST tile, 16-row steps at or past `live` are skipped (their X is 0).
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void product_into(float (&acc)[DP / 8][4], const float (&x)[BN / 8][4],
                                             uint32_t y, int live) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    if (!LAST || kk * 16 < live) {
      uint32_t a[4];
      dfdt::c_to_a<BN / 8>(a, x, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 16; ++jd) {
        uint32_t b[4];
        dfdt::ldsm_x4_t(b, y + 2 * (kk * 16 * LD + jd * 16));
        dfdt::mma_bf16(acc[2 * jd], a, b[0], b[1]);
        dfdt::mma_bf16(acc[2 * jd + 1], a, b[2], b[3]);
      }
    }
  }
}

// Write a warp's 16 x DP accumulator times `mul` as bf16 rows of a (b, h)
// slice, rows < n and columns < d.
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long row_stride,
                                           const float (&acc)[DP / 8][4], float mul, int row0,
                                           int n, int d, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + lane / 4 + 8 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int jd = 0; jd < DP / 8; ++jd) {
      const int c = jd * 8 + 2 * (lane % 4);
      if (c < d)
        *reinterpret_cast<__nv_bfloat162*>(dst + gr * row_stride + c) =
            __floats2bfloat162_rn(acc[jd][2 * i] * mul, acc[jd][2 * i + 1] * mul);
    }
  }
}

// Arguments of the bf16 kernels. The unsplit passes write dq, dk and dv;
// the split passes write f32 partials, which the reduce kernel sums:
// part + 0, + plane, + 2 plane hold dQ, dK and dV, each (B*H, S, N, d)
// and unscaled. The tensor-core kernels take them as separate parameters
// and build this in registers: a struct parameter cost the dQ pass 34
// registers a thread at d = 64 (162 against 128, ptxas), one block per SM.
struct BwdArgs {
  const __nv_bfloat16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* dvec;
  __nv_bfloat16 *dq, *dk, *dv;
  float* part;
  long long plane;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int H, N, d, splits;
  float scale;
};

// The dQ pass on the tensor cores. One block per (64-row query tile, key
// split, b*h): D for the tile's rows (every split computes it, split 0
// writes it), then a walk over the split's K/V tiles accumulating
// dQ = sum dS K, written times the scale (!SPLIT) or as a partial (SPLIT).
template <int DP, bool SPLIT>
__device__ __forceinline__ void dq_block(const BwdArgs& a) {
  using dfdt::bf16;
  using C = TcBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD, KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + C::ROWS * LD;
  bf16* sK = sdO + C::ROWS * LD;  // two stages
  bf16* sV = sK + 2 * BN * LD;    // two stages
  float* sD = reinterpret_cast<float*>(sV + 2 * BN * LD);

  const int N = a.N, d = a.d;
  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, SPLIT ? a.splits : 1);
  const int bh = w.bh;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = row0 + warp * 16;
  const bool active = wrow0 < N;

  const bf16* kb = a.k + b * a.sk.b + h * a.sk.h;
  const bf16* vb = a.v + b * a.sv.b + h * a.sv.h;
  const bf16* dob = a.dout + b * a.sdo.b + h * a.sdo.h;
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sQ, a.q + b * a.sq.b + h * a.sq.h, a.sq.n,
                                                row0, N, d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sdO, dob, a.sdo.n, row0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, a.sk.n, w.t0 * BN, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, a.sv.n, w.t0 * BN, N, d);
  dfdt::cp_async_commit();

  // D = rowsum(dO * O) in f32: two lanes per row, 16-byte reads
  {
    const int r = threadIdx.x / 2;
    const int gr = row0 + r;
    float part = 0.f;
    if (gr < N) {
      const bf16* orow = a.o + b * a.so.b + h * a.so.h + gr * a.so.n;
      const bf16* drow = dob + gr * a.sdo.n;
      for (int c = (threadIdx.x % 2) * 8; c < d; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 x = __bfloat1622float2(o2[i]);
          const float2 y = __bfloat1622float2(d2[i]);
          part = fmaf(x.x, y.x, part);
          part = fmaf(x.y, y.y, part);
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      sD[r] = part;
      if (gr < N && w.s == 0) a.dvec[(long long)bh * N + gr] = part;
    }
  }

  const float sl2 = a.scale * kLog2e;
  float lrow[2], drow[2] = {0.f, 0.f};  // lse (log2 units) and D of rows g, g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = wrow0 + lane / 4 + 8 * i;
    lrow[i] = gr < N ? a.lse[(long long)bh * N + gr] * kLog2e : 0.f;
  }
  float acc[2 * KD][4] = {};
  uint32_t qf[C::kHold ? KD : 1][4], df[C::kHold ? KD : 1][4];
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off<LD>(lane);
  const uint32_t wdO = dfdt::smem_u32(sdO + warp * 16 * LD) + dfdt::a_off<LD>(lane);

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
      if (t == w.t0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) drow[i] = sD[warp * 16 + lane / 4 + 8 * i];
        if constexpr (C::kHold) {
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            dfdt::ldsm_x4(qf[kd], wQ + kd * 32);
            dfdt::ldsm_x4(df[kd], wdO + kd * 32);
          }
        }
      }
      const int key0 = t * BN;
      const int kv = min(BN, N - key0);
      const uint32_t tK = dfdt::smem_u32(sK + st * BN * LD);
      const uint32_t tV = dfdt::smem_u32(sV + st * BN * LD);
      // LAST: the tile that holds key N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S = Q K^T, dP = dO V^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products<DP, BN, C::kHold, LAST>(s, dp, qf, df, wQ, wdO,
                                             tK + dfdt::bn_off<LD>(lane),
                                             tV + dfdt::bn_off<LD>(lane), kv);
        // dS = P (dP - D), P = exp(S scale - L) and 0 on keys >= N
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = !LAST || key0 + j * 8 + 2 * (lane % 4) + (e & 1) < N;
            const float p = live ? exp2f(fmaf(s[j][e], sl2, -lrow[e >> 1])) : 0.f;
            s[j][e] = p * (dp[j][e] - drow[e >> 1]);
          }
        // dQ += dS K
        product_into<DP, BN, LAST>(acc, s, tK + dfdt::bk_off<LD>(lane), kv);
      };
      if (kv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  const float one[2] = {1.f, 1.f};
  if constexpr (SPLIT)
    dfdt::store_rows_f32<DP>(a.part + ((long long)bh * a.splits + w.s) * N * d, d, acc, one,
                             wrow0, N, d, lane);
  else
    store_rows<DP>(a.dq + b * a.sdq.b + h * a.sdq.h, a.sdq.n, acc, a.scale, wrow0, N, d, lane);
}

// The dK/dV pass on the tensor cores. One block per (64-key tile, query
// split, b*h): a walk over the split's Q/dO tiles (with their lse and D
// rows) accumulating dV = sum P^T dO and dK = sum dS^T Q, written in bf16
// (dK times the scale; !SPLIT) or as partials (SPLIT); P = 0 on query rows
// >= N.
template <int DP, bool SPLIT>
__device__ __forceinline__ void dkv_block(const BwdArgs& a) {
  using dfdt::bf16;
  using C = TcBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD, KD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + C::ROWS * LD;
  bf16* sQ = sV + C::ROWS * LD;  // two stages
  bf16* sdO = sQ + 2 * BN * LD;  // two stages
  float* sL = reinterpret_cast<float*>(sdO + 2 * BN * LD);  // two stages
  float* sD = sL + 2 * BN;                                  // two stages

  const int N = a.N, d = a.d;
  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, SPLIT ? a.splits : 1);
  const int bh = w.bh;
  const int b = bh / a.H;
  const int h = bh % a.H;
  const int key0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wkey0 = key0 + warp * 16;
  const bool active = wkey0 < N;

  const bf16* qb = a.q + b * a.sq.b + h * a.sq.h;
  const bf16* dob = a.dout + b * a.sdo.b + h * a.sdo.h;
  const float* lb = a.lse + (long long)bh * N;
  const float* db = a.dvec + (long long)bh * N;
  // query tile `tile` (its Q, dO, lse and D rows) into stage `st`
  auto load_queries = [&](int tile, int st) {
    const int q0 = tile * BN;
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sQ + st * BN * LD, qb, a.sq.n, q0, N, d);
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sdO + st * BN * LD, dob, a.sdo.n, q0, N, d);
    for (int i = threadIdx.x; i < 2 * BN; i += C::THREADS) {
      const int r = i % BN;
      const bool ok = q0 + r < N;
      const float* src = i < BN ? lb : db;
      dfdt::cp_async4((i < BN ? sL : sD) + st * BN + r, ok ? src + q0 + r : src, ok);
    }
  };
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sK, a.k + b * a.sk.b + h * a.sk.h, a.sk.n, key0,
                                                N, d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sV, a.v + b * a.sv.b + h * a.sv.h, a.sv.n, key0,
                                                N, d);
  load_queries(w.t0, 0);
  dfdt::cp_async_commit();

  const float sl2 = a.scale * kLog2e;
  float acc_dk[2 * KD][4] = {}, acc_dv[2 * KD][4] = {};
  uint32_t kf[C::kHold ? KD : 1][4], vf[C::kHold ? KD : 1][4];
  const uint32_t wK = dfdt::smem_u32(sK + warp * 16 * LD) + dfdt::a_off<LD>(lane);
  const uint32_t wV = dfdt::smem_u32(sV + warp * 16 * LD) + dfdt::a_off<LD>(lane);

  for (int t = w.t0; t < w.t1; ++t) {
    const int st = (t - w.t0) & 1;
    if (t + 1 < w.t1) {
      load_queries(t + 1, st ^ 1);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      if constexpr (C::kHold) {
        if (t == w.t0) {
#pragma unroll
          for (int kd = 0; kd < KD; ++kd) {
            dfdt::ldsm_x4(kf[kd], wK + kd * 32);
            dfdt::ldsm_x4(vf[kd], wV + kd * 32);
          }
        }
      }
      const int q0 = t * BN;
      const int qv = min(BN, N - q0);
      const uint32_t tQ = dfdt::smem_u32(sQ + st * BN * LD);
      const uint32_t tdO = dfdt::smem_u32(sdO + st * BN * LD);
      const float* tL = sL + st * BN;
      const float* tD = sD + st * BN;
      // LAST: the tile that holds query row N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S^T = K Q^T, dP^T = V dO^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products<DP, BN, C::kHold, LAST>(s, dp, kf, vf, wK, wV,
                                             tQ + dfdt::bn_off<LD>(lane),
                                             tdO + dfdt::bn_off<LD>(lane), qv);
        // P^T (0 on query rows >= N: their lse is not a logsumexp) and dS^T
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * (lane % 4) + (e & 1);
            const float p = !LAST || q0 + col < N
                                ? exp2f(fmaf(s[j][e], sl2, -tL[col] * kLog2e))
                                : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - tD[col]);
          }
        // dV += P^T dO, dK += dS^T Q
        product_into<DP, BN, LAST>(acc_dv, s, tdO + dfdt::bk_off<LD>(lane), qv);
        product_into<DP, BN, LAST>(acc_dk, dp, tQ + dfdt::bk_off<LD>(lane), qv);
      };
      if (qv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  if constexpr (SPLIT) {
    const float one[2] = {1.f, 1.f};
    float* dst = a.part + a.plane + ((long long)bh * a.splits + w.s) * N * d;
    dfdt::store_rows_f32<DP>(dst, d, acc_dk, one, wkey0, N, d, lane);
    dfdt::store_rows_f32<DP>(dst + a.plane, d, acc_dv, one, wkey0, N, d, lane);
  } else {
    store_rows<DP>(a.dk + b * a.sdk.b + h * a.sdk.h, a.sdk.n, acc_dk, a.scale, wkey0, N, d,
                   lane);
    store_rows<DP>(a.dv + b * a.sdv.b + h * a.sdv.h, a.sdv.n, acc_dv, 1.f, wkey0, N, d, lane);
  }
}

using bf16p = const __nv_bfloat16* __restrict__;

// N <= 512, or a grid that fills the card unsplit: one block per (64-row
// tile, b*h) walks every streamed tile.
template <int DP>
__global__ void __launch_bounds__(TcBwd<DP>::THREADS)
flash_bwd_dq_bf16_kernel(bf16p q, bf16p k, bf16p v, bf16p o, bf16p dout,
                         const float* __restrict__ lse, float* __restrict__ dvec,
                         __nv_bfloat16* __restrict__ dq, Strides sq, Strides sk, Strides sv,
                         Strides so, Strides sdo, Strides sdq, int H, int N, int d, float scale) {
  const BwdArgs a{q, k, v, o, dout, lse, dvec, dq, nullptr, nullptr, nullptr, 0,
                  sq, sk, sv, so, sdo, sdq, Strides{}, Strides{}, H, N, d, 1, scale};
  dq_block<DP, false>(a);
}
template <int DP>
__global__ void __launch_bounds__(TcBwd<DP>::THREADS)
flash_bwd_dkv_bf16_kernel(bf16p q, bf16p k, bf16p v, bf16p dout, const float* __restrict__ lse,
                          float* __restrict__ dvec, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, Strides sq, Strides sk, Strides sv,
                          Strides sdo, Strides sdk, Strides sdv, int H, int N, int d,
                          float scale) {
  const BwdArgs a{q, k, v, nullptr, dout, lse, dvec, nullptr, dk, dv,
                  nullptr, 0, sq, sk, sv, Strides{}, sdo, Strides{}, sdk, sdv, H, N, d, 1, scale};
  dkv_block<DP, false>(a);
}

// The split route: one block per (64-row tile, split, b*h).
template <int DP>
__global__ void __launch_bounds__(TcBwd<DP>::THREADS)
flash_bwd_dq_split_bf16_kernel(bf16p q, bf16p k, bf16p v, bf16p o, bf16p dout,
                               const float* __restrict__ lse, float* __restrict__ dvec,
                               float* __restrict__ part, Strides sq, Strides sk, Strides sv,
                               Strides so, Strides sdo, int H, int N, int d, int splits,
                               float scale) {
  const BwdArgs a{q, k, v, o, dout, lse, dvec, nullptr, nullptr, nullptr, part, 0,
                  sq, sk, sv, so, sdo, Strides{}, Strides{}, Strides{}, H, N, d, splits, scale};
  dq_block<DP, true>(a);
}
template <int DP>
__global__ void __launch_bounds__(TcBwd<DP>::THREADS)
flash_bwd_dkv_split_bf16_kernel(bf16p q, bf16p k, bf16p v, bf16p dout,
                                const float* __restrict__ lse, float* __restrict__ dvec,
                                float* __restrict__ part, long long plane, Strides sq,
                                Strides sk, Strides sv, Strides sdo, int H, int N, int d,
                                int splits, float scale) {
  const BwdArgs a{q, k, v, nullptr, dout, lse, dvec, nullptr, nullptr,
                  nullptr, part, plane, sq, sk, sv, Strides{}, sdo, Strides{}, Strides{},
                  Strides{}, H, N, d, splits, scale};
  dkv_block<DP, true>(a);
}

constexpr int kReduceThreads = 256;

// dQ, dK and dV from their S partials: the sum over s in order, times the
// scale (dQ, dK) or 1 (dV), rounded once to bf16 and written through the
// caller's strides. One thread per (output, row, 8 columns); rows = B*H*N.
__global__ void __launch_bounds__(kReduceThreads)
flash_bwd_reduce_kernel(BwdArgs a, long long rows) {
  const int cpr = a.d / 8;
  const long long per = rows * cpr;  // items of one output
  const long long i = (long long)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= 3 * per) return;
  const int which = (int)(i / per);  // 0: dQ, 1: dK, 2: dV
  const long long j = i % per;
  const int c = (int)(j % cpr) * 8;
  const long long row = j / cpr;
  const int n = (int)(row % a.N);
  const long long bh = row / a.N;
  const float* src = a.part + which * a.plane + (bh * a.splits * a.N + n) * a.d + c;
  const long long step = (long long)a.N * a.d;  // from split s to s + 1
  float acc[8] = {};
#pragma unroll 4  // the loads of several splits in flight at once
  for (int s = 0; s < a.splits; ++s) {
    const float4* p = reinterpret_cast<const float4*>(src + s * step);
    const float4 x = p[0], y = p[1];
    acc[0] += x.x;
    acc[1] += x.y;
    acc[2] += x.z;
    acc[3] += x.w;
    acc[4] += y.x;
    acc[5] += y.y;
    acc[6] += y.z;
    acc[7] += y.w;
  }
  const float mul = which < 2 ? a.scale : 1.f;
  __nv_bfloat16* base = which == 0 ? a.dq : which == 1 ? a.dk : a.dv;
  const Strides st = which == 0 ? a.sdq : which == 1 ? a.sdk : a.sdv;
  __nv_bfloat16* dst = base + (bh / a.H) * st.b + (bh % a.H) * st.h + n * st.n + c;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    reinterpret_cast<__nv_bfloat162*>(dst)[k] =
        __floats2bfloat162_rn(acc[2 * k] * mul, acc[2 * k + 1] * mul);
}

template <int DP>
cudaError_t launch_bf16(const BwdArgs& a, int B, cudaStream_t stream) {
  using C = TcBwd<DP>;
  const int n_tiles = (a.N + C::BN - 1) / C::BN;
  if (a.splits > n_tiles) return cudaErrorInvalidValue;  // no split without rows
  const bool split = a.splits > 1;
  cudaError_t err = cudaFuncSetAttribute(split ? (const void*)flash_bwd_dq_split_bf16_kernel<DP>
                                               : (const void*)flash_bwd_dq_bf16_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(split ? (const void*)flash_bwd_dkv_split_bf16_kernel<DP>
                                   : (const void*)flash_bwd_dkv_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkv_smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * a.H * a.N;
  const long long blocks = (long long)B * a.H * ((a.N + C::ROWS - 1) / C::ROWS) * a.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (split)
    flash_bwd_dq_split_bf16_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        a.q, a.k, a.v, a.o, a.dout, a.lse, a.dvec, a.part, a.sq, a.sk, a.sv, a.so, a.sdo, a.H,
        a.N, a.d, a.splits, a.scale);
  else
    flash_bwd_dq_bf16_kernel<DP><<<grid, C::THREADS, C::dq_smem, stream>>>(
        a.q, a.k, a.v, a.o, a.dout, a.lse, a.dvec, a.dq, a.sq, a.sk, a.sv, a.so, a.sdo, a.sdq,
        a.H, a.N, a.d, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (split)
    flash_bwd_dkv_split_bf16_kernel<DP><<<grid, C::THREADS, C::dkv_smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.part, a.plane, a.sq, a.sk, a.sv, a.sdo, a.H,
        a.N, a.d, a.splits, a.scale);
  else
    flash_bwd_dkv_bf16_kernel<DP><<<grid, C::THREADS, C::dkv_smem, stream>>>(
        a.q, a.k, a.v, a.dout, a.lse, a.dvec, a.dk, a.dv, a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv,
        a.H, a.N, a.d, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return err;
  const long long items = 3 * rows * (a.d / 8);
  flash_bwd_reduce_kernel<<<(unsigned)((items + kReduceThreads - 1) / kReduceThreads),
                            kReduceThreads, 0, stream>>>(a, rows);
  return cudaGetLastError();
}

// the tensor-core kernels take rows of 16-byte multiples: d % 8 == 0, every
// B/H/N stride a multiple of 8 elements and 16-byte aligned data
inline bool tc_aligned(const void* p, Strides s, int d) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && d % 8 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.n % 8 == 0;
}

// ---- f32: the 3xTF32 tensor-core kernels ----

template <int DP> struct TfBwd {
  static constexpr int THREADS = 128;             // 4 warps of 16 rows
  static constexpr int ROWS = 64;                 // rows a block owns
  static constexpr int BN = DP <= 128 ? 32 : 16;  // rows per streamed tile
  static constexpr int LD = DP + 4;               // floats per shared-memory row
  static constexpr size_t tiles = sizeof(float) * (2 * ROWS + 4 * BN) * LD;
  static constexpr size_t dq_smem = tiles + sizeof(float) * ROWS;
  static constexpr size_t dkv_smem = tiles + sizeof(float) * 4 * BN;
};

// S = A0 B0^T and T = A1 B1^T for one warp in f32 by 3xTF32: A0, A1 the
// warp's 16 rows at a0/a1 (a_off_f32 layout), B0, B1 the streamed tile's
// rows at b0/b1 (bn_off_f32 layout). The k-steps run outermost, so each A
// fragment is split once a tile. LAST as in two_products.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void two_products_tf32(float (&s)[BN / 8][4], float (&t)[BN / 8][4],
                                                  uint32_t a0, uint32_t a1, uint32_t b0,
                                                  uint32_t b1, int live) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = t[j][e] = 0.f;
#pragma unroll
  for (int kd = 0; kd < DP / 8; ++kd) {
    uint32_t r0[4], r1[4];
    dfdt::ldsm_x4(r0, a0 + kd * 32);
    dfdt::ldsm_x4(r1, a1 + kd * 32);
    dfdt::FragA x0, x1;
    dfdt::split_a(x0, r0);
    dfdt::split_a(x1, r1);
#pragma unroll
    for (int np = 0; np < BN / 16; ++np) {
      if (!LAST || np * 16 < live) {
        uint32_t y0[4], y1[4];
        dfdt::ldsm_x4(y0, b0 + 4 * (np * 16 * LD + kd * 8));
        dfdt::ldsm_x4(y1, b1 + 4 * (np * 16 * LD + kd * 8));
        dfdt::FragB f;
        dfdt::split_b(f, __uint_as_float(y0[0]), __uint_as_float(y0[1]));
        dfdt::mma_3xtf32(s[2 * np], x0, f);
        dfdt::split_b(f, __uint_as_float(y0[2]), __uint_as_float(y0[3]));
        dfdt::mma_3xtf32(s[2 * np + 1], x0, f);
        dfdt::split_b(f, __uint_as_float(y1[0]), __uint_as_float(y1[1]));
        dfdt::mma_3xtf32(t[2 * np], x1, f);
        dfdt::split_b(f, __uint_as_float(y1[2]), __uint_as_float(y1[3]));
        dfdt::mma_3xtf32(t[2 * np + 1], x1, f);
      }
    }
  }
}

// acc += X Y for one warp in f32 by 3xTF32: X is 16 x BN, the C fragments
// x (relabelled k order); Y the streamed tile stored [k][n] at y
// (bk_off_f32 added), read by 32-bit loads. LAST as in product_into.
template <int DP, int BN, bool LAST>
__device__ __forceinline__ void product_into_tf32(float (&acc)[DP / 8][4],
                                                  const float (&x)[BN / 8][4], const float* y,
                                                  int live) {
  constexpr int LD = DP + 4;
#pragma unroll
  for (int kk = 0; kk < BN / 8; ++kk) {
    if (!LAST || kk * 8 < live) {
      dfdt::FragA a;
      dfdt::c_to_a_tf32<BN / 8>(a, x, kk);
#pragma unroll
      for (int jd = 0; jd < DP / 8; ++jd) {
        dfdt::FragB b;
        dfdt::load_b_kn<LD>(b, y, kk, jd);
        dfdt::mma_3xtf32(acc[jd], a, b);
      }
    }
  }
}

// The dQ pass in f32 (both passes are compiled for 1 block per SM: with no
// minimum, ptxas held the dK/dV pass to 168 registers at d = 64 and spilled).
// One block per (64-row query tile, b*h), row tile
// fastest: D for the tile's rows, then a walk over every K/V tile
// accumulating dQ = sum dS K, written times the scale.
template <int DP>
__global__ void __launch_bounds__(TfBwd<DP>::THREADS, 1)
flash_bwd_dq_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ o,
                         const float* __restrict__ dout, const float* __restrict__ lse,
                         float* __restrict__ dvec, float* __restrict__ dq, Strides sq,
                         Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq, int H,
                         int N, int d, float scale) {
  using C = TfBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sdO = sQ + C::ROWS * LD;
  float* sK = sdO + C::ROWS * LD;  // two stages
  float* sV = sK + 2 * BN * LD;    // two stages
  float* sD = sV + 2 * BN * LD;

  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, 1);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wrow0 = row0 + warp * 16;
  const bool active = wrow0 < N;

  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sQ, q + b * sq.b + h * sq.h, sq.n, row0, N,
                                                    d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sdO, dob, sdo.n, row0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sK, kb, sk.n, 0, N, d);
  dfdt::tile_async<DP, LD, BN, C::THREADS>(sV, vb, sv.n, 0, N, d);
  dfdt::cp_async_commit();

  // D = rowsum(dO * O): two lanes per row, 16-byte reads
  {
    const int r = threadIdx.x / 2;
    const int gr = row0 + r;
    float part = 0.f;
    if (gr < N) {
      const float* orow = o + b * so.b + h * so.h + gr * so.n;
      const float* drow = dob + gr * sdo.n;
      for (int c = (threadIdx.x % 2) * 4; c < d; c += 8) {
        const float4 x = *reinterpret_cast<const float4*>(orow + c);
        const float4 y = *reinterpret_cast<const float4*>(drow + c);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (threadIdx.x % 2 == 0) {
      sD[r] = part;
      if (gr < N) dvec[(long long)bh * N + gr] = part;
    }
  }

  const float sl2 = scale * kLog2e;
  float lrow[2], drow[2] = {0.f, 0.f};  // lse (log2 units) and D of rows g, g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = wrow0 + lane / 4 + 8 * i;
    lrow[i] = gr < N ? lse[(long long)bh * N + gr] * kLog2e : 0.f;
  }
  float acc[DP / 8][4] = {};
  const uint32_t wQ = dfdt::smem_u32(sQ + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const uint32_t wdO = dfdt::smem_u32(sdO + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
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
      if (t == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) drow[i] = sD[warp * 16 + lane / 4 + 8 * i];
      }
      const int key0 = t * BN;
      const int kv = min(BN, N - key0);
      float* tK = sK + st * BN * LD;
      const uint32_t uK = dfdt::smem_u32(tK);
      const uint32_t uV = dfdt::smem_u32(sV + st * BN * LD);
      // LAST: the tile that holds key N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S = Q K^T, dP = dO V^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products_tf32<DP, BN, LAST>(s, dp, wQ, wdO, uK + dfdt::bn_off_f32<LD>(lane),
                                        uV + dfdt::bn_off_f32<LD>(lane), kv);
        // dS = P (dP - D), P = exp(S scale - L) and 0 on keys >= N
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool live = !LAST || key0 + j * 8 + 2 * (lane % 4) + (e & 1) < N;
            const float p = live ? exp2f(fmaf(s[j][e], sl2, -lrow[e >> 1])) : 0.f;
            s[j][e] = p * (dp[j][e] - drow[e >> 1]);
          }
        // dQ += dS K
        product_into_tf32<DP, BN, LAST>(acc, s, tK + dfdt::bk_off_f32<LD>(lane), kv);
      };
      if (kv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  const float mul[2] = {scale, scale};
  dfdt::store_rows_f32<DP>(dq + b * sdq.b + h * sdq.h, sdq.n, acc, mul, wrow0, N, d,
                                   lane);
}

// The dK/dV pass in f32. One block per (64-key tile, b*h), row tile
// fastest: a walk over every Q/dO tile (with its lse and D rows)
// accumulating dV = sum P^T dO and dK = sum dS^T Q (written times the
// scale); P = 0 on query rows >= N.
template <int DP>
__global__ void __launch_bounds__(TfBwd<DP>::THREADS, 1)
flash_bwd_dkv_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ dvec,
                          float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                          Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv, int H,
                          int N, int d, float scale) {
  using C = TfBwd<DP>;
  constexpr int BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + C::ROWS * LD;
  float* sQ = sV + C::ROWS * LD;  // two stages
  float* sdO = sQ + 2 * BN * LD;  // two stages
  float* sL = sdO + 2 * BN * LD;  // two stages
  float* sD = sL + 2 * BN;        // two stages

  const dfdt::Work w = dfdt::block_work<C::ROWS, BN>(N, 1);
  const int bh = w.bh;
  const int b = bh / H;
  const int h = bh % H;
  const int key0 = w.row0;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wkey0 = key0 + warp * 16;
  const bool active = wkey0 < N;

  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * N;
  const float* db = dvec + (long long)bh * N;
  // query tile `tile` (its Q, dO, lse and D rows) into stage `st`
  auto load_queries = [&](int tile, int st) {
    const int q0 = tile * BN;
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sQ + st * BN * LD, qb, sq.n, q0, N, d);
    dfdt::tile_async<DP, LD, BN, C::THREADS>(sdO + st * BN * LD, dob, sdo.n, q0, N, d);
    for (int i = threadIdx.x; i < 2 * BN; i += C::THREADS) {
      const int r = i % BN;
      const bool ok = q0 + r < N;
      const float* src = i < BN ? lb : db;
      dfdt::cp_async4((i < BN ? sL : sD) + st * BN + r, ok ? src + q0 + r : src, ok);
    }
  };
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sK, k + b * sk.b + h * sk.h, sk.n, key0, N,
                                                    d);
  dfdt::tile_async<DP, LD, C::ROWS, C::THREADS>(sV, v + b * sv.b + h * sv.h, sv.n, key0, N,
                                                    d);
  load_queries(0, 0);
  dfdt::cp_async_commit();

  const float sl2 = scale * kLog2e;
  float acc_dk[DP / 8][4] = {}, acc_dv[DP / 8][4] = {};
  const uint32_t wK = dfdt::smem_u32(sK + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const uint32_t wV = dfdt::smem_u32(sV + warp * 16 * LD) + dfdt::a_off_f32<LD>(lane);
  const int n_tiles = (N + BN - 1) / BN;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    if (t + 1 < n_tiles) {
      load_queries(t + 1, st ^ 1);
      dfdt::cp_async_commit();
      dfdt::cp_async_wait<1>();
    } else {
      dfdt::cp_async_wait<0>();
    }
    __syncthreads();

    if (active) {
      const int q0 = t * BN;
      const int qv = min(BN, N - q0);
      const float* tQ = sQ + st * BN * LD;
      const float* tdO = sdO + st * BN * LD;
      const float* tL = sL + st * BN;
      const float* tD = sD + st * BN;
      // LAST: the tile that holds query row N - 1 (masked, with skips)
      auto step = [&](auto last) {
        constexpr bool LAST = decltype(last)::value;
        // S^T = K Q^T, dP^T = V dO^T
        float s[BN / 8][4], dp[BN / 8][4];
        two_products_tf32<DP, BN, LAST>(s, dp, wK, wV,
                                        dfdt::smem_u32(tQ) + dfdt::bn_off_f32<LD>(lane),
                                        dfdt::smem_u32(tdO) + dfdt::bn_off_f32<LD>(lane), qv);
        // P^T (0 on query rows >= N: their lse is not a logsumexp) and dS^T
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j * 8 + 2 * (lane % 4) + (e & 1);
            const float p = !LAST || q0 + col < N
                                ? exp2f(fmaf(s[j][e], sl2, -tL[col] * kLog2e))
                                : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - tD[col]);
          }
        // dV += P^T dO, dK += dS^T Q
        product_into_tf32<DP, BN, LAST>(acc_dv, s, tdO + dfdt::bk_off_f32<LD>(lane), qv);
        product_into_tf32<DP, BN, LAST>(acc_dk, dp, tQ + dfdt::bk_off_f32<LD>(lane), qv);
      };
      if (qv == BN)
        step(std::false_type{});
      else
        step(std::true_type{});
    }
    __syncthreads();
  }
  if (!active) return;
  const float mul_dk[2] = {scale, scale}, one[2] = {1.f, 1.f};
  dfdt::store_rows_f32<DP>(dk + b * sdk.b + h * sdk.h, sdk.n, acc_dk, mul_dk, wkey0, N,
                                   d, lane);
  dfdt::store_rows_f32<DP>(dv + b * sdv.b + h * sdv.h, sdv.n, acc_dv, one, wkey0, N, d,
                                   lane);
}

// st: (b, h, n) strides of q, k, v, o, dout, dq, dk, dv
template <int DP>
cudaError_t launch_tf32(const float* q, const float* k, const float* v, const float* o,
                        const float* dout, const float* lse, float* dvec, float* dq, float* dk,
                        float* dv, const Strides* st, int B, int H, int N, int d, float scale,
                        cudaStream_t stream) {
  using C = TfBwd<DP>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_tf32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::dq_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_tf32_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::dkv_smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((N + C::ROWS - 1) / C::ROWS);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_bwd_dq_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dq_smem, stream>>>(
      q, k, v, o, dout, lse, dvec, dq, st[0], st[1], st[2], st[3], st[4], st[5], H, N, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_tf32_kernel<DP><<<(unsigned)blocks, C::THREADS, C::dkv_smem, stream>>>(
      q, k, v, dout, lse, dvec, dk, dv, st[0], st[1], st[2], st[4], st[6], st[7], H, N, d, scale);
  return cudaGetLastError();
}

}  // namespace

// strides: 24 element strides, (b, h, n) for q, k, v, o, dout, dq, dk, dv in
// that order. lse and dvec (scratch for D) are contiguous f32 (B, H, N).
// bf16 goes to the bf16 tensor-core kernels, f32 to the 3xTF32 ones; both
// take 16-byte rows of q, k, v, o, dout (cudaErrorMisalignedAddress
// otherwise). splits:
// 1, or (bf16 only) the splits S of the split route, with `scratch` the
// caller's f32 buffer of 3*S*B*H*N*d elements for the partials.
extern "C" int dfdt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dvec, void* dq,
                              void* dk, void* dv, int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, int splits, void* scratch,
                              void* stream) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * 32 || splits < 1 ||
      (splits > 1 && (!is_bf16 || scratch == nullptr)))
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvv = static_cast<float*>(dvec);
  const void* ins[5] = {q, k, v, o, dout};
  for (int i = 0; i < 5; ++i)
    if (is_bf16 ? !tc_aligned(ins[i], st[i], d) : !dfdt::f32_aligned(ins[i], st[i], d))
      return (int)cudaErrorMisalignedAddress;
  for (int i = 5; i < 8; ++i)
    if (st[i].b % 2 || st[i].h % 2 || st[i].n % 2) return (int)cudaErrorMisalignedAddress;
  if (!is_bf16) {
    using F = const float*;
    F fq = static_cast<F>(q), fk = static_cast<F>(k), fv = static_cast<F>(v),
      fo = static_cast<F>(o), fdo = static_cast<F>(dout);
    float *fdq = static_cast<float*>(dq), *fdk = static_cast<float*>(dk),
          *fdv = static_cast<float*>(dv);
#define DFDT_BWD_TF32(DP) \
  launch_tf32<DP>(fq, fk, fv, fo, fdo, l, dvv, fdq, fdk, fdv, st, B, H, N, d, scale, s)
    if (d <= 32) return (int)DFDT_BWD_TF32(32);
    if (d <= 64) return (int)DFDT_BWD_TF32(64);
    if (d <= 128) return (int)DFDT_BWD_TF32(128);
    return (int)DFDT_BWD_TF32(256);
#undef DFDT_BWD_TF32
  }
  using T = __nv_bfloat16;
  const BwdArgs a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
                  static_cast<const T*>(o), static_cast<const T*>(dout), l, dvv,
                  static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
                  static_cast<float*>(scratch), (long long)splits * B * H * N * d,
                  st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], H, N, d, splits, scale};
#define DFDT_BWD_BF16(DP) \
  case DP / 16:           \
    return (int)launch_bf16<DP>(a, B, s);
  switch ((d + 15) / 16) {
    DFDT_BWD_BF16(16) DFDT_BWD_BF16(32) DFDT_BWD_BF16(48) DFDT_BWD_BF16(64)
    DFDT_BWD_BF16(80) DFDT_BWD_BF16(96) DFDT_BWD_BF16(112) DFDT_BWD_BF16(128)
    DFDT_BWD_BF16(144) DFDT_BWD_BF16(160) DFDT_BWD_BF16(176) DFDT_BWD_BF16(192)
    DFDT_BWD_BF16(208) DFDT_BWD_BF16(224) DFDT_BWD_BF16(240) DFDT_BWD_BF16(256)
  }
#undef DFDT_BWD_BF16
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dfdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
