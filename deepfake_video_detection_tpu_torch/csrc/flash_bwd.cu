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
// bf16 (every path of the port on the card) runs flash_bwd_dq_bf16_kernel
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
// f32 (the CLI's default without --bf16, and the f32 tests, which need
// atol = rtol = 1e-3) runs flash_bwd_dq_kernel and flash_bwd_dkv_kernel:
// the TPU kernel's f32 arithmetic on the CUDA cores (67 TFLOP/s f32; TF32
// tensor cores would not hold it), bound in practice by their FMAs and
// shared-memory reads. Layout of the work, in both: 256 threads as a
// 16 x 16 grid; thread (ty, tx) owns tile rows ty + 16i and tile columns
// tx + 16j of every score tile, and rows ty + 16i with head-dim columns
// tx + 16jj of its accumulators. Tiles are staged as f32 in shared memory
// with rows padded by one float (column walks hit distinct banks) and P/dS
// rows padded to BM + 16 floats (the two half-warps of a warp land 16 banks
// apart). The head dim is a template on its padded width (32/64/128/256,
// zero-filled columns); the tile height BM is 64, or 32 at d = 256 so the
// four staged tiles fit (144 KB of dynamic shared memory, raised with
// cudaFuncSetAttribute).
//
// f32 has no split route: at N > 512 its grid is as short of blocks as the
// bf16 one was. Both take element strides for the B, H and N axes (the last
// axis contiguous), so dO goes in as the strided view autograd hands over
// and q, k, v as views of a fused QKV projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, h, n;
};

// the CUDA-core kernels are templates on the element type; only f32 is
// instantiated (bf16 runs on the tensor-core kernels)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

// tile height for a padded head dim: 64 rows, or 32 at d = 256
template <int DP> struct Tile {
  static constexpr int BM = DP > 128 ? 32 : 64;
};

template <int DP>
constexpr size_t dq_smem_bytes() {
  constexpr int BM = Tile<DP>::BM;
  return sizeof(float) * (4 * BM * (DP + 1) + BM * (BM + 16) + 2 * BM);
}

template <int DP>
constexpr size_t dkv_smem_bytes() {
  constexpr int BM = Tile<DP>::BM;
  return sizeof(float) * (4 * BM * (DP + 1) + 2 * BM * (BM + 16) + 2 * BM);
}

// Stage rows [row0, row0 + BM) of one (b, h) slice into shared memory as f32
// (row stride DP + 1), zero-filling rows >= n and columns >= d.
template <typename T, int DP, int BM>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n, int d) {
  for (int idx = threadIdx.x; idx < BM * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < n && c < d) val = to_f32(src[gr * row_stride + c]);
    dst[r * (DP + 1) + c] = val;
  }
}

// Stage BM entries of a contiguous per-row f32 vector, zero past n.
template <int BM>
__device__ __forceinline__ void load_rows(float* __restrict__ dst, const float* __restrict__ src,
                                          int row0, int n) {
  for (int r = threadIdx.x; r < BM; r += kThreads) dst[r] = row0 + r < n ? src[row0 + r] : 0.f;
}

// dQ pass. One block per (BM-row query tile, b*h): D for the tile's rows,
// then a walk over the K/V tiles accumulating dQ = sum dS K * scale.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dvec, T* __restrict__ dq,
                    Strides sq, Strides sk, Strides sv, Strides so, Strides sdo, Strides sdq,
                    int H, int N, int d, float scale) {
  constexpr int BM = Tile<DP>::BM;
  constexpr int LD = DP + 1;
  constexpr int PS = BM + 16;
  constexpr int R = BM / 16;     // tile rows (and score columns) per thread
  constexpr int CPT = DP / 16;   // accumulator columns per thread
  constexpr int TPR = kThreads / BM;  // threads per row in the D reduction
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BM * LD;
  float* sK = sdO + BM * LD;
  float* sV = sK + BM * LD;
  float* sS = sV + BM * LD;
  float* sL = sS + BM * PS;
  float* sD = sL + BM;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, DP, BM>(sQ, q + b * sq.b + h * sq.h, sq.n, row0, N, d);
  load_tile<T, DP, BM>(sdO, dout + b * sdo.b + h * sdo.h, sdo.n, row0, N, d);
  load_tile<T, DP, BM>(sK, o + b * so.b + h * so.h, so.n, row0, N, d);  // O, for D
  load_rows<BM>(sL, lse + (long long)bh * N, row0, N);
  __syncthreads();

  // D = rowsum(dO * O): TPR consecutive lanes per row, reduced by shuffles
  {
    const int r = threadIdx.x / TPR;
    const int lane = threadIdx.x % TPR;
    float part = 0.f;
    for (int c = lane; c < DP; c += TPR) part = fmaf(sdO[r * LD + c], sK[r * LD + c], part);
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) {
      sD[r] = part;
      if (row0 + r < N) dvec[(long long)bh * N + row0 + r] = part;
    }
  }
  __syncthreads();

  float acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;

  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (N + BM - 1) / BM;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * BM;
    load_tile<T, DP, BM>(sK, kb, sk.n, key0, N, d);
    load_tile<T, DP, BM>(sV, vb, sv.n, key0, N, d);
    __syncthreads();

    // S = Q K^T and dP = dO V^T for this thread's R x R (rows x keys)
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = sQ[(ty + 16 * i) * LD + c];
        dov[i] = sdO[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + c];
        vv[j] = sV[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // dS = P * (dP - D), P = exp(S * scale - L), P = 0 on keys >= N
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + 16 * j;
        const float p = key0 + col < N ? expf(s[i][j] * scale - sL[r]) : 0.f;
        sS[r * PS + col] = p * (dp[i][j] - sD[r]);
      }
    }
    __syncthreads();

    // dQ += dS K over the valid keys of the tile
    const int keys = min(BM, N - key0);
    for (int kk = 0; kk < keys; ++kk) {
      float dsv[R], kv[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) dsv[i] = sS[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) kv[jj] = sK[kk * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = fmaf(dsv[i], kv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= N) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) dqb[gr * sdq.n + c] = from_f32<T>(acc[i][jj] * scale);
    }
  }
}

// dK/dV pass. One block per (BM-key tile, b*h): a walk over the Q/dO tiles
// accumulating dV = sum P^T dO and dK = sum dS^T Q * scale.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
                     Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk, Strides sdv,
                     int H, int N, int d, float scale) {
  constexpr int BM = Tile<DP>::BM;
  constexpr int LD = DP + 1;
  constexpr int PS = BM + 16;
  constexpr int R = BM / 16;
  constexpr int CPT = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BM * LD;
  float* sQ = sV + BM * LD;
  float* sdO = sQ + BM * LD;
  float* sP = sdO + BM * LD;
  float* sdS = sP + BM * PS;
  float* sL = sdS + BM * PS;
  float* sD = sL + BM;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int key0 = blockIdx.y * BM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<T, DP, BM>(sK, k + b * sk.b + h * sk.h, sk.n, key0, N, d);
  load_tile<T, DP, BM>(sV, v + b * sv.b + h * sv.h, sv.n, key0, N, d);

  float acc_dk[R][CPT], acc_dv[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc_dk[i][jj] = acc_dv[i][jj] = 0.f;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* dob = dout + b * sdo.b + h * sdo.h;
  const float* lb = lse + (long long)bh * N;
  const float* db = dvec + (long long)bh * N;
  const int n_tiles = (N + BM - 1) / BM;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BM;
    load_tile<T, DP, BM>(sQ, qb, sq.n, q0, N, d);
    load_tile<T, DP, BM>(sdO, dob, sdo.n, q0, N, d);
    load_rows<BM>(sL, lb, q0, N);
    load_rows<BM>(sD, db, q0, N);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for this thread's R x R (keys x rows)
    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DP; ++c) {
      float kv[R], vv[R], qv[R], dov[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        kv[i] = sK[(ty + 16 * i) * LD + c];
        vv[i] = sV[(ty + 16 * i) * LD + c];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + c];
        dov[j] = sdO[(tx + 16 * j) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // P^T and dS^T; P = 0 on query rows >= N (their L is not a logsumexp)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int col = tx + 16 * j;
        const float p = q0 + col < N ? expf(s[i][j] * scale - sL[col]) : 0.f;
        sP[r * PS + col] = p;
        sdS[r * PS + col] = p * (dp[i][j] - sD[col]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the valid rows of the tile
    const int rows = min(BM, N - q0);
    for (int qq = 0; qq < rows; ++qq) {
      float pv[R], dsv[R], dov[CPT], qv[CPT];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = sP[(ty + 16 * i) * PS + qq];
        dsv[i] = sdS[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) {
        dov[jj] = sdO[qq * LD + tx + 16 * jj];
        qv[jj] = sQ[qq * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) {
          acc_dv[i][jj] = fmaf(pv[i], dov[jj], acc_dv[i][jj]);
          acc_dk[i][jj] = fmaf(dsv[i], qv[jj], acc_dk[i][jj]);
        }
    }
    __syncthreads();
  }

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int gr = key0 + ty + 16 * i;
    if (gr >= N) continue;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) {
        dkb[gr * sdk.n + c] = from_f32<T>(acc_dk[i][jj] * scale);
        dvb[gr * sdv.n + c] = from_f32<T>(acc_dv[i][jj]);
      }
    }
  }
}

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
    dfdt::store_rows_f32<DP>(a.part + ((long long)bh * a.splits + w.s) * N * d, acc, one, wrow0,
                             N, d, lane);
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
    dfdt::store_rows_f32<DP>(dst, acc_dk, one, wkey0, N, d, lane);
    dfdt::store_rows_f32<DP>(dst + a.plane, acc_dv, one, wkey0, N, d, lane);
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

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* dvec, void* dq, void* dk, void* dv,
                   const Strides* st, int B, int H, int N, int d, float scale,
                   cudaStream_t stream) {
  constexpr int BM = Tile<DP>::BM;
  constexpr size_t smem_dq = dq_smem_bytes<DP>();
  constexpr size_t smem_dkv = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((N + BM - 1) / BM));
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, DP><<<grid, kThreads, smem_dq, stream>>>(
      tq, tk, tv, static_cast<const T*>(o), tdo, lse, dvec, static_cast<T*>(dq),
      st[0], st[1], st[2], st[3], st[4], st[5], H, N, d, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, DP><<<grid, kThreads, smem_dkv, stream>>>(
      tq, tk, tv, tdo, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv),
      st[0], st[1], st[2], st[4], st[6], st[7], H, N, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* dvec, void* dq, void* dk,
                       void* dv, const Strides* st, int B, int H, int N, int d, float scale,
                       cudaStream_t s) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, dout, lse, dvec, dq, dk, dv, st, B, H, N, d, scale, s);
  if (d <= 64) return launch<T, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, st, B, H, N, d, scale, s);
  if (d <= 128) return launch<T, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, st, B, H, N, d, scale, s);
  return launch<T, 256>(q, k, v, o, dout, lse, dvec, dq, dk, dv, st, B, H, N, d, scale, s);
}

}  // namespace

// strides: 24 element strides, (b, h, n) for q, k, v, o, dout, dq, dk, dv in
// that order. lse and dvec (scratch for D) are contiguous f32 (B, H, N).
// bf16 goes to the tensor-core kernels, f32 to the CUDA-core ones. splits:
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
  if (!is_bf16)
    return (int)dispatch_d<float>(q, k, v, o, dout, l, dvv, dq, dk, dv, st, B, H, N, d, scale, s);
  const void* ins[5] = {q, k, v, o, dout};
  for (int i = 0; i < 5; ++i)
    if (!tc_aligned(ins[i], st[i], d)) return (int)cudaErrorMisalignedAddress;
  for (int i = 5; i < 8; ++i)
    if (st[i].b % 2 || st[i].h % 2 || st[i].n % 2) return (int)cudaErrorMisalignedAddress;
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
