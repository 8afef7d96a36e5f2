// Flash attention backward for Hopper: dQ, dK and dV of O = softmax(Q K^T s) V,
// s = 1/sqrt(d), from the forward's O and per-row logsumexp L.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_bwd_kernel
// (K4, n_pad <= 512: the ViT blocks in training, N = 197 at 224 px) and
// computes the same functions as ::_bwd_dq_kernel (K5) and ::_bwd_dkv_kernel
// (K6), the streaming FlashAttention-2 passes for n_pad > 512, since both
// kernels here stream over any N. As in those kernels: keys >= N get P = 0
// (the -1e30 mask), query rows >= N get P = 0 (the padded rows the TPU
// kernels zero explicitly), the math runs in f32 whatever the input type,
// and dQ, dK, dV are written in the input type.
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
// dK/dV pass, launched after it on the same stream, reads it.
//
// What bounds it on an H100: by the roofline, bytes. At the ViT-B/16 training
// shape (128, 12, 197, 64) bf16 the function reads q, k, v, O, dO (5 x 38.7
// MB) and lse, and writes dq, dk, dv (3 x 38.7 MB): ~312 MB, ~0.093 ms at
// 3.35 TB/s; its 10*N^2*d*B*H = 38 GFLOP take ~0.039 ms at 989 TFLOP/s. This
// first kernel keeps the TPU kernel's f32 arithmetic on the CUDA cores (67
// TFLOP/s f32), so in practice it is bound by its own FMAs and shared-memory
// reads; the tensor cores are left to a later change, as for the forward.
//
// Layout of the work, in both kernels: 256 threads as a 16 x 16 grid; thread
// (ty, tx) owns tile rows ty + 16i and tile columns tx + 16j of every score
// tile, and rows ty + 16i with head-dim columns tx + 16jj of its
// accumulators. Tiles are staged as f32 in shared memory with rows padded by
// one float (column walks hit distinct banks) and P/dS rows padded to BM + 16
// floats (the two half-warps of a warp land 16 banks apart). The head dim is
// a template on its padded width (32/64/128/256, zero-filled columns); the
// tile height BM is 64, or 32 at d = 256 so the four staged tiles fit (144 KB
// of dynamic shared memory, raised with cudaFuncSetAttribute). Inputs take
// element strides for the B, H and N axes (the last axis contiguous), so dO
// goes in as the strided view autograd hands over and q, k, v as views of a
// fused QKV projection.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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
extern "C" int dfdt_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const void* lse, void* dvec, void* dq,
                              void* dk, void* dv, int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * 32)
    return (int)cudaErrorInvalidValue;
  Strides st[8];
  for (int i = 0; i < 8; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dvv = static_cast<float*>(dvec);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, dout, l, dvv, dq, dk, dv, st, B, H, N, d, scale, s)
              : dispatch_d<float>(q, k, v, o, dout, l, dvv, dq, dk, dv, st, B, H, N, d, scale, s);
  return (int)err;
}

extern "C" const char* dfdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
