// Flash attention forward for Hopper: O = softmax(Q K^T / sqrt(d)) V and the
// per-row logsumexp of the scaled scores.
//
// Replaces deepfake_video_detection_tpu/ops/attention.py::_short_attn_kernel
// (K2, n_pad <= 512: the ViT blocks, N = 197 at 224 px) and computes the same
// function as ::_attn_kernel (K3, the streaming kernel for n_pad > 512), since
// it streams over any N. As in those kernels, keys >= N are masked to -1e30
// (not -inf), l is guarded by max(l, 1e-30), the math runs in f32 whatever
// the input type, O is written in the input type and lse in f32.
//
// What bounds it on an H100: by the roofline, bytes. At the ViT-B/16 serving
// shape (8, 12, 197, 64) bf16 one call does 4*N^2*d*B*H = 0.95 GFLOP (~1 us
// at 989 TFLOP/s on the tensor cores) and moves 9.7 MB (~2.9 us at
// 3.35 TB/s). This first kernel keeps the TPU kernel's f32 arithmetic and
// runs it on the CUDA cores (67 TFLOP/s f32), with tiles padded to 64, so in
// practice it is bound by its own FMAs and shared-memory reads; the tensor
// cores (mma/wgmma on bf16 tiles) are left to a later change.
//
// Design: one block of 256 threads per (64-row query tile, batch*head). The
// grid is (B*H, ceil(N/64)). The Q tile is staged once in shared memory,
// pre-scaled by 1/sqrt(d) as the TPU kernel does; the block then walks
// 64-row K/V tiles through shared memory with the online-softmax recurrence
// (running max m, sum l and accumulator, all in f32 registers). Threads form
// a 16 x 16 grid: thread (ty, tx) owns query rows ty + 16i and keys tx + 16j
// (i, j < 4) of each score tile, and the same rows with head-dim columns
// tx + 16jj of the accumulator, so each shared-memory read feeds 4 FMAs. Row
// max and sum are reduced over the 16 tx lanes of a half-warp by shuffles. P
// goes through shared memory into the P.V product. Q and K rows are padded by
// one float and P rows to 80 floats, so the column walks hit distinct banks.
// The head dim is a template on its padded width (32/64/128/256, zero-filled
// columns), so any d <= 256 is taken; the tiles live in dynamic shared memory
// (69 KB at d = 64, 213 KB at d = 256) raised with cudaFuncSetAttribute.
// There is no grouping of heads per program (_short_group): it existed because
// a TPU grid runs in sequence, while this grid fills the 132 SMs in parallel.
// Q, K and V take element strides for the B, H and N axes (the last axis is
// contiguous), so the q/k/v views of a fused QKV projection go in without a
// copy; O is written through strides as well.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block
constexpr int kBlockN = 64;   // keys per K/V tile
constexpr int kThreads = 256;
constexpr int kPStride = 80;  // floats per P row: the two half-warps land 16 banks apart
constexpr float kNegBig = -1e30f;

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

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlockM * (DP + 1) + kBlockN * DP + kBlockM * kPStride);
}

// Stage rows [row0, row0 + 64) of one (b, h) slice into shared memory as f32,
// zero-filling rows >= n and columns >= d, times `mul`.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ src,
                                          long long row_stride, int row0, int n, int d,
                                          float mul) {
  for (int idx = threadIdx.x; idx < kBlockM * DP; idx += kThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int gr = row0 + r;
    float val = 0.f;
    if (gr < n && c < d) val = to_f32(src[gr * row_stride + c]) * mul;
    dst[r * LD + c] = val;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq, Strides sk,
                 Strides sv, Strides so, int H, int N, int d, float scale) {
  constexpr int QS = DP + 1;  // padded row stride of sQ and sK
  constexpr int CPT = DP / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockM * QS;
  float* sV = sK + kBlockN * QS;
  float* sP = sV + kBlockN * DP;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int row0 = blockIdx.y * kBlockM;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  load_tile<T, DP, QS>(sQ, qb, sq.n, row0, N, d, scale);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = (N + kBlockN - 1) / kBlockN;
  for (int t = 0; t < n_tiles; ++t) {
    const int key0 = t * kBlockN;
    load_tile<T, DP, QS>(sK, kb, sk.n, key0, N, d, 1.f);
    load_tile<T, DP, DP>(sV, vb, sv.n, key0, N, d, 1.f);
    __syncthreads();

    // S = (Q * scale) K^T for this thread's 4 x 4 rows x keys
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DP; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile's keys, row by row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (key0 + tx + 16 * j >= N) s[i][j] = kNegBig;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // acc += P V over the valid keys of the tile
    const int keys = min(kBlockN, N - key0);
    for (int kk = 0; kk < keys; ++kk) {
      float pv[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int jj = 0; jj < CPT; ++jj) vv[jj] = sV[kk * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < CPT; ++jj) acc[i][jj] = fmaf(pv[i], vv[jj], acc[i][jj]);
    }
    __syncthreads();
  }

  T* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= N) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < CPT; ++jj) {
      const int c = tx + 16 * jj;
      if (c < d) ob[gr * so.n + c] = from_f32<T>(acc[i][jj] / l_safe);
    }
    if (tx == 0) lse[(long long)bh * N + gr] = m[i] + logf(l_safe);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int N,
                   int d, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(B * H), (unsigned)((N + kBlockM - 1) / kBlockM));
  flash_fwd_kernel<T, DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, sv, so, H, N, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse,
                       Strides sq, Strides sk, Strides sv, Strides so, int B, int H,
                       int N, int d, float scale, cudaStream_t stream) {
  if (d <= 32) return launch<T, 32>(q, k, v, o, lse, sq, sk, sv, so, B, H, N, d, scale, stream);
  if (d <= 64) return launch<T, 64>(q, k, v, o, lse, sq, sk, sv, so, B, H, N, d, scale, stream);
  if (d <= 128) return launch<T, 128>(q, k, v, o, lse, sq, sk, sv, so, B, H, N, d, scale, stream);
  return launch<T, 256>(q, k, v, o, lse, sq, sk, sv, so, B, H, N, d, scale, stream);
}

}  // namespace

// strides: 12 element strides, (b, h, n) for q, k, v and o in that order.
extern "C" int dfdt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int B, int H, int N, int d, int is_bf16,
                              const long long* strides, float scale, void* stream) {
  if (B < 1 || H < 1 || N < 1 || d < 1 || d > 256 || N > 65535 * kBlockM)
    return (int)cudaErrorInvalidValue;
  const Strides sq{strides[0], strides[1], strides[2]};
  const Strides sk{strides[3], strides[4], strides[5]};
  const Strides sv{strides[6], strides[7], strides[8]};
  const Strides so{strides[9], strides[10], strides[11]};
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, l, sq, sk, sv, so, B, H, N, d, scale, s)
              : dispatch_d<float>(q, k, v, o, l, sq, sk, sv, so, B, H, N, d, scale, s);
  return (int)err;
}

extern "C" const char* dfdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
