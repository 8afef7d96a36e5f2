// Fused ImageNet normalisation: uint8 frames -> bf16 or f32 in one pass.
//
// Replaces deepfake_video_detection_tpu/ops/preprocess.py::_kernel (wrapper
// fused_normalize, K1): y = (x * (1/255) - mean[c]) * (1/std[c]), where the
// channel c is the flat index mod 3 of a channel-last (..., 3) buffer.
//
// What bounds it on an H100: bytes. Each element is 1 byte read and 2 (bf16)
// or 4 (f32) bytes written against 3 flops, about 1 flop per byte, far below
// the card's ridge of ~295. At (16, 8, 224, 224, 3) -> bf16 that is 19.3 MB
// in and 38.5 MB out, ~17 us at 3.35 TB/s.
//
// Design: a grid-stride loop in which each thread takes 16 input bytes with
// one 16-byte load and writes its 16 outputs with 16-byte stores, so every
// warp moves whole 512-byte (in) and 1-2 KB (out) segments. The channel of
// the first byte is its flat index mod 3; the next 15 follow cyclically. The
// tail (a size that is not a multiple of 16) and buffers that are not 16-byte
// aligned go through a scalar loop that masks by size, so any size is taken:
// the TPU kernel's 128-lane tiling rule has no counterpart here. mean and
// 1/std are compile-time constants, rounded from double to f32 the way the
// reference rounds its Python constants, and each step is rounded on its own
// (__fmul_rn/__fsub_rn: no fused multiply-add), so the result matches the
// plain PyTorch version bit for bit in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 blocks per SM is plenty for a stream

__device__ __forceinline__ float normalize1(uint32_t x, int c) {
  const float mean = c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
  const float inv_std = c == 0 ? (float)(1.0 / 0.229)
                               : (c == 1 ? (float)(1.0 / 0.224) : (float)(1.0 / 0.225));
  const float scaled = __fmul_rn((float)x, (float)(1.0 / 255.0));
  return __fmul_rn(__fsub_rn(scaled, mean), inv_std);
}

__device__ __forceinline__ void store1(float* out, float v) { *out = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store16(float* out, const float* v) {
  float4* dst = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* v) {
  alignas(16) __nv_bfloat162 h[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  uint4* dst = reinterpret_cast<uint4*>(out);
  const uint4* src = reinterpret_cast<const uint4*>(h);
  dst[0] = src[0];
  dst[1] = src[1];
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
normalize_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                 long long n, bool vectorized) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long scalar_from = 0;
  if (vectorized) {
    const long long chunks = n >> 4;
    const uint4* x16 = reinterpret_cast<const uint4*>(x);
    for (long long ch = tid; ch < chunks; ch += stride) {
      const uint4 raw = x16[ch];
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      int c = (int)((ch << 4) % 3);
      alignas(16) float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = normalize1((words[j >> 2] >> ((j & 3) * 8)) & 0xffu, c);
        c = c == 2 ? 0 : c + 1;
      }
      store16(out + (ch << 4), v);
    }
    scalar_from = chunks << 4;
  }
  for (long long i = scalar_from + tid; i < n; i += stride)
    store1(out + i, normalize1(x[i], (int)(i % 3)));
}

}  // namespace

extern "C" int dfdt_normalize_u8(const void* x, void* out, long long n,
                                 int out_bf16, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const bool vectorized =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const long long work = vectorized ? (n + 15) / 16 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* xin = static_cast<const uint8_t*>(x);
  if (out_bf16)
    normalize_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
        xin, static_cast<__nv_bfloat16*>(out), n, vectorized);
  else
    normalize_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        xin, static_cast<float*>(out), n, vectorized);
  return (int)cudaGetLastError();
}

extern "C" const char* dfdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
