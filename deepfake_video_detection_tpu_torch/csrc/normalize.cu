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
//
// Second entry, packed YUV420 -> normalised RGB (dfdt_normalize_yuv420):
// the serving forward's YUV branch. The JAX package needs no kernel there
// (XLA fuses ops/yuv.py's colour matrix into the normalisation and the stem
// conv); eager PyTorch would run it as some 25 launches over f32 tensors.
// Input: contiguous uint8 frames of H*W*3/2 bytes each, Y plane (H, W), then
// U and V (H/2, W/2); output (frames, H, W, 3) bf16 or f32. Per pixel: Y at
// (h, w), U and V at (h/2, w/2) (nearest 2x chroma), the BT.601 limited-range
// matrix of ops/yuv.py, clamp to [0, 255], then (x / 255 - mean[c]) / std[c],
// written once. Each step is rounded on its own, in the plain version's
// order (no fused multiply-add); the two divisions are multiplications by
// the f32 reciprocals (an IEEE division costs some twenty instructions), so
// f32 agrees with the plain version to a few ulp.
// Bound: bytes again, 1.5 bytes in and 6 (bf16) or 12 (f32) out per pixel;
// at (16, 8, 224, 224) -> bf16, 9.6 MB in and 38.5 MB out, ~14 us at
// 3.35 TB/s. Threads: where W is a multiple of 8 (every serving size), one
// per run of 8 pixels: one 8-byte Y load, one 4-byte U and one 4-byte V load
// (a warp reads 256 consecutive Y bytes). A warp's 32 runs are 256
// consecutive pixels, so its outputs are one contiguous span of 1.5 KB
// (bf16) or 3 KB (f32): each thread puts its 24 values in shared memory and
// the warp writes the span back with 16-byte stores, lane after lane, so
// every store instruction fills whole 512-byte segments. Other widths take
// one thread per pixel pair (byte loads, 4- or 8-byte stores). The grid's x
// walks the runs of one frame and its y the frames; each input byte is read
// once from memory.

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

__device__ __forceinline__ void yuv_to_normalized(uint32_t y, float uf, float vf,
                                                  float* rgb) {
  const float yl = __fmul_rn(1.164383f, __fsub_rn((float)y, 16.0f));
  float c[3];
  c[0] = __fadd_rn(yl, __fmul_rn(1.596027f, vf));
  c[1] = __fsub_rn(__fsub_rn(yl, __fmul_rn(0.391762f, uf)), __fmul_rn(0.812968f, vf));
  c[2] = __fadd_rn(yl, __fmul_rn(2.017232f, uf));
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float inv_std[3] = {1.0f / 0.229f, 1.0f / 0.224f, 1.0f / 0.225f};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float x = fminf(fmaxf(c[k], 0.0f), 255.0f);
    rgb[k] = __fmul_rn(__fsub_rn(__fmul_rn(x, (float)(1.0 / 255.0)), mean[k]),
                       inv_std[k]);
  }
}

__device__ __forceinline__ void store_pair(float* out, const float* v) {
  float2* dst = reinterpret_cast<float2*>(out);  // 24-byte aligned
  dst[0] = make_float2(v[0], v[1]);
  dst[1] = make_float2(v[2], v[3]);
  dst[2] = make_float2(v[4], v[5]);
}

__device__ __forceinline__ void store_pair(__nv_bfloat16* out, const float* v) {
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(out);  // 12-byte aligned
  dst[0] = __floats2bfloat162_rn(v[0], v[1]);
  dst[1] = __floats2bfloat162_rn(v[2], v[3]);
  dst[2] = __floats2bfloat162_rn(v[4], v[5]);
}

__device__ __forceinline__ void stage24(float* dst, const float* v) {
  float4* d = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int q = 0; q < 6; ++q)
    d[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

__device__ __forceinline__ void stage24(__nv_bfloat16* dst, const float* v) {
  alignas(16) __nv_bfloat162 h[12];
#pragma unroll
  for (int q = 0; q < 12; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  uint4* d = reinterpret_cast<uint4*>(dst);
  const uint4* src = reinterpret_cast<const uint4*>(h);
  d[0] = src[0];
  d[1] = src[1];
  d[2] = src[2];
}

// W % 8 == 0: one thread per 8 pixels of a row (4 chroma columns); run r of a
// frame is its pixels [8r, 8r + 8)
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
yuv420_normalize_x8_kernel(const uint8_t* __restrict__ packed, OutT* __restrict__ out,
                           long long frames, int height, int width) {
  __shared__ __align__(16) unsigned char stage_bytes[kThreads * 24 * sizeof(OutT)];
  OutT* stage = reinterpret_cast<OutT*>(stage_bytes);
  const int runs_w = width >> 3;
  const int runs = height * runs_w;                // 8-pixel runs in a frame
  const int lane = threadIdx.x & 31;
  const int run = blockIdx.x * blockDim.x + threadIdx.x;
  const int run0 = run - lane;                     // the warp's first run
  if (run0 >= runs) return;                        // the whole warp is past the frame
  const int count = min(32, runs - run0);
  const int h = run / runs_w;
  const int w8 = run - h * runs_w;
  const long long hw = (long long)height * width;
  const long long frame_bytes = hw * 3 / 2;
  const int chroma = (h >> 1) * (width >> 1) + 4 * w8;
  OutT* warp_stage = stage + (threadIdx.x - lane) * 24;
  const int chunks = count * 24 * (int)sizeof(OutT) / 16;
  for (long long f = blockIdx.y; f < frames; f += gridDim.y) {
    if (lane < count) {
      const uint8_t* yp = packed + f * frame_bytes;
      const uint2 y8 = *reinterpret_cast<const uint2*>(yp + 8 * run);
      const uint32_t u4 = *reinterpret_cast<const uint32_t*>(yp + hw + chroma);
      const uint32_t v4 = *reinterpret_cast<const uint32_t*>(yp + hw + hw / 4 + chroma);
      float v[24];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float uf = __fsub_rn((float)((u4 >> (8 * j)) & 0xffu), 128.0f);
        const float vf = __fsub_rn((float)((v4 >> (8 * j)) & 0xffu), 128.0f);
        const uint32_t yw = j < 2 ? y8.x : y8.y;
        const int sh = 16 * (j & 1);
        yuv_to_normalized((yw >> sh) & 0xffu, uf, vf, v + 6 * j);
        yuv_to_normalized((yw >> (sh + 8)) & 0xffu, uf, vf, v + 6 * j + 3);
      }
      stage24(warp_stage + lane * 24, v);
    }
    __syncwarp();
    const uint4* src = reinterpret_cast<const uint4*>(warp_stage);
    uint4* dst = reinterpret_cast<uint4*>(out + (f * hw + 8LL * run0) * 3);
    for (int c = lane; c < chunks; c += 32) dst[c] = src[c];
    __syncwarp();
  }
}

// any even W: one thread per pixel pair
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
yuv420_normalize_kernel(const uint8_t* __restrict__ packed, OutT* __restrict__ out,
                        long long frames, int height, int width) {
  const int half_w = width >> 1;
  const int pairs = height * half_w;               // pixel pairs in a frame
  const int pair = blockIdx.x * blockDim.x + threadIdx.x;
  if (pair >= pairs) return;
  const int h = pair / half_w;
  const int w2 = pair - h * half_w;                // chroma column
  const long long hw = (long long)height * width;
  const long long frame_bytes = hw * 3 / 2;
  const int chroma = (h >> 1) * half_w + w2;
  for (long long f = blockIdx.y; f < frames; f += gridDim.y) {
    const uint8_t* yp = packed + f * frame_bytes;
    const float uf = __fsub_rn((float)yp[hw + chroma], 128.0f);
    const float vf = __fsub_rn((float)yp[hw + hw / 4 + chroma], 128.0f);
    const int pix = h * width + 2 * w2;
    float v[6];
    yuv_to_normalized(yp[pix], uf, vf, v);
    yuv_to_normalized(yp[pix + 1], uf, vf, v + 3);
    store_pair(out + (f * hw + pix) * 3, v);
  }
}

}  // namespace

extern "C" int dfdt_normalize_yuv420(const void* packed, void* out, long long frames,
                                     int height, int width, int out_bf16, void* stream) {
  if (frames <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  const unsigned fy = (unsigned)(frames < 65535 ? frames : 65535);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(packed);
  const bool x8 = width % 8 == 0 && (reinterpret_cast<uintptr_t>(packed) & 7) == 0 &&
                  (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (x8) {
    const int runs = height * (width / 8);
    const dim3 grid((unsigned)((runs + kThreads - 1) / kThreads), fy);
    if (out_bf16)
      yuv420_normalize_x8_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
          in, static_cast<__nv_bfloat16*>(out), frames, height, width);
    else
      yuv420_normalize_x8_kernel<float><<<grid, kThreads, 0, s>>>(
          in, static_cast<float*>(out), frames, height, width);
    return (int)cudaGetLastError();
  }
  const int pairs = height * (width / 2);
  const dim3 grid((unsigned)((pairs + kThreads - 1) / kThreads), fy);
  if (out_bf16)
    yuv420_normalize_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        in, static_cast<__nv_bfloat16*>(out), frames, height, width);
  else
    yuv420_normalize_kernel<float><<<grid, kThreads, 0, s>>>(
        in, static_cast<float*>(out), frames, height, width);
  return (int)cudaGetLastError();
}

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
