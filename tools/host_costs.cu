// Host costs of the driver and runtime calls that a flash wrapper's ctypes
// call makes, on the current device, each the mean of `iters` calls in a C
// loop (no Python in between): a tensor map encoded (cuTensorMapEncodeTiled),
// a cached map copied and given a new address (cuTensorMapReplaceAddress),
// cudaFuncSetAttribute of the dynamic shared memory, a launch of an empty
// kernel that takes four or six tensor maps (the flash kernels' parameters),
// and cudaGetDevice. Built and called by tools/flash_host_split.py --costs.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libhost_costs.so tools/host_costs.cu

#include <cuda.h>
#include <cuda_runtime.h>

#include <chrono>
#include <cstring>

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

void* entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                                           &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

__global__ void four_maps(const __grid_constant__ CUtensorMap a,
                          const __grid_constant__ CUtensorMap b,
                          const __grid_constant__ CUtensorMap c,
                          const __grid_constant__ CUtensorMap d, float* x, int n, float s) {}

__global__ void six_maps(const __grid_constant__ CUtensorMap a,
                         const __grid_constant__ CUtensorMap b,
                         const __grid_constant__ CUtensorMap c,
                         const __grid_constant__ CUtensorMap d,
                         const __grid_constant__ CUtensorMap e,
                         const __grid_constant__ CUtensorMap f, float* x, int n, float s) {}

double now_ns() {
  return (double)std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

}  // namespace

// out (6 doubles, ns a call): encode, copy + replace address, set attribute,
// launch with 4 maps, launch with 6 maps, cudaGetDevice. geo: 9 values as
// ops/attention.py::_tma_geometry gives them (dims, byte strides, box).
extern "C" int host_costs(double* out, int iters, void* ptr, const long long* geo, int f32,
                          int smem, void* stream) {
  const auto encode = reinterpret_cast<EncodeTiled>(entry("cuTensorMapEncodeTiled"));
  const auto replace = reinterpret_cast<ReplaceAddress>(entry("cuTensorMapReplaceAddress"));
  if (encode == nullptr || replace == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1], (cuuint64_t)geo[2],
                              (cuuint64_t)geo[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geo[4], (cuuint64_t)geo[5], (cuuint64_t)geo[6]};
  const cuuint32_t box[4] = {(cuuint32_t)geo[7], (cuuint32_t)geo[8], 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  CUtensorMap map, copy;
  auto enc = [&] {
    return encode(&map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, ptr, dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  if (enc() != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  double t0 = now_ns();
  for (int i = 0; i < iters; ++i) enc();
  out[0] = (now_ns() - t0) / iters;
  t0 = now_ns();
  for (int i = 0; i < iters; ++i) {
    std::memcpy(&copy, &map, sizeof map);
    replace(&copy, ptr);
  }
  out[1] = (now_ns() - t0) / iters;
  t0 = now_ns();
  for (int i = 0; i < iters; ++i)
    cudaFuncSetAttribute(four_maps, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  out[2] = (now_ns() - t0) / iters;
  cudaFuncSetAttribute(six_maps, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  t0 = now_ns();
  for (int i = 0; i < iters; ++i)
    four_maps<<<1, 128, smem, s>>>(copy, copy, copy, copy, nullptr, 0, 1.f);
  out[3] = (now_ns() - t0) / iters;
  t0 = now_ns();
  for (int i = 0; i < iters; ++i)
    six_maps<<<1, 128, smem, s>>>(copy, copy, copy, copy, copy, copy, nullptr, 0, 1.f);
  out[4] = (now_ns() - t0) / iters;
  int dev = 0;
  t0 = now_ns();
  for (int i = 0; i < iters; ++i) cudaGetDevice(&dev);
  out[5] = (now_ns() - t0) / iters;
  return (int)cudaGetLastError();
}
