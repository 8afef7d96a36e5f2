// Host side of the flash kernels' TMA loads and stores (flash_fwd.cu,
// flash_bwd.cu): the 4-D tensor map of one bf16 or f32 operand from the
// geometry that ops/attention.py::_tma_geometry computes, and the message of
// a refused map.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace dfdt {

// cuTensorMapEncodeTiled, looked up in libcuda by the runtime's entry-point
// query (so the library links against the CUDA runtime alone); null where
// libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A CUresult of cuTensorMapEncodeTiled comes back to the caller as this plus
// the code (error_string names it).
constexpr int kTmaErrorBase = 100000;

// The 4-D tensor map of one bf16 (or, with f32, f32) operand from the
// wrapper's geometry (ops/attention.py::_tma_geometry): dims (d, N, H, B),
// the byte strides of N, H and B, and the box (one 128-byte row: 64 bf16 or
// 32 f32 columns; `rows`), which must be the kernel's. 128-byte swizzle: the
// layout wgmma reads (wgmma_tma.cuh).
inline int encode_map(CUtensorMap* map, const void* ptr, const long long* geo, int d, int N,
                      int H, int B, int rows, bool f32 = false) {
  const int cols = f32 ? 32 : 64;
  if (geo[0] != d || geo[1] != N || geo[2] != H || geo[3] != B || geo[7] != cols ||
      geo[8] != rows)
    return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)geo[0], (cuuint64_t)geo[1], (cuuint64_t)geo[2],
                              (cuuint64_t)geo[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)geo[4], (cuuint64_t)geo[5], (cuuint64_t)geo[6]};
  const cuuint32_t box[4] = {(cuuint32_t)cols, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(map,
                            f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                            4, const_cast<void*>(ptr),
                            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTmaErrorBase + (int)r;
}

// the message of a status a flash entry returned: a cudaError_t, or a
// refused tensor map
inline const char* error_string(int code) {
  if (code >= kTmaErrorBase) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled refused the tensor map (CUresult %d)",
             code - kTmaErrorBase);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace dfdt
