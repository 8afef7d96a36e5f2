// Host side of the flash kernels' TMA loads and stores (flash_fwd.cu,
// flash_bwd.cu): the 4-D tensor map of one bf16 or f32 operand from the
// geometry that ops/attention.py::_tma_geometry computes, the cache that
// encodes each map once per geometry, dtype and device and afterwards only
// gives a copy its new address, the kernels' shared-memory attribute set
// once per kernel and device, and the message of a refused map.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <set>
#include <unordered_map>
#include <utility>

namespace dfdt {

// cuTensorMapEncodeTiled, looked up in libcuda by the runtime's entry-point
// query (so the library links against the CUDA runtime alone); null where
// libcuda has none.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapReplaceAddress, looked up likewise
using ReplaceAddress = CUresult (*)(CUtensorMap*, void*);

inline void* driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? p : nullptr;
}

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(driver_entry("cuTensorMapEncodeTiled"));
  return fn;
}

inline ReplaceAddress replace_address() {
  static const ReplaceAddress fn =
      reinterpret_cast<ReplaceAddress>(driver_entry("cuTensorMapReplaceAddress"));
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

// What a flash launch reuses from the calls before it: each operand's tensor
// map by its geometry (the 9 values of encode_map), dtype and device, and
// the kernels whose dynamic shared memory attribute is set on a device (the
// attribute belongs to the device's context). One lock: serving replicas
// launch from a thread a card, and ctypes lets them run at once. At most
// kMaxMaps maps; past that the maps are dropped and encoded again as met.
class LaunchCache {
 public:
  static constexpr size_t kMaxMaps = 1024;

  // maps[i]: the tensor map of operand i (its data at ptrs[i], its geometry
  // at geo + 9 i, boxes of rows[i] rows) of a (B, H, N, d) call on the
  // current device: encoded on the first call with that geometry, dtype and
  // device, afterwards a copy of it given the new address. 0 or a status.
  int maps(CUtensorMap* maps, const void* const* ptrs, const long long* geo, const int* rows,
           int n, int d, int N, int H, int B, bool f32) {
    const ReplaceAddress replace = replace_address();
    if (replace == nullptr) return (int)cudaErrorSymbolNotFound;
    const int cols = f32 ? 32 : 64;
    for (int i = 0; i < n; ++i) {
      const long long* g = geo + 9 * i;
      if (g[0] != d || g[1] != N || g[2] != H || g[3] != B || g[7] != cols || g[8] != rows[i])
        return (int)cudaErrorInvalidValue;
    }
    int device = 0;
    const cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    {
      std::lock_guard<std::mutex> lock(mu_);
      for (int i = 0; i < n; ++i) {
        Key key{};
        std::memcpy(key.geo, geo + 9 * i, sizeof key.geo);
        key.f32 = f32;
        key.device = device;
        auto it = maps_.find(key);
        if (it == maps_.end()) {
          CUtensorMap map;
          const int err = encode_map(&map, ptrs[i], geo + 9 * i, d, N, H, B, rows[i], f32);
          if (err) return err;
          if (maps_.size() >= kMaxMaps) maps_.clear();
          it = maps_.emplace(key, map).first;
        }
        maps[i] = it->second;
      }
    }
    for (int i = 0; i < n; ++i) {
      const CUresult r = replace(&maps[i], const_cast<void*>(ptrs[i]));
      if (r != CUDA_SUCCESS) return kTmaErrorBase + (int)r;
    }
    return 0;
  }

  // cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) on the
  // current device, the first time this kernel launches there
  int smem_attribute(const void* kernel, int bytes) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return (int)e;
    std::lock_guard<std::mutex> lock(mu_);
    if (attributed_.count({kernel, device})) return 0;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess) attributed_.insert({kernel, device});
    return (int)e;
  }

  // forget every map and attribute (the tests' check that a cleared cache
  // gives the same results)
  void clear() {
    std::lock_guard<std::mutex> lock(mu_);
    maps_.clear();
    attributed_.clear();
  }

 private:
  struct Key {
    long long geo[9];
    int f32, device;
    bool operator==(const Key& o) const { return std::memcmp(this, &o, sizeof(Key)) == 0; }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      size_t h = 1469598103934665603ull;  // FNV-1a over the key's words
      for (long long g : k.geo) h = (h ^ (size_t)g) * 1099511628211ull;
      return ((h ^ (size_t)k.f32) * 1099511628211ull ^ (size_t)k.device) * 1099511628211ull;
    }
  };
  std::mutex mu_;
  std::unordered_map<Key, CUtensorMap, KeyHash> maps_;
  std::set<std::pair<const void*, int>> attributed_;
};

// this library's cache (each flash library holds its own)
inline LaunchCache& launch_cache() {
  static LaunchCache cache;
  return cache;
}

// the message of a status a flash entry returned: a cudaError_t, or a
// refused tensor map
inline const char* error_string(int code) {
  if (code >= kTmaErrorBase) {
    static thread_local char msg[128];
    snprintf(msg, sizeof msg,
             "cuTensorMapEncodeTiled or cuTensorMapReplaceAddress refused a tensor map "
             "(CUresult %d)",
             code - kTmaErrorBase);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace dfdt
