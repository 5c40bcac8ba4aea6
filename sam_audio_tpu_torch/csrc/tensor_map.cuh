// Host side of TMA: tensor maps for contiguous tensors, encoded by libcuda
// and kept by (pointer, shape, box).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace sa {

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime the libraries
// link, so it is looked up in the libcuda the process has already loaded.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The map of a contiguous tensor of `rank` (2 to 4) dimensions, innermost
// first in `dims`, read in boxes of `box` elements with the 128-byte swizzle
// (so box[0] * elem_bytes must be 128) and zero fill outside the tensor.
// Encoding costs host time on every launch, so the last few maps are kept.
// Returns 0 or a cudaError_t.
inline int tensor_map(const void* ptr, CUtensorMapDataType type, int elem_bytes, int rank,
                      const uint64_t (&dims)[4], const uint32_t (&box)[4], CUtensorMap* out) {
  struct Key {
    const void* ptr;
    int type, rank;
    uint64_t dims[4];
    uint32_t box[4];
  };
  constexpr int SLOTS = 32;
  static std::mutex lock;
  static Key keys[SLOTS];
  static CUtensorMap maps[SLOTS];
  static int used = 0, next = 0;
  Key key;
  memset(&key, 0, sizeof(key));  // padding too: keys are compared as bytes
  key.ptr = ptr;
  key.type = (int)type;
  key.rank = rank;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
  }
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof(Key)) == 0) {
      *out = maps[i];
      return 0;
    }
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  cuuint64_t gdims[4], strides[3];
  cuuint32_t gbox[4], elem[4];
  cuuint64_t stride = (cuuint64_t)elem_bytes;
  for (int i = 0; i < rank; ++i) {
    gdims[i] = dims[i];
    gbox[i] = box[i];
    elem[i] = 1;
    stride *= dims[i];
    if (i + 1 < rank) strides[i] = stride;  // bytes between steps of dimension i + 1
  }
  CUtensorMap map;
  const CUresult res =
      encode(&map, type, (cuuint32_t)rank, const_cast<void*>(ptr), gdims, strides, gbox, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  keys[next] = key;
  maps[next] = map;
  next = (next + 1) % SLOTS;
  if (used < SLOTS) ++used;
  *out = map;
  return 0;
}

}  // namespace sa
