// Shared device helpers of the sam_audio_tpu_torch kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sa {

// jnp.finfo(float32).min: the masked-logit fill of the fused attention glue.
constexpr float kF32Min = -3.4028234663852886e38f;
// -0.7 * finfo(float32).max: the flash kernel's additive mask value.
constexpr float kFlashMask = (float)(-0.7 * 3.4028234663852886e38);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---- tensor-core helpers (mma.sync m16n8k16, bf16 in, fp32 accumulate) ----
// Fragment layouts, with g = lane / 4 and q = lane % 4:
//   A (16x16, row-major): a0 (row g, k 2q..2q+1), a1 (row g+8, same k),
//                         a2 (row g, k 2q+8..), a3 (row g+8, k 2q+8..)
//   B (16x8, k-major):    b0 (k 2q..2q+1, col g), b1 (k 2q+8.., col g)
//   C/D (16x8, fp32):     d0, d1 (row g, cols 2q, 2q+1), d2, d3 (row g+8)
// A 32-bit register holds two bf16, the lower index in the low half.

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragment (b0, b1) of a 16(k) x 8(n) tile stored row-major by k in shared
// memory (n contiguous): row_ptr is this lane's row, k = lane % 16, of the
// tile; ldmatrix .trans hands each lane its (k 2q..2q+1, n g) pairs.
__device__ __forceinline__ void ldmatrix_b_trans(uint32_t (&b)[2],
                                                 const __nv_bfloat16* row_ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row_ptr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(addr));
}

// Rows r0 .. r0+rows-1 of a (rows, D) bf16 matrix with the given row stride
// into shared memory (row stride LD), 16 bytes per load; rows at or past
// `limit` become zeros. Rows in device memory must start 16-byte aligned.
template <int D, int LD, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t row_stride, int r0, int rows, int limit) {
  for (int e = threadIdx.x; e < rows * D / 8; e += NTHREADS) {
    const int r = e / (D / 8), c8 = (e % (D / 8)) * 8, t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < limit) val = *reinterpret_cast<const uint4*>(src + (size_t)t * row_stride + c8);
    *reinterpret_cast<uint4*>(dst + r * LD + c8) = val;
  }
}

// Sets the dynamic shared-memory limit, launches, and reports the first error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, block, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace sa
