// Split-TF32 ("3xTF32") helpers of the fp32 kernel bodies (sm_90a).
//
// TF32 keeps 10 explicit mantissa bits: one product in TF32 is off by up to
// ~2^-11 relative, too coarse for the fp32 bodies' 1e-4 contract. Each fp32
// operand is split into two TF32 values, x = hi + lo with hi = rna(x) (to
// nearest, ties away from zero: cvt.rna.tf32.f32's rounding) and lo the TF32
// part of x - hi (|x - hi - lo| <= 2^-21 |x| for normal x), and a product is
// taken as
//   a . b ~ a_hi . b_hi + a_hi . b_lo + a_lo . b_hi
// in three tensor-core products accumulated in fp32; the dropped a_lo . b_lo
// is ~2^-21 of each term. The precision is fixed here, by design: nothing
// reads torch.backends.cuda.matmul.allow_tf32 or cudnn.allow_tf32.
// ops/fused_conv.py::split_tf32 splits the weights on the host the same way,
// lo also rounded to nearest (2^-22).
#pragma once

#include <stdint.h>

namespace sa {

// x rounded to TF32 (round to nearest, ties away from zero), as its fp32
// bits: what cvt.rna.tf32.f32 gives for every finite x below TF32's largest,
// in two integer operations (a conversion is a 16-a-clock instruction, and
// the attention body splits ~300 K values a block)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo: hi = rna(x) in TF32 and lo = x - hi exactly, whose low 13
// mantissa bits a TF32 product does not read; the part it reads is lo to
// within 2^-10 of itself, so hi + lo as the tensor cores see it is x within
// 2^-21 |x| (normal x). Three operations: the split runs once per operand
// element and fragment load.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8, row) . b (8 x 8, col), TF32 in, fp32 accumulate. For
// lane l of the warp with g = l / 4, q = l % 4:
//   a0 (row g, k q), a1 (row g + 8, k q), a2 (row g, k q + 4), a3 (row g + 8, k q + 4)
//   b0 (k q, col g), b1 (k q + 4, col g)
//   d0, d1 (row g, cols 2q, 2q + 1), d2, d3 (row g + 8, the same cols)
// (Not volatile: the compiler may interleave independent products.)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += a . b[n] in 3xTF32 for N independent tiles n (b[n] = {b0, b1},
// split): the two small terms first, then hi . hi, each pass over every n so
// that no product waits on the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (&d)[N][4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], const uint32_t (&b_hi)[N][2],
                                           const uint32_t (&b_lo)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_lo, b_hi[n][0], b_hi[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_hi, b_lo[n][0], b_lo[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_hi, b_hi[n][0], b_hi[n][1]);
}

// The warpgroup products with TF32 operands (wgmma m64nNk8; both operands in
// shared memory and K-major, the only form PTX allows for TF32). A k step is
// 8 TF32 values = 32 bytes of a row, the same bytes as a bf16 k16 step, so
// the descriptors of sm90.cuh apply as they are.
// d (64 x 32, fp32) = a (64 x 8, shared, K-major) . b (32 x 8, shared, K-major)
// (+ d when accumulate is nonzero)
__device__ __forceinline__ void wgmma_m64n32k8_tf32(float (&d)[16], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = a (64 x 8, shared, K-major) . b (64 x 8, shared, K-major)
// (+ d when accumulate is nonzero)
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 96, fp32) = a (64 x 8, shared, K-major) . b (96 x 8, shared, K-major)
// (+ d when accumulate is nonzero)
__device__ __forceinline__ void wgmma_m64n96k8_tf32(float (&d)[48], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = a (64 x 8, shared, K-major) . b (128 x 8, shared, K-major)
// (+ d when accumulate is nonzero)
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

}  // namespace sa
