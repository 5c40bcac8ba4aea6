// One whole DAC residual unit per (batch, time tile), (B, C, T) layout:
//   s1 = snake(x, a1)                        rounded to the compute dtype
//   h  = b7 + sum_j W7[j] . s1[t + j*dil - 3*dil]   (dilated k=7 conv, fp32 sum,
//                                            zero padding at the sequence edges)
//   s2 = snake(round(h), a2)                 rounded to the compute dtype
//   out = W1 . s2 + b1 + x                   (fp32, then rounded)
// Replaces sam_audio_tpu/ops/fused_conv.py::fused_residual_unit
// (_fused_res_unit_padded / _res_unit_kernel). In bf16 the snake uses the
// same range-reduced polynomial sin^2 as the TPU kernel; in fp32, sinf.
//
// Design: an implicit-GEMM convolution. A block owns one time tile of TT
// outputs and every channel: it writes s1 for the tile plus its 2*3*dil halo
// into shared memory once, runs the 7 shifted products as one GEMM of
// K = 7*C (weights staged through shared memory in 32-deep slices), keeps h
// in shared memory, applies the second snake in place and runs the 1x1
// product the same way, adding the bias and the residual in the epilogue.
// x is read and out written once. The host picks the largest tile whose
// buffers fit the 227 KB a block may use.
//   bf16: tensor-core products (mma.sync m16n8k16, fp32 accumulators); s1 and
//         h are stored time-major (channel contiguous), so each operand
//         fragment is a 32-bit shared-memory load. Tiles 64 or 32.
//   fp32: fp32 FMA products, each thread a 4-channel x TT/16-time register
//         block. Tiles 64, 32 or 16.

#include <initializer_list>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int KC = 32;        // reduction slice staged per step
constexpr int CO = 64;        // output channels per pass
constexpr int LA = CO + 1;    // fp32 path: padded stride of the staged slice
constexpr int LDA = KC + 8;   // bf16 path: padded stride of a staged weight row
constexpr int KSIZE = 7;
constexpr double kTwoPi = 6.283185307179586;
constexpr size_t kMaxSmem = 232448;  // 227 KB per block

// cos(sqrt(u)) on [0, pi^2] (sam_audio_tpu/ops/conv.py _COS_POLY)
__device__ __forceinline__ float sin2_fast(float z) {
  const float z2 = 2.0f * z;
  const float r = z2 - (float)kTwoPi * rintf(z2 * (float)(1.0 / kTwoPi));
  const float u = r * r;
  float acc = 1.7243750503357124e-09f;
  acc = acc * u + -2.7075446763970063e-07f;
  acc = acc * u + 2.4769052460238803e-05f;
  acc = acc * u + -0.0013887731716129153f;
  acc = acc * u + 0.041666462324917386f;
  acc = acc * u + -0.49999985125182195f;
  acc = acc * u + 0.9999999738700588f;
  return 0.5f * (1.0f - acc);
}

template <bool FAST>
__device__ __forceinline__ float snake(float x, float a) {
  float s;
  if constexpr (FAST) {
    s = sin2_fast(a * x);
  } else {
    const float v = sinf(a * x);
    s = v * v;
  }
  return x + (1.0f / (a + 1e-9f)) * s;
}

// ---------------------------------------------------------------- bf16 path

// acc += W(co, k) . B(k, n) over k < kdim for the block's 64-channel pass
// starting at co0. W(co, k) = w[co * w_ld + k] (device memory, staged through
// As); B(k, n) = bT[n * b_ld + k] (shared memory, k contiguous). 8 warps:
// warp (wm, wn) owns channels wm*32 .. +31 and columns wn*8*NI .. +8*NI-1.
template <int NI>
__device__ __forceinline__ void mma_gemm(const bf16* __restrict__ w, int w_ld, int kdim,
                                         const bf16* bT, int b_ld, int co0, int C,
                                         bf16* As, float (&acc)[2][NI][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < CO * KC / 2; e += THREADS) {
      const int row = e / (KC / 2), pair = e % (KC / 2), co = co0 + row;
      const uint32_t v = co < C ? sa::ld32(w + (size_t)co * w_ld + k0 + 2 * pair) : 0u;
      *reinterpret_cast<uint32_t*>(As + row * LDA + 2 * pair) = v;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t a[2][4], b[NI][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* ap = As + (wm * 32 + mi * 16 + g) * LDA + ks + 2 * tq;
        a[mi][0] = sa::ld32(ap);
        a[mi][1] = sa::ld32(ap + 8 * LDA);
        a[mi][2] = sa::ld32(ap + 8);
        a[mi][3] = sa::ld32(ap + 8 * LDA + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const bf16* bp = bT + (size_t)(wn * 8 * NI + ni * 8 + g) * b_ld + k0 + ks + 2 * tq;
        b[ni][0] = sa::ld32(bp);
        b[ni][1] = sa::ld32(bp + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) sa::mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
  }
}

template <int TT>
__global__ void __launch_bounds__(THREADS)
res_unit_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w7,
                    const float* __restrict__ b7, const bf16* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ a1,
                    const float* __restrict__ a2, bf16* __restrict__ out, int C, int Tn,
                    int dil) {
  constexpr int NI = TT / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo = 3 * dil, ls = TT + 2 * halo, ld = C + 8;
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // CO x LDA
  bf16* S1T = As + CO * LDA;                     // ls x ld: s1, time-major
  bf16* HT = S1T + (size_t)ls * ld;              // TT x ld: h then s2, time-major

  const int t0 = blockIdx.x * TT;
  const bf16* xb = x + (size_t)blockIdx.y * C * Tn;
  bf16* ob = out + (size_t)blockIdx.y * C * Tn;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = warp / 4, wn = warp % 4;

  for (int e = threadIdx.x; e < C * ls; e += THREADS) {
    const int c = e / ls, u = e % ls, t = t0 - halo + u;
    float s = 0.f;  // zero padding outside the sequence (snake(0) = 0)
    if (t >= 0 && t < Tn) s = snake<true>(sa::to_f(xb[(size_t)c * Tn + t]), a1[c]);
    S1T[u * ld + c] = sa::from_f<bf16>(s);
  }

  // dilated k=7 conv: tap j reads s1 shifted by j*dil time rows
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[2][NI][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r0 = co0 + wm * 32 + mi * 16 + g, r1 = r0 + 8;
      const float lo = r0 < C ? b7[r0] : 0.f, hi = r1 < C ? b7[r1] : 0.f;
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        acc[mi][ni][0] = acc[mi][ni][1] = lo;
        acc[mi][ni][2] = acc[mi][ni][3] = hi;
      }
    }
    for (int j = 0; j < KSIZE; ++j)
      mma_gemm<NI>(w7 + (size_t)j * C * C, C, C, S1T + (size_t)j * dil * ld, ld, co0, C,
                   As, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = co0 + wm * 32 + mi * 16 + g + (q >> 1) * 8;
          const int n = wn * 8 * NI + ni * 8 + 2 * tq + (q & 1);
          if (co < C) HT[n * ld + co] = sa::from_f<bf16>(acc[mi][ni][q]);
        }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < TT * C; e += THREADS) {
    const int n = e / C, c = e % C;
    HT[n * ld + c] = sa::from_f<bf16>(snake<true>(sa::to_f(HT[n * ld + c]), a2[c]));
  }

  // 1x1 conv + bias + residual
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[2][NI][4] = {};
    mma_gemm<NI>(w1, C, C, HT, ld, co0, C, As, acc);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = co0 + wm * 32 + mi * 16 + g + (q >> 1) * 8;
          const int t = t0 + wn * 8 * NI + ni * 8 + 2 * tq + (q & 1);
          if (co < C && t < Tn) {
            const size_t idx = (size_t)co * Tn + t;
            ob[idx] = sa::from_f<bf16>(acc[mi][ni][q] + b1[co] + sa::to_f(xb[idx]));
          }
        }
  }
}

size_t mma_smem_bytes(int C, int TT, int dil) {
  return sizeof(bf16) * ((size_t)CO * LDA + (size_t)(2 * TT + 6 * dil) * (C + 8));
}

// ---------------------------------------------------------------- fp32 path

// acc[r][i] += sum_k W[co0 + 4*cg + r][k] * B[k][tg + 16*i] over k < kdim,
// where W(co, k) = w[co * w_ld + k] and B(k, t) = bsrc[k * b_ld + t].
template <int TR>
__device__ __forceinline__ void fma_gemm(const float* __restrict__ w, int w_ld, int kdim,
                                         const float* bsrc, int b_ld, int co0, int C,
                                         float* As, float (&acc)[4][TR]) {
  const int tg = threadIdx.x % 16, cg = threadIdx.x / 16;
  for (int k0 = 0; k0 < kdim; k0 += KC) {
    __syncthreads();
    for (int e = threadIdx.x; e < KC * CO; e += THREADS) {
      const int kk = e % KC, col = e / KC, co = co0 + col;
      As[kk * LA + col] = co < C ? w[(size_t)co * w_ld + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float a[4], bv[TR];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[kk * LA + cg * 4 + r];
      const float* brow = bsrc + (size_t)(k0 + kk) * b_ld + tg;
#pragma unroll
      for (int i = 0; i < TR; ++i) bv[i] = brow[16 * i];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int i = 0; i < TR; ++i) acc[r][i] = fmaf(a[r], bv[i], acc[r][i]);
    }
  }
}

template <int TT>
__global__ void __launch_bounds__(THREADS)
res_unit_fma_kernel(const float* __restrict__ x, const float* __restrict__ w7,
                    const float* __restrict__ b7, const float* __restrict__ w1,
                    const float* __restrict__ b1, const float* __restrict__ a1,
                    const float* __restrict__ a2, float* __restrict__ out, int C, int Tn,
                    int dil) {
  constexpr int TR = TT / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int halo = 3 * dil;
  const int ls = TT + 2 * halo;
  float* As = reinterpret_cast<float*>(smem_raw);  // KC x LA
  float* S1 = As + KC * LA;                        // C x ls
  float* Hs = S1 + (size_t)C * ls;                 // C x TT

  const int t0 = blockIdx.x * TT;
  const float* xb = x + (size_t)blockIdx.y * C * Tn;
  float* ob = out + (size_t)blockIdx.y * C * Tn;
  const int tg = threadIdx.x % 16, cg = threadIdx.x / 16;

  for (int e = threadIdx.x; e < C * ls; e += THREADS) {
    const int c = e / ls, u = e % ls, t = t0 - halo + u;
    S1[e] = (t >= 0 && t < Tn) ? snake<false>(xb[(size_t)c * Tn + t], a1[c]) : 0.f;
  }

  // dilated k=7 conv: W7 is (7, C, C); tap j reads S1 shifted by j*dil
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[4][TR];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int co = co0 + cg * 4 + r;
      const float bias = co < C ? b7[co] : 0.f;
#pragma unroll
      for (int i = 0; i < TR; ++i) acc[r][i] = bias;
    }
    for (int j = 0; j < KSIZE; ++j)
      fma_gemm<TR>(w7 + (size_t)j * C * C, C, C, S1 + j * dil, ls, co0, C, As, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int co = co0 + cg * 4 + r;
      if (co < C) {
#pragma unroll
        for (int i = 0; i < TR; ++i) Hs[co * TT + tg + 16 * i] = acc[r][i];
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < C * TT; e += THREADS) Hs[e] = snake<false>(Hs[e], a2[e / TT]);

  // 1x1 conv + bias + residual
  for (int co0 = 0; co0 < C; co0 += CO) {
    float acc[4][TR] = {};
    fma_gemm<TR>(w1, C, C, Hs, TT, co0, C, As, acc);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int co = co0 + cg * 4 + r;
      if (co >= C) continue;
#pragma unroll
      for (int i = 0; i < TR; ++i) {
        const int t = t0 + tg + 16 * i;
        if (t < Tn) {
          const size_t idx = (size_t)co * Tn + t;
          ob[idx] = acc[r][i] + b1[co] + xb[idx];
        }
      }
    }
  }
}

size_t fma_smem_bytes(int C, int TT, int dil) {
  return sizeof(float) * ((size_t)KC * LA + (size_t)C * (2 * TT + 6 * dil));
}

// ---------------------------------------------------------------- host side

int pick_tile(int C, int dil, int dtype) {
  if (dtype == 1) {
    for (int tt : {64, 32})
      if (mma_smem_bytes(C, tt, dil) <= kMaxSmem) return tt;
    return 0;
  }
  for (int tt : {64, 32, 16})
    if (fma_smem_bytes(C, tt, dil) <= kMaxSmem) return tt;
  return 0;
}

template <typename Kernel, typename T>
int launch_tile(Kernel kernel, size_t smem, int TT, const void* x, const void* w7,
                const float* b7, const void* w1, const float* b1, const float* a1,
                const float* a2, void* out, int B, int C, int Tn, int dil,
                cudaStream_t stream) {
  dim3 grid((Tn + TT - 1) / TT, B);
  return sa::launch(kernel, grid, dim3(THREADS), smem, stream, (const T*)x, (const T*)w7,
                    b7, (const T*)w1, b1, a1, a2, (T*)out, C, Tn, dil);
}

}  // namespace

// Time tile the kernel takes for (C, dilation, dtype), 0 if none fits.
extern "C" int sa_res_unit_tile(int C, int dil, int dtype) { return pick_tile(C, dil, dtype); }

// x, out: (B, C, T) contiguous; w7: (7, C_out, C_in); w1: (C_out, C_in), all in
// the compute dtype (0 = float32, 1 = bfloat16); b7, b1, a1, a2: (C,)
// float32. C must be a multiple of 32.
extern "C" int sa_fused_residual_unit(const void* x, const void* w7, const float* b7,
                                      const void* w1, const float* b1, const float* a1,
                                      const float* a2, void* out, int B, int C, int T,
                                      int dil, int dtype, void* stream) {
  if (C % KC != 0 || T < 1 || dil < 1) return (int)cudaErrorInvalidValue;
  const int tt = pick_tile(C, dil, dtype);
  if (tt == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    const size_t smem = mma_smem_bytes(C, tt, dil);
    if (tt == 64)
      return launch_tile<decltype(&res_unit_mma_kernel<64>), bf16>(
          res_unit_mma_kernel<64>, smem, 64, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
    return launch_tile<decltype(&res_unit_mma_kernel<32>), bf16>(
        res_unit_mma_kernel<32>, smem, 32, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
  }
  const size_t smem = fma_smem_bytes(C, tt, dil);
  if (tt == 64)
    return launch_tile<decltype(&res_unit_fma_kernel<64>), float>(
        res_unit_fma_kernel<64>, smem, 64, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
  if (tt == 32)
    return launch_tile<decltype(&res_unit_fma_kernel<32>), float>(
        res_unit_fma_kernel<32>, smem, 32, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
  return launch_tile<decltype(&res_unit_fma_kernel<16>), float>(
      res_unit_fma_kernel<16>, smem, 16, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
}
