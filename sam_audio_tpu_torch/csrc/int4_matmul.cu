// y = x . dequant(w4)^T with packed int4 weights and per-(out, group) scales:
//   w4: (half, K) uint8; byte (p, i) holds weight row p in its low nibble and
//       row p + half in its high nibble, both sign-extended values in [-7, 7];
//   scale: (2*half, G) fp32, one per (output row, group of K/G inputs);
//   y[t, o] = sum_g scale[o, g] * (sum_{i in group g} x[t, i] * q[o, i])
// Each group's partial dot is taken in fp32 and multiplied by its scale
// before it is added, and the result is rounded once to x's dtype (no bias).
// Replaces sam_audio_tpu/ops/int4_matmul.py::matmul_int4 (`_kernel`).
//
// Design: a block owns BM tokens x BN packed rows, so one read of the packed
// tile feeds both output planes (rows p..p+BN and half+p..half+p+BN). It walks
// the contraction axis in chunks of KC columns (KC divides the group):
//   bf16: the x chunk and the packed bytes go to shared memory with 16-byte
//         cp.async copies, three chunks in flight; the nibbles are
//         sign-extended to bf16 in shared memory (a byte permute and one
//         bf16x2 subtraction per two values), and the products run on the
//         tensor cores (ldmatrix + mma.sync m16n8k16, fp32 accumulation) into
//         a per-group partial, which is scaled and added to the fp32
//         accumulator at each group's end.
//   fp32: the same tiling with FMA products, each thread a 4-token x
//         (4 low + 4 high)-column register block.
// Masked loads (zero fill) replace the TPU kernel's padding of the tokens to
// 8, so any token count runs. What bounds it on the H100: at the DiT's shapes
// and 250 tokens, 2*M*K*N operations on the tensor cores (near the ridge);
// only cross-attention's k/v projections at ~14 tokens are bound by the
// weight bytes. The kernel is far from that bound: a block walks all of K
// alone (the time grows with K and barely with the tokens), and the
// (2048, .) shapes fill 64 of the 132 SMs. Split-K, wgmma and TMA are later
// work.

#include <initializer_list>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int BM = 64;        // tokens per block
constexpr int BN = 64;        // packed rows per block (64 low + 64 high outputs)
constexpr int KC = 128;       // largest contraction chunk staged per step
constexpr int LDX = KC + 8;   // bf16 row stride of staged x and unpacked w
constexpr int LDP = KC;       // byte row stride of the staged packed tile
constexpr int STAGES = 3;     // bf16 path: chunks of x and packed bytes in flight
constexpr int LDXF = KC + 4;  // fp32 path: row stride of staged x
constexpr int LDN = BN + 4;   // fp32 path: row stride of the k-major unpacked w

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the sign-extended 4-bit value in bits [shift, shift + 4) of v
__device__ __forceinline__ float nibble(uint32_t v, int shift) {
  const int n = (int)((v >> shift) & 0xFu);
  return (float)((n ^ 8) - 8);
}

// The nibbles in bits 0-3 and 16-19 of v, sign-extended, as two bf16 (bits
// 0-3 in the low half). 0x4300 | (n ^ 8) is the bf16 of 128 + (n ^ 8), and
// subtracting 136 leaves (n ^ 8) - 8, the signed value, exactly.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  const uint32_t biased = ((v & 0x000F000Fu) ^ 0x00080008u) | 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---------------------------------------------------------------- bf16 path

// ldmatrix .x4: lane l gives the row address of matrix l / 8; each lane gets
// its (row l / 4, columns 2 * (l % 4) ..+1) pair of each of the four matrices
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* row) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 8 warps: warp (wm, wn) owns tokens wm*16 .. +15 and packed columns
// wn*32 .. +31 of the block, i.e. 4 n-tiles of 8 in each of the two planes.
// KCT, the staged chunk, is a template argument so that every index below is
// a shift or a constant and the product loop unrolls.
template <int KCT>
__global__ void __launch_bounds__(THREADS)
    int4_mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ w4,
                    const float* __restrict__ scale, bf16* __restrict__ out, int M, int K,
                    int half, int G, int gs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);                          // [STAGES][BM][LDX]
  uint8_t* ps = smem + STAGES * BM * LDX * sizeof(bf16);             // [STAGES][BN][LDP]
  bf16* ws = reinterpret_cast<bf16*>(ps + STAGES * BN * LDP);        // [2 planes][BN][LDX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int m0 = blockIdx.y * BM, p0 = blockIdx.x * BN;
  const int nchunks = K / KCT, cpg = gs / KCT;

  auto copy_chunk = [&](int c, int stage) {
    const int k0 = c * KCT;
    bf16* xd = xs + stage * BM * LDX;
    constexpr int XCPR = KCT / 8;  // 16-byte copies per x row
#pragma unroll
    for (int e = tid; e < BM * XCPR; e += THREADS) {
      const int r = e / XCPR, c8 = (e % XCPR) * 8;
      const bool ok = m0 + r < M;
      cp_async16(xd + r * LDX + c8, ok ? x + (size_t)(m0 + r) * K + k0 + c8 : x, ok);
    }
    uint8_t* pd = ps + stage * BN * LDP;
    constexpr int PCPR = KCT / 16;  // 16-byte copies per packed row
    for (int e = tid; e < BN * PCPR; e += THREADS) {
      const int r = e / PCPR, c16 = (e % PCPR) * 16;
      const bool ok = p0 + r < half;
      cp_async16(pd + r * LDP + c16, ok ? w4 + (size_t)(p0 + r) * K + k0 + c16 : w4, ok);
    }
    cp_async_commit();
  };

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[pl][j][e] = part[pl][j][e] = 0.f;

  // this lane's ldmatrix row addresses: A rows wm*16 + l % 16 at k + (l / 16) * 8;
  // B rows (packed columns) wn*32 + (l / 16) * 8 + l % 8 at k + ((l / 8) % 2) * 8
  const int a_off = (wm * 16 + (lane & 15)) * LDX + (lane >> 4) * 8;
  const int b_off = (wn * 32 + (lane >> 4) * 8 + (lane & 7)) * LDX + ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nchunks) copy_chunk(st, st);
    else cp_async_commit();  // an empty group keeps the group count uniform
  }
  for (int c = 0; c < nchunks; ++c) {
    const int stage = c % STAGES;
    // at a group's end, fetch its scales first: the copy wait, the
    // unpack and the products hide their latency
    const bool group_end = (c + 1) % cpg == 0;
    float sc[2][4][2];
    if (group_end) {
      const int gi = (c + 1) / cpg - 1;
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = p0 + wn * 32 + j * 8 + 2 * q + e;
            sc[pl][j][e] = col < half ? __ldg(scale + (size_t)(pl * half + col) * G + gi) : 0.f;
          }
    }

    cp_async_wait<STAGES - 2>();  // chunk c has landed
    // every thread has also finished chunk c - 1: its stage and the unpacked
    // planes may be rewritten
    __syncthreads();
    if (c + STAGES - 1 < nchunks) copy_chunk(c + STAGES - 1, (c + STAGES - 1) % STAGES);
    else cp_async_commit();

    // sign-extend both nibble planes of the packed chunk to bf16
    const uint8_t* pd = ps + stage * BN * LDP;
    constexpr int WPR = KCT / 4;
#pragma unroll
    for (int e = tid; e < BN * WPR; e += THREADS) {
      const int r = e / WPR, c4 = (e % WPR) * 4;
      const uint32_t v = *reinterpret_cast<const uint32_t*>(pd + r * LDP + c4);
      const uint32_t b01 = __byte_perm(v, 0u, 0x4140), b23 = __byte_perm(v, 0u, 0x4342);
      uint2 lo, hi;  // bytes 0, 1 | 2, 3 spread to the two 16-bit halves
      lo.x = nibbles_to_bf16x2(b01);
      lo.y = nibbles_to_bf16x2(b23);
      hi.x = nibbles_to_bf16x2(b01 >> 4);
      hi.y = nibbles_to_bf16x2(b23 >> 4);
      *reinterpret_cast<uint2*>(ws + r * LDX + c4) = lo;
      *reinterpret_cast<uint2*>(ws + BN * LDX + r * LDX + c4) = hi;
    }
    __syncthreads();

    const bf16* xa = xs + stage * BM * LDX;
#pragma unroll
    for (int kk = 0; kk < KCT; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, xa + a_off + kk);
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int j = 0; j < 4; j += 2) {  // n-tiles j and j + 1
          uint32_t b[4];
          ldmatrix_x4(b, ws + pl * BN * LDX + j * 8 * LDX + b_off + kk);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          sa::mma_bf16(part[pl][j], a, b0);
          sa::mma_bf16(part[pl][j + 1], a, b1);
        }
    }

    if (group_end) {  // acc += partial * scale
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            acc[pl][j][e] += part[pl][j][e] * sc[pl][j][e];
            acc[pl][j][e + 2] += part[pl][j][e + 2] * sc[pl][j][e];
            part[pl][j][e] = part[pl][j][e + 2] = 0.f;
          }
    }
  }

  const int n_out = 2 * half;
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = m0 + wm * 16 + g + 8 * h;
        if (t >= M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = p0 + wn * 32 + j * 8 + 2 * q + e;
          if (col < half)
            out[(size_t)t * n_out + pl * half + col] = __float2bfloat16(acc[pl][j][2 * h + e]);
        }
      }
}

size_t mma_smem_bytes() {
  return STAGES * (BM * LDX * sizeof(bf16) + BN * LDP) + 2 * BN * LDX * sizeof(bf16);
}

// ---------------------------------------------------------------- fp32 path

// thread (ty, tx) owns tokens ty*4 .. +3 and packed columns tx*4 .. +3 of the
// block, in both planes.
__global__ void __launch_bounds__(THREADS)
    int4_fma_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w4,
                    const float* __restrict__ scale, float* __restrict__ out, int M, int K,
                    int half, int G, int gs, int kc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [BM][LDXF]
  float* wt = xs + BM * LDXF;                  // [2 planes][KC][LDN], k-major
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * BM, p0 = blockIdx.x * BN;
  const int nchunks = K / kc, cpg = gs / kc;

  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[pl][i][j] = part[pl][i][j] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const int k0 = c * kc;
    const int xq = kc / 4;
    for (int e = tid; e < BM * xq; e += THREADS) {
      const int r = e / xq, c4 = (e % xq) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M) v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + k0 + c4);
      *reinterpret_cast<float4*>(xs + r * LDXF + c4) = v;
    }
    const int pq = kc / 16;
    for (int e = tid; e < BN * pq; e += THREADS) {
      const int r = e / pq, c16 = (e % pq) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + r < half) v = *reinterpret_cast<const uint4*>(w4 + (size_t)(p0 + r) * K + k0 + c16);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi)
#pragma unroll
        for (int bi = 0; bi < 4; ++bi) {
          const int k = c16 + wi * 4 + bi;
          wt[k * LDN + r] = nibble(words[wi], 8 * bi);
          wt[(KC + k) * LDN + r] = nibble(words[wi], 8 * bi + 4);
        }
    }
    __syncthreads();

    for (int k = 0; k < kc; ++k) {
      float xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[(ty * 4 + i) * LDXF + k];
      const float4 wl = *reinterpret_cast<const float4*>(wt + k * LDN + tx * 4);
      const float4 wh = *reinterpret_cast<const float4*>(wt + (KC + k) * LDN + tx * 4);
      const float wv[2][4] = {{wl.x, wl.y, wl.z, wl.w}, {wh.x, wh.y, wh.z, wh.w}};
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[pl][i][j] = fmaf(xv[i], wv[pl][j], part[pl][i][j]);
    }

    if ((c + 1) % cpg == 0) {
      const int gi = (c + 1) / cpg - 1;
#pragma unroll
      for (int pl = 0; pl < 2; ++pl)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = p0 + tx * 4 + j;
          const float s = col < half ? __ldg(scale + (size_t)(pl * half + col) * G + gi) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[pl][i][j] += part[pl][i][j] * s;
            part[pl][i][j] = 0.f;
          }
        }
    }
    __syncthreads();
  }

  const int n_out = 2 * half;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = m0 + ty * 4 + i;
    if (t >= M) continue;
#pragma unroll
    for (int pl = 0; pl < 2; ++pl)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = p0 + tx * 4 + j;
        if (col < half) out[(size_t)t * n_out + pl * half + col] = acc[pl][i][j];
      }
  }
}

size_t fma_smem_bytes() { return sizeof(float) * ((size_t)BM * LDXF + 2 * (size_t)KC * LDN); }

// the largest staged chunk that divides the group
int pick_chunk(int gs) {
  for (int kc : {128, 64, 32, 16})
    if (gs % kc == 0) return kc;
  return 0;
}

}  // namespace

// x: (M, K) in the compute dtype (0 = float32, 1 = bfloat16), 16-byte aligned;
// w4: (half, K) uint8, 16-byte aligned; scale: (2*half, G) float32;
// out: (M, 2*half) in x's dtype. K/G (the group) must be a multiple of 16.
extern "C" int sa_matmul_int4(const void* x, const uint8_t* w4, const float* scale, void* out,
                              int M, int K, int half, int G, int dtype, void* stream) {
  if (M < 1 || half < 1 || G < 1 || K % G != 0) return (int)cudaErrorInvalidValue;
  const int gs = K / G;
  const int kc = pick_chunk(gs);
  if (kc == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((half + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    auto run = [&](auto kernel) {
      return sa::launch(kernel, grid, dim3(THREADS), mma_smem_bytes(), s, (const bf16*)x, w4,
                        scale, (bf16*)out, M, K, half, G, gs);
    };
    switch (kc) {
      case 128: return run(int4_mma_kernel<128>);
      case 64: return run(int4_mma_kernel<64>);
      case 32: return run(int4_mma_kernel<32>);
      default: return run(int4_mma_kernel<16>);
    }
  }
  return sa::launch(int4_fma_kernel, grid, dim3(THREADS), fma_smem_bytes(), s, (const float*)x,
                    w4, scale, (float*)out, M, K, half, G, gs, kc);
}
