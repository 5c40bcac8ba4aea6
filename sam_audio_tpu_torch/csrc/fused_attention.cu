// Fused short-sequence self-attention of the DiT: per (batch, head)
//   q' = rope_half(rmsnorm(q)), k' = rope_half(rmsnorm(k))   (fp32, then cast
//   back to the activation dtype)
//   out = softmax(q' k'^T / sqrt(D), masked keys = finfo(f32).min) . v
// Replaces sam_audio_tpu/ops/fused_attention.py::fused_glue_attention (_kernel).
//
// Semantics kept from the TPU kernel: T is treated as padded to a multiple of
// 128 with masked, zero-valued keys (so a fully masked row averages V over
// the padded length); the softmax is normalised before p is rounded to the
// activation dtype for the second product; products accumulate in fp32.
//
// Design: a block owns a tile of query rows of one (batch, head); it
// normalises and rotates them into shared memory, then streams K in 64-row
// tiles (normalised and rotated on load) and V in 64-row tiles. K and V are
// streamed because at T = 512 a head's K and V (256 KB in bf16) exceed the
// 227 KB a block may hold. Scores never reach device memory. D = 128.
//   bf16: 64 query rows, 4 warps of 16 rows. The block loads q and every
//         key with 16-byte loads, normalises and rotates them in shared memory
//         (k' for all T_pad <= 512 keys stays there, 139 KB at 512), then
//         makes two passes over the keys on the tensor cores (mma.sync
//         m16n8k16, fp32 accumulators): the first finds each row's max and
//         sum, the second recomputes the scores, normalises p, rounds it to
//         bf16 straight into the A operand of P . V (V streamed in 64-row
//         tiles, its operand through ldmatrix.trans) and accumulates the
//         output in registers.
//   fp32: 16 query rows, 256 threads; the rows' fp32 scores for every key
//         stay in shared memory (16 x T_pad, 32 KB at T = 512) for one exact
//         softmax; fp32 FMA products.

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int QT = 16;        // query rows per block
constexpr int KT = 64;        // keys per streamed tile
constexpr int THREADS = 256;  // 8 warps
constexpr int LD = D + 1;     // padded shared-memory row stride (floats)

// One warp normalises and rotates one row of D values; lane l holds columns
// l, l+32 (first half) and their rotary partners l+64, l+96.
__device__ __forceinline__ void norm_rope_row(const float* __restrict__ src,
                                              const float* __restrict__ w,
                                              const float* __restrict__ cs,
                                              const float* __restrict__ sn,
                                              float eps, float* dst) {
  const int lane = threadIdx.x & 31;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = src[lane + 32 * i];
  float ss = x[0] * x[0] + x[1] * x[1] + x[2] * x[2] + x[3] * x[3];
  ss = sa::warp_sum(ss);
  const float r = rsqrtf(ss / D + eps);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = x[i] * r * w[lane + 32 * i];
  const float c0 = cs[lane], s0 = sn[lane], c1 = cs[lane + 32], s1 = sn[lane + 32];
  dst[lane] = x[0] * c0 - x[2] * s0;
  dst[lane + 64] = x[0] * s0 + x[2] * c0;
  dst[lane + 32] = x[1] * c1 - x[3] * s1;
  dst[lane + 96] = x[1] * s1 + x[3] * c1;
}

__device__ __forceinline__ void zero_row(float* dst) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 4; ++i) dst[lane + 32 * i] = 0.f;
}

__global__ void __launch_bounds__(THREADS)
fused_glue_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ qw,
                            const float* __restrict__ kw, const float* __restrict__ cs,
                            const float* __restrict__ sn,
                            const uint8_t* __restrict__ mask, float* __restrict__ out,
                            int Tn, int H, int t_pad, float eps, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;            // QT x LD
  float* KVs = Qs + QT * LD;   // KT x LD
  float* S = KVs + KT * LD;    // QT x t_pad

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t row_stride = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;
  const uint8_t* mrow = mask + (size_t)b * Tn;

  for (int r = warp; r < QT; r += THREADS / 32) {
    const int t = q0 + r;
    if (t < Tn)
      norm_rope_row(q + base + t * row_stride, qw, cs + (size_t)t * (D / 2),
                       sn + (size_t)t * (D / 2), eps, Qs + r * LD);
    else
      zero_row(Qs + r * LD);
  }

  // scores: thread -> key j of the tile, query rows 4*rg .. 4*rg+3
  const int j = threadIdx.x % KT, rg = threadIdx.x / KT;
  for (int k0 = 0; k0 < t_pad; k0 += KT) {
    __syncthreads();
    for (int r = warp; r < KT; r += THREADS / 32) {
      const int t = k0 + r;
      if (t < Tn)
        norm_rope_row(k + base + t * row_stride, kw, cs + (size_t)t * (D / 2),
                         sn + (size_t)t * (D / 2), eps, KVs + r * LD);
      else
        zero_row(KVs + r * LD);
    }
    __syncthreads();
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kv = KVs[j * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(Qs[(rg * 4 + i) * LD + d], kv, acc[i]);
    }
    const int key = k0 + j;
    const bool valid = key < Tn && mrow[key] != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      S[(rg * 4 + i) * t_pad + key] = valid ? acc[i] * scale : sa::kF32Min;
  }
  __syncthreads();

  // row softmax (one warp per row); p is normalised, then rounded to T
  for (int r = warp; r < QT; r += THREADS / 32) {
    float* row = S + r * t_pad;
    float m = -INFINITY;
    for (int c = lane; c < t_pad; c += 32) m = fmaxf(m, row[c]);
    m = sa::warp_max(m);
    float s = 0.f;
    for (int c = lane; c < t_pad; c += 32) {
      const float e = expf(row[c] - m);
      row[c] = e;
      s += e;
    }
    s = sa::warp_sum(s);
    for (int c = lane; c < t_pad; c += 32) row[c] /= s;
  }

  // out rows 2*warp, 2*warp+1; columns lane + 32*i
  const int r0 = warp * 2;
  float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int k0 = 0; k0 < t_pad; k0 += KT) {
    __syncthreads();
    for (int e = threadIdx.x; e < KT * D; e += THREADS) {
      const int r = e / D, c = e % D, t = k0 + r;
      KVs[r * LD + c] = t < Tn ? v[base + t * row_stride + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < KT; ++jj) {
      const float p0 = S[r0 * t_pad + k0 + jj], p1 = S[(r0 + 1) * t_pad + k0 + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float vv = KVs[jj * LD + lane + 32 * i];
        o[0][i] = fmaf(p0, vv, o[0][i]);
        o[1][i] = fmaf(p1, vv, o[1][i]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = q0 + r0 + rr;
    if (t < Tn) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[base + t * row_stride + lane + 32 * i] = o[rr][i];
    }
  }
}


// ---------------------------------------------------------------- bf16 path

using bf16 = __nv_bfloat16;
constexpr int NW = 4;               // warps per block, 16 query rows each
constexpr int MQ = 16 * NW;
constexpr int MTHREADS = 32 * NW;
constexpr int LDK = D + 8;          // bf16 row stride of the Q, K and V tiles

__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&x)[8]) {
  return make_uint4(sa::pack_bf16(x[0], x[1]), sa::pack_bf16(x[2], x[3]),
                    sa::pack_bf16(x[4], x[5]), sa::pack_bf16(x[6], x[7]));
}

// Rows 0 .. rows-1 of a bf16 tile in shared memory, RMS-normalised and
// rotated in place; row r is sequence position t0 + r, and rows at or past
// `limit` become zeros. Eight lanes share a row (8 channels of the first
// half each, with their rotary partners), so a warp does four rows at once
// and every load is 16 bytes wide.
__device__ void norm_rope_tile(bf16* tile, int rows, int t0, int limit,
                               const float* __restrict__ w, const float* __restrict__ cs,
                               const float* __restrict__ sn, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane >> 3, c0 = (lane & 7) * 8;
  float w1[8], w2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w1[i] = w[c0 + i];
    w2[i] = w[D / 2 + c0 + i];
  }
  for (int rb = warp * 4; rb < rows; rb += NW * 4) {
    const int r = rb + sub, t = t0 + r;
    const bool valid = r < rows && t < limit;
    float x1[8] = {}, x2[8] = {}, c[8] = {}, s[8] = {};
    if (valid) {
      const float4* cp = reinterpret_cast<const float4*>(cs + (size_t)t * (D / 2) + c0);
      const float4* sp = reinterpret_cast<const float4*>(sn + (size_t)t * (D / 2) + c0);
      const float4 ca = cp[0], cb = cp[1], sa_ = sp[0], sb = sp[1];
      c[0] = ca.x; c[1] = ca.y; c[2] = ca.z; c[3] = ca.w;
      c[4] = cb.x; c[5] = cb.y; c[6] = cb.z; c[7] = cb.w;
      s[0] = sa_.x; s[1] = sa_.y; s[2] = sa_.z; s[3] = sa_.w;
      s[4] = sb.x; s[5] = sb.y; s[6] = sb.z; s[7] = sb.w;
      unpack8(*reinterpret_cast<const uint4*>(tile + r * LDK + c0), x1);
      unpack8(*reinterpret_cast<const uint4*>(tile + r * LDK + D / 2 + c0), x2);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += x1[i] * x1[i] + x2[i] * x2[i];
    ss += __shfl_xor_sync(0xffffffffu, ss, 1);
    ss += __shfl_xor_sync(0xffffffffu, ss, 2);
    ss += __shfl_xor_sync(0xffffffffu, ss, 4);
    const float rr = rsqrtf(ss / D + eps);
    float o1[8], o2[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = x1[i] * rr * w1[i], b = x2[i] * rr * w2[i];
      o1[i] = a * c[i] - b * s[i];
      o2[i] = a * s[i] + b * c[i];
    }
    if (r < rows) {
      *reinterpret_cast<uint4*>(tile + r * LDK + c0) = pack8(o1);
      *reinterpret_cast<uint4*>(tile + r * LDK + D / 2 + c0) = pack8(o2);
    }
  }
}

// this warp's 16 x KT scores against the KT keys at Ks: scaled, with masked
// keys (and keys past T) set to finfo(f32).min
__device__ __forceinline__ void tile_scores(float (&s)[KT / 8][4],
                                            const uint32_t (&qa)[D / 16][4], const bf16* Ks,
                                            int k0, int Tn, const uint8_t* __restrict__ mrow,
                                            float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* kp = Ks + (nt * 8 + g) * LDK + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t bk[2] = {sa::ld32(kp + ks * 16), sa::ld32(kp + ks * 16 + 8)};
      sa::mma_bf16(s[nt], qa[ks], bk);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + 2 * tq + (e & 1);
      s[nt][e] = (key < Tn && mrow[key] != 0) ? s[nt][e] * scale : sa::kF32Min;
    }
  }
}

__global__ void __launch_bounds__(MTHREADS)
fused_glue_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const float* __restrict__ qw,
                                const float* __restrict__ kw, const float* __restrict__ cs,
                                const float* __restrict__ sn,
                                const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                int Tn, int H, int t_pad, float eps, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // t_pad x LDK: k' of every key
  bf16* Qs = Ks + (size_t)t_pad * LDK;           // MQ x LDK: this block's q'
  bf16* Vs = Qs + MQ * LDK;                      // KT x LDK: streamed V tile

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * MQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const size_t row_stride = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;
  const uint8_t* mrow = mask + (size_t)b * Tn;

  sa::load_rows<D, LDK, MTHREADS>(Qs, q + base, row_stride, q0, MQ, Tn);
  sa::load_rows<D, LDK, MTHREADS>(Ks, k + base, row_stride, 0, t_pad, Tn);
  __syncthreads();
  norm_rope_tile(Qs, MQ, q0, Tn, qw, cs, sn, eps);
  norm_rope_tile(Ks, t_pad, 0, Tn, kw, cs, sn, eps);
  __syncthreads();
  uint32_t qa[D / 16][4];
  {
    const bf16* qp = Qs + (warp * 16 + g) * LDK + 2 * tq;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      qa[ks][0] = sa::ld32(qp + ks * 16);
      qa[ks][1] = sa::ld32(qp + 8 * LDK + ks * 16);
      qa[ks][2] = sa::ld32(qp + ks * 16 + 8);
      qa[ks][3] = sa::ld32(qp + 8 * LDK + ks * 16 + 8);
    }
  }

  // pass 1: each row's max and sum of exp(s - max)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  float s[KT / 8][4];
  for (int k0 = 0; k0 < t_pad; k0 += KT) {
    tile_scores(s, qa, Ks + (size_t)k0 * LDK, k0, Tn, mrow, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m_r[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt)
        sum += expf(s[nt][2 * r] - m_next) + expf(s[nt][2 * r + 1] - m_next);
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_r[r] = l_r[r] * expf(m_r[r] - m_next) + sum;
      m_r[r] = m_next;
    }
  }

  // pass 2: p = exp(s - max) / sum, rounded to bf16, times V
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  for (int k0 = 0; k0 < t_pad; k0 += KT) {
    __syncthreads();
    sa::load_rows<D, LDK, MTHREADS>(Vs, v + base, row_stride, k0, KT, Tn);
    __syncthreads();
    tile_scores(s, qa, Ks + (size_t)k0 * LDK, k0, Tn, mrow, scale);
    uint32_t pa[KT / 16][4];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const float p0 = expf(s[nt][0] - m_r[0]) / l_r[0];
      const float p1 = expf(s[nt][1] - m_r[0]) / l_r[0];
      const float p2 = expf(s[nt][2] - m_r[1]) / l_r[1];
      const float p3 = expf(s[nt][3] - m_r[1]) / l_r[1];
      pa[nt / 2][(nt & 1) * 2] = sa::pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = sa::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const bf16* vrow = Vs + (kk * 16 + (lane & 15)) * LDK;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        uint32_t bv[2];
        sa::ldmatrix_b_trans(bv, vrow + dt * 8);
        sa::mma_bf16(o[dt], pa[kk], bv);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Tn) continue;
    bf16* orow = out + base + (size_t)t * row_stride + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) = sa::pack_bf16(o[dt][2 * r], o[dt][2 * r + 1]);
  }
}

int launch_fp32(const void* q, const void* k, const void* v, const float* qw,
                const float* kw, const float* cs, const float* sn, const uint8_t* mask,
                void* out, int B, int Tn, int H, float eps, float scale,
                cudaStream_t stream) {
  const int t_pad = (Tn + 127) / 128 * 128;
  const size_t smem = sizeof(float) * ((size_t)QT * LD + (size_t)KT * LD + (size_t)QT * t_pad);
  dim3 grid((Tn + QT - 1) / QT, B * H);
  return sa::launch(fused_glue_attention_kernel, grid, dim3(THREADS), smem, stream,
                    (const float*)q, (const float*)k, (const float*)v, qw, kw, cs, sn, mask,
                    (float*)out, Tn, H, t_pad, eps, scale);
}

}  // namespace

// q, k, v, out: (B, T, H, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// qw, kw: (D,) float32; cs, sn: (T, D/2) float32; mask: (B, T) uint8.
// D must be 128 and T <= 512 (the fp32 path keeps 16 rows' scores in shared
// memory). In bf16, q/k/v rows and cos/sin rows must start 16-byte aligned.
extern "C" int sa_fused_glue_attention(const void* q, const void* k, const void* v,
                                       const float* qw, const float* kw,
                                       const float* cs, const float* sn,
                                       const uint8_t* mask, void* out, int B, int T,
                                       int H, int Dh, float eps, float scale,
                                       int dtype, void* stream) {
  if (Dh != D || T > 512 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    const int t_pad = (T + 127) / 128 * 128;
    const size_t smem = sizeof(bf16) * (size_t)(t_pad + MQ + KT) * LDK;
    dim3 grid((T + MQ - 1) / MQ, B * H);
    return sa::launch(fused_glue_attention_mma_kernel, grid, dim3(MTHREADS), smem, s,
                      (const bf16*)q, (const bf16*)k, (const bf16*)v, qw, kw, cs, sn, mask,
                      (bf16*)out, T, H, t_pad, eps, scale);
  }
  return launch_fp32(q, k, v, qw, kw, cs, sn, mask, out, B, T, H, eps, scale, s);
}
