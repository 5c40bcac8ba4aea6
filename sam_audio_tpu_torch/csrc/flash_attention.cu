// Forward flash attention with a key-padding mask, (B, S, H, D) layout.
// Replaces sam_audio_tpu/ops/flash_attention.py::flash_attention
// (_flash_padded / _flash_kernel).
//
// Semantics kept from the TPU kernel: s = q.k * scale + (1 - mask) * (-0.7 *
// f32max); online softmax with running max m, running sum l and accumulator
// in fp32; p = exp(s - m) is rounded to the value dtype before the product
// with V, l sums the unrounded p; out = acc / l (l == 0 guarded). Keys are
// treated as padded to a multiple of 128 with masked zero keys, as the TPU
// kernel's block padding does, so a fully masked row averages V over the
// padded length.
//
// Design: one block per (batch*head, 64-query tile); an inner loop streams
// 64-key tiles of K and V through shared memory. D = 128.
//   bf16: 4 warps, each owning 16 query rows. Q . K^T and P . V run on the
//         tensor cores (mma.sync m16n8k16, fp32 accumulators); the scores,
//         the running statistics and the 16x128 accumulator stay in
//         registers, and P goes from the score accumulators straight into
//         the A operand of P . V (rounded to bf16 there, as the TPU kernel
//         rounds p). V's operand comes through ldmatrix.trans.
//   fp32: 256 threads; each keeps a 4x4 block of scores and an 8-row x
//         4-column block of the accumulator in registers; fp32 FMA products.

#include "common.cuh"

namespace {

constexpr int D = 128;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LD = D + 1;
constexpr int LS = BK + 1;

__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const uint8_t* __restrict__ mask,
                       float* __restrict__ out, int Sq, int Sk, int H, int sk_pad,
                       float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;              // BQ x LD
  float* KVs = Qs + BQ * LD;     // BK x LD
  float* S = KVs + BK * LD;      // BQ x LS
  float* m_s = S + BQ * LS;      // BQ
  float* l_s = m_s + BQ;         // BQ
  float* a_s = l_s + BQ;         // BQ

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const size_t row_stride = (size_t)H * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D;
  const size_t kbase = ((size_t)b * Sk * H + h) * D;
  const uint8_t* mrow = mask + (size_t)b * Sk;

  for (int e = threadIdx.x; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e % D, t = q0 + r;
    Qs[r * LD + c] = t < Sq ? q[qbase + t * row_stride + c] : 0.f;
  }
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.f;
  }

  // score block: rows 4*rg + i, keys kg + 16*jj
  const int kg = threadIdx.x % 16, rg = threadIdx.x / 16;
  // softmax: 4 threads per row, 16 keys each
  const int srow = threadIdx.x / 4, ssub = threadIdx.x % 4;
  // accumulator block: rows 8*ag + r, columns dg + 32*i
  const int dg = threadIdx.x % 32, ag = threadIdx.x / 32;
  float acc[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[r][i] = 0.f;

  for (int k0 = 0; k0 < sk_pad; k0 += BK) {
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, t = k0 + r;
      KVs[r * LD + c] = t < Sk ? k[kbase + t * row_stride + c] : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kv[jj] = KVs[(kg + 16 * jj) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) s[i][jj] = fmaf(qv[i], kv[jj], s[i][jj]);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int key = k0 + kg + 16 * jj;
      const bool valid = key < Sk && mrow[key] != 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[i][jj] * scale;
        if (!valid) x += sa::kFlashMask;
        S[(rg * 4 + i) * LS + kg + 16 * jj] = x;
      }
    }
    __syncthreads();

    {  // online softmax statistics of row srow
      float* row = S + srow * LS + ssub * 16;
      const float m_prev = m_s[srow];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_next = fmaxf(m_prev, mx);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_next);
        psum += p;
        row[c] = p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (ssub == 0) {
        const float alpha = expf(m_prev - m_next);
        a_s[srow] = alpha;
        l_s[srow] = alpha * l_s[srow] + psum;
        m_s[srow] = m_next;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < BK * D; e += THREADS) {
      const int r = e / D, c = e % D, t = k0 + r;
      KVs[r * LD + c] = t < Sk ? v[kbase + t * row_stride + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float alpha = a_s[ag * 8 + r];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[r][i] *= alpha;
    }
#pragma unroll 2
    for (int jj = 0; jj < BK; ++jj) {
      float vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) vv[i] = KVs[jj * LD + dg + 32 * i];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = S[(ag * 8 + r) * LS + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = ag * 8 + r, t = q0 + row;
    if (t < Sq) {
      const float l = l_s[row];
      const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        out[qbase + t * row_stride + dg + 32 * i] = acc[r][i] * l_inv;
    }
  }
}


// ---------------------------------------------------------------- bf16 path

constexpr int MQ = 64;          // query rows per block: 4 warps x 16
constexpr int MK = 64;          // keys per tile
constexpr int MTHREADS = 128;
constexpr int LDK = D + 8;      // bf16 row stride of the Q, K and V tiles

using bf16 = __nv_bfloat16;

__global__ void __launch_bounds__(MTHREADS)
flash_attention_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                           bf16* __restrict__ out, int Sq, int Sk, int H, int sk_pad,
                           float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // MQ x LDK
  bf16* Ks = Qs + MQ * LDK;                      // MK x LDK
  bf16* Vs = Ks + MK * LDK;                      // MK x LDK

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * MQ;
  const size_t row_stride = (size_t)H * D;
  const size_t qbase = ((size_t)b * Sq * H + h) * D;
  const size_t kbase = ((size_t)b * Sk * H + h) * D;
  const uint8_t* mrow = mask + (size_t)b * Sk;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;

  sa::load_rows<D, LDK, MTHREADS>(Qs, q + qbase, row_stride, q0, MQ, Sq);
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
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < sk_pad; k0 += MK) {
    __syncthreads();
    sa::load_rows<D, LDK, MTHREADS>(Ks, k + kbase, row_stride, k0, MK, Sk);
    sa::load_rows<D, LDK, MTHREADS>(Vs, v + kbase, row_stride, k0, MK, Sk);
    __syncthreads();

    float s[MK / 8][4];
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kp = Ks + (nt * 8 + g) * LDK + 2 * tq;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t bk[2] = {sa::ld32(kp + ks * 16), sa::ld32(kp + ks * 16 + 8)};
        sa::mma_bf16(s[nt], qa[ks], bk);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        float x = s[nt][e] * scale;
        if (!(key < Sk && mrow[key] != 0)) x += sa::kFlashMask;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], m_next[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      m_next[r] = fmaxf(m_r[r], mx[r]);
      alpha[r] = expf(m_r[r] - m_next[r]);
      m_r[r] = m_next[r];
    }
    // p = exp(s - m): summed unrounded into l, rounded to bf16 as P . V's A
    uint32_t pa[MK / 16][4];
#pragma unroll
    for (int nt = 0; nt < MK / 8; ++nt) {
      const float p0 = expf(s[nt][0] - m_next[0]), p1 = expf(s[nt][1] - m_next[0]);
      const float p2 = expf(s[nt][2] - m_next[1]), p3 = expf(s[nt][3] - m_next[1]);
      psum[0] += p0 + p1;
      psum[1] += p2 + p3;
      pa[nt / 2][(nt & 1) * 2] = sa::pack_bf16(p0, p1);
      pa[nt / 2][(nt & 1) * 2 + 1] = sa::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_r[r] = alpha[r] * l_r[r] + psum[r];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < MK / 16; ++kk) {
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
    if (t >= Sq) continue;
    const float l_inv = l_r[r] == 0.f ? 1.f : 1.f / l_r[r];
    bf16* orow = out + qbase + (size_t)t * row_stride + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          sa::pack_bf16(o[dt][2 * r] * l_inv, o[dt][2 * r + 1] * l_inv);
  }
}

int launch_fp32(const void* q, const void* k, const void* v, const uint8_t* mask,
                void* out, int B, int Sq, int Sk, int H, float scale,
                cudaStream_t stream) {
  const int sk_pad = (Sk + 127) / 128 * 128;
  const size_t smem =
      sizeof(float) * ((size_t)BQ * LD + (size_t)BK * LD + (size_t)BQ * LS + 3 * BQ);
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  return sa::launch(flash_attention_kernel, grid, dim3(THREADS), smem, stream,
                    (const float*)q, (const float*)k, (const float*)v, mask, (float*)out, Sq, Sk, H,
                    sk_pad, scale);
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); all contiguous, dtype 0 =
// float32, 1 = bfloat16; mask: (B, Sk) uint8 (1 = attend). D must be 128;
// bf16 rows must start 16-byte aligned.
extern "C" int sa_flash_attention(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, int B, int Sq,
                                  int Sk, int H, int Dh, float scale, int dtype,
                                  void* stream) {
  if (Dh != D || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    const size_t smem = sizeof(bf16) * (size_t)(MQ + 2 * MK) * LDK;
    dim3 grid((Sq + MQ - 1) / MQ, B * H);
    return sa::launch(flash_attention_mma_kernel, grid, dim3(MTHREADS), smem, s,
                      (const bf16*)q, (const bf16*)k, (const bf16*)v, mask, (bf16*)out, Sq,
                      Sk, H, (Sk + 127) / 128 * 128, scale);
  }
  return launch_fp32(q, k, v, mask, out, B, Sq, Sk, H, scale, s);
}
