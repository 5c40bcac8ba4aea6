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
// What bounds it on the H100 at the main shape (1, 250, 16, 128) bf16: q, k,
// v and out, 4.1 MB (1.2 us at 3.35 TB/s), against 0.52 GFLOP (0.5 us at 989
// TFLOP/s): bytes, and below them the latency of one short pass.
//
// Design, bf16 (the path that carries the launches): one block per (64 query
// rows, batch * head) with four warpgroups; warpgroup w owns keys
// [w t_pad / 4, (w + 1) t_pad / 4) of the padded length t_pad <= 512.
//   Copies:   TMA (a 4-D tensor map over (B, T, H, D), boxes of 32 rows x 64
//             columns, 128-byte swizzle; rows past T arrive as zeros). One
//             thread fetches Q; each warpgroup fetches only its own K and V,
//             V landing while Q and K are normalised.
//   Norm:     each warpgroup normalises and rotates 16 of the 64 query rows
//             and all of its own keys in place (eight lanes a row, 16-byte
//             pieces), so no key is normalised twice in a block.
//   Products: q' k'^T is wgmma m64n32k16 (both operands in shared memory);
//             the scores stay in registers and are computed once. p . v is
//             wgmma m64n128k16 with p as the register operand and V read as
//             it lies (the transposed-B form).
//   Softmax:  one pass. Each warpgroup finds its rows' max and sum over its
//             keys in base 2 (one ex2 a score); the warpgroups trade them
//             through shared memory at one barrier and scale their p by
//             2^(m_w - m) / l, so p is normalised before it is rounded.
//   Output:   the four fp32 partial outputs meet in shared memory (where K
//             and V were) and each warpgroup sums and stores 32 columns.
//   At t_pad <= 256 K and V have places of their own; at 384 and 512 a
//   warpgroup's V lands on its K once its scores are done.
//   fp32: the same 64 query rows a tile, its keys split over a cluster of
//         two blocks (one half each, each key normalised once a tile), and
//         both products on the tensor cores in split TF32 ("3xTF32",
//         tf32.cuh): every operand is x = hi + lo in TF32 and a product is
//         hi.hi + hi.lo + lo.hi (mma.sync m16n8k8, fp32 accumulation; the
//         dropped lo.lo is ~2^-21 of a term), which holds the plain
//         version's 1e-4 where one TF32 product (~2^-11) would not. The
//         precision is the design's: the kernel reads neither
//         torch.backends.cuda.matmul.allow_tf32 nor cudnn.allow_tf32. Bound
//         at (1, 250, 16, 128): 3 x 0.52 GFLOP of TF32 products, 3.1 us at
//         495 TFLOP/s (7.6 us as fp32 FMAs), 8.2 MB (2.4 us). See
//         fused_glue_attention_tf32_kernel.

#include "common.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"
#include "tf32.cuh"

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int D = 128;

// ---------------------------------------------------------------- bf16 path

using bf16 = __nv_bfloat16;
constexpr int GROUPS = 4;                     // warpgroups; each owns a quarter of the keys
constexpr int MQ = 64;                        // query rows per block (one wgmma M)
constexpr int WTHREADS = 128 * GROUPS;
constexpr int Q_HALF = MQ * 128;              // 64 rows x 64 columns, swizzled
constexpr int REGION_BYTES = 128 * 1024;      // K and V, later the partial outputs
constexpr float LOG2E = 1.4426950408889634f;

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

// Row r (sequence position t) of a swizzled two-half tile at `tile` (halves
// `half_bytes` apart), RMS-normalised and rotated in place. Eight lanes share
// a row: lane l % 8 holds the 16-byte piece l % 8 of each half (8 channels of
// the first half and their rotary partners). Lanes whose row is past the
// sequence (`valid` false) take part in the shuffles and store nothing.
__device__ __forceinline__ void norm_rope_tile_row(unsigned char* tile, int half_bytes, int r,
                                                   int t, bool valid, const float (&w1)[8],
                                                   const float (&w2)[8],
                                                   const float* __restrict__ cs,
                                                   const float* __restrict__ sn, float eps) {
  const int c8 = threadIdx.x & 7;
  uint4* p1 = reinterpret_cast<uint4*>(tile + r * 128 + ((c8 ^ (r & 7)) << 4));
  uint4* p2 = reinterpret_cast<uint4*>(reinterpret_cast<unsigned char*>(p1) + half_bytes);
  float x1[8] = {}, x2[8] = {}, c[8] = {}, s[8] = {};
  if (valid) {
    unpack8(*p1, x1);
    unpack8(*p2, x2);
    const float4* cp = reinterpret_cast<const float4*>(cs + (size_t)t * (D / 2) + c8 * 8);
    const float4* sp = reinterpret_cast<const float4*>(sn + (size_t)t * (D / 2) + c8 * 8);
    const float4 ca = cp[0], cb = cp[1], sa_ = sp[0], sb = sp[1];
    c[0] = ca.x; c[1] = ca.y; c[2] = ca.z; c[3] = ca.w;
    c[4] = cb.x; c[5] = cb.y; c[6] = cb.z; c[7] = cb.w;
    s[0] = sa_.x; s[1] = sa_.y; s[2] = sa_.z; s[3] = sa_.w;
    s[4] = sb.x; s[5] = sb.y; s[6] = sb.z; s[7] = sb.w;
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
  if (valid) {
    *p1 = pack8(o1);
    *p2 = pack8(o2);
  }
}

__device__ __forceinline__ void load_norm_weights(const float* __restrict__ w, float (&w1)[8],
                                                  float (&w2)[8]) {
  const int c8 = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w1[i] = w[c8 * 8 + i];
    w2[i] = w[D / 2 + c8 * 8 + i];
  }
}

// KW = keys a warpgroup owns = t_pad / 4 (32, 64, 96 or 128).
template <int KW>
__global__ void __launch_bounds__(WTHREADS, 1)
fused_glue_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                                  const __grid_constant__ CUtensorMap map_k,
                                  const __grid_constant__ CUtensorMap map_v,
                                  const float* __restrict__ qw, const float* __restrict__ kw,
                                  const float* __restrict__ cs, const float* __restrict__ sn,
                                  const uint8_t* __restrict__ mask, bf16* __restrict__ out,
                                  int Tn, int H, float eps, float scale_log2) {
  constexpr int NSUB = KW / 32;      // 32-key blocks of scores
  constexpr int CHUNK = KW * 128;    // one 64-column half of the group's K (or V) rows
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + 2 * GROUPS];  // Q; per group: its K, its V
  __shared__ float red_m[GROUPS][MQ], red_l[GROUPS][MQ];
  // the swizzled tiles need 1024-byte alignment
  const uint32_t raw = sa::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* base_p = smem_raw + (base - raw);
  const uint32_t q_s = base, region = base + 2 * Q_HALF;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp >> 2, wl = warp & 3, tg = threadIdx.x & 127;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * MQ;
  const int key0 = group * KW;
  // V has its own place while K and V fit the region together (t_pad <= 256);
  // past that, each group's V lands on its own K once its scores are done
  constexpr bool v_apart = 2 * GROUPS * 2 * CHUNK <= REGION_BYTES;
  const uint32_t k_s = region + group * 2 * CHUNK;
  const uint32_t v_s = v_apart ? region + GROUPS * 2 * CHUNK + group * 2 * CHUNK : k_s;
  const uint32_t q_full = sa::smem_u32(&bars[0]);
  const uint32_t k_full = sa::smem_u32(&bars[1 + group]);
  const uint32_t v_full = sa::smem_u32(&bars[1 + GROUPS + group]);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + 2 * GROUPS; ++i) sa::mbar_init(sa::smem_u32(&bars[i]), 1);
    sa::mbar_init_fence();
  }
  __syncthreads();

  // copies: 32-row boxes, two 64-column halves each; rows past T arrive as zeros
  auto load_rows = [&](uint32_t dst, int half_bytes, const CUtensorMap* map, uint32_t bar,
                       int row0, int rows) {
    for (int r = 0; r < rows; r += 32)
      for (int hf = 0; hf < 2; ++hf)
        sa::tma_load_4d(dst + hf * half_bytes + r * 128, map, bar, 64 * hf, h, row0 + r, b);
  };
  if (threadIdx.x == 0) {
    sa::mbar_arrive_expect_tx(q_full, 2 * Q_HALF);
    load_rows(q_s, Q_HALF, &map_q, q_full, q0, MQ);
  }
  if (tg == 0) {
    sa::mbar_arrive_expect_tx(k_full, 2 * CHUNK);
    load_rows(k_s, CHUNK, &map_k, k_full, key0, KW);
    if (v_apart) {
      sa::mbar_arrive_expect_tx(v_full, 2 * CHUNK);
      load_rows(v_s, CHUNK, &map_v, v_full, key0, KW);
    }
  }

  // which of the group's keys are attended: bit 8 j + 2 tq + e of word n is
  // key key0 + 32 n + 8 j + 2 tq + e (keys past T are masked)
  uint32_t bits[NSUB];
  const uint8_t* mrow = mask ? mask + (size_t)b * Tn : nullptr;
#pragma unroll
  for (int n = 0; n < NSUB; ++n) {
    const int key = key0 + 32 * n + lane;
    bits[n] = __ballot_sync(0xffffffffu, key < Tn && (mrow == nullptr || mrow[key] != 0)) >>
              (2 * tq);
  }

  // q' for rows 16 group .. + 15, then k' for the group's keys, in place
  {
    float w1[8], w2[8];
    load_norm_weights(qw, w1, w2);
    const int sub = 4 * wl + (lane >> 3);
    const int r = 16 * group + sub, t = q0 + r;
    sa::mbar_wait(q_full, 0);
    norm_rope_tile_row(base_p, Q_HALF, r, t, t < Tn, w1, w2, cs, sn, eps);
    load_norm_weights(kw, w1, w2);
    unsigned char* k_p = base_p + (k_s - base);
    sa::mbar_wait(k_full, 0);
#pragma unroll
    for (int r0 = 0; r0 < KW; r0 += 16) {
      const int tk = key0 + r0 + sub;
      norm_rope_tile_row(k_p, CHUNK, r0 + sub, tk, tk < Tn, w1, w2, cs, sn, eps);
    }
  }
  sa::fence_proxy_async();  // the normalised rows are wgmma operands
  __syncthreads();

  // s = q' . k'^T for the group's keys: 64 x KW scores in registers
  float s[NSUB][16];
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) s[n][i] = 0.f;
#pragma unroll
  for (int n = 0; n < NSUB; ++n) sa::pin_regs(s[n]);
  sa::wgmma_fence();
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks & 3) * 32;
      const uint64_t a = sa::wgmma_desc(q_s + (ks >> 2) * Q_HALF + off, 16, 1024);
      const uint64_t bk = sa::wgmma_desc(k_s + (ks >> 2) * CHUNK + n * 32 * 128 + off, 16, 1024);
      sa::wgmma_m64n32k16_ss(s[n], a, bk, ks > 0);
    }
  sa::wgmma_commit();
  sa::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NSUB; ++n) sa::pin_regs(s[n]);

  if (!v_apart) {  // the group's K is read: its V may land there
    sa::named_barrier(1 + group, 128);
    if (tg == 0) {
      sa::mbar_arrive_expect_tx(v_full, 2 * CHUNK);
      load_rows(v_s, CHUNK, &map_v, v_full, key0, KW);
    }
  }

  // Softmax in base 2: x = s * scale * log2(e); a masked key takes
  // finfo(f32).min itself, unscaled (scaled, it would overflow to -inf and a
  // fully masked row would give NaN). Each group finds its rows' max m_g and
  // sum l_g of 2^(x - m_g) over its keys; the groups trade them once, and
  // p = 2^(x - m_g) * 2^(m_g - m) / l with the row's max m and sum l: one
  // exponential a score and p normalised before it is rounded.
  float m_loc[2] = {-INFINITY, -INFINITY}, l_loc[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const bool ok = (bits[n] >> (8 * (i >> 2) + (i & 1))) & 1u;
      const float x = ok ? s[n][i] * scale_log2 : sa::kF32Min;
      s[n][i] = x;
      m_loc[(i >> 1) & 1] = fmaxf(m_loc[(i >> 1) & 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_loc[r] = fmaxf(m_loc[r], __shfl_xor_sync(0xffffffffu, m_loc[r], 1));
    m_loc[r] = fmaxf(m_loc[r], __shfl_xor_sync(0xffffffffu, m_loc[r], 2));
  }
#pragma unroll
  for (int n = 0; n < NSUB; ++n)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[n][i] = sa::ex2(s[n][i] - m_loc[(i >> 1) & 1]);
      l_loc[(i >> 1) & 1] += s[n][i];
    }
  const int row0 = 16 * wl + g;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_loc[r] += __shfl_xor_sync(0xffffffffu, l_loc[r], 1);
    l_loc[r] += __shfl_xor_sync(0xffffffffu, l_loc[r], 2);
    if (tq == 0) {
      red_m[group][row0 + 8 * r] = m_loc[r];
      red_l[group][row0 + 8 * r] = l_loc[r];
    }
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float m = red_m[0][row0 + 8 * r];
#pragma unroll
    for (int gr = 1; gr < GROUPS; ++gr) m = fmaxf(m, red_m[gr][row0 + 8 * r]);
    float l = 0.f;
#pragma unroll
    for (int gr = 0; gr < GROUPS; ++gr)
      l += red_l[gr][row0 + 8 * r] * sa::ex2(red_m[gr][row0 + 8 * r] - m);
    f[r] = sa::ex2(m_loc[r] - m) / l;
  }
  // p rounded to bf16 as the A fragments of p . v: 8-key block nt is
  // s[nt / 4][4 (nt % 4) + e]
  uint32_t pa[KW / 16][4];
#pragma unroll
  for (int nt = 0; nt < KW / 8; ++nt) {
    const float* sp = &s[nt / 4][4 * (nt % 4)];
    pa[nt / 2][(nt & 1) * 2] = sa::pack_bf16(sp[0] * f[0], sp[1] * f[0]);
    pa[nt / 2][(nt & 1) * 2 + 1] = sa::pack_bf16(sp[2] * f[1], sp[3] * f[1]);
  }

  // o = p . v over the group's keys: V read as it lies (keys down, D
  // across), the transposed-B form
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  sa::mbar_wait(v_full, 0);
  sa::pin_regs(o);
  sa::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk)
    sa::wgmma_m64n128k16_rs_bt(o, pa[kk], sa::wgmma_desc(v_s + kk * 16 * 128, CHUNK, 1024),
                               kk > 0);
  sa::wgmma_commit();
  sa::wgmma_wait<0>();
  sa::pin_regs(o);
  sa::pin_regs(pa);

  // the four partial outputs meet in the region (K and V are read by now);
  // group gr sums and writes columns 32 gr .. 32 gr + 31
  __syncthreads();
  float* red = reinterpret_cast<float*>(base_p + (region - base));
#pragma unroll
  for (int i = 0; i < D / 2; ++i) red[(group * (D / 2) + i) * 128 + tg] = o[i];
  __syncthreads();
#pragma unroll
  for (int dd = 0; dd < 4; ++dd) {
    const int dt = 4 * group + dd;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = 0.f;
#pragma unroll
      for (int gr = 0; gr < GROUPS; ++gr) v[e] += red[(gr * (D / 2) + 4 * dt + e) * 128 + tg];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = q0 + row0 + 8 * r;
      if (t < Tn)  // rows past T were computed on zeros and are dropped
        *reinterpret_cast<uint32_t*>(out + (((size_t)b * Tn + t) * H + h) * D + 8 * dt + 2 * tq) =
            sa::pack_bf16(v[2 * r], v[2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- fp32 path

constexpr int FQ = 64;            // query rows a tile
constexpr int FTHREADS = 256;     // 8 warps: 4 groups of 16 query rows x 2 quarters of the keys
constexpr int FLD = D + 4;        // row stride in floats (528 bytes): conflict-free fragment loads
constexpr int FKB = 32;           // keys of a quarter in one streamed block
constexpr int FROWS = 2 * FKB;    // rows of a streamed block: both quarters' 32 keys
constexpr size_t FP32_SMEM = sizeof(float) * (size_t)(FQ + 2 * FROWS) * FLD;

// Rows of a tile in shared memory (FLD apart), RMS-normalised by weight w and
// rotated at their positions, in place: warp `warp` takes rows warp, warp +
// 8, ..., NR at a time so that their table loads are in flight together;
// lane l holds columns l, l + 32 and their rotary partners l + 64, l + 96 (the
// same arithmetic as the plain version, fp32). A row whose position is past
// T (staged as zeros) is left as it is.
template <int NR, typename PosOf>
__device__ __forceinline__ void norm_rope_rows(float* tile, int nrows, PosOf pos_of, int Tn,
                                               const float* __restrict__ w,
                                               const float* __restrict__ cs,
                                               const float* __restrict__ sn, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float wv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) wv[i] = w[lane + 32 * i];
  for (int r0 = warp; r0 < nrows; r0 += 8 * NR) {
    float x[NR][4], c[NR][2], s[NR][2];
    int tpos[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const int r = r0 + 8 * u;
      tpos[u] = r < nrows ? pos_of(r) : Tn;
      const bool ok = tpos[u] < Tn;
      const float* tc = cs + (size_t)(ok ? tpos[u] : 0) * (D / 2);
      const float* ts = sn + (size_t)(ok ? tpos[u] : 0) * (D / 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[u][i] = ok ? tile[r * FLD + lane + 32 * i] : 0.f;
      c[u][0] = ok ? tc[lane] : 0.f;
      c[u][1] = ok ? tc[lane + 32] : 0.f;
      s[u][0] = ok ? ts[lane] : 0.f;
      s[u][1] = ok ? ts[lane + 32] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      if (tpos[u] >= Tn) continue;  // the same for every lane of the warp
      float ss = x[u][0] * x[u][0] + x[u][1] * x[u][1] + x[u][2] * x[u][2] + x[u][3] * x[u][3];
      ss = sa::warp_sum(ss);
      const float rr = rsqrtf(ss / D + eps);
      float y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) y[i] = x[u][i] * rr * wv[i];
      float* row = tile + (r0 + 8 * u) * FLD;
      row[lane] = y[0] * c[u][0] - y[2] * s[u][0];
      row[lane + 64] = y[0] * s[u][0] + y[2] * c[u][0];
      row[lane + 32] = y[1] * c[u][1] - y[3] * s[u][1];
      row[lane + 96] = y[1] * s[u][1] + y[3] * c[u][1];
    }
  }
}

// The fp32 body: the same 64 query rows a tile as in bf16, the tile's work
// split over a cluster of two blocks on two SMs (B = 1 gives 128 blocks,
// not 64). Block r of the pair owns half r of the t_pad keys (KW = t_pad / 2)
// and normalises and rotates only those, so each key is normalised once a
// tile; its 8 warps: warp w takes query rows 16 (w % 4) .. + 15 and quarter
// w / 4 of the block's keys (KQ = KW / 2). Both products are mma.sync
// m16n8k8 TF32 in 3xTF32 (tf32.cuh), the fragments loaded from shared
// memory and split in registers: TF32 wgmma would need V K-major, i.e.
// transposed, and every operand split in shared memory, hi and lo, which
// does not fit beside Q, K and V at T = 512.
//   Copies:  Q, then the block's K and V in blocks of 2 x 32 keys (each
//            quarter's next 32), by 16-byte cp.async into two buffers, the
//            next landing while this one is used; rows past T arrive as
//            zeros.
//   Norm:    Q (both blocks), then each K block, in place.
//   Scores:  q' k'^T for the warp's 16 rows and KQ keys stay in registers
//            (KQ / 2 a thread).
//   Softmax: each quarter's row max and sum in base 2, traded once across
//            the cluster (distributed shared memory); p = 2^(x - m_q)
//            2^(m_q - m) / l, normalised before the second product, as the
//            plain version.
//   p . v:   p's accumulator fragments are the A fragments of m16n8k8 once
//            keys 2q and 2q + 1 of each 8 are taken as k = q and q + 4; V's
//            rows are read in the same order. The four partial outputs meet
//            across the cluster; block r sums and stores rows 32 r .. + 31
//            in 16-byte pieces.
// Bound at (1, 250, 16, 128): 3 x 0.52 GFLOP of TF32 products, 3.1 us at
// 495 TFLOP/s (7.6 us as fp32 FMAs); 8.2 MB, 2.4 us at 3.35 TB/s.
// Up to T = 256 (KW <= 128) two blocks share an SM (128 registers a thread,
// 101 KB of shared memory each), which hides more latency when B > 1.
template <int KW>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(FTHREADS, KW <= 128 ? 2 : 1)
fused_glue_attention_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ qw,
                                 const float* __restrict__ kw, const float* __restrict__ cs,
                                 const float* __restrict__ sn, const uint8_t* __restrict__ mask,
                                 float* __restrict__ out, int Tn, int H, float eps,
                                 float scale_log2) {
  constexpr int KQ = KW / 2;             // keys of a warp's quarter
  constexpr int NB = KQ / FKB;           // streamed blocks of K, then as many of V
  constexpr int NR = KQ <= 64 ? 8 : 4;   // rows a warp normalises at once (registers allowing)
  extern __shared__ __align__(16) float fsmem[];
  __shared__ float red_m[2][FQ], red_l[2][FQ];
  float* Qs = fsmem;                     // FQ x FLD
  float* bufs = fsmem + FQ * FLD;        // two blocks of FROWS x FLD
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 3, kq = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = (blockIdx.x >> 1) * FQ;
  const size_t row_stride = (size_t)H * D;
  const size_t base = ((size_t)b * Tn * H + h) * D;

  // row r of block i is key rank KW + (r / 32) KQ + 32 (i % NB) + r % 32: K
  // for i < NB, V after
  auto key_of = [&](int i, int r) {
    return rank * KW + (r / FKB) * KQ + FKB * (i % NB) + (r % FKB);
  };
  auto fetch = [&](int i) {
    if (i < 2 * NB) {
      const float* src = i < NB ? k : v;
      float* dst = bufs + (i % 2) * FROWS * FLD;
      for (int p = threadIdx.x; p < FROWS * (D / 4); p += FTHREADS) {
        const int r = p / (D / 4), c4 = p % (D / 4), key = key_of(i, r);
        const bool in = key < Tn;
        sa::cp_async16(sa::smem_u32(dst + r * FLD + 4 * c4),
                       in ? src + base + key * row_stride + 4 * c4 : src, in ? 16 : 0);
      }
    }
    sa::cp_async_commit();
  };
  for (int p = threadIdx.x; p < FQ * (D / 4); p += FTHREADS) {
    const int r = p / (D / 4), c4 = p % (D / 4), t = q0 + r;
    const bool in = t < Tn;
    sa::cp_async16(sa::smem_u32(Qs + r * FLD + 4 * c4), in ? q + base + t * row_stride + 4 * c4 : q,
                   in ? 16 : 0);
  }
  sa::cp_async_commit();
  fetch(0);
  fetch(1);
  sa::cp_async_wait<2>();
  __syncthreads();
  norm_rope_rows<NR>(Qs, FQ, [&](int r) { return q0 + r; }, Tn, qw, cs, sn, eps);

  // s[i][n]: the scores of 8-key tile n of block i; o[hf][n]: output
  // columns 64 hf + 8 n .. + 7
  float s[NB][FKB / 8][4], o[2][8][4];
#pragma unroll
  for (int i = 0; i < NB; ++i)
#pragma unroll
    for (int n = 0; n < FKB / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][n][e] = 0.f;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hf][n][e] = 0.f;
  const float* qa = Qs + (16 * rg) * FLD;

#pragma unroll
  for (int i = 0; i < 2 * NB; ++i) {
    sa::cp_async_wait<1>();  // block i has landed (block i + 1 may be in flight)
    __syncthreads();         // ... for every thread's pieces; Q is normalised
    float* blk = bufs + (i % 2) * FROWS * FLD;
    if (i < NB) {
      norm_rope_rows<NR>(blk, FROWS, [&](int r) { return key_of(i, r); }, Tn, kw, cs, sn, eps);
      __syncthreads();
      // scores of this block: keys 32 i .. 32 i + 31 of the warp's quarter
      const float* kb = blk + (kq * FKB) * FLD;
#pragma unroll 4
      for (int ks = 0; ks < D / 8; ++ks) {
        uint32_t ah[4], al[4];
        sa::split_tf32(qa[g * FLD + 8 * ks + tq], ah[0], al[0]);
        sa::split_tf32(qa[(g + 8) * FLD + 8 * ks + tq], ah[1], al[1]);
        sa::split_tf32(qa[g * FLD + 8 * ks + tq + 4], ah[2], al[2]);
        sa::split_tf32(qa[(g + 8) * FLD + 8 * ks + tq + 4], ah[3], al[3]);
        uint32_t bh[FKB / 8][2], bl[FKB / 8][2];
#pragma unroll
        for (int n = 0; n < FKB / 8; ++n) {
          sa::split_tf32(kb[(8 * n + g) * FLD + 8 * ks + tq], bh[n][0], bl[n][0]);
          sa::split_tf32(kb[(8 * n + g) * FLD + 8 * ks + tq + 4], bh[n][1], bl[n][1]);
        }
        sa::mma_3xtf32(s[i], ah, al, bh, bl);
      }
    } else {
      if (i == NB) {
        // Softmax in base 2: x = s * scale * log2(e); a masked key (or one
        // past T) takes finfo(f32).min itself, unscaled, so that a fully
        // masked row is uniform. Element e of tile n of block bi: row 16 rg
        // + g + 8 (e / 2), key rank KW + kq KQ + 32 bi + 8 n + 2 tq + e % 2.
        const uint8_t* mrow = mask ? mask + (size_t)b * Tn : nullptr;
        float m_loc[2] = {-INFINITY, -INFINITY}, l_loc[2] = {0.f, 0.f};
#pragma unroll
        for (int bi = 0; bi < NB; ++bi)
#pragma unroll
          for (int n = 0; n < FKB / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = rank * KW + kq * KQ + FKB * bi + 8 * n + 2 * tq + (e & 1);
              const bool ok = key < Tn && (mrow == nullptr || mrow[key] != 0);
              s[bi][n][e] = ok ? s[bi][n][e] * scale_log2 : sa::kF32Min;
              m_loc[e >> 1] = fmaxf(m_loc[e >> 1], s[bi][n][e]);
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          m_loc[r] = fmaxf(m_loc[r], __shfl_xor_sync(0xffffffffu, m_loc[r], 1));
          m_loc[r] = fmaxf(m_loc[r], __shfl_xor_sync(0xffffffffu, m_loc[r], 2));
        }
#pragma unroll
        for (int bi = 0; bi < NB; ++bi)
#pragma unroll
          for (int n = 0; n < FKB / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[bi][n][e] = sa::ex2(s[bi][n][e] - m_loc[e >> 1]);
              l_loc[e >> 1] += s[bi][n][e];
            }
        const int row0 = 16 * rg + g;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_loc[r] += __shfl_xor_sync(0xffffffffu, l_loc[r], 1);
          l_loc[r] += __shfl_xor_sync(0xffffffffu, l_loc[r], 2);
          if (tq == 0) {
            red_m[kq][row0 + 8 * r] = m_loc[r];
            red_l[kq][row0 + 8 * r] = l_loc[r];
          }
        }
        cluster.sync();  // both blocks' quarters' statistics are written
        const float* rm = cluster.map_shared_rank(&red_m[0][0], rank ^ 1);
        const float* rl = cluster.map_shared_rank(&red_l[0][0], rank ^ 1);
        float f[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          const float mq[4] = {red_m[0][row], red_m[1][row], rm[row], rm[FQ + row]};
          const float lq[4] = {red_l[0][row], red_l[1][row], rl[row], rl[FQ + row]};
          const float m = fmaxf(fmaxf(mq[0], mq[1]), fmaxf(mq[2], mq[3]));
          float l = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) l += lq[j] * sa::ex2(mq[j] - m);
          f[r] = sa::ex2(m_loc[r] - m) / l;
        }
#pragma unroll
        for (int bi = 0; bi < NB; ++bi)
#pragma unroll
          for (int n = 0; n < FKB / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[bi][n][e] *= f[e >> 1];
      }
      // o += p . v over keys 32 (i - NB) .. + 31 of the warp's quarter;
      // within each 8 keys, keys 2 tq and 2 tq + 1 are k = tq and tq + 4
      const float* vb = blk + (kq * FKB) * FLD;
#pragma unroll
      for (int kk = 0; kk < FKB / 8; ++kk) {
        const float* sp = s[i - NB][kk];
        uint32_t ah[4], al[4];
        sa::split_tf32(sp[0], ah[0], al[0]);
        sa::split_tf32(sp[2], ah[1], al[1]);
        sa::split_tf32(sp[1], ah[2], al[2]);
        sa::split_tf32(sp[3], ah[3], al[3]);
        const float* v0 = vb + (8 * kk + 2 * tq) * FLD + g;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t bh[8][2], bl[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            sa::split_tf32(v0[64 * hf + 8 * n], bh[n][0], bl[n][0]);
            sa::split_tf32(v0[FLD + 64 * hf + 8 * n], bh[n][1], bl[n][1]);
          }
          sa::mma_3xtf32(o[hf], ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // block i's buffer is free
    fetch(i + 2);
  }

  // the quarters' partial outputs meet in the buffers (every block is read):
  // quarter kq of this block at rows 64 kq ..; block r sums rows 32 r .. + 31
  // of all four (two of them in the other block) and stores those below T
  float* red = bufs + kq * FQ * FLD;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float2*>(red + (16 * rg + g + 8 * r) * FLD + 64 * hf + 8 * n + 2 * tq) =
            make_float2(o[hf][n][2 * r], o[hf][n][2 * r + 1]);
  cluster.sync();  // both blocks' partials are written
  const float* other = cluster.map_shared_rank(bufs, rank ^ 1);
  for (int p = threadIdx.x; p < (FQ / 2) * (D / 4); p += FTHREADS) {
    const int r = 32 * rank + p / (D / 4), c4 = p % (D / 4), t = q0 + r;
    if (t < Tn) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* src = (j < 2 ? bufs : other) + ((j & 1) * FQ + r) * FLD + 4 * c4;
        const float4 a = *reinterpret_cast<const float4*>(src);
        acc.x += a.x;
        acc.y += a.y;
        acc.z += a.z;
        acc.w += a.w;
      }
      *reinterpret_cast<float4*>(out + base + t * row_stride + 4 * c4) = acc;
    }
  }
  cluster.sync();  // the other block is done reading this block's partials
}

// A (B, T, H, D) bf16 tensor as a 4-D map whose box is 32 rows of one head,
// 64 columns wide (128 bytes, the swizzle's span).
int qkv_map(const void* ptr, int B, int T, int H, CUtensorMap* out) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)T, (uint64_t)B};
  const uint32_t box[4] = {64, 1, 32, 1};
  return sa::tensor_map(ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dims, box, out);
}

template <int KW>
int launch_bf16_kw(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
                   const float* qw, const float* kw, const float* cs, const float* sn,
                   const uint8_t* mask, void* out, int B, int Tn, int H, float eps, float scale,
                   cudaStream_t stream) {
  const size_t smem = 1024 + 2 * Q_HALF + REGION_BYTES;  // + alignment slack
  dim3 grid((Tn + MQ - 1) / MQ, B * H);
  return sa::launch(fused_glue_attention_wgmma_kernel<KW>, grid, dim3(WTHREADS), smem, stream,
                    mq, mk, mv, qw, kw, cs, sn, mask, (bf16*)out, Tn, H, eps, scale * LOG2E);
}

int launch_bf16(const void* q, const void* k, const void* v, const float* qw, const float* kw,
                const float* cs, const float* sn, const uint8_t* mask, void* out, int B,
                int Tn, int H, float eps, float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int err = qkv_map(q, B, Tn, H, &mq);
  if (err == 0) err = qkv_map(k, B, Tn, H, &mk);
  if (err == 0) err = qkv_map(v, B, Tn, H, &mv);
  if (err != 0) return err;
  switch ((Tn + 127) / 128) {
    case 1: return launch_bf16_kw<32>(mq, mk, mv, qw, kw, cs, sn, mask, out, B, Tn, H, eps, scale, stream);
    case 2: return launch_bf16_kw<64>(mq, mk, mv, qw, kw, cs, sn, mask, out, B, Tn, H, eps, scale, stream);
    case 3: return launch_bf16_kw<96>(mq, mk, mv, qw, kw, cs, sn, mask, out, B, Tn, H, eps, scale, stream);
    default: return launch_bf16_kw<128>(mq, mk, mv, qw, kw, cs, sn, mask, out, B, Tn, H, eps, scale, stream);
  }
}

template <int KW>
int launch_fp32_kw(const float* q, const float* k, const float* v, const float* qw,
                   const float* kw, const float* cs, const float* sn, const uint8_t* mask,
                   float* out, int B, int Tn, int H, float eps, float scale, cudaStream_t stream) {
  dim3 grid(2 * ((Tn + FQ - 1) / FQ), B * H);  // a cluster of two blocks a tile
  return sa::launch(fused_glue_attention_tf32_kernel<KW>, grid, dim3(FTHREADS), FP32_SMEM, stream,
                    q, k, v, qw, kw, cs, sn, mask, out, Tn, H, eps, scale * LOG2E);
}

int launch_fp32(const void* q, const void* k, const void* v, const float* qw,
                const float* kw, const float* cs, const float* sn, const uint8_t* mask,
                void* out, int B, int Tn, int H, float eps, float scale,
                cudaStream_t stream) {
  const float *qf = (const float*)q, *kf = (const float*)k, *vf = (const float*)v;
  float* of = (float*)out;
  switch ((Tn + 127) / 128) {  // KW = t_pad / 2
    case 1: return launch_fp32_kw<64>(qf, kf, vf, qw, kw, cs, sn, mask, of, B, Tn, H, eps, scale, stream);
    case 2: return launch_fp32_kw<128>(qf, kf, vf, qw, kw, cs, sn, mask, of, B, Tn, H, eps, scale, stream);
    case 3: return launch_fp32_kw<192>(qf, kf, vf, qw, kw, cs, sn, mask, of, B, Tn, H, eps, scale, stream);
    default: return launch_fp32_kw<256>(qf, kf, vf, qw, kw, cs, sn, mask, of, B, Tn, H, eps, scale, stream);
  }
}

}  // namespace

// q, k, v, out: (B, T, H, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// qw, kw: (D,) float32; cs, sn: (T, D/2) float32; mask: (B, T) uint8, or null
// for no mask.
// D must be 128 and T <= 512 (each warp keeps its rows' scores for half the
// keys in registers). q/k/v and the cos/sin rows must start 16-byte aligned.
extern "C" int sa_fused_glue_attention(const void* q, const void* k, const void* v,
                                       const float* qw, const float* kw,
                                       const float* cs, const float* sn,
                                       const uint8_t* mask, void* out, int B, int T,
                                       int H, int Dh, float eps, float scale,
                                       int dtype, void* stream) {
  if (Dh != D || T > 512 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_bf16(q, k, v, qw, kw, cs, sn, mask, out, B, T, H, eps, scale, s);
  return launch_fp32(q, k, v, qw, kw, cs, sn, mask, out, B, T, H, eps, scale, s);
}
