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
// What bounds it on the H100: 4 * S * S * D * H operations against four
// (B, S, H, D) tensors of traffic; at the long path's (1, 1125, 16, 128) that
// is 10.4 GFLOP (10.5 us at 989 TFLOP/s) against 18.4 MB (5.5 us): operations.
//
// Design, bf16 (the path that carries the launches): one block per
// (batch * head, 192-query tile) = three consumer warpgroups (128 threads
// and 64 queries each) plus a producer warpgroup of which one lane works.
//   Copies:   the producer's first lane fetches Q once and then the 64-key K
//             and V tiles through TMA (a 4-D tensor map over (B, S, H, D), box
//             64 rows x 64 columns, 128-byte swizzle; rows past S arrive as
//             zeros, which is what the padded keys need) into a ring of three
//             stages, each completion counted on an mbarrier; the consumers
//             free a stage on a second mbarrier. Tiles j + 1 and j + 2 are in
//             flight while tile j is multiplied.
//   Products: q . k^T is wgmma m64n64k16 with Q and the K tile read from
//             shared memory through descriptors; p . v is wgmma m64n128k16
//             with P as the register operand (rounded to bf16 there) and the V
//             tile read as it lies (keys down, D across): the transposed-B
//             form, no ldmatrix and no transpose pass.
//   Overlap:  a warpgroup starts tile j + 1's q . k^T and tile j's p . v
//             together and runs tile j + 1's softmax while they are in
//             flight, so the exponentials hide behind the tensor cores even
//             when the warpgroups of a block march in step.
//   Softmax:  scale * log2(e) is folded into the scores and 2^x is the
//             hardware's ex2; m, l and the 64 x 128 accumulator stay in fp32
//             registers; l sums the unrounded p. The mask constant is added
//             after the scaling, unscaled, so a fully masked row still gets
//             p = 1 for every key. The keys walk to round_up(Sk, 128). A
//             tile's 64 mask bytes are read two a lane and shared by ballot.
//   Tiles:    192 queries a block: three consumer warpgroups of 64 rows
//             that share every K/V tile. The long path is 16 heads x 6 tiles
//             = 96 blocks, all resident at once on 96 of the 132 SMs (one
//             block an SM: 48 KB of Q + 3 x 32 KB of K/V stages, 512
//             threads), and an SM reads K and V once for 192 queries. With
//             64 queries a block, two blocks an SM, the 288 blocks found 264
//             places: two waves. 128 queries would give 144 blocks: a second
//             wave 9% full that doubles the time. B = 8 and streaming windows
//             have blocks to spare.
//   Registers: four warpgroups of 128 registers a thread fill the register
//             file and a consumer needs about 140, so setmaxnreg drops the
//             producer's warpgroup to 24 and raises each consumer to 160.
//   fp32: 256 threads; each keeps a 4x4 block of scores and an 8-row x
//         4-column block of the accumulator in registers; fp32 FMA products.

#include "common.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"

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
  const uint8_t* mrow = mask ? mask + (size_t)b * Sk : nullptr;

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
      const bool valid = key < Sk && (mrow == nullptr || mrow[key] != 0);
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

using bf16 = __nv_bfloat16;

constexpr int GROUPS = 3;                   // consumer warpgroups, 64 query rows each
constexpr int WQ = 64 * GROUPS;             // query rows per block
constexpr int WK = 64;                      // keys per tile
constexpr int STAGES = 3;                   // K/V tiles in flight
constexpr int CONSUMERS = 128 * GROUPS;     // consumer threads
constexpr int WTHREADS = CONSUMERS + 128;   // plus the producer's warpgroup
constexpr int HALF_BYTES = 64 * 128;        // a swizzled 64-row x 64-column bf16 tile
constexpr int TILE_BYTES = 2 * HALF_BYTES;  // 64 rows x D = 128 columns: two such tiles
constexpr float LOG2E = 1.4426950408889634f;

__global__ void __launch_bounds__(WTHREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const uint8_t* __restrict__ mask, bf16* __restrict__ out, int Sq,
                             int Sk, int H, int sk_pad, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + 2 * STAGES];  // Q arrived; per stage: tile arrived, tile free
  // the swizzled tiles need 1024-byte alignment
  const uint32_t base = (sa::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, k_s = base + GROUPS * TILE_BYTES, v_s = k_s + STAGES * TILE_BYTES;
  const uint32_t q_full = sa::smem_u32(&bars[0]);
  const uint32_t full = sa::smem_u32(&bars[1]), empty = sa::smem_u32(&bars[1 + STAGES]);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * WQ;
  const int n_tiles = sk_pad / WK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sa::mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      sa::mbar_init(full + 8 * st, 1);
      sa::mbar_init(empty + 8 * st, CONSUMERS);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  // Four warpgroups of 128 registers a thread fill the register file, and
  // the consumers need about 140: the producer's warpgroup (a whole one, so
  // that what it hands back covers it) drops to 24 and each consumer
  // warpgroup takes 160.
  if (warp >= CONSUMERS / 32) {
    // ---- producer: one lane keeps STAGES tiles of K and V in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp != CONSUMERS / 32 || lane != 0) return;
    sa::mbar_arrive_expect_tx(q_full, GROUPS * TILE_BYTES);
    for (int i = 0; i < GROUPS; ++i) {  // a warpgroup's 64 rows: two 64-column tiles
      sa::tma_load_4d(q_s + i * TILE_BYTES, &map_q, q_full, 0, h, q0 + 64 * i, b);
      sa::tma_load_4d(q_s + i * TILE_BYTES + HALF_BYTES, &map_q, q_full, 64, h, q0 + 64 * i, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % STAGES;
      // the first pass over the ring finds every stage free
      sa::mbar_wait(empty + 8 * st, ((j / STAGES) & 1) ^ 1);
      const uint32_t bar = full + 8 * st;
      sa::mbar_arrive_expect_tx(bar, 2 * TILE_BYTES);
      const uint32_t kd = k_s + st * TILE_BYTES, vd = v_s + st * TILE_BYTES;
      sa::tma_load_4d(kd, &map_k, bar, 0, h, j * WK, b);
      sa::tma_load_4d(kd + HALF_BYTES, &map_k, bar, 64, h, j * WK, b);
      sa::tma_load_4d(vd, &map_v, bar, 0, h, j * WK, b);
      sa::tma_load_4d(vd + HALF_BYTES, &map_v, bar, 64, h, j * WK, b);
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each, 16 a warp ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");
  const int group = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const uint8_t* mrow = mask ? mask + (size_t)b * Sk : nullptr;
  float o[D / 2];  // 64 x 128 accumulator: o[4 * dt + e], columns 8 dt + 2 tq + e % 2
  float s[WK / 2];  // 64 x 64 scores, then p: s[4 * nt + e], keys 8 nt + 2 tq + e % 2
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < WK / 2; ++i) s[i] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f}, alpha[2];
  uint32_t pa[WK / 16][4];  // p rounded to bf16: the register operand of p . v

  sa::mbar_wait(q_full, 0);
  const uint64_t q_desc = sa::wgmma_desc(q_s + group * TILE_BYTES, 16, 1024);

  // s = q . k^T of tile j (asynchronous): eight 16-wide steps over D, four
  // in each half tile
  auto start_qk = [&](int j) {
    const int st = j % STAGES;
    sa::mbar_wait(full + 8 * st, (j / STAGES) & 1);
    const uint64_t k_desc = sa::wgmma_desc(k_s + st * TILE_BYTES, 16, 1024);
    sa::pin_regs(s);
    sa::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint64_t off = (uint64_t)(((ks >> 2) * HALF_BYTES + (ks & 3) * 32) >> 4);
      sa::wgmma_m64n64k16_ss(s, q_desc + off, k_desc + off, ks > 0);
    }
    sa::wgmma_commit();
  };

  // Which keys of tile j are masked, as two words shifted so that bit
  // 8 * (nt % 4) + e of word nt / 4 is key 8 nt + 2 tq + e. Lane l looks at
  // keys l and 32 + l of the tile and two ballots make the 64 bits: two byte
  // loads a lane and tile. Zero for a tile of attended keys below Sk.
  auto tile_mask = [&](int j, uint32_t (&bits)[2]) {
    const int k0 = j * WK;
    bits[0] = bits[1] = 0u;
    if (mrow == nullptr && k0 + WK <= Sk) return;
    const int ka = k0 + lane, kb = ka + 32;
    const bool oka = ka < Sk && (mrow == nullptr || mrow[ka] != 0);
    const bool okb = kb < Sk && (mrow == nullptr || mrow[kb] != 0);
    bits[0] = ~__ballot_sync(0xffffffffu, oka) >> (2 * tq);
    bits[1] = ~__ballot_sync(0xffffffffu, okb) >> (2 * tq);
  };

  // Online softmax of the scores in s, in the base-2 domain: x = s * scale *
  // log2(e); the mask constant is added after the scaling, unscaled (scaled,
  // it would overflow). Leaves p = 2^(x - m) in s (unrounded, summed into l)
  // and the factor for the old accumulator in alpha.
  auto softmax = [&](const uint32_t (&bits)[2]) {
    float mx[2] = {-INFINITY, -INFINITY};
    if ((bits[0] | bits[1]) == 0u) {
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) {
        s[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < WK / 2; ++i) {
        float x = s[i] * scale_log2;
        if (bits[i >> 4] >> (8 * ((i >> 2) & 3) + (i & 1)) & 1u) x += sa::kFlashMask;
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_next = fmaxf(m_r[r], mx[r]);
      alpha[r] = sa::ex2(m_r[r] - m_next);
      m_r[r] = m_next;
    }
#pragma unroll
    for (int i = 0; i < WK / 2; ++i) {
      s[i] = sa::ex2(s[i] - m_r[(i >> 1) & 1]);
      psum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
      psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
      l_r[r] = alpha[r] * l_r[r] + psum[r];
    }
  };

  // p rounded to bf16 into the A fragments (it never touches shared memory)
  auto pack_p = [&]() {
#pragma unroll
    for (int nt = 0; nt < WK / 8; ++nt) {
      pa[nt / 2][(nt & 1) * 2] = sa::pack_bf16(s[4 * nt], s[4 * nt + 1]);
      pa[nt / 2][(nt & 1) * 2 + 1] = sa::pack_bf16(s[4 * nt + 2], s[4 * nt + 3]);
    }
  };

  uint32_t bits[2];
  start_qk(0);
  tile_mask(0, bits);
  sa::wgmma_wait<0>();
  sa::pin_regs(s);
  softmax(bits);  // the accumulator is still zero: alpha is not needed
  pack_p();

  // o += p . v of tile j (asynchronous): V's tile is read as it lies (keys
  // down, D across), the transposed-B form; four 16-key steps, 2048 bytes of
  // rows each
  auto start_pv = [&](int j) {
    const uint64_t v_desc = sa::wgmma_desc(v_s + (j % STAGES) * TILE_BYTES, HALF_BYTES, 1024);
    sa::pin_regs(o);
    sa::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WK / 16; ++kk)
      sa::wgmma_m64n128k16_rs_bt(o, pa[kk], v_desc + (uint64_t)((kk * 16 * 128) >> 4), 1);
    sa::wgmma_commit();
  };
  // p . v of tile j has finished: its registers are ours again and its stage
  // may be refilled
  auto finish_pv = [&](int j) {
    sa::wgmma_wait<0>();
    sa::pin_regs(o);
    sa::pin_regs(pa);
    sa::mbar_arrive(empty + 8 * (j % STAGES));
  };

  // Tile j's p . v and tile j + 1's q . k^T run on the tensor cores while
  // tile j + 1's softmax runs on the other units. The last tile is peeled off
  // so that the loop's body has no branch around a product.
  for (int j = 0; j + 1 < n_tiles; ++j) {
    start_qk(j + 1);
    start_pv(j);
    tile_mask(j + 1, bits);
    sa::wgmma_wait<1>();  // the scores have arrived; p . v may still run
    sa::pin_regs(s);
    softmax(bits);
    finish_pv(j);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      o[4 * dt] *= alpha[0];
      o[4 * dt + 1] *= alpha[0];
      o[4 * dt + 2] *= alpha[1];
      o[4 * dt + 3] *= alpha[1];
    }
    pack_p();
  }
  start_pv(n_tiles - 1);
  finish_pv(n_tiles - 1);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + warp * 16 + g + 8 * r;
    if (t >= Sq) continue;  // rows past Sq were computed on zeros and are dropped
    const float l_inv = l_r[r] == 0.f ? 1.f : 1.f / l_r[r];
    bf16* orow = out + (((size_t)b * Sq + t) * H + h) * D + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(orow + dt * 8) =
          sa::pack_bf16(o[4 * dt + 2 * r] * l_inv, o[4 * dt + 2 * r + 1] * l_inv);
  }
}

// A (B, S, H, D) bf16 tensor as a 4-D map whose box is 64 rows of one head,
// 64 columns wide (128 bytes, the swizzle's span).
int qkv_map(const void* ptr, int B, int S, int H, CUtensorMap* out) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint32_t box[4] = {64, 1, 64, 1};
  return sa::tensor_map(ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, dims, box, out);
}

int launch_bf16(const void* q, const void* k, const void* v, const uint8_t* mask, void* out,
                int B, int Sq, int Sk, int H, float scale, cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int err = qkv_map(q, B, Sq, H, &map_q);
  if (err == 0) err = qkv_map(k, B, Sk, H, &map_k);
  if (err == 0) err = qkv_map(v, B, Sk, H, &map_v);
  if (err != 0) return err;
  const size_t smem = (size_t)(GROUPS + 2 * STAGES) * TILE_BYTES + 1024;  // + alignment slack
  dim3 grid((Sq + WQ - 1) / WQ, B * H);
  return sa::launch(flash_attention_wgmma_kernel, grid, dim3(WTHREADS), smem, stream, map_q,
                    map_k, map_v, mask, (bf16*)out, Sq, Sk, H, (Sk + 127) / 128 * 128,
                    scale * LOG2E);
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
// float32, 1 = bfloat16; mask: (B, Sk) bytes (nonzero = attend) or null for
// no mask. D must be 128; bf16 tensors must start 16-byte aligned.
extern "C" int sa_flash_attention(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, int B, int Sq,
                                  int Sk, int H, int Dh, float scale, int dtype,
                                  void* stream) {
  if (Dh != D || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_bf16(q, k, v, mask, out, B, Sq, Sk, H, scale, s);
  return launch_fp32(q, k, v, mask, out, B, Sq, Sk, H, scale, s);
}
