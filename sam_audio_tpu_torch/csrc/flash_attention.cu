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
//   fp32: split-TF32 products (3xTF32, mma.sync m16n8k8) fed by the same
//         kind of TMA ring, each tile split once for the block, 144 query
//         rows a block; the fp32 path section below.

#include "common.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"
#include "tf32.cuh"

namespace {

constexpr int D = 128;

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

// ---------------------------------------------------------------- fp32 path

// Flash attention in split TF32 ("3xTF32", tf32.cuh): each operand of a
// product is split into hi + lo in TF32 and the product is taken as lo . hi +
// hi . lo + hi . hi in fp32, so that the fp32 body holds fp32's grain (TF32
// alone keeps ~3 digits). The precision is fixed here: nothing reads
// torch.backends.cuda.matmul.allow_tf32 or cudnn.allow_tf32.
//   Copies:   one lane of a producer warp fetches the block's Q (16-row boxes,
//             a warp's rows) and then each 32-key K and V tile through TMA:
//             a 4-D fp32 map over (B, S, H, D), boxes of 32 columns (128
//             bytes, 128-byte swizzle), zero fill past S, into a ring of two
//             stages, each arrival counted on an mbarrier and each stage
//             freed on a second one as soon as the tile is split: tile j + 1
//             and j + 2's copies run under tile j's products.
//   Split:    the nine consumer warps split each tile once for the block
//             (not once a warp): K into hi and lo in its own swizzled
//             layout, V into hi and lo transposed (D rows of 32 keys), the
//             keys of each 8 stored in the order 0, 2, 4, 6, 1, 3, 5, 7. Two
//             named barriers a tile fence the split buffers.
//   Products: both on mma.sync m16n8k8 TF32 (Q's fragments split in
//             registers as they load; K's and V's read split), every
//             fragment by ldmatrix, four 8 x 4 fp32 matrices an instruction,
//             free of bank conflicts under the swizzle. Not wgmma: a warp
//             group owns 64 rows, which 144 are not a multiple of, and split
//             planes of Q beside the ring and the split K and V do not fit
//             in shared memory.
//   Scores:   a warp owns 16 query rows; its 16 x 32 scores and p stay in
//             registers. The online softmax runs in base 2 with scale *
//             log2(e) folded in; the mask constant is added after the
//             scaling, unscaled, as in bf16. p is not rounded (the plain
//             version's p.to(v.dtype) is a no-op in fp32); l sums it.
//   p . v:    p's accumulator fragments are the A fragments of m16n8k8 once
//             keys 2q and 2q + 1 of each 8 are taken as k = q and q + 4,
//             which is the order V^T stores them in. Each tile's p . v goes
//             to a fresh accumulator (a quarter of D at a time), added to the
//             rescaled running output with fp32 arithmetic: the tensor
//             cores' fp32 accumulation rounds toward zero, and the output
//             takes every key tile (36 at S = 1125).
//   Tiles:    144 query rows a block (nine consumer warps): the long path's
//             (1, 1125, 16, 128) is 8 x 16 = 128 blocks, one wave on 132 SMs
//             (64-row blocks would be 288, 128-row 144: two waves each).
//             72 KB of Q, two 32 KB stages, 64 KB of split K and V: one
//             block an SM.
// Bound at (1, 1125, 16, 128): 3 x 10.4 GFLOP of TF32 products, 63 us at
// 495 TFLOP/s (155 us as fp32 FMAs). What holds it back (PERF.md): it runs
// at ~3.6x that bound. A 32-key tile is ~1,900 instructions a warp, 384 of
// them mma, issued at ~0.4 a clock a scheduler: each accumulator takes 48
// dependent products a tile, Q's fragments are split again every tile, and
// ten warps an SM cap a thread at 168 registers (ptxas spills a little).
constexpr int FW = 9;                    // consumer warps, 16 query rows each
constexpr int FQ = 16 * FW;              // query rows per block
constexpr int FCONSUMERS = 32 * FW;      // consumer threads
constexpr int FTHREADS = FCONSUMERS + 32;  // plus one producer warp
constexpr int FK = 32;                   // keys per tile
constexpr int FSTAGES = 2;               // K/V tiles in flight
constexpr int FKBOX = FK * 128;          // a 32-key x 32-column fp32 box
constexpr int FTILE = 4 * FKBOX;         // 32 keys x D = 128 columns
constexpr int FVT = D * 128;             // V^T of a tile: D rows x 32 keys
constexpr int FQBOX = 16 * 128;          // a 16-row x 32-column fp32 box
constexpr int FQSLAB = 4 * FQBOX;        // a warp's 16 query rows
// Q | ring [stage][K, V] | K hi | K lo | V^T hi | V^T lo (+ alignment)
constexpr size_t FP32_SMEM =
    (size_t)FW * FQSLAB + 2 * FSTAGES * FTILE + 2 * FTILE + 2 * FVT + 1024;

// Four 8-row x 4-column fp32 matrices from shared memory (ldmatrix's 8 x 8
// b16 ones): lane l gives the address of row l % 8 of matrix l / 8 and gets
// of matrix i, in r[i], the element at row l / 4, column l % 4: the TF32
// m16n8k8 fragment layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Byte offset of (row r, 16-byte piece c) in rows of 128 bytes with the
// 128-byte swizzle: piece c of row r sits at piece c ^ (r % 8).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// One block per (batch * head, 144 query rows). Consumer warp w owns rows
// q0 + 16 w .. + 15; lane l (g = l / 4, tq = l % 4) holds rows g and g + 8
// and, of every 8 keys or output columns, 2 tq and 2 tq + 1.
__global__ void __launch_bounds__(FTHREADS, 1)
flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const uint8_t* __restrict__ mask, float* __restrict__ out, int Sq,
                            int Sk, int H, int sk_pad, float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[1 + 2 * FSTAGES];  // Q arrived; per stage: tile arrived, tile free
  const uint32_t raw = sa::smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;  // the swizzled boxes need 1024-byte alignment
  const uint32_t ring = q_s + FW * FQSLAB;      // stage st: K at + 2 st FTILE, V after it
  const uint32_t k_hi = ring + 2 * FSTAGES * FTILE, k_lo = k_hi + FTILE;
  const uint32_t vt_hi = k_lo + FTILE, vt_lo = vt_hi + FVT;
  auto at = [&](uint32_t a) { return smem_raw + (a - raw); };  // a shared address, generic
  const uint32_t q_full = sa::smem_u32(&bars[0]);
  const uint32_t full = sa::smem_u32(&bars[1]), empty = sa::smem_u32(&bars[1 + FSTAGES]);

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * FQ;
  const int n_tiles = sk_pad / FK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sa::mbar_init(q_full, 1);
    for (int st = 0; st < FSTAGES; ++st) {
      sa::mbar_init(full + 8 * st, 1);
      sa::mbar_init(empty + 8 * st, FCONSUMERS);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  if (warp == FW) {
    // ---- producer: one lane fetches Q, then keeps FSTAGES tiles in flight ----
    if (lane != 0) return;
    sa::mbar_arrive_expect_tx(q_full, FW * FQSLAB);
    for (int w = 0; w < FW; ++w)
      for (int c = 0; c < 4; ++c)
        sa::tma_load_4d(q_s + w * FQSLAB + c * FQBOX, &map_q, q_full, 32 * c, h, q0 + 16 * w, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % FSTAGES;
      // the first pass over the ring finds every stage free
      sa::mbar_wait(empty + 8 * st, ((j / FSTAGES) & 1) ^ 1);
      const uint32_t bar = full + 8 * st, kd = ring + 2 * st * FTILE;
      sa::mbar_arrive_expect_tx(bar, 2 * FTILE);
      for (int c = 0; c < 4; ++c) {
        sa::tma_load_4d(kd + c * FKBOX, &map_k, bar, 32 * c, h, FK * j, b);
        sa::tma_load_4d(kd + FTILE + c * FKBOX, &map_v, bar, 32 * c, h, FK * j, b);
      }
    }
    return;
  }

  // ---- consumer warps ----
  const int g = lane >> 2, tq = lane & 3;
  const int tid = threadIdx.x;
  const uint8_t* mrow = mask ? mask + (size_t)b * Sk : nullptr;
  // ldmatrix rows of this lane (matrix lm, row lr): Q's A fragment of a
  // step is rows 0-7 / 8-15 x d 0-3 / 4-7; a B fragment pair of K (two
  // 8-key tiles x d 0-3 / 4-7) or of V^T (two 8-column tiles x the keys
  // taken as k 0-3 / 4-7)
  const int lm = lane >> 3, lr = lane & 7;
  const uint32_t q_lane = q_s + warp * FQSLAB + (lr + 8 * (lm & 1)) * 128;
  const int pair_row = 8 * (lm >> 1) + lr;
  float o[2][8][4];  // output columns 64 hf + 8 n + 2 tq + e % 2, rows g + 8 (e / 2)
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[hf][n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};

  sa::mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FSTAGES, k0 = FK * j;
    // Which keys of the tile are masked, shifted so that bit 8 n + e is key
    // 8 n + 2 tq + e. Zero for a tile of attended keys below Sk.
    uint32_t bits = 0u;
    if (mrow != nullptr || k0 + FK > Sk) {
      const int key = k0 + lane;
      const bool ok = key < Sk && (mrow == nullptr || mrow[key] != 0);
      bits = ~__ballot_sync(0xffffffffu, ok) >> (2 * tq);
    }
    sa::mbar_wait(full + 8 * st, (j / FSTAGES) & 1);

    // Split the tile for the block: K (keys x D) into hi and lo at the same
    // offsets; V into hi and lo as V^T (D rows x 32 keys, each 8 keys in the
    // order 0, 2, 4, 6, 1, 3, 5, 7). Unit u: key u % 32, columns 4 (u / 32)
    // .. + 3; a warp's lanes take 32 keys of one piece.
    const uint32_t kd = ring + 2 * st * FTILE;
    for (int u = tid; u < FK * (D / 4); u += FCONSUMERS) {
      const int key = u & 31, c4 = u >> 5;
      const uint32_t off = (c4 >> 3) * FKBOX + swz(key, c4 & 7);
      const float4 kx = *reinterpret_cast<const float4*>(at(kd + off));
      const float4 vx = *reinterpret_cast<const float4*>(at(kd + FTILE + off));
      const float kv[4] = {kx.x, kx.y, kx.z, kx.w}, vv[4] = {vx.x, vx.y, vx.z, vx.w};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sa::split_tf32(kv[i], hi[i], lo[i]);
      *reinterpret_cast<uint4*>(at(k_hi + off)) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(at(k_lo + off)) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      const int pos = (key & 24) | ((key & 7) >> 1) | ((key & 1) << 2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c4 + i;
        const uint32_t vo = swz(d, pos >> 2) + ((pos & 3) << 2);
        sa::split_tf32(vv[i], hi[i], lo[i]);
        *reinterpret_cast<uint32_t*>(at(vt_hi + vo)) = hi[i];
        *reinterpret_cast<uint32_t*>(at(vt_lo + vo)) = lo[i];
      }
    }
    sa::mbar_arrive(empty + 8 * st);           // this thread has read its share of the stage
    sa::named_barrier(1, FCONSUMERS);          // the split tile is complete

    // s = q . k^T: 16 steps of 8 over D, four 8-key tiles
    float s[4][4];  // keys 8 n + 2 tq + e % 2, rows g + 8 (e / 2)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      // the step's 16-byte pieces 2 (ks % 4) and + 1 of a row, swizzled
      uint32_t a[4], ah[4], al[4];
      ldmatrix_x4(q_lane + (ks >> 2) * FQBOX + (((2 * (ks & 3) + (lm >> 1)) ^ lr) << 4), a);
#pragma unroll
      for (int i = 0; i < 4; ++i) sa::split_tf32(__uint_as_float(a[i]), ah[i], al[i]);
      const uint32_t k_step = (ks >> 2) * FKBOX + swz(pair_row, 2 * (ks & 3) + (lm & 1));
      uint32_t kh[2][4], kl[2][4];  // tiles 2 p, 2 p + 1: b0, b1, b0, b1
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        ldmatrix_x4(k_hi + k_step + p * 16 * 128, kh[p]);
        ldmatrix_x4(k_lo + k_step + p * 16 * 128, kl[p]);
      }
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          bh[n][i] = kh[n >> 1][2 * (n & 1) + i];
          bl[n][i] = kl[n >> 1][2 * (n & 1) + i];
        }
      sa::mma_3xtf32(s, ah, al, bh, bl);
    }

    // online softmax in base 2: x = s * scale * log2(e) (+ the mask constant,
    // unscaled); p = 2^(x - m) unrounded, summed into l
    float alpha[2];
    {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (bits >> (8 * n + (e & 1)) & 1u) x += sa::kFlashMask;
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
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
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = sa::ex2(s[n][e] - m_r[e >> 1]);
          psum[e >> 1] += s[n][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
        psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
        l_r[r] = alpha[r] * l_r[r] + psum[r];
      }
    }

    // o = o * alpha + p . v, a quarter of D (32 columns) at a time through a
    // fresh accumulator
#pragma unroll
    for (int qd = 0; qd < 4; ++qd) {
      float ot[4][4];  // output columns 32 qd + 8 n + ..
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) ot[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < FK / 8; ++kk) {
        // keys 8 kk + 2 tq, + 1 of rows g, g + 8 as k = tq, tq + 4
        uint32_t ah[4], al[4];
        sa::split_tf32(s[kk][0], ah[0], al[0]);
        sa::split_tf32(s[kk][2], ah[1], al[1]);
        sa::split_tf32(s[kk][1], ah[2], al[2]);
        sa::split_tf32(s[kk][3], ah[3], al[3]);
        uint32_t vh[2][4], vl[2][4];  // column tiles 2 p, 2 p + 1: b0, b1, b0, b1
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const uint32_t v_off = swz(32 * qd + 16 * p + pair_row, 2 * kk + (lm & 1));
          ldmatrix_x4(vt_hi + v_off, vh[p]);
          ldmatrix_x4(vt_lo + v_off, vl[p]);
        }
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            bh[n][i] = vh[n >> 1][2 * (n & 1) + i];
            bl[n][i] = vl[n >> 1][2 * (n & 1) + i];
          }
        sa::mma_3xtf32(ot, ah, al, bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& acc = o[qd >> 1][4 * (qd & 1) + n][e];
          acc = acc * alpha[e >> 1] + ot[n][e];
        }
    }
    sa::named_barrier(1, FCONSUMERS);  // every warp is done with the split tile
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = q0 + 16 * warp + g + 8 * r;
    if (t >= Sq) continue;  // rows past Sq were computed on zeros and are dropped
    const float l_inv = l_r[r] == 0.f ? 1.f : 1.f / l_r[r];
    float* orow = out + (((size_t)b * Sq + t) * H + h) * D + 2 * tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<float2*>(orow + 64 * hf + 8 * n) =
            make_float2(o[hf][n][2 * r] * l_inv, o[hf][n][2 * r + 1] * l_inv);
  }
}

// A (B, S, H, D) fp32 tensor as a 4-D map whose box is `rows` rows of one
// head, 32 columns wide (128 bytes, the swizzle's span).
int qkv_map_fp32(const void* ptr, int B, int S, int H, int rows, CUtensorMap* out) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S, (uint64_t)B};
  const uint32_t box[4] = {32, 1, (uint32_t)rows, 1};
  return sa::tensor_map(ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, 4, dims, box, out);
}

int launch_fp32(const void* q, const void* k, const void* v, const uint8_t* mask,
                void* out, int B, int Sq, int Sk, int H, float scale,
                cudaStream_t stream) {
  CUtensorMap map_q, map_k, map_v;
  int err = qkv_map_fp32(q, B, Sq, H, 16, &map_q);
  if (err == 0) err = qkv_map_fp32(k, B, Sk, H, FK, &map_k);
  if (err == 0) err = qkv_map_fp32(v, B, Sk, H, FK, &map_v);
  if (err != 0) return err;
  dim3 grid((Sq + FQ - 1) / FQ, B * H);
  return sa::launch(flash_attention_tf32_kernel, grid, dim3(FTHREADS), FP32_SMEM, stream, map_q,
                    map_k, map_v, mask, (float*)out, Sq, Sk, H, (Sk + 127) / 128 * 128,
                    scale * LOG2E);
}

}  // namespace

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); all contiguous, dtype 0 =
// float32, 1 = bfloat16; mask: (B, Sk) bytes (nonzero = attend) or null for
// no mask. D must be 128; q, k and v must start 16-byte aligned (TMA).
extern "C" int sa_flash_attention(const void* q, const void* k, const void* v,
                                  const uint8_t* mask, void* out, int B, int Sq,
                                  int Sk, int H, int Dh, float scale, int dtype,
                                  void* stream) {
  if (Dh != D || Sq < 1 || Sk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_bf16(q, k, v, mask, out, B, Sq, Sk, H, scale, s);
  return launch_fp32(q, k, v, mask, out, B, Sq, Sk, H, scale, s);
}
