// One whole DAC residual unit, (B, C, T) layout:
//   s1 = snake(x, a1)                        rounded to the compute dtype
//   h  = b7 + sum_j W7[j] . s1[t + j*dil - 3*dil]   (dilated k=7 conv, fp32 sum,
//                                            zero padding at the sequence edges)
//   s2 = snake(round(h), a2)                 rounded to the compute dtype
//   out = W1 . s2 + b1 + x                   (fp32, then rounded)
// Replaces sam_audio_tpu/ops/fused_conv.py::fused_residual_unit
// (_fused_res_unit_padded / _res_unit_kernel). In bf16 the snake uses the
// same range-reduced polynomial sin^2 as the TPU kernel; in fp32, sinf.
//
// What bounds it on the H100: 16 C^2 T operations against 4 C T bytes; the 36
// launches of one separate do 2.28 TFLOP (2.3 ms at 989 TFLOP/s) and move
// 3.5 GB (1.0 ms at 3.35 TB/s): operations. Below that, the weights: a time
// tile of TT samples needs all 16 C^2 bytes of them.
//
// Design, bf16 (the path that carries the launches): an implicit GEMM on
// wgmma. M is time (64 rows a warpgroup, 128 a work item), N output channels,
// K the input channels of each of the seven taps. A block is persistent and
// walks work items (batch, 128-sample tile, chunk of output channels):
//   Staging:  three warps fetch 64-channel chunks of the input (with the
//             3 dil halo; zeros outside the sequence) by cp.async, double-
//             buffered, apply the first snake and store them, rounded, as an
//             unswizzled wgmma operand: 8 column blocks of R time rows x 16
//             bytes. A tap's shift by j dil rows is then its descriptor's
//             start address, j dil x 16 bytes on, so the seven taps read one
//             staged chunk. Two staged chunks in flight.
//   Weights:  prepared once per model on the host, tiled into slices of NC
//             output channels x 64 input channels, pre-swizzled (128 bytes)
//             and laid out in the order they are used; one lane streams them
//             with bulk copies into a ring of up to 24 slots (mbarriers), so
//             a tile's weights cost one copy instruction a slice.
//   Products: two warpgroups, each a 64 x NC fp32 accumulator: a tap is four
//             wgmma k steps (A = staged rows, B = the slice); the previous
//             tap's group retires while the next is issued.
//   Fused (NC = C = 32, 64, 96, 128, 192 or 256): h + b7 is rounded, snaked
//             and rounded again in registers, where its accumulator layout is
//             already the A fragment of the 1x1 product (wgmma, register A;
//             above 128 channels in two passes of C / 2 outputs). Wider or
//             other C (chunks of 128 / 96 / 64 / 32 output channels): a k7
//             kernel stores s2 to a (B, C, T) scratch and a 1x1 kernel (the
//             same code, one tap, no snake) adds b1 + x; the chunks give C =
//             512 / 768 at T = 3000 enough blocks to fill the card.
//   Epilogue: each warpgroup's outputs pass through a tile in shared memory,
//             so x is read and the result written in 16-byte pieces along
//             time.
//   fp32: fp32 FMA products, a block owns one time tile (64, 32 or 16) and
//         every channel: s1 with its halo and h in shared memory, weights
//         staged in 32-deep slices, each thread a 4-channel x TT/16-time block.

#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int KC = 32;        // reduction slice staged per step
constexpr int CO = 64;        // output channels per pass
constexpr int LA = CO + 1;    // fp32 path: padded stride of the staged slice
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

// x + sin^2(a x) / a with the exact sine: the fp32 path
__device__ __forceinline__ float snake_exact(float x, float a) {
  const float v = sinf(a * x);
  return x + (1.0f / (a + 1e-9f)) * (v * v);
}

// ---------------------------------------------------------------- bf16 path

constexpr int TT = 128;          // time rows a work item: two MMA warpgroups of 64
constexpr int KCH = 64;          // input channels a staged chunk (one weight slice's depth)
constexpr int WG_THREADS = 128;
constexpr int MMA_THREADS = 2 * WG_THREADS;
constexpr int STAGERS = 96;      // warps 1..3 of the helper warpgroup
constexpr int THREADS_BF16 = WG_THREADS + MMA_THREADS;
constexpr int NSTAGE = 2;        // staged chunks in flight
constexpr int MAX_SLOTS = 24;    // weight slices in flight, at most
enum Mode { FUSED = 0, CONV7 = 1, CONV1 = 2 };

// staged rows of a chunk: the tile and its halo, a multiple of 8 (a TMA box
// row of 16-byte multiples, at most 256)
__host__ __device__ inline int staged_rows(int halo) { return (TT + 2 * halo + 7) / 8 * 8; }

// the epilogue tile: channel rows of 64 samples (128 bytes) and 16 of padding
constexpr int EP_LD = 144;
// channels of one epilogue pass: the fused kernel's 1x1 pass, else the chunk
__host__ __device__ inline int ep_channels(int NC, int MODE) {
  return MODE == FUSED && NC > 128 ? NC / 2 : NC;
}

struct ResArgs {
  const bf16* src;      // (B, C, T): x (FUSED, CONV7) or s2 (CONV1)
  const bf16* x;        // the residual (FUSED, CONV1)
  const bf16* w;        // tiled weights: the k7 slices, then the 1x1 slices
  const float* bias;    // b7 (FUSED, CONV7) or b1 (CONV1)
  const float* b1;      // FUSED: the 1x1 bias
  const float2* a_in;   // snake (alpha, 1 / (alpha + 1e-9)) of the staged input (FUSED, CONV7)
  const float2* a_out;  // the same for h (FUSED, CONV7)
  bf16* dst;            // out (FUSED, CONV1) or s2 (CONV7)
  int C, T, dil, n_items, n_tiles, n_chunks, slots, w1_first;
};

// The products on wgmma, picked by the accumulator's width NC = 2 x its size.
__device__ __forceinline__ void mma_ss(float (&d)[16], uint64_t a, uint64_t b) { sa::wgmma_m64n32k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) { sa::wgmma_m64n64k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_ss(float (&d)[48], uint64_t a, uint64_t b) { sa::wgmma_m64n96k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b) { sa::wgmma_m64n128k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_ss(float (&d)[96], uint64_t a, uint64_t b) { sa::wgmma_m64n192k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_ss(float (&d)[128], uint64_t a, uint64_t b) { sa::wgmma_m64n256k16_ss(d, a, b, 1); }
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) { sa::wgmma_m64n32k16_rs(d, a, b, 1); }
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { sa::wgmma_m64n64k16_rs(d, a, b, 1); }
__device__ __forceinline__ void mma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) { sa::wgmma_m64n96k16_rs(d, a, b, 1); }
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { sa::wgmma_m64n128k16_rs(d, a, b, 1); }

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16(v)); }

// x + sin^2(a x) / a with the polynomial sin^2 (bf16), the channel's
// a = alpha.x and 1 / (alpha + 1e-9) = alpha.y given (computed on the host,
// the same correctly rounded division): no division an element
__device__ __forceinline__ float snake_pair(float x, float2 a) { return x + a.y * sin2_fast(a.x * x); }

// One residual unit, or one half of it, as an implicit GEMM on wgmma:
//   FUSED (NC = C): h = b7 + k7 conv of snake(x); s2 = snake(h) in registers
//         as the A operand of the 1x1 product; out = W1 s2 + b1 + x.
//   CONV7 (wider C): output channels [NC n, NC (n + 1)) of s2 = snake(b7 + k7
//         conv of snake(x)), stored to a (B, C, T) scratch.
//   CONV1 (wider C): output channels [NC n, NC (n + 1)) of W1 s2 + b1 + x.
// A work item is (batch, 128-sample tile, output-channel chunk); each block
// walks items blockIdx.x, + gridDim.x, ... Roles:
//   warp 0, lane 0: streams the weight slices (NC rows x 64 input channels,
//     pre-swizzled on the host) with bulk copies into a ring of `slots`;
//   warps 1-3: stage the input in 64-channel chunks (snake applied, rounded
//     to bf16) as time rows of an unswizzled wgmma operand: 8 column blocks of
//     R rows x 16 bytes, so a tap's shift of j * dil rows is a start address
//     j * dil * 16 bytes on: any shift is a legal descriptor;
//   warpgroups 1-2: 64 time rows each; per chunk and tap, four wgmma k steps
//     (A = staged rows, B = the weight slice), one commit group per tap, the
//     previous group retired (and its slice freed) as the next is issued.
template <int NC, int MODE>
__global__ void __launch_bounds__(THREADS_BF16, 1)
res_unit_wgmma_kernel(const ResArgs a) {
  constexpr int TAPS = MODE == CONV1 ? 1 : KSIZE;
  constexpr int SLICE = NC * 128;
  // fused: the 1x1 product's output channels a pass (all of them up to 128;
  // above, half, so that its accumulator and s2 fit the registers together)
  constexpr int NC1 = NC > 128 ? NC / 2 : NC;
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * MAX_SLOTS + 2 * NSTAGE];
  const uint32_t raw = sa::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzled slices need 1024-byte alignment
  unsigned char* base_p = smem_raw + (base - raw);
  const int C = a.C, Tn = a.T, dil = a.dil;
  const int halo = MODE == CONV1 ? 0 : 3 * dil;
  const int R = staged_rows(halo);
  const int stage_bytes = R * KCH * 2;
  const int RA = R + 8, raw_bytes = RA * KCH * 2;  // a raw chunk: 8-aligned rows of RA samples
  const uint32_t slots_s = base, raw_s = base + a.slots * SLICE;
  const uint32_t stage_s = raw_s + NSTAGE * raw_bytes;
  const int ep_bytes = ep_channels(NC, MODE) * EP_LD;   // a warpgroup's epilogue tile
  const uint32_t ep_s = stage_s + NSTAGE * stage_bytes;
  const int nci = (C + KCH - 1) / KCH;
  auto wfull = [&](int i) { return sa::smem_u32(&bars[i]); };
  auto wempty = [&](int i) { return sa::smem_u32(&bars[MAX_SLOTS + i]); };
  auto sfull = [&](int i) { return sa::smem_u32(&bars[2 * MAX_SLOTS + i]); };
  auto sempty = [&](int i) { return sa::smem_u32(&bars[2 * MAX_SLOTS + NSTAGE + i]); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) {
      sa::mbar_init(wfull(i), 1);
      sa::mbar_init(wempty(i), MMA_THREADS);
    }
    for (int i = 0; i < NSTAGE; ++i) {
      sa::mbar_init(sfull(i), STAGERS);
      sa::mbar_init(sempty(i), MMA_THREADS);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // item -> (batch, tile, chunk of output channels), the chunk fastest
  auto item_of = [&](int it, int& bb, int& t0, int& nch) {
    nch = it % a.n_chunks;
    const int rest = it / a.n_chunks;
    t0 = (rest % a.n_tiles) * TT;
    bb = rest / a.n_tiles;
  };

  if (warp == 0) {
    // ---- weight slices, in the order the MMA warpgroups take them ----
    if (lane != 0) return;
    int use = 0;
    // slice i of the k7 part starts at i * SLICE bytes, slice i of the 1x1
    // part at w1_first * SLICE + (i - w1_first) * SLICE1
    auto issue = [&](int slice, int bytes) {
      const int st = use % a.slots;
      const size_t off = slice < a.w1_first
                             ? (size_t)slice * SLICE
                             : (size_t)a.w1_first * SLICE + (size_t)(slice - a.w1_first) * bytes;
      sa::mbar_wait(wempty(st), ((use / a.slots) & 1) ^ 1);
      sa::mbar_arrive_expect_tx(wfull(st), bytes);
      sa::bulk_load(slots_s + st * SLICE, reinterpret_cast<const unsigned char*>(a.w) + off, bytes,
                    wfull(st));
      ++use;
    };
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      int bb, t0, nch;
      item_of(it, bb, t0, nch);
      for (int kc = 0; kc < nci; ++kc)
        for (int j = 0; j < TAPS; ++j)
          issue(MODE == CONV1 ? a.w1_first + nch * nci + kc : (nch * nci + kc) * KSIZE + j, SLICE);
      if (MODE == FUSED)
        for (int nh = 0; nh < NC / NC1; ++nh)
          for (int kc = 0; kc < nci; ++kc) issue(a.w1_first + nh * nci + kc, NC1 * 128);
    }
    return;
  }

  if (warp < 4) {
    // ---- staging, by warps 1-3. Chunk q of this block's sequence (item
    // q / nci, input chunk q % nci) is copied with cp.async into raw buffer
    // q % 2 while chunk q - 1 is transposed: 64 channel rows of RA samples
    // from an 8-aligned start, 16-byte pieces wholly inside the sequence or
    // wholly outside it (T is a multiple of 8), the outside ones zeros,
    // which is the conv's zero padding (snake(0) = 0). The transpose makes
    // time rows with the first snake applied and rounded: a lane makes one
    // row of 8 channels, one 16-byte store. ----
    const int sid = threadIdx.x - 32;
    const int my_items = a.n_items > (int)blockIdx.x ? (a.n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int n_chunks_mine = my_items * nci;
    auto start = [&](int q) {  // the 8-aligned first sample of chunk q, and its batch row
      int bb, t0, nch;
      item_of(blockIdx.x + (q / nci) * gridDim.x, bb, t0, nch);
      return make_int2((t0 - halo) & ~7, bb);
    };
    auto fetch = [&](int q) {
      if (q < n_chunks_mine) {
        const int2 s = start(q);
        const int kc = q % nci, ch = min(KCH, C - kc * KCH), pieces = RA / 8;
        const bf16* src = a.src + ((size_t)s.y * C + kc * KCH) * Tn;
        const uint32_t dst = raw_s + (q % 2) * raw_bytes;
        for (int p = sid; p < ch * pieces; p += STAGERS) {
          const int c = p / pieces, t = s.x + (p % pieces) * 8;
          const bool in = t >= 0 && t < Tn;
          sa::cp_async16(dst + p * 16, in ? src + (size_t)c * Tn + t : src, in ? 16 : 0);
        }
      }
      sa::cp_async_commit();
    };
    fetch(0);
    for (int q = 0; q < n_chunks_mine; ++q) {
      sa::named_barrier(1, STAGERS);  // raw buffer (q + 1) % 2 is read: refill it
      fetch(q + 1);
      sa::cp_async_wait<1>();
      sa::named_barrier(1, STAGERS);  // every stager's pieces of chunk q have landed
      int bb, t0, nch;
      item_of(blockIdx.x + (q / nci) * gridDim.x, bb, t0, nch);
      const int kc = q % nci, off = (t0 - halo) - ((t0 - halo) & ~7);
      const int st = q % NSTAGE;
      sa::mbar_wait(sempty(st), ((q / NSTAGE) & 1) ^ 1);
      const bf16* raw = reinterpret_cast<const bf16*>(base_p + (raw_s - base) + (q % 2) * raw_bytes);
      unsigned char* stage = base_p + (stage_s - base) + st * stage_bytes;
      const int kb_n = min(KCH, C - kc * KCH) / 8, r32 = (R + 31) / 32;
      for (int unit = sid / 32; unit < kb_n * r32; unit += 3) {
        const int kb = unit / r32, u = (unit % r32) * 32 + lane;
        if (u >= R) continue;
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = sa::to_f(raw[(kb * 8 + i) * RA + off + u]);
          if (MODE != CONV1) v[i] = snake_pair(v[i], a.a_in[kc * KCH + kb * 8 + i]);
        }
        *reinterpret_cast<uint4*>(stage + kb * R * 16 + u * 16) =
            make_uint4(sa::pack_bf16(v[0], v[1]), sa::pack_bf16(v[2], v[3]),
                       sa::pack_bf16(v[4], v[5]), sa::pack_bf16(v[6], v[7]));
      }
      sa::fence_proxy_async();  // the staged rows are wgmma operands
      sa::mbar_arrive(sfull(st));
    }
    return;
  }

  // ---- MMA warpgroups ----
  const int wg = (warp >> 2) - 1, wl = warp & 3, tg = threadIdx.x & 127;
  const int g = lane >> 2, tq = lane & 3;
  int wuse = 0, suse = 0;
  int prev_slot = -1, prev_stage = -1;  // the group in flight before the newest
  // retire every group but the newest, freeing the previous group's slice
  // (and its staged chunk after its last tap)
  auto retire_prev = [&]() {
    if (prev_slot >= 0) sa::mbar_arrive(wempty(prev_slot));
    if (prev_stage >= 0) sa::mbar_arrive(sempty(prev_stage));
  };
  float acc[NC / 2];
  for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
    int bb, t0, nch;
    item_of(it, bb, t0, nch);
    const int co0 = nch * NC;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const float b0 = a.bias[co0 + 8 * j + 2 * tq], b1v = a.bias[co0 + 8 * j + 2 * tq + 1];
      acc[4 * j] = acc[4 * j + 2] = b0;
      acc[4 * j + 1] = acc[4 * j + 3] = b1v;
    }
    for (int kc = 0; kc < nci; ++kc) {
      const int st = suse % NSTAGE;
      sa::mbar_wait(sfull(st), (suse / NSTAGE) & 1);
      const uint32_t stage = stage_s + st * stage_bytes + (64 * wg) * 16;
      const int ksteps = min(KCH, C - kc * KCH) / 16;
      for (int j = 0; j < TAPS; ++j) {
        const int slot = wuse % a.slots;
        sa::mbar_wait(wfull(slot), (wuse / a.slots) & 1);
        const uint32_t slice = slots_s + slot * SLICE;
        sa::pin_regs(acc);
        sa::wgmma_fence();
        const uint32_t a0 = stage + j * dil * 16;
        if (ksteps == 4) {
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            mma_ss(acc, sa::wgmma_desc_plain(a0 + 2 * ks * R * 16, R * 16, 128),
                   sa::wgmma_desc(slice + ks * 32, 16, 1024));
        } else {  // a 32-channel chunk (C = 96 and the like)
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            mma_ss(acc, sa::wgmma_desc_plain(a0 + 2 * ks * R * 16, R * 16, 128),
                   sa::wgmma_desc(slice + ks * 32, 16, 1024));
        }
        sa::wgmma_commit();
        sa::wgmma_wait<1>();
        sa::pin_regs(acc);
        retire_prev();
        prev_slot = slot;
        prev_stage = j == TAPS - 1 ? st : -1;
        ++wuse;
      }
      ++suse;
    }
    sa::wgmma_wait<0>();
    sa::pin_regs(acc);
    retire_prev();
    prev_slot = prev_stage = -1;

    // Epilogue of output channels cbase .. cbase + NCE - 1 (NCE = 8 NJ) over
    // this warpgroup's 64 rows, through its tile in shared memory (channel
    // rows of 64 samples, 144 bytes apart): x comes in and the result goes
    // out in 16-byte pieces along time; the fragments (row + 8 (e / 2),
    // column 8 j + 2 tq + e % 2) meet the tile in 2-byte steps that hit 32
    // banks. CONV7 stores s2 = snake(h); the others h + x.
    unsigned char* ep = base_p + (ep_s - base) + wg * ep_bytes;
    const int trow0 = t0 + 64 * wg;
    auto store = [&](const auto& v_acc, int cbase) {
      constexpr int NCE = 8 * (sizeof(v_acc) / sizeof(float) / 4);
      const bf16* xb = a.x + (size_t)bb * C * Tn;
      bf16* ob = a.dst + (size_t)bb * C * Tn;
      if (MODE != CONV7) {
        for (int p = tg; p < NCE * 8; p += WG_THREADS) {
          const int c = p / 8, t = trow0 + (p % 8) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (t < Tn) v = *reinterpret_cast<const uint4*>(xb + (size_t)(cbase + c) * Tn + t);
          *reinterpret_cast<uint4*>(ep + c * EP_LD + (p % 8) * 16) = v;
        }
        sa::named_barrier(2 + wg, WG_THREADS);
      }
#pragma unroll
      for (int j = 0; j < NCE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * wl + g + 8 * (e >> 1), c = 8 * j + 2 * tq + (e & 1);
          bf16* slot = reinterpret_cast<bf16*>(ep + c * EP_LD + r * 2);
          float v = v_acc[4 * j + e];
          if (MODE == CONV7)
            v = snake_pair(round_bf16(v), a.a_out[cbase + c]);
          else
            v += sa::to_f(*slot);
          *slot = sa::from_f<bf16>(v);
        }
      sa::named_barrier(2 + wg, WG_THREADS);
      for (int p = tg; p < NCE * 8; p += WG_THREADS) {
        const int c = p / 8, t = trow0 + (p % 8) * 8;
        if (t < Tn)
          *reinterpret_cast<uint4*>(ob + (size_t)(cbase + c) * Tn + t) =
              *reinterpret_cast<const uint4*>(ep + c * EP_LD + (p % 8) * 16);
      }
      sa::named_barrier(2 + wg, WG_THREADS);  // the tile is free again
    };
    if (MODE == FUSED) {
      // h -> bf16 -> snake -> bf16, straight into the A fragments of the 1x1
      // product: 16-channel step ks is acc[8 ks .. 8 ks + 7]
      uint32_t s2[NC / 16][4];
#pragma unroll
      for (int ks = 0; ks < NC / 16; ++ks)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = 2 * ks + (r >> 1), e = 2 * (r & 1);
          const int c = co0 + 8 * j + 2 * tq;
          s2[ks][r] = sa::pack_bf16(snake_pair(round_bf16(acc[4 * j + e]), a.a_out[c]),
                                    snake_pair(round_bf16(acc[4 * j + e + 1]), a.a_out[c + 1]));
        }
      float acc2[NC1 / 2];
#pragma unroll
      for (int nh = 0; nh < NC / NC1; ++nh) {
#pragma unroll
        for (int j = 0; j < NC1 / 8; ++j) {
          const int c = nh * NC1 + 8 * j + 2 * tq;
          acc2[4 * j] = acc2[4 * j + 2] = a.b1[c];
          acc2[4 * j + 1] = acc2[4 * j + 3] = a.b1[c + 1];
        }
#pragma unroll
        for (int kc = 0; kc < (NC + KCH - 1) / KCH; ++kc) {
          const int slot = wuse % a.slots;
          sa::mbar_wait(wfull(slot), (wuse / a.slots) & 1);
          const uint32_t slice = slots_s + slot * SLICE;
          sa::pin_regs(acc2);
          sa::wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            if (kc * 4 + ks < NC / 16)
              mma_rs(acc2, s2[kc * 4 + ks], sa::wgmma_desc(slice + ks * 32, 16, 1024));
          sa::wgmma_commit();
          sa::wgmma_wait<0>();
          sa::pin_regs(acc2);
          sa::pin_regs(s2);
          sa::mbar_arrive(wempty(slot));
          ++wuse;
        }
        store(acc2, nh * NC1);
      }
    } else {
      store(acc, co0);
    }
  }
}

// Output-channel chunk of the bf16 path for width C: all of C (one fused
// kernel) for C = 32, 64, 96, 128, 192 or 256, else the widest of 128 / 96 /
// 64 / 32 that divides C (two kernels through a scratch s2). 0 when C is not
// a multiple of 32.
int bf16_chunk(int C) {
  if (C % 32 != 0 || C < 32) return 0;
  if (C <= 128 || C == 192 || C == 256) return C;
  for (int nc : {128, 96, 64, 32})
    if (C % nc == 0) return nc;
  return 0;
}

size_t wgmma_smem_bytes(int NC, int mode, int slots, int halo) {
  const int R = staged_rows(halo);
  return 1024 + (size_t)slots * NC * 128 + (size_t)NSTAGE * (2 * R + 8) * KCH * 2 +
         (size_t)2 * ep_channels(NC, mode) * EP_LD;
}

template <int NC, int MODE>
int launch_wgmma(ResArgs a, int B, int halo, cudaStream_t stream) {
  constexpr size_t kStatic = 1024;  // the barriers, with room to spare
  const size_t fixed = wgmma_smem_bytes(NC, MODE, 0, halo);
  a.slots = (int)std::min<size_t>(MAX_SLOTS, (kMaxSmem - kStatic - fixed) / ((size_t)NC * 128));
  if (a.slots < 2) return (int)cudaErrorInvalidValue;
  a.n_tiles = (a.T + TT - 1) / TT;
  a.n_chunks = MODE == FUSED ? 1 : a.C / NC;
  a.n_items = B * a.n_tiles * a.n_chunks;
  const size_t smem = wgmma_smem_bytes(NC, MODE, a.slots, halo);
  const int grid = std::min(a.n_items, sa::num_sms());
  return sa::launch(res_unit_wgmma_kernel<NC, MODE>, dim3(grid), dim3(THREADS_BF16), smem, stream,
                    a);
}

template <int NC>
int run_split(ResArgs a, const bf16* x, const float* b7, const float* b1, bf16* s2, bf16* out,
              int B, cudaStream_t stream) {
  if (s2 == nullptr) return (int)cudaErrorInvalidValue;
  a.src = x; a.x = nullptr; a.bias = b7; a.b1 = nullptr; a.dst = s2;
  int err = launch_wgmma<NC, CONV7>(a, B, 3 * a.dil, stream);
  if (err != 0) return err;
  a.src = s2; a.x = x; a.bias = b1; a.a_in = nullptr; a.a_out = nullptr; a.dst = out;
  return launch_wgmma<NC, CONV1>(a, B, 0, stream);
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
    S1[e] = (t >= 0 && t < Tn) ? snake_exact(xb[(size_t)c * Tn + t], a1[c]) : 0.f;
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
  for (int e = threadIdx.x; e < C * TT; e += THREADS) Hs[e] = snake_exact(Hs[e], a2[e / TT]);

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

int pick_tile_fp32(int C, int dil) {
  for (int tt : {64, 32, 16})
    if (fma_smem_bytes(C, tt, dil) <= kMaxSmem) return tt;
  return 0;
}

template <int TT_>
int launch_fp32(size_t smem, const void* x, const void* w7, const float* b7, const void* w1,
                const float* b1, const float* a1, const float* a2, void* out, int B, int C,
                int Tn, int dil, cudaStream_t stream) {
  dim3 grid((Tn + TT_ - 1) / TT_, B);
  return sa::launch(res_unit_fma_kernel<TT_>, grid, dim3(THREADS), smem, stream, (const float*)x,
                    (const float*)w7, b7, (const float*)w1, b1, a1, a2, (float*)out, C, Tn, dil);
}

}  // namespace

// What the kernel takes for (C, dilation, dtype): in bf16 the output-channel
// chunk (C itself when one fused kernel does the unit), in fp32 the time
// tile; 0 when it cannot take the shape.
extern "C" int sa_res_unit_plan(int C, int dil, int dtype) {
  if (dil < 1) return 0;
  if (dtype == 1) {
    const int nc = bf16_chunk(C);
    return nc != 0 && staged_rows(3 * dil) <= 256 &&
                   wgmma_smem_bytes(nc, nc == C ? FUSED : CONV7, 2, 3 * dil) + 1024 <= kMaxSmem
               ? nc
               : 0;
  }
  return C % KC == 0 ? pick_tile_fp32(C, dil) : 0;
}

// bf16: x, out: (B, C, T) contiguous, T a multiple of 8 (rows of 16-byte
// multiples for TMA; the wrapper pads others), x 16-byte aligned; w: the tiled weights (see
// ops/fused_conv.py::tile_weights, with the chunk sa_res_unit_plan gives);
// b7, b1: (C,) float32; a1, a2: (C, 2) float32, each channel's (alpha,
// 1 / (alpha + 1e-9)); s2: a (B, C, T) bf16 scratch when the chunk is not C
// (else unused).
extern "C" int sa_fused_residual_unit_bf16(const void* x, const void* w, const float* b7,
                                           const float* b1, const float* a1, const float* a2,
                                           void* s2, void* out, int B, int C, int T, int dil,
                                           void* stream) {
  const int nc = sa_res_unit_plan(C, dil, 1);
  if (nc == 0 || T < 1 || T % 8 != 0) return (int)cudaErrorInvalidValue;
  ResArgs a{};
  a.w = (const bf16*)w;
  a.a_in = (const float2*)a1;
  a.a_out = (const float2*)a2;
  a.C = C;
  a.T = T;
  a.dil = dil;
  a.w1_first = (C / nc) * ((C + KCH - 1) / KCH) * KSIZE;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x;
  bf16 *sb = (bf16*)s2, *ob = (bf16*)out;
  if (nc == C) {  // one fused kernel
    a.src = xb; a.x = xb; a.bias = b7; a.b1 = b1; a.dst = ob;
    const int halo = 3 * dil;
    switch (nc) {
      case 32: return launch_wgmma<32, FUSED>(a, B, halo, s);
      case 64: return launch_wgmma<64, FUSED>(a, B, halo, s);
      case 96: return launch_wgmma<96, FUSED>(a, B, halo, s);
      case 128: return launch_wgmma<128, FUSED>(a, B, halo, s);
      case 192: return launch_wgmma<192, FUSED>(a, B, halo, s);
      default: return launch_wgmma<256, FUSED>(a, B, halo, s);
    }
  }
  switch (nc) {
    case 32: return run_split<32>(a, xb, b7, b1, sb, ob, B, s);
    case 64: return run_split<64>(a, xb, b7, b1, sb, ob, B, s);
    case 96: return run_split<96>(a, xb, b7, b1, sb, ob, B, s);
    default: return run_split<128>(a, xb, b7, b1, sb, ob, B, s);
  }
}

// fp32: x, out: (B, C, T) contiguous; w7: (7, C_out, C_in); w1: (C_out,
// C_in); b7, b1, a1, a2: (C,). C must be a multiple of 32.
extern "C" int sa_fused_residual_unit(const void* x, const void* w7, const float* b7,
                                      const void* w1, const float* b1, const float* a1,
                                      const float* a2, void* out, int B, int C, int T,
                                      int dil, void* stream) {
  const int tt = sa_res_unit_plan(C, dil, 0);
  if (tt == 0 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = fma_smem_bytes(C, tt, dil);
  if (tt == 64) return launch_fp32<64>(smem, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
  if (tt == 32) return launch_fp32<32>(smem, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
  return launch_fp32<16>(smem, x, w7, b7, w1, b1, a1, a2, out, B, C, T, dil, s);
}
