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
//   fp32: the same implicit GEMM on the tensor cores in split TF32
//         ("3xTF32", tf32.cuh): every fp32 operand is x = hi + lo in TF32
//         and a product is hi.hi + hi.lo + lo.hi (three wgmma m64nNk8,
//         fp32 accumulation; the dropped lo.lo is ~2^-21 of a term), which
//         holds the plain version's 1e-4 where one TF32 product (~2^-11)
//         would not. The precision is the design's: the kernel reads
//         neither torch.backends.cuda.matmul.allow_tf32 nor
//         torch.backends.cudnn.allow_tf32. TF32 wgmma takes both operands
//         from shared memory, K-major: the staged rows (hi and lo, 32
//         channels a chunk: a 128-byte row, the bf16 layout byte for byte)
//         and the weight slices (hi and lo, tiled and split once per unit on
//         the host: ops/fused_conv.py::tile_weights_fp32). Staging warps
//         read x with plain loads (any T), apply the exact snake (sinf) and
//         split. Up to Cp = 64 one kernel does the unit, s2 split into each
//         warpgroup's tile in shared memory for the 1x1 product; wider, a
//         k7 kernel writes s2 to a scratch already in the staged layout,
//         16 KB blocks that the 1x1 kernel fetches with one bulk copy each.
//         The tensor cores' accumulation rounds toward zero, so the products
//         of each staged chunk (four for the 1x1) go to a fresh accumulator
//         that is added to the output's with fp32 adds (see PROMOTE_K7).
//         Bound: the 36 launches' 2.28 TFLOP are 6.84 TFLOP of TF32
//         products, 13.8 ms at 495 TFLOP/s (34.0 ms as fp32 FMAs at 67).
//   Any C: both paths work on Cp = C rounded up to a multiple of 32 channels.
//         Channels past C are zeros where they are staged (input rows, s1,
//         h), the host pads the weights with zero rows and columns, the
//         biases with 0 and the alphas with 1, so they stay exact zeros
//         through both products and the snakes (snake(0) = 0); only rows
//         c < C are read from x or stored. In bf16 that is the PAD variant
//         of the kernel (fused up to Cp = 128, else split at 32); widths
//         that are multiples of 32 run the kernels they ran before, whose
//         masks would cost 2-8% (the split shapes most).

#include <algorithm>
#include <initializer_list>

#include "common.cuh"
#include "sm90.cuh"
#include "tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// the channels both paths compute: C rounded up to a multiple of 32
__host__ __device__ inline int padded_width(int C) { return (C + 31) / 32 * 32; }

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
// PAD (C not a multiple of 32): the unit runs on Cp = C rounded up to a
// multiple of 32 channels, the ones past C staged as zeros, never read from
// x nor stored; without PAD, Cp = C and the code is as it was for them.
template <int NC, int MODE, bool PAD>
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
  const int C = a.C, Cp = PAD ? padded_width(C) : C, Tn = a.T, dil = a.dil;
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
    // row of 8 channels, one 16-byte store. Channels C .. Cp - 1 (not
    // fetched) are staged as zeros. ----
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
      const int kb_n = min(KCH, Cp - kc * KCH) / 8, r32 = (R + 31) / 32;
      for (int unit = sid / 32; unit < kb_n * r32; unit += 3) {
        const int kb = unit / r32, u = (unit % r32) * 32 + lane;
        if (u >= R) continue;
        const int valid = C - (kc * KCH + kb * 8);  // PAD: channels of this row below C
        float v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          v[i] = !PAD || i < valid ? sa::to_f(raw[(kb * 8 + i) * RA + off + u]) : 0.f;
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
      const int ksteps = min(KCH, Cp - kc * KCH) / 16;
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
    // banks. CONV7 stores s2 = snake(h); the others h + x. Rows c >= C
    // (padding) are neither read nor stored.
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
          if (t < Tn && (!PAD || cbase + c < C))
            v = *reinterpret_cast<const uint4*>(xb + (size_t)(cbase + c) * Tn + t);
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
        if (t < Tn && (!PAD || cbase + c < C))
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
// 64 / 32 that divides C (two kernels through a scratch s2). A C that is not
// a multiple of 32 runs padded (PAD): fused on Cp = C rounded up to a multiple
// of 32 up to Cp = 128, else split at 32. 0 when C < 1.
int bf16_chunk(int C) {
  if (C < 1) return 0;
  const int Cp = padded_width(C);
  if (Cp != C) return Cp <= 128 ? Cp : 32;
  if (C <= 128 || C == 192 || C == 256) return C;
  for (int nc : {128, 96, 64})
    if (C % nc == 0) return nc;
  return 32;
}

size_t wgmma_smem_bytes(int NC, int mode, int slots, int halo) {
  const int R = staged_rows(halo);
  return 1024 + (size_t)slots * NC * 128 + (size_t)NSTAGE * (2 * R + 8) * KCH * 2 +
         (size_t)2 * ep_channels(NC, mode) * EP_LD;
}

template <int NC, int MODE, bool PAD>
int launch_wgmma(ResArgs a, int B, int halo, cudaStream_t stream) {
  constexpr size_t kStatic = 1024;  // the barriers, with room to spare
  const size_t fixed = wgmma_smem_bytes(NC, MODE, 0, halo);
  a.slots = (int)std::min<size_t>(MAX_SLOTS, (kMaxSmem - kStatic - fixed) / ((size_t)NC * 128));
  if (a.slots < 2) return (int)cudaErrorInvalidValue;
  a.n_tiles = (a.T + TT - 1) / TT;
  a.n_chunks = MODE == FUSED ? 1 : (PAD ? padded_width(a.C) : a.C) / NC;
  a.n_items = B * a.n_tiles * a.n_chunks;
  const size_t smem = wgmma_smem_bytes(NC, MODE, a.slots, halo);
  const int grid = std::min(a.n_items, sa::num_sms());
  return sa::launch(res_unit_wgmma_kernel<NC, MODE, PAD>, dim3(grid), dim3(THREADS_BF16), smem,
                    stream, a);
}

template <int NC, bool PAD>
int run_split(ResArgs a, const bf16* x, const float* b7, const float* b1, bf16* s2, bf16* out,
              int B, cudaStream_t stream) {
  if (s2 == nullptr) return (int)cudaErrorInvalidValue;
  a.src = x; a.x = nullptr; a.bias = b7; a.b1 = nullptr; a.dst = s2;
  int err = launch_wgmma<NC, CONV7, PAD>(a, B, 3 * a.dil, stream);
  if (err != 0) return err;
  a.src = s2; a.x = x; a.bias = b1; a.a_in = nullptr; a.a_out = nullptr; a.dst = out;
  return launch_wgmma<NC, CONV1, PAD>(a, B, 0, stream);
}

// ---------------------------------------------------------------- fp32 path

// The bf16 body's implicit GEMM with TF32 operands in 3xTF32 (tf32.cuh). A
// staged chunk is 32 input channels: a 128-byte time row of TF32, the bytes
// of a bf16 chunk's 64 channels, so the column blocks and descriptors are
// the bf16 body's; it is stored twice, hi then lo. A weight slice is NC
// output channels x 32 input channels, hi then lo, each half the bf16
// slices' swizzled layout.
constexpr int KCF = 32;       // input channels of an fp32 chunk
constexpr int NST_MAX = 3;    // staged chunks in flight, at most

// slices are NC rows of 32 TF32, hi then lo
__host__ __device__ constexpr int fp32_slice_bytes(int NC) { return 2 * NC * 128; }
// CONV1 keeps three chunks in flight: one landing, one being split, one in use
__host__ __device__ constexpr int fp32_stages(int mode) { return mode == CONV1 ? 3 : 2; }

struct ResArgs32 {
  const float* src;     // x (FUSED, CONV7) or the staged s2 scratch (CONV1)
  const float* x;       // the residual (FUSED, CONV1)
  const float* w;       // the tiled weight slices (hi, lo)
  const float* bias;    // b7 (FUSED, CONV7) or b1 (CONV1), (Cp,)
  const float* b1;      // FUSED: the 1x1 bias
  const float2* a_in;   // (alpha, 1 / (alpha + 1e-9)) of the first snake (FUSED, CONV7)
  const float2* a_out;  // the same for h (FUSED, CONV7)
  float* dst;           // out (FUSED, CONV1) or the s2 scratch (CONV7)
  int C, T, dil, n_items, n_tiles, n_chunks, slots, w1_first;
};

// x + sin^2(a x) / a with the exact sine (the plain version's torch.sin), the
// channel's a = alpha.x and 1 / (alpha + 1e-9) = alpha.y given
__device__ __forceinline__ float snake_exact(float x, float2 a) {
  const float v = sinf(a.x * x);
  return x + a.y * (v * v);
}

// The TF32 products on wgmma, picked by the accumulator's width NC = 2 x its size.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], uint64_t a, uint64_t b, int acc) { sa::wgmma_m64n32k8_tf32(d, a, b, acc); }
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t a, uint64_t b, int acc) { sa::wgmma_m64n64k8_tf32(d, a, b, acc); }
__device__ __forceinline__ void wgmma_tf32(float (&d)[48], uint64_t a, uint64_t b, int acc) { sa::wgmma_m64n96k8_tf32(d, a, b, acc); }
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int acc) { sa::wgmma_m64n128k8_tf32(d, a, b, acc); }

// One k step of 8 input channels in 3xTF32: the small terms, then hi . hi;
// accumulate = 0 starts d afresh
template <int N>
__device__ __forceinline__ void wgmma_3xtf32(float (&d)[N], uint64_t a_hi, uint64_t a_lo,
                                             uint64_t b_hi, uint64_t b_lo, int accumulate) {
  wgmma_tf32(d, a_lo, b_hi, accumulate);
  wgmma_tf32(d, a_hi, b_lo, 1);
  wgmma_tf32(d, a_hi, b_hi, 1);
}

// The tensor cores' fp32 accumulation does not round to nearest: an addition
// can lose up to an ulp of the accumulator, always toward zero. Over the
// 2,016 additions of a 768-channel unit (|h| up to ~8) one accumulator
// drifted by up to 1.2e-4 on the card, past the 1e-4 contract. So each span
// of PROMOTE staged chunks is summed in a fresh wgmma accumulator (a partial
// sum, several times smaller) and added into the output's accumulator with
// ordinary fp32 adds: 1.9e-5 at most at every width up to 1,024.
constexpr int PROMOTE_K7 = 1;   // k7 products: 7 x 32 = 224 input values a span
constexpr int PROMOTE_1X1 = 4;  // 1x1 products: 128 input values a span

// One residual unit, or one half of it, in fp32: the bf16 kernel's roles,
// work items and weight ring, with every product in 3xTF32.
//   FUSED (Cp <= 64): s2 = snake(h) is split into the warpgroup's own tile
//         (the staged layout, 64 rows) and the 1x1 product reads it there.
//   CONV7: s2 = snake(h) of output channels [NC n, NC (n + 1)) goes to the
//         scratch in the staged layout: for each (batch, 128-row tile,
//         32-channel chunk), 8 column blocks of 128 rows x 16 bytes, 16 KB.
//   CONV1: each such block is one bulk copy into a staged chunk, split in
//         place by the staging warps.
// The staging warps of FUSED and CONV7 read x with plain loads along time
// (any T; eight rows of four channels a lane in flight), apply the snake
// and store hi and lo. The epilogue reads x and writes out straight from
// the accumulator fragments (32-byte runs along time). Channels C .. Cp - 1
// are exact zeros throughout (zero weights and biases, alphas of 1) and are
// neither read from x nor stored.
template <int NC, int MODE>
__global__ void __launch_bounds__(THREADS_BF16, 1)
res_unit_tf32_kernel(const ResArgs32 a) {
  constexpr int TAPS = MODE == CONV1 ? 1 : KSIZE;
  constexpr int NST = fp32_stages(MODE);
  constexpr int SLICE = fp32_slice_bytes(NC);  // hi, then lo at + NC * 128
  constexpr int BATCH = 8;             // staging: (row block, column block) pairs a lane loads at once
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * MAX_SLOTS + 3 * NST_MAX];
  const uint32_t raw = sa::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // the swizzled slices need 1024-byte alignment
  unsigned char* base_p = smem_raw + (base - raw);
  const int C = a.C, Cp = padded_width(C), nci = Cp / KCF, Tn = a.T, dil = a.dil;
  const int halo = MODE == CONV1 ? 0 : 3 * dil;
  const int R = staged_rows(halo);
  const int stage_bytes = 2 * R * 128;  // hi: 8 column blocks of R rows x 16 bytes; then lo
  const uint32_t slots_s = base, stage_s = base + a.slots * SLICE;
  const uint32_t s2_s = stage_s + NST * stage_bytes;  // FUSED: each warpgroup's s2, NC * 512 bytes
  auto wfull = [&](int i) { return sa::smem_u32(&bars[i]); };
  auto wempty = [&](int i) { return sa::smem_u32(&bars[MAX_SLOTS + i]); };
  auto sfull = [&](int i) { return sa::smem_u32(&bars[2 * MAX_SLOTS + i]); };
  auto sempty = [&](int i) { return sa::smem_u32(&bars[2 * MAX_SLOTS + NST_MAX + i]); };
  auto cfull = [&](int i) { return sa::smem_u32(&bars[2 * MAX_SLOTS + 2 * NST_MAX + i]); };

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.slots; ++i) {
      sa::mbar_init(wfull(i), 1);
      sa::mbar_init(wempty(i), MMA_THREADS);
    }
    for (int i = 0; i < NST; ++i) {
      sa::mbar_init(sfull(i), STAGERS);
      sa::mbar_init(sempty(i), MMA_THREADS);
      sa::mbar_init(cfull(i), 1);
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
    auto issue = [&](int slice) {
      const int st = use % a.slots;
      sa::mbar_wait(wempty(st), ((use / a.slots) & 1) ^ 1);
      sa::mbar_arrive_expect_tx(wfull(st), SLICE);
      sa::bulk_load(slots_s + st * SLICE, a.w + (size_t)slice * (SLICE / 4), SLICE, wfull(st));
      ++use;
    };
    for (int it = blockIdx.x; it < a.n_items; it += gridDim.x) {
      int bb, t0, nch;
      item_of(it, bb, t0, nch);
      for (int kc = 0; kc < nci; ++kc)
        for (int j = 0; j < TAPS; ++j)
          issue(MODE == CONV1 ? a.w1_first + nch * nci + kc : (nch * nci + kc) * KSIZE + j);
      if (MODE == FUSED)
        for (int kc = 0; kc < nci; ++kc) issue(a.w1_first + kc);
    }
    return;
  }

  if (warp < 4) {
    // ---- staging, by warps 1-3: chunk q of this block's sequence is item
    // q / nci, input channels 32 (q % nci) on ----
    const int sid = threadIdx.x - 32, sw = sid >> 5;
    const int my_items = a.n_items > (int)blockIdx.x ? (a.n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    const int n_mine = my_items * nci;
    if (MODE == CONV1) {
      // one bulk copy a chunk from the scratch into the hi half of its
      // stage, one chunk ahead; then split in place, lo beside it
      auto fetch = [&](int q) {
        if (sid != 0 || q >= n_mine) return;
        const int st = q % NST;
        int bb, t0, nch;
        item_of(blockIdx.x + (q / nci) * gridDim.x, bb, t0, nch);
        const float* blk =
            a.src + (((size_t)bb * a.n_tiles + t0 / TT) * nci + q % nci) * (TT * KCF);
        sa::mbar_wait(sempty(st), ((q / NST) & 1) ^ 1);
        sa::mbar_arrive_expect_tx(cfull(st), TT * KCF * 4);
        sa::bulk_load(stage_s + st * stage_bytes, blk, TT * KCF * 4, cfull(st));
      };
      fetch(0);
      for (int q = 0; q < n_mine; ++q) {
        fetch(q + 1);
        const int st = q % NST;
        sa::mbar_wait(cfull(st), (q / NST) & 1);
        uint4* hi = reinterpret_cast<uint4*>(base_p + (stage_s - base) + st * stage_bytes);
        uint4* lo = hi + R * 8;
        for (int i = sid; i < R * 8; i += STAGERS) {
          const uint4 v = hi[i];
          uint4 h, l;
          sa::split_tf32(__uint_as_float(v.x), h.x, l.x);
          sa::split_tf32(__uint_as_float(v.y), h.y, l.y);
          sa::split_tf32(__uint_as_float(v.z), h.z, l.z);
          sa::split_tf32(__uint_as_float(v.w), h.w, l.w);
          hi[i] = h;
          lo[i] = l;
        }
        sa::fence_proxy_async();  // the staged rows are wgmma operands
        sa::mbar_arrive(sfull(st));
      }
      return;
    }
    // FUSED, CONV7: time rows t0 - halo .. t0 - halo + R - 1 of 32 channels,
    // the conv's zero padding outside the sequence (snake(0) = 0), zeros past
    // C. Pair p is column block p % 8 (four channels) of the 32-row block
    // p / 8; a lane makes one row of it: four loads along time (coalesced),
    // the snake, and a 16-byte store to each of hi and lo.
    const int npairs = 8 * ((R + 31) / 32);
    for (int q = 0; q < n_mine; ++q) {
      int bb, t0, nch;
      item_of(blockIdx.x + (q / nci) * gridDim.x, bb, t0, nch);
      const int kc = q % nci, st = q % NST, tb = t0 - halo;
      const float* xb = a.src + (size_t)bb * C * Tn;
      sa::mbar_wait(sempty(st), ((q / NST) & 1) ^ 1);
      unsigned char* hi_p = base_p + (stage_s - base) + st * stage_bytes;
      unsigned char* lo_p = hi_p + R * 128;
      for (int p0 = sw; p0 < npairs; p0 += 3 * BATCH) {
        float v[BATCH][4];
#pragma unroll
        for (int bi = 0; bi < BATCH; ++bi) {
          const int p = p0 + 3 * bi, u = (p >> 3) * 32 + lane, t = tb + u;
          const bool in = p < npairs && u < R && t >= 0 && t < Tn;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int c = kc * KCF + (p & 7) * 4 + i;
            v[bi][i] = in && c < C ? __ldg(xb + (size_t)c * Tn + t) : 0.f;
          }
        }
#pragma unroll
        for (int bi = 0; bi < BATCH; ++bi) {
          const int p = p0 + 3 * bi, kb = p & 7, u = (p >> 3) * 32 + lane;
          if (p >= npairs || u >= R) continue;
          uint32_t h[4], l[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sa::split_tf32(snake_exact(v[bi][i], a.a_in[kc * KCF + kb * 4 + i]), h[i], l[i]);
          *reinterpret_cast<uint4*>(hi_p + kb * R * 16 + u * 16) = make_uint4(h[0], h[1], h[2], h[3]);
          *reinterpret_cast<uint4*>(lo_p + kb * R * 16 + u * 16) = make_uint4(l[0], l[1], l[2], l[3]);
        }
      }
      sa::fence_proxy_async();  // the staged rows are wgmma operands
      sa::mbar_arrive(sfull(st));
    }
    return;
  }

  // ---- MMA warpgroups: per chunk and tap, four k steps of three wgmma
  // (lo . hi, hi . lo, hi . hi) into the partial sum, one commit group per
  // tap, the previous group retired (and its slice freed) as the next is
  // issued; every PROMOTE chunks the partial sum joins acc ----
  constexpr int PROMOTE = MODE == CONV1 ? PROMOTE_1X1 : PROMOTE_K7;
  const int wg = (warp >> 2) - 1, wl = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  int wuse = 0, suse = 0;
  int prev_slot = -1, prev_stage = -1;
  auto retire_prev = [&]() {
    if (prev_slot >= 0) sa::mbar_arrive(wempty(prev_slot));
    if (prev_stage >= 0) sa::mbar_arrive(sempty(prev_stage));
  };
  // accumulator element e of 8-channel block j: row (of the 128-row tile)
  // 64 wg + 16 wl + g + 8 (e / 2), channel 8 j + 2 tq + e % 2
  auto row_of = [&](int e) { return 64 * wg + 16 * wl + g + 8 * (e >> 1); };
  float acc[NC / 2], part[NC / 2];
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
      const int st = suse % NST;
      sa::mbar_wait(sfull(st), (suse / NST) & 1);
      const uint32_t ahi = stage_s + st * stage_bytes + (64 * wg) * 16, alo = ahi + R * 128;
      for (int j = 0; j < TAPS; ++j) {
        const int slot = wuse % a.slots;
        sa::mbar_wait(wfull(slot), (wuse / a.slots) & 1);
        const uint32_t bhi = slots_s + slot * SLICE, blo = bhi + NC * 128;
        sa::pin_regs(part);
        sa::wgmma_fence();
        const uint32_t off = j * dil * 16;  // the tap's shift: j dil rows
        const int fresh = kc % PROMOTE == 0 && j == 0;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t ka = off + 2 * ks * R * 16;
          wgmma_3xtf32(part, sa::wgmma_desc_plain(ahi + ka, R * 16, 128),
                       sa::wgmma_desc_plain(alo + ka, R * 16, 128),
                       sa::wgmma_desc(bhi + ks * 32, 16, 1024),
                       sa::wgmma_desc(blo + ks * 32, 16, 1024), !(fresh && ks == 0));
        }
        sa::wgmma_commit();
        sa::wgmma_wait<1>();  // part is read only after wait<0> below
        retire_prev();
        prev_slot = slot;
        prev_stage = j == TAPS - 1 ? st : -1;
        ++wuse;
      }
      ++suse;
      if ((kc + 1) % PROMOTE == 0 || kc == nci - 1) {
        sa::wgmma_wait<0>();
        sa::pin_regs(part);
        retire_prev();
        prev_slot = prev_stage = -1;
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) acc[i] += part[i];
      }
    }

    // out = v + x for channels co0 .. co0 + NC - 1 below C and rows below T
    auto store_out = [&](const float (&v)[NC / 2]) {
      const float* xb = a.x + (size_t)bb * C * Tn;
      float* ob = a.dst + (size_t)bb * C * Tn;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = co0 + 8 * j + 2 * tq + (e & 1), t = t0 + row_of(e);
          if (c < C && t < Tn) {
            const size_t idx = (size_t)c * Tn + t;
            ob[idx] = v[4 * j + e] + __ldg(xb + idx);
          }
        }
    };
    if (MODE == CONV7) {
      // s2 = snake(h), every row and channel of the tile, into the scratch
      // block of (batch, tile, 32-channel chunk): column block (c % 32) / 4
      // of 128 rows x 16 bytes
      float* blk0 = a.dst + ((size_t)bb * a.n_tiles + t0 / TT) * nci * (TT * KCF);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = co0 + 8 * j + 2 * tq + (e & 1);
          blk0[(c / KCF) * (TT * KCF) + ((c % KCF) / 4) * (TT * 4) + row_of(e) * 4 + (c & 3)] =
              snake_exact(acc[4 * j + e], a.a_out[c]);
        }
    } else if (MODE == CONV1) {
      store_out(acc);
    } else {
      // FUSED: s2 = snake(h), split, into this warpgroup's tile (column block
      // c / 4 of 64 rows x 16 bytes, hi then lo): the A operand of the 1x1
      // product, whose slices follow the k7 slices in the ring
      float* s2_hi = reinterpret_cast<float*>(base_p + (s2_s - base) + wg * (NC * 512));
      float* s2_lo = s2_hi + NC * 64;
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * tq + (e & 1), off = (c / 4) * 256 + (row_of(e) - 64 * wg) * 4 + (c & 3);
          uint32_t h, l;
          sa::split_tf32(snake_exact(acc[4 * j + e], a.a_out[c]), h, l);
          s2_hi[off] = __uint_as_float(h);
          s2_lo[off] = __uint_as_float(l);
        }
      sa::fence_proxy_async();
      sa::named_barrier(2 + wg, WG_THREADS);  // the warpgroup's s2 is written
      float acc2[NC / 2];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const float b0 = a.b1[8 * j + 2 * tq], b1v = a.b1[8 * j + 2 * tq + 1];
        acc2[4 * j] = acc2[4 * j + 2] = b0;
        acc2[4 * j + 1] = acc2[4 * j + 3] = b1v;
      }
      const uint32_t shi = s2_s + wg * (NC * 512), slo = shi + NC * 256;
      for (int kc = 0; kc < nci; ++kc) {  // at most 64 input values: no promotion
        const int slot = wuse % a.slots;
        sa::mbar_wait(wfull(slot), (wuse / a.slots) & 1);
        const uint32_t bhi = slots_s + slot * SLICE, blo = bhi + NC * 128;
        sa::pin_regs(acc2);
        sa::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t ka = (kc * 8 + 2 * ks) * 64 * 16;
          wgmma_3xtf32(acc2, sa::wgmma_desc_plain(shi + ka, 64 * 16, 128),
                       sa::wgmma_desc_plain(slo + ka, 64 * 16, 128),
                       sa::wgmma_desc(bhi + ks * 32, 16, 1024),
                       sa::wgmma_desc(blo + ks * 32, 16, 1024), 1);
        }
        sa::wgmma_commit();
        sa::wgmma_wait<0>();
        sa::pin_regs(acc2);
        sa::mbar_arrive(wempty(slot));
        ++wuse;
      }
      store_out(acc2);
    }
  }
}

size_t fp32_smem_bytes(int NC, int mode, int slots, int halo) {
  return 1024 + (size_t)slots * fp32_slice_bytes(NC) +
         (size_t)fp32_stages(mode) * 2 * staged_rows(halo) * 128 +
         (mode == FUSED ? (size_t)NC * 1024 : 0);
}

// Output-channel chunk of the fp32 path for width C: Cp = padded_width(C)
// itself up to 64 (one fused kernel), else the widest of 128 / 96 / 64 / 32
// that divides Cp (a k7 and a 1x1 kernel through the scratch). 0 when C < 1.
int fp32_chunk(int C) {
  if (C < 1) return 0;
  const int Cp = padded_width(C);
  if (Cp <= 64) return Cp;
  for (int nc : {128, 96, 64})
    if (Cp % nc == 0) return nc;
  return 32;
}

template <int NC, int MODE>
int launch_tf32(ResArgs32 a, int B, cudaStream_t stream) {
  constexpr size_t kStatic = 1024;  // the barriers, with room to spare
  const int halo = MODE == CONV1 ? 0 : 3 * a.dil;
  const size_t fixed = fp32_smem_bytes(NC, MODE, 0, halo);
  if (fixed + kStatic > kMaxSmem) return (int)cudaErrorInvalidValue;
  a.slots = (int)std::min<size_t>(MAX_SLOTS, (kMaxSmem - kStatic - fixed) / fp32_slice_bytes(NC));
  if (a.slots < 2) return (int)cudaErrorInvalidValue;
  a.n_tiles = (a.T + TT - 1) / TT;
  a.n_chunks = MODE == FUSED ? 1 : padded_width(a.C) / NC;
  a.n_items = B * a.n_tiles * a.n_chunks;
  const size_t smem = fp32_smem_bytes(NC, MODE, a.slots, halo);
  const int grid = std::min(a.n_items, sa::num_sms());
  return sa::launch(res_unit_tf32_kernel<NC, MODE>, dim3(grid), dim3(THREADS_BF16), smem, stream, a);
}

template <int NC>
int run_split32(ResArgs32 a, const float* x, const float* b7, const float* b1, float* s2,
                float* out, int B, cudaStream_t stream) {
  if (s2 == nullptr) return (int)cudaErrorInvalidValue;
  a.src = x; a.x = nullptr; a.bias = b7; a.b1 = nullptr; a.dst = s2;
  int err = launch_tf32<NC, CONV7>(a, B, stream);
  if (err != 0) return err;
  a.src = s2; a.x = x; a.bias = b1; a.a_in = nullptr; a.a_out = nullptr; a.dst = out;
  return launch_tf32<NC, CONV1>(a, B, stream);
}

}  // namespace

// What the kernel takes for (C, dilation, dtype): the output-channel chunk
// (bf16: the padded width itself when one fused kernel does the unit; fp32:
// the same up to 64 channels); 0 when it cannot take the shape.
extern "C" int sa_res_unit_plan(int C, int dil, int dtype) {
  if (dil < 1 || C < 1) return 0;
  if (dtype == 1) {
    const int nc = bf16_chunk(C);
    const int mode = nc == padded_width(C) ? FUSED : CONV7;
    return staged_rows(3 * dil) <= 256 && wgmma_smem_bytes(nc, mode, 2, 3 * dil) + 1024 <= kMaxSmem
               ? nc
               : 0;
  }
  const int nc = fp32_chunk(C);
  auto fits = [&](int mode, int halo) { return fp32_smem_bytes(nc, mode, 2, halo) + 1024 <= kMaxSmem; };
  if (padded_width(C) <= 64) return fits(FUSED, 3 * dil) ? nc : 0;
  return fits(CONV7, 3 * dil) && fits(CONV1, 0) ? nc : 0;
}

// bf16: x, out: (B, C, T) contiguous, T a multiple of 8 (rows of 16-byte
// multiples for TMA; the wrapper pads others), x 16-byte aligned; w: the tiled weights (see
// ops/fused_conv.py::tile_weights, with the chunk sa_res_unit_plan gives,
// Cp = C rounded up to a multiple of 32 output rows); b7, b1: (Cp,) float32,
// zero past C; a1, a2: (Cp, 2) float32, each channel's (alpha, 1 / (alpha +
// 1e-9)), alpha 1 past C; s2: a (B, C, T) bf16 scratch when the chunk is not
// Cp (else unused).
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
  const int Cp = padded_width(C);
  a.w1_first = (Cp / nc) * ((C + KCH - 1) / KCH) * KSIZE;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x;
  bf16 *sb = (bf16*)s2, *ob = (bf16*)out;
  const bool pad = Cp != C;
  if (nc == Cp) {  // one fused kernel
    a.src = xb; a.x = xb; a.bias = b7; a.b1 = b1; a.dst = ob;
    const int halo = 3 * dil;
    if (pad) {  // bf16_chunk gives at most 128
      switch (nc) {
        case 32: return launch_wgmma<32, FUSED, true>(a, B, halo, s);
        case 64: return launch_wgmma<64, FUSED, true>(a, B, halo, s);
        case 96: return launch_wgmma<96, FUSED, true>(a, B, halo, s);
        default: return launch_wgmma<128, FUSED, true>(a, B, halo, s);
      }
    }
    switch (nc) {
      case 32: return launch_wgmma<32, FUSED, false>(a, B, halo, s);
      case 64: return launch_wgmma<64, FUSED, false>(a, B, halo, s);
      case 96: return launch_wgmma<96, FUSED, false>(a, B, halo, s);
      case 128: return launch_wgmma<128, FUSED, false>(a, B, halo, s);
      case 192: return launch_wgmma<192, FUSED, false>(a, B, halo, s);
      default: return launch_wgmma<256, FUSED, false>(a, B, halo, s);
    }
  }
  if (pad) return run_split<32, true>(a, xb, b7, b1, sb, ob, B, s);  // bf16_chunk gives 32
  switch (nc) {
    case 32: return run_split<32, false>(a, xb, b7, b1, sb, ob, B, s);
    case 64: return run_split<64, false>(a, xb, b7, b1, sb, ob, B, s);
    case 96: return run_split<96, false>(a, xb, b7, b1, sb, ob, B, s);
    default: return run_split<128, false>(a, xb, b7, b1, sb, ob, B, s);
  }
}

// fp32: x, out: (B, C, T) contiguous, any T >= 1; w: the tiled weights (see
// ops/fused_conv.py::tile_weights_fp32, with the chunk sa_res_unit_plan
// gives); b7, b1: (Cp,) float32, zero past C; a1, a2: (Cp, 2) float32 alpha
// pairs as in bf16; s2: a float32 scratch of B x ceil(T / 128) x Cp x 128
// when Cp > 64 (else unused). Any C whose staging fits shared memory (every
// C up to 1,024 at dilations 1, 3 and 9).
extern "C" int sa_fused_residual_unit(const void* x, const void* w, const float* b7,
                                      const float* b1, const float* a1, const float* a2,
                                      void* s2, void* out, int B, int C, int T, int dil,
                                      void* stream) {
  const int nc = sa_res_unit_plan(C, dil, 0);
  if (nc == 0 || T < 1) return (int)cudaErrorInvalidValue;
  ResArgs32 a{};
  a.w = (const float*)w;
  a.a_in = (const float2*)a1;
  a.a_out = (const float2*)a2;
  a.C = C;
  a.T = T;
  a.dil = dil;
  const int Cp = padded_width(C);
  a.w1_first = (Cp / nc) * (Cp / KCF) * KSIZE;
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float *sf = (float*)s2, *of = (float*)out;
  if (Cp <= 64) {  // one fused kernel
    a.src = xf; a.x = xf; a.bias = b7; a.b1 = b1; a.dst = of;
    return nc == 32 ? launch_tf32<32, FUSED>(a, B, s) : launch_tf32<64, FUSED>(a, B, s);
  }
  switch (nc) {
    case 32: return run_split32<32>(a, xf, b7, b1, sf, of, B, s);
    case 64: return run_split32<64>(a, xf, b7, b1, sf, of, B, s);
    case 96: return run_split32<96>(a, xf, b7, b1, sf, of, B, s);
    default: return run_split32<128>(a, xf, b7, b1, sf, of, B, s);
  }
}
