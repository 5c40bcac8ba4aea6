// y = x . dequant(w4)^T with packed int4 weights and per-(out, group) scales:
//   w4: (half, K) uint8; byte (p, i) holds weight row p in its low nibble and
//       row p + half in its high nibble, both sign-extended values in [-7, 7];
//   scale: (2*half, G) fp32, one per (output row, group of K/G inputs);
//   y[t, o] = sum_g scale[o, g] * (sum_{i in group g} x[t, i] * q[o, i])
// Each group's partial dot is taken in fp32 and multiplied by its scale
// before it is added, and the result is rounded once to x's dtype (no bias).
// Replaces sam_audio_tpu/ops/int4_matmul.py::matmul_int4 (`_kernel`).
//
// What bounds it on the H100: at the DiT's shapes and 250 tokens, 2*M*K*N
// operations on the tensor cores (near the ridge); only cross-attention's k/v
// projections at ~14 tokens are bound by the weight bytes.
//
// Design, bf16 (the path that carries the launches): y^T = W . x^T, so that
// the 64 rows a wgmma wants are output rows and a few tokens cost a narrow
// instruction (N = 16), not a padded 64-row tile.
//   Tiles:    a block owns 64 packed rows x NT tokens (16 or 64 when they
//             hold M, else 128) x one split of the groups. Two consumer
//             warpgroups each make one nibble plane (64 outputs x NT tokens)
//             from the same staged bytes: one read of a packed byte feeds
//             both, and a warpgroup sign-extends only its own nibble.
//   Split-K:  a group's partial is scaled and then summed, so sums over
//             disjoint sets of groups add exactly in fp32. grid.z blocks
//             share the groups of one tile (split s takes groups
//             [s*G/S, (s+1)*G/S)), each writes its fp32 partial to a
//             workspace, and a second small kernel adds the splits in order
//             and rounds once: no atomics, the same bits run to run. With one
//             split the block rounds and writes the output itself. (A
//             thread-block cluster a tile, reducing through distributed
//             shared memory, was tried and took twice as long: clusters of 4
//             to 8 blocks that each fill an SM are slow to place.)
//   Copies:   one lane of a third warpgroup fetches the x chunk (NT x 128
//             columns, two 128-byte-swizzled tiles) and the packed bytes
//             (64 rows x 128, swizzled too) through TMA into a ring of five
//             stages guarded by mbarriers; zero fill past M, past out/2 and
//             past K. The consumers make no copy and meet at no block-wide
//             barrier. setmaxnreg moves the producer's registers to them.
//   Unpack:   each thread reads its own 2-byte pairs of the packed tile (all
//             of a chunk's loads first) and sign-extends them in registers
//             (a byte permute, one logic operation and one bf16x2
//             subtraction per two values) straight into the A fragment: no
//             unpacked copy in shared memory.
//   Products: wgmma m64nNTk16 with A from registers and the x tile as the
//             shared-memory B operand, started step by step so that the next
//             step's unpack runs under the previous step's product; fp32
//             partial per group, times the group's scale, into the fp32
//             accumulator (groups of any multiple of 16 columns).
//   What holds it back (PERF.md): a chunk costs a block ~1.1 us where its
//             products take 0.5 and its copies 0.4, and they add instead of
//             overlapping (both go through shared memory); at 250 tokens two
//             thirds of a launch are fixed costs (two launches, the ring's
//             fill, the workspace).
//   fp32: the same tiles, ring and split plan on the bf16 tensor cores, x
//         split into three bf16 planes (x = hi + mid + lo) by a small
//         kernel of the same call; each nibble fragment meets all three
//         planes (the fp32 path section below).
// Masked copies (zero fill) replace the TPU kernel's padding of the tokens to
// 8, so any token count runs.

#include "common.cuh"
#include "sm90.cuh"
#include "tensor_map.cuh"

namespace {

using bf16 = __nv_bfloat16;

// The nibbles in bits 0-3 and 16-19 of v, sign-extended, as two bf16 (bits
// 0-3 in the low half). 0x4300 | (n ^ 8) is the bf16 of 128 + (n ^ 8), and
// subtracting 136 leaves (n ^ 8) - 8, the signed value, exactly. The bit
// select is one three-input logic operation: (v ^ 8) under the nibble mask,
// the constant elsewhere.
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  constexpr uint32_t MASK = 0x000F000Fu, BITS = 0x43084308u;
  const uint32_t biased = (MASK & (v ^ BITS)) | (~MASK & BITS);
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// ---------------------------------------------------------------- bf16 path

constexpr int WCONSUMERS = 256;  // two warpgroups: one for each nibble plane
constexpr int WTHREADS = WCONSUMERS + 128;  // plus the producer's warpgroup
constexpr int WBN = 64;         // packed rows per block: wgmma's 64 rows, in both planes
constexpr int WKC = 128;        // staged columns per chunk: two 64-column swizzled tiles of x
constexpr int WSTAGES = 5;      // chunks of x and packed bytes in flight
constexpr int WPACKED = WBN * WKC;  // bytes of a staged packed tile

constexpr size_t wgmma_smem_bytes(int nt) {
  return (size_t)WSTAGES * (nt * WKC * sizeof(bf16) + WPACKED) + 1024;  // + alignment slack
}

template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  if constexpr (NT == 128) sa::wgmma_m64n128k16_rs(d, a, desc_b, accumulate);
  else if constexpr (NT == 64) sa::wgmma_m64n64k16_rs(d, a, desc_b, accumulate);
  else sa::wgmma_m64n16k16_rs(d, a, desc_b, accumulate);
}

// y^T = W . x^T for one (64 packed rows, NT tokens, split of the groups)
// tile. Warpgroup 0 makes the low-nibble plane (outputs p0 ..), warpgroup 1
// the high-nibble plane (outputs half + p0 ..), both from the one staged copy
// of the packed bytes and of x; one lane of warpgroup 2 fetches the chunks.
// Thread t of a consumer warpgroup (w = t / 32, g = t % 32 / 4, q = t % 4)
// owns packed rows 16 w + g and + 8 and tokens 8 j + 2 q, + 1. map_x: x as
// (M, K) bf16 in boxes of NT rows x 64 columns; map_w: w4 as (half, K) bytes
// in boxes of 64 rows x 128 bytes; both with the 128-byte swizzle and zero
// fill past the edges. grid: (row tiles, token tiles, splits). With one split
// the block rounds and writes `out`; with more it writes its fp32 partial to
// ws[split][token][out]. FULL: the group is 128 columns, a whole chunk (the
// usual case); otherwise any multiple of 16, with the group ends checked step
// by step.
template <int NT, bool FULL>
__global__ void __launch_bounds__(WTHREADS, 1)
    int4_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      const float* __restrict__ scale, bf16* __restrict__ out,
                      float* __restrict__ ws, int M, int half, int G, int gs) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * WSTAGES];  // per stage: chunk arrived, chunk free
  constexpr int XHALF = NT * 128;        // bytes of one swizzled NT x 64 tile of x
  constexpr int XSTAGE = 2 * XHALF;
  constexpr int NACC = NT / 2;
  const uint32_t xs = (sa::smem_u32(smem_raw) + 1023u) & ~1023u;  // [WSTAGES][2][NT][128 B]
  const uint32_t ps = xs + WSTAGES * XSTAGE;                      // [WSTAGES][WBN][128 B]
  const unsigned char* ps_gen = smem_raw + (ps - sa::smem_u32(smem_raw));
  const uint32_t full = sa::smem_u32(&bars[0]), empty = sa::smem_u32(&bars[WSTAGES]);
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * WBN, m0 = blockIdx.y * NT;
  const int splits = gridDim.z, split = blockIdx.z;
  // this block's groups: [g_begin, g_end), every group in exactly one split
  const int g_begin = (int)((long long)split * G / splits);
  const int g_end = (int)((long long)(split + 1) * G / splits);
  const int k_begin = g_begin * gs, k_end = g_end * gs;
  const int nchunks = (k_end - k_begin + WKC - 1) / WKC;

  if (tid == 0) {
    for (int st = 0; st < WSTAGES; ++st) {
      sa::mbar_init(full + 8 * st, 1);
      sa::mbar_init(empty + 8 * st, WCONSUMERS);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  // Three warpgroups are compiled for 168 registers a thread and the
  // consumers need about 216: the producer's warpgroup (a whole one, so that
  // what it hands back covers it) drops to 24 and each consumer takes 232.
  if (tid >= WCONSUMERS) {
    // ---- producer: one lane keeps WSTAGES chunks in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != WCONSUMERS) return;
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % WSTAGES, k0 = k_begin + c * WKC;
      // the first pass over the ring finds every stage free
      sa::mbar_wait(empty + 8 * st, ((c / WSTAGES) & 1) ^ 1);
      const uint32_t bar = full + 8 * st;
      sa::mbar_arrive_expect_tx(bar, XSTAGE + WPACKED);
      sa::tma_load_2d(xs + st * XSTAGE, &map_x, bar, k0, m0);
      sa::tma_load_2d(xs + st * XSTAGE + XHALF, &map_x, bar, k0 + 64, m0);
      sa::tma_load_2d(ps + st * WPACKED, &map_w, bar, k0, p0);
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int plane = tid >> 7, warp = (tid >> 5) & 3;  // warpgroup, warp within it
  const int g = lane >> 2, q = lane & 3;
  const int steps_per_group = gs / 16;
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.f;

  // this thread's scales of group gi: rows g and g + 8 of its plane
  auto load_scales = [&](int gi, float (&sc)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p0 + warp * 16 + g + 8 * h;
      sc[h] = row < half ? __ldg(scale + (size_t)(plane * half + row) * G + gi) : 0.f;
    }
  };
  // This thread's bytes of the chunk: rows 16 w + g and + 8, 2-byte pairs 2 q
  // and 2 q + 8 of each 16-byte piece; piece ks of a row lies at piece
  // ks ^ (row % 8) = ks ^ g (the swizzle). All of a chunk's loads go out
  // first: the asm statements of a step keep the compiler from moving a later
  // step's loads above them, and a load's latency in every step was most of a
  // chunk's time before its products ran.
  auto load_packed = [&](const unsigned char* prow, uint32_t (&a)[WKC / 16][4]) {
#pragma unroll
    for (int ks = 0; ks < WKC / 16; ++ks) {
      const unsigned char* piece = prow + ((ks ^ g) << 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[ks][i] = *reinterpret_cast<const uint16_t*>(piece + (i & 1) * 8 * WKC + (i >> 1) * 8);
    }
  };
  // One 16-column step: sign-extend the step's nibbles of this plane in place
  // into the A fragment (a0/a2 from row g, a1/a3 from row g + 8) and start the
  // product on the x tile.
  auto step = [&](uint32_t xd, int ks, uint32_t (&a)[4], int accumulate) {
#pragma unroll
    for (int i = 0; i < 4; ++i)  // byte 0 | byte 1 << 16, the plane's nibbles moved to the bottom
      a[i] = nibbles_to_bf16x2(__byte_perm(a[i], 0u, 0x4140) >> (4 * plane));
    const uint64_t desc = sa::wgmma_desc(xd + (ks >> 2) * XHALF + (ks & 3) * 32, 16, 1024);
    sa::wgmma_fence();
    wgmma_rs<NT>(part, a, desc, accumulate);
    sa::wgmma_commit();
  };
  auto add_scaled = [&](const float (&sc)[2]) {  // acc += partial * scale
    sa::pin_regs(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i] * sc[(i >> 1) & 1];
  };

  int gi = g_begin, in_group = 0;  // the current group and the steps done in it
  float sc[2] = {0.f, 0.f};
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % WSTAGES;
    if (FULL) load_scales(gi, sc);  // under the wait for the chunk
    sa::mbar_wait(full + 8 * st, (c / WSTAGES) & 1);
    const unsigned char* prow = ps_gen + st * WPACKED + (warp * 16 + g) * WKC + 2 * q;
    const uint32_t xd = xs + st * XSTAGE;
    uint32_t a[WKC / 16][4];  // a step's fragment stays put while its product runs
    load_packed(prow, a);
    sa::pin_regs(part);
    if (FULL) {  // a chunk is a group: eight steps in flight, one wait
#pragma unroll
      for (int ks = 0; ks < WKC / 16; ++ks) step(xd, ks, a[ks], ks > 0);
    } else {
      const int steps = min(WKC, k_end - (k_begin + c * WKC)) / 16;
#pragma unroll
      for (int ks = 0; ks < WKC / 16; ++ks) {
        if (ks < steps) {
          if (in_group == 0) load_scales(gi, sc);
          step(xd, ks, a[ks], in_group > 0);
          if (++in_group == steps_per_group) {
            sa::wgmma_wait<0>();
            add_scaled(sc);
            in_group = 0;
            ++gi;
          }
        }
      }
    }
    // nothing may still read this stage or the fragments when the loop turns
    sa::wgmma_wait<0>();
    sa::mbar_arrive(empty + 8 * st);  // the stage may be refilled
    if (FULL) {
      add_scaled(sc);
      ++gi;
    } else {
      sa::pin_regs(part);
    }
  }

  const int n_out = 2 * half;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int row = p0 + warp * 16 + g + 8 * ((i >> 1) & 1);
    const int t = m0 + 8 * (i >> 2) + 2 * q + (i & 1);
    if (row >= half || t >= M) continue;
    const size_t at = (size_t)t * n_out + plane * half + row;
    if (splits == 1) out[at] = __float2bfloat16(acc[i]);
    else ws[(size_t)split * M * n_out + at] = acc[i];
  }
}

// out = round(sum over the splits, in order, of ws[split]): n elements, n even
__global__ void int4_reduce_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
                                   size_t n, int splits) {
  const size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 sum = *reinterpret_cast<const float2*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(ws + (size_t)s * n + i);
    sum.x += v.x;
    sum.y += v.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(sum.x, sum.y);
}

template <int NT>
int launch_wgmma(const void* x, const uint8_t* w4, const float* scale, void* out, float* ws,
                 int M, int K, int half, int G, int splits, cudaStream_t stream) {
  CUtensorMap map_x, map_w;
  const uint64_t x_dims[4] = {(uint64_t)K, (uint64_t)M}, w_dims[4] = {(uint64_t)K, (uint64_t)half};
  const uint32_t x_box[4] = {64, NT}, w_box[4] = {WKC, WBN};
  int err = sa::tensor_map(x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 2, x_dims, x_box, &map_x);
  if (err == 0) err = sa::tensor_map(w4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, w_dims, w_box, &map_w);
  if (err != 0) return err;
  const dim3 grid((half + WBN - 1) / WBN, (M + NT - 1) / NT, splits);
  auto run = [&](auto kernel) {
    return sa::launch(kernel, grid, dim3(WTHREADS), wgmma_smem_bytes(NT), stream, map_x, map_w,
                      scale, (bf16*)out, ws, M, half, G, K / G);
  };
  err = K / G == WKC ? run(int4_wgmma_kernel<NT, true>) : run(int4_wgmma_kernel<NT, false>);
  if (err != 0 || splits == 1) return err;
  const size_t n = (size_t)M * 2 * half;
  int4_reduce_kernel<<<(unsigned)((n / 2 + 255) / 256), 256, 0, stream>>>(ws, (bf16*)out, n,
                                                                         splits);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- fp32 path
//
// y^T = W . x^T on the bf16 tensor cores, exact to fp32's grain: the weights
// are integers in [-7, 7], exact in bf16, so only x needs splitting. A first
// small kernel of the same call writes x as three bf16 planes, x = hi + mid +
// lo (each rounded to nearest; together they hold all 24 bits of an fp32
// significand), and a product of a plane with an int4 weight is exact in
// fp32. Each group's partial is W_g . lo^T + W_g . mid^T + W_g . hi^T,
// smallest first, into one fresh fp32 wgmma accumulator (`part`); the
// tensor cores' fp32 accumulation rounds toward zero, so they never add
// across groups: the partial is scaled and added to the fp32 total with
// ordinary fp32 arithmetic, as in the bf16 body. The precision is fixed
// here; nothing reads torch.backends.cuda.matmul.allow_tf32 or
// cudnn.allow_tf32.
//   Split:    x (M, K) fp32 -> (3, M, K) bf16 planes in a workspace the
//             wrapper allocates, four values a thread. A kernel of its own,
//             not the consumers splitting fp32 tiles in shared memory: an
//             fp32 tile and its three planes in one stage would leave room
//             for two stages, and both consumer warpgroups would meet at a
//             barrier every chunk to split one shared tile. The split reads
//             4 and writes 6 bytes a value once a launch; every block then
//             reads its planes through TMA as the bf16 body reads x.
//   Tiles:    the bf16 body's: 64 packed rows x NT tokens (16 or 64 when
//             they hold M, else 128) x a split of the groups, so split_plan
//             is the same. A stage holds three NT x 128 planes and the 64 x
//             128 packed bytes: 104 KB at NT = 128 (two stages), 56 KB at 64
//             (four), 20 KB at 16 (eight). At 250 tokens 128-token tiles
//             beat 64-token ones by 10% over an fp32 separate's launches
//             (PERF.md): (5504, 2048) fits one wave, not two.
//   Products: a thread sign-extends its nibbles of a step once
//             (nibbles_to_bf16x2) into the A fragment, which then meets the
//             three planes' B tiles: wgmma m64nNTk16 with A from registers,
//             24 a chunk (8 steps x 3 planes), lo first, then mid, then hi.
//   Splits:   fp32 partials of the splits go to a workspace and a second
//             kernel adds them in order: the same bits run to run.
// Bound at (2048, 2048) and 250 tokens: three bf16 products of 2.1 GFLOP,
// 6.4 us at 989 TFLOP/s; over an fp32 separate's 4,640 launches at 250
// tokens, 45.9 ms. What holds it back (PERF.md): it runs at ~2.5x that
// bound: as in bf16 a chunk's copies and products add instead of
// overlapping (one wait for all 24 products a chunk), and every call is
// three launches (split, products, reduce), which at 14 tokens (weight
// bytes, 0.7 us) make most of its ~8 us.

// x = hi + mid + lo, each bf16 rounded to nearest: hi = rn(x), mid = rn(x -
// hi), lo = rn(x - hi - mid). Both differences are exact in fp32, and the
// three planes hold x's 24 significant bits, so the sum is x exactly unless
// mid or lo falls below bf16's smallest normal (then within 2^-134 of x). A
// finite x that would round past bf16's largest takes hi rounded toward
// zero instead, so that the rest still holds it; an infinite or NaN x is hi
// alone.
__device__ __forceinline__ void split_bf16x3(float x, bf16& hi, bf16& mid, bf16& lo) {
  const bool finite = isfinite(x);
  hi = __float2bfloat16_rn(x);
  if (finite && (__bfloat16_as_ushort(hi) & 0x7FFFu) == 0x7F80u) hi = __float2bfloat16_rz(x);
  const float r1 = finite ? x - __bfloat162float(hi) : 0.f;
  mid = __float2bfloat16_rn(r1);
  lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
}

__device__ __forceinline__ uint32_t pack2(bf16 a, bf16 b) {
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

// planes[0], [1], [2] = hi, mid, lo of the n values of x (n a multiple of 4,
// four a thread)
__global__ void int4_split_kernel(const float* __restrict__ x, bf16* __restrict__ planes,
                                  size_t n) {
  const size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  const float4 v = *reinterpret_cast<const float4*>(x + i);
  bf16 p[3][4];
  split_bf16x3(v.x, p[0][0], p[1][0], p[2][0]);
  split_bf16x3(v.y, p[0][1], p[1][1], p[2][1]);
  split_bf16x3(v.z, p[0][2], p[1][2], p[2][2]);
  split_bf16x3(v.w, p[0][3], p[1][3], p[2][3]);
#pragma unroll
  for (int pl = 0; pl < 3; ++pl)
    *reinterpret_cast<uint2*>(planes + pl * n + i) =
        make_uint2(pack2(p[pl][0], p[pl][1]), pack2(p[pl][2], p[pl][3]));
}

__host__ __device__ constexpr int fp32_stages(int nt) { return nt == 16 ? 8 : nt == 64 ? 4 : 2; }

__host__ __device__ constexpr size_t fp32_smem_bytes(int nt) {
  return (size_t)fp32_stages(nt) * (3 * nt * WKC * sizeof(bf16) + WPACKED) +
         1024;  // + alignment slack
}

// One (64 packed rows, NT tokens, split of the groups) tile, as the bf16
// kernel's: warpgroup 0 makes the low-nibble plane, warpgroup 1 the high, one
// lane of warpgroup 2 fetches the chunks. map_x3: the (3, M, K) bf16 planes
// as a 4-D map (K, M, 3, 1) in boxes of 64 columns x NT rows of one plane;
// map_w as in the bf16 kernel; both 128-byte swizzled with zero fill. Output
// fp32: with one split the block writes `out`, with more its partial goes to
// ws[split][token][out].
template <int NT, bool FULL>
__global__ void __launch_bounds__(WTHREADS, 1)
    int4_wgmma_fp32_kernel(const __grid_constant__ CUtensorMap map_x3,
                           const __grid_constant__ CUtensorMap map_w,
                           const float* __restrict__ scale, float* __restrict__ out,
                           float* __restrict__ ws, int M, int half, int G, int gs) {
  constexpr int STAGES = fp32_stages(NT);
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t bars[2 * STAGES];  // per stage: chunk arrived, chunk free
  constexpr int XHALF = NT * 128;        // bytes of one swizzled NT x 64 tile of a plane
  constexpr int XPLANE = 2 * XHALF;      // a plane's NT x 128 chunk
  constexpr int XSTAGE = 3 * XPLANE;     // hi, mid, lo
  constexpr int NACC = NT / 2;
  const uint32_t xs = (sa::smem_u32(smem_raw) + 1023u) & ~1023u;  // [STAGES][3][2][NT][128 B]
  const uint32_t ps = xs + STAGES * XSTAGE;                       // [STAGES][WBN][128 B]
  const unsigned char* ps_gen = smem_raw + (ps - sa::smem_u32(smem_raw));
  const uint32_t full = sa::smem_u32(&bars[0]), empty = sa::smem_u32(&bars[STAGES]);
  const int tid = threadIdx.x, lane = tid & 31;
  const int p0 = blockIdx.x * WBN, m0 = blockIdx.y * NT;
  const int splits = gridDim.z, split = blockIdx.z;
  const int g_begin = (int)((long long)split * G / splits);
  const int g_end = (int)((long long)(split + 1) * G / splits);
  const int k_begin = g_begin * gs, k_end = g_end * gs;
  const int nchunks = (k_end - k_begin + WKC - 1) / WKC;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      sa::mbar_init(full + 8 * st, 1);
      sa::mbar_init(empty + 8 * st, WCONSUMERS);
    }
    sa::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= WCONSUMERS) {
    // ---- producer: one lane keeps STAGES chunks in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid != WCONSUMERS) return;
    for (int c = 0; c < nchunks; ++c) {
      const int st = c % STAGES, k0 = k_begin + c * WKC;
      sa::mbar_wait(empty + 8 * st, ((c / STAGES) & 1) ^ 1);
      const uint32_t bar = full + 8 * st, xd = xs + st * XSTAGE;
      sa::mbar_arrive_expect_tx(bar, XSTAGE + WPACKED);
      for (int pl = 0; pl < 3; ++pl) {
        sa::tma_load_4d(xd + pl * XPLANE, &map_x3, bar, k0, m0, pl, 0);
        sa::tma_load_4d(xd + pl * XPLANE + XHALF, &map_x3, bar, k0 + 64, m0, pl, 0);
      }
      sa::tma_load_2d(ps + st * WPACKED, &map_w, bar, k0, p0);
    }
    return;
  }

  // ---- consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int plane = tid >> 7, warp = (tid >> 5) & 3;  // nibble plane, warp within it
  const int g = lane >> 2, q = lane & 3;
  const int steps_per_group = gs / 16;
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = part[i] = 0.f;

  auto load_scales = [&](int gi, float (&sc)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p0 + warp * 16 + g + 8 * h;
      sc[h] = row < half ? __ldg(scale + (size_t)(plane * half + row) * G + gi) : 0.f;
    }
  };
  // this thread's bytes of the chunk, as in the bf16 kernel
  auto load_packed = [&](const unsigned char* prow, uint32_t (&a)[WKC / 16][4]) {
#pragma unroll
    for (int ks = 0; ks < WKC / 16; ++ks) {
      const unsigned char* piece = prow + ((ks ^ g) << 4);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[ks][i] = *reinterpret_cast<const uint16_t*>(piece + (i & 1) * 8 * WKC + (i >> 1) * 8);
    }
  };
  // the step's nibbles of this thread's plane, sign-extended in place into
  // the A fragment
  auto unpack = [&](uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = nibbles_to_bf16x2(__byte_perm(a[i], 0u, 0x4140) >> (4 * plane));
  };
  // start part (+)= W . x^T of step ks on x plane xp (0 hi, 1 mid, 2 lo)
  auto product = [&](uint32_t xd, int xp, int ks, const uint32_t (&a)[4], int accumulate) {
    const uint64_t desc =
        sa::wgmma_desc(xd + xp * XPLANE + (ks >> 2) * XHALF + (ks & 3) * 32, 16, 1024);
    sa::wgmma_fence();
    wgmma_rs<NT>(part, a, desc, accumulate);
    sa::wgmma_commit();
  };
  auto add_scaled = [&](const float (&sc)[2]) {  // acc += partial * scale
    sa::pin_regs(part);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] += part[i] * sc[(i >> 1) & 1];
  };

  int gi = g_begin, in_group = 0;  // the current group and the steps done in it
  float sc[2] = {0.f, 0.f};
  for (int c = 0; c < nchunks; ++c) {
    const int st = c % STAGES;
    if (FULL) load_scales(gi, sc);  // under the wait for the chunk
    sa::mbar_wait(full + 8 * st, (c / STAGES) & 1);
    const unsigned char* prow = ps_gen + st * WPACKED + (warp * 16 + g) * WKC + 2 * q;
    const uint32_t xd = xs + st * XSTAGE;
    uint32_t a[WKC / 16][4];  // a step's fragment stays put while its products run
    load_packed(prow, a);
    sa::pin_regs(part);
    if (FULL) {  // a chunk is a group: 24 products in flight, one wait
#pragma unroll
      for (int ks = 0; ks < WKC / 16; ++ks) {
        unpack(a[ks]);
        product(xd, 2, ks, a[ks], ks > 0);
      }
#pragma unroll
      for (int xp = 1; xp >= 0; --xp)
#pragma unroll
        for (int ks = 0; ks < WKC / 16; ++ks) product(xd, xp, ks, a[ks], 1);
    } else {
      // the chunk's steps in runs that lie in one group each: lo, mid, hi
      // over a run, then the group's end scales the partial
      const int steps = min(WKC, k_end - (k_begin + c * WKC)) / 16;
      for (int s0 = 0; s0 < steps;) {
        const int s1 = min(steps, s0 + steps_per_group - in_group);
        if (in_group == 0) load_scales(gi, sc);
#pragma unroll
        for (int ks = 0; ks < WKC / 16; ++ks)
          if (ks >= s0 && ks < s1) {
            unpack(a[ks]);
            product(xd, 2, ks, a[ks], in_group > 0 || ks > s0);
          }
#pragma unroll
        for (int xp = 1; xp >= 0; --xp)
#pragma unroll
          for (int ks = 0; ks < WKC / 16; ++ks)
            if (ks >= s0 && ks < s1) product(xd, xp, ks, a[ks], 1);
        in_group += s1 - s0;
        if (in_group == steps_per_group) {
          sa::wgmma_wait<0>();
          add_scaled(sc);
          in_group = 0;
          ++gi;
        }
        s0 = s1;
      }
    }
    // nothing may still read this stage or the fragments when the loop turns
    sa::wgmma_wait<0>();
    sa::mbar_arrive(empty + 8 * st);  // the stage may be refilled
    if (FULL) {
      add_scaled(sc);
      ++gi;
    } else {
      sa::pin_regs(part);
    }
  }

  const int n_out = 2 * half;
#pragma unroll
  for (int i = 0; i < NACC; ++i) {
    const int row = p0 + warp * 16 + g + 8 * ((i >> 1) & 1);
    const int t = m0 + 8 * (i >> 2) + 2 * q + (i & 1);
    if (row >= half || t >= M) continue;
    const size_t at = (size_t)t * n_out + plane * half + row;
    if (splits == 1) out[at] = acc[i];
    else ws[(size_t)split * M * n_out + at] = acc[i];
  }
}

// out = sum over the splits, in order, of ws[split]: n elements, n even
__global__ void int4_reduce_fp32_kernel(const float* __restrict__ ws, float* __restrict__ out,
                                        size_t n, int splits) {
  const size_t i = 2 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 sum = *reinterpret_cast<const float2*>(ws + i);
  for (int s = 1; s < splits; ++s) {
    const float2 v = *reinterpret_cast<const float2*>(ws + (size_t)s * n + i);
    sum.x += v.x;
    sum.y += v.y;
  }
  *reinterpret_cast<float2*>(out + i) = sum;
}

template <int NT>
int launch_wgmma_fp32(const float* x, bf16* x3, const uint8_t* w4, const float* scale,
                      float* out, float* ws, int M, int K, int half, int G, int splits,
                      cudaStream_t stream) {
  const size_t n = (size_t)M * K;  // a multiple of 16: so is K
  int4_split_kernel<<<(unsigned)((n / 4 + 255) / 256), 256, 0, stream>>>(x, x3, n);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  CUtensorMap map_x3, map_w;
  const uint64_t x_dims[4] = {(uint64_t)K, (uint64_t)M, 3, 1};
  const uint64_t w_dims[4] = {(uint64_t)K, (uint64_t)half};
  const uint32_t x_box[4] = {64, NT, 1, 1}, w_box[4] = {WKC, WBN};
  err = sa::tensor_map(x3, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, 4, x_dims, x_box, &map_x3);
  if (err == 0) err = sa::tensor_map(w4, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 2, w_dims, w_box, &map_w);
  if (err != 0) return err;
  const dim3 grid((half + WBN - 1) / WBN, (M + NT - 1) / NT, splits);
  auto run = [&](auto kernel) {
    return sa::launch(kernel, grid, dim3(WTHREADS), fp32_smem_bytes(NT), stream, map_x3, map_w,
                      scale, out, ws, M, half, G, K / G);
  };
  err = K / G == WKC ? run(int4_wgmma_fp32_kernel<NT, true>)
                     : run(int4_wgmma_fp32_kernel<NT, false>);
  if (err != 0 || splits == 1) return err;
  const size_t n_out = (size_t)M * 2 * half;
  int4_reduce_fp32_kernel<<<(unsigned)((n_out / 2 + 255) / 256), 256, 0, stream>>>(
      ws, out, n_out, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) in the compute dtype (0 = float32, 1 = bfloat16), 16-byte aligned;
// w4: (half, K) uint8, 16-byte aligned; scale: (2*half, G) float32;
// out: (M, 2*half) in x's dtype. K/G (the group) must be a multiple of 16.
// `splits` blocks share the groups of one output tile (the wrapper chooses
// it, counting 64 packed rows and 16, 64 or 128 tokens (the least that holds
// M, else 128) a tile, in either dtype); with splits > 1, ws is an fp32
// workspace of splits * M * 2*half elements. fp32 only: x3 is a bf16
// workspace of 3 * M * K elements for the planes of x.
extern "C" int sa_matmul_int4(const void* x, const uint8_t* w4, const float* scale, void* out,
                              void* ws, void* x3, int M, int K, int half, int G, int splits,
                              int dtype, void* stream) {
  if (M < 1 || half < 1 || G < 1 || K % G != 0 || (K / G) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || splits > G || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    if (M <= 16)
      return launch_wgmma<16>(x, w4, scale, out, (float*)ws, M, K, half, G, splits, s);
    if (M <= 64)
      return launch_wgmma<64>(x, w4, scale, out, (float*)ws, M, K, half, G, splits, s);
    return launch_wgmma<128>(x, w4, scale, out, (float*)ws, M, K, half, G, splits, s);
  }
  if (x3 == nullptr) return (int)cudaErrorInvalidValue;
  const float* xf = (const float*)x;
  if (M <= 16)
    return launch_wgmma_fp32<16>(xf, (bf16*)x3, w4, scale, (float*)out, (float*)ws, M, K, half,
                                 G, splits, s);
  if (M <= 64)
    return launch_wgmma_fp32<64>(xf, (bf16*)x3, w4, scale, (float*)out, (float*)ws, M, K, half,
                                 G, splits, s);
  return launch_wgmma_fp32<128>(xf, (bf16*)x3, w4, scale, (float*)out, (float*)ws, M, K, half, G,
                                splits, s);
}
