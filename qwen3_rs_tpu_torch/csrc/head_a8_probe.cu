// The classifier's compute path for Hopper (sm_90a): B activation rows times resident int8
// weight tiles [TN, TD] with 64-row groups of f32 scales, three ways, swept many times.
//
// Replaces the Pallas kernel of scripts/head_a8_probe.py:99 (`make_kernel`: VMEM-resident
// tiles, no DMA, the compute path of the decode head alone).  Output o[b, d] sums, over
// `sweeps` sweeps of tile t = sweep % n_tiles, one of
//   deq-dot (0): x . bf16(bf16(code) * bf16(scale))               x bf16, f32 sums
//   i8-seg  (1): sum over groups of f32(xq . code) * scale * xs    int8 dots, int32 per group
//   i8-seg2 (2): sum over groups of f32(xq . code) * scale         (x-scale folded beforehand)
// as the JAX body sums its tile sweeps into o_ref.  The int8 dots are exact; the f32 fixups are
// the JAX body's, products in the same order; only the f32 sums run in another order.
//
// Bound on the H100: once the tiles sit in shared memory the sweeps read nothing from device
// memory, so the probe measures the compute path: deq-dot's dequantization (5 instructions a
// pair of codes: a byte permute, two logic ops, two bf16x2 FMAs) at 33.5e12 instructions a
// second, 0.47 us a [4096 x 1536] tile, above its bf16 products; the int arms' products at the
// int8 peak and their fixups (a conversion and 3 f32 operations, or 2 for i8-seg2, an output,
// group and row).  A launch also reads each tile once from device memory.
// Design (the unit of work: 16 weight columns by one 64-row group of one tile):
//  * every SM works: the units, in (tile, 16-column tile, group) order, are cut into as many
//    equal contiguous ranges as the card has SMs (more only where shared memory runs out), one a
//    block (head_a8_plan in ops/kernels/probes.py mirrors the cut).  A block stages its range's
//    codes in shared memory once, as [column][64 rows], and keeps them for the whole launch;
//  * the weights on the wide side of the product: a unit is one m16 tile of mma.sync, the
//    columns on m, the B <= 8 activation rows on n8 (rows past B are zeros, no padding to m16).
//    A lane reads its 16 bytes of a column row (rows 16q .. 16q + 15, q = lane % 4) with one
//    conflict-free 16-byte load; the activations are staged once in the matching order (deq-dot:
//    in fragment order; the int arms: xq rows padded to 64 bytes past TN);
//  * deq-dot dequantizes as the row kernel does (deq2_i8, copied from qmatmul_w8a16.cu): a pair
//    of codes into bf16 with no conversion instruction, then one bf16 multiply by the bf16 scale,
//    the pair k, k + 4 of a lane's rows as m16n8k16's k slots 2q, 2q + 1 (the activations follow);
//  * the int arms: the codes as the A operand of m16n8k32 .s8, straight from shared memory; each
//    group's int32 dot starts at 0x4B400000, so one f32 subtraction is its exact conversion
//    (|dot| < 2^22), then the JAX body's fixup;
//  * each warp holds several units (Cfg: deq-dot 8 warps of up to 12, the int arms 16 of up to 6),
//    one accumulator set a unit (deq-dot two), so that no chain of dependent mma sets the pace, a
//    unit's operands loaded while the unit before it computes; the sums stay in registers across
//    the sweeps;
//  * at the end a block sums its units' accumulators in unit order, one partial a (tile, column
//    tile) it touched, and the last block to arrive at a column tile (one counter each, left at
//    zero) sums its partials in (tile, block) order: the result does not depend on scheduling.
// Not built: wgmma (m64n8) would take the same m16 tiles four to a warpgroup, with the deq-dot
// operand from registers as here and the int8 codes by descriptor; at n = 8 it offers the
// products no more than mma.sync does, and the dequantization, not the products, bounds deq-dot.
// Measured on the card and not kept: every unit of a warp unrolled with no condition (ptxas spilled
// under 16 warps' 128 registers), the next sweep's first unit loaded during a sweep's last, and
// deq-dot on 16, 6 or 4 warps (of 6, 16 or 24 units) in place of 8 of 12.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;      // weight columns of a unit: an m16 tile
constexpr int kGroup = 64;     // rows of a unit: one scale group
constexpr int kUnitBytes = kCols * kGroup;
constexpr int kMaxUnits = 96;  // units of a block at most
constexpr int kSmemMax = 226 * 1024;  // of the 227 KB a block may have, 1 KB left to its static part
constexpr int kXqPad = 64;     // bytes past TN of a staged xq row (rows 0 and 1 on other banks)
constexpr uint32_t kMagic = 0x4B400000u;  // 2^23 + 2^22: its float plus an int below 2^22 is exact
constexpr float kMagicF = 12582912.f;

// Warps of a block, units of a warp at most and accumulator sets of a unit, by arm.  deq-dot: 8
// warps of 12 units, two sets (the even and odd k-steps: two chains of dependent mma); on the card
// its dequantization ran faster with each warp's independent units than with more warps.  The int
// arms: 16 warps of 6 units, one set.
template <int V>
struct Cfg {
  static constexpr int kWarps = V == 0 ? 8 : 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kPerWarp = kMaxUnits / kWarps;
  static constexpr int kSets = V == 0 ? 2 : 1;
};

__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The masks of deq2_i8, as registers: with them as immediates ptxas splits each mask-and-or into two
// LOP3s (one immediate an instruction), 4 integer operations a pair of codes where 2 will do.  The
// host passes their values in, so the compiler cannot fold them.
struct Masks {
  uint32_t low7, sign, low7_or, sign_or;  // 0x007F007F, 0x00800080, 0x43004300, 0xC300C300
};

__device__ __forceinline__ uint32_t mask_or(uint32_t p, uint32_t m, uint32_t o) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(p), "r"(m), "r"(o));  // (p & m) | o
  return d;
}

// bf16(code_a * s) | bf16(code_b * s) << 16 for byte k of two words of int8 codes: the byte's
// low 7 bits masked into 0x43nn (128 + nn), its sign into 0xC300 (-128) or 0xC380 (-256), their
// sum the code exactly, then the product rounded once; no conversion instruction.  The row
// kernel's (qmatmul_w8a16.cu), its masks in registers.
__device__ __forceinline__ uint32_t deq2_i8(uint32_t wa, uint32_t wb, int k, uint32_t s, const Masks& mk) {
  const uint32_t p = __byte_perm(wa, wb, k | ((k + 4) << 8));
  const uint32_t t = mask_or(p, mk.low7, mk.low7_or), c = mask_or(p, mk.sign, mk.sign_or);
  return bf16x2_fma(bf16x2_fma(t, 0x3F803F80u, c), s, 0x80008000u);
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(uint32_t* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// The first unit of block i of G over U units, and the block that holds unit u.
__device__ __forceinline__ int range_start(long i, long U, long G) { return (int)(i * U / G); }
__device__ __forceinline__ int block_of(long u, long U, long G) { return (int)(((u + 1) * G - 1) / U); }

struct Geo {
  int B, TN, TD, n_tiles, sweeps, M, C, U;  // M column tiles, C groups a tile, U units
};

// Dynamic shared memory of a block of nu units: the codes, the scales, then the activations.
__host__ __device__ inline int act_bytes(int variant, int TN) {
  return variant == 0 ? (TN / kGroup) * 1024 : 8 * (TN + kXqPad) + (TN / kGroup) * 8 * 4;
}
__host__ __device__ inline int smem_bytes(int variant, int TN, int nu) {
  return nu * (kUnitBytes + kCols * 4) + act_bytes(variant, TN);
}

// A warp's view of its units: its lane's 16 bytes of column row g of its first unit (its unit i is
// 16 units on), the scale of column g, the staged activations.
struct Slots {
  const uint8_t* codes;
  const uint32_t* scl;
  const uint8_t* act;
  int TN, lane;
};

// What one sweep of a unit reads from shared memory: the lane's codes of columns g and g + 8, their
// scales, and its activations (deq-dot: the B fragments of the unit's group; the int arms: 16 xq
// bytes of row g and the x-scales of rows 2q, 2q + 1).
struct Operands {
  uint4 wg, wh, x0, x1;
  uint32_t sg, sh;
  float2 xs;
};

template <int V>
__device__ __forceinline__ Operands load_unit(const Slots& sl, int i, int c) {
  const int g = sl.lane >> 2, q = sl.lane & 3;
  Operands o;
  constexpr int W = Cfg<V>::kWarps;
  o.wg = *reinterpret_cast<const uint4*>(sl.codes + i * W * kUnitBytes);
  o.wh = *reinterpret_cast<const uint4*>(sl.codes + i * W * kUnitBytes + 8 * kGroup);
  o.sg = sl.scl[i * W * kCols];
  o.sh = sl.scl[i * W * kCols + 8];
  if constexpr (V == 0) {
    const uint4* xf = reinterpret_cast<const uint4*>(sl.act) + c * 64 + sl.lane;
    o.x0 = xf[0];
    o.x1 = xf[32];
  } else {
    o.x0 = *reinterpret_cast<const uint4*>(sl.act + g * (sl.TN + kXqPad) + c * kGroup + 16 * q);
    if constexpr (V == 1)
      o.xs = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(sl.act + 8 * (sl.TN + kXqPad)) + c * 8 +
                                              2 * q);
  }
  return o;
}

// One sweep of a unit into its accumulators (deq-dot: the even and odd k-steps into two sets, two
// chains of dependent mma, summed at the end).
template <int V>
__device__ __forceinline__ void sweep_unit(float (&acc)[Cfg<V>::kSets][4], const Operands& o, const Masks& mk) {
  if constexpr (V == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4& xv = j < 2 ? o.x0 : o.x1;
      const uint32_t b0 = j % 2 ? xv.z : xv.x, b1 = j % 2 ? xv.w : xv.y;
      mma_bf16(acc[j % Cfg<V>::kSets], deq2_i8(o.wg.x, o.wg.y, j, o.sg, mk), deq2_i8(o.wh.x, o.wh.y, j, o.sh, mk),
               deq2_i8(o.wg.z, o.wg.w, j, o.sg, mk), deq2_i8(o.wh.z, o.wh.w, j, o.sh, mk), b0, b1);
    }
  } else {
    uint32_t d[4] = {kMagic, kMagic, kMagic, kMagic};
    mma_s8(d, o.wg.x, o.wh.x, o.wg.y, o.wh.y, o.x0.x, o.x0.y);
    mma_s8(d, o.wg.z, o.wh.z, o.wg.w, o.wh.w, o.x0.z, o.x0.w);
    const float sg = __uint_as_float(o.sg), sh = __uint_as_float(o.sh);
    const float df[4] = {__uint_as_float(d[0]) - kMagicF, __uint_as_float(d[1]) - kMagicF,
                         __uint_as_float(d[2]) - kMagicF, __uint_as_float(d[3]) - kMagicF};
    if constexpr (V == 1) {  // (dot * w-scale) * x-scale, then the sum: the JAX body's order
      acc[0][0] = __fadd_rn(acc[0][0], __fmul_rn(__fmul_rn(df[0], sg), o.xs.x));
      acc[0][1] = __fadd_rn(acc[0][1], __fmul_rn(__fmul_rn(df[1], sg), o.xs.y));
      acc[0][2] = __fadd_rn(acc[0][2], __fmul_rn(__fmul_rn(df[2], sh), o.xs.x));
      acc[0][3] = __fadd_rn(acc[0][3], __fmul_rn(__fmul_rn(df[3], sh), o.xs.y));
    } else {
      acc[0][0] = __fadd_rn(acc[0][0], __fmul_rn(df[0], sg));
      acc[0][1] = __fadd_rn(acc[0][1], __fmul_rn(df[1], sg));
      acc[0][2] = __fadd_rn(acc[0][2], __fmul_rn(df[2], sh));
      acc[0][3] = __fadd_rn(acc[0][3], __fmul_rn(df[3], sh));
    }
  }
}

template <int V>
__global__ void __launch_bounds__(Cfg<V>::kThreads, 1)
head_a8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ xq,
               const float* __restrict__ xs, const int8_t* __restrict__ w,
               const float* __restrict__ s, float* __restrict__ out, float* __restrict__ ws,
               int* __restrict__ counters, Geo geo, Masks mk) {
  constexpr int kWarps = Cfg<V>::kWarps, kThreads = Cfg<V>::kThreads, kPerWarp = Cfg<V>::kPerWarp;
  constexpr int kSets = Cfg<V>::kSets;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int merge_list[kMaxUnits / 8 + 2];  // the pairs of a block: at most (nu - 1) / C + 2, C >= 8
  __shared__ int n_merge;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int B = geo.B, TN = geo.TN, TD = geo.TD, M = geo.M, C = geo.C, U = geo.U, G = gridDim.x;
  const int u0 = range_start(blockIdx.x, U, G), u1 = range_start(blockIdx.x + 1, U, G), nu = u1 - u0;
  uint8_t* codes = smem;                                                  // [nu][16 cols][64 rows]
  uint32_t* scl = reinterpret_cast<uint32_t*>(smem + nu * kUnitBytes);    // [nu][16]
  uint8_t* act = smem + nu * (kUnitBytes + kCols * 4);

  // 1. The block's codes, 4 rows by 16 columns an item, transposed by byte permutes; a thread's
  // loads of kBatch items go out before any is stored.
  constexpr int kBatch = 4;
  for (int it0 = tid; it0 < nu * (kGroup / 4); it0 += kBatch * kThreads) {
    uint4 r[kBatch][4];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = it0 + b * kThreads;
      if (it >= nu * (kGroup / 4)) break;
      const int l = it / (kGroup / 4), kq = it % (kGroup / 4), u = u0 + l;
      const int t = u / (M * C), m = u / C % M, c = u % C;
      const int8_t* src = w + ((long)t * TN + c * kGroup + 4 * kq) * TD + m * kCols;
#pragma unroll
      for (int j = 0; j < 4; ++j) r[b][j] = __ldg(reinterpret_cast<const uint4*>(src + (long)j * TD));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = it0 + b * kThreads;
      if (it >= nu * (kGroup / 4)) break;
      uint32_t* dst = reinterpret_cast<uint32_t*>(codes + it / (kGroup / 4) * kUnitBytes) + it % (kGroup / 4);
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        const uint32_t a = (&r[b][0].x)[wi], bb = (&r[b][1].x)[wi], cc = (&r[b][2].x)[wi], d = (&r[b][3].x)[wi];
        const uint32_t ab0 = __byte_perm(a, bb, 0x5140), ab1 = __byte_perm(a, bb, 0x7362);
        const uint32_t cd0 = __byte_perm(cc, d, 0x5140), cd1 = __byte_perm(cc, d, 0x7362);
        dst[(4 * wi + 0) * (kGroup / 4)] = __byte_perm(ab0, cd0, 0x5410);
        dst[(4 * wi + 1) * (kGroup / 4)] = __byte_perm(ab0, cd0, 0x7632);
        dst[(4 * wi + 2) * (kGroup / 4)] = __byte_perm(ab1, cd1, 0x5410);
        dst[(4 * wi + 3) * (kGroup / 4)] = __byte_perm(ab1, cd1, 0x7632);
      }
    }
  }
  // The scales (deq-dot's as bf16 pairs (s, s), the int arms' as f32), kBatch loads in flight.
  for (int it0 = tid; it0 < nu * kCols; it0 += kBatch * kThreads) {
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = min(it0 + b * kThreads, nu * kCols - 1), u = u0 + it / kCols;
      const int t = u / (M * C), m = u / C % M, c = u % C;
      v[b] = __ldg(s + ((long)t * C + c) * TD + m * kCols + it % kCols);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int it = it0 + b * kThreads;
      if (it >= nu * kCols) break;
      const __nv_bfloat16 h = __float2bfloat16_rn(v[b]);
      scl[it] = V == 0 ? pack_bf16(h, h) : __float_as_uint(v[b]);
    }
  }
  // The activations.  deq-dot: group c's B fragments, [c][half][lane] 16 bytes, half h holding the
  // k-steps 2h and 2h + 1 (b0, b1 each): x row g at rows 16q + j, + 4 + j (b0) and + 8 + j,
  // + 12 + j (b1) of the group.  The int arms: xq rows as they are, xs as [group][row].
  if (V == 0) {
    uint4* xf = reinterpret_cast<uint4*>(act);
    for (int it = tid; it < C * 32; it += kThreads) {  // (group c, lane): x row g, rows 16q .. 16q + 15
      const int c = it / 32, ln = it % 32, gr = ln >> 2, qq = ln & 3;
      uint4 raw[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
      if (gr < B) {
        const uint4* xr = reinterpret_cast<const uint4*>(x + (long)gr * TN + c * kGroup + 16 * qq);
        raw[0] = __ldg(xr);
        raw[1] = __ldg(xr + 1);
      }
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(raw);  // rows 16q + 0 .. 15
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * h + jj;
          v[2 * jj] = pack_bf16(e[j], e[4 + j]);
          v[2 * jj + 1] = pack_bf16(e[8 + j], e[12 + j]);
        }
        xf[c * 64 + h * 32 + ln] = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  } else {
    const int stride = TN + kXqPad;
    for (int it = tid; it < 8 * (TN / 16); it += kThreads) {
      const int b = it / (TN / 16), k = it % (TN / 16) * 16;
      *reinterpret_cast<uint4*>(act + b * stride + k) =
          b < B ? __ldg(reinterpret_cast<const uint4*>(xq + (long)b * TN + k)) : make_uint4(0u, 0u, 0u, 0u);
    }
    float* xss = reinterpret_cast<float*>(act + 8 * stride);
    for (int it = tid; it < C * 8; it += kThreads) {
      const int c = it / 8, b = it % 8;
      xss[it] = b < B && V == 1 ? xs[(long)b * C + c] : 0.f;
    }
  }
  __syncthreads();

  // 2. The sweeps.  Warp `warp` takes the block's units warp, warp + 16, ... (`mine` of them); a
  // unit's tile is swept in the sweeps s with s % n_tiles == its tile.  In the sweeps that every
  // unit of the warp takes, each unit's operands are loaded while the unit before it computes.
  const int mine = nu > warp ? (nu - warp + kWarps - 1) / kWarps : 0;
  float acc[kPerWarp][kSets][4] = {};
  int ci[kPerWarp], reps[kPerWarp], lo = mine > 0 ? geo.sweeps : 0, hi = 0;
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    const int u = u0 + warp + kWarps * i, t = u / (M * C);
    ci[i] = u % C;
    reps[i] = (geo.sweeps - t + geo.n_tiles - 1) / geo.n_tiles;
    if (i < mine) lo = min(lo, reps[i]), hi = max(hi, reps[i]);
  }
  const Slots sl = {codes + warp * kUnitBytes + g * kGroup + 16 * q, scl + warp * kCols + g, act, TN, lane};
  for (int r = 0; r < lo; ++r) {
    Operands cur = load_unit<V>(sl, 0, ci[0]);
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i) {
      if (i >= mine) break;
      Operands nxt = cur;
      if (i + 1 < mine) nxt = load_unit<V>(sl, i + 1, ci[i + 1]);
      sweep_unit<V>(acc[i], cur, mk);
      cur = nxt;
    }
  }
  for (int r = lo; r < hi; ++r)  // the units whose tile takes one sweep more
#pragma unroll
    for (int i = 0; i < kPerWarp; ++i)
      if (i < mine && r < reps[i]) sweep_unit<V>(acc[i], load_unit<V>(sl, i, ci[i]), mk);

  // 3. Each unit's sums into shared memory (over its codes), [unit][column][row]: accumulator
  // rows g and g + 8 are columns, its columns 2q and 2q + 1 the activation rows.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < kPerWarp; ++i) {
    if (i >= mine) break;
    float* ru = red + (warp + kWarps * i) * (kCols * 8);
    float a[4] = {acc[i][0][0], acc[i][0][1], acc[i][0][2], acc[i][0][3]};
#pragma unroll
    for (int k = 1; k < kSets; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] += acc[i][k][e];
    *reinterpret_cast<float2*>(ru + g * 8 + 2 * q) = make_float2(a[0], a[1]);
    *reinterpret_cast<float2*>(ru + (g + 8) * 8 + 2 * q) = make_float2(a[2], a[3]);
  }
  if (tid == 0) n_merge = 0;
  __syncthreads();

  // 4. One partial a (tile, column tile) pair p of the block, its units summed in order, to slot
  // blockIdx.x + p (distinct over blocks and pairs); then one arrival a pair at its column tile.
  const int p_first = u0 / C, p_last = (u1 - 1) / C;
  const int per = B * kCols;
  for (int p = p_first; p <= p_last; ++p) {
    const int l0 = max(u0, p * C) - u0, l1 = min(u1, (p + 1) * C) - u0;
    for (int it = tid; it < per; it += kThreads) {
      const int b = it / kCols, n = it % kCols;
      float v = 0.f;
      for (int l = l0; l < l1; ++l) v += red[l * (kCols * 8) + n * 8 + b];
      ws[(long)(blockIdx.x + p) * per + it] = v;
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    for (int p = p_first; p <= p_last; ++p) {
      const int m = p % M;
      int expected = 0;
      for (int t = 0; t < geo.n_tiles; ++t) {
        const long pu = ((long)t * M + m) * C;
        expected += block_of(pu + C - 1, U, G) - block_of(pu, U, G) + 1;
      }
      if (atomicAdd(counters + m, 1) == expected - 1) {
        counters[m] = 0;  // left at zero for the next launch
        merge_list[n_merge++] = m;
      }
    }
  }
  __syncthreads();
  if (n_merge == 0) return;
  __threadfence();

  // 5. The last block of a column tile: its partials in (tile, block) order.
  for (int j = 0; j < n_merge; ++j) {
    const int m = merge_list[j];
    for (int it = tid; it < per; it += kThreads) {
      const int b = it / kCols, n = it % kCols;
      float v = 0.f;
      for (int t = 0; t < geo.n_tiles; ++t) {
        const int p = t * M + m;
        const long pu = (long)p * C;
        const int i0 = block_of(pu, U, G), i1 = block_of(pu + C - 1, U, G);
        for (int i = i0; i <= i1; ++i) v += __ldcg(ws + (long)(i + p) * per + it);
      }
      out[(long)b * TD + m * kCols + n] = v;
    }
  }
}

}  // namespace

// The blocks of a launch: the units cut into equal ranges, one an SM (fewer where there are fewer
// units, more where a range would not fit shared memory); 0 where no block holds TN's activations
// and one unit.  ops/kernels/probes.py:head_a8_plan is the same.
extern "C" int head_a8_grid(int variant, int TN, int TD, int n_tiles, int sms) {
  const long U = (long)n_tiles * (TD / kCols) * (TN / kGroup);
  const int room = (kSmemMax - act_bytes(variant, TN)) / (kUnitBytes + kCols * 4);
  const int cap = room < kMaxUnits ? room : kMaxUnits;
  if (cap < 1) return 0;
  long grid = (U + cap - 1) / cap;
  if (grid < sms) grid = U < sms ? U : sms;
  return (int)grid;
}

// Plain C entry point.  variant 0 (deq-dot), 1 (i8-seg) or 2 (i8-seg2); x bf16 [B, TN], xq int8
// [B, TN], xs f32 [B, TN/64], w int8 [n_tiles, TN, TD], s f32 [n_tiles, TN/64, TD], out f32
// [B, TD], contiguous device pointers (variant 0 reads no xq or xs, variants 1 and 2 no x, 2 no
// xs); ws f32 [(grid + n_tiles * TD/16) * B * 16] scratch; counters int32 [TD/16], zero (left
// zero).  1 <= B <= 8, TN a multiple of 512, TD of 16, grid from head_a8_grid.  Returns
// cudaGetLastError().
extern "C" int head_a8(int variant, const void* x, const void* xq, const void* xs, const void* w,
                       const void* s, void* out, int B, int TN, int TD, int n_tiles, int sweeps,
                       int grid, void* ws, void* counters, void* stream) {
  if (B < 1 || B > 8 || TN < 512 || TN % 512 || TD < kCols || TD % kCols || n_tiles < 1 || sweeps < 1 ||
      variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  Geo geo = {B, TN, TD, n_tiles, sweeps, TD / kCols, TN / kGroup, 0};
  const long U = (long)n_tiles * geo.M * geo.C;
  if (U > (1L << 30) || grid < 1 || grid > U) return (int)cudaErrorInvalidValue;
  geo.U = (int)U;
  const int nu = (int)((U + grid - 1) / grid);  // the longest range
  if (nu > kMaxUnits) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(variant, TN, nu);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* xqb = reinterpret_cast<const int8_t*>(xq);
  const auto* xsf = reinterpret_cast<const float*>(xs);
  const auto* wb = reinterpret_cast<const int8_t*>(w);
  const auto* sf = reinterpret_cast<const float*>(s);
  auto* o = reinterpret_cast<float*>(out);
  auto* wsf = reinterpret_cast<float*>(ws);
  auto* cnt = reinterpret_cast<int*>(counters);
  decltype(&head_a8_kernel<0>) kernel;
  int threads;
  switch (variant) {
    case 0: kernel = head_a8_kernel<0>, threads = Cfg<0>::kThreads; break;
    case 1: kernel = head_a8_kernel<1>, threads = Cfg<1>::kThreads; break;
    default: kernel = head_a8_kernel<2>, threads = Cfg<2>::kThreads; break;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const Masks mk = {0x007F007Fu, 0x00800080u, 0x43004300u, 0xC300C300u};
  kernel<<<grid, threads, smem, st>>>(xb, xqb, xsf, wb, sf, o, wsf, cnt, geo, mk);
  return (int)cudaGetLastError();
}
