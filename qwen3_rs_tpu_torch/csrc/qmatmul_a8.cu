// W8A8 row-blocked grouped matmul for Hopper (sm_90a): exact (reference-parity) mode.
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked_rows_a8.
// The layer offset of stacked weights is a pointer offset made by the wrapper.
//
// Numerics, as the Pallas kernel (the reference engine's tensor.rs hot loop): for each group of
// g contraction rows, an int8 x int8 -> int32 dot (exact), then
//     acc = acc + (f32(dot) * w_scale[group, col]) * x_scale[row, group]
// in f32, over the groups in order.  Every multiply and add rounds on its own: __fmul_rn and
// __fadd_rn keep nvcc from contracting them into an FMA, so the kernel and its plain PyTorch
// version agree bit for bit.
//
// Bound on the H100: the larger of 2*M*N*D int8 operations at 1979 TOPS and the per-group f32
// fix-up of every output element, 3 rounded operations, each one instruction, at 128 a clock per
// SM (33.5 * 10^12 a second): the two run on separate pipes and may overlap.  The fix-up is the
// larger at g = 64.
//
// Group sizes up to 128 (the main path: g = 64) take the wgmma kernel (namespace wg):
//  * a conversion for free: each group's int32 partials start at 0x4B400000, the bits of
//    1.5 * 2^23, so that for |dot| <= 2^22 (|dot| <= 2^21 at g <= 128) the sum, read as a float, is
//    exactly 12582912 + dot, and one __fsub_rn gives f32(dot) with the bits __int2float_rn gives;
//  * the operands swapped, as in w8a16_wgmma.cuh: a consumer warpgroup computes 64 output columns
//    for a tile of 128 rows with wgmma m64n64k32 .s8, the weights as its register A operand and
//    x's tile as its K-major B operand, as TMA lands it (128-byte swizzle);
//  * no transpose of the weights: the s8 product wants k contiguous per column, and the weight
//    tile holds n contiguous per k.  ldmatrix.trans reads 8 k rows x 16 columns as b16 pairs; the
//    lanes give it the rows {0,1,4,5,8,9,12,13} and {2,3,6,7,...} of each 16, so that each lane
//    holds k 4t..4t+3 of columns 2g and 2g + 1 in two registers, and two byte permutes make the A
//    fragment rows g (column 2g) and g + 8 (column 2g + 1);
//  * the fix-up overlaps the products: two sets of int32 group partials, one for each half (64
//    rows) of the tile's rows.  Half 0's products of group k run while half 1's fix-up of group
//    k - 1 does, then half 1's products of group k while half 0's fix-up of group k does;
//  * tiles arrive ahead of the tensor cores: a producer warpgroup keeps TMA loads of x tiles
//    [128 rows x 128 k] and weight tiles [128 k x 128 columns] in flight on a ring of 5-6 stages
//    (and bulk copies of the scale rows of every group in the tile: x's transposed to [G, rows]
//    by the wrapper), and gives its registers to the consumers (setmaxnreg 40 / 232).
// Tried on the card and not kept: two full m64n128 sets (192 accumulator registers a thread:
// ptxas holds a block of more than 8 warps to 168 registers, since three warps share a scheduler's
// register file, and spilled; with 8 warps and no producer warpgroup it took 255 and ran slower);
// one set a warpgroup (its products, a wait, its fix-up); the second warpgroup taking each fix-up
// before the products it overlaps, to keep the two half a step apart; mma.sync m16n8k32 on a
// cp.async ring with the fix-up interleaved row block by row block (the products alone ran at
// ~20% of the int8 peak, as the a8_depth probe's mma.sync kernel does).  ptxas inserted a wgmma
// wait (C7517) before the fix-up of half 1 until the explicit wait at the top of the group loop
// told it that nothing is in flight there; removing it did not change the time measurably.
//
// Larger groups (|dot| may pass 2^22) take the mma.sync kernel: mma.sync m16n8k32 s8 -> s32 on
// 128 x 128 output tiles, 8 warps of 64 x 32, the same byte-permute trick on a 4-stage cp.async
// ring (XOR-swizzled rows), and __int2float_rn; the fix-up of each row block is issued right
// before that block's products of the next group, so the f32 work of one block issues while the
// mma.sync of the one before run.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // activation rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction rows per k-tile
constexpr int kThreads = 256;
constexpr int kStages = 4;
constexpr int kScaleSlots = 16;  // scale rows of groups j in slot j % 16
constexpr int kXBytes = BM * BK;    // x tile: 128 rows of 64 bytes
constexpr int kWBytes = BK * BN;    // weight tile: 64 k rows of 128 bytes
constexpr int kStageBytes = kXBytes + kWBytes;
constexpr int kScaleBytes = (BM + BN) * 4;  // one group: x scales of the rows, w scales of the columns
constexpr int kSmem = kStages * kStageBytes + kScaleSlots * kScaleBytes;
constexpr uint32_t kMagic = 0x4B400000u;  // 1.5 * 2^23
constexpr float kMagicF = 12582912.0f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r: the x tile (64-byte rows) and the weight tile (128-byte
// rows), XOR-swizzled so that the 8 rows an ldmatrix phase reads fall on 8 different chunks of the
// banks.  The weight tile's phases read the k rows {0,1,4,5,8,9,12,13} (+2, +16) of a k-step.
__device__ __forceinline__ int x_off(int r, int c) { return r * BK + ((c ^ ((r >> 1) & 3)) << 4); }
__device__ __forceinline__ int w_swz(int r) { return (r & 1) | (((r >> 2) & 3) << 1); }
__device__ __forceinline__ int w_off(int r, int c) { return r * BN + ((c ^ w_swz(r & 15)) << 4); }

// The mma.sync kernel (groups larger than 128).
__global__ void __launch_bounds__(kThreads, 1)
qmatmul_a8_i2f_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs_t,
                  const int8_t* __restrict__ codes, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int m_pad, int N, int D, int g) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* scal = smem + kStages * kStageBytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int groups = N / g, k_tiles = N / BK;
  const int steps = g / 32;  // k-steps a group

  // Issue the copies of k-tile kt into stage kt % kStages, and the scale rows of every group that
  // starts in it; one commit group a call (empty past the last tile).
  auto load_tile = [&](int kt) {
    if (kt < k_tiles) {
      uint8_t* st = smem + (kt % kStages) * kStageBytes;
      const int k0 = kt * BK;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int id = tid + i * kThreads, r = id >> 2, c = id & 3;
        const bool ok = m0 + r < M;
        cp_async16(smem_addr(st + x_off(r, c)), xq + (ok ? (long)(m0 + r) * N + k0 + 16 * c : 0), ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int id = tid + i * kThreads, r = id >> 3, c = id & 7;
        const bool ok = n0 + 16 * c < D;
        cp_async16(smem_addr(st + kXBytes + w_off(r, c)), codes + (ok ? (long)(k0 + r) * D + n0 + 16 * c : 0),
                   ok ? 16 : 0);
      }
      if (tid < 128) {  // 64 chunks of scales a group starting in this tile
        const int j = (k0 + g - 1) / g + (tid >> 6), c = tid & 63;
        if (j * g < k0 + BK && j < groups) {
          uint8_t* sl = scal + (j % kScaleSlots) * kScaleBytes;
          if (c < 32) {
            const bool ok = m0 + 4 * c < m_pad;
            cp_async16(smem_addr(sl + 16 * c), xs_t + (ok ? (long)j * m_pad + m0 + 4 * c : 0), ok ? 16 : 0);
          } else {
            const int cc = c - 32;
            const bool ok = n0 + 4 * cc < D;
            cp_async16(smem_addr(sl + BM * 4 + 16 * cc), ws + (ok ? (long)j * D + n0 + 4 * cc : 0), ok ? 16 : 0);
          }
        }
      }
    }
    cp_commit();
  };

  float acc[4][4][4];
  int part[4][4][4];  // the int32 partials of the group in flight
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // acc = acc + (f32(dot) * w_scale) * x_scale for group grp from its partials p, the rows of
  // row block mi.  Lane (gq, tq) holds rows wm + 16 mi + gq (+ 8) and columns wn + 16 q + 4 tq ..
  // + 3: n-tile ni = 2 q + e holds the even (e = 0) or odd (e = 1) columns of the 16, c0 -> column
  // 4 tq + e, c1 -> 4 tq + 2 + e.  wsv: the group's w scales of the lane's 8 columns.
  auto fixup_rows = [&](const int (&p)[4][4][4], const float* sl, const float (&wsv)[2][4], int mi) {
    const float xs0 = sl[wm + 16 * mi + gq], xs1 = sl[wm + 16 * mi + gq + 8];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int v = p[mi][ni][e];
        const float t = __fmul_rn(__int2float_rn(v), wsv[ni >> 1][2 * (e & 1) + (ni & 1)]);
        acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], __fmul_rn(t, (e >> 1) ? xs1 : xs0));
      }
  };
  auto scales_of = [&](int grp, float (&wsv)[2][4]) {
    const float* sl = reinterpret_cast<const float*>(scal + (grp % kScaleSlots) * kScaleBytes);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 w4 = *reinterpret_cast<const float4*>(sl + BM + wn + 16 * q + 4 * tq);
      wsv[q][0] = w4.x; wsv[q][1] = w4.y; wsv[q][2] = w4.z; wsv[q][3] = w4.w;
    }
    return sl;
  };
  auto fixup = [&](const int (&p)[4][4][4], int grp) {
    float wsv[2][4];
    const float* sl = scales_of(grp, wsv);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) fixup_rows(p, sl, wsv, mi);
  };

  // One 32-deep k-step of the k-tile in stage `st` into the partials p.  The first k-step of a
  // group (fix_grp >= 0: the group before it, finished in p) takes row block by row block: the
  // fix-up of row block mi, its partials restarted, then its products of the new group, so that
  // the warp issues the f32 work of row block mi + 1 while the mma.sync of row block mi run.
  auto kstep = [&](const uint8_t* st, int ks, int (&p)[4][4][4], int fix_grp, bool first) {
    uint32_t b[4][2];
    {
      // Lane's row of the 4 matrices: k rows {0,1,4,5,8,9,12,13} (+2 for odd matrices, +16 for
      // the upper two), columns wn + 16 q .. + 15.
      const int mi = lane >> 3, j = lane & 7;
      const int r = ks * 32 + 16 * (mi >> 1) + 2 * (mi & 1) + ((j & 1) | ((j >> 1) << 2));
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        uint32_t w[4];
        ldsm_x4_trans(smem_addr(st + kXBytes + w_off(r, (wn >> 4) + q)), w);
        b[2 * q][0] = __byte_perm(w[0], w[1], 0x6420);      // even column 2g, k 4t .. 4t + 3
        b[2 * q + 1][0] = __byte_perm(w[0], w[1], 0x7531);  // odd column 2g + 1
        b[2 * q][1] = __byte_perm(w[2], w[3], 0x6420);      // k 16 + 4t ..
        b[2 * q + 1][1] = __byte_perm(w[2], w[3], 0x7531);
      }
    }
    float wsv[2][4];
    const float* sl = fix_grp >= 0 ? scales_of(fix_grp, wsv) : nullptr;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      uint32_t a[4];
      const int r = wm + 16 * mi + (lane & 15);
      ldsm_x4(smem_addr(st + x_off(r, 2 * ks + (lane >> 4))), a);
      if (fix_grp >= 0) fixup_rows(p, sl, wsv, mi);
      if (first)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) p[mi][ni][e] = 0;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) mma_s8(p[mi][ni], a, b[ni][0], b[ni][1]);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_tile(s);

  // k-steps in order; group grp's fix-up is issued in the first k-step of group grp + 1.
  int kt_loaded = -1;  // the k-tile whose stage the block last waited for
  auto step = [&](int k_step, int fix_grp, bool first) {
    const int kt = k_step >> 1;
    if (kt != kt_loaded) {
      cp_wait<kStages - 2>();
      __syncthreads();  // the tile has landed for every thread; the stage of kt - 1 is free
      load_tile(kt + kStages - 1);
      kt_loaded = kt;
    }
    kstep(smem + (kt % kStages) * kStageBytes, k_step & 1, part, fix_grp, first);
  };
  for (int grp = 0; grp < groups; ++grp)
    for (int s = 0; s < steps; ++s) step(grp * steps + s, s == 0 ? grp - 1 : -1, s == 0);
  fixup(part, groups - 1);
  cp_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int row = m0 + wm + 16 * mi + gq;
      const int col = n0 + wn + 16 * q + 4 * tq;
      if (col < D) {
        const float* e0 = acc[mi][2 * q];
        const float* e1 = acc[mi][2 * q + 1];
        if (row < M)
          *reinterpret_cast<float4*>(out + (long)row * D + col) = make_float4(e0[0], e1[0], e0[1], e1[1]);
        if (row + 8 < M)
          *reinterpret_cast<float4*>(out + (long)(row + 8) * D + col) = make_float4(e0[2], e1[2], e0[3], e1[3]);
      }
    }
  }
}

// ------------------------------------------------------------------ the wgmma kernel (g <= 128)
namespace wg {

constexpr int kWarps = 8;                    // two consumer warpgroups
constexpr int kThreads = kWarps * 32 + 128;  // and a producer warpgroup
constexpr int BM = 128;  // x rows a tile (wgmma's N)
constexpr int BD = 128;  // output columns a tile (64 a consumer warpgroup: wgmma's M)
constexpr int BK = 128;  // contraction rows a k-tile: one 128-byte swizzled row of x
constexpr int kX = BM * BK, kW = BK * BD;
constexpr int kScaleBytes = (BM + BD) * 4;  // a group's x scales of the rows, w scales of the columns

template <int GPT>  // groups a k-tile: 128 / g
struct Ring {
  static constexpr int kStage = (kX + kW + GPT * kScaleBytes + 1023) / 1024 * 1024;
  static constexpr int kStages = 200 * 1024 / kStage < 6 ? 200 * 1024 / kStage : 6;
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 + 1024;  // + mbarriers, alignment
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma's descriptor of x's K-major tile with 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart.  The k-step s (32 bytes) adds 2 s to it.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keeps the compiler from moving accesses of the accumulators across the asynchronous wgmma.
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d += A . B over 32 k: A the 64 x 32 int8 fragment in registers, B 64 rows x 32 k of x's tile.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "n"(1));
}

// One launch's pointers and sizes besides the two tensor maps.
struct Args {
  const float *xs_t, *ws;  // [G, m_pad] and [G, D] f32
  float* out;              // [M, D]
  int M, m_pad, D, groups, k_tiles;
};

// GPT: groups a k-tile (128 / g: 1, 2 or 4).
template <int GPT>
__global__ void __launch_bounds__(kThreads, 1)
a8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap, const Args a) {
  using R = Ring<GPT>;
  constexpr int kSteps = 4 / GPT;  // 32-deep k-steps a group
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024-byte grid
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kStages * R::kStage);
  uint64_t* empty = full + R::kStages;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BD;
  // The producer's k-tile kt into stage kt % kStages: x's box, the weight box, the tile's groups'
  // scale rows.
  auto issue = [&](int kt) {
    const int stage = kt % R::kStages;
    const int g0 = kt * GPT, ng = min(GPT, a.groups - g0);
    const int xs_bytes = min(BM, a.m_pad - m0) * 4, ws_bytes = min(BD, a.D - n0) * 4;
    const uint32_t bar = smem_addr(&full[stage]);
    mbar_expect_tx(bar, kX + kW + ng * (xs_bytes + ws_bytes));
    const uint32_t st = smem_addr(smem + stage * R::kStage);
    tma_load_2d(st, &xmap, bar, kt * BK, m0);
    tma_load_2d(st + kX, &wmap, bar, n0, kt * BK);
    for (int j = 0; j < ng; ++j) {
      bulk_copy(st + kX + kW + j * kScaleBytes, a.xs_t + (long)(g0 + j) * a.m_pad + m0, xs_bytes, bar);
      bulk_copy(st + kX + kW + j * kScaleBytes + BM * 4, a.ws + (long)(g0 + j) * a.D + n0, ws_bytes, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(smem_addr(&full[s]), 1);
      mbar_init(smem_addr(&empty[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= kWarps) {  // the producer: one thread issues every load as stages free up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kWarps && lane == 0)
      for (int kt = 0; kt < a.k_tiles; ++kt) {
        mbar_wait(smem_addr(&empty[kt % R::kStages]), ((kt / R::kStages) & 1) ^ 1);
        issue(kt);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // Warp wi of warpgroup wgi holds fragment rows 16 wi + gq (output column c = 64 wgi + 16 wi + 2 gq,
  // even) and 16 wi + gq + 8 (column c + 1); of x's rows, half h (rows 64 h ..) in its partials
  // ph and acc[32 h ..]: rows 64 h + 8 j + 2 tq (+ 1) for j < 8.
  const int wgi = warp >> 2, wi = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int c_loc = 64 * wgi + 16 * wi + 2 * gq, chunk = 4 * wgi + wi;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int p0[32], p1[32];  // the group partials of the two halves of x's rows

  // The A fragments of group grp's k-steps, from the weight tile (k rows {0,1,4,5,8,9,12,13} and
  // +2 of each 16 read as b16 pairs by ldmatrix.trans, two byte permutes to k 4t .. 4t + 3 of the
  // even and the odd column).
  auto frags_of = [&](const uint8_t* wt, int gi, uint32_t (&fr)[kSteps][4]) {
    const int mi = lane >> 3, j = lane & 7;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int r = 32 * (gi * kSteps + s) + 16 * (mi >> 1) + 2 * (mi & 1) + ((j & 1) | ((j >> 1) << 2));
      uint32_t w[4];
      ldsm_x4_trans(smem_addr(wt + r * BD + ((chunk ^ (r & 7)) << 4)), w);
      fr[s][0] = __byte_perm(w[0], w[1], 0x6420);
      fr[s][1] = __byte_perm(w[0], w[1], 0x7531);
      fr[s][2] = __byte_perm(w[2], w[3], 0x6420);
      fr[s][3] = __byte_perm(w[2], w[3], 0x7531);
    }
  };
  // acc = acc + (f32(dot) * w_scale) * x_scale for group grp, half h, from its partials p.
  auto fixup = [&](const int (&p)[32], int grp, int h) {
    const float* sl = reinterpret_cast<const float*>(smem + (grp / GPT % R::kStages) * R::kStage + kX + kW +
                                                     (grp % GPT) * kScaleBytes);
    const float we = sl[BM + c_loc], wo = sl[BM + c_loc + 1];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 xv = *reinterpret_cast<const float2*>(sl + 64 * h + 8 * j + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = __fsub_rn(__int_as_float(p[4 * j + e]), kMagicF);
        const float t = __fmul_rn(d, (e & 2) ? wo : we);
        acc[32 * h + 4 * j + e] = __fadd_rn(acc[32 * h + 4 * j + e], __fmul_rn(t, (e & 1) ? xv.y : xv.x));
      }
    }
  };
  // The products of group grp for half h into p: in flight on return.
  auto products = [&](const uint8_t* st, int gi, const uint32_t (&fr)[kSteps][4], int (&p)[32], int h) {
#pragma unroll
    for (int i = 0; i < 32; ++i) p[i] = (int)kMagic;
    fence_acc(p);
    wg_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) wgmma_s8(p, fr[s], x_desc(smem_addr(st + 64 * h * BK)) + 2 * (gi * kSteps + s));
    wg_commit();
  };
  // Group grp: half 0's products while half 1's fix-up of group grp - 1 runs (then its k-tile is
  // free when grp - 1 was the tile's last group), half 1's products while half 0's fix-up runs.
  for (int grp = 0; grp < a.groups; ++grp) {
    // Nothing is in flight here; said to ptxas, which does not carry the last iteration's wait
    // across the loop and would otherwise wait for half 0's products before half 1's fix-up.
    wg_wait0();
    fence_acc(p1);
    const int kt = grp / GPT, gi = grp % GPT, stage = kt % R::kStages;
    if (gi == 0) mbar_wait(smem_addr(&full[stage]), (kt / R::kStages) & 1);
    const uint8_t* st = smem + stage * R::kStage;
    uint32_t fr[kSteps][4];
    frags_of(st + kX, gi, fr);
    products(st, gi, fr, p0, 0);
    if (grp > 0) {
      fixup(p1, grp - 1, 1);
      const int pk = (grp - 1) / GPT;
      if (pk != kt) {  // grp - 1 was its k-tile's last group: the stage is free
        __syncwarp();
        if (lane == 0) mbar_arrive(smem_addr(&empty[pk % R::kStages]));
      }
    }
    wg_wait0();
    fence_acc(p0);
    products(st, gi, fr, p1, 1);
    fixup(p0, grp, 0);
    wg_wait0();
    fence_acc(p1);
  }
  fixup(p1, a.groups - 1, 1);

  const int col = n0 + c_loc;
  if (col < a.D) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = m0 + 64 * h + 8 * j + 2 * tq + e, i = 32 * h + 4 * j;
          if (row < a.M)
            *reinterpret_cast<float2*>(a.out + (long)row * a.D + col) = make_float2(acc[i + e], acc[i + 2 + e]);
        }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point query (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, cols] uint8 matrix (row stride `cols` bytes) in boxes of 128 x 128 with the 128-byte
// swizzle; a box past the matrix reads zeros.  Returns 0, or the negated CUresult minus one.
int byte_map(CUtensorMap* map, const void* p, int rows, int cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(p), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

template <int GPT>
int launch(const void* xq, const void* xs_t, const void* codes, const void* ws, void* out, int M, int m_pad, int N,
           int D, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  int e = byte_map(&xmap, xq, M, N);
  if (e) return e;
  e = byte_map(&wmap, codes, N, D);
  if (e) return e;
  const void* fn = reinterpret_cast<const void*>(&a8_wgmma_kernel<GPT>);
  const cudaError_t r = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<GPT>::kSmem);
  if (r != cudaSuccess) return (int)r;  // set at every launch: it holds for the current device only
  const Args a{reinterpret_cast<const float*>(xs_t), reinterpret_cast<const float*>(ws), reinterpret_cast<float*>(out),
               M, m_pad, D, N / (128 / GPT), (N + BK - 1) / BK};
  a8_wgmma_kernel<GPT><<<dim3((M + BM - 1) / BM, (D + BD - 1) / BD), kThreads, Ring<GPT>::kSmem, s>>>(
      xmap, wmap, a);
  return (int)cudaGetLastError();
}

}  // namespace wg

int launch_i2f(const void* xq, const void* xs_t, const void* codes, const void* ws, void* out, int M, int m_pad,
               int N, int D, int g, cudaStream_t s) {
  const void* fn = reinterpret_cast<const void*>(&qmatmul_a8_i2f_kernel);
  const cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BM - 1) / BM, (D + BN - 1) / BN);
  qmatmul_a8_i2f_kernel<<<grid, kThreads, kSmem, s>>>(
      reinterpret_cast<const int8_t*>(xq), reinterpret_cast<const float*>(xs_t),
      reinterpret_cast<const int8_t*>(codes), reinterpret_cast<const float*>(ws), reinterpret_cast<float*>(out),
      M, m_pad, N, D, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point.  xq [M, N] int8, xs_t [N/g, m_pad] f32 (the activation scales transposed,
// zero past M, m_pad a multiple of 4), codes [N, D] int8 and ws [N/g, D] f32 are device pointers
// (codes/ws already offset to the layer); out [M, D] f32.  The wrapper guarantees N % 64 == 0,
// g % 32 == 0, D % 16 == 0 and 16-byte aligned pointers.  Returns a cudaError_t.
extern "C" int qmatmul_w8a8_rows(const void* xq, const void* xs_t, const void* codes, const void* ws,
                                 void* out, int M, int m_pad, int N, int D, int g, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (N % BK || g % 32 || D % 16 || m_pad % 4 || m_pad < M) return (int)cudaErrorInvalidValue;
  switch (g) {
    case 32: return wg::launch<4>(xq, xs_t, codes, ws, out, M, m_pad, N, D, s);
    case 64: return wg::launch<2>(xq, xs_t, codes, ws, out, M, m_pad, N, D, s);
    case 128: return wg::launch<1>(xq, xs_t, codes, ws, out, M, m_pad, N, D, s);
    default: return launch_i2f(xq, xs_t, codes, ws, out, M, m_pad, N, D, g, s);  // |dot| may pass 2^22
  }
}
