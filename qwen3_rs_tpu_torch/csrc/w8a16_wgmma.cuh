// Tensor-core W8A16 product for Hopper (sm_90a), shared by the fused kernel's tensor-core route
// (csrc/qmatmul_w8a16.cu, windows of 9 to 256 rows) and the row-blocked kernel
// (csrc/qmatmul_rows.cu, windows of more than 256 rows):
//   out[m, c] = sum_k x[m, k] * bf16(code[k, c] * bf16(scale[k / g, c])), summed in f32.
//
// Bound on the H100: the weight bytes (one per code, half a byte for INT4) up to ~128 rows,
// the bf16 tensor-core operations (2 * rows * N * D at 989 TFLOP/s) past that.  Design:
//  * the operands are swapped: a warpgroup computes out^T = W^T . x^T with wgmma m64nNk16, the
//    output columns on the 64-row M side and the window's rows on the N side (64, 128 or 256),
//    so one tile holds every row of a window of up to 256 rows and streams each weight byte
//    once for all of them;
//  * W^T is the A operand, built in registers: a consumer thread reads its codes from the
//    stage's code tile and dequantizes them (the exponent trick, then bf16(code * scale)) straight
//    into wgmma's A fragment, so the bf16 weight tile exists in neither shared nor device memory.
//    Fragment row 16 w + r + 8 h of warp w in m-tile mt holds output column
//    2 MT (8 w + r) + 2 mt + h of its warpgroup's 64 MT: a thread's codes are 2 MT adjacent bytes
//    of a code row and its results 2 MT adjacent floats of an output row;
//  * x^T is the B operand: x's tile (N rows by 64 contraction slots, bf16, K-major, 128-byte
//    swizzle) as TMA writes it and wgmma reads it;
//  * a ring of stages in shared memory, filled by TMA from one thread of a producer warpgroup
//    (an x box and the code boxes, 128-byte swizzle: a thread's four code rows of a k-step fall
//    in four different bank groups), drained by two consumer warpgroups; one mbarrier per stage
//    counts the bytes in, another the consumer warps out.  The producer gives its registers to
//    the consumers (setmaxnreg 40 / 232): with the 168 of an even split, ptxas serializes the
//    256-row tile's wgmma for want of registers;
//  * a consumer dequantizes a whole k-tile into the A fragments of its four k-steps, then issues
//    their wgmma as one group, and reads the next k-tile's codes while the group runs: no
//    instruction but wgmma defines a wgmma's registers while one is in flight (ptxas would
//    serialize them), and the other consumer warpgroup's wgmma can run while one dequantizes;
//  * a persistent grid walks the tiles (column strip, row tile, contraction split) row tiles
//    first, so the blocks at work share a strip's codes in L2, and the producer loads the next
//    tile while the consumers store the last;
//  * INT4 (nibble-packed [N/2, D], group split-half): a k-tile is 32 packed rows; slot s < 32 is
//    the low nibble of packed row s, slot s >= 32 the high nibble of packed row s - 32.  x is
//    staged in that slot order (stage_x_kernel), which is x's own order where g == 64;
//  * scales: where g % 64 == 0 a k-tile lies in one group and a thread loads its 2 MT scales once
//    per k-tile; any other g loads them per code row (right first, slower).
// Each output element sums its k-tiles in k order whatever the column window: a window equals
// those columns of the full product bit for bit.  The tensor cores' f32 sums round toward zero.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: two libraries of the port include this header, and a function-local
// static of an inline function would otherwise be one object across both (and so would the
// "attribute set" state of launch()).
namespace tc {
namespace {

constexpr int kConsumerWarps = 8;                    // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and a producer warpgroup
constexpr int kSlots = 64;                           // contraction slots of a k-tile
constexpr int kSmemBudget = 200 * 1024;              // for the ring of stages

// The tile of a wgmma row count N (the window's rows per tile) and MT m-tiles per warpgroup.
template <int N, int MT, bool Q4>
struct Tile {
  static constexpr int BD = 2 * 64 * MT;       // output columns of a tile
  static constexpr int KR = Q4 ? 32 : 64;      // code rows of a k-tile
  static constexpr int X_BYTES = N * 128;      // x: N rows of 64 bf16
  static constexpr int C_BYTES = BD * KR;      // codes: BD / 128 boxes of KR rows of 128 bytes
  static constexpr int STAGE = X_BYTES + C_BYTES;
  static constexpr int STAGES = kSmemBudget / STAGE < 8 ? kSmemBudget / STAGE : 8;
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + mbarriers, alignment
  static_assert(X_BYTES % 1024 == 0 && C_BYTES % 1024 == 0, "stages keep the swizzle's alignment");
};

// One launch's arguments besides the two tensor maps.
struct Args {
  const __nv_bfloat16* scales;  // the layer's [G, ldw] scales, moved to the window's first column
  int ldw, groups, g;           // weight columns (row stride), groups, group size
  int M, D;                     // output rows and columns (the window's); out's row stride is D
  int c0;                       // the window's first weight column
  int n_strips, n_row_tiles, splits, kts, k_tiles;  // tiles; k-tiles per split and in all
  float* out;                   // [M, D], or [splits, M, D] partials where splits > 1
  const void* residual;         // [M, D] f32 or bf16 (res_bf16), added where splits == 1
  int res_bf16;
};

struct TileIdx {
  int strip, rt, split, k0, k1;
};

__device__ __forceinline__ TileIdx tile_of(int tile, const Args& a) {
  TileIdx t;
  t.rt = tile % a.n_row_tiles;
  const int r = tile / a.n_row_tiles;
  t.split = r % a.splits;
  t.strip = r / a.splits;
  t.k0 = t.split * a.kts;
  t.k1 = min(a.k_tiles, t.k0 + a.kts);
  return t;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// A 2-D TMA load of the box at (c0, c1) (innermost coordinate first), counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma's descriptor of a K-major bf16 tile with 128-byte swizzle: rows of 128 bytes, 8-row
// groups 1024 bytes apart.  The k-step s (16 slots, 32 bytes) adds 2 s to it.
__device__ __forceinline__ uint64_t x_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of the accumulators across the asynchronous wgmma.
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Byte k (0..3) of `biased` as a float: an int8 code xor 0x80 (Q4 = false) or a biased INT4
// code (code + 8, Q4 = true), exactly (0x4B0000xx is 2^23 + xx).
template <bool Q4>
__device__ __forceinline__ float code_byte(uint32_t biased, int k) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | k)) -
         (Q4 ? 8388616.0f : 8388736.0f);
}

// bf16(code_a * sa) | bf16(code_b * sb) << 16: two weights of one column at adjacent slots.
template <bool Q4>
__device__ __forceinline__ uint32_t deq_pair(uint32_t wa, uint32_t wb, int k, float sa, float sb) {
  const __nv_bfloat162 v =
      __floats2bfloat162_rn(code_byte<Q4>(wa, k) * sa, code_byte<Q4>(wb, k) * sb);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The C scales of group grp at column col (window-relative), as f32; zeros past the window.
template <int C>
__device__ __forceinline__ void load_group_scales(const Args& a, int grp, int col, bool ok,
                                                  float (&s)[C]) {
  if (!ok) {
#pragma unroll
    for (int i = 0; i < C; ++i) s[i] = 0.f;
    return;
  }
  const __nv_bfloat16* p = a.scales + (long)min(grp, a.groups - 1) * a.ldw + col;
  if constexpr (C == 4) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    s[0] = lo.x, s[1] = lo.y, s[2] = hi.x, s[3] = hi.y;
  } else {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(p));
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    s[0] = f.x, s[1] = f.y;
  }
}

template <int N, int MT, bool Q4, bool Uniform>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
                const Args a) {
  using T = Tile<N, MT, Q4>;
  constexpr int CW = 2 * MT;  // output columns of a thread
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024-byte grid
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_tiles = a.n_strips * a.n_row_tiles * a.splits;

  if (warp >= kConsumerWarps) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const TileIdx ti = tile_of(tile, a);
        for (int kt = ti.k0; kt < ti.k1; ++kt) {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          const uint32_t bar = smem_u32(&full[stage]);
          mbar_expect_tx(bar, T::STAGE);
          uint8_t* st = smem + stage * T::STAGE;
          tma_load_2d(smem_u32(st), &xmap, bar, kt * kSlots, ti.rt * N);
#pragma unroll
          for (int b = 0; b < T::BD / 128; ++b)
            tma_load_2d(smem_u32(st + T::X_BYTES + b * T::KR * 128), &cmap, bar,
                        a.c0 + ti.strip * T::BD + b * 128, kt * T::KR);
          if (++stage == T::STAGES) stage = 0, phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2, wi = warp & 3, r8 = lane >> 2, t4 = lane & 3;
  const int col_in_tile = wg * 64 * MT + (wi * 8 + r8) * CW;
  const int cbox = col_in_tile / 128, cbyte = col_in_tile % 128;  // the thread's code bytes
  constexpr int KW = Q4 ? 2 : 4;  // code rows are read for k-steps 0..KW-1 (INT4: both nibbles)
  const int h = a.g / 2;
  float acc[MT][N / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
  uint32_t frag[4][MT][4];  // the A fragments of a k-tile's four k-steps
  uint32_t kw[KW][4];       // the thread's code words of a k-tile
  float su[CW];             // its scales, where a k-tile lies in one group
  int stage = 0;
  uint32_t phase = 0;
  // Waits for the stage's k-tile kt and reads the thread's code rows 16 s + 2 t4 + {0, 1, 8, 9}
  // of each k-step s, under the 128-byte swizzle (and, with Uniform, the k-tile's scales).
  auto fetch = [&](int st, uint32_t ph, int kt, int col, bool col_ok) {
    if constexpr (Uniform) load_group_scales<CW>(a, Q4 ? kt * 32 / h : kt * kSlots / a.g, col, col_ok, su);
    mbar_wait(smem_u32(&full[st]), ph);
    const uint8_t* ct = smem + st * T::STAGE + T::X_BYTES + cbox * T::KR * 128;
#pragma unroll
    for (int s = 0; s < KW; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = 16 * s + 2 * t4 + (r & 1) + 8 * (r >> 1);
        const uint8_t* p = ct + kr * 128 + ((((cbyte >> 4) ^ (kr & 7)) << 4) | (cbyte & 15));
        const uint32_t v = MT == 2 ? *reinterpret_cast<const uint32_t*>(p)
                                   : *reinterpret_cast<const uint16_t*>(p);
        kw[s][r] = Q4 ? v : v ^ 0x80808080u;
      }
  };
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const TileIdx ti = tile_of(tile, a);
    const int col = ti.strip * T::BD + col_in_tile;  // the thread's first column in the window
    const bool col_ok = col < a.D;
    fetch(stage, phase, ti.k0, col, col_ok);
    for (int kt = ti.k0; kt < ti.k1; ++kt) {
      // The A fragments of all four k-steps first: no instruction but wgmma may define a
      // wgmma's registers while one is in flight, or ptxas serializes them.
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t w[4];
        float sr[4][CW];  // the scales of the step's four code rows
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if constexpr (Q4) w[r] = (kw[s & 1][r] >> (4 * (s >> 1))) & 0x0F0F0F0Fu;
          else w[r] = kw[s][r];
          if constexpr (Uniform) {
#pragma unroll
            for (int c = 0; c < CW; ++c) sr[r][c] = su[c];
          } else {
            const int kr = 16 * (s & (KW - 1)) + 2 * t4 + (r & 1) + 8 * (r >> 1);
            load_group_scales<CW>(a, Q4 ? (kt * 32 + kr) / h : (kt * kSlots + kr) / a.g, col, col_ok,
                                  sr[r]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int c = 2 * mt;  // fragment rows r8 (c) and r8 + 8 (c + 1)
          frag[s][mt][0] = deq_pair<Q4>(w[0], w[1], c, sr[0][c], sr[1][c]);
          frag[s][mt][1] = deq_pair<Q4>(w[0], w[1], c + 1, sr[0][c + 1], sr[1][c + 1]);
          frag[s][mt][2] = deq_pair<Q4>(w[2], w[3], c, sr[2][c], sr[3][c]);
          frag[s][mt][3] = deq_pair<Q4>(w[2], w[3], c + 1, sr[2][c + 1], sr[3][c + 1]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          wgmma_rs(acc[mt], frag[s][mt], x_desc(smem_u32(smem + stage * T::STAGE)) + 2 * s,
                   kt != ti.k0 || s != 0);
      wg_commit();
      // While the tensor cores work, fetch the next k-tile's codes (the other warpgroup
      // dequantizes meanwhile).
      const int next = stage + 1 == T::STAGES ? 0 : stage + 1;
      const uint32_t next_phase = next == 0 ? phase ^ 1 : phase;
      if (kt + 1 < ti.k1) fetch(next, next_phase, kt + 1, col, col_ok);
      wg_wait<0>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[stage]));
      stage = next, phase = next_phase;
    }

    // Row m = 8 j + 2 t4 + e of the tile, columns col .. col + CW - 1.
    float* dst = a.out + (a.splits > 1 ? (long)ti.split * a.M * a.D : 0L);
    const bool add_res = a.residual != nullptr && a.splits == 1;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = ti.rt * N + 8 * j + 2 * t4 + e;
        if (m >= a.M || !col_ok) continue;
        float v[CW];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          v[2 * mt] = acc[mt][4 * j + e];
          v[2 * mt + 1] = acc[mt][4 * j + 2 + e];
        }
        const long o = (long)m * a.D + col;
        if (add_res) {
#pragma unroll
          for (int c = 0; c < CW; ++c)
            v[c] += a.res_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.residual)[o + c])
                               : reinterpret_cast<const float*>(a.residual)[o + c];
        }
        if constexpr (CW == 4)
          *reinterpret_cast<float4*>(dst + o) = make_float4(v[0], v[1], v[2], v[3]);
        else
          *reinterpret_cast<float2*>(dst + o) = make_float2(v[0], v[1]);
      }
  }
}

// Slots [1024 blockIdx.y, 1024 blockIdx.y + 1024) of row blockIdx.x of the activation as bf16
// in slot order, kp slots (a multiple of 64; slots past the weight's rows are 0): INT8 slot s is
// in-row s; INT4 slot 64 i + j is the in-row of packed row 32 i + j % 32, low nibble for j < 32,
// high for j >= 32.  The prologue (0 none, 1 RMSNorm with norm_w, 2 SwiGLU of x = gate|up) runs
// in f32 and rounds once to bf16, as the fused kernel's; every block of a row sums its squares
// over the whole row, in the fused kernel's order.
constexpr int kStageSlots = 1024;

__global__ void __launch_bounds__(256)
stage_x_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ norm_w,
               int prologue, float eps, int n, int g, int q4, int kp,
               __nv_bfloat16* __restrict__ xs) {
  __shared__ float red[8];
  __shared__ float inv_s;
  const int row = blockIdx.x, tid = threadIdx.x;
  const long base = (long)row * (prologue == 2 ? 2L * n : (long)n);
  auto act = [&](long i) {
    return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                  : reinterpret_cast<const float*>(x)[i];
  };
  if (prologue == 1) {  // inv = rsqrt(mean(x^2) + eps)
    float ss = 0.f;
#pragma unroll 8
    for (int i = tid; i < n; i += 256) {
      const float v = act(base + i);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += red[w];
      inv_s = rsqrtf(t / (float)n + eps);
    }
    __syncthreads();
  }
  const int hg = g / 2;
#pragma unroll
  for (int j = 0; j < kStageSlots / 256; ++j) {
    const int s = blockIdx.y * kStageSlots + j * 256 + tid;
    if (s >= kp) break;
    int in = s;
    if (q4) {
      const int p = (s / 64) * 32 + (s & 31);
      in = 2 * p < n ? (p / hg) * g + p % hg + ((s >> 5) & 1) * hg : n;
    }
    float v = 0.f;
    if (in < n) {
      v = act(base + in);
      if (prologue == 2) {
        const float up = act(base + n + in);
        v = v * (1.f / (1.f + expf(-v))) * up;
      } else if (prologue == 1) {
        v = v * inv_s * norm_w[in];
      }
    }
    xs[(long)row * kp + s] = __float2bfloat16_rn(v);
  }
}

// The staging pass over M rows of kp slots.
inline void stage_x(cudaStream_t s, const void* x, int x_bf16, const float* norm_w, int prologue,
                    float eps, int M, int n, int g, int q4, int kp, __nv_bfloat16* xs) {
  stage_x_kernel<<<dim3(M, (kp + kStageSlots - 1) / kStageSlots), 256, 0, s>>>(
      x, x_bf16, norm_w, prologue, eps, n, g, q4, kp, xs);
}

// ---------------------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, found through the runtime (no link against libcuda).
inline EncodeTiled encode_tiled() {
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

// A map over a row-major [rows, cols] array (row_bytes apart) with boxes of box_cols x box_rows
// and 128-byte swizzle; a box past the array's end reads zeros.  Returns 0, or the negated
// driver error minus one.
inline int make_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t cols,
                    uint64_t rows, uint64_t row_bytes, uint32_t box_cols, uint32_t box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

// The maps of x (or its staged copy) [M, kp] bf16 and of the layer's codes [code rows, ldw].
inline int make_maps(CUtensorMap* xm, CUtensorMap* cm, const void* x, int M, int kp, int n_rows,
                     const void* codes, int code_rows, int ldw, bool q4) {
  const int e = make_map(xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, kp, M, 2ull * kp, kSlots, n_rows);
  if (e) return e;
  return make_map(cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, ldw, code_rows, ldw, 128, q4 ? 32 : 64);
}

template <int N, int MT, bool Q4, bool Uniform>
int launch(const CUtensorMap& xm, const CUtensorMap& cm, const Args& a, cudaStream_t s) {
  using T = Tile<N, MT, Q4>;
  auto* kernel = w8a16_tc_kernel<N, MT, Q4, Uniform>;
  static int slots = 0;  // resident blocks on the card, set with the attribute once per instance
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    slots = sms * per_sm;
  }
  const int tiles = a.n_strips * a.n_row_tiles * a.splits;
  kernel<<<tiles < slots ? tiles : slots, kThreads, T::SMEM, s>>>(xm, cm, a);
  return 0;
}

// The instance for row tile N (MT = 2 up to 128 rows, 1 at 256), the code format and the group.
template <int N>
int launch_for(bool q4, bool uniform, const CUtensorMap& xm, const CUtensorMap& cm, const Args& a,
               cudaStream_t s) {
  constexpr int MT = N <= 128 ? 2 : 1;
  if (q4) return uniform ? launch<N, MT, true, true>(xm, cm, a, s) : launch<N, MT, true, false>(xm, cm, a, s);
  return uniform ? launch<N, MT, false, true>(xm, cm, a, s) : launch<N, MT, false, false>(xm, cm, a, s);
}

// Output columns of a tile for row tile N.
__host__ __device__ constexpr int tile_cols(int n) { return n <= 128 ? 256 : 128; }

}  // namespace
}  // namespace tc
