// The W8A8-g64 depth question for Hopper (sm_90a): can int8 dots that must be flushed every 64
// rows of depth beat one full-depth bf16 product on this card's tensor cores?
//
// Replaces the Pallas kernel of scripts/a8_depth_probe.py:90 (`make_kernel`: w13 prefill
// shapes, the same tile geometry for three arms, no scale work).  out [M, D] f32 = x [M, K] .
// wt^T, the weights given as wt [D, K] (each output column's weights contiguous along the depth):
//   bf16-full (0): bf16 operands, one f32 accumulator over the whole depth;
//   i8-seg64  (1): int8 operands; a fresh int32 partial for each 64-deep group, converted and
//                  added into the f32 accumulator after the group (no scale multiply, as the JAX
//                  probe omits all scale work);
//   i8-full   (2): the same, flushed every 512 rows of depth (the JAX probe's TILE_N).
// The flush is what a g=64 group forces on this card and what i8-seg64 measures, so it is done
// in full: every output element, every group.  Every partial sum of inputs of |v| <= 20 is an
// integer below 2^24, exact in f32, so both int arms equal their plain versions bit for bit.
//
// Bound on the H100: bf16-full and i8-full 2*M*K*D operations at 989 and 1979 TOPS.  i8-seg64:
// the larger of its int8 products and its flush, 2 instructions (a conversion and an add) per
// output element and group at 33.5 * 10^12 a second, on the CUDA cores beside the tensor cores:
// at 2048 x 4096 x 24576 the two are nearly equal (0.208 and 0.192 ms), so only a kernel that
// overlaps them shows what the card gives.
//
// Design (the usual Hopper shape):
//  * both operands are K-major as given, the layout wgmma takes from shared memory for bf16 and
//    requires for s8: x's tile is the A operand (64 rows a consumer warpgroup), wt's the B operand
//    (the tile's output columns), both through descriptors; no operand goes through registers and
//    nothing is transposed;
//  * a persistent grid, one block an SM, walks 128 x BN output tiles, x's row tiles first, so the
//    blocks at work share wt's tiles in L2 and x stays there; a producer warp keeps TMA loads of
//    128-byte-wide boxes of x and wt in flight on a ring of stages (128-byte swizzle) and gives
//    its registers to the two consumer warpgroups (setmaxnreg 40 / 232); it runs on into the next
//    tile while the consumers store the last.  ptxas holds a block of 12 warps to 168 registers a
//    thread all the same (three warps share a scheduler's registers), which sets the tiles;
//  * bf16-full: BN = 256, wgmma m64n256k16 with f32 accumulators (128 registers), one commit
//    group a 64-deep k-tile, kept in flight while the next k-tile's are issued;
//  * int arms: BN = 128, wgmma m64n128k32 .s32.s8.s8 into int32 partials (64 registers) beside the
//    f32 accumulators (64), two products a 64-deep group, a k-tile 128 deep; the first product of
//    a flush segment starts the partials at zero (wgmma's scale-d), so no other instruction
//    writes them; the flush is __int2float_rn, exact below 2^24, and one __fadd_rn (no FMA
//    contraction);
//  * i8-full runs as bf16-full does: one commit group a k-tile kept in flight, a wait and a flush
//    every four k-tiles, K padded to whole 512-deep segments (the k-tiles past K read zeros);
//  * i8-seg64, one partial set a warpgroup: a group's products, a wait, the flush; the other
//    warpgroup's products run while one flushes;
//  * every product is issued on a path that both warpgroups' warps take alike (a k-tile past K is
//    multiplied like any other): a product behind a condition on the group, or waits that differ
//    between paths, made ptxas serialize the wgmma (C7517/C7518) and ran far slower.
// Tried on the card and not kept (i8-seg64): #8's conversion for free (the partials started at
// the bits of 1.5 * 2^23, one subtract) in place of the conversion instruction, which costs an
// instruction more an element and ran slower; two partial sets of half the columns each, one
// half's flush beside the other half's products (m64n64 products read more shared memory a
// product); two full-width partial sets on tiles of 96 columns (the widest whose sets fit 168
// registers); no producer warpgroup, with thread 0 of a consumer warpgroup issuing the loads:
// 8 warps, each consumer warpgroup with two full partial sets (up to 255 registers a thread), or
// three consumer warpgroups of one set each on 192-row tiles (the loads then wait on the
// consumers); the warpgroups' products put in turn by named barriers, after each other's issue
// or completion.  Each ran slower than the one partial set kept here.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_wgmma.cuh"

namespace {

using tc::fence_acc;
using tc::make_map;
using tc::mbar_arrive;
using tc::mbar_expect_tx;
using tc::mbar_init;
using tc::smem_u32;
using tc::tma_load_2d;
using tc::wg_commit;
using tc::wg_fence;
using tc::wg_wait;
using tc::x_desc;

constexpr int kConsumerWarps = 8;                    // two consumer warpgroups, 64 rows of x each
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and a producer warpgroup
constexpr int BM = 128;                              // x rows of a tile
constexpr int BK = 128;                              // bytes of depth of a k-tile: one swizzled row
constexpr int kGroup = 64;                           // int8 depth of a group: two k32 steps

template <int V>  // 0 bf16-full, 1 i8-seg64, 2 i8-full
struct Tile {
  static constexpr int BN = V == 0 ? 256 : 128;  // output columns (rows of wt)
  static constexpr int X = BM * BK, W = BN * BK, STAGE = X + W;
  static constexpr int STAGES = 200 * 1024 / STAGE;  // 4 (bf16) or 6 (int8)
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + mbarriers, alignment
  static_assert(X % 1024 == 0 && W % 1024 == 0, "stages keep the swizzle's 1024-byte grid");
};

// d += A . B over one k-step: A (64 x k) and B (N x k) in shared memory, both K-major, through
// their descriptors (bf16 k16, N = 256, f32 accumulators; s8 k32, N = 128, s32 partials, zeroed
// first where scale_d is 0).
__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
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
      : "l"(da), "l"(db), "n"(1));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// tc::mbar_wait with a bound: a wait that outlasts 2^34 cycles (about 10 s) traps, a launch error,
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

struct Args {
  float* out;  // [M, D]
  int M, K, D, tiles_m, tiles, k_tiles;  // k_tiles: 128 bytes of depth each, past K zeros
};

// acc[i] += f32(p[i]) for the partials p of a finished flush segment (exact: |p| < 2^24).
template <int N>
__device__ __forceinline__ void flush(float (&acc)[N], int (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(p[i])::"memory");
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], __int2float_rn(p[i]));
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
a8_depth_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap, const Args a) {
  using T = Tile<V>;
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

  if (warp >= kConsumerWarps) {  // the producer: one thread issues every load as stages free up
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
        const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * T::BN;
        for (int kt = 0; kt < a.k_tiles; ++kt, ++it) {
          const int s = it % T::STAGES;
          mbar_wait(smem_u32(&empty[s]), ((it / T::STAGES) & 1) ^ 1);
          const uint32_t bar = smem_u32(&full[s]), st = smem_u32(smem + s * T::STAGE);
          mbar_expect_tx(bar, T::STAGE);
          tma_load_2d(st, &xmap, bar, kt * BK, m0);
          tma_load_2d(st + T::X, &wmap, bar, kt * BK, n0);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  // Accumulator element 4 j + e of the thread: tile row row_l + 8 (e >> 1), column 8 j + col_l + (e & 1).
  const int wg = warp >> 2;
  const int row_l = 64 * wg + 16 * (warp & 3) + (lane >> 2), col_l = 2 * (lane & 3);
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[it % T::STAGES]));
  };
  auto wait_full = [&](int it) { mbar_wait(smem_u32(&full[it % T::STAGES]), (it / T::STAGES) & 1); };
  auto x_of = [&](int it) { return x_desc(smem_u32(smem + (it % T::STAGES) * T::STAGE + 64 * wg * BK)); };
  auto w_of = [&](int it) { return x_desc(smem_u32(smem + (it % T::STAGES) * T::STAGE + T::X)); };

  float acc[T::BN / 2];
  int it = 0;  // k-tiles this block has taken
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    const int m0 = (t % a.tiles_m) * BM, n0 = (t / a.tiles_m) * T::BN;
#pragma unroll
    for (int i = 0; i < T::BN / 2; ++i) acc[i] = 0.f;
    if constexpr (V == 0) {
      // One commit group a k-tile (four k16 steps); k-tile kt - 1's stage is freed once kt's are issued.
      for (int kt = 0; kt < a.k_tiles; ++kt) {
        wait_full(it + kt);
        const uint64_t dx = x_of(it + kt), dw = w_of(it + kt);
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_bf16(acc, dx + 2 * k, dw + 2 * k);
        wg_commit();
        wg_wait<1>();
        if (kt > 0) release(it + kt - 1);
      }
      wg_wait<0>();
      fence_acc(acc);
      release(it + a.k_tiles - 1);
    } else if constexpr (V == 2) {
      // i8-full: one commit group a k-tile, kept in flight while the next is issued, as
      // bf16-full; a flush every four k-tiles (512 rows), K padded to a multiple of 512.  The
      // first product of a segment starts its partials at zero (wgmma's scale-d).
      int p[T::BN / 2];
      for (int kt0 = 0; kt0 < a.k_tiles; kt0 += 4) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kt = it + kt0 + j;
          wait_full(kt);
          const uint64_t dx = x_of(kt), dw = w_of(kt);
          wg_fence();
#pragma unroll
          for (int k = 0; k < 4; ++k) wgmma_s8(p, dx + 2 * k, dw + 2 * k, j > 0 || k > 0);
          wg_commit();
          wg_wait<1>();
          if (j > 0) release(kt - 1);
        }
        wg_wait<0>();
        release(it + kt0 + 3);
        flush(acc, p);
      }
    } else {
      // i8-seg64, one partial set: a group's products, a wait, its flush; the other warpgroup's
      // products run while this one flushes.
      int p[T::BN / 2];
      for (int kt = 0; kt < a.k_tiles; ++kt) {
        wait_full(it + kt);
        const uint64_t dx = x_of(it + kt), dw = w_of(it + kt);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wg_fence();
          wgmma_s8(p, dx + 4 * h, dw + 4 * h, 0);
          wgmma_s8(p, dx + 4 * h + 2, dw + 4 * h + 2, 1);
          wg_commit();
          wg_wait<0>();
          flush(acc, p);
        }
        release(it + kt);
      }
    }
    it += a.k_tiles;

    float* o0 = a.out + (long)(m0 + row_l) * a.D;
    float* o1 = o0 + 8L * a.D;
#pragma unroll
    for (int j = 0; j < T::BN / 8; ++j) {
      const int c = n0 + 8 * j + col_l;
      if (c < a.D) {
        *reinterpret_cast<float2*>(o0 + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(o1 + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// K's k-tiles as the kernel walks them: bf16 64 deep, the int arms 128 deep, i8-full padded to
// whole 512-deep flush segments (the k-tiles past K read zeros, which add nothing).
__host__ inline int k_tiles_of(int V, int K) {
  return V == 0 ? K / 64 : V == 1 ? (K + 127) / 128 : (K + 511) / 512 * 4;
}

template <int V>
int launch(const void* x, const void* w, void* out, int M, int K, int D, cudaStream_t s) {
  using T = Tile<V>;
  const uint64_t row_bytes = (uint64_t)K * (V != 0 ? 1 : 2);
  CUtensorMap xm, wm;
  int e = make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, row_bytes, M, row_bytes, BK, BM);
  if (e) return e;
  e = make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, row_bytes, D, row_bytes, BK, T::BN);
  if (e) return e;
  auto* kernel = a8_depth_kernel<V>;
  int dev = 0, sms = 0;
  cudaError_t r = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (r == cudaSuccess) r = cudaGetDevice(&dev);
  if (r == cudaSuccess) r = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (r != cudaSuccess) return (int)r;
  const int tiles_m = M / BM, tiles = tiles_m * ((D + T::BN - 1) / T::BN);
  const Args a{reinterpret_cast<float*>(out), M, K, D, tiles_m, tiles, k_tiles_of(V, K)};
  kernel<<<tiles < sms ? tiles : sms, kThreads, T::SMEM, s>>>(xm, wm, a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point.  variant 0 (bf16-full), 1 (i8-seg64) or 2 (i8-full); x [M, K] and w
// [D, K] bf16 (variant 0) or int8, out f32 [M, D], contiguous 16-byte aligned device pointers;
// M and D multiples of 128, K of 64.  Returns cudaGetLastError() (or a tensor map's error, negated).
extern "C" int a8_depth(int variant, const void* x, const void* w, void* out, int M, int K, int D,
                        void* stream) {
  if (M <= 0 || D <= 0 || K <= 0 || M % BM || D % 128 || K % kGroup) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0: return launch<0>(x, w, out, M, K, D, s);
    case 1: return launch<1>(x, w, out, M, K, D, s);
    case 2: return launch<2>(x, w, out, M, K, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
