// The W8A8-g64 depth question for Hopper (sm_90a): can int8 dots that must be flushed every 64
// rows of depth beat one full-depth bf16 product on this card's tensor cores?
//
// Replaces the Pallas kernel of scripts/a8_depth_probe.py:90 (`make_kernel`: w13 prefill
// shapes, the same tile geometry for three arms, no scale work).  out [M, D] f32 = x [M, K] .
// w^T, with w given as [D, K] (each output column's weights contiguous along the depth, the
// layout the tensor cores take for B):
//   bf16-full (0): bf16 operands, one f32 accumulator over the whole depth;
//   i8-seg64  (1): int8 operands; a fresh int32 accumulator for each 64-deep group, converted
//                  and added into the f32 accumulator after the group (no scale multiply, as
//                  the JAX probe omits all scale work);
//   i8-full   (2): int8 operands; int32 accumulation over each 512-deep k-tile (the JAX
//                  probe's TILE_N), then converted and added.
// On mma.sync an int32 accumulator carries from one k-step to the next for free, so segmenting
// without a flush would cost nothing and answer nothing: the flush (a convert and an add of the
// whole accumulator tile every 64 rows) is what a g=64 group forces on this card, and i8-seg64
// pays it.  For int8 inputs of magnitude <= 16 every partial sum is an integer below 2^24, so
// both int arms are exact in f32 and equal their plain versions bit for bit.
//
// Bound on the H100: 2*M*K*D operations at the bf16 (989 TFLOP/s) or int8 (1979 TOP/s) peak; the
// bytes (x, w once, the f32 output) take far less.
// Design (right and simple first; wgmma and TMA are later work):
//  * 128 x 128 output tiles, 8 warps of 64 x 32, a k-tile of 64 bytes (32 bf16 or 64 int8
//    values), so both types share one shared-memory layout: rows of 64 bytes padded by 16
//    (ldmatrix without bank conflicts), 3 stages filled by cp.async;
//  * fragments by ldmatrix.x4 (an int8 row of 16 bytes is 8 b16 pairs, the m16n8k32 layout),
//    mma.sync m16n8k16 bf16 or m16n8k32 s8, 2 k-steps a k-tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128, kBN = 128;
constexpr int kBKBytes = 64;             // bytes of depth per k-tile
constexpr int kRowBytes = kBKBytes + 16; // padded shared row
constexpr int kStages = 3;
constexpr int kStageBytes = (kBM + kBN) * kRowBytes;
constexpr int kSmemBytes = kStages * kStageBytes;
constexpr int kFullTile = 512;           // i8-full: int32 depth before a flush

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-tile kt of the block's 128 rows of x and 128 rows of w: 16 bytes a copy, 4 a thread.
__device__ __forceinline__ void load_tile(unsigned char* stage, const unsigned char* xa,
                                          const unsigned char* wb, long row_bytes, int kt) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int id = threadIdx.x + i * kThreads;  // 0..1023: 512 chunks of x, then 512 of w
    const int r = (id & 511) >> 2, ch = id & 3;
    const unsigned char* src = (id < 512 ? xa : wb) + r * row_bytes + (long)kt * kBKBytes + ch * 16;
    cp_async16(stage + ((id < 512 ? 0 : kBM) + r) * kRowBytes + ch * 16, src);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
a8_depth_kernel(const void* __restrict__ x, const void* __restrict__ w, float* __restrict__ out,
                int M, int K, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kElem = V == 0 ? 2 : 1;
  constexpr int kFlushTiles = V == 1 ? 1 : kFullTile / kBKBytes;  // int8 k-tiles per flush
  const long row_bytes = (long)K * kElem;
  const int n_kt = (int)(row_bytes / kBKBytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // warp tile: rows wm*64.., columns wn*32..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const auto* xa = reinterpret_cast<const unsigned char*>(x) + m0 * row_bytes;
  const auto* wb = reinterpret_cast<const unsigned char*>(w) + n0 * row_bytes;

  float acc[4][4][4];
  int iacc[V == 0 ? 1 : 4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if constexpr (V != 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) iacc[i][j][e] = 0;
  }

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) load_tile(smem + st * kStageBytes, xa, wb, row_bytes, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed for every thread; tile kt-1's stage is free
    const int nxt = kt + kStages - 1;
    if (nxt < n_kt) load_tile(smem + (nxt % kStages) * kStageBytes, xa, wb, row_bytes, nxt);
    cp_async_commit();

    const unsigned char* As = smem + (kt % kStages) * kStageBytes;
    const unsigned char* Bs = As + kBM * kRowBytes;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of depth a k-step
      uint32_t a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldsm_x4(smem_addr(As + (wm * 64 + mi * 16 + (lane & 15)) * kRowBytes + ks * 32 + (lane >> 4) * 16),
                a[mi]);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldsm_x4(smem_addr(Bs + (wn * 32 + nj * 16 + (lane & 7) + (lane >> 4) * 8) * kRowBytes + ks * 32 +
                          ((lane >> 3) & 1) * 16),
                b[nj]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const uint32_t b0 = b[ni >> 1][(ni & 1) * 2], b1 = b[ni >> 1][(ni & 1) * 2 + 1];
          if constexpr (V == 0) mma_bf16(acc[mi][ni], a[mi], b0, b1);
          else mma_s8(iacc[mi][ni], a[mi], b0, b1);
        }
    }
    if constexpr (V != 0) {
      if ((kt + 1) % kFlushTiles == 0 || kt + 1 == n_kt) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[mi][ni][e] += (float)iacc[mi][ni][e];
              iacc[mi][ni][e] = 0;
            }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 64 + mi * 16 + (lane >> 2);
      const int col = n0 + wn * 32 + ni * 8 + (lane & 3) * 2;
      *reinterpret_cast<float2*>(out + (long)row * D + col) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(out + (long)(row + 8) * D + col) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
}

}  // namespace

// Plain C entry point.  variant 0 (bf16-full), 1 (i8-seg64) or 2 (i8-full); x [M, K] and w
// [D, K] bf16 (variant 0) or int8, out f32 [M, D], contiguous 16-byte aligned device pointers;
// M and D multiples of 128, K of 64.  Returns cudaGetLastError().
extern "C" int a8_depth(int variant, const void* x, const void* w, void* out, int M, int K, int D,
                        void* stream) {
  if (M <= 0 || D <= 0 || K <= 0 || M % kBM || D % kBN || K % 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  decltype(&a8_depth_kernel<0>) kernel;
  switch (variant) {
    case 0: kernel = a8_depth_kernel<0>; break;
    case 1: kernel = a8_depth_kernel<1>; break;
    case 2: kernel = a8_depth_kernel<2>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(D / kBN, M / kBM);
  kernel<<<grid, kThreads, kSmemBytes, s>>>(x, w, reinterpret_cast<float*>(out), M, K, D);
  return (int)cudaGetLastError();
}
