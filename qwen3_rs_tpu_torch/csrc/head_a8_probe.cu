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
// Bound on the H100: the probe asks what the tensor cores and the fixup cost once the tiles sit
// in fast memory, so the time to set against is 2*B*TN*TD operations a sweep at the bf16 (0) or
// int8 (1, 2) peak; a launch also reads each tile once from device memory (n_tiles*TN*TD bytes).
// Design:
//  * a block owns 16 columns of every tile (TD/16 blocks: 96 at TD 1536) and keeps them resident
//    in shared memory for the whole launch: the codes transposed to [column][row] (rows padded
//    by 16 bytes, so that the fragment loads meet no bank conflict) and the scales as f32; the
//    activations sit there too (x bf16, or xq int8 and xs f32).  At TN 4096 that is 136 KB of
//    weights and 64 KB (deq-dot) or 34 KB (int8) of activations, under 227 KB;
//  * deq-dot: mma.sync bf16 m16n8k16, the B rows padded to 16 with zeros, the weight fragment
//    dequantized from shared memory for every sweep (the work the JAX probe times);
//  * i8-seg, i8-seg2: mma.sync s8 m16n8k32, two k-steps for each 64-row group into a fresh int32
//    accumulator, then the f32 fixup of the group into the f32 accumulator;
//  * the 8 warps split each tile's rows (TN/8 each) and sum their columns at the end in shared
//    memory, in warp order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 16;  // columns of a block
constexpr int kGroup = 64;
constexpr int kWPad = 16;  // bytes of padding per shared code row

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Two int8 codes (k, k+1 of one column) times their bf16 scale, each rounded to bf16, packed.
__device__ __forceinline__ uint32_t deq2(uint16_t codes, float scale) {
  const float c0 = (float)(int8_t)(codes & 0xff), c1 = (float)(int8_t)(codes >> 8);
  return pack_bf16(c0 * scale, c1 * scale);
}

template <int V>
__global__ void __launch_bounds__(kThreads, 1)
head_a8_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ xq,
               const float* __restrict__ xs, const int8_t* __restrict__ w,
               const float* __restrict__ s, float* __restrict__ out, int B, int TN, int TD,
               int n_tiles, int sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TG = TN / kGroup;
  const int w_stride = TN + kWPad;                       // bytes per shared code row
  int8_t* Ws = reinterpret_cast<int8_t*>(smem);          // [n_tiles][kCols][w_stride]
  float* Ss = reinterpret_cast<float*>(Ws + n_tiles * kCols * w_stride);  // [n_tiles][TG][kCols]
  unsigned char* act = reinterpret_cast<unsigned char*>(Ss + n_tiles * TG * kCols);
  const int x_stride = TN + 8;                           // bf16 per shared x row (deq-dot)
  const int xq_stride = TN + 16;                         // bytes per shared xq row (int8)
  __nv_bfloat16* Xs = reinterpret_cast<__nv_bfloat16*>(act);                 // [8][x_stride]
  int8_t* XQs = reinterpret_cast<int8_t*>(act);                              // [8][xq_stride]
  float* XSs = reinterpret_cast<float*>(act + 8 * xq_stride);                // [8][TG]
  __shared__ float red[kWarps][8][kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kCols;

  // Resident tiles: 16 bytes of a row per load, stored transposed.
  for (int i = tid; i < n_tiles * TN; i += kThreads) {
    const int t = i / TN, k = i % TN;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(w + ((long)t * TN + k) * TD + c0));
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int n = 0; n < kCols; ++n)
      Ws[(t * kCols + n) * w_stride + k] = (int8_t)(words[n >> 2] >> (8 * (n & 3)));
  }
  for (int i = tid; i < n_tiles * TG * kCols; i += kThreads) {
    const int n = i % kCols, tg = i / kCols;  // tg = t * TG + group
    const float v = s[(long)tg * TD + c0 + n];
    Ss[i] = V == 0 ? round_bf16(v) : v;
  }
  for (int i = tid; i < 8 * TN; i += kThreads) {
    const int b = i / TN, k = i % TN;
    if (V == 0) Xs[b * x_stride + k] = b < B ? x[(long)b * TN + k] : __float2bfloat16_rn(0.f);
    else XQs[b * xq_stride + k] = b < B ? xq[(long)b * TN + k] : (int8_t)0;
  }
  if (V == 1)
    for (int i = tid; i < 8 * TG; i += kThreads) XSs[i] = i / TG < B ? xs[i] : 0.f;
  __syncthreads();

  const int g = lane >> 2, q = lane & 3;  // fragment row (activation row) and quad lane
  const int k_begin = warp * (TN / kWarps), k_end = k_begin + TN / kWarps;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int sw = 0; sw < sweeps; ++sw) {
    const int t = sw % n_tiles;
    const int8_t* wt = Ws + t * kCols * w_stride;
    const float* st = Ss + t * TG * kCols;
    if constexpr (V == 0) {
      for (int k0 = k_begin; k0 < k_end; k0 += 16) {
        const uint32_t a0 = *reinterpret_cast<const uint32_t*>(&Xs[g * x_stride + k0 + 2 * q]);
        const uint32_t a2 = *reinterpret_cast<const uint32_t*>(&Xs[g * x_stride + k0 + 8 + 2 * q]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int n = nt * 8 + g;
          const float sc = st[(k0 / kGroup) * kCols + n];
          const int8_t* row = wt + n * w_stride + k0 + 2 * q;
          const uint32_t b0 = deq2(*reinterpret_cast<const uint16_t*>(row), sc);
          const uint32_t b1 = deq2(*reinterpret_cast<const uint16_t*>(row + 8), sc);
          mma_bf16(acc[nt], a0, a2, b0, b1);
        }
      }
    } else {
      for (int k0 = k_begin; k0 < k_end; k0 += kGroup) {
        int d[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
#pragma unroll
        for (int kk = 0; kk < kGroup; kk += 32) {
          const int8_t* xr = XQs + g * xq_stride + k0 + kk + 4 * q;
          const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xr);
          const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xr + 16);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int8_t* row = wt + (nt * 8 + g) * w_stride + k0 + kk + 4 * q;
            mma_s8(d[nt], a0, a2, *reinterpret_cast<const uint32_t*>(row),
                   *reinterpret_cast<const uint32_t*>(row + 16));
          }
        }
        const int grp = k0 / kGroup;
        const float xsc = V == 1 ? XSs[g * TG + grp] : 1.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const float2 sc = *reinterpret_cast<const float2*>(&st[grp * kCols + nt * 8 + 2 * q]);
          if (V == 1) {
            acc[nt][0] += (float)d[nt][0] * sc.x * xsc;
            acc[nt][1] += (float)d[nt][1] * sc.y * xsc;
          } else {
            acc[nt][0] += (float)d[nt][0] * sc.x;
            acc[nt][1] += (float)d[nt][1] * sc.y;
          }
        }
      }
    }
  }

  // Accumulator row g (rows 8..15 are padding), columns nt*8 + 2q, +1.
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
    red[warp][g][nt * 8 + 2 * q] = acc[nt][0];
    red[warp][g][nt * 8 + 2 * q + 1] = acc[nt][1];
  }
  __syncthreads();
  if (tid < B * kCols) {
    const int b = tid / kCols, n = tid % kCols;
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) v += red[wi][b][n];
    out[(long)b * TD + c0 + n] = v;
  }
}

// Dynamic shared memory of a block, in bytes.
int smem_bytes(int variant, int TN, int n_tiles) {
  const int weights = n_tiles * kCols * (TN + kWPad) + n_tiles * (TN / kGroup) * kCols * 4;
  const int acts = variant == 0 ? 8 * (TN + 8) * 2 : 8 * (TN + 16) + 8 * (TN / kGroup) * 4;
  return weights + acts;
}

}  // namespace

// Plain C entry point.  variant 0 (deq-dot), 1 (i8-seg) or 2 (i8-seg2); x bf16 [B, TN], xq int8
// [B, TN], xs f32 [B, TN/64], w int8 [n_tiles, TN, TD], s f32 [n_tiles, TN/64, TD], out f32
// [B, TD], contiguous device pointers (variant 0 reads no xq or xs, variants 1 and 2 no x, 2 no
// xs).  1 <= B <= 8, TN a multiple of 512, TD of 16.  Returns cudaGetLastError().
extern "C" int head_a8(int variant, const void* x, const void* xq, const void* xs, const void* w,
                       const void* s, void* out, int B, int TN, int TD, int n_tiles, int sweeps,
                       void* stream) {
  if (B < 1 || B > 8 || TN % (kWarps * kGroup) || TD % kCols || n_tiles < 1 || sweeps < 1)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(variant, TN, n_tiles);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* xqb = reinterpret_cast<const int8_t*>(xq);
  const auto* xsf = reinterpret_cast<const float*>(xs);
  const auto* wb = reinterpret_cast<const int8_t*>(w);
  const auto* sf = reinterpret_cast<const float*>(s);
  auto* o = reinterpret_cast<float*>(out);
  decltype(&head_a8_kernel<0>) kernel;
  switch (variant) {
    case 0: kernel = head_a8_kernel<0>; break;
    case 1: kernel = head_a8_kernel<1>; break;
    case 2: kernel = head_a8_kernel<2>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<TD / kCols, kThreads, smem, st>>>(xb, xqb, xsf, wb, sf, o, B, TN, TD, n_tiles, sweeps);
  return (int)cudaGetLastError();
}
