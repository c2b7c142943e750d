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
// Bound on the H100: 2*M*N*D int8 operations at 1979 TOPS, plus a per-group f32 fixup of every
// output element (3 rounded operations and a conversion per group) that runs on the CUDA cores
// and dominates at g = 64.  Design:
//  * mma.sync m16n8k32 s8 -> s32 on 128 x 128 output tiles, 8 warps of 64 x 32 each; the int32
//    group partials and the f32 sums both live in registers;
//  * the weight tile [64 k x 128 n] is transposed to n-major in shared memory on the way in
//    (4 x 4 byte transposes with byte permutes), since the s8 mma wants k contiguous per column;
//  * one stage of register prefetch of the next k-tile, ldmatrix reads from rows padded to 80
//    bytes (free of bank conflicts), row tiles as the fastest grid axis.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // activation rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction rows per k-tile
constexpr int kThreads = 256;
constexpr int STRIDE = BK + 16;  // bytes per shared row (x tile and transposed weight tile)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
qmatmul_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const int8_t* __restrict__ codes, const float* __restrict__ ws,
                  float* __restrict__ out, int M, int N, int D, int g) {
  __shared__ __align__(16) int8_t As[BM * STRIDE];
  __shared__ __align__(16) int8_t Bt[BN * STRIDE];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int groups = N / g;

  float acc[4][4][4];
  int part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        part[i][j][e] = 0;
      }

  // Register stage: 2 x 16 bytes of x codes; a 4 (k) x 8 (n) block of weight codes.
  uint4 a_reg[2];
  uint2 w_reg[4];
  const int kr = tid >> 4, nc = tid & 15;  // this thread's weight block: rows 4kr.., cols 8nc..

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads, r = id >> 2, ch = id & 3;
      const int row = m0 + r;
      a_reg[i] = row < M ? *reinterpret_cast<const uint4*>(xq + (long)row * N + k0 + ch * 16)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
    const int col = n0 + nc * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w_reg[j] = col < D ? __ldg(reinterpret_cast<const uint2*>(codes + (long)(k0 + 4 * kr + j) * D + col))
                         : make_uint2(0u, 0u);
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int id = tid + i * kThreads, r = id >> 2, ch = id & 3;
      *reinterpret_cast<uint4*>(&As[r * STRIDE + ch * 16]) = a_reg[i];
    }
    // 4 x 8 bytes (rows k, columns n) -> 8 words of 4 k-consecutive bytes, one per column.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t r0 = h ? w_reg[0].y : w_reg[0].x, r1 = h ? w_reg[1].y : w_reg[1].x;
      const uint32_t r2 = h ? w_reg[2].y : w_reg[2].x, r3 = h ? w_reg[3].y : w_reg[3].x;
      const uint32_t lo01 = __byte_perm(r0, r1, 0x5140), hi01 = __byte_perm(r0, r1, 0x7362);
      const uint32_t lo23 = __byte_perm(r2, r3, 0x5140), hi23 = __byte_perm(r2, r3, 0x7362);
      const uint32_t col_words[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(&Bt[(nc * 8 + 4 * h + c) * STRIDE + 4 * kr]) = col_words[c];
    }
  };

  // acc += (f32(part) * w_scale) * x_scale for group `grp`, then part = 0.
  auto fixup = [&](int grp) {
    float wsv[4][2], xsv[4][2];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
      wsv[ni][0] = col < D ? __ldg(ws + (long)grp * D + col) : 0.f;
      wsv[ni][1] = col < D ? __ldg(ws + (long)grp * D + col + 1) : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int row = m0 + wm + mi * 16 + (lane >> 2);
      xsv[mi][0] = row < M ? __ldg(xs + (long)row * groups + grp) : 0.f;
      xsv[mi][1] = row + 8 < M ? __ldg(xs + (long)(row + 8) * groups + grp) : 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float t = __fmul_rn(__int2float_rn(part[mi][ni][e]), wsv[ni][e & 1]);
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], __fmul_rn(t, xsv[mi][e >> 1]));
          part[mi][ni][e] = 0;
        }
  };

  const int k_tiles = N / BK;
  load_tile(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < k_tiles) load_tile((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm + mi * 16 + (lane & 15);
        ldsm_x4(smem_addr(&As[row * STRIDE + ks * 32 + (lane >> 4) * 16]), a[mi][0], a[mi][1],
                a[mi][2], a[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int n = wn + nj * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(smem_addr(&Bt[n * STRIDE + ks * 32 + ((lane >> 3) & 1) * 16]), b[2 * nj][0],
                b[2 * nj][1], b[2 * nj + 1][0], b[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
      const int k_next = kt * BK + (ks + 1) * 32;
      if (k_next % g == 0) fixup(k_next / g - 1);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm + mi * 16 + (lane >> 2);
      const int col = n0 + wn + ni * 8 + (lane & 3) * 2;
      if (col < D) {
        if (row < M)
          *reinterpret_cast<float2*>(out + (long)row * D + col) =
              make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        if (row + 8 < M)
          *reinterpret_cast<float2*>(out + (long)(row + 8) * D + col) =
              make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      }
    }
  }
}

}  // namespace

// Plain C entry point.  xq [M, N] int8, xs [M, N/g] f32, codes [N, D] int8 and ws [N/g, D] f32
// are device pointers (codes/ws already offset to the layer); out [M, D] f32.  The wrapper
// guarantees N % 64 == 0, g % 32 == 0, D % 8 == 0 and 16-byte alignment.
// Returns cudaGetLastError().
extern "C" int qmatmul_w8a8_rows(const void* xq, const void* xs, const void* codes, const void* ws,
                                 void* out, int M, int N, int D, int g, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (D + BN - 1) / BN);
  qmatmul_a8_kernel<<<grid, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int8_t*>(xq), reinterpret_cast<const float*>(xs),
      reinterpret_cast<const int8_t*>(codes), reinterpret_cast<const float*>(ws),
      reinterpret_cast<float*>(out), M, N, D, g);
  return (int)cudaGetLastError();
}
