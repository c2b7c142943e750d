// Row-blocked W8A16 matmul for Hopper (sm_90a): out[M, dc] = x[M, N] · dequant(W[N, c0:c0+dc]), f32.
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked_rows (prefill windows > 256 rows),
// with its column window out_cols=(c0, dc) (the tensor-parallel overlap's chunks of a
// row-parallel projection): the code and scale pointers move by c0 columns and keep the full
// row stride D, so the kernel reads only the window's columns, as the Pallas index map offsets
// its out-tile axis, and no weight is copied.  Each output element sums its products in the same
// k order whatever the window, so a window equals those columns of the full product bit for bit.
// The layer offset of stacked weights is a pointer offset made by the wrapper.  A template
// parameter picks the code format: int8 codes [N, D], or INT4 codes nibble-packed [N/2, D]
// (group split-half along N, code + 8 per nibble: the Q4 tiles of the same Pallas kernel).
//
// Numerics ("scale_w", as the Pallas kernel): x is bf16; each weight element is
// bf16(code * bf16(scale)) (the product of an 8-bit code and a bf16 scale is exact in f32, then
// rounded once to bf16); products accumulate in f32 on the tensor cores.  No prologue, no
// epilogue: the RMSNorm, SwiGLU and residual add run outside, as in the reference package.
//
// Bound on the H100: at prefill widths (M >= 257 rows) the product is bound by tensor-core
// operations (2*M*N*D at 989 TFLOP/s bf16) and not by bytes.  Design:
//  * mma.sync m16n8k16 bf16 -> f32 on 128 x 128 output tiles, 8 warps of 64 x 32 each;
//  * each 64-row k-tile of codes is dequantized once per block into shared memory as bf16
//    (the codes stream at 1 byte per weight; the bf16 tile never goes to device memory);
//  * the next k-tile's x and codes are loaded into registers while the tensor cores work on the
//    current one (one stage of register prefetch);
//  * row tiles are the fastest grid axis, so the blocks of one weight column strip run together
//    and the strip is read from device memory about once and from L2 afterwards;
//  * shared-memory rows are padded by 16 bytes so that ldmatrix reads are free of bank
//    conflicts.  wgmma, TMA and a deeper pipeline are later work.
// INT4: a k-tile is 32 packed rows, i.e. 64 in-rows: shared row r < 32 holds the low nibbles of
// packed row p0 + r, row r >= 32 the high nibbles of packed row p0 + r - 32.  The product does
// not depend on the order of k, so the x tile is gathered in the same order (8-row runs where
// g % 16 == 0, else row by row: any even g), and the mma.sync body is the INT8 kernel's.  Each weight is
// bf16((nibble - 8) * bf16(scale)), as the Pallas "int" unpack.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // activation rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 64;   // contraction rows per k-tile
constexpr int kThreads = 256;
constexpr int A_STRIDE = BK + 8;  // bf16 per shared row of the x tile (144 bytes)
constexpr int B_STRIDE = BN + 8;  // bf16 per shared row of the weight tile (272 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float code_of(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

// Two codes times their bf16 scales (one 32-bit word of bf16 pairs), each product rounded to bf16.
__device__ __forceinline__ uint32_t dequant2(float c0, float c1, uint32_t scale_pair) {
  const float2 s = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&scale_pair));
  const __nv_bfloat162 w = __floats2bfloat162_rn(c0 * s.x, c1 * s.y);
  return *reinterpret_cast<const uint32_t*>(&w);
}

// In-row of x that shared column k (0..63) of the k-tile starting at packed row p0 holds.
__device__ __forceinline__ int q4_in_row(int p0, int k, int h) {
  const int p = p0 + (k & 31);
  return (p / h) * 2 * h + (p % h) + (k >> 5) * h;
}

// D: the output's columns (the window's width); ldw: the weights' row stride (all their columns).
template <bool Q4>
__global__ void __launch_bounds__(kThreads)
qmatmul_rows_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                    const __nv_bfloat16* __restrict__ scales, float* __restrict__ out, int M,
                    int N, int D, int ldw, int g) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * A_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Bs[BK * B_STRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Register stage: 4 x 16 bytes of x and 2 x 16 codes (with their 2 x 16 bf16 scales); INT4
  // stages one 16-byte load of packed codes (32 shared rows of 16 columns) and its scales.
  constexpr int kCodeLoads = Q4 ? 1 : 2;
  uint4 a_reg[4], c_reg[kCodeLoads], s_reg[kCodeLoads][2];
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const int h = g / 2;

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, ch = id & 7;
      const int row = m0 + r;
      if (!Q4 || h % 8 == 0) {  // the 8 columns are 8 adjacent in-rows
        const int k = Q4 ? q4_in_row(k0 / 2, ch * 8, h) : k0 + ch * 8;
        a_reg[i] = row < M ? *reinterpret_cast<const uint4*>(x + (long)row * N + k) : zero;
      } else {  // a group boundary may fall inside them: gather one by one
        __align__(16) __nv_bfloat16 e[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = row < M ? x[(long)row * N + q4_in_row(k0 / 2, ch * 8 + j, h)]
                         : __float2bfloat16_rn(0.f);
        a_reg[i] = *reinterpret_cast<const uint4*>(e);
      }
    }
#pragma unroll
    for (int i = 0; i < kCodeLoads; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, ch = id & 7;
      const int col = n0 + ch * 16, k = (Q4 ? k0 / 2 : k0) + r;  // a packed row for INT4
      if (col < D) {
        c_reg[i] = __ldg(reinterpret_cast<const uint4*>(codes + (long)k * ldw + col));
        const int grp = Q4 ? k / h : k / g;
        const uint4* sp = reinterpret_cast<const uint4*>(scales + (long)grp * ldw + col);
        s_reg[i][0] = __ldg(sp);
        s_reg[i][1] = __ldg(sp + 1);
      } else {
        c_reg[i] = zero;
        s_reg[i][0] = s_reg[i][1] = zero;
      }
    }
  };

  // 16 codes (one byte each of cw, at byte k of each word, minus `bias`) times their scales,
  // rounded to bf16, into shared row r.
  auto store_row = [&](int r, int ch, const uint32_t* cw, const uint32_t* sw, float bias) {
    uint32_t wv[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      wv[2 * q] = dequant2(code_of(cw[q], 0) - bias, code_of(cw[q], 1) - bias, sw[2 * q]);
      wv[2 * q + 1] = dequant2(code_of(cw[q], 2) - bias, code_of(cw[q], 3) - bias, sw[2 * q + 1]);
    }
    uint4* dst = reinterpret_cast<uint4*>(&Bs[r * B_STRIDE + ch * 16]);
    dst[0] = make_uint4(wv[0], wv[1], wv[2], wv[3]);
    dst[1] = make_uint4(wv[4], wv[5], wv[6], wv[7]);
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, ch = id & 7;
      *reinterpret_cast<uint4*>(&As[r * A_STRIDE + ch * 8]) = a_reg[i];
    }
#pragma unroll
    for (int i = 0; i < kCodeLoads; ++i) {
      const int id = tid + i * kThreads, r = id >> 3, ch = id & 7;
      const uint32_t cw[4] = {c_reg[i].x, c_reg[i].y, c_reg[i].z, c_reg[i].w};
      const uint32_t sw[8] = {s_reg[i][0].x, s_reg[i][0].y, s_reg[i][0].z, s_reg[i][0].w,
                              s_reg[i][1].x, s_reg[i][1].y, s_reg[i][1].z, s_reg[i][1].w};
      if constexpr (Q4) {
        // Nibbles as unsigned bytes (code + 8, 0..15): code_of reads them as non-negative int8.
        const uint32_t lo[4] = {cw[0] & 0x0F0F0F0Fu, cw[1] & 0x0F0F0F0Fu, cw[2] & 0x0F0F0F0Fu,
                                cw[3] & 0x0F0F0F0Fu};
        const uint32_t hi[4] = {(cw[0] >> 4) & 0x0F0F0F0Fu, (cw[1] >> 4) & 0x0F0F0F0Fu,
                                (cw[2] >> 4) & 0x0F0F0F0Fu, (cw[3] >> 4) & 0x0F0F0F0Fu};
        store_row(r, ch, lo, sw, 8.f);
        store_row(r + 32, ch, hi, sw, 8.f);
      } else {
        store_row(r, ch, cw, sw, 0.f);
      }
    }
  };

  const int k_tiles = N / BK;
  load_tile(0);
  for (int kt = 0; kt < k_tiles; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < k_tiles) load_tile((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int row = wm + mi * 16 + (lane & 15), col = ks * 16 + (lane >> 4) * 8;
        ldsm_x4(smem_addr(&As[row * A_STRIDE + col]), a[mi][0], a[mi][1], a[mi][2], a[mi][3]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int k = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int n = wn + nj * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(&Bs[k * B_STRIDE + n]), b[2 * nj][0], b[2 * nj][1],
                      b[2 * nj + 1][0], b[2 * nj + 1][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
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

// Plain C entry point.  x [M, N] bf16, codes [N, D] int8 (q4: [N/2, D] packed) and scales
// [N/g, D] bf16 are device pointers (codes/scales already offset to the layer); out [M, dc] f32
// holds columns [c0, c0 + dc) of the product (c0 = 0, dc = D: all of it).  The wrapper guarantees
// N % 64 == 0, D, c0 and dc multiples of 16 with c0 + dc <= D, 16-byte alignment and, for q4, an
// even g.  Returns cudaGetLastError().
extern "C" int qmatmul_w8a16_rows(const void* x, const void* codes, const void* scales, void* out,
                                  int M, int N, int D, int c0, int dc, int g, int q4,
                                  void* stream) {
  const dim3 grid((M + BM - 1) / BM, (dc + BN - 1) / BN);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  const auto* cq = reinterpret_cast<const int8_t*>(codes) + c0;  // packed INT4 keeps D columns
  const auto* cs = reinterpret_cast<const __nv_bfloat16*>(scales) + c0;
  auto* o = reinterpret_cast<float*>(out);
  if (q4)
    qmatmul_rows_kernel<true><<<grid, kThreads, 0, s>>>(xb, cq, cs, o, M, N, dc, D, g);
  else
    qmatmul_rows_kernel<false><<<grid, kThreads, 0, s>>>(xb, cq, cs, o, M, N, dc, D, g);
  return (int)cudaGetLastError();
}
