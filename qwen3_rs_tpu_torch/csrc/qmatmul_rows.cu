// Row-blocked W8A16 matmul for Hopper (sm_90a): out[M, dc] = x[M, N] · dequant(W[N, c0:c0+dc]), f32.
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked_rows (prefill windows > 256 rows),
// with its Q4 tiles and its column window out_cols=(c0, dc) (the tensor-parallel overlap's chunks
// of a row-parallel projection): the window is a box offset of the code map and a column offset
// of the scales, so the kernel reads only the window's columns (and those of its last 128-column
// box) and no weight is copied.  The layer offset of stacked weights is a pointer offset made by
// the wrapper.  INT8 codes [N, D] or INT4 codes nibble-packed [N/2, D] (group split-half along N,
// code + 8 per nibble).
//
// Numerics ("scale_w", as the Pallas kernel): x is bf16; each weight element is
// bf16(code * bf16(scale)) (exact in f32, rounded once); products accumulate in f32 on the tensor
// cores.  No prologue, no epilogue: the RMSNorm, SwiGLU and residual add run outside, as in the
// reference package.
//
// Bound on the H100: at prefill widths (M >= 257 rows) the product is bound by tensor-core
// operations (2*M*N*D at 989 TFLOP/s bf16) and not by bytes.  The kernel is w8a16_wgmma.cuh's
// at its 256-row tile: 128 output columns by 256 rows, wgmma m64n256k16 with the weights
// dequantized into the A fragments, a TMA-fed ring of five 40 KB stages and a persistent grid of
// one block per SM walking the tiles row tiles first.  There is no split of the contraction:
// every output element sums its k-tiles in k order, whatever the window.  INT4 with g != 64 has
// x staged in the kernel's slot order first (one pass over x; g == 64 is x's own order).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_wgmma.cuh"

// Plain C entry point.  x [M, N] bf16, codes [N, D] int8 (q4: [N/2, D] packed) and scales
// [N/g, D] bf16 are device pointers (codes/scales already offset to the layer); out [M, dc] f32
// holds columns [c0, c0 + dc) of the product (c0 = 0, dc = D: all of it).  xs: scratch of M * N
// bf16 for INT4 with g != 64, else null.  The wrapper guarantees N % 64 == 0, D and dc multiples
// of 16, c0 a multiple of 128 with c0 + dc <= D, 16-byte alignment and, for q4, an even g.
// Returns cudaGetLastError() (or the error of a tensor map, negated).
extern "C" int qmatmul_w8a16_rows(const void* x, void* xs, const void* codes, const void* scales,
                                  void* out, int M, int N, int D, int c0, int dc, int g, int q4,
                                  void* stream) {
  constexpr int kRowTile = 256;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const void* xt = x;
  if (xs != nullptr) {
    tc::stage_x(s, x, 1, nullptr, 0, 0.f, M, N, g, q4, N, reinterpret_cast<__nv_bfloat16*>(xs));
    xt = xs;
  }
  CUtensorMap xm, cm;
  const int e = tc::make_maps(&xm, &cm, xt, M, N, kRowTile, codes, q4 ? N / 2 : N, D, q4 != 0);
  if (e) return e;
  const int k_tiles = N / tc::kSlots;
  const tc::Args a{reinterpret_cast<const __nv_bfloat16*>(scales) + c0, D, N / g, g, M, dc, c0,
                   (dc + tc::tile_cols(kRowTile) - 1) / tc::tile_cols(kRowTile),
                   (M + kRowTile - 1) / kRowTile, 1, k_tiles, k_tiles,
                   reinterpret_cast<float*>(out), nullptr, 0};
  const int rc = tc::launch_for<kRowTile>(q4 != 0, g % 64 == 0, xm, cm, a, s);
  if (rc) return rc;
  return (int)cudaGetLastError();
}
