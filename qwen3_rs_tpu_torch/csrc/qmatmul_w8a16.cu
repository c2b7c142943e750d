// W8A16 grouped-dequant matmul for Hopper (sm_90a): out = prologue(x) · dequant(W).
//
// Replaces the reference package's Pallas kernels
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas               (2-D weights),
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked       (layer of [L, N, D]),
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked_fused (+ RMSNorm or SwiGLU
//                                                                    prologue, residual epilogue).
// The layer offset is a pointer offset made by the wrapper, so one kernel covers all three.
// A template parameter picks the code format: int8 codes [N, D], or INT4 codes nibble-packed
// [N/2, D] (the Q4 variant of the same three kernels, qmatmul.py::_dequant_tile_q4 "int"):
// byte row k*g/2 + j of group k holds in-row k*g + j in its low nibble and in-row k*g + g/2 + j
// in its high nibble, each stored as code + 8.
//
// Numerics ("scale_w", as the Pallas kernel): the prologue runs in f32 and the activation is
// rounded to bf16 after it; each weight element is bf16(bf16(code) * bf16(scale)); products
// accumulate in f32.  The residual, when given, is added once, in the last pass.  INT4 codes
// (-8..7) take the same rounding.
//
// Bound on the H100: at decode (B = 1) the kernel streams every weight byte once and does
// ~2 flops per byte, so it is bound by device-memory bytes (codes N*D + bf16 scales 2*N*D/g).
// Design against that bound:
//  * codes are in-major [N, D]: a thread owns 16 adjacent output columns and reads them as one
//    16-byte load per row, so a warp reads 512 contiguous bytes of a row;
//  * each thread keeps 4 rows of loads in flight before it computes on them;
//  * the int8 -> f32 conversion uses the exponent trick (byte permute + one f32 subtract), not
//    a conversion instruction, and the bf16 rounding of two products is one paired convert;
//  * wo and w2 have only D/512 = 8 column strips at 8B, too few blocks for 132 SMs, so the
//    contraction axis N is split across blocks (grid.y).  Splits write f32 partials to a
//    workspace that a second pass sums in a fixed order (deterministic; the residual is added
//    there once);
//  * the 8 warps of a block share the strip's columns and split the rows of each staged tile;
//    their partial sums meet in shared memory in a fixed order;
//  * row tiles of up to 8 activation rows (grid.z): at 1-8 rows a thread holds B x 16
//    accumulators, and each weight byte is read once.
// INT4: the bound halves (N*D/2 code bytes).  A 16-byte load along D holds 16 columns of two
// in-rows, j and j + g/2 of one group; the thread dequantizes the low nibbles, accumulates them
// against activation row j, then the high nibbles against row j + g/2.  The tile stages its
// activation rows in packed order (staged_row), so any even group size works, 512 included.
// Any group size: a thread reloads its scales where a code row leaves their group.
//
// The tensor-core route (qmatmul_w8a16_tc, the wrapper's route for windows of 9 or more rows):
// on CUDA cores a window of B rows would read every weight B / 8 times.  Instead a small pass
// (tc::stage_x_kernel) writes the prologue's bf16 activation once, in the kernel's slot order,
// and w8a16_wgmma.cuh's kernel streams each weight byte once for all the rows: wgmma with the
// dequantized weights as the register A operand and the rows as N (64, 128 or 256: the row tile
// the wrapper picks), the contraction split over blocks as here (tc_plan in the wrapper), the
// splits summed in split order by the same reduce pass, which adds the residual; unsplit, the
// residual is added in the store.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_dequant.cuh"
#include "w8a16_wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerThread = 16;
constexpr int kBlockCols = 32 * kColsPerThread;  // 512 output columns per block
constexpr int kRowsPerBatch = kCodeRowsInFlight;  // code rows in flight per thread
constexpr int kTileRows = kThreads;              // activation rows staged per pass

enum Prologue { kNone = 0, kRms = 1, kSwiglu = 2 };

__device__ __forceinline__ float load_act(const void* p, int is_bf16, long i) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

template <int BT, bool Q4, bool Shared>
__global__ void __launch_bounds__(kThreads)
qmatmul_w8a16_kernel(const void* __restrict__ x, int x_bf16, const int8_t* __restrict__ codes,
                     const __nv_bfloat16* __restrict__ scales, const float* __restrict__ norm_w,
                     const void* __restrict__ residual, int res_bf16, float* __restrict__ out,
                     float* __restrict__ partial, int B, int N, int D, int g, int prologue,
                     float eps, int kc) {
  __shared__ float xs[BT][kTileRows];
  __shared__ __align__(16) float red[kWarps][kBlockCols];  // float4 stores
  __shared__ float rms_part[kWarps][BT];
  __shared__ float inv_s[BT];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.x * kBlockCols + lane * kColsPerThread;
  const int row0 = blockIdx.z * BT;
  const int k_begin = blockIdx.y * kc;
  const int k_end = min(N, k_begin + kc);
  const long xw = prologue == kSwiglu ? 2L * N : (long)N;  // x row width
  const bool active = col0 < D;

  if (prologue == kRms) {
    // inv = rsqrt(mean(x^2) + eps) over the full row, computed by every block.
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float ss = 0.f;
      if (row0 + b < B) {
        for (int i = tid; i < N; i += kThreads) {
          const float v = load_act(x, x_bf16, (row0 + b) * xw + i);
          ss = fmaf(v, v, ss);
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
      if (lane == 0) rms_part[warp][b] = ss;
    }
    __syncthreads();
    if (tid < BT) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += rms_part[w][tid];
      inv_s[tid] = rsqrtf(t / (float)N + eps);
    }
    __syncthreads();
  }

  float acc[BT][kColsPerThread];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int e = 0; e < kColsPerThread; ++e) acc[b][e] = 0.f;
  GroupScales gs;

  for (int t0 = k_begin; t0 < k_end; t0 += kTileRows) {
    const int rows = min(kTileRows, k_end - t0);  // a multiple of 8
    const int r = tid;  // each thread stages one slot of every activation row
    const int n = staged_row<Q4>(t0, r, g);
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = 0.f;
      if (r < rows && row0 + b < B) {
        const long base = (row0 + b) * xw;
        v = load_act(x, x_bf16, base + n);
        if (prologue == kSwiglu) {
          const float up = load_act(x, x_bf16, base + N + n);
          v = v * (1.f / (1.f + expf(-v))) * up;
        } else if (prologue == kRms) {
          v = v * inv_s[b] * norm_w[n];
        }
        v = __bfloat162float(__float2bfloat16_rn(v));
      }
      xs[b][r] = v;
    }
    __syncthreads();
    if (active)
      tile_dot<BT, Q4, Shared>(codes, scales, D, g, col0, Q4 ? t0 / 2 : t0, Q4 ? rows / 2 : rows,
                       warp * kRowsPerBatch, kWarps * kRowsPerBatch, &xs[0][0], kTileRows, gs,
                       acc);
    __syncthreads();
  }

  // Sum the 8 warps' partials per activation row, in warp order.
  const int c = 2 * tid;  // this thread's two columns within the strip
  const int col = blockIdx.x * kBlockCols + c;
#pragma unroll
  for (int b = 0; b < BT; ++b) {
    if (active) {
#pragma unroll
      for (int e = 0; e < kColsPerThread; e += 4)
        *reinterpret_cast<float4*>(&red[warp][lane * kColsPerThread + e]) =
            make_float4(acc[b][e], acc[b][e + 1], acc[b][e + 2], acc[b][e + 3]);
    }
    __syncthreads();
    if (row0 + b < B && col < D) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s0 += red[w][c];
        s1 += red[w][c + 1];
      }
      const long o = (long)(row0 + b) * D + col;
      if (gridDim.y == 1) {
        if (residual != nullptr) {
          s0 = load_act(residual, res_bf16, o) + s0;
          s1 = load_act(residual, res_bf16, o + 1) + s1;
        }
        *reinterpret_cast<float2*>(out + o) = make_float2(s0, s1);
      } else {
        *reinterpret_cast<float2*>(partial + (long)blockIdx.y * B * D + o) = make_float2(s0, s1);
      }
    }
    __syncthreads();
  }
}

// out = residual + sum over splits of the partials, in split order.
__global__ void qmatmul_reduce_kernel(const float* __restrict__ partial,
                                      const void* __restrict__ residual, int res_bf16,
                                      float* __restrict__ out, int splits, long bd) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  float s = residual != nullptr ? load_act(residual, res_bf16, i) : 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * bd + i];
  out[i] = s;
}

template <bool Q4, bool Shared>
int launch(const dim3& grid, cudaStream_t s, int bt, const void* x, int x_bf16, const int8_t* cq,
           const __nv_bfloat16* cs, const float* nw, const void* residual, int res_bf16, float* o,
           float* p, int B, int N, int D, int g, int prologue, float eps, int kc) {
  decltype(&qmatmul_w8a16_kernel<1, Q4, Shared>) kernel;
  switch (bt) {
    case 1: kernel = qmatmul_w8a16_kernel<1, Q4, Shared>; break;
    case 2: kernel = qmatmul_w8a16_kernel<2, Q4, Shared>; break;
    case 4: kernel = qmatmul_w8a16_kernel<4, Q4, Shared>; break;
    case 8: kernel = qmatmul_w8a16_kernel<8, Q4, Shared>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  kernel<<<grid, kThreads, 0, s>>>(x, x_bf16, cq, cs, nw, residual, res_bf16, o, p, B, N, D, g,
                                   prologue, eps, kc);
  return 0;
}

// The instantiation for the code format and for whether the rows in flight share a group.
template <bool Q4>
int launch_for_group(bool shared, const dim3& grid, cudaStream_t s, int bt, const void* x,
                     int x_bf16, const int8_t* cq, const __nv_bfloat16* cs, const float* nw,
                     const void* residual, int res_bf16, float* o, float* p, int B, int N, int D,
                     int g, int prologue, float eps, int kc) {
  return shared ? launch<Q4, true>(grid, s, bt, x, x_bf16, cq, cs, nw, residual, res_bf16, o, p,
                                   B, N, D, g, prologue, eps, kc)
                : launch<Q4, false>(grid, s, bt, x, x_bf16, cq, cs, nw, residual, res_bf16, o, p,
                                    B, N, D, g, prologue, eps, kc);
}

}  // namespace

// Plain C entry point.  Pointers are device pointers (codes/scales/norm_w already offset to
// the layer).  `q4`: codes are nibble-packed [N/2, D] (g even).  The wrapper guarantees
// N % 8 == 0 and kc % 8 == 0.  `bt` is the activation row tile (1, 2, 4 or 8); `kc` the
// rows of N per split; `partial` holds splits*B*D floats when splits > 1.  Returns
// cudaGetLastError().
extern "C" int qmatmul_w8a16(const void* x, int x_bf16, const void* codes, const void* scales,
                             const void* norm_w, const void* residual, int res_bf16, void* out,
                             void* partial, int B, int N, int D, int g, int prologue, float eps,
                             int bt, int kc, int splits, int q4, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((D + kBlockCols - 1) / kBlockCols, splits, (B + bt - 1) / bt);
  const auto* cq = reinterpret_cast<const int8_t*>(codes);
  const auto* cs = reinterpret_cast<const __nv_bfloat16*>(scales);
  const auto* nw = reinterpret_cast<const float*>(norm_w);
  auto* o = reinterpret_cast<float*>(out);
  auto* p = reinterpret_cast<float*>(partial);
  const bool shared = rows_share_group(g, q4 != 0);
  const int bad = q4 ? launch_for_group<true>(shared, grid, s, bt, x, x_bf16, cq, cs, nw, residual,
                                              res_bf16, o, p, B, N, D, g, prologue, eps, kc)
                     : launch_for_group<false>(shared, grid, s, bt, x, x_bf16, cq, cs, nw, residual,
                                               res_bf16, o, p, B, N, D, g, prologue, eps, kc);
  if (bad) return bad;
  if (splits > 1) {
    const long bd = (long)B * D;
    qmatmul_reduce_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, s>>>(p, residual, res_bf16, o,
                                                                       splits, bd);
  }
  return (int)cudaGetLastError();
}

// Plain C entry point of the tensor-core route: the same arguments as qmatmul_w8a16 but for the
// CUDA cores' tiling, and xs, scratch of B * ceil(N / 64) * 64 bf16 for the staged activation.
// n_tile is the row tile (64, 128 or 256, at least B); the contraction's k-tiles (64 in-rows)
// go kts to a split; `partial` holds splits * B * D floats when splits > 1.  Returns cudaGetLastError() (or the error of a tensor map, negated).
extern "C" int qmatmul_w8a16_tc(const void* x, int x_bf16, void* xs, const void* codes,
                                const void* scales, const void* norm_w, const void* residual,
                                int res_bf16, void* out, void* partial, int B, int N, int D, int g,
                                int prologue, float eps, int q4, int n_tile, int splits, int kts,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int kp = (N + tc::kSlots - 1) / tc::kSlots * tc::kSlots;
  auto* xb = reinterpret_cast<__nv_bfloat16*>(xs);
  tc::stage_x(s, x, x_bf16, reinterpret_cast<const float*>(norm_w), prologue, eps, B, N, g, q4, kp, xb);
  CUtensorMap xm, cm;
  const int e = tc::make_maps(&xm, &cm, xb, B, kp, n_tile, codes, q4 ? N / 2 : N, D, q4 != 0);
  if (e) return e;
  const int bd = tc::tile_cols(n_tile);
  auto* o = reinterpret_cast<float*>(out);
  auto* p = reinterpret_cast<float*>(partial);
  const tc::Args a{reinterpret_cast<const __nv_bfloat16*>(scales), D, N / g, g, B, D, 0,
                   (D + bd - 1) / bd, 1, splits, kts, kp / tc::kSlots, splits > 1 ? p : o,
                   residual, res_bf16};
  const bool uniform = g % 64 == 0;
  int rc;
  switch (n_tile) {
    case 64: rc = tc::launch_for<64>(q4 != 0, uniform, xm, cm, a, s); break;
    case 128: rc = tc::launch_for<128>(q4 != 0, uniform, xm, cm, a, s); break;
    case 256: rc = tc::launch_for<256>(q4 != 0, uniform, xm, cm, a, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  if (splits > 1) {
    const long bd_ = (long)B * D;
    qmatmul_reduce_kernel<<<(unsigned)((bd_ + 255) / 256), 256, 0, s>>>(p, residual, res_bf16, o,
                                                                         splits, bd_);
  }
  return (int)cudaGetLastError();
}
