// The launch-boundary probe's one-call arm for Hopper (sm_90a): y[l] = x . dequant(W[l]) for
// every layer of a stacked INT8-g weight, all layers streamed reps times by one launch.
//
// Replaces the Pallas kernel of scripts/boundary_probe.py:98 (`onecall`: one pallas_call whose
// grid has a leading layer axis over reps*L layers, body qwen3_rs_tpu/ops/pallas/qmatmul.py:480
// `_kernel_stacked`).  The probe sets it against L separate launches of the W8A16 kernel
// (csrc/qmatmul_w8a16.cu), eager and in a CUDA graph: the difference per layer is the price of
// a launch boundary.
//
// Numerics, as the W8A16 kernel (#2, "scale_w"): x is rounded to bf16, each weight element is
// bf16(bf16(code) * bf16(scale)) (csrc/w8a16_dequant.cuh), products accumulate in f32.  Each
// rep overwrites y[l] with the same value, so the result is deterministic and equals #2's
// layer l within #2's tolerance (another f32 summation order).
//
// Bound on the H100: the bytes of the weights, reps * L * (N*D codes + 2*N*D/g scale bytes), at
// 3.35 TB/s; two flops per code byte are far under the tensor-free f32 rate.
// Design:
//  * the sequential layer axis of the TPU grid becomes a loop inside each block: a block owns a
//    strip of 16*TC columns and runs the full depth N of every layer, so no split-K pass and no
//    second launch is needed;
//  * TC (2..32 threads across a strip) is picked by the wrapper so that there are about as many
//    strips as SMs; the other 256/TC threads of the block split the rows, four consecutive rows
//    in flight each (one group of scales per four rows), 16-byte loads along D;
//  * x is staged once, rounded to bf16, in dynamic shared memory: every layer reads the same x;
//  * partial sums meet by warp shuffles across the row lanes of a warp, then across the 8 warps
//    in shared memory in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_dequant.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int TC, bool Shared>
__global__ void __launch_bounds__(kThreads)
boundary_onecall_kernel(const float* __restrict__ x, const int8_t* __restrict__ codes,
                        const __nv_bfloat16* __restrict__ scales, float* __restrict__ y, int N,
                        int D, int g, int L, int passes) {
  constexpr int SW = 16 * TC;                 // columns of the block's strip
  constexpr int R = kThreads / TC;            // row lanes of the block
  extern __shared__ float xs[];               // [N], x rounded to bf16
  __shared__ __align__(16) float red[kWarps][SW];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ct = tid % TC, rl = tid / TC;
  const int strip0 = blockIdx.x * SW;
  const int col0 = strip0 + ct * 16;
  for (int i = tid; i < N; i += kThreads) xs[i] = __bfloat162float(__float2bfloat16_rn(x[i]));
  __syncthreads();

  const long layer_codes = (long)N * D, layer_scales = (long)(N / g) * D;
  for (int p = 0; p < passes; ++p) {
    const int l = p % L;
    float acc[1][16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[0][e] = 0.f;
    GroupScales gs;
    tile_dot<1, false, Shared>(codes + l * layer_codes, scales + l * layer_scales, D, g, col0, 0, N,
                               kCodeRowsInFlight * rl, kCodeRowsInFlight * R, xs, N, gs, acc);
    // Lanes of a warp with the same column thread hold parts of the same 16 columns.
#pragma unroll
    for (int o = TC; o < 32; o <<= 1)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[0][e] += __shfl_xor_sync(0xffffffffu, acc[0][e], o);
    if (lane < TC) {
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        *reinterpret_cast<float4*>(&red[warp][lane * 16 + e]) =
            make_float4(acc[0][e], acc[0][e + 1], acc[0][e + 2], acc[0][e + 3]);
    }
    __syncthreads();
    for (int c = tid; c < SW; c += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][c];
      y[(long)l * D + strip0 + c] = s;
    }
    __syncthreads();  // red is read before the next layer writes it
  }
}

template <int TC>
int launch(cudaStream_t s, bool shared, const float* x, const int8_t* c,
           const __nv_bfloat16* sc, float* y, int N, int D, int g, int L, int passes) {
  const int smem = N * (int)sizeof(float);
  auto kernel = shared ? boundary_onecall_kernel<TC, true> : boundary_onecall_kernel<TC, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<D / (16 * TC), kThreads, smem, s>>>(x, c, sc, y, N, D, g, L, passes);
  return 0;
}

}  // namespace

// Plain C entry point.  x f32 [N], codes int8 [L, N, D], scales bf16 [L, N/g, D], y f32 [L, D],
// all contiguous device pointers; `passes` = reps * L layers are streamed in the order
// 0, 1, .., L-1, 0, ..; tc (2, 4, 8, 16 or 32) divides D/16; N % 4 == 0 and g divides N.
// Returns cudaGetLastError().
extern "C" int boundary_onecall(const void* x, const void* codes, const void* scales, void* y,
                                int N, int D, int g, int L, int passes, int tc, void* stream) {
  if (N % 4 || g <= 0 || N % g || D % (16 * tc) || L < 1 || passes < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* xf = reinterpret_cast<const float*>(x);
  const auto* c = reinterpret_cast<const int8_t*>(codes);
  const auto* sc = reinterpret_cast<const __nv_bfloat16*>(scales);
  auto* yf = reinterpret_cast<float*>(y);
  const bool shared = rows_share_group(g, false);
  int bad;
  switch (tc) {
    case 2: bad = launch<2>(s, shared, xf, c, sc, yf, N, D, g, L, passes); break;
    case 4: bad = launch<4>(s, shared, xf, c, sc, yf, N, D, g, L, passes); break;
    case 8: bad = launch<8>(s, shared, xf, c, sc, yf, N, D, g, L, passes); break;
    case 16: bad = launch<16>(s, shared, xf, c, sc, yf, N, D, g, L, passes); break;
    case 32: bad = launch<32>(s, shared, xf, c, sc, yf, N, D, g, L, passes); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (bad) return bad;
  return (int)cudaGetLastError();
}
