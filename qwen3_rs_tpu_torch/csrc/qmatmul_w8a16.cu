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
//  * row tiles of up to 8 activation rows (grid.z) keep prefill windows (B <= 256) correct
//    without holding B x 16 accumulators per thread; tensor cores are left for a later version.
// INT4: the bound halves (N*D/2 code bytes).  A 16-byte load along D holds 16 columns of two
// in-rows, j and j + g/2 of one group; the thread dequantizes the low nibbles, accumulates them
// against activation row j, then the high nibbles against row j + g/2.  Splits and staged tiles
// cover whole groups (g divides 256 and the split length), so both rows are always staged.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerThread = 16;
constexpr int kBlockCols = 32 * kColsPerThread;  // 512 output columns per block
constexpr int kRowsPerBatch = 4;                 // code rows in flight per thread
constexpr int kTileRows = 256;                   // activation rows staged per pass

enum Prologue { kNone = 0, kRms = 1, kSwiglu = 2 };

__device__ __forceinline__ float load_act(const void* p, int is_bf16, long i) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// Byte k of `biased` (an int8 code xor 0x80, i.e. code + 128) as the float code, exactly:
// 0x4B0000xx is 2^23 + xx, so subtracting 2^23 + 128 leaves the signed code.
template <int K>
__device__ __forceinline__ float code_at(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | K)) - 8388736.0f;
}

// Byte k of `nibbles` (a biased INT4 code, code + 8, in 0..15) as the float code, exactly.
template <int K>
__device__ __forceinline__ float q4_code_at(uint32_t nibbles) {
  return __uint_as_float(__byte_perm(nibbles, 0x4B000000u, 0x7650 | K)) - 8388616.0f;
}

// 16 codes of one row times their bf16 scales, each product rounded to bf16, as f32.  `biased`
// holds 16 int8 codes xor 0x80 (Q4 = false) or 16 biased INT4 codes, one per byte (Q4 = true).
template <bool Q4>
__device__ __forceinline__ void dequant16(const uint4& biased, const float* sf, float* w) {
  const uint32_t words[4] = {biased.x, biased.y, biased.z, biased.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float c0, c1, c2, c3;
    if constexpr (Q4) {
      c0 = q4_code_at<0>(words[q]), c1 = q4_code_at<1>(words[q]);
      c2 = q4_code_at<2>(words[q]), c3 = q4_code_at<3>(words[q]);
    } else {
      c0 = code_at<0>(words[q]), c1 = code_at<1>(words[q]);
      c2 = code_at<2>(words[q]), c3 = code_at<3>(words[q]);
    }
    const float2 lo = __bfloat1622float2(__floats2bfloat162_rn(c0 * sf[4 * q], c1 * sf[4 * q + 1]));
    const float2 hi =
        __bfloat1622float2(__floats2bfloat162_rn(c2 * sf[4 * q + 2], c3 * sf[4 * q + 3]));
    w[4 * q] = lo.x;
    w[4 * q + 1] = lo.y;
    w[4 * q + 2] = hi.x;
    w[4 * q + 3] = hi.y;
  }
}

__device__ __forceinline__ uint4 xor4(const uint4& c, uint32_t m) {
  return make_uint4(c.x ^ m, c.y ^ m, c.z ^ m, c.w ^ m);
}

__device__ __forceinline__ uint4 nibbles4(const uint4& c, int shift) {
  return make_uint4((c.x >> shift) & 0x0F0F0F0Fu, (c.y >> shift) & 0x0F0F0F0Fu,
                    (c.z >> shift) & 0x0F0F0F0Fu, (c.w >> shift) & 0x0F0F0F0Fu);
}

// Loads the bf16 scales of group `grp` for this thread's 16 columns into sf, as f32.
__device__ __forceinline__ void load_scales(const __nv_bfloat16* __restrict__ scales, int grp,
                                            int D, int col0, float* sf) {
  const uint4* sp = reinterpret_cast<const uint4*>(scales + (long)grp * D + col0);
  const uint4 s0 = __ldg(sp), s1 = __ldg(sp + 1);
  const uint32_t sw[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&sw[e]));
    sf[2 * e] = f.x;
    sf[2 * e + 1] = f.y;
  }
}

template <int BT, bool Q4>
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
  float sf[kColsPerThread];
  int cur_grp = -1;

  for (int t0 = k_begin; t0 < k_end; t0 += kTileRows) {
    const int rows = min(kTileRows, k_end - t0);  // a multiple of 4
    for (int i = tid; i < BT * kTileRows; i += kThreads) {
      const int b = i / kTileRows, r = i % kTileRows;
      float v = 0.f;
      if (r < rows && row0 + b < B) {
        const long base = (row0 + b) * xw;
        const int n = t0 + r;
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
    if (active && Q4) {
      // Packed rows of the tile: rows / 2, a multiple of 4 (g % 8 == 0); 4 in flight share a group.
      const int h = g / 2;
      for (int pb = warp * kRowsPerBatch; pb < rows / 2; pb += kWarps * kRowsPerBatch) {
        const long pr = t0 / 2 + pb;  // packed row
        uint4 c[kRowsPerBatch];
#pragma unroll
        for (int j = 0; j < kRowsPerBatch; ++j)
          c[j] = __ldg(reinterpret_cast<const uint4*>(codes + (pr + j) * D + col0));
        const int grp = static_cast<int>(pr / h);
        if (grp != cur_grp) {
          load_scales(scales, grp, D, col0, sf);
          cur_grp = grp;
        }
        const int lo = grp * g + static_cast<int>(pr % h) - t0;  // staged row of the low nibbles
#pragma unroll
        for (int j = 0; j < kRowsPerBatch; ++j) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float w[kColsPerThread];
            dequant16<true>(nibbles4(c[j], 4 * half), sf, w);
            const int r = lo + j + half * h;
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              const float xv = xs[b][r];
#pragma unroll
              for (int e = 0; e < kColsPerThread; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
            }
          }
        }
      }
    } else if (active) {
      for (int rb = warp * kRowsPerBatch; rb < rows; rb += kWarps * kRowsPerBatch) {
        const int n = t0 + rb;
        uint4 c[kRowsPerBatch];
#pragma unroll
        for (int j = 0; j < kRowsPerBatch; ++j)
          c[j] = __ldg(reinterpret_cast<const uint4*>(codes + (long)(n + j) * D + col0));
        const int grp = n / g;  // g % 4 == 0: the 4 rows share a group
        if (grp != cur_grp) {
          load_scales(scales, grp, D, col0, sf);
          cur_grp = grp;
        }
#pragma unroll
        for (int j = 0; j < kRowsPerBatch; ++j) {
          float w[kColsPerThread];
          dequant16<false>(xor4(c[j], 0x80808080u), sf, w);
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            const float xv = xs[b][rb + j];
#pragma unroll
            for (int e = 0; e < kColsPerThread; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
          }
        }
      }
    }
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

template <bool Q4>
int launch(const dim3& grid, cudaStream_t s, int bt, const void* x, int x_bf16, const int8_t* cq,
           const __nv_bfloat16* cs, const float* nw, const void* residual, int res_bf16, float* o,
           float* p, int B, int N, int D, int g, int prologue, float eps, int kc) {
  switch (bt) {
    case 1:
      qmatmul_w8a16_kernel<1, Q4><<<grid, kThreads, 0, s>>>(x, x_bf16, cq, cs, nw, residual,
                                                            res_bf16, o, p, B, N, D, g, prologue,
                                                            eps, kc);
      return 0;
    case 2:
      qmatmul_w8a16_kernel<2, Q4><<<grid, kThreads, 0, s>>>(x, x_bf16, cq, cs, nw, residual,
                                                            res_bf16, o, p, B, N, D, g, prologue,
                                                            eps, kc);
      return 0;
    case 4:
      qmatmul_w8a16_kernel<4, Q4><<<grid, kThreads, 0, s>>>(x, x_bf16, cq, cs, nw, residual,
                                                            res_bf16, o, p, B, N, D, g, prologue,
                                                            eps, kc);
      return 0;
    case 8:
      qmatmul_w8a16_kernel<8, Q4><<<grid, kThreads, 0, s>>>(x, x_bf16, cq, cs, nw, residual,
                                                            res_bf16, o, p, B, N, D, g, prologue,
                                                            eps, kc);
      return 0;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point.  Pointers are device pointers (codes/scales/norm_w already offset to
// the layer).  `q4`: codes are nibble-packed [N/2, D] (the wrapper guarantees g % 8 == 0,
// 256 % g == 0 and kc % g == 0).  `bt` is the activation row tile (1, 2, 4 or 8); `kc` the
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
  const int bad = q4 ? launch<true>(grid, s, bt, x, x_bf16, cq, cs, nw, residual, res_bf16, o, p,
                                    B, N, D, g, prologue, eps, kc)
                     : launch<false>(grid, s, bt, x, x_bf16, cq, cs, nw, residual, res_bf16, o, p,
                                     B, N, D, g, prologue, eps, kc);
  if (bad) return bad;
  if (splits > 1) {
    const long bd = (long)B * D;
    qmatmul_reduce_kernel<<<(unsigned)((bd + 255) / 256), 256, 0, s>>>(p, residual, res_bf16, o,
                                                                       splits, bd);
  }
  return (int)cudaGetLastError();
}
