// Streaming INT8 -> bf16 weight dequantization for Hopper (sm_90a): W[N, D] = bf16(code * scale).
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::dequant_pallas_stacked (default impl "f32"),
// the first half of the long-prefill "xdot" path: one layer's codes become a dense bf16 matrix
// that a plain large matrix product then consumes.  The layer offset is a pointer offset made by
// the wrapper.
//
// Numerics: the product code * scale is taken in f32 and rounded once to bf16.  f32 scales are
// used as given (unrounded); bf16 scales are exact in f32.
//
// INT4 (dequant_q4, the Q4 branch of the same Pallas kernel): codes are nibble-packed [N/2, D]
// (group split-half along N, code + 8 per nibble).  The Pallas kernel always takes its "int"
// unpack there: a bf16 product with the scales rounded to bf16 first, i.e.
// bf16((nibble - 8) * bf16(scale)) (the product is exact in f32 before that one rounding).  So
// f32 scales are rounded to bf16 here, unlike the INT8 path.  One 16-byte load of packed codes
// gives 16 columns of two output rows, j and j + g/2 of a group.
//
// Bound on the H100: pure data movement, 1 byte read and 2 bytes written per weight plus the
// scales (2 or 4 bytes per group of g weights), at 3.35 TB/s.  Design: each thread converts 16
// adjacent codes of one row with one 16-byte load, reads their 16 scales (L1/L2 hits: a scale
// row serves g code rows) and writes 32 bytes; neighbouring threads touch neighbouring addresses.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float code_of(uint32_t word, int byte) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * byte)) & 0xffu));
}

__device__ __forceinline__ void load_scales16(const float* p, float* s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
    s[4 * i] = v.x;
    s[4 * i + 1] = v.y;
    s[4 * i + 2] = v.z;
    s[4 * i + 3] = v.w;
  }
}

__device__ __forceinline__ void load_scales16(const __nv_bfloat16* p, float* s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      s[8 * i + 2 * j] = f.x;
      s[8 * i + 2 * j + 1] = f.y;
    }
  }
}

template <typename Scale>
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int8_t* __restrict__ codes, const Scale* __restrict__ scales,
               __nv_bfloat16* __restrict__ out, long chunks, int D, int g) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;  // a chunk of 16 codes
  if (i >= chunks) return;
  const long e = i * 16;
  const long row = e / D;
  const int col = static_cast<int>(e - row * D);
  const uint4 c = __ldg(reinterpret_cast<const uint4*>(codes + e));
  float s[16];
  load_scales16(scales + (row / g) * D + col, s);
  const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
  uint32_t w[8];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(code_of(cw[q], 2 * h) * s[4 * q + 2 * h],
                                                     code_of(cw[q], 2 * h + 1) * s[4 * q + 2 * h + 1]);
      w[2 * q + h] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
  uint4* dst = reinterpret_cast<uint4*>(out + e);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__device__ __forceinline__ void round_scales_bf16(float* s) {
#pragma unroll
  for (int i = 0; i < 16; ++i) s[i] = __bfloat162float(__float2bfloat16_rn(s[i]));
}

// Packed INT4 codes: `chunks` = (N/2)*D/16 chunks of 16 packed bytes.
template <typename Scale>
__global__ void __launch_bounds__(kThreads)
dequant_q4_kernel(const uint8_t* __restrict__ codes, const Scale* __restrict__ scales,
                  __nv_bfloat16* __restrict__ out, long chunks, int D, int g) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= chunks) return;
  const long e = i * 16;
  const long prow = e / D;  // packed row
  const int col = static_cast<int>(e - prow * D);
  const int h = g / 2;
  const long grp = prow / h;
  const long lo_row = grp * g + prow % h;
  const uint4 c = __ldg(reinterpret_cast<const uint4*>(codes + e));
  float s[16];
  load_scales16(scales + grp * D + col, s);
  round_scales_bf16(s);
  const uint32_t cw[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t nib = (cw[q] >> (4 * half)) & 0x0F0F0F0Fu;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float c0 = static_cast<float>((nib >> (16 * k)) & 0xFu) - 8.f;
        const float c1 = static_cast<float>((nib >> (16 * k + 8)) & 0xFu) - 8.f;
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(c0 * s[4 * q + 2 * k], c1 * s[4 * q + 2 * k + 1]);
        w[2 * q + k] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(out + (lo_row + half * h) * D + col);
    dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
    dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

}  // namespace

// Plain C entry point.  codes [N/2, D] packed INT4 and scales [N/g, D] (f32 when scales_f32,
// else bf16) are device pointers already offset to the layer; out [N, D] bf16.  The wrapper
// guarantees D % 16 == 0, g even and 16-byte alignment.  Returns cudaGetLastError().
extern "C" int dequant_q4(const void* codes, const void* scales, int scales_f32, void* out, int N,
                          int D, int g, void* stream) {
  const long chunks = (long)(N / 2) * D / 16;
  const unsigned blocks = static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* cq = reinterpret_cast<const uint8_t*>(codes);
  auto* o = reinterpret_cast<__nv_bfloat16*>(out);
  if (scales_f32)
    dequant_q4_kernel<float><<<blocks, kThreads, 0, s>>>(
        cq, reinterpret_cast<const float*>(scales), o, chunks, D, g);
  else
    dequant_q4_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        cq, reinterpret_cast<const __nv_bfloat16*>(scales), o, chunks, D, g);
  return (int)cudaGetLastError();
}

// Plain C entry point.  codes [N, D] int8 and scales [N/g, D] (f32 when scales_f32, else bf16)
// are device pointers already offset to the layer; out [N, D] bf16.  The wrapper guarantees
// D % 16 == 0 and 16-byte alignment.  Returns cudaGetLastError().
extern "C" int dequant_w8(const void* codes, const void* scales, int scales_f32, void* out, int N,
                          int D, int g, void* stream) {
  const long chunks = (long)N * D / 16;
  const unsigned blocks = static_cast<unsigned>((chunks + kThreads - 1) / kThreads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* cq = reinterpret_cast<const int8_t*>(codes);
  auto* o = reinterpret_cast<__nv_bfloat16*>(out);
  if (scales_f32)
    dequant_kernel<float><<<blocks, kThreads, 0, s>>>(cq, reinterpret_cast<const float*>(scales),
                                                      o, chunks, D, g);
  else
    dequant_kernel<__nv_bfloat16><<<blocks, kThreads, 0, s>>>(
        cq, reinterpret_cast<const __nv_bfloat16*>(scales), o, chunks, D, g);
  return (int)cudaGetLastError();
}
