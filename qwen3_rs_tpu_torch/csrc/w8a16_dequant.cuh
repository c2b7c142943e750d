// Weight dequantization and the tile dot product on the CUDA cores, of the launch-boundary
// probe's one-call kernel (csrc/boundary_probe.cu): int8 codes,
// or INT4 codes nibble-packed group split-half along the in axis (byte row k*g/2 + j of group k
// holds in-row k*g + j in its low nibble and in-row k*g + g/2 + j in its high nibble, each
// stored as code + 8).
//
// Each weight element is bf16(bf16(code) * bf16(scale)), as f32.  The conversions use the
// exponent trick (a byte permute and one f32 subtract), not a conversion instruction.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// 16 int8 codes with each byte xor 0x80: the biased form dequant16<false> takes.
__device__ __forceinline__ uint4 xor4(const uint4& c, uint32_t m) {
  return make_uint4(c.x ^ m, c.y ^ m, c.z ^ m, c.w ^ m);
}

// The low (shift 0) or high (shift 4) nibbles of 16 packed bytes, one per byte.
__device__ __forceinline__ uint4 nibbles4(const uint4& c, int shift) {
  return make_uint4((c.x >> shift) & 0x0F0F0F0Fu, (c.y >> shift) & 0x0F0F0F0Fu,
                    (c.z >> shift) & 0x0F0F0F0Fu, (c.w >> shift) & 0x0F0F0F0Fu);
}

// Loads the bf16 scales of group `grp` for 16 columns from col0 into sf, as f32.
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

constexpr int kCodeRowsInFlight = 4;  // code rows a thread loads before it computes on them

// The activation in-row that staged slot r of a tile starting at in-row t0 (even) holds.
// INT8: t0 + r.  INT4: the slots go in packed order, two per packed row (its low, then its
// high nibble), so the tile covers packed rows t0/2 + r/2 and need not hold whole groups:
// any even group size works.
template <bool Q4>
__device__ __forceinline__ int staged_row(int t0, int r, int g) {
  if constexpr (Q4) {
    const int h = g / 2, pr = t0 / 2 + r / 2;
    return (pr / h) * g + pr % h + (r & 1) * h;
  } else {
    return t0 + r;
  }
}

// The f32 scales of one thread's 16 columns for the group of the code row it reads; they are
// loaded again only where a row leaves the group (code rows [begin, end)).
struct GroupScales {
  float sf[16];
  int begin = 0, end = 0;
  __device__ __forceinline__ void at(const __nv_bfloat16* __restrict__ scales, int row,
                                     int rows_per_group, int D, int col0) {
    if (row < begin || row >= end) {
      const int grp = row / rows_per_group;
      load_scales(scales, grp, D, col0, sf);
      begin = grp * rows_per_group;
      end = begin + rows_per_group;
    }
  }
};

// Whether the code rows in flight always share a group (their first row is a multiple of 4):
// code rows per group (INT8: g; INT4: g/2 packed rows) a multiple of 4.  The kernels then take
// the instantiation of tile_dot that checks the group once per 4 rows.
__device__ __host__ __forceinline__ bool rows_share_group(int g, bool q4) {
  return (q4 ? g / 2 : g) % kCodeRowsInFlight == 0;
}

// One warp's share of a staged tile, for one thread's 16 columns from col0: code rows
// row0 + rb for rb = first, first + stride, ... below n_rows (a multiple of 4), 4 in flight;
// acc[b][e] += x[b][in-row] * w[in-row][col0 + e].  xs holds the tile's activation rows
// [BT][xs_stride] in slot order (staged_row): INT8 code row row0 + rb is slot rb, INT4 packed
// row row0 + rb is slots 2 rb (low nibbles) and 2 rb + 1 (high nibbles).  Shared: the rows in
// flight share a group (rows_share_group), so the scales are checked once per 4 rows.
template <int BT, bool Q4, bool Shared>
__device__ __forceinline__ void tile_dot(const int8_t* __restrict__ codes,
                                         const __nv_bfloat16* __restrict__ scales, int D, int g,
                                         int col0, long row0, int n_rows, int first, int stride,
                                         const float* xs, int xs_stride, GroupScales& gs,
                                         float (&acc)[BT][16]) {
  const int rows_per_group = Q4 ? g / 2 : g;
  for (int rb = first; rb < n_rows; rb += stride) {
    uint4 c[kCodeRowsInFlight];
#pragma unroll
    for (int j = 0; j < kCodeRowsInFlight; ++j)
      c[j] = __ldg(reinterpret_cast<const uint4*>(codes + (row0 + rb + j) * D + col0));
#pragma unroll
    for (int j = 0; j < kCodeRowsInFlight; ++j) {
      if (!Shared || j == 0) gs.at(scales, static_cast<int>(row0 + rb + j), rows_per_group, D, col0);
#pragma unroll
      for (int half = 0; half < (Q4 ? 2 : 1); ++half) {
        float w[16];
        if constexpr (Q4) dequant16<true>(nibbles4(c[j], 4 * half), gs.sf, w);
        else dequant16<false>(xor4(c[j], 0x80808080u), gs.sf, w);
        const int slot = Q4 ? 2 * (rb + j) + half : rb + j;
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float xv = xs[b * xs_stride + slot];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[b][e] = fmaf(xv, w[e], acc[b][e]);
        }
      }
    }
  }
}

}  // namespace
