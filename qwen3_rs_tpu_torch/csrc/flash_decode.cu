// Position-bounded GQA decode attention (S = 1) for Hopper (sm_90a).
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/flash_attention.py::flash_gqa_decode_stacked.
// For each batch row b and query head h (kv head h / kv_mul) it attends over the cache rows
// t < pos[b] of layer `layer` plus the step's own key/value (not cached yet):
//   out = softmax([q.k_self, q.K[0:pos]] / sqrt(hd)) . [v_self; V[0:pos]].
// f32, bf16 and INT8 caches; for INT8 the per-row K scale multiplies the score before the
// max and the per-row V scale multiplies the probability before P.V, as the Pallas kernel.
//
// Bound on the H100: bytes.  Every valid cache row is read once (2 * pos * hd elements per
// kv head), against ~4 flops per element.
// Design against that bound:
//  * one block per (batch row, kv head, 128-row chunk of the cache): the kv head's kv_mul
//    query heads share every K/V row the block reads, and split-KV gives the card enough
//    blocks at B = 1 (8 kv heads alone would fill 8 of 132 SMs);
//  * blocks whose chunk starts at or past pos[b] return at once, and no row >= pos[b] is read;
//  * a warp reads one 128-wide row per load (lane = 4 consecutive elements: 16 B in f32),
//    and keeps 8 rows of K and V in flight before it computes on them;
//  * each warp keeps an online softmax (m, l, acc) per query head; the block merges its
//    warps in shared memory and writes one partial (m, l, acc) per chunk;
//  * a second pass per (batch row, kv head) seeds the softmax with the self key (m = q.k_self,
//    l = 1, acc = v_self, as the Pallas kernel) and merges the chunks in order, so the result
//    does not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;     // head_dim
constexpr int kChunk = 128;  // cache rows per block
constexpr int kWarps = 4;
constexpr int kRows = 8;     // rows per warp in flight

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float* o) {
  const char4 v = *reinterpret_cast<const char4*>(p);
  o[0] = (float)v.x; o[1] = (float)v.y; o[2] = (float)v.z; o[3] = (float)v.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: one partial (m, l, acc) per (batch row, kv head, chunk) with rows below pos[b].
// k/v: layer base of [B, n_kv, t_max, hd]; ks/vs: layer base of [B, n_kv, t_max] or null.
// part_ml: [B * n_kv, n_chunks, M, 2]; part_acc: [B * n_kv, n_chunks, M, hd].
template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            int n_kv, int t_max, float scale, float* __restrict__ part_ml,
                            float* __restrict__ part_acc) {
  __shared__ float sm_m[kWarps][M];
  __shared__ float sm_l[kWarps][M];
  __shared__ __align__(16) float sm_acc[kWarps][M][kHd];

  const int bh = blockIdx.y;  // b * n_kv + kv head
  const int b = bh / n_kv, h = bh % n_kv;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int p = min(max(pos[b], 0), t_max);  // a pos past the cache reads no row past it
  const int t0 = chunk * kChunk;
  if (t0 >= p) return;
  const int t1 = min(p, t0 + kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    load4(q + ((long)b * n_kv * M + h * M + m) * kHd + lane * 4, qr[m]);
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[m][i] *= scale;
  }
  float mrun[M], lrun[M], acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  }

  const long row0 = (long)bh * t_max;  // first cache row of this (b, kv head)
  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    float kf[kRows][4], vf[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tb + r < t1) {
        load4(k + (row0 + tb + r) * kHd + lane * 4, kf[r]);
        load4(v + (row0 + tb + r) * kHd + lane * 4, vf[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) kf[r][i] = vf[r][i] = 0.f;
      }
    }
    float ksc[kRows], vsc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = tb + r < t1;
      ksc[r] = (ks != nullptr && ok) ? ks[row0 + tb + r] : 1.f;
      vsc[r] = (vs != nullptr && ok) ? vs[row0 + tb + r] : 1.f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s[kRows];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float d = qr[m][0] * kf[r][0];
        d = fmaf(qr[m][1], kf[r][1], d);
        d = fmaf(qr[m][2], kf[r][2], d);
        d = fmaf(qr[m][3], kf[r][3], d);
        d = warp_sum(d) * ksc[r];
        s[r] = tb + r < t1 ? d : -INFINITY;
        mx = fmaxf(mx, s[r]);
      }
      const float m_new = fmaxf(mrun[m], mx);  // finite: row tb is valid
      const float corr = expf(mrun[m] - m_new);
      lrun[m] *= corr;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] *= corr;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = expf(s[r] - m_new);
        lrun[m] += pr;
        const float pv = pr * vsc[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][i] = fmaf(pv, vf[r][i], acc[m][i]);
      }
      mrun[m] = m_new;
    }
  }

  // Merge the warps (a warp with no rows carries m = -inf, l = 0, acc = 0).
#pragma unroll
  for (int m = 0; m < M; ++m) {
    if (lane == 0) {
      sm_m[warp][m] = mrun[m];
      sm_l[warp][m] = lrun[m];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][m][lane * 4 + i] = acc[m][i];
  }
  __syncthreads();
  const int d = threadIdx.x;  // kHd == blockDim.x
  const long slot = ((long)bh * n_chunks + chunk) * M;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][m]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(sm_m[w][m] - mm);
      l = fmaf(sm_l[w][m], c, l);
      a = fmaf(sm_acc[w][m][d], c, a);
    }
    part_acc[(slot + m) * kHd + d] = a;
    if (d == 0) {
      part_ml[(slot + m) * 2] = mm;
      part_ml[(slot + m) * 2 + 1] = l;
    }
  }
}

// Pass 2: seed with the self key and merge the chunks below pos[b] in order.
// q: [B, n_kv * M, hd]; k_new/v_new: [B, n_kv, hd]; out: [B, n_kv * M, hd].
template <int M>
__global__ void __launch_bounds__(kHd)
flash_decode_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                          const float* __restrict__ v_new, const int* __restrict__ pos,
                          int n_kv, int n_chunks, float scale, const float* __restrict__ part_ml,
                          const float* __restrict__ part_acc, float* __restrict__ out) {
  __shared__ float red[kHd / 32][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv, h = bh % n_kv;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const float kd = k_new[(long)bh * kHd + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = warp_sum(q[((long)b * n_kv * M + h * M + m) * kHd + d] * scale * kd);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (min(max(pos[b], 0), n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * kHd + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = 0.f;
#pragma unroll
    for (int w = 0; w < kHd / 32; ++w) mcur += red[w][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * M + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * kHd + d] * cj;
      mcur = m_new;
    }
    out[((long)b * n_kv * M + h * M + m) * kHd + d] = a / l;
  }
}

template <typename T, int M>
void launch(const void* q, const void* k_new, const void* v_new, const void* k,
            const void* v, const void* ks, const void* vs, const int* pos, int B, int n_kv,
            int t_max, float scale, float* part_ml, float* part_acc, float* out,
            cudaStream_t s) {
  const int n_chunks = (t_max + kChunk - 1) / kChunk;
  flash_decode_partial_kernel<T, M><<<dim3(n_chunks, B * n_kv), kWarps * 32, 0, s>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), reinterpret_cast<const float*>(ks),
      reinterpret_cast<const float*>(vs), pos, n_kv, t_max, scale, part_ml, part_acc);
  flash_decode_merge_kernel<M><<<B * n_kv, kHd, 0, s>>>(
      reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
      reinterpret_cast<const float*>(v_new), pos, n_kv, n_chunks, scale, part_ml, part_acc,
      out);
}

template <typename T>
int dispatch_m(int kv_mul, const void* q, const void* k_new, const void* v_new, const void* k,
               const void* v, const void* ks, const void* vs, const int* pos, int B, int n_kv,
               int t_max, float scale, float* part_ml, float* part_acc, float* out,
               cudaStream_t s) {
  switch (kv_mul) {
    case 1: launch<T, 1>(q, k_new, v_new, k, v, ks, vs, pos, B, n_kv, t_max, scale, part_ml, part_acc, out, s); break;
    case 2: launch<T, 2>(q, k_new, v_new, k, v, ks, vs, pos, B, n_kv, t_max, scale, part_ml, part_acc, out, s); break;
    case 4: launch<T, 4>(q, k_new, v_new, k, v, ks, vs, pos, B, n_kv, t_max, scale, part_ml, part_acc, out, s); break;
    case 8: launch<T, 8>(q, k_new, v_new, k, v, ks, vs, pos, B, n_kv, t_max, scale, part_ml, part_acc, out, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// Plain C entry point.  q [B, n_kv * kv_mul, 128] f32, k_new/v_new [B, n_kv, 128] f32, k/v the
// layer's cache base [B, n_kv, t_max, 128] (cache_type 0 = f32, 1 = bf16, 2 = int8 with
// ks/vs [B, n_kv, t_max] f32), pos [B] int32 on the device, workspaces of
// B * n_kv * ceil(t_max / 128) * kv_mul * (2 | 128) floats.  Returns cudaGetLastError().
extern "C" int flash_decode(const void* q, const void* k_new, const void* v_new, const void* k,
                            const void* v, const void* ks, const void* vs, const void* pos,
                            int cache_type, int B, int n_kv, int kv_mul, int t_max, float scale,
                            void* part_ml, void* part_acc, void* out, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int* p = reinterpret_cast<const int*>(pos);
  float* ml = reinterpret_cast<float*>(part_ml);
  float* pa = reinterpret_cast<float*>(part_acc);
  float* o = reinterpret_cast<float*>(out);
  int rc;
  switch (cache_type) {
    case 0: rc = dispatch_m<float>(kv_mul, q, k_new, v_new, k, v, nullptr, nullptr, p, B, n_kv, t_max, scale, ml, pa, o, s); break;
    case 1: rc = dispatch_m<__nv_bfloat16>(kv_mul, q, k_new, v_new, k, v, nullptr, nullptr, p, B, n_kv, t_max, scale, ml, pa, o, s); break;
    case 2: rc = dispatch_m<int8_t>(kv_mul, q, k_new, v_new, k, v, ks, vs, p, B, n_kv, t_max, scale, ml, pa, o, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
