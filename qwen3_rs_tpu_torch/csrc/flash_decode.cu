// Position-bounded GQA decode attention (S = 1) for Hopper (sm_90a).
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/flash_attention.py::flash_gqa_decode_stacked.
// For each batch row b and query head h (kv head h / kv_mul) it attends over the cache rows
// t < pos[b] of layer `layer` plus the step's own key/value (not cached yet):
//   out = softmax([q.k_self, q.K[0:pos]] / sqrt(hd)) . [v_self; V[0:pos]].
// f32, bf16 and INT8 caches; for INT8 the per-row K scale multiplies the score before the
// max and the per-row V scale multiplies the probability before P.V, as the Pallas kernel.
// At head_dim 128 and 256 with a cache of a multiple of 16 rows the flash_decode wrapper takes
// paged_decode.cu's one-launch kernel for every cache type; this kernel takes the other shapes.
//
// Bound on the H100: bytes.  Every valid cache row is read once (2 * pos * hd elements per
// kv head), against ~4 flops per element.
// Design against that bound:
//  * one block per (batch row, kv head, 128-row chunk of the cache, group of query heads): a
//    group's M query heads share every K/V row the block reads, and split-KV gives the card
//    enough blocks at B = 1 (8 kv heads alone would fill 8 of 132 SMs).  M is the largest
//    power of two up to 8 that divides kv_mul, so any kv_mul works (3 or 5 read each row 3 or
//    5 times, once per group);
//  * blocks whose chunk starts at or past pos[b] return at once, and no row >= pos[b] is read;
//  * a warp reads one row per load (lane = 4 consecutive elements of each 128-wide piece:
//    16 B in f32), and keeps 8 rows of K and V in flight before it computes on them;
//  * head_dim is a template parameter: 128, 256, 384 or 512.  Past 128 the rows in flight and
//    the query heads per block shrink (4 at 256, 2 above), so the registers a thread holds stay
//    those of head_dim 128;
//  * any larger multiple of 128 (the reference's gate admits them all) takes the column-blocked
//    kernels: the output is split into 128-column blocks over the grid, each block computes the
//    full scores by reading q and K in 128-column pieces and keeps only its own 128 columns of V
//    and of the partials, so registers and shared memory stay those of head_dim 128 whatever the
//    head.  K is read once per column block (right first; speed is later work);
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

constexpr int kChunk = 128;  // cache rows per block
constexpr int kWarps = 4;

// Query heads per block and cache rows per warp in flight, at most: 8 at head_dim 128, fewer
// above, so that a thread's registers (q, acc, K and V rows) stay the same.
__host__ __device__ constexpr int max_group(int hd) { return hd <= 128 ? 8 : hd <= 256 ? 4 : 2; }

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

// A lane's share of one head_dim-wide row: 4 elements of each 128-wide piece.
template <typename T, int V>
__device__ __forceinline__ void load_row(const T* row, int lane, float (&o)[V][4]) {
#pragma unroll
  for (int j = 0; j < V; ++j) load4(row + j * 128 + lane * 4, o[j]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 1: one partial (m, l, acc) per (batch row, kv head, chunk, query head) with rows below
// pos[b], for the M query heads of group blockIdx.z.  k/v: layer base of [B, n_kv, t_max, HD];
// ks/vs: layer base of [B, n_kv, t_max] or null.  part_ml: [B * n_kv, n_chunks, kv_mul, 2];
// part_acc: [B * n_kv, n_chunks, kv_mul, HD].
template <typename T, int M, int HD>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ ks,
                            const float* __restrict__ vs, const int* __restrict__ pos,
                            int n_kv, int kv_mul, int t_max, float scale,
                            float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int V = HD / 128, kRows = max_group(HD);
  __shared__ float sm_m[kWarps][M];
  __shared__ float sm_l[kWarps][M];
  __shared__ __align__(16) float sm_acc[kWarps][M][HD];

  const int bh = blockIdx.y;  // b * n_kv + kv head
  const int b = bh / n_kv;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const long head0 = (long)bh * kv_mul + blockIdx.z * M;  // the group's first query head
  const int p = min(max(pos[b], 0), t_max);  // a pos past the cache reads no row past it
  const int t0 = chunk * kChunk;
  if (t0 >= p) return;
  const int t1 = min(p, t0 + kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[M][V][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    load_row<float, V>(q + (head0 + m) * HD, lane, qr[m]);
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[m][j][i] *= scale;
  }
  float mrun[M], lrun[M], acc[M][V][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  }

  const long row0 = (long)bh * t_max;  // first cache row of this (b, kv head)
  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    float kf[kRows][V][4], vf[kRows][V][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tb + r < t1) {
        load_row<T, V>(k + (row0 + tb + r) * HD, lane, kf[r]);
        load_row<T, V>(v + (row0 + tb + r) * HD, lane, vf[r]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) kf[r][j][i] = vf[r][j][i] = 0.f;
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
        float d = qr[m][0][0] * kf[r][0][0];
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int i = (j == 0 ? 1 : 0); i < 4; ++i) d = fmaf(qr[m][j][i], kf[r][j][i], d);
        d = warp_sum(d) * ksc[r];
        s[r] = tb + r < t1 ? d : -INFINITY;
        mx = fmaxf(mx, s[r]);
      }
      const float m_new = fmaxf(mrun[m], mx);  // finite: row tb is valid
      const float corr = expf(mrun[m] - m_new);
      lrun[m] *= corr;
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[m][j][i] *= corr;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pr = expf(s[r] - m_new);
        lrun[m] += pr;
        const float pv = pr * vsc[r];
#pragma unroll
        for (int j = 0; j < V; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[m][j][i] = fmaf(pv, vf[r][j][i], acc[m][j][i]);
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
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_acc[warp][m][j * 128 + lane * 4 + i] = acc[m][j][i];
  }
  __syncthreads();
  const long slot = ((long)bh * n_chunks + chunk) * kv_mul + blockIdx.z * M;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][m]);
    float c[kWarps], l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      c[w] = expf(sm_m[w][m] - mm);
      l = fmaf(sm_l[w][m], c[w], l);
    }
    for (int d = threadIdx.x; d < HD; d += kWarps * 32) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][m][d], c[w], a);
      part_acc[(slot + m) * HD + d] = a;
    }
    if (threadIdx.x == 0) {
      part_ml[(slot + m) * 2] = mm;
      part_ml[(slot + m) * 2 + 1] = l;
    }
  }
}

// Pass 2: seed with the self key and merge the chunks below pos[b] in order, for the M query
// heads of group blockIdx.y; one thread per element of head_dim.  q: [B, n_kv * kv_mul, HD];
// k_new/v_new: [B, n_kv, HD]; out like q.
template <int M, int HD>
__global__ void __launch_bounds__(HD)
flash_decode_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                          const float* __restrict__ v_new, const int* __restrict__ pos,
                          int n_kv, int kv_mul, int n_chunks, float scale,
                          const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                          float* __restrict__ out) {
  __shared__ float red[HD / 32][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv;
  const int m0 = blockIdx.y * M;
  const long head0 = (long)bh * kv_mul + m0;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const float kd = k_new[(long)bh * HD + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = warp_sum(q[(head0 + m) * HD + d] * scale * kd);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (min(max(pos[b], 0), n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * HD + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = 0.f;
#pragma unroll
    for (int w = 0; w < HD / 32; ++w) mcur += red[w][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * kv_mul + m0 + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * HD + d] * cj;
      mcur = m_new;
    }
    out[(head0 + m) * HD + d] = a / l;
  }
}

// Column-blocked pass 1 for head_dim hd > 512 (a multiple of 128): blockIdx.z is group * n_cb +
// column block.  The scores sum each lane's share of the head piece by piece, as the template
// kernels do; every column block computes the same (m, l), and block 0 writes them.
template <typename T, int M>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_partial_wide_kernel(const float* __restrict__ q, const T* __restrict__ k,
                                 const T* __restrict__ v, const float* __restrict__ ks,
                                 const float* __restrict__ vs, const int* __restrict__ pos,
                                 int n_kv, int kv_mul, int t_max, int hd, float scale,
                                 float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int kRows = max_group(512);
  __shared__ float sm_m[kWarps][M];
  __shared__ float sm_l[kWarps][M];
  __shared__ __align__(16) float sm_acc[kWarps][M][128];

  const int n_cb = hd / 128;
  const int bh = blockIdx.y;
  const int b = bh / n_kv;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int grp = blockIdx.z / n_cb, cb = blockIdx.z % n_cb;
  const long head0 = (long)bh * kv_mul + grp * M;
  const int p = min(max(pos[b], 0), t_max);
  const int t0 = chunk * kChunk;
  if (t0 >= p) return;
  const int t1 = min(p, t0 + kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float mrun[M], lrun[M], acc[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  }

  const long row0 = (long)bh * t_max;
  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    float d[M][kRows];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int r = 0; r < kRows; ++r) d[m][r] = 0.f;
    for (int j = 0; j < n_cb; ++j) {
      float qv[M][4], kf[kRows][4];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        load4(q + (head0 + m) * hd + j * 128 + lane * 4, qv[m]);
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[m][i] *= scale;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (tb + r < t1) load4(k + (row0 + tb + r) * hd + j * 128 + lane * 4, kf[r]);
        else kf[r][0] = kf[r][1] = kf[r][2] = kf[r][3] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[m][r] = fmaf(qv[m][i], kf[r][i], d[m][r]);
    }
    float vf[kRows][4], ksc[kRows], vsc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = tb + r < t1;
      if (ok) load4(v + (row0 + tb + r) * hd + cb * 128 + lane * 4, vf[r]);
      else vf[r][0] = vf[r][1] = vf[r][2] = vf[r][3] = 0.f;
      ksc[r] = (ks != nullptr && ok) ? ks[row0 + tb + r] : 1.f;
      vsc[r] = (vs != nullptr && ok) ? vs[row0 + tb + r] : 1.f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      float s[kRows];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sr = warp_sum(d[m][r]) * ksc[r];
        s[r] = tb + r < t1 ? sr : -INFINITY;
        mx = fmaxf(mx, s[r]);
      }
      const float m_new = fmaxf(mrun[m], mx);
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
  const long slot = ((long)bh * n_chunks + chunk) * kv_mul + grp * M;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w][m]);
    float c[kWarps], l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      c[w] = expf(sm_m[w][m] - mm);
      l = fmaf(sm_l[w][m], c[w], l);
    }
    const int d = threadIdx.x;  // kWarps * 32 == 128 columns
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a = fmaf(sm_acc[w][m][d], c[w], a);
    part_acc[(slot + m) * hd + cb * 128 + d] = a;
    if (threadIdx.x == 0 && cb == 0) {
      part_ml[(slot + m) * 2] = mm;
      part_ml[(slot + m) * 2 + 1] = l;
    }
  }
}

// Column-blocked pass 2 for head_dim hd > 512: one block per (batch row and kv head, group of M
// query heads, 128-column block), one thread per column; the self score sums each thread's
// columns piece by piece, then the block.
template <int M>
__global__ void __launch_bounds__(128)
flash_decode_merge_wide_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                               const float* __restrict__ v_new, const int* __restrict__ pos,
                               int n_kv, int kv_mul, int n_chunks, int hd, float scale,
                               const float* __restrict__ part_ml,
                               const float* __restrict__ part_acc, float* __restrict__ out) {
  __shared__ float red[4][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv;
  const int m0 = blockIdx.y * M;
  const long head0 = (long)bh * kv_mul + m0;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int col = blockIdx.z * 128 + t;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
    for (int j = 0; j < hd / 128; ++j)
      s = fmaf(q[(head0 + m) * hd + j * 128 + t] * scale, k_new[(long)bh * hd + j * 128 + t], s);
    s = warp_sum(s);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (min(max(pos[b], 0), n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * hd + col];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = red[0][m] + red[1][m] + red[2][m] + red[3][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * kv_mul + m0 + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * hd + col] * cj;
      mcur = m_new;
    }
    out[(head0 + m) * hd + col] = a / l;
  }
}

// The arguments of one call, as the entry point receives them.
struct Args {
  const void *q, *k_new, *v_new, *k, *v, *ks, *vs;
  const int* pos;
  int B, n_kv, kv_mul, t_max;
  float scale;
  float *part_ml, *part_acc, *out;
  cudaStream_t s;
};

template <typename T, int M, int HD>
void launch(const Args& a) {
  const int n_chunks = (a.t_max + kChunk - 1) / kChunk;
  const int groups = a.kv_mul / M;
  flash_decode_partial_kernel<T, M, HD><<<dim3(n_chunks, a.B * a.n_kv, groups), kWarps * 32, 0, a.s>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), reinterpret_cast<const float*>(a.ks),
      reinterpret_cast<const float*>(a.vs), a.pos, a.n_kv, a.kv_mul, a.t_max, a.scale, a.part_ml,
      a.part_acc);
  flash_decode_merge_kernel<M, HD><<<dim3(a.B * a.n_kv, groups), HD, 0, a.s>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const float*>(a.k_new),
      reinterpret_cast<const float*>(a.v_new), a.pos, a.n_kv, a.kv_mul, n_chunks, a.scale,
      a.part_ml, a.part_acc, a.out);
}

// Launches with M, the largest power of two up to max_group(HD) that divides kv_mul.
template <typename T, int HD>
int dispatch_m(const Args& a) {
  if (a.kv_mul < 1) return (int)cudaErrorInvalidValue;
  constexpr int kMax = max_group(HD);
  const int low = a.kv_mul & -a.kv_mul;  // the largest power of two dividing kv_mul
  switch (low < kMax ? low : kMax) {
    case 1: launch<T, 1, HD>(a); break;
    case 2: launch<T, 2, HD>(a); break;
    case 4: if constexpr (kMax >= 4) launch<T, 4, HD>(a); break;
    default: if constexpr (kMax >= 8) launch<T, 8, HD>(a); break;
  }
  return 0;
}

template <typename T, int M>
void launch_wide(const Args& a, int hd) {
  const int n_chunks = (a.t_max + kChunk - 1) / kChunk;
  const int groups = a.kv_mul / M, n_cb = hd / 128;
  flash_decode_partial_wide_kernel<T, M><<<dim3(n_chunks, a.B * a.n_kv, groups * n_cb), kWarps * 32, 0, a.s>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const T*>(a.k),
      reinterpret_cast<const T*>(a.v), reinterpret_cast<const float*>(a.ks),
      reinterpret_cast<const float*>(a.vs), a.pos, a.n_kv, a.kv_mul, a.t_max, hd, a.scale,
      a.part_ml, a.part_acc);
  flash_decode_merge_wide_kernel<M><<<dim3(a.B * a.n_kv, groups, n_cb), 128, 0, a.s>>>(
      reinterpret_cast<const float*>(a.q), reinterpret_cast<const float*>(a.k_new),
      reinterpret_cast<const float*>(a.v_new), a.pos, a.n_kv, a.kv_mul, n_chunks, hd, a.scale,
      a.part_ml, a.part_acc, a.out);
}

template <typename T>
int dispatch_hd(int hd, const Args& a) {
  switch (hd) {
    case 128: return dispatch_m<T, 128>(a);
    case 256: return dispatch_m<T, 256>(a);
    case 384: return dispatch_m<T, 384>(a);
    case 512: return dispatch_m<T, 512>(a);
    default:
      if (hd % 128 || hd < 128 || a.kv_mul < 1) return (int)cudaErrorInvalidValue;
      if (a.kv_mul % 2) launch_wide<T, 1>(a, hd);  // query heads per block: as at 512
      else launch_wide<T, 2>(a, hd);
      return 0;
  }
}

}  // namespace

// Plain C entry point.  q [B, n_kv * kv_mul, hd] f32, k_new/v_new [B, n_kv, hd] f32, k/v the
// layer's cache base [B, n_kv, t_max, hd] (cache_type 0 = f32, 1 = bf16, 2 = int8 with
// ks/vs [B, n_kv, t_max] f32), pos [B] int32 on the device, workspaces of
// B * n_kv * ceil(t_max / 128) * kv_mul * (2 | hd) floats; hd is a multiple of 128.
// Returns cudaGetLastError() (or cudaErrorInvalidValue for an argument it does not take).
extern "C" int flash_decode(const void* q, const void* k_new, const void* v_new, const void* k,
                            const void* v, const void* ks, const void* vs, const void* pos,
                            int cache_type, int B, int n_kv, int kv_mul, int t_max, int hd,
                            float scale, void* part_ml, void* part_acc, void* out, void* stream) {
  const bool quant = cache_type == 2;
  const Args a{q, k_new, v_new, k, v, quant ? ks : nullptr, quant ? vs : nullptr,
               reinterpret_cast<const int*>(pos), B, n_kv, kv_mul, t_max, scale,
               reinterpret_cast<float*>(part_ml), reinterpret_cast<float*>(part_acc),
               reinterpret_cast<float*>(out), reinterpret_cast<cudaStream_t>(stream)};
  int rc;
  switch (cache_type) {
    case 0: rc = dispatch_hd<float>(hd, a); break;
    case 1: rc = dispatch_hd<__nv_bfloat16>(hd, a); break;
    case 2: rc = dispatch_hd<int8_t>(hd, a); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
