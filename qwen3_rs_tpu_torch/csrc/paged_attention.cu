// GQA attention over the serving page pool, for Hopper (sm_90a): the paged decode kernel and
// the paged window partials kernel, which share their first pass.  At head_dim 128 and 256 over
// pages of a multiple of 16 rows paged_decode.cu's one-launch kernels take over, for every pool type;
// these kernels take the other head_dims and pages.
//
// Replaces the reference package's Pallas kernels
//   qwen3_rs_tpu/ops/pallas/paged_attention.py::paged_gqa_decode_stacked      (paged_decode)
//   qwen3_rs_tpu/ops/pallas/paged_attention.py::paged_gqa_window_stacked      (paged_window_partials,
//                                                                              its _partials_kernel).
// The pool of one layer is [P, n_kv, page, hd]; cache row t of request b lives in page
// table[b, t / page] at page row t % page, and only rows t < pos[b] are valid.  For each request
// b and kv head h, R query rows (pre-scaled by 1/sqrt(hd)) attend over those rows; every row
// shares that one mask.  INT8 pools: the per-row K scale multiplies the score before the max, the
// V scale the probability before P.V (after l takes it), as the Pallas kernels do.
//  * paged_decode: R = kv_mul, the step's query heads of kv head h, which also attend to the
//    step's own key and value (not cached yet):
//      out = softmax([q.k_self, q.K[0:pos]]) . [v_self; V[0:pos]].
//  * paged_window_partials: R = S * kv_mul rows of a window, (mul, s) order, up to 128; it returns
//    the softmax partials of the cache part only,
//      m = max_t s_t,  l = sum_t exp(s_t - m),  acc = sum_t exp(s_t - m) v_t,
//    with m = -inf, l = 0 and acc = 0 where pos[b] = 0.  The caller merges them with the causal
//    attention inside the window.
//
// Bound on the H100: bytes for decode and short windows (each valid cache row read once for
// 2 * hd elements, against ~4 flops per element and query row), operations (4 * hd per query
// row and cache row, in f32) once R grows.
// Design against that bound:
//  * pass 1, one block per (128-row chunk of the cache, request and kv head, tile of Q query
//    rows): the tile's rows share every K/V row the block reads, and the split over chunks gives
//    the card enough blocks at B = 8 (64 (request, kv head) pairs alone would fill 64 SMs).
//    Decode takes Q = the largest power of two up to 8 (head_dim 128) that divides kv_mul (so
//    any kv_mul works, in kv_mul / Q tiles); a window takes Q = 8, so the per-row state stays in
//    registers;
//  * a block reads the page ids of its own rows from the table, per row, so any page size works
//    and a chunk may span pages;
//  * blocks whose chunk starts at or past pos[b] return at once, and no row >= pos[b] is read:
//    an idle slot (pos 0) and the null page cost one block launch that reads nothing;
//  * a warp reads one row per load (lane = 4 consecutive elements of each 128-wide piece) and
//    keeps 8 rows of K and V in flight, with an online softmax (m, l, acc) per query row; the
//    block merges its warps in shared memory and writes one partial per chunk;
//  * head_dim is a template parameter: 128, 256, 384 or 512.  Past 128 the rows in flight and
//    the query rows per block shrink (4 at 256, 2 above), so the registers a thread holds stay
//    those of head_dim 128;
//  * any larger multiple of 128 (the reference's gates admit them all) takes the column-blocked
//    kernels: the output is split into 128-column blocks over the grid, each block computes the
//    full scores by reading q and K in 128-column pieces and keeps only its own 128 columns of V
//    and of the partials, so registers and shared memory stay those of head_dim 128 whatever the
//    head.  K is read once per column block (right first; speed is later work);
//  * pass 2 merges the chunks below pos[b] in order, so the result does not depend on
//    scheduling: decode seeds the softmax with the self key (m = q.k_self, l = 1, acc = v_self,
//    as the Pallas kernel) and normalises; the window keeps the reference's isfinite guards and
//    returns the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;  // cache rows per block
constexpr int kWarps = 4;

// Query rows per block and cache rows per warp in flight, at most: 8 at head_dim 128, fewer
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

__device__ __forceinline__ int valid_rows(const int* pos, int b, int limit) {
  return min(max(pos[b], 0), limit);
}

// Pass 1: one partial (m, l, acc) per (request and kv head, chunk, query row) over the chunk's
// rows below pos[b], for the Q query rows of tile blockIdx.z.  q: [B * n_kv, R, HD] f32;
// k/v: the layer's pool; ks/vs: [P, n_kv, page] or null; part_ml: [B * n_kv, n_chunks, R, 2];
// part_acc: [B * n_kv, n_chunks, R, HD].
template <typename T, int Q, int HD>
__global__ void __launch_bounds__(kWarps * 32)
paged_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ table,
                     const int* __restrict__ pos, int n_kv, int R, int page, int max_pages,
                     float scale, float* __restrict__ part_ml, float* __restrict__ part_acc) {
  constexpr int V = HD / 128, kRows = max_group(HD);
  __shared__ float sm_m[kWarps][Q];
  __shared__ float sm_l[kWarps][Q];
  __shared__ __align__(16) float sm_acc[kWarps][Q][HD];

  const int bh = blockIdx.y;  // b * n_kv + kv head
  const int b = bh / n_kv, h = bh % n_kv;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int r0 = blockIdx.z * Q;
  const int p = valid_rows(pos, b, max_pages * page);  // the table covers no row past it
  const int t0 = chunk * kChunk;
  if (t0 >= p) return;
  const int t1 = min(p, t0 + kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* tab = table + (long)b * max_pages;

  float qr[Q][V][4];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    if (r0 + m < R) {
      load_row<float, V>(q + ((long)bh * R + r0 + m) * HD, lane, qr[m]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) qr[m][j][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[m][j][i] *= scale;
  }
  float mrun[Q], lrun[Q], acc[Q][V][4];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;
  }

  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    long row[kRows];  // pool row of cache row tb + r: (page id, kv head, page row)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = tb + r;
      row[r] = t < t1 ? ((long)tab[t / page] * n_kv + h) * page + t % page : 0;
    }
    float kf[kRows][V][4], vf[kRows][V][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tb + r < t1) {
        load_row<T, V>(k + row[r] * HD, lane, kf[r]);
        load_row<T, V>(v + row[r] * HD, lane, vf[r]);
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
      ksc[r] = (ks != nullptr && ok) ? ks[row[r]] : 1.f;
      vsc[r] = (vs != nullptr && ok) ? vs[row[r]] : 1.f;
    }
#pragma unroll
    for (int m = 0; m < Q; ++m) {
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
  for (int m = 0; m < Q; ++m) {
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
  const long slot = ((long)bh * n_chunks + chunk) * R;
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    if (r0 + m >= R) break;
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
      part_acc[(slot + r0 + m) * HD + d] = a;
    }
    if (threadIdx.x == 0) {
      part_ml[(slot + r0 + m) * 2] = mm;
      part_ml[(slot + r0 + m) * 2 + 1] = l;
    }
  }
}

// Decode pass 2: seed with the self key and merge the chunks below pos[b] in order, one block per
// (request and kv head, tile of M query heads), one thread per element of head_dim.
// q: [B, n_kv * R, HD] (R = kv_mul); k_new/v_new: [B, n_kv, HD]; out like q.
template <int M, int HD>
__global__ void __launch_bounds__(HD)
decode_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                    const float* __restrict__ v_new, const int* __restrict__ pos, int n_kv, int R,
                    int n_chunks, float scale, const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc, float* __restrict__ out) {
  __shared__ float red[HD / 32][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv;
  const int r0 = blockIdx.y * M;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const float kd = k_new[(long)bh * HD + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = warp_sum(q[((long)bh * R + r0 + m) * HD + d] * scale * kd);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (valid_rows(pos, b, n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * HD + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = 0.f;
#pragma unroll
    for (int w = 0; w < HD / 32; ++w) mcur += red[w][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * R + r0 + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * HD + d] * cj;
      mcur = m_new;
    }
    out[((long)bh * R + r0 + m) * HD + d] = a / l;
  }
}

// Window pass 2: merge the chunks below pos[b] in order, one block per (request and kv head,
// query row), one thread per element of head_dim.  out_m/out_l: [B * n_kv, R];
// out_acc: [B * n_kv, R, HD].
template <int HD>
__global__ void __launch_bounds__(HD)
window_merge_kernel(const int* __restrict__ pos, int n_kv, int R, int n_chunks,
                    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    float* __restrict__ out_m, float* __restrict__ out_l,
                    float* __restrict__ out_acc) {
  const int bh = blockIdx.x, r = blockIdx.y;
  const int b = bh / n_kv;
  const int d = threadIdx.x;
  const int active = (valid_rows(pos, b, n_chunks * kChunk) + kChunk - 1) / kChunk;
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int j = 0; j < active; ++j) {
    const long slot = ((long)bh * n_chunks + j) * R + r;
    const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
    const float m_new = fmaxf(m, mj);
    const bool finite = isfinite(m_new);
    const float ca = finite ? expf(m - m_new) : 0.f;
    const float cj = finite ? expf(mj - m_new) : 0.f;
    l = l * ca + lj * cj;
    a = a * ca + part_acc[slot * HD + d] * cj;
    m = m_new;
  }
  const long o = (long)bh * R + r;
  out_acc[o * HD + d] = a;
  if (d == 0) {
    out_m[o] = m;
    out_l[o] = l;
  }
}

// Column-blocked pass 1 for head_dim hd > 512 (a multiple of 128): blockIdx.z is tile * n_cb +
// column block.  The scores sum each lane's share of the head piece by piece, as the template
// kernels do; every column block computes the same (m, l), and block 0 writes them.
template <typename T, int Q>
__global__ void __launch_bounds__(kWarps * 32)
paged_partial_wide_kernel(const float* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const float* __restrict__ ks,
                          const float* __restrict__ vs, const int* __restrict__ table,
                          const int* __restrict__ pos, int n_kv, int R, int page, int max_pages,
                          int hd, float scale, float* __restrict__ part_ml,
                          float* __restrict__ part_acc) {
  constexpr int kRows = max_group(512);
  __shared__ float sm_m[kWarps][Q];
  __shared__ float sm_l[kWarps][Q];
  __shared__ __align__(16) float sm_acc[kWarps][Q][128];

  const int n_cb = hd / 128;
  const int bh = blockIdx.y;
  const int b = bh / n_kv, h = bh % n_kv;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int r0 = (blockIdx.z / n_cb) * Q, cb = blockIdx.z % n_cb;
  const int p = valid_rows(pos, b, max_pages * page);
  const int t0 = chunk * kChunk;
  if (t0 >= p) return;
  const int t1 = min(p, t0 + kChunk);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* tab = table + (long)b * max_pages;

  float mrun[Q], lrun[Q], acc[Q][4];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  }

  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    long row[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = tb + r;
      row[r] = t < t1 ? ((long)tab[t / page] * n_kv + h) * page + t % page : 0;
    }
    float d[Q][kRows];
#pragma unroll
    for (int m = 0; m < Q; ++m)
#pragma unroll
      for (int r = 0; r < kRows; ++r) d[m][r] = 0.f;
    for (int j = 0; j < n_cb; ++j) {
      float qv[Q][4], kf[kRows][4];
#pragma unroll
      for (int m = 0; m < Q; ++m) {
        if (r0 + m < R) load4(q + ((long)bh * R + r0 + m) * hd + j * 128 + lane * 4, qv[m]);
        else qv[m][0] = qv[m][1] = qv[m][2] = qv[m][3] = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[m][i] *= scale;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (tb + r < t1) load4(k + row[r] * hd + j * 128 + lane * 4, kf[r]);
        else kf[r][0] = kf[r][1] = kf[r][2] = kf[r][3] = 0.f;
      }
#pragma unroll
      for (int m = 0; m < Q; ++m)
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) d[m][r] = fmaf(qv[m][i], kf[r][i], d[m][r]);
    }
    float vf[kRows][4], ksc[kRows], vsc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const bool ok = tb + r < t1;
      if (ok) load4(v + row[r] * hd + cb * 128 + lane * 4, vf[r]);
      else vf[r][0] = vf[r][1] = vf[r][2] = vf[r][3] = 0.f;
      ksc[r] = (ks != nullptr && ok) ? ks[row[r]] : 1.f;
      vsc[r] = (vs != nullptr && ok) ? vs[row[r]] : 1.f;
    }
#pragma unroll
    for (int m = 0; m < Q; ++m) {
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
  for (int m = 0; m < Q; ++m) {
    if (lane == 0) {
      sm_m[warp][m] = mrun[m];
      sm_l[warp][m] = lrun[m];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][m][lane * 4 + i] = acc[m][i];
  }
  __syncthreads();
  const long slot = ((long)bh * n_chunks + chunk) * R;
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    if (r0 + m >= R) break;
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
    part_acc[(slot + r0 + m) * hd + cb * 128 + d] = a;
    if (threadIdx.x == 0 && cb == 0) {
      part_ml[(slot + r0 + m) * 2] = mm;
      part_ml[(slot + r0 + m) * 2 + 1] = l;
    }
  }
}

// Column-blocked decode pass 2 for head_dim hd > 512: one block per (request and kv head, tile of
// M query heads, 128-column block), one thread per column.
template <int M>
__global__ void __launch_bounds__(128)
decode_merge_wide_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                         const float* __restrict__ v_new, const int* __restrict__ pos, int n_kv,
                         int R, int n_chunks, int hd, float scale,
                         const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         float* __restrict__ out) {
  __shared__ float red[4][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv;
  const int r0 = blockIdx.y * M;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int col = blockIdx.z * 128 + t;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float s = 0.f;
    for (int j = 0; j < hd / 128; ++j)
      s = fmaf(q[((long)bh * R + r0 + m) * hd + j * 128 + t] * scale,
               k_new[(long)bh * hd + j * 128 + t], s);
    s = warp_sum(s);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (valid_rows(pos, b, n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * hd + col];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = red[0][m] + red[1][m] + red[2][m] + red[3][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * R + r0 + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * hd + col] * cj;
      mcur = m_new;
    }
    out[((long)bh * R + r0 + m) * hd + col] = a / l;
  }
}

// Column-blocked window pass 2 for head_dim hd > 512: one block per (request and kv head, query
// row, 128-column block).
__global__ void __launch_bounds__(128)
window_merge_wide_kernel(const int* __restrict__ pos, int n_kv, int R, int n_chunks, int hd,
                         const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                         float* __restrict__ out_m, float* __restrict__ out_l,
                         float* __restrict__ out_acc) {
  const int bh = blockIdx.x, r = blockIdx.y;
  const int b = bh / n_kv;
  const int col = blockIdx.z * 128 + threadIdx.x;
  const int active = (valid_rows(pos, b, n_chunks * kChunk) + kChunk - 1) / kChunk;
  float m = -INFINITY, l = 0.f, a = 0.f;
  for (int j = 0; j < active; ++j) {
    const long slot = ((long)bh * n_chunks + j) * R + r;
    const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
    const float m_new = fmaxf(m, mj);
    const bool finite = isfinite(m_new);
    const float ca = finite ? expf(m - m_new) : 0.f;
    const float cj = finite ? expf(mj - m_new) : 0.f;
    l = l * ca + lj * cj;
    a = a * ca + part_acc[slot * hd + col] * cj;
    m = m_new;
  }
  const long o = (long)bh * R + r;
  out_acc[o * hd + col] = a;
  if (col == 0) {
    out_m[o] = m;
    out_l[o] = l;
  }
}

// The pointers of one call, as the entry points receive them.
struct Pool {
  const void *k, *v, *ks, *vs;
  const int *table, *pos;
  int B, n_kv, page, max_pages;
  float *part_ml, *part_acc;
  int n_chunks() const { return (max_pages * page + kChunk - 1) / kChunk; }
};

template <typename T, int Q, int HD>
void launch_partials(const Pool& p, const float* q, int R, float scale, cudaStream_t s) {
  const dim3 grid(p.n_chunks(), p.B * p.n_kv, (R + Q - 1) / Q);
  paged_partial_kernel<T, Q, HD><<<grid, kWarps * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(p.k), reinterpret_cast<const T*>(p.v),
      reinterpret_cast<const float*>(p.ks), reinterpret_cast<const float*>(p.vs), p.table, p.pos,
      p.n_kv, R, p.page, p.max_pages, scale, p.part_ml, p.part_acc);
}

// The decode kernel's arguments besides the pool.
struct Step {
  const float *q, *k_new, *v_new;
  int kv_mul;
  float scale;
  float* out;
  cudaStream_t s;
};

template <typename T, int M, int HD>
void launch_decode(const Pool& p, const Step& a) {
  launch_partials<T, M, HD>(p, a.q, a.kv_mul, a.scale, a.s);
  decode_merge_kernel<M, HD><<<dim3(p.B * p.n_kv, a.kv_mul / M), HD, 0, a.s>>>(
      a.q, a.k_new, a.v_new, p.pos, p.n_kv, a.kv_mul, p.n_chunks(), a.scale, p.part_ml,
      p.part_acc, a.out);
}

// Launches with M, the largest power of two up to max_group(HD) that divides kv_mul.
template <typename T, int HD>
int decode_for(const Pool& p, const Step& a) {
  if (a.kv_mul < 1) return (int)cudaErrorInvalidValue;
  constexpr int kMax = max_group(HD);
  const int low = a.kv_mul & -a.kv_mul;  // the largest power of two dividing kv_mul
  switch (low < kMax ? low : kMax) {
    case 1: launch_decode<T, 1, HD>(p, a); break;
    case 2: launch_decode<T, 2, HD>(p, a); break;
    case 4: if constexpr (kMax >= 4) launch_decode<T, 4, HD>(p, a); break;
    default: if constexpr (kMax >= 8) launch_decode<T, 8, HD>(p, a); break;
  }
  return 0;
}

template <typename T, int Q>
void launch_partials_wide(const Pool& p, const float* q, int R, int hd, float scale, cudaStream_t s) {
  const dim3 grid(p.n_chunks(), p.B * p.n_kv, (R + Q - 1) / Q * (hd / 128));
  paged_partial_wide_kernel<T, Q><<<grid, kWarps * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(p.k), reinterpret_cast<const T*>(p.v),
      reinterpret_cast<const float*>(p.ks), reinterpret_cast<const float*>(p.vs), p.table, p.pos,
      p.n_kv, R, p.page, p.max_pages, hd, scale, p.part_ml, p.part_acc);
}

template <typename T, int M>
void launch_decode_wide(const Pool& p, const Step& a, int hd) {
  launch_partials_wide<T, M>(p, a.q, a.kv_mul, hd, a.scale, a.s);
  decode_merge_wide_kernel<M><<<dim3(p.B * p.n_kv, a.kv_mul / M, hd / 128), 128, 0, a.s>>>(
      a.q, a.k_new, a.v_new, p.pos, p.n_kv, a.kv_mul, p.n_chunks(), hd, a.scale, p.part_ml,
      p.part_acc, a.out);
}

template <typename T>
int decode_hd(int hd, const Pool& p, const Step& a) {
  switch (hd) {
    case 128: return decode_for<T, 128>(p, a);
    case 256: return decode_for<T, 256>(p, a);
    case 384: return decode_for<T, 384>(p, a);
    case 512: return decode_for<T, 512>(p, a);
    default:
      if (hd % 128 || hd < 128 || a.kv_mul < 1) return (int)cudaErrorInvalidValue;
      if (a.kv_mul % 2) launch_decode_wide<T, 1>(p, a, hd);  // query heads per block: as at 512
      else launch_decode_wide<T, 2>(p, a, hd);
      return 0;
  }
}

// A window's partials and their merge: query rows in tiles of max_group(HD).
template <typename T, int HD>
void window_for(const Pool& p, const float* q, int R, float scale, float* out_m, float* out_l,
                float* out_acc, cudaStream_t s) {
  launch_partials<T, max_group(HD), HD>(p, q, R, scale, s);
  window_merge_kernel<HD><<<dim3(p.B * p.n_kv, R), HD, 0, s>>>(
      p.pos, p.n_kv, R, p.n_chunks(), p.part_ml, p.part_acc, out_m, out_l, out_acc);
}

template <typename T>
int window_hd(int hd, const Pool& p, const float* q, int R, float scale, float* out_m,
              float* out_l, float* out_acc, cudaStream_t s) {
  switch (hd) {
    case 128: window_for<T, 128>(p, q, R, scale, out_m, out_l, out_acc, s); break;
    case 256: window_for<T, 256>(p, q, R, scale, out_m, out_l, out_acc, s); break;
    case 384: window_for<T, 384>(p, q, R, scale, out_m, out_l, out_acc, s); break;
    case 512: window_for<T, 512>(p, q, R, scale, out_m, out_l, out_acc, s); break;
    default:
      if (hd % 128 || hd < 128) return (int)cudaErrorInvalidValue;
      launch_partials_wide<T, max_group(512)>(p, q, R, hd, scale, s);
      window_merge_wide_kernel<<<dim3(p.B * p.n_kv, R, hd / 128), 128, 0, s>>>(
          p.pos, p.n_kv, R, p.n_chunks(), hd, p.part_ml, p.part_acc, out_m, out_l, out_acc);
  }
  return 0;
}

Pool pool_of(const void* k, const void* v, const void* ks, const void* vs, const void* table,
             const void* pos, int B, int n_kv, int page, int max_pages, void* part_ml,
             void* part_acc) {
  return Pool{k, v, ks, vs, reinterpret_cast<const int*>(table),
              reinterpret_cast<const int*>(pos), B, n_kv, page, max_pages,
              reinterpret_cast<float*>(part_ml), reinterpret_cast<float*>(part_acc)};
}

}  // namespace

// Plain C entry points.  k/v: the layer's pool [P, n_kv, page, hd] (cache_type 0 = f32,
// 1 = bf16, 2 = int8 with ks/vs [P, n_kv, page] f32); table [B, max_pages] and pos [B] int32 on
// the device; workspaces part_ml / part_acc of B * n_kv * ceil(max_pages * page / 128) * R floats
// times 2 and times hd; hd is a multiple of 128.  Each returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument it does not take).

// q [B, n_kv * kv_mul, hd] f32 (unscaled), k_new/v_new [B, n_kv, hd] f32 → out like q; R = kv_mul.
extern "C" int paged_decode(const void* q, const void* k_new, const void* v_new, const void* k,
                            const void* v, const void* ks, const void* vs, const void* table,
                            const void* pos, int cache_type, int B, int n_kv, int kv_mul, int page,
                            int max_pages, int hd, float scale, void* part_ml, void* part_acc,
                            void* out, void* stream) {
  const Pool p = pool_of(k, v, ks, vs, table, pos, B, n_kv, page, max_pages, part_ml, part_acc);
  const Step a{reinterpret_cast<const float*>(q), reinterpret_cast<const float*>(k_new),
               reinterpret_cast<const float*>(v_new), kv_mul, scale, reinterpret_cast<float*>(out),
               reinterpret_cast<cudaStream_t>(stream)};
  int rc;
  switch (cache_type) {
    case 0: rc = decode_hd<float>(hd, p, a); break;
    case 1: rc = decode_hd<__nv_bfloat16>(hd, p, a); break;
    case 2: rc = decode_hd<int8_t>(hd, p, a); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// q [B, n_kv, R, hd] f32 (R rows per kv head, unscaled) → out_m/out_l [B, n_kv, R] and out_acc
// [B, n_kv, R, hd] f32.
extern "C" int paged_window_partials(const void* q, const void* k, const void* v, const void* ks,
                                     const void* vs, const void* table, const void* pos,
                                     int cache_type, int B, int n_kv, int R, int page,
                                     int max_pages, int hd, float scale, void* part_ml,
                                     void* part_acc, void* out_m, void* out_l, void* out_acc,
                                     void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const Pool p = pool_of(k, v, ks, vs, table, pos, B, n_kv, page, max_pages, part_ml, part_acc);
  const float* qf = reinterpret_cast<const float*>(q);
  float* om = reinterpret_cast<float*>(out_m);
  float* ol = reinterpret_cast<float*>(out_l);
  float* oa = reinterpret_cast<float*>(out_acc);
  int rc;
  switch (cache_type) {
    case 0: rc = window_hd<float>(hd, p, qf, R, scale, om, ol, oa, s); break;
    case 1: rc = window_hd<__nv_bfloat16>(hd, p, qf, R, scale, om, ol, oa, s); break;
    case 2: rc = window_hd<int8_t>(hd, p, qf, R, scale, om, ol, oa, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
