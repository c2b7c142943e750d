// GQA attention over the serving page pool, for Hopper (sm_90a): the paged decode kernel and
// the paged window partials kernel, which share their first pass.
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
//    Decode takes Q = the largest power of two up to 8 that divides kv_mul (so any kv_mul
//    works, in kv_mul / Q tiles); a window takes Q = 8, so the per-row state stays in
//    registers;
//  * a block reads the page ids of its own rows from the table, per row, so any page size works
//    and a chunk may span pages;
//  * blocks whose chunk starts at or past pos[b] return at once, and no row >= pos[b] is read:
//    an idle slot (pos 0) and the null page cost one block launch that reads nothing;
//  * a warp reads one 128-wide row per load (lane = 4 consecutive elements) and keeps 8 rows of
//    K and V in flight, with an online softmax (m, l, acc) per query row; the block merges its
//    warps in shared memory and writes one partial per chunk;
//  * pass 2 merges the chunks below pos[b] in order, so the result does not depend on
//    scheduling: decode seeds the softmax with the self key (m = q.k_self, l = 1, acc = v_self,
//    as the Pallas kernel) and normalises; the window keeps the reference's isfinite guards and
//    returns the partials.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHd = 128;     // head_dim
constexpr int kChunk = 128;  // cache rows per block
constexpr int kWarps = 4;
constexpr int kRows = 8;     // cache rows per warp in flight
constexpr int kWindowQ = 8;  // query rows per block of a window

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

__device__ __forceinline__ int valid_rows(const int* pos, int b, int limit) {
  return min(max(pos[b], 0), limit);
}

// Pass 1: one partial (m, l, acc) per (request and kv head, chunk, query row) over the chunk's
// rows below pos[b], for the Q query rows of tile blockIdx.z.  q: [B * n_kv, R, hd] f32;
// k/v: the layer's pool; ks/vs: [P, n_kv, page] or null; part_ml: [B * n_kv, n_chunks, R, 2];
// part_acc: [B * n_kv, n_chunks, R, hd].
template <typename T, int Q>
__global__ void __launch_bounds__(kWarps * 32)
paged_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ ks,
                     const float* __restrict__ vs, const int* __restrict__ table,
                     const int* __restrict__ pos, int n_kv, int R, int page, int max_pages,
                     float scale, float* __restrict__ part_ml, float* __restrict__ part_acc) {
  __shared__ float sm_m[kWarps][Q];
  __shared__ float sm_l[kWarps][Q];
  __shared__ __align__(16) float sm_acc[kWarps][Q][kHd];

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

  float qr[Q][4];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    if (r0 + m < R) {
      load4(q + ((long)bh * R + r0 + m) * kHd + lane * 4, qr[m]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[m][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) qr[m][i] *= scale;
  }
  float mrun[Q], lrun[Q], acc[Q][4];
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    mrun[m] = -INFINITY;
    lrun[m] = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
  }

  for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
    long row[kRows];  // pool row of cache row tb + r: (page id, kv head, page row)
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int t = tb + r;
      row[r] = t < t1 ? ((long)tab[t / page] * n_kv + h) * page + t % page : 0;
    }
    float kf[kRows][4], vf[kRows][4];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (tb + r < t1) {
        load4(k + row[r] * kHd + lane * 4, kf[r]);
        load4(v + row[r] * kHd + lane * 4, vf[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) kf[r][i] = vf[r][i] = 0.f;
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
  for (int m = 0; m < Q; ++m) {
    if (lane == 0) {
      sm_m[warp][m] = mrun[m];
      sm_l[warp][m] = lrun[m];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) sm_acc[warp][m][lane * 4 + i] = acc[m][i];
  }
  __syncthreads();
  const int d = threadIdx.x;  // kHd == blockDim.x
  const long slot = ((long)bh * n_chunks + chunk) * R;
#pragma unroll
  for (int m = 0; m < Q; ++m) {
    if (r0 + m >= R) break;
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
    part_acc[(slot + r0 + m) * kHd + d] = a;
    if (d == 0) {
      part_ml[(slot + r0 + m) * 2] = mm;
      part_ml[(slot + r0 + m) * 2 + 1] = l;
    }
  }
}

// Decode pass 2: seed with the self key and merge the chunks below pos[b] in order, one block per
// (request and kv head, tile of M query heads).  q: [B, n_kv * R, hd] (R = kv_mul);
// k_new/v_new: [B, n_kv, hd]; out like q.
template <int M>
__global__ void __launch_bounds__(kHd)
decode_merge_kernel(const float* __restrict__ q, const float* __restrict__ k_new,
                    const float* __restrict__ v_new, const int* __restrict__ pos, int n_kv, int R,
                    int n_chunks, float scale, const float* __restrict__ part_ml,
                    const float* __restrict__ part_acc, float* __restrict__ out) {
  __shared__ float red[kHd / 32][M];
  const int bh = blockIdx.x;
  const int b = bh / n_kv;
  const int r0 = blockIdx.y * M;
  const int d = threadIdx.x, lane = d & 31, warp = d >> 5;
  const float kd = k_new[(long)bh * kHd + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const float s = warp_sum(q[((long)bh * R + r0 + m) * kHd + d] * scale * kd);
    if (lane == 0) red[warp][m] = s;
  }
  __syncthreads();
  const int active = (valid_rows(pos, b, n_chunks * kChunk) + kChunk - 1) / kChunk;
  const float vd = v_new[(long)bh * kHd + d];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    float mcur = 0.f;
#pragma unroll
    for (int w = 0; w < kHd / 32; ++w) mcur += red[w][m];
    float l = 1.f, a = vd;
    for (int j = 0; j < active; ++j) {
      const long slot = ((long)bh * n_chunks + j) * R + r0 + m;
      const float mj = part_ml[slot * 2], lj = part_ml[slot * 2 + 1];
      const float m_new = fmaxf(mcur, mj);
      const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
      l = l * ca + lj * cj;
      a = a * ca + part_acc[slot * kHd + d] * cj;
      mcur = m_new;
    }
    out[((long)bh * R + r0 + m) * kHd + d] = a / l;
  }
}

// Window pass 2: merge the chunks below pos[b] in order, one block per (request and kv head,
// query row).  out_m/out_l: [B * n_kv, R]; out_acc: [B * n_kv, R, hd].
__global__ void __launch_bounds__(kHd)
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
    a = a * ca + part_acc[slot * kHd + d] * cj;
    m = m_new;
  }
  const long o = (long)bh * R + r;
  out_acc[o * kHd + d] = a;
  if (d == 0) {
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

template <typename T, int Q>
void launch_partials(const Pool& p, const float* q, int R, float scale, cudaStream_t s) {
  const dim3 grid(p.n_chunks(), p.B * p.n_kv, (R + Q - 1) / Q);
  paged_partial_kernel<T, Q><<<grid, kWarps * 32, 0, s>>>(
      q, reinterpret_cast<const T*>(p.k), reinterpret_cast<const T*>(p.v),
      reinterpret_cast<const float*>(p.ks), reinterpret_cast<const float*>(p.vs), p.table, p.pos,
      p.n_kv, R, p.page, p.max_pages, scale, p.part_ml, p.part_acc);
}

template <typename T, int M>
void launch_decode(const Pool& p, const float* q, int kv_mul, const float* k_new,
                   const float* v_new, float scale, float* out, cudaStream_t s) {
  launch_partials<T, M>(p, q, kv_mul, scale, s);
  decode_merge_kernel<M><<<dim3(p.B * p.n_kv, kv_mul / M), kHd, 0, s>>>(
      q, k_new, v_new, p.pos, p.n_kv, kv_mul, p.n_chunks(), scale, p.part_ml, p.part_acc, out);
}

// Launches with M, the largest power of two up to 8 that divides kv_mul.
template <typename T>
int decode_for(int kv_mul, const Pool& p, const float* q, const float* k_new,
               const float* v_new, float scale, float* out, cudaStream_t s) {
  if (kv_mul < 1) return (int)cudaErrorInvalidValue;
  switch ((kv_mul & -kv_mul) < 8 ? (kv_mul & -kv_mul) : 8) {
    case 1: launch_decode<T, 1>(p, q, kv_mul, k_new, v_new, scale, out, s); break;
    case 2: launch_decode<T, 2>(p, q, kv_mul, k_new, v_new, scale, out, s); break;
    case 4: launch_decode<T, 4>(p, q, kv_mul, k_new, v_new, scale, out, s); break;
    default: launch_decode<T, 8>(p, q, kv_mul, k_new, v_new, scale, out, s); break;
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

// Plain C entry points.  k/v: the layer's pool [P, n_kv, page, 128] (cache_type 0 = f32,
// 1 = bf16, 2 = int8 with ks/vs [P, n_kv, page] f32); table [B, max_pages] and pos [B] int32 on
// the device; workspaces part_ml / part_acc of B * n_kv * ceil(max_pages * page / 128) * R floats
// times 2 and times 128.  Each returns cudaGetLastError() (or cudaErrorInvalidValue for an
// argument it does not take).

// q [B, n_kv * kv_mul, 128] f32 (unscaled), k_new/v_new [B, n_kv, 128] f32 → out like q; R = kv_mul.
extern "C" int paged_decode(const void* q, const void* k_new, const void* v_new, const void* k,
                            const void* v, const void* ks, const void* vs, const void* table,
                            const void* pos, int cache_type, int B, int n_kv, int kv_mul, int page,
                            int max_pages, float scale, void* part_ml, void* part_acc, void* out,
                            void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const Pool p = pool_of(k, v, ks, vs, table, pos, B, n_kv, page, max_pages, part_ml, part_acc);
  const float* qf = reinterpret_cast<const float*>(q);
  const float* kn = reinterpret_cast<const float*>(k_new);
  const float* vn = reinterpret_cast<const float*>(v_new);
  float* o = reinterpret_cast<float*>(out);
  int rc;
  switch (cache_type) {
    case 0: rc = decode_for<float>(kv_mul, p, qf, kn, vn, scale, o, s); break;
    case 1: rc = decode_for<__nv_bfloat16>(kv_mul, p, qf, kn, vn, scale, o, s); break;
    case 2: rc = decode_for<int8_t>(kv_mul, p, qf, kn, vn, scale, o, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

// q [B, n_kv, R, 128] f32 (R rows per kv head, unscaled) → out_m/out_l [B, n_kv, R] and out_acc
// [B, n_kv, R, 128] f32.
extern "C" int paged_window_partials(const void* q, const void* k, const void* v, const void* ks,
                                     const void* vs, const void* table, const void* pos,
                                     int cache_type, int B, int n_kv, int R, int page,
                                     int max_pages, float scale, void* part_ml, void* part_acc,
                                     void* out_m, void* out_l, void* out_acc, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const Pool p = pool_of(k, v, ks, vs, table, pos, B, n_kv, page, max_pages, part_ml, part_acc);
  const float* qf = reinterpret_cast<const float*>(q);
  switch (cache_type) {
    case 0: launch_partials<float, kWindowQ>(p, qf, R, scale, s); break;
    case 1: launch_partials<__nv_bfloat16, kWindowQ>(p, qf, R, scale, s); break;
    case 2: launch_partials<int8_t, kWindowQ>(p, qf, R, scale, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  window_merge_kernel<<<dim3(B * n_kv, R), kHd, 0, s>>>(
      p.pos, n_kv, R, p.n_chunks(), p.part_ml, p.part_acc, reinterpret_cast<float*>(out_m),
      reinterpret_cast<float*>(out_l), reinterpret_cast<float*>(out_acc));
  return (int)cudaGetLastError();
}
