// Whole-step decode megakernel for Hopper (sm_90a): every layer of a decode step, and the
// classifier, in ONE cooperative launch.
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/megakernel.py::decode_stack_megakernel.
// For B <= 8 rows at their own positions, per layer: RMSNorm -> wqkv -> QK-norm + RoPE ->
// attention over the dense cache rows < min(pos, T), seeded with the step's own key and value
// -> the step's K/V row written in place at min(pos, T - 1) where write_ok (an INT8 cache
// quantizes it and writes its scale) -> wo + residual -> RMSNorm -> w13 -> SwiGLU -> w2 +
// residual.  Then, optionally, RMSNorm + the classifier: f32 logits [B, v_pad], or the
// first-max argmax over the first `vocab` columns.
//
// Numerics (as the Pallas kernel): the residual stream is f32; each matmul rounds its
// activation to bf16 at the dot, takes each weight as bf16(bf16(code) * bf16(scale)) and sums
// in f32; attention runs in f32 with q scaled by 1/sqrt(128) after RoPE; an INT8 cache's K
// scale multiplies the score and its V scale the probability.
//
// INT4 layers (the Q4 tiles of the Pallas kernel, its _dequant_tile_q4 in the tile loop): the
// four layer matrices of an INT4 checkpoint hold nibble-packed codes [L, n/2, d] (group
// split-half, code + 8; csrc/w8a16_dequant.cuh), and each plan says its own format, so one
// launch carries Q4 layers and the INT8 classifier.  A 16-byte load along d holds 16 columns of
// two in-rows of one group, j and j + g/2; the thread dequantizes the low nibbles against
// activation row j, then the high ones against row j + g/2, with the same rounding as INT8
// (bias 8 in the exponent trick instead of 128).  A staged tile holds its activation rows in
// packed order (staged_row in w8a16_dequant.cuh), so splits and tiles need not hold whole
// groups and any even group size works.
//
// Bound on the H100: bytes.  A step streams every weight byte once (7.8 GB at 8B; 4.3 GB with
// INT4 layers) plus the cache rows below each position, against ~2 flops per weight element
// and row.
// Design against that bound:
//  * one persistent, cooperative grid (the occupancy limit times the SM count, launched with
//    cudaLaunchCooperativeKernel); the phases of a layer are separated by grid-wide barriers
//    (cooperative groups' grid.sync()), so the whole step is one launch and nothing of it
//    returns to the host;
//  * a matmul phase splits its output into 512-column strips and its contraction into
//    splits of kc rows (a plan chosen by the wrapper so that every block gets the same
//    share); each (strip, split) item writes f32 partials, which the next phase sums in
//    split order: deterministic, no float atomics, and one writer per residual column;
//  * inside an item, a thread owns 16 adjacent columns (one 16-byte load per row), keeps 4
//    rows of loads in flight, and the 8 warps split the rows and meet in shared memory;
//  * the RMSNorm prologue is computed by every block from the f32 stream it reads, so a
//    normalized activation never goes to device memory;
//  * each phase is a function of its own (__noinline__), compiled once per row tile or cache
//    type, so the build stays short; the phases share one static shared-memory buffer;
//  * attention is split over (batch row, kv head, 128-row chunk) items, as flash decode is,
//    so that B = 1 still gives the card enough blocks; a merge phase per (row, kv head)
//    seeds the softmax with the self key and merges the chunks in order, then writes the
//    step's K/V row: every read of the layer's cache has finished at the barrier before it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "w8a16_dequant.cuh"

namespace cg = cooperative_groups;

struct MatPlan {
  const void* codes;             // int8 [L, n, d] (the classifier: [n, d]); Q4: uint8 [L, n/2, d]
  const __nv_bfloat16* scales;   // [L, n / g, d]
  int n, d, splits, kc;
  int q4;                        // codes nibble-packed (layer matrices of an INT4 checkpoint)
};

// The C entry point's argument; the wrapper fills a ctypes mirror of it.
struct Params {
  MatPlan mat[5];  // wqkv, wo, w13, w2, head
  const float* x_in;
  float* x_out;
  const float *rms_att, *rms_ffn, *q_norm, *k_norm, *rms_final;
  const float *cos, *sin;  // [B, 64]
  void *k_cache, *v_cache;  // [L, B, n_kv, T, 128]
  float *k_scale, *v_scale;  // [L, B, n_kv, T] (INT8 cache)
  const int *pos, *write_ok;  // [B]; write_ok may be null (all on)
  float* logits;  // [B, v_pad]
  int* tokens;    // [B]
  float* part;    // split partials, the largest plan's splits * B * d
  float* att;     // attention partials: m, l then acc per (row, kv head, chunk, head)
  float* act;     // [B, max(ah, hidden)]: attention output, SwiGLU output
  float* red_val;  // [grid, B] the greedy head's per-block best
  int* red_idx;
  int B, dim, ah, kvd, hidden, n_kv, kv_mul, T, L, g, vocab, v_pad;
  int cache_type, use_qk_norm, has_head, greedy;
  float eps, scale;
};

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kColsPerThread = 16;
constexpr int kStrip = 32 * kColsPerThread;  // 512 output columns per item
constexpr int kRowsPerBatch = kCodeRowsInFlight;  // code rows in flight per thread
constexpr int kTileRows = kThreads;          // activation rows staged per pass
constexpr int kHd = 128;                     // head_dim
constexpr int kChunk = 128;                  // cache rows per attention item
constexpr int kRows = 8;                     // cache rows per warp in flight
constexpr int kMaxM = 8;                     // query heads per attention item
// Shared memory, reused by every phase: the attention items need the most
// (q [M][128], the warps' m and l [8][M], their acc [8][M][128]).
constexpr int kSmemFloats = kMaxM * kHd + 2 * kWarps * kMaxM + kWarps * kMaxM * kHd;

enum Prologue { kNone = 0, kRms = 1 };

// The block's shared memory, used by one phase at a time.
__shared__ __align__(16) float g_smem[kSmemFloats];

constexpr int kNoIndex = 0x7fffffff;  // no column yet

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One matmul phase: part[split, b, :] = act(src)[b, split rows] . W[layer][split rows, :].
// src [B, n] f32 (the stream, or an activation written by an earlier phase); with kRms the
// activation is src * inv_rms(src) * norm_w, rounded to bf16 like every activation.  Q4: the
// layer's codes are nibble-packed [n/2, d], and the tile's activation rows are staged in packed
// order.
template <int BT, bool Q4, bool Shared>
__device__ __noinline__ void matvec(const Params& p, const MatPlan& mp, int layer, int prologue,
                                    const float* src, const float* norm_w) {
  const int N = mp.n, D = mp.d, B = p.B;
  const int8_t* codes = reinterpret_cast<const int8_t*>(mp.codes) + (long)layer * (Q4 ? N / 2 : N) * D;
  const __nv_bfloat16* scales = mp.scales + (long)layer * (N / p.g) * D;
  float* xs = g_smem;                         // [BT][kTileRows]
  float* red = g_smem + BT * kTileRows;       // [kWarps][kStrip]
  float* inv = red + kWarps * kStrip;         // [BT]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (prologue == kRms) {
    // inv = 1 / sqrt(mean(x^2) + eps) of each row, computed alike by every block.
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float ss = 0.f;
      if (b < B)
        for (int i = tid; i < N; i += kThreads) {
          const float v = __ldcg(src + (long)b * N + i);
          ss = fmaf(v, v, ss);
        }
      ss = warp_sum(ss);
      if (lane == 0) red[warp * BT + b] = ss;
    }
    __syncthreads();
    if (tid < BT) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t += red[w * BT + tid];
      inv[tid] = 1.f / sqrtf(t / (float)N + p.eps);
    }
    __syncthreads();
  }

  const int strips = (D + kStrip - 1) / kStrip;
  const int items = strips * mp.splits;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int si = it % strips, ki = it / strips;
    const int col0 = si * kStrip + lane * kColsPerThread;
    const bool active = col0 < D;
    const int k_begin = ki * mp.kc;
    const int k_end = min(N, k_begin + mp.kc);

    float acc[BT][kColsPerThread];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int e = 0; e < kColsPerThread; ++e) acc[b][e] = 0.f;
    GroupScales gs;

    for (int t0 = k_begin; t0 < k_end; t0 += kTileRows) {
      const int rows = min(kTileRows, k_end - t0);  // a multiple of 8
      __syncthreads();  // the previous tile (or item, or the rms sums) is done with smem
      const int r = tid;  // each thread stages one slot of every activation row
      const int n = staged_row<Q4>(t0, r, p.g);
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        float v = 0.f;
        if (r < rows && b < B) {
          v = __ldcg(src + (long)b * N + n);
          if (prologue == kRms) v = v * inv[b] * norm_w[n];
          v = bf16_round(v);
        }
        xs[b * kTileRows + r] = v;
      }
      __syncthreads();
      if (active)
        tile_dot<BT, Q4, Shared>(codes, scales, D, p.g, col0, Q4 ? t0 / 2 : t0, Q4 ? rows / 2 : rows,
                         warp * kRowsPerBatch, kWarps * kRowsPerBatch, xs, kTileRows, gs, acc);
    }

    // Sum the 8 warps' partials per row in warp order; one partial per (split, row, column).
    const int c2 = 2 * tid;  // this thread's two columns of the strip
    const int col = si * kStrip + c2;
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      __syncthreads();
      if (active) {
#pragma unroll
        for (int e = 0; e < kColsPerThread; e += 4)
          *reinterpret_cast<float4*>(&red[warp * kStrip + lane * kColsPerThread + e]) =
              make_float4(acc[b][e], acc[b][e + 1], acc[b][e + 2], acc[b][e + 3]);
      }
      __syncthreads();
      if (b < B && col < D) {
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          s0 += red[w * kStrip + c2];
          s1 += red[w * kStrip + c2 + 1];
        }
        *reinterpret_cast<float2*>(p.part + ((long)ki * B + b) * D + col) = make_float2(s0, s1);
      }
    }
  }
}

// A matmul phase on the plan's code format and group size (uniform over the grid).
template <int BT>
__device__ void matmul(const Params& p, const MatPlan& mp, int layer, int prologue, const float* src,
                       const float* norm_w) {
  const bool shared = rows_share_group(p.g, mp.q4 != 0);
  if (mp.q4) {
    if (shared) matvec<BT, true, true>(p, mp, layer, prologue, src, norm_w);
    else matvec<BT, true, false>(p, mp, layer, prologue, src, norm_w);
  } else {
    if (shared) matvec<BT, false, true>(p, mp, layer, prologue, src, norm_w);
    else matvec<BT, false, false>(p, mp, layer, prologue, src, norm_w);
  }
}

// Sum of the split partials of (row b, column c) of a plan, in split order.
__device__ __forceinline__ float split_sum(const Params& p, const MatPlan& mp, int b, int c) {
  float s = 0.f;
  for (int k = 0; k < mp.splits; ++k) s += __ldcg(p.part + ((long)k * p.B + b) * mp.d + c);
  return s;
}

// dst[b, c] = src[b, c] + (the plan's partials summed): one writer per column.
__device__ void residual_add(const Params& p, const MatPlan& mp, const float* src, float* dst) {
  const long total = (long)p.B * mp.d;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total; i += (long)gridDim.x * kThreads) {
    const int b = (int)(i / mp.d), c = (int)(i % mp.d);
    dst[i] = __ldcg(src + i) + split_sum(p, mp, b, c);
  }
}

// act[b, j] = silu(gate) * up from the w13 partials (gate | up).
__device__ void swiglu(const Params& p) {
  const MatPlan& mp = p.mat[2];
  const long total = (long)p.B * p.hidden;
  for (long i = (long)blockIdx.x * kThreads + threadIdx.x; i < total; i += (long)gridDim.x * kThreads) {
    const int b = (int)(i / p.hidden), j = (int)(i % p.hidden);
    const float gate = split_sum(p, mp, b, j), up = split_sum(p, mp, b, p.hidden + j);
    p.act[i] = gate * (1.f / (1.f + expf(-gate))) * up;
  }
}

// One head vector of row b from the wqkv partials, by one warp: lane holds dims
// lane + 32 * j.  Optional RMSNorm (norm_w), RoPE (pairs d, d + 64) and a final factor.
__device__ void head_vector(const Params& p, int b, int col, const float* norm_w, bool rope,
                            float mul, float* out) {
  const int lane = threadIdx.x & 31;
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = split_sum(p, p.mat[0], b, col + lane + 32 * j);
  if (norm_w != nullptr) {
    const float ss = warp_sum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
    const float inv = 1.f / sqrtf(ss / (float)kHd + p.eps);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = v[j] * inv * norm_w[lane + 32 * j];
  }
  if (rope) {
    const float c0 = p.cos[b * (kHd / 2) + lane], s0 = p.sin[b * (kHd / 2) + lane];
    const float c1 = p.cos[b * (kHd / 2) + lane + 32], s1 = p.sin[b * (kHd / 2) + lane + 32];
    const float a0 = v[0] * c0 - v[2] * s0, a2 = v[0] * s0 + v[2] * c0;
    const float a1 = v[1] * c1 - v[3] * s1, a3 = v[1] * s1 + v[3] * c1;
    v[0] = a0; v[1] = a1; v[2] = a2; v[3] = a3;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[lane + 32 * j] = v[j] * mul;
}

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

// Attention, first pass: one partial (m, l, acc) per (row b, kv head, group of query heads,
// 128-row chunk) over the cache rows below min(pos, T); chunks at or past it are skipped and
// never read.  The kv_mul query heads of a kv head go in groups of up to kMaxM, which share
// each row the item reads and which registers hold.
template <typename TC>
__device__ __noinline__ void attn_chunks(const Params& p, int layer) {
  const int KM = p.kv_mul;
  const int groups = (KM + kMaxM - 1) / kMaxM;
  const int n_chunks = (p.T + kChunk - 1) / kChunk;
  const int items = p.B * p.n_kv * groups * n_chunks;
  const long layer_rows = (long)p.B * p.n_kv * p.T;
  const TC* kc = reinterpret_cast<const TC*>(p.k_cache) + layer * layer_rows * kHd;
  const TC* vc = reinterpret_cast<const TC*>(p.v_cache) + layer * layer_rows * kHd;
  const float* ks = p.k_scale != nullptr ? p.k_scale + layer * layer_rows : nullptr;
  const float* vs = p.v_scale != nullptr ? p.v_scale + layer * layer_rows : nullptr;
  const float* qn = p.use_qk_norm ? p.q_norm + layer * kHd : nullptr;
  float* sq = g_smem;                        // [kMaxM][128]
  float* sm_m = sq + kMaxM * kHd;            // [kWarps][M]
  float* sm_l = sm_m + kWarps * kMaxM;       // [kWarps][M]
  float* sm_acc = sm_l + kWarps * kMaxM;     // [kWarps][M][128]
  float* part_ml = p.att;
  float* part_acc = p.att + (long)p.B * p.n_kv * n_chunks * KM * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int chunk = it % n_chunks, rest = it / n_chunks;
    const int bh = rest / groups, m0 = (rest % groups) * kMaxM;
    const int M = min(kMaxM, KM - m0);  // this item's query heads: m0 .. m0 + M - 1
    const int b = bh / p.n_kv, h = bh % p.n_kv;
    const int pb = min(max(p.pos[b], 0), p.T);
    const int t0 = chunk * kChunk;
    if (t0 >= pb) continue;  // uniform over the block
    const int t1 = min(pb, t0 + kChunk);
    __syncthreads();  // the previous item is done with smem
    for (int m = warp; m < M; m += kWarps)
      head_vector(p, b, (h * KM + m0 + m) * kHd, qn, true, p.scale, sq + m * kHd);
    __syncthreads();

    float qr[kMaxM][4], mrun[kMaxM], lrun[kMaxM], acc[kMaxM][4];
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qr[m][i] = m < M ? sq[m * kHd + lane * 4 + i] : 0.f;
        acc[m][i] = 0.f;
      }
      mrun[m] = -INFINITY;
      lrun[m] = 0.f;
    }
    const long row0 = (long)bh * p.T;  // first cache row of this (b, kv head)
    for (int tb = t0 + warp * kRows; tb < t1; tb += kWarps * kRows) {
      float kf[kRows][4], vf[kRows][4], ksc[kRows], vsc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const bool ok = tb + r < t1;
        if (ok) {
          load4(kc + (row0 + tb + r) * kHd + lane * 4, kf[r]);
          load4(vc + (row0 + tb + r) * kHd + lane * 4, vf[r]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) kf[r][i] = vf[r][i] = 0.f;
        }
        ksc[r] = (ks != nullptr && ok) ? ks[row0 + tb + r] : 1.f;
        vsc[r] = (vs != nullptr && ok) ? vs[row0 + tb + r] : 1.f;
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m >= M) break;
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
    for (int m = 0; m < kMaxM; ++m) {
      if (m >= M) break;
      if (lane == 0) {
        sm_m[warp * kMaxM + m] = mrun[m];
        sm_l[warp * kMaxM + m] = lrun[m];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) sm_acc[(warp * kMaxM + m) * kHd + lane * 4 + i] = acc[m][i];
    }
    __syncthreads();
    if (tid < kHd) {
      const long slot = ((long)bh * n_chunks + chunk) * KM + m0;
      for (int m = 0; m < M; ++m) {
        float mm = -INFINITY;
        for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, sm_m[w * kMaxM + m]);
        float l = 0.f, a = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float c = expf(sm_m[w * kMaxM + m] - mm);
          l = fmaf(sm_l[w * kMaxM + m], c, l);
          a = fmaf(sm_acc[(w * kMaxM + m) * kHd + tid], c, a);
        }
        part_acc[(slot + m) * kHd + tid] = a;
        if (tid == 0) {
          part_ml[(slot + m) * 2] = mm;
          part_ml[(slot + m) * 2 + 1] = l;
        }
      }
    }
  }
}

// INT8 row: scale amax / 127 (1 where it is 0), codes round(x / scale) half to even; one warp.
__device__ void store_row_int8(int8_t* dst, float* scale_dst, const float* v) {
  const int lane = threadIdx.x & 31;
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[lane + 32 * j]));
  amax = warp_max(amax);
  const float sc = amax / 127.f;
  const float safe = sc == 0.f ? 1.f : sc;
#pragma unroll
  for (int j = 0; j < 4; ++j) dst[lane + 32 * j] = (int8_t)__float2int_rn(v[lane + 32 * j] / safe);
  if (lane == 0) *scale_dst = sc;
}

// Attention, second pass, per (row b, kv head): for each group of up to kMaxM query heads, the
// self key seeds the softmax (m = q.k_self, l = 1, acc = v_self) and the chunks below pos merge
// in order; then the step's K/V row.
__device__ __noinline__ void attn_merge(const Params& p, int layer) {
  const int KM = p.kv_mul;
  const int n_chunks = (p.T + kChunk - 1) / kChunk;
  const int items = p.B * p.n_kv;
  const float* part_ml = p.att;
  const float* part_acc = p.att + (long)p.B * p.n_kv * n_chunks * KM * 2;
  const float* qn = p.use_qk_norm ? p.q_norm + layer * kHd : nullptr;
  const float* kn = p.use_qk_norm ? p.k_norm + layer * kHd : nullptr;
  float* vec = g_smem;                      // [kMaxM][128]: a group's q heads
  float* kv = vec + kMaxM * kHd;            // [2][128]: the step's k, v
  float* sself = kv + 2 * kHd;              // [kMaxM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int b = it / p.n_kv, h = it % p.n_kv;
    const int pb = min(max(p.pos[b], 0), p.T);
    const int active = (pb + kChunk - 1) / kChunk;
    for (int m0 = 0; m0 < KM; m0 += kMaxM) {
      const int M = min(kMaxM, KM - m0);
      __syncthreads();  // the previous group (or item) is done with vec, kv and sself
      // The group's q heads, and with the first group the step's k and v, in one pass.
      for (int vi = warp; vi < M + (m0 == 0 ? 2 : 0); vi += kWarps) {
        if (vi < M)
          head_vector(p, b, (h * KM + m0 + vi) * kHd, qn, true, p.scale, vec + vi * kHd);
        else if (vi == M)
          head_vector(p, b, p.ah + h * kHd, kn, true, 1.f, kv);
        else
          head_vector(p, b, p.ah + p.kvd + h * kHd, nullptr, false, 1.f, kv + kHd);
      }
      __syncthreads();
      if (warp < M) {
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s = fmaf(vec[warp * kHd + lane + 32 * j], kv[lane + 32 * j], s);
        s = warp_sum(s);
        if (lane == 0) sself[warp] = s;
      }
      __syncthreads();
      if (tid < kHd) {
        const float vd = kv[kHd + tid];
        for (int m = 0; m < M; ++m) {
          float mcur = sself[m], l = 1.f, a = vd;
          for (int j = 0; j < active; ++j) {
            const long slot = ((long)it * n_chunks + j) * KM + m0 + m;
            const float mj = __ldcg(part_ml + slot * 2), lj = __ldcg(part_ml + slot * 2 + 1);
            const float m_new = fmaxf(mcur, mj);
            const float ca = expf(mcur - m_new), cj = expf(mj - m_new);
            l = l * ca + lj * cj;
            a = a * ca + __ldcg(part_acc + slot * kHd + tid) * cj;
            mcur = m_new;
          }
          p.act[(long)b * p.ah + (h * KM + m0 + m) * kHd + tid] = a / l;
        }
      }
    }
    // The step's K/V row, in place; every read of this layer's cache ended at the barrier.
    if (p.write_ok == nullptr || p.write_ok[b] != 0) {
      const int row = min(max(p.pos[b], 0), p.T - 1);
      const long r = (((long)layer * p.B + b) * p.n_kv + h) * p.T + row;
      if (p.cache_type == 2) {
        if (warp == 0)
          store_row_int8(reinterpret_cast<int8_t*>(p.k_cache) + r * kHd, p.k_scale + r, kv);
        else if (warp == 1)
          store_row_int8(reinterpret_cast<int8_t*>(p.v_cache) + r * kHd, p.v_scale + r, kv + kHd);
      } else if (tid < kHd && p.cache_type == 1) {
        __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(p.k_cache);
        __nv_bfloat16* vc = reinterpret_cast<__nv_bfloat16*>(p.v_cache);
        kc[r * kHd + tid] = __float2bfloat16_rn(kv[tid]);
        vc[r * kHd + tid] = __float2bfloat16_rn(kv[kHd + tid]);
      } else if (tid < kHd) {
        reinterpret_cast<float*>(p.k_cache)[r * kHd + tid] = kv[tid];
        reinterpret_cast<float*>(p.v_cache)[r * kHd + tid] = kv[kHd + tid];
      }
    }
  }
}

__device__ void attention_chunks(const Params& p, int layer) {
  if (p.cache_type == 0) attn_chunks<float>(p, layer);
  else if (p.cache_type == 1) attn_chunks<__nv_bfloat16>(p, layer);
  else attn_chunks<int8_t>(p, layer);
}

// (value, index) with first-max order: larger value, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// Classifier partials -> logits; for greedy, each block's first max over its contiguous
// columns below `vocab`.
__device__ __noinline__ void head_reduce(const Params& p) {
  const MatPlan& mp = p.mat[4];
  const int per = (p.v_pad + gridDim.x - 1) / gridDim.x;
  const int c0 = blockIdx.x * per, c1 = min(p.v_pad, c0 + per);
  float* sv = g_smem;                                 // [kWarps]
  int* si = reinterpret_cast<int*>(g_smem + kWarps);  // [kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = 0; b < p.B; ++b) {
    float bv = -INFINITY;
    int bi = kNoIndex;
    for (int c = c0 + tid; c < c1; c += kThreads) {
      const float s = split_sum(p, mp, b, c);
      p.logits[(long)b * p.v_pad + c] = s;
      if (c < p.vocab && better(s, c, bv, bi)) {
        bv = s;
        bi = c;
      }
    }
    if (!p.greedy) continue;
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    __syncthreads();
    if (lane == 0) {
      sv[warp] = bv;
      si[warp] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w)
        if (better(sv[w], si[w], bv, bi)) {
          bv = sv[w];
          bi = si[w];
        }
      p.red_val[(long)blockIdx.x * p.B + b] = bv;
      p.red_idx[(long)blockIdx.x * p.B + b] = bi;
    }
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1) decode_megakernel_kernel(const __grid_constant__ Params p) {
  cg::grid_group grid = cg::this_grid();
  const int dim = p.dim;
  for (int l = 0; l < p.L; ++l) {
    const float* x = l == 0 ? p.x_in : p.x_out;
    matmul<BT>(p, p.mat[0], l, kRms, x, p.rms_att + (long)l * dim);  // wqkv
    grid.sync();
    attention_chunks(p, l);
    grid.sync();
    attn_merge(p, l);
    grid.sync();
    matmul<BT>(p, p.mat[1], l, kNone, p.act, nullptr);  // wo
    grid.sync();
    residual_add(p, p.mat[1], x, p.x_out);
    grid.sync();
    matmul<BT>(p, p.mat[2], l, kRms, p.x_out, p.rms_ffn + (long)l * dim);  // w13
    grid.sync();
    swiglu(p);
    grid.sync();
    matmul<BT>(p, p.mat[3], l, kNone, p.act, nullptr);  // w2
    grid.sync();
    residual_add(p, p.mat[3], p.x_out, p.x_out);
    grid.sync();
  }
  if (!p.has_head) return;
  matmul<BT>(p, p.mat[4], 0, kRms, p.x_out, p.rms_final);  // the classifier: INT8
  grid.sync();
  head_reduce(p);
  if (!p.greedy) return;
  grid.sync();
  if (blockIdx.x == 0 && threadIdx.x < p.B) {
    // Blocks hold increasing column ranges: the first max over blocks in order.
    const int b = threadIdx.x;
    float bv = -INFINITY;
    int bi = kNoIndex;
    for (int k = 0; k < (int)gridDim.x; ++k) {
      const float v = __ldcg(p.red_val + (long)k * p.B + b);
      const int i = __ldcg(p.red_idx + (long)k * p.B + b);
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    p.tokens[b] = bi == kNoIndex ? 0 : bi;
  }
}

const void* kernel_for(int bt) {
  switch (bt) {
    case 1: return reinterpret_cast<const void*>(&decode_megakernel_kernel<1>);
    case 2: return reinterpret_cast<const void*>(&decode_megakernel_kernel<2>);
    case 4: return reinterpret_cast<const void*>(&decode_megakernel_kernel<4>);
    case 8: return reinterpret_cast<const void*>(&decode_megakernel_kernel<8>);
    default: return nullptr;
  }
}

}  // namespace

// The largest cooperative grid of the kernel for row tile `bt` (1, 2, 4, 8) on the current
// device: blocks per SM at full occupancy times the SM count.  Returns a cudaError_t.
extern "C" int decode_megakernel_grid(int bt, int* grid) {
  const void* k = kernel_for(bt);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return (int)e;
}

// Plain C entry point: one cooperative launch of the whole step on `stream`.  `p` holds
// device pointers and the plans; `grid` must not exceed decode_megakernel_grid(bt).  A grid
// that cannot be co-resident is refused by the launch (the error is returned, nothing runs).
extern "C" int decode_megakernel(const Params* p, int bt, int grid, void* stream) {
  const void* k = kernel_for(bt);
  if (k == nullptr || p->B < 1 || p->B > bt) return (int)cudaErrorInvalidValue;
  void* args[] = {const_cast<Params*>(p)};
  cudaError_t e = cudaLaunchCooperativeKernel(k, dim3(grid), dim3(kThreads), args, 0,
                                              reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
