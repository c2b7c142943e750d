// Paged attention for Hopper (sm_90a), one launch a call: the decode kernel and the window kernel at
// head_dim 128 and 256, the decode kernel past 256 (paged_decode_wide_kernel, every multiple of 128 up
// to 1024) and the window kernel past 256 (paged_window_wide_kernel, every multiple of 128).
//
// Replaces the reference package's Pallas kernels
//   qwen3_rs_tpu/ops/pallas/paged_attention.py::paged_gqa_decode_stacked   (paged_decode_kernel and
//                                                                           paged_decode_wide_kernel)
//   qwen3_rs_tpu/ops/pallas/paged_attention.py::paged_gqa_window_stacked   (paged_window_kernel and
//                                                                           paged_window_wide_kernel:
//                                                                           its _partials_kernel)
// at these head_dims (paged_attention.cu keeps the two-pass kernels for the decode past 1024 and for
// pages that are not a multiple of 16 rows).  The pool of one layer is [P, n_kv, page, hd]; cache row t of request b lives in
// page table[b, t / page] at page row t % page, and only rows t < pos[b] are valid.  INT8 pools: the
// per-row K scale multiplies the score, the V scale the probability after l takes it.
//  * decode: for request b and kv head h the kv_mul query heads of h (pre-scaled by 1/sqrt(hd))
//    attend over those rows and over the step's own key and value:
//        out = softmax([q.k_self, q.K[0:pos]]) . [v_self; V[0:pos]].
//  * window: R = S * kv_mul rows of a window ((mul, s) order, R <= 128) attend over the cache rows,
//    one mask for every row; the kernel returns the unnormalised partials of that part,
//        m = max_t s_t,  l = sum_t exp(s_t - m),  acc = sum_t exp(s_t - m) v_t,
//    with m = -inf, l = 0 and acc = 0 where pos[b] = 0; the caller merges them with the causal
//    attention inside the window.
//
// Bound on the H100: bytes for the decode (each valid row read once for 2 * hd elements, against
// 4 * kv_mul flops per element); for the window the bytes too as long as every query row shares each
// K/V row read (4 * R flops per element, on the tensor cores; with q and P in two bf16 terms each
// product is computed twice, over an f32 pool three times).  What the design does about it:
//  * one launch: a fixed grid of blocks, as many as fit the card (at least one per request, kv head
//    and head tile, or row tile of the window).  Every block reads the positions and makes the same
//    plan from them: the live rows of every request are cut into splits of `span` rows, the least
//    multiple of 16 for which the splits fit the grid, so that the live rows of the whole batch
//    spread over every SM, and block u takes unit u in (request, kv head, tile, split) order (warp 0
//    plans from the positions in registers while the producer warp prefetches the tensor maps).  Its
//    partial (m, l, acc) goes to a workspace slot; the last block of a (request, kv head, tile) to
//    arrive merges the splits in split order: the decode seeded with the self key as the Pallas
//    kernel (m = q.k_self, l = 1, acc = v_self) and normalised, the window with the reference's
//    isfinite guards and left unnormalised.  The result does not depend on scheduling, and the
//    arrival counters are left at zero, so a CUDA graph can replay the launch;
//  * whole pages copied in bulk: a producer warp fills a ring of stages with TMA copies of 16-row
//    boxes of a (page, kv head) slab (the slab is contiguous; a box is 16 rows by one 128-byte band
//    of the row, with the 128-byte swizzle, so that the compute reads it free of bank conflicts), up
//    to 64 rows a stage, never past the page; INT8 pools copy their row scales the same way.  The
//    producer reads the block's page ids once, 32 at a time, one per lane; without a table (a dense
//    layer [B, n_kv, T, hd] viewed as B pages of T rows, the flash_decode wrapper's call) request
//    b's page is b and nothing is read before the first copy;
//  * no shuffle per score: the decode's stage compute follows the pool's type:
//      - bf16 and INT8 pools (kMma): the kv head's query heads against the stage on the tensor cores
//        (mma.sync m16n8k16, cache rows on the 16-row side, the heads padded to 8): q and P are split
//        into bf16 terms (two; three for an INT8 dense layer, which then holds #4's 1e-5), so the f32
//        tolerance holds; the K and V tiles come by ldmatrix from the
//        swizzled stage (INT8 codes converted to bf16 in registers, exactly; their scales go on in
//        f32).  On the card it beat one cache row a lane on the CUDA cores at B = 8 on a bf16 pool,
//        so the CUDA cores are not built for these pools;
//      - f32 pools (kCores), whose K and V are not exact in bf16: on the CUDA cores, 16 rows a warp,
//        a row on two lanes (each half the head_dim, one shuffle to sum them: twice the warps of a
//        row a lane, so a short split's one stage does not rest on one warp), q broadcast from
//        shared memory; then the lanes take the columns for P.V, the probabilities broadcast from
//        the warp's shared scratch.
//    Each consumer warp keeps an online softmax over its rows of every stage; one shuffle reduction
//    per head and stage, not per score; the warps merge at the end of the split.  The last block's
//    merge loads 16 splits' partials at once, unconditionally (the last run's spare slots reload the
//    last split and weigh 0), and rescales its sums once a run, so that each split's weight is an exp
//    of its own (merged one by one, each exp waited on the one before; a loop's remainder issued
//    the last run's loads one by one, and loads behind a condition each ran slower on the card);
//  * the window: all R query rows of a (request, kv head) share each K/V row the block reads (the
//    two-pass kernel read every row once per 8 query rows): a block takes a tile of 64 rows (R = 128
//    in two tiles), its q as bf16 hi + lo in shared memory, and its four consumer warps, one
//    warpgroup, compute each stage's S = Q . K^T and O += P . V on wgmma (P's hi and lo as the
//    register operand, straight from S's accumulators).  An INT8 stage is converted to bf16 once, in
//    shared memory, each warp its 16 rows; an f32 stage (whose rows are not exact in bf16) to bf16
//    hi and lo, and each product takes three terms: q lo . K hi, q hi . K lo, q hi . K hi, and
//    P alike with V (the lo . lo term, under 2^-16 of the product, is left out).  Splits are at least 128 rows (a split's partial is a
//    tile of rows by hd), and the last block weighs each split once a row before it sums the
//    columns.  A first version on mma.sync (each warp 16 query rows against a share of each stage's
//    rows, every warp converting the INT8 codes it read) was slower on the card at every 8B window
//    but S = 4 over an INT8 pool, where the two were level.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kBox = 16;           // rows of one TMA box
constexpr int kBandBytes = 128;    // bytes of one band of a row (the 128-byte swizzle's line)
constexpr int kMaxStages = 4;
constexpr int kHeadsMma = 8;       // the mma route's head tile (the n side of m16n8k16)
constexpr int kCoreRows = 16;      // rows of a stage a consumer warp takes on the CUDA cores

enum Route { kCores = 0, kMma = 1 };

// The stage compute of a pool of element type T.
template <typename T>
__host__ __device__ constexpr int route_of() { return sizeof(T) == 4 ? kCores : kMma; }

// The tensor maps and pointers of one call.
struct Args {
  CUtensorMap kmap, vmap;  // the layer's K and V pool, [P * n_kv, page, hd], 16-row boxes of a band
  const float *q, *k_new, *v_new;  // q [B, n_kv * kv_mul, HD] f32 (unscaled), k_new/v_new [B, n_kv, HD]
  const float *ks, *vs;            // the layer's row scales [P, n_kv, page] (INT8), else null
  const int *table, *pos;          // [B, max_pages], [B]
  float *ws_ml, *ws_acc;           // [grid, qm, 2], [grid, qm, HD]
  int* counters;                   // [B * n_kv * tiles], zero at rest
  float* out;                      // like q
  unsigned long long* stamps;      // [grid, kStamps] global ns of each block's phases, or null
  int B, n_kv, kv_mul, qm, page, max_pages;
  float scale;
  // The window kernel: q is the window [B, S, n_kv * kv_mul, HD] (row r = (mul, s) of kv head h is
  // q[b, s, h * kv_mul + mul]; R = S * kv_mul), out its acc [B, n_kv, R, HD], and out_m / out_l its m
  // and l [B, n_kv, R].
  int R, S;
  float *out_m, *out_l;
  // The window kernel past head_dim 256: the head_dim, and each block's scratch for its q tile's bf16
  // hi and lo terms [grid][hd / 64 bands][2 terms][64 rows x 128 bytes].
  int hd;
  uint8_t* ws_q;
};

// One block's share: request b, kv head h, head tile `tile`, split s of n_s, rows [lo, hi); slot:
// the workspace slot of split 0 of this (b, h, tile) (split s has slot + s); pair: the counter.
struct Unit {
  int b, h, tile, s, n_s, lo, hi, slot, pair;
};

template <typename T>
struct Pool;
template <>
struct Pool<float> {
  static constexpr int kEsz = 4;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Pool<__nv_bfloat16> {
  static constexpr int kEsz = 2;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Pool<int8_t> {
  static constexpr int kEsz = 1;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// The layout of one instance: rows a stage, bands a row, stages, consumer warps, shared memory.
template <typename T, int HD, int R, int KT = 0>
struct Shape {
  static constexpr int kEsz = Pool<T>::kEsz;
  static constexpr int kBands = HD * kEsz / kBandBytes;
  static constexpr int kBandElems = kBandBytes / kEsz;
  static constexpr bool kQuant = kEsz == 1;
  // 64 rows a stage, 32 where a stage of 64 would pass 64 KB (f32 at head_dim 256), or KT.
  static constexpr int kT = KT ? KT : 2 * 64 * HD * kEsz > 65536 ? 32 : 64;
  static constexpr int kKvBytes = kBands * kT * kBandBytes;  // K (or V) of one stage
  static constexpr int kStageBytes = ((2 * kKvBytes + (kQuant ? 2 * kT * 4 : 0)) + 1023) / 1024 * 1024;
  static constexpr int kStages = kStageBytes <= 16384 ? 4 : kStageBytes <= 32768 ? 3 : 2;
  static constexpr int kWarps = kT / 16;  // consumer warps: 16 rows each
  static constexpr int kThreads = (kWarps + 1) * 32;
};

// A block's clock stamps (`stamps`, for the phase breakdown): its start, the plan made, the
// producer's first copies issued, the first stage landed, the last stage done, the partial
// written, the arrival counted, the merge done (the last block only).
constexpr int kStamps = 8;

__device__ __forceinline__ void stamp(const Args& a, int k) {
  if (a.stamps != nullptr) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    a.stamps[blockIdx.x * kStamps + k] = t;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 3-D TMA load of the box at (c0, c1, c2) (element, page row, slab), counted on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// The consumer warps' own barrier (the producer warp never takes part).
__device__ __forceinline__ void consumer_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// Byte offset of 16-byte chunk `c` of band row `r` in a band of a stage (128-byte swizzle: the
// chunks of a row are permuted by the row's index mod 8).
__device__ __forceinline__ int swz(int r, int c) { return r * kBandBytes + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ int live_rows(const Args& a, int b) { return min(max(__ldg(a.pos + b), 0), a.max_pages * a.page); }

// The plan (every block makes the same one, in its warp 0): the least span, a multiple of 16 and at
// least min_boxes boxes (or the longest request's rows), whose splits fit the grid, then unit u's
// place in it.  Returns false if u is past the last unit.  Lane l holds the live rows of requests l,
// l + 32, l + 64 and l + 96 in registers (read once); requests past 128 are read again at each step.
__device__ bool plan_unit(const Args& a, int tiles, int min_boxes, int u, Unit& out) {
  constexpr int kRegs = 4;
  const int lane = threadIdx.x & 31, per = a.n_kv * tiles;
  int pr[kRegs];
#pragma unroll
  for (int c = 0; c < kRegs; ++c) pr[c] = 32 * c + lane < a.B ? live_rows(a, 32 * c + lane) : 0;
  auto live = [&](int c) { return c < kRegs ? pr[c] : (32 * c + lane < a.B ? live_rows(a, 32 * c + lane) : 0); };
  const int chunks = (a.B + 31) / 32;
  int maxp = 0;
  for (int c = 0; c < chunks; ++c) maxp = max(maxp, live(c));
  maxp = __reduce_max_sync(0xffffffffu, maxp);
  auto units = [&](int span) {
    int n = 0;
    for (int c = 0; c < chunks; ++c)
      if (32 * c + lane < a.B) n += max(1, (live(c) + span - 1) / span);
    return (int)__reduce_add_sync(0xffffffffu, (unsigned)n) * per;
  };
  int hi = max(1, (maxp + kBox - 1) / kBox), lo = min(min_boxes, hi);  // in boxes; at hi every request is one split
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (units(mid * kBox) <= (int)gridDim.x) hi = mid;
    else lo = mid + 1;
  }
  const int span = lo * kBox;
  int base = 0;
  for (int c = 0; c < chunks; ++c) {
    const int b = 32 * c + lane;
    const int p = live(c);
    const int s = b < a.B ? max(1, (p + span - 1) / span) : 0;
    int inc = s * per;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    const int tot = __shfl_sync(0xffffffffu, inc, 31);
    if (u < base + tot) {
      const int L = __ffs(__ballot_sync(0xffffffffu, u < base + inc)) - 1;
      const int excl = __shfl_sync(0xffffffffu, inc - s * per, L);
      const int n_s = __shfl_sync(0xffffffffu, s, L), pb = __shfl_sync(0xffffffffu, p, L);
      const int off = u - base - excl, pair = off / n_s;
      out.b = 32 * c + L;
      out.h = pair / tiles;
      out.tile = pair % tiles;
      out.s = off % n_s;
      out.n_s = n_s;
      out.lo = out.s * span;
      out.hi = min(pb, out.lo + span);
      out.slot = base + excl + pair * n_s;
      out.pair = (out.b * a.n_kv + out.h) * tiles + out.tile;
      return true;
    }
    base += tot;
  }
  return false;
}

// Rows [t, t + n) of the split's next stage: never past the split, the page or kT rows.
template <int kT>
__device__ __forceinline__ int stage_rows(const Args& a, const Unit& u, int t) {
  return min(min(u.hi - t, a.page - t % a.page), kT);
}

// --------------------------------------------------------------------------------- producer
template <typename T, int HD, int R, int NST, int KT = 0>
__device__ void produce(const Args& a, const Unit& u, uint8_t* ring, uint32_t bars) {
  using S = Shape<T, HD, R, KT>;
  const int lane = threadIdx.x & 31;
  const int* tab = a.table + (a.table != nullptr ? (long)u.b * a.max_pages : 0L);
  const int p0 = u.lo / a.page;
  int id_base = -32, id = 0, stage = 0;
  uint32_t phase = 0;
  for (int t = u.lo; t < u.hi;) {
    const int n = stage_rows<S::kT>(a, u, t);
    const int pg = t / a.page - p0, r0 = t % a.page;
    int slab = u.b * a.n_kv + u.h;  // a dense layer (no table): request b's rows are page b
    if (a.table != nullptr) {
      if (pg >= id_base + 32) {  // the next 32 page ids, one a lane
        id_base = pg / 32 * 32;
        id = p0 + id_base + lane < a.max_pages ? __ldg(tab + p0 + id_base + lane) : 0;
      }
      slab = __shfl_sync(0xffffffffu, id, pg - id_base) * a.n_kv + u.h;
    }
    const int nbox = (n + kBox - 1) / kBox, srows = (n + 3) & ~3;
    mbar_wait(bars + 8 * (kMaxStages + stage), phase ^ 1u);
    const uint32_t full = bars + 8 * stage;
    if (lane == 0)
      mbar_expect_tx(full, 2 * nbox * S::kBands * kBox * kBandBytes + (S::kQuant ? 2 * srows * 4 : 0));
    __syncwarp();
    const uint32_t dst = smem_u32(ring + stage * S::kStageBytes);
    for (int i = lane; i < 2 * nbox * S::kBands; i += 32) {
      const int kv = i / (nbox * S::kBands), band = i / nbox % S::kBands, j = i % nbox;
      tma_box(dst + kv * S::kKvBytes + band * S::kT * kBandBytes + j * kBox * kBandBytes, kv ? &a.vmap : &a.kmap,
              full, band * S::kBandElems, r0 + j * kBox, slab);
    }
    if (S::kQuant && lane < 2) {
      const float* src = (lane ? a.vs : a.ks) + ((long)slab * a.page + r0);
      bulk_copy(dst + 2 * S::kKvBytes + lane * S::kT * 4, src, srows * 4, full);
    }
    if (t == u.lo && lane == 0) stamp(a, 2);
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
    t += n;
  }
}

// -------------------------------------------------------------------------- consumers: cores
// 16 bytes of a row as floats.
template <typename T>
__device__ __forceinline__ void chunk_floats(const uint8_t* p, float* o);
template <>
__device__ __forceinline__ void chunk_floats<float>(const uint8_t* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

// `E` consecutive elements of a row from byte `cb` of its band (E * esz == 16: one chunk).
template <typename T, int E>
__device__ __forceinline__ void cols_floats(const uint8_t* band_row, int r, int cb, float* o) {
  const uint8_t* p = band_row + ((((cb >> 4) ^ (r & 7)) << 4) | (cb & 15));
  static_assert(sizeof(T) * E == 16, "the CUDA cores read f32 pools in 16-byte chunks");
  chunk_floats<T>(p, o);
}

// The online softmax of a consumer warp: m (the same in every lane), l (each lane's share), and
// its lanes' share of acc.
template <int QM, int NACC>
struct Soft {
  float m[QM], l[QM], acc[QM][NACC];
};

// One stage on the CUDA cores (f32 pools): warp w takes rows [16 w, 16 w + 16).  For the scores lane
// l holds row 16 w + l % 16 and half l / 16 of its head_dim (the halves summed by one shuffle), so a
// stage's rows spread over twice the warps that one row a lane would need; then lane = columns
// [lane * HD / 32, ...) for P.V over the warp's rows.  qs: the scaled q [QM][HD] f32; pw: the warp's
// scratch [16][QM] of probabilities.
template <typename T, int HD, int QM>
__device__ __forceinline__ void stage_cores(const uint8_t* st, int n, int w, const float* qs, float* pw,
                                            Soft<QM, HD / 32>& sm) {
  using S = Shape<T, HD, kCores>;
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  constexpr int C = HD / 32;         // columns a lane in P.V
  constexpr int HB = S::kBands / 2;  // bands of half a row
  const int lane = threadIdx.x & 31, r0 = kCoreRows * w, i = r0 + (lane & 15), half = lane >> 4;
  const int rows = min(kCoreRows, n - r0);
  if (rows <= 0) return;
  const bool valid = (lane & 15) < rows;
  float s[QM];
#pragma unroll
  for (int m = 0; m < QM; ++m) s[m] = 0.f;
  if (valid) {
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) {
      const int band = half * HB + hb;
      const uint8_t* kr = st + band * S::kT * kBandBytes;
#pragma unroll
      for (int c = 0; c < kBandBytes / 16; ++c) {
        float kf[E];
        chunk_floats<T>(kr + swz(i, c), kf);
        const int col = band * S::kBandElems + c * E;
#pragma unroll
        for (int m = 0; m < QM; ++m)
#pragma unroll
          for (int e = 0; e < E; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + m * HD + col + e);
            s[m] = fmaf(qv.x, kf[e], s[m]);
            s[m] = fmaf(qv.y, kf[e + 1], s[m]);
            s[m] = fmaf(qv.z, kf[e + 2], s[m]);
            s[m] = fmaf(qv.w, kf[e + 3], s[m]);
          }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < QM; ++m) s[m] += __shfl_xor_sync(0xffffffffu, s[m], 16);  // both halves: the row's dot
  float ksc = 1.f, vsc = 1.f;
  if (S::kQuant && valid) {
    const float* sc = reinterpret_cast<const float*>(st + 2 * S::kKvBytes);
    ksc = sc[i];
    vsc = sc[S::kT + i];
  }
  float corr[QM];
#pragma unroll
  for (int m = 0; m < QM; ++m) {
    const float sv = valid ? s[m] * ksc : -INFINITY;
    float mx = sv;
#pragma unroll
    for (int o = 8; o; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(sm.m[m], mx);  // finite: row r0 is valid
    corr[m] = expf(sm.m[m] - m_new);
    const float p = valid ? expf(sv - m_new) : 0.f;
    sm.l[m] = sm.l[m] * corr[m] + (half == 0 ? p : 0.f);  // each row once: the lanes of half 0
    sm.m[m] = m_new;
    if (half == 0) pw[(lane & 15) * QM + m] = p * vsc;
  }
  __syncwarp();
#pragma unroll
  for (int m = 0; m < QM; ++m)
#pragma unroll
    for (int j = 0; j < C; ++j) sm.acc[m][j] *= corr[m];
  // Lane's columns: C consecutive elements from column lane * C, in pieces within one chunk.
  constexpr int PE = C * sizeof(T) > 16 ? 16 / sizeof(T) : C;  // elements a piece
  const int col0 = lane * C;
  for (int r = 0; r < rows; ++r) {
    const int ir = r0 + r;
    float v[C];
#pragma unroll
    for (int j = 0; j < C; j += PE) {
      const int col = col0 + j, band = col / S::kBandElems, cb = (col % S::kBandElems) * (int)sizeof(T);
      cols_floats<T, PE>(st + S::kKvBytes + band * S::kT * kBandBytes + ir * kBandBytes, ir, cb, v + j);
    }
    float p[QM];
#pragma unroll
    for (int m = 0; m < QM; m += (QM >= 4 ? 4 : QM)) {
      if constexpr (QM >= 4) {
        const float4 pv = *reinterpret_cast<const float4*>(pw + r * QM + m);
        p[m] = pv.x; p[m + 1] = pv.y; p[m + 2] = pv.z; p[m + 3] = pv.w;
      } else {
#pragma unroll
        for (int k = 0; k < QM; ++k) p[k] = pw[r * QM + k];
      }
    }
#pragma unroll
    for (int m = 0; m < QM; ++m)
#pragma unroll
      for (int j = 0; j < C; ++j) sm.acc[m][j] = fmaf(p[m], v[j], sm.acc[m][j]);
  }
  __syncwarp();  // pw is rewritten by the next stage
}

// ---------------------------------------------------------------------------- consumers: mma
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x as the sum of N bf16 terms, each the nearest bf16 to what the terms before it leave (exactly in
// f32: x minus a nearest bf16 is an f32).  Two terms hold x to ~2^-17 of its value; three hold every
// bit of an f32 (8 + 8 + 8 significant bits).  paged_attention.bf16_terms is the same split in Python.
template <int N>
__device__ __forceinline__ void split_terms(float x0, float x1, uint32_t* out) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    out[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 hf = __bfloat1622float2(h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// Terms of q and P on the decode's mma route (TERMS): two for bf16 and INT8 pools (#9, held to
// 1e-4·max|ref|), three for an INT8 dense layer (#4's call, held to 1e-5, which two missed on the card;
// three were slower on #9's INT8 pool, so the pool keeps two).
constexpr int kExactInt8 = 3;  // the cache type of an INT8 layer on three terms
// The mma route's state of a warp: m and l of heads 2t, 2t+1 (t = lane % 4), and O^T [HD x 8 heads]
// as HD / 16 accumulator tiles.
template <int HD>
struct SoftMma {
  float m[2], l[2], o[HD / 16][4];
};

// bf16 pairs of bytes I and J of 4 int8 codes (xu: the codes ^ 0x80808080), exactly: the float
// with bits 0x4B000000 | (code + 128) is 2^23 + code + 128.
template <int I, int J>
__device__ __forceinline__ uint32_t i8_pair(uint32_t xu) {
  const float a = __int_as_float(__byte_perm(xu, 0x4B000000u, 0x7540 | I)) - 8388736.f;
  const float b = __int_as_float(__byte_perm(xu, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  return pack_bf16(a, b);
}

// One stage on the tensor cores, the warp's 16 rows [16 w, 16 w + 16): S^T = K . q^T (each of q's
// NT terms, NT accumulator chains), the online softmax, O^T += V^T . P^T (each of P's NT terms).
// qf: q's B fragments, term by term.  bf16 rows: fragment tile mt holds head_dim columns 16 mt + g
// (+ 8).  INT8
// rows: the codes are converted to bf16 (exact) in registers; a 32-column tile pair takes K's
// columns 4t .. 4t + 3 of each 16 as k slots 2t, 2t + 1, 2t + 8, 2t + 9 (q's fragments follow), and
// V's even and odd columns as two fragment tiles: tile 2 cp + e holds columns 32 cp + 2 g + e (+ 16).
// The row scales: K's multiplies the score, V's the probability.
template <typename T, int HD, int NT>
__device__ __forceinline__ void stage_mma(uint8_t* st, int n, int w, const uint32_t (&qf)[NT][HD / 16][2],
                                          SoftMma<HD>& sm) {
  using S = Shape<T, HD, kMma>;
  constexpr bool kI8 = S::kQuant;
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int r0 = 16 * w;
  if (r0 >= n) return;
  if (n < r0 + 16) {  // rows past the stage's last valid one: zero V (their P is 0, V may be NaN)
    for (int k = lane; k < (r0 + 16 - n) * S::kBands * 8; k += 32) {
      const int r = n + k / (S::kBands * 8), band = k / 8 % S::kBands;
      *reinterpret_cast<uint4*>(st + S::kKvBytes + band * S::kT * kBandBytes + r * kBandBytes + (k % 8) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
  }
  const uint32_t kbase = smem_u32(st), vbase = kbase + S::kKvBytes;
  float c[NT][4] = {};
  const int mi = lane >> 3;
  if constexpr (kI8) {
    const int row = r0 + (lane & 7) + 8 * (mi & 1), half = mi >> 1;
#pragma unroll
    for (int kk = 0; kk < HD / 16; kk += 2) {  // 32 columns: chunks kk, kk + 1 of the row
      const int band = kk / 8, ch0 = kk % 8 + half;
      uint32_t x[4];
      ldsm_x4(kbase + band * S::kT * kBandBytes + swz(row, ch0), x);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] ^= 0x80808080u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // chunk kk + h: matrices 2 h (rows 0-7) and 2 h + 1 (rows 8-15)
        const uint32_t a[4] = {i8_pair<0, 1>(x[2 * h]), i8_pair<0, 1>(x[2 * h + 1]), i8_pair<2, 3>(x[2 * h]),
                               i8_pair<2, 3>(x[2 * h + 1])};
#pragma unroll
        for (int i = 0; i < NT; ++i) mma_bf16(c[i], a, qf[i][kk + h][0], qf[i][kk + h][1]);
      }
    }
  } else {
    const int row = r0 + (lane & 7) + 8 * (mi & 1), half = mi >> 1;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {  // 16 columns: chunks 2 kk, 2 kk + 1 of the row
      const int band = kk / 4, ch0 = 2 * (kk % 4) + half;
      uint32_t a[4];
      ldsm_x4(kbase + band * S::kT * kBandBytes + swz(row, ch0), a);
#pragma unroll
      for (int i = 0; i < NT; ++i) mma_bf16(c[i], a, qf[i][kk][0], qf[i][kk][1]);
    }
  }
  const bool v0 = r0 + g < n, v1 = r0 + g + 8 < n;
  float ks0 = 1.f, ks1 = 1.f, vs0 = 1.f, vs1 = 1.f;
  if constexpr (kI8) {  // the stage's scales: K's [kT], then V's
    const float* sc = reinterpret_cast<const float*>(st + 2 * S::kKvBytes);
    ks0 = sc[r0 + g];
    ks1 = sc[r0 + g + 8];
    vs0 = sc[S::kT + r0 + g];
    vs1 = sc[S::kT + r0 + g + 8];
  }
  float d[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    d[e] = c[NT - 1][e];  // the smallest terms' sum first
#pragma unroll
    for (int i = NT - 2; i >= 0; --i) d[e] += c[i][e];
  }
  const float s[4] = {v0 ? d[0] * ks0 : -INFINITY, v0 ? d[1] * ks0 : -INFINITY, v1 ? d[2] * ks1 : -INFINITY,
                      v1 ? d[3] * ks1 : -INFINITY};
  float corr[2], p[4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    float mx = fmaxf(s[j], s[j + 2]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(sm.m[j], mx);  // finite: row r0 is valid
    corr[j] = expf(sm.m[j] - m_new);
    p[j] = v0 ? expf(s[j] - m_new) : 0.f;
    p[j + 2] = v1 ? expf(s[j + 2] - m_new) : 0.f;
    sm.l[j] = sm.l[j] * corr[j] + p[j] + p[j + 2];
    sm.m[j] = m_new;
  }
#pragma unroll
  for (int mt = 0; mt < HD / 16; ++mt) {
    sm.o[mt][0] *= corr[0];
    sm.o[mt][1] *= corr[1];
    sm.o[mt][2] *= corr[0];
    sm.o[mt][3] *= corr[1];
  }
  // P^T's C fragments (rows g, g + 8; heads 2t, 2t + 1) transposed into B fragments (rows 2t, 2t + 1
  // and 2t + 8, 2t + 9; head g).  INT8: V's row scale goes on the probability first.
  uint32_t top[NT], bot[NT], b0[NT], b1[NT];
  split_terms<NT>(v0 ? p[0] * vs0 : 0.f, v0 ? p[1] * vs0 : 0.f, top);
  split_terms<NT>(v1 ? p[2] * vs1 : 0.f, v1 ? p[3] * vs1 : 0.f, bot);
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    b0[i] = movmatrix_trans(top[i]);
    b1[i] = movmatrix_trans(bot[i]);
  }
  if constexpr (kI8) {
    const int row = r0 + (lane & 7) + 8 * (mi >> 1), half = mi & 1;
#pragma unroll
    for (int cp = 0; cp < HD / 32; ++cp) {  // head_dim columns 32 cp .. 32 cp + 31
      const int band = cp / 4, ch0 = 2 * (cp % 4) + half;
      uint32_t x[4];
      ldsm_x4_trans(vbase + band * S::kT * kBandBytes + swz(row, ch0), x);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] ^= 0x80808080u;
      const uint32_t ae[4] = {i8_pair<0, 2>(x[0]), i8_pair<0, 2>(x[1]), i8_pair<0, 2>(x[2]), i8_pair<0, 2>(x[3])};
      const uint32_t ao[4] = {i8_pair<1, 3>(x[0]), i8_pair<1, 3>(x[1]), i8_pair<1, 3>(x[2]), i8_pair<1, 3>(x[3])};
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        mma_bf16(sm.o[2 * cp], ae, b0[i], b1[i]);
        mma_bf16(sm.o[2 * cp + 1], ao, b0[i], b1[i]);
      }
    }
  } else {
    const int row = r0 + (lane & 7) + 8 * (mi >> 1), half = mi & 1;
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) {  // head_dim columns 16 mt .. 16 mt + 15
      const int band = mt / 4, ch0 = 2 * (mt % 4) + half;
      uint32_t a[4];
      ldsm_x4_trans(vbase + band * S::kT * kBandBytes + swz(row, ch0), a);
#pragma unroll
      for (int i = 0; i < NT; ++i) mma_bf16(sm.o[mt], a, b0[i], b1[i]);
    }
  }
}

// The head_dim column of fragment tile mt's element e (row half e >> 1) for lane row g.
template <typename T>
__device__ __forceinline__ int o_col(int mt, int e, int g) {
  if constexpr (sizeof(T) == 1) return 32 * (mt >> 1) + 16 * (e >> 1) + 2 * g + (mt & 1);
  else return 16 * mt + g + 8 * (e >> 1);
}

// The tail of a decode block, its split's partial in workspace slot u.slot + u.s (written by the
// NT consumer threads): the last block of the (request, kv head, head tile) to arrive merges the
// splits into out; sself holds the tile's heads' scaled q . k_self.  flag is the block's shared int.
__device__ __forceinline__ void merge_decode(const Args& a, const Unit& u, int hd, long qrow0, const float* sself,
                                             int NT, int& flag) {
  const int tid = threadIdx.x;
  if (u.n_s > 1) {
    __threadfence();
    consumer_sync(NT);
    if (tid == 0) stamp(a, 5);
    if (tid == 0) {
      const int old = atomicAdd(a.counters + u.pair, 1);
      flag = old == u.n_s - 1;
      if (flag) a.counters[u.pair] = 0;  // left at zero for the next launch
    }
    consumer_sync(NT);
    if (tid == 0) stamp(a, 6);
    if (!flag) return;
    __threadfence();
  } else {
    consumer_sync(NT);
  }

  // The last block: the splits merged in split order into the self key's seed (m = q.k_self,
  // l = 1, acc = v_self), normalised; each thread 4 columns of a head.  Runs of 16 splits: a run's
  // loads all go out at once, unconditionally (a slot past the last split reloads the last one; a
  // load behind a condition waited for its data where the branches joined), then the run's largest
  // m, one rescale of the sums to it, and each split's weight exp(m_s - max), independent of the
  // others, added in split order; a slot past the last split weighs 0.
  const int ns = u.n_s, qm = a.qm;
  const float* vn = a.v_new + ((long)u.b * a.n_kv + u.h) * hd;
  for (int k = tid; k < qm * hd / 4; k += NT) {
    const int m = k / (hd / 4), col = k % (hd / 4) * 4;
    float mcur = sself[m], l = 1.f;
    float4 acc = __ldg(reinterpret_cast<const float4*>(vn + col));
    for (int s0 = 0; s0 < ns; s0 += 16) {
      float2 ml[16];
      float4 p4[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long sl = (u.slot + min(s0 + j, ns - 1)) * qm + m;
        ml[j] = __ldcg(reinterpret_cast<const float2*>(a.ws_ml + sl * 2));
        p4[j] = __ldcg(reinterpret_cast<const float4*>(a.ws_acc + sl * hd + col));
      }
      float mx = mcur;
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, s0 + j < ns ? ml[j].x : -INFINITY);
      const float r = expf(mcur - mx);
      l *= r;
      acc = make_float4(acc.x * r, acc.y * r, acc.z * r, acc.w * r);
      mcur = mx;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float c = s0 + j < ns ? expf(ml[j].x - mx) : 0.f;
        l = fmaf(ml[j].y, c, l);
        acc = make_float4(fmaf(p4[j].x, c, acc.x), fmaf(p4[j].y, c, acc.y), fmaf(p4[j].z, c, acc.z),
                          fmaf(p4[j].w, c, acc.w));
      }
    }
    *reinterpret_cast<float4*>(a.out + (qrow0 + m) * hd + col) =
        make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
  if (a.stamps != nullptr) {
    consumer_sync(NT);
    if (tid == 0) stamp(a, 7);
  }
}

// ------------------------------------------------------------------------------- the kernel
// Shared memory: the mbarriers, the unit, the split's flag, q (scaled, [QH][HD] f32), the cores
// route's per-warp scratch, then the ring (1024-aligned), which the warps' merge reuses at the end.
template <typename T, int HD, int R, int QM>
struct Smem {
  using S = Shape<T, HD, R>;
  static constexpr int QH = R == kMma ? kHeadsMma : QM;  // heads the block holds
  static constexpr int kUnit = 2 * kMaxStages * 8, kFlag = kUnit + sizeof(Unit);  // the mbarriers at 0
  static constexpr int kSelf = kFlag + 4;  // the self key's scores [QH]
  static constexpr int kQ = (kSelf + QH * 4 + 15) / 16 * 16;
  static constexpr int kScratch = kQ + QH * HD * 4;
  static constexpr int kRing = kScratch + (R == kCores ? S::kWarps * kCoreRows * QM * 4 : 0);
  static constexpr int kBytes = kRing + 1024 + S::kStages * S::kStageBytes;  // the ring 1024-aligned at run time
  static constexpr int kMergeBytes = S::kWarps * QH * (HD + 2) * 4;
  static_assert(kMergeBytes <= S::kStages * S::kStageBytes, "the warps' merge fits the ring");
};

template <typename T, int HD, int R, int QM, int TERMS>
__global__ void __launch_bounds__(Shape<T, HD, R>::kThreads)
paged_decode_kernel(const __grid_constant__ Args a) {
  using S = Shape<T, HD, R>;
  using L = Smem<T, HD, R, QM>;
  static_assert(R == route_of<T>(), "the pool's type fixes the stage compute");
  constexpr int QH = L::QH, W = S::kWarps, NT = W * 32;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  Unit& unit = *reinterpret_cast<Unit*>(smem + L::kUnit);
  int& flag = *reinterpret_cast<int*>(smem + L::kFlag);
  float* qs = reinterpret_cast<float*>(smem + L::kQ);
  uint8_t* ring = smem + L::kRing;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;  // the swizzle's pattern repeats every 1024 bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) stamp(a, 0);
  const int tiles = a.kv_mul / a.qm;
  if (warp == 0) {
    Unit u;
    const bool ok = plan_unit(a, tiles, 1, blockIdx.x, u);
    if (lane == 0) {
      unit = u;
      flag = ok;
      for (int s = 0; s < S::kStages; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (kMaxStages + s), W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else if (warp == W && lane < 2) {  // meanwhile the tensor maps into the TMA unit's cache
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(lane ? &a.vmap : &a.kmap)) : "memory");
  }
  __syncthreads();
  if (tid == 0) stamp(a, 1);
  if (!flag) return;
  const Unit u = unit;
  if (warp == W) {
    produce<T, HD, R, S::kStages>(a, u, ring, bars);
    return;
  }
  // q of the tile's heads, scaled; zero rows past qm (the mma route's padding).
  const long qrow0 = ((long)u.b * a.n_kv + u.h) * a.kv_mul + u.tile * a.qm;
  for (int k = tid; k < QH * HD; k += NT) {
    const int m = k / HD;
    qs[k] = m < a.qm ? __ldg(a.q + (qrow0 + m) * HD + k % HD) * a.scale : 0.f;
  }
  consumer_sync(NT);
  float* sself = reinterpret_cast<float*>(smem + L::kSelf);  // scaled q . k_self, for the merge
  {
    const float* kn = a.k_new + ((long)u.b * a.n_kv + u.h) * HD;
    for (int m = warp; m < a.qm; m += W) {
      float d = 0.f;
      for (int c = lane; c < HD; c += 32) d = fmaf(qs[m * HD + c], __ldg(kn + c), d);
#pragma unroll
      for (int o = 16; o; o >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o);
      if (lane == 0) sself[m] = d;
    }
  }

  float m_w[QH], l_w[QH];  // this warp's m and l per head, after the split (lane 0's copy is used)
  float* merge = reinterpret_cast<float*>(ring);  // [W][QH][HD + 2] after the ring's last stage
  int stage = 0;
  uint32_t phase = 0;
  if constexpr (R == kCores) {
    Soft<QM, HD / 32> sm;
#pragma unroll
    for (int m = 0; m < QM; ++m) {
      sm.m[m] = -INFINITY;
      sm.l[m] = 0.f;
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) sm.acc[m][j] = 0.f;
    }
    float* pw = reinterpret_cast<float*>(smem + L::kScratch) + warp * kCoreRows * QM;
    for (int t = u.lo; t < u.hi;) {
      const int n = stage_rows<S::kT>(a, u, t);
      mbar_wait(bars + 8 * stage, phase);
      if (t == u.lo && tid == 0) stamp(a, 3);
      stage_cores<T, HD, QM>(ring + stage * S::kStageBytes, n, warp, qs, pw, sm);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + stage));
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1u;
      }
      t += n;
    }
#pragma unroll
    for (int m = 0; m < QM; ++m) {
      float l = sm.l[m];
#pragma unroll
      for (int o = 16; o; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
      m_w[m] = sm.m[m];
      l_w[m] = l;
    }
    consumer_sync(NT);  // every warp is past its last stage: the ring is free
#pragma unroll
    for (int m = 0; m < QM; ++m)
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) merge[(warp * QH + m) * (HD + 2) + lane * (HD / 32) + j] = sm.acc[m][j];
  } else {
    uint32_t qf[TERMS][HD / 16][2];
    {
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // INT8: k slots 2t, 2t + 1 (+ 8) are columns 4t, 4t + 1 (+ 2)
          const float* qr = qs + g * HD + 16 * kk + (S::kQuant ? 2 * h + 4 * t : 8 * h + 2 * t);
          uint32_t x[TERMS];
          split_terms<TERMS>(qr[0], qr[1], x);
#pragma unroll
          for (int i = 0; i < TERMS; ++i) qf[i][kk][h] = x[i];
        }
    }
    SoftMma<HD> sm;
    sm.m[0] = sm.m[1] = -INFINITY;
    sm.l[0] = sm.l[1] = 0.f;
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt) sm.o[mt][0] = sm.o[mt][1] = sm.o[mt][2] = sm.o[mt][3] = 0.f;
    for (int t = u.lo; t < u.hi;) {
      const int n = stage_rows<S::kT>(a, u, t);
      mbar_wait(bars + 8 * stage, phase);
      if (t == u.lo && tid == 0) stamp(a, 3);
      stage_mma<T, HD, TERMS>(ring + stage * S::kStageBytes, n, warp, qf, sm);
      // The zeroed V rows were written by this warp's threads: order them before the next TMA write.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + stage));
      if (++stage == S::kStages) {
        stage = 0;
        phase ^= 1u;
      }
      t += n;
    }
    const int g = lane >> 2, t = lane & 3;
    float l2[2] = {sm.l[0], sm.l[1]};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) l2[j] += __shfl_xor_sync(0xffffffffu, l2[j], o);
    // Lane t holds heads 2t, 2t + 1: every lane learns every head's m and l.
#pragma unroll
    for (int m = 0; m < QH; ++m) {
      m_w[m] = __shfl_sync(0xffffffffu, sm.m[m & 1], m >> 1);
      l_w[m] = __shfl_sync(0xffffffffu, l2[m & 1], m >> 1);
    }
    consumer_sync(NT);
#pragma unroll
    for (int mt = 0; mt < HD / 16; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        merge[(warp * QH + 2 * t + (e & 1)) * (HD + 2) + o_col<T>(mt, e, g)] = sm.o[mt][e];
  }
  if (tid == 0) stamp(a, 4);
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < QH; ++m) {
      merge[(warp * QH + m) * (HD + 2) + HD] = m_w[m];
      merge[(warp * QH + m) * (HD + 2) + HD + 1] = l_w[m];
    }
  consumer_sync(NT);

  // The split's partial: the warps merged (a warp with no rows has m = -inf, l = 0, acc = 0; warp 0
  // has rows whenever the split has any).
  const int qm = a.qm;
  const long slot = u.slot + u.s;
  const bool empty = u.hi <= u.lo;
  for (int k = tid; k < qm * HD; k += NT) {
    const int m = k / HD, col = k % HD;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) mm = fmaxf(mm, merge[(w * QH + m) * (HD + 2) + HD]);
    float l = 0.f, acc = 0.f;
    if (!empty)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float* mw = merge + (w * QH + m) * (HD + 2);
        const float c = expf(mw[HD] - mm);
        l = fmaf(mw[HD + 1], c, l);
        acc = fmaf(mw[col], c, acc);
      }
    a.ws_acc[(slot * qm + m) * HD + col] = acc;
    if (col == 0) {
      a.ws_ml[(slot * qm + m) * 2] = mm;
      a.ws_ml[(slot * qm + m) * 2 + 1] = l;
    }
  }
  merge_decode(a, u, HD, qrow0, sself, NT, flag);
}

// ---------------------------------------------------------------- the decode kernel past 256
// paged_decode_wide_kernel: the decode at every head_dim past 256 up to kMaxWideHeadDim (a multiple
// of 128), one instance a pool type (and #4's INT8 dense layer on three terms), the head_dim at run
// time.  The kernel above stages whole rows, 32-64 a stage, and keeps a full-width O in each warp:
// past 256 a bf16 stage of 32 rows by 512 is 64 KB, and O is hd / 4 registers a lane (128 at 512).
// This one keeps its plan, its TMA ring filled by the producer warp, the self key's seed and the
// last block's merge (merge_decode), and changes the stage:
//  * a stage is 16 rows, one TMA box a band, and its K and its V take a ring slot each (K of stage
//    i, then its V): a slot is 16 rows of the head (6-64 KB), and the ring holds as many as keep a
//    block within kWideBlock (two blocks an SM; at least two slots);
//  * hd / 128 consumer warps, warp w owning head_dim columns [128 w, 128 w + 128).  For each stage a
//    warp computes S^T = K . q^T over its columns for the 16 rows and the tile's heads (bf16 and
//    INT8 rows on mma.sync m16n8k16, q's terms for its columns in registers, the heads padded to 8;
//    f32 rows on the CUDA cores, a row on two lanes, q from shared memory) and writes that partial
//    to shared memory; after one barrier every warp sums the warps' partials in warp order, so that
//    each holds the stage's S and runs the same online softmax (m and l equal in every warp); then
//    O^T += V^T . P^T over its own columns only, P from its registers.  O is 32 floats a lane at
//    every head_dim, and the scores are computed once a stage;
//  * a block takes all the query heads of its kv head up to 8 (the tile: the largest divisor of
//    kv_mul up to 8, decode_qm in Python), so that each K/V row of a (request, kv head) is read from
//    device memory once a launch wherever kv_mul <= 8;
//  * the split's partial goes to its workspace slot straight from the warps' registers, each warp
//    its columns.
// Not built: one warp's S over the whole head with P handed to the others through shared memory,
// which would put hd / 128 times this stage's S chain on one warp while the others wait.
constexpr int kWideRows = 16;          // cache rows of a stage past 256
constexpr int kWarpCols = 128;         // head_dim columns a consumer warp owns past 256
constexpr int kMaxWideHeadDim = 1024;  // the kernel past 256 takes head_dims up to this
constexpr int kMaxWideWarps = kMaxWideHeadDim / kWarpCols;
constexpr int kMaxWideSlots = 12;
constexpr int kWideBlock = 112 * 1024;  // a block's shared memory: two fit an SM's 228 KB
// The head of its shared memory: the mbarriers (a slot's full, then its empty), the unit, the flag,
// the tile's scaled q . k_self for the merge, and each warp's share of it.
constexpr int kWUnit = 2 * kMaxWideSlots * 8, kWFlag = kWUnit + sizeof(Unit), kWSelf = 256, kWSelfParts = 512;
constexpr int kWHead = 1024;
static_assert(kWFlag + 4 <= kWSelf && kWSelfParts + kMaxWideWarps * kHeadsMma * 4 <= kWHead, "the head's layout");

// The layout of paged_decode_wide_kernel for a pool of T at head_dim hd: consumer warps, ring slots,
// a slot's bytes, and byte offsets: the stages' S partials [2][warps][128] f32, the f32 route's P of
// each warp [warps][16][8], the INT8 slots' row scales [kMaxWideSlots][16], the f32 route's q
// [8][hd], the ring (from the next 1024-byte boundary, the swizzle's grid), and the block's bytes.
struct DecWide {
  int warps, slots, slot, part, pw, scales, q, ring, bytes;
};

template <typename T>
__host__ __device__ inline DecWide dec_wide(int hd) {
  constexpr int esz = Pool<T>::kEsz;
  DecWide d;
  d.warps = hd / kWarpCols;
  d.slot = kWideRows * hd * esz;
  d.part = kWHead;
  d.pw = d.part + 2 * d.warps * 128 * 4;
  d.scales = d.pw + (esz == 4 ? d.warps * kWideRows * kHeadsMma * 4 : 0);
  d.q = d.scales + (esz == 1 ? kMaxWideSlots * kWideRows * 4 : 0);
  d.ring = d.q + (esz == 4 ? kHeadsMma * hd * 4 : 0);
  const int fit = (kWideBlock - d.ring - 1024) / d.slot;
  d.slots = fit > kMaxWideSlots ? kMaxWideSlots : fit < 2 ? 2 : fit;
  d.bytes = d.ring + 1024 + d.slots * d.slot;
  return d;
}

// The producer of the kernel past 256: for each stage of 16 rows, K's slot then V's (a TMA box of
// 16 rows by one 128-byte band for each band of the head, one a lane; INT8: the slot's row scales).
template <typename T>
__device__ void produce_wide_decode(const Args& a, const Unit& u, uint8_t* ring, const float* scales,
                                    uint32_t bars, const DecWide& L) {
  constexpr int esz = Pool<T>::kEsz;
  const int lane = threadIdx.x & 31, bands = a.hd * esz / kBandBytes;
  const int* tab = a.table + (a.table != nullptr ? (long)u.b * a.max_pages : 0L);
  const int p0 = u.lo / a.page;
  int id_base = -32, id = 0, slot = 0;
  uint32_t phase = 0;
  for (int t = u.lo; t < u.hi; t += kWideRows) {  // a stage never crosses a page (both multiples of 16)
    const int n = min(u.hi - t, kWideRows), pg = t / a.page - p0, r0 = t % a.page;
    int slab = u.b * a.n_kv + u.h;  // a dense layer (no table): request b's rows are page b
    if (a.table != nullptr) {
      if (pg >= id_base + 32) {  // the next 32 page ids, one a lane
        id_base = pg / 32 * 32;
        id = p0 + id_base + lane < a.max_pages ? __ldg(tab + p0 + id_base + lane) : 0;
      }
      slab = __shfl_sync(0xffffffffu, id, pg - id_base) * a.n_kv + u.h;
    }
    const int srows = (n + 3) & ~3;
    for (int kv = 0; kv < 2; ++kv) {
      mbar_wait(bars + 8 * (kMaxWideSlots + slot), phase ^ 1u);
      const uint32_t full = bars + 8 * slot, dst = smem_u32(ring + slot * L.slot);
      if (lane == 0) mbar_expect_tx(full, bands * kBox * kBandBytes + (esz == 1 ? srows * 4 : 0));
      __syncwarp();
      for (int i = lane; i < bands; i += 32)
        tma_box(dst + i * kBox * kBandBytes, kv ? &a.vmap : &a.kmap, full, i * (kBandBytes / esz), r0, slab);
      if (esz == 1 && lane == 0)
        bulk_copy(smem_u32(scales + slot * kWideRows), (kv ? a.vs : a.ks) + ((long)slab * a.page + r0), srows * 4,
                  full);
      if (++slot == L.slots) {
        slot = 0;
        phase ^= 1u;
      }
    }
    if (t == u.lo && lane == 0) stamp(a, 2);
  }
}

template <typename T, int TERMS>
__global__ void __launch_bounds__((kMaxWideWarps + 1) * 32)
paged_decode_wide_kernel(const __grid_constant__ Args a) {
  constexpr bool kI8 = sizeof(T) == 1, kF32 = sizeof(T) == 4;
  constexpr int kBandBox = kBox * kBandBytes;  // one band of a slot: 16 rows of 128 bytes
  const int hd = a.hd;
  const DecWide L = dec_wide<T>(hd);
  const int W = L.warps, NT = W * 32;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  Unit& unit = *reinterpret_cast<Unit*>(smem + kWUnit);
  int& flag = *reinterpret_cast<int*>(smem + kWFlag);
  float* sself = reinterpret_cast<float*>(smem + kWSelf);
  float* sparts = reinterpret_cast<float*>(smem + kWSelfParts);
  float* part = reinterpret_cast<float*>(smem + L.part);
  const float* scl = reinterpret_cast<const float*>(smem + L.scales);
  uint8_t* ring = smem + L.ring;
  ring += (1024 - (smem_u32(ring) & 1023)) & 1023;  // the swizzle's pattern repeats every 1024 bytes
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const auto full = [&](int i) { return bars + 8 * i; };
  const auto empty = [&](int i) { return bars + 8 * (kMaxWideSlots + i); };
  if (tid == 0) stamp(a, 0);
  if (warp == 0) {
    Unit u;
    const bool ok = plan_unit(a, a.kv_mul / a.qm, 1, blockIdx.x, u);
    if (lane == 0) {
      unit = u;
      flag = ok;
      for (int s = 0; s < L.slots; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else if (warp == W && lane < 2) {  // meanwhile the tensor maps into the TMA unit's cache
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(lane ? &a.vmap : &a.kmap)) : "memory");
  }
  __syncthreads();
  if (tid == 0) stamp(a, 1);
  if (!flag) return;
  const Unit u = unit;
  if (warp == W) {
    produce_wide_decode<T>(a, u, ring, scl, bars, L);
    return;
  }
  const int qm = a.qm, c0 = warp * kWarpCols;
  const long bh = (long)u.b * a.n_kv + u.h, qrow0 = bh * a.kv_mul + u.tile * qm;
  const float* kn = a.k_new + bh * hd;
  // The scaled q . k_self of the tile's heads is summed over each warp's columns into sparts, read
  // with the same loads as q (one round of loads before the first stage), and over the warps at
  // the end.
  const long slot0 = u.slot + u.s;
  int slot = 0, par = 0;
  uint32_t phase = 0;
  // The next slot of the ring and its phase (a stage takes K's, then V's).
  const auto next = [&](int& s, uint32_t& ph) {
    s = slot;
    ph = phase;
    if (++slot == L.slots) {
      slot = 0;
      phase ^= 1u;
    }
  };
  if constexpr (!kF32) {
    const int g = lane >> 2, t4 = lane & 3, mi = lane >> 3;
    // q's B fragments for the warp's 8 k-steps, term by term (heads past qm zero).  bf16 rows: k-step
    // kk holds columns c0 + 16 kk + 2 t4 (+ 1) and + 8; INT8 rows: c0 + 16 kk + 4 t4 .. + 3 (the
    // converted codes' k slots, as in stage_mma).
    // Lane (g, t4) reads 32 of head g's 128 columns; with k_self's, its share of q . k_self.
    uint32_t qf[TERMS][8][2];
    {
      float2 x[8][2], kx[8][2];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = c0 + 16 * kk + (kI8 ? 2 * h + 4 * t4 : 8 * h + 2 * t4);
          x[kk][h] = g < qm ? __ldg(reinterpret_cast<const float2*>(a.q + (qrow0 + g) * hd + col)) : make_float2(0.f, 0.f);
          kx[kk][h] = __ldg(reinterpret_cast<const float2*>(kn + col));
        }
      float d = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float q0 = x[kk][h].x * a.scale, q1 = x[kk][h].y * a.scale;
          d = fmaf(q1, kx[kk][h].y, fmaf(q0, kx[kk][h].x, d));
          uint32_t y[TERMS];
          split_terms<TERMS>(q0, q1, y);
#pragma unroll
          for (int i = 0; i < TERMS; ++i) qf[i][kk][h] = y[i];
        }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      if (t4 == 0 && g < qm) sparts[warp * kHeadsMma + g] = d;
    }
    float mrun[2] = {-INFINITY, -INFINITY}, lrun[2] = {0.f, 0.f}, o[8][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) o[mt][0] = o[mt][1] = o[mt][2] = o[mt][3] = 0.f;
    for (int t = u.lo; t < u.hi; t += kWideRows) {
      const int n = min(u.hi - t, kWideRows);
      int ks, vs;
      uint32_t kph, vph;
      next(ks, kph);
      next(vs, vph);
      mbar_wait(full(ks), kph);
      if (t == u.lo && tid == 0) stamp(a, 3);
      // S^T over the warp's columns: rows g, g + 8 of the stage; heads 2 t4, 2 t4 + 1.
      const uint32_t kb = smem_u32(ring + ks * L.slot);
      float c[TERMS][4] = {};
      if constexpr (kI8) {  // the warp's 128 columns are band `warp`
        const int row = (lane & 7) + 8 * (mi & 1), half = mi >> 1;
#pragma unroll
        for (int kk = 0; kk < 8; kk += 2) {
          uint32_t x[4];
          ldsm_x4(kb + warp * kBandBox + swz(row, kk + half), x);
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] ^= 0x80808080u;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint32_t af[4] = {i8_pair<0, 1>(x[2 * h]), i8_pair<0, 1>(x[2 * h + 1]), i8_pair<2, 3>(x[2 * h]),
                                    i8_pair<2, 3>(x[2 * h + 1])};
#pragma unroll
            for (int i = 0; i < TERMS; ++i) mma_bf16(c[i], af, qf[i][kk + h][0], qf[i][kk + h][1]);
          }
        }
      } else {  // bands 2 warp and 2 warp + 1
        const int row = (lane & 7) + 8 * (mi & 1), half = mi >> 1;
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          uint32_t af[4];
          ldsm_x4(kb + (2 * warp + kk / 4) * kBandBox + swz(row, 2 * (kk % 4) + half), af);
#pragma unroll
          for (int i = 0; i < TERMS; ++i) mma_bf16(c[i], af, qf[i][kk][0], qf[i][kk][1]);
        }
      }
      float ks0 = 1.f, ks1 = 1.f;
      if constexpr (kI8) {
        ks0 = scl[ks * kWideRows + g];
        ks1 = scl[ks * kWideRows + g + 8];
      }
      // K's slot is free: its reads ordered before the producer's next TMA write into it (without
      // this fence an INT8 stage, whose slots the producer refills at once, now and then read a
      // later lap's rows).
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(ks));
      float* pp = part + par * W * 128;
      {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          d[e] = c[TERMS - 1][e];  // the smallest terms' sum first
#pragma unroll
          for (int i = TERMS - 2; i >= 0; --i) d[e] += c[i][e];
        }
        *reinterpret_cast<float4*>(pp + (warp * 32 + lane) * 4) = make_float4(d[0], d[1], d[2], d[3]);
      }
      consumer_sync(NT);
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int w = 0; w < W; ++w) {
        const float4 x = *reinterpret_cast<const float4*>(pp + (w * 32 + lane) * 4);
        sum[0] += x.x;
        sum[1] += x.y;
        sum[2] += x.z;
        sum[3] += x.w;
      }
      par ^= 1;
      // The online softmax, as stage_mma's (INT8: K's row scale on the score, V's on the probability).
      const bool v0 = g < n, v1 = g + 8 < n;
      const float s[4] = {v0 ? sum[0] * ks0 : -INFINITY, v0 ? sum[1] * ks0 : -INFINITY,
                          v1 ? sum[2] * ks1 : -INFINITY, v1 ? sum[3] * ks1 : -INFINITY};
      float corr[2], p[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float mx = fmaxf(s[j], s[j + 2]);
#pragma unroll
        for (int o_ = 4; o_ < 32; o_ <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
        const float m_new = fmaxf(mrun[j], mx);  // finite: the stage's row 0 is valid
        corr[j] = expf(mrun[j] - m_new);
        p[j] = v0 ? expf(s[j] - m_new) : 0.f;
        p[j + 2] = v1 ? expf(s[j + 2] - m_new) : 0.f;
        lrun[j] = lrun[j] * corr[j] + p[j] + p[j + 2];
        mrun[j] = m_new;
      }
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        o[mt][0] *= corr[0];
        o[mt][1] *= corr[1];
        o[mt][2] *= corr[0];
        o[mt][3] *= corr[1];
      }
      mbar_wait(full(vs), vph);
      float vs0 = 1.f, vs1 = 1.f;
      if constexpr (kI8) {
        vs0 = scl[vs * kWideRows + g];
        vs1 = scl[vs * kWideRows + g + 8];
      }
      uint32_t top[TERMS], bot[TERMS], b0[TERMS], b1[TERMS];
      split_terms<TERMS>(v0 ? p[0] * vs0 : 0.f, v0 ? p[1] * vs0 : 0.f, top);
      split_terms<TERMS>(v1 ? p[2] * vs1 : 0.f, v1 ? p[3] * vs1 : 0.f, bot);
#pragma unroll
      for (int i = 0; i < TERMS; ++i) {
        b0[i] = movmatrix_trans(top[i]);
        b1[i] = movmatrix_trans(bot[i]);
      }
      uint8_t* vst = ring + vs * L.slot;
      if (!kI8 && n < kWideRows) {  // bf16 rows past the stage's last valid one: zero (P is 0, V may be NaN)
        for (int k = lane; k < (kWideRows - n) * 16; k += 32) {  // (row, band of the warp's two, chunk)
          const int r = n + k / 16, band = 2 * warp + (k >> 3 & 1);
          *reinterpret_cast<uint4*>(vst + band * kBandBox + r * kBandBytes + (k & 7) * 16) = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncwarp();
      }
      const uint32_t vb = smem_u32(vst);
      if constexpr (kI8) {
        const int row = (lane & 7) + 8 * (mi >> 1), half = mi & 1;
#pragma unroll
        for (int cp = 0; cp < 4; ++cp) {  // columns c0 + 32 cp .. + 31
          uint32_t x[4];
          ldsm_x4_trans(vb + warp * kBandBox + swz(row, 2 * cp + half), x);
#pragma unroll
          for (int i = 0; i < 4; ++i) x[i] ^= 0x80808080u;
          const uint32_t ae[4] = {i8_pair<0, 2>(x[0]), i8_pair<0, 2>(x[1]), i8_pair<0, 2>(x[2]), i8_pair<0, 2>(x[3])};
          const uint32_t ao[4] = {i8_pair<1, 3>(x[0]), i8_pair<1, 3>(x[1]), i8_pair<1, 3>(x[2]), i8_pair<1, 3>(x[3])};
#pragma unroll
          for (int i = 0; i < TERMS; ++i) {
            mma_bf16(o[2 * cp], ae, b0[i], b1[i]);
            mma_bf16(o[2 * cp + 1], ao, b0[i], b1[i]);
          }
        }
      } else {
        const int row = (lane & 7) + 8 * (mi >> 1), half = mi & 1;
#pragma unroll
        for (int mt = 0; mt < 8; ++mt) {  // columns c0 + 16 mt .. + 15
          uint32_t af[4];
          ldsm_x4_trans(vb + (2 * warp + mt / 4) * kBandBox + swz(row, 2 * (mt % 4) + half), af);
#pragma unroll
          for (int i = 0; i < TERMS; ++i) mma_bf16(o[mt], af, b0[i], b1[i]);
        }
      }
      // V's slot is free: its reads and zeroed rows ordered before the next TMA write into it.
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(vs));
    }
    if (tid == 0) stamp(a, 4);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int o_ = 4; o_ < 32; o_ <<= 1) lrun[j] += __shfl_xor_sync(0xffffffffu, lrun[j], o_);
    // The split's partial: each warp its columns; m and l (equal in every warp) from warp 0.
#pragma unroll
    for (int mt = 0; mt < 8; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = 2 * t4 + (e & 1);
        if (m < qm) a.ws_acc[(slot0 * qm + m) * hd + c0 + o_col<T>(mt, e, g)] = o[mt][e];
      }
    if (warp == 0 && g == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (2 * t4 + j < qm) {
          a.ws_ml[(slot0 * qm + 2 * t4 + j) * 2] = mrun[j];
          a.ws_ml[(slot0 * qm + 2 * t4 + j) * 2 + 1] = lrun[j];
        }
  } else {
    // f32 rows on the CUDA cores.  S: lane l holds stage row l % 16 and half l / 16 of the warp's
    // columns (two 128-byte bands; one shuffle sums the halves); P.V: lane l holds columns
    // c0 + 4 l .. + 3, the probabilities broadcast from the warp's scratch.
    float* qs = reinterpret_cast<float*>(smem + L.q);  // the tile's q, scaled [qm][hd]
    const float4 k4 = __ldg(reinterpret_cast<const float4*>(kn + c0) + lane);
    for (int k = tid; k < qm * hd; k += NT) qs[k] = __ldg(a.q + qrow0 * hd + k) * a.scale;
    consumer_sync(NT);
    for (int m = 0; m < qm; ++m) {  // lane l: columns c0 + 4 l .. + 3
      const float4 q4 = *reinterpret_cast<const float4*>(qs + m * hd + c0 + 4 * lane);
      float d = fmaf(q4.w, k4.w, fmaf(q4.z, k4.z, fmaf(q4.y, k4.y, q4.x * k4.x)));
#pragma unroll
      for (int o_ = 16; o_; o_ >>= 1) d += __shfl_xor_sync(0xffffffffu, d, o_);
      if (lane == 0) sparts[warp * kHeadsMma + m] = d;
    }
    float* pw = reinterpret_cast<float*>(smem + L.pw) + warp * kWideRows * kHeadsMma;  // [16][8]
    const int r = lane & 15, half = lane >> 4;
    float mrun[kHeadsMma], lrun[kHeadsMma], acc[kHeadsMma][4];
#pragma unroll
    for (int m = 0; m < kHeadsMma; ++m) {
      mrun[m] = -INFINITY;
      lrun[m] = 0.f;
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;
    }
    const int vcol = c0 + 4 * lane, vband = vcol / 32, vch = vcol % 32 / 4;
    for (int t = u.lo; t < u.hi; t += kWideRows) {
      const int n = min(u.hi - t, kWideRows);
      int ks, vs;
      uint32_t kph, vph;
      next(ks, kph);
      next(vs, vph);
      mbar_wait(full(ks), kph);
      if (t == u.lo && tid == 0) stamp(a, 3);
      const uint8_t* kst = ring + ks * L.slot;
      float s[kHeadsMma];
#pragma unroll
      for (int m = 0; m < kHeadsMma; ++m) s[m] = 0.f;
#pragma unroll 1
      for (int hb = 0; hb < 2; ++hb) {  // one band's loads in flight at a time: a full unroll spilled
        const int band = 4 * warp + 2 * half + hb;  // 32 columns a band
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
          const float4 kf = *reinterpret_cast<const float4*>(kst + band * kBandBox + swz(r, ch));
          const float* qc = qs + band * 32 + 4 * ch;
#pragma unroll
          for (int m = 0; m < kHeadsMma; ++m)
            if (m < qm) {
              const float4 qv = *reinterpret_cast<const float4*>(qc + m * hd);
              s[m] = fmaf(qv.x, kf.x, s[m]);
              s[m] = fmaf(qv.y, kf.y, s[m]);
              s[m] = fmaf(qv.z, kf.z, s[m]);
              s[m] = fmaf(qv.w, kf.w, s[m]);
            }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // K's slot is free
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(ks));
#pragma unroll
      for (int m = 0; m < kHeadsMma; ++m) s[m] += __shfl_xor_sync(0xffffffffu, s[m], 16);  // both halves
      float* pp = part + par * W * 128;  // [warps][16 rows][8 heads]
      if (half == 0) {
        *reinterpret_cast<float4*>(pp + (warp * 16 + r) * 8) = make_float4(s[0], s[1], s[2], s[3]);
        *reinterpret_cast<float4*>(pp + (warp * 16 + r) * 8 + 4) = make_float4(s[4], s[5], s[6], s[7]);
      }
      consumer_sync(NT);
#pragma unroll
      for (int m = 0; m < kHeadsMma; ++m) s[m] = 0.f;
      for (int w = 0; w < W; ++w) {
        const float4 x0 = *reinterpret_cast<const float4*>(pp + (w * 16 + r) * 8);
        const float4 x1 = *reinterpret_cast<const float4*>(pp + (w * 16 + r) * 8 + 4);
        s[0] += x0.x;
        s[1] += x0.y;
        s[2] += x0.z;
        s[3] += x0.w;
        s[4] += x1.x;
        s[5] += x1.y;
        s[6] += x1.z;
        s[7] += x1.w;
      }
      par ^= 1;
      const bool valid = r < n;
      float corr[kHeadsMma];
#pragma unroll
      for (int m = 0; m < kHeadsMma; ++m) {
        corr[m] = 1.f;
        if (m < qm) {
          const float sv = valid ? s[m] : -INFINITY;
          float mx = sv;
#pragma unroll
          for (int o_ = 8; o_; o_ >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
          const float m_new = fmaxf(mrun[m], mx);  // finite: the stage's row 0 is valid
          corr[m] = expf(mrun[m] - m_new);
          const float pr = valid ? expf(sv - m_new) : 0.f;
          lrun[m] = lrun[m] * corr[m] + (half == 0 ? pr : 0.f);  // each row once: the lanes of half 0
          mrun[m] = m_new;
          if (half == 0) pw[r * kHeadsMma + m] = pr;
        }
      }
      __syncwarp();
#pragma unroll
      for (int m = 0; m < kHeadsMma; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[m][j] *= corr[m];
      mbar_wait(full(vs), vph);
      const uint8_t* vst = ring + vs * L.slot + vband * kBandBox;
      for (int i = 0; i < n; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(vst + swz(i, vch));
        const float4 p0 = *reinterpret_cast<const float4*>(pw + i * kHeadsMma);
        const float4 p1 = *reinterpret_cast<const float4*>(pw + i * kHeadsMma + 4);
        const float pr[kHeadsMma] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int m = 0; m < kHeadsMma; ++m)
          if (m < qm) {
            acc[m][0] = fmaf(pr[m], v.x, acc[m][0]);
            acc[m][1] = fmaf(pr[m], v.y, acc[m][1]);
            acc[m][2] = fmaf(pr[m], v.z, acc[m][2]);
            acc[m][3] = fmaf(pr[m], v.w, acc[m][3]);
          }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // V's slot is free
      __syncwarp();  // and pw is rewritten by the next stage
      if (lane == 0) mbar_arrive(empty(vs));
    }
    if (tid == 0) stamp(a, 4);
#pragma unroll
    for (int m = 0; m < kHeadsMma; ++m)
      if (m < qm) {
        *reinterpret_cast<float4*>(a.ws_acc + (slot0 * qm + m) * hd + vcol) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        float l = lrun[m];
#pragma unroll
        for (int o_ = 16; o_; o_ >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o_);
        if (warp == 0 && lane == 0) {
          a.ws_ml[(slot0 * qm + m) * 2] = mrun[m];
          a.ws_ml[(slot0 * qm + m) * 2 + 1] = l;
        }
      }
  }
  consumer_sync(NT);
  if (tid < qm) {
    float d = 0.f;
    for (int w = 0; w < W; ++w) d += sparts[w * kHeadsMma + tid];
    sself[tid] = d;
  }
  merge_decode(a, u, hd, qrow0, sself, NT, flag);
}

// ------------------------------------------------------------------------- the window kernel
// paged_window_kernel: the cache part of a window of S query rows, R = S * kv_mul rows a kv head,
// in tiles of kRowTile rows.  Unit u of the plan (tiles = ceil(R / kRowTile) in place of head tiles)
// is one split of one (request, kv head, row tile): the producer warp brings its rows as the decode
// kernel's does, and the four consumer warps, one warpgroup, take the tile's 64 query rows against
// each stage's 64 cache rows on wgmma: S = Q . K^T with q's bf16 hi and lo in shared memory (m64n64k16,
// both operands K-major), the online softmax in registers, O += P . V with P's hi and lo as the
// register operand and V (row-major: MN-major) in shared memory (m64n{hd}k16).  Every query row of
// the tile shares each K/V row the block reads.  An INT8 stage is first converted to bf16 (exactly)
// in shared memory, each warp its 16 rows, and released as soon as it is; an f32 stage likewise to
// K's and V's bf16 hi and lo, by the whole warpgroup (at head_dim 256 an f32 stage has 32 rows, so
// that a stage, its conversion and q fit: S is m64n32k16 there).
// An f32 pool's products could instead run on the CUDA cores (#9's stage_cores widened to a tile of
// query rows, q from shared memory, every product in f32, 4 * R * hd flops a cache row at 67 TFLOP/s);
// the tensor cores' three terms keep the bf16 pools' structure and their rate.  Measured and not
// kept: 64-row f32 stages in a ring of two (a block then takes 225 KB, one an SM, and the plan's
// splits, cut for a wave of one block an SM, leave the longest request on one block).
constexpr int kRowTile = 64;
// A window split's least rows (2 stages): its partial is 64 rows by hd, so a shorter split costs its
// block's fixed start and its partial's write and merge more than it saves.
constexpr int kWinMinSpan = 128;

// The window kernel's threads: one warpgroup of consumers (a 64-row tile of query rows) and the
// producer warp.
constexpr int kWinWarps = kRowTile / 16;
constexpr int kWinThreads = (kWinWarps + 1) * 32;

// Cache rows of a window stage: 64; an f32 stage 32, so that its conversion to bf16 hi and lo, q
// and one stage of the ring take half an SM's shared memory (two blocks an SM at head_dim 128).
template <typename T>
__host__ __device__ constexpr int win_rows() { return sizeof(T) == 4 ? 32 : 64; }

// The window kernel's layout: the mbarriers, the unit and the split's flag in the first kHead bytes,
// then from the next 1024-byte boundary (the swizzle's grid, which wgmma reads by address): the
// tile's q as bf16 hi and lo in 128-byte swizzled bands, the converted stage (INT8: a bf16 stage,
// then its K and V row scales; f32: K's bf16 hi and lo, then V's), and the ring: two stages, one
// of an f32 pool (converted as soon as it lands, it is free while the products run).  A stage has
// win_rows cache rows; the converted stage's bands have as many rows.
template <typename T, int HD>
struct WinSmem {
  using S = Shape<T, HD, kMma, win_rows<T>()>;
  using B = Shape<__nv_bfloat16, HD, kMma>;  // the layout wgmma reads
  static constexpr bool kF32 = sizeof(T) == 4;
  static_assert(S::kT == kRowTile || (kF32 && S::kT == kRowTile / 2), "a stage of 64 rows (f32: 32)");
  static constexpr int kUnit = 2 * kMaxStages * 8, kFlag = kUnit + sizeof(Unit), kHead = 128;
  static constexpr int kQTerm = kRowTile * HD * 2;  // bytes of one bf16 term of the tile's q
  static constexpr int kConv = 2 * kQTerm;          // from the aligned base
  static constexpr int kTerm = HD / 64 * S::kT * kBandBytes;  // one bf16 matrix of a converted stage
  static constexpr int kConvBytes = kF32 ? 4 * kTerm
                                         : S::kQuant ? (2 * B::kKvBytes + 2 * kRowTile * 4 + 1023) / 1024 * 1024 : 0;
  static constexpr int kRing = kConv + kConvBytes;
  static constexpr int kStages = kF32 ? 1 : 2;
  static constexpr int kBytes = kHead + 1024 + kRing + kStages * S::kStageBytes;
  static_assert(kFlag + 4 <= kHead, "the head holds the barriers, the unit and the flag");
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
};

// The byte of element pair (row, 2 c) of a q term: bands of 64 bf16 columns, 128-byte swizzled rows.
__device__ __forceinline__ int q_byte(int row, int c) {
  return (c >> 6) * kRowTile * kBandBytes + swz(row, (c & 63) >> 3) + (c & 7) * 2;
}

// Rows [16 w, 16 w + 16) of an INT8 stage into the bf16 stage layout (each code exactly; rows at or
// past n zero, which wgmma then multiplies by P = 0), and their K and V row scales after it.
template <int HD>
__device__ __forceinline__ void convert_rows(const uint8_t* st8, uint8_t* stb, int w, int n) {
  using S8 = Shape<int8_t, HD, kMma>;
  using SB = Shape<__nv_bfloat16, HD, kMma>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = lane; k < 2 * 16 * (HD / 16); k += 32) {  // (K or V, row, 16 codes)
    const int kv = k / (16 * (HD / 16)), row = 16 * w + k / (HD / 16) % 16, c = k % (HD / 16);
    uint32_t xw[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};  // codes 0 after the flip
    if (row < n) {
      const uint4 x = *reinterpret_cast<const uint4*>(st8 + kv * S8::kKvBytes + (c >> 3) * S8::kT * kBandBytes +
                                                      swz(row, c & 7));
      xw[0] = x.x ^ 0x80808080u, xw[1] = x.y ^ 0x80808080u, xw[2] = x.z ^ 0x80808080u, xw[3] = x.w ^ 0x80808080u;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // bf16 chunk 2 c + h: codes 8 h .. 8 h + 7
      const int cb = 2 * c + h;
      *reinterpret_cast<uint4*>(stb + kv * SB::kKvBytes + (cb >> 3) * SB::kT * kBandBytes + swz(row, cb & 7)) =
          make_uint4(i8_pair<0, 1>(xw[2 * h]), i8_pair<2, 3>(xw[2 * h]), i8_pair<0, 1>(xw[2 * h + 1]),
                     i8_pair<2, 3>(xw[2 * h + 1]));
    }
  }
  if (lane < 16) {
    const float* sc = reinterpret_cast<const float*>(st8 + 2 * S8::kKvBytes);
    float* dc = reinterpret_cast<float*>(stb + 2 * SB::kKvBytes);
    dc[16 * w + lane] = sc[16 * w + lane];
    dc[kRowTile + 16 * w + lane] = sc[S8::kT + 16 * w + lane];
  }
}

// V rows [n, 64) of a bf16 stage zeroed (they may hold anything, NaN included, and wgmma multiplies
// them by P = 0), by the warpgroup's 128 threads.
template <int HD>
__device__ __forceinline__ void zero_rows(uint8_t* st, int n) {
  using SB = Shape<__nv_bfloat16, HD, kMma>;
  for (int k = (int)threadIdx.x; k < (kRowTile - n) * (HD / 8); k += 128) {  // (row, 16-byte chunk)
    const int row = n + k / (HD / 8), c = k % (HD / 8);
    *reinterpret_cast<uint4*>(st + SB::kKvBytes + (c >> 3) * SB::kT * kBandBytes + swz(row, c & 7)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// An f32 stage of KT rows as bf16 hi and lo (hi = the nearest bf16, lo = the nearest to what hi
// leaves), K's two then V's, each a bf16 stage of KT-row bands; rows at or past n zero (their P is
// 0, and V may hold NaN).  The warpgroup's 128 threads take 16-byte pieces of rows in turn, 8 loads
// in flight a thread.
template <int HD, int KT>
__device__ __forceinline__ void convert_f32_rows(const uint8_t* st, uint8_t* conv, int n) {
  using S32 = Shape<float, HD, kMma, KT>;
  constexpr int kTerm = HD / 64 * KT * kBandBytes, kPieces = 2 * KT * (HD / 4), kBatch = 8;
  static_assert(kPieces % (kBatch * 128) == 0, "whole batches");
#pragma unroll 1
  for (int k0 = (int)threadIdx.x; k0 < kPieces; k0 += kBatch * 128) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // piece (K or V, row, 4 columns from 4 c)
      const int k = k0 + j * 128, kv = k / (KT * (HD / 4)), row = k / (HD / 4) % KT, c = k % (HD / 4);
      x[j] = row < n ? *reinterpret_cast<const float4*>(st + kv * S32::kKvBytes + (c >> 3) * KT * kBandBytes +
                                                         swz(row, c & 7))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = k0 + j * 128, kv = k / (KT * (HD / 4)), row = k / (HD / 4) % KT, c = k % (HD / 4);
      uint32_t p01[2], p23[2];  // columns 4c, 4c + 1 and 4c + 2, 4c + 3: [hi, lo] each
      split_terms<2>(x[j].x, x[j].y, p01);
      split_terms<2>(x[j].z, x[j].w, p23);
      uint8_t* d = conv + 2 * kv * kTerm + (c >> 4) * KT * kBandBytes + swz(row, (c & 15) >> 1) + 8 * (c & 1);
      *reinterpret_cast<uint2*>(d) = make_uint2(p01[0], p23[0]);
      *reinterpret_cast<uint2*>(d + kTerm) = make_uint2(p01[1], p23[1]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWinThreads)
paged_window_kernel(const __grid_constant__ Args a) {
  using L = WinSmem<T, HD>;
  using S = typename L::S;
  constexpr bool kI8 = S::kQuant, kF32 = L::kF32;
  constexpr int KT = S::kT;  // cache rows of a stage
  constexpr int W = kWinWarps, NT = W * 32, NST = L::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  Unit& unit = *reinterpret_cast<Unit*>(smem + L::kUnit);
  int& flag = *reinterpret_cast<int*>(smem + L::kFlag);
  uint8_t* base = smem + L::kHead;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;  // the swizzle's pattern repeats every 1024 bytes
  uint8_t* qt = base;
  uint8_t* conv = base + L::kConv;
  uint8_t* ring = base + L::kRing;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (a.R + kRowTile - 1) / kRowTile;
  if (tid == 0) stamp(a, 0);
  if (warp == 0) {
    Unit u;
    const bool ok = plan_unit(a, tiles, kWinMinSpan / kBox, blockIdx.x, u);
    if (lane == 0) {
      unit = u;
      flag = ok;
      for (int s = 0; s < NST; ++s) {
        mbar_init(bars + 8 * s, 1);
        mbar_init(bars + 8 * (kMaxStages + s), W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else if (warp == W && lane < 2) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(lane ? &a.vmap : &a.kmap)) : "memory");
  }
  __syncthreads();
  if (tid == 0) stamp(a, 1);
  if (!flag) return;
  const Unit u = unit;
  if (warp == W) {
    produce<T, HD, kMma, NST, KT>(a, u, ring, bars);
    return;
  }
  // The tile's q rows, scaled, as bf16 hi and lo (rows past R zero), 16 loads of 16 bytes in flight a
  // thread.
  const long bh = (long)u.b * a.n_kv + u.h;
  const int r0 = u.tile * kRowTile, rows = min(kRowTile, a.R - r0);
  auto q_row = [&](int r) {  // row r0 + r = (mul, s) of the tile's kv head
    const int mul = (r0 + r) / a.S, sq = (r0 + r) % a.S;
    return a.q + (((long)u.b * a.S + sq) * a.n_kv * a.kv_mul + (long)u.h * a.kv_mul + mul) * HD;
  };
  constexpr int kVecs = kRowTile * HD / 4 / NT;  // 16-byte pieces a thread
  static_assert(kVecs % 16 == 0, "q is staged 16 pieces at a time");
#pragma unroll
  for (int k0 = 0; k0 < kVecs; k0 += 16) {
    float4 x[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = (k0 + j) * NT + tid, r = k / (HD / 4);
      x[j] = r < rows ? __ldg(reinterpret_cast<const float4*>(q_row(r)) + k % (HD / 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int k = (k0 + j) * NT + tid, r = k / (HD / 4), c = k % (HD / 4) * 4;  // columns c .. c + 3
      uint32_t tm[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        split_terms<2>((h ? x[j].z : x[j].x) * a.scale, (h ? x[j].w : x[j].y) * a.scale, tm);
        *reinterpret_cast<uint32_t*>(qt + q_byte(r, c + 2 * h)) = tm[0];
        *reinterpret_cast<uint32_t*>(qt + L::kQTerm + q_byte(r, c + 2 * h)) = tm[1];
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // q is read by wgmma
  consumer_sync(NT);

  // This thread's rows of the tile: 16 w + g and 16 w + g + 8; n8 chunk j of S holds s[4 j + e], row
  // (e & 2 ? the second : the first), cache row 8 j + 2 t4 + (e & 1) of the stage; O alike, with
  // head_dim columns in place of cache rows.
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t q_base = smem_u32(qt);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int t = u.lo; t < u.hi;) {
    const int n = stage_rows<S::kT>(a, u, t);
    mbar_wait(bars + 8 * stage, phase);
    if (t == u.lo && tid == 0) stamp(a, 3);
    uint8_t* st = ring + stage * S::kStageBytes;
    if constexpr (kI8 || kF32) {  // the stage to bf16 (INT8: each warp its 16 rows); then it is free
      if constexpr (kI8) convert_rows<HD>(st, conv, warp, n);
      else convert_f32_rows<HD, KT>(st, conv, n);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + stage));
      consumer_sync(NT);
      st = conv;
    } else if (n < kRowTile) {
      zero_rows<HD>(st, n);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync(NT);
    }
    const uint32_t kbase = smem_u32(st);
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
    fence_acc(s);
    wg_fence();
    // q's lo and hi against K (bf16 and INT8 rows are exact); f32 rows: q lo . K hi, q hi . K lo,
    // q hi . K hi (q lo . K lo, below 2^-16 of the product, is left out).  The small terms first.
    constexpr int kProducts = kF32 ? 3 : 2;
#pragma unroll
    for (int pr = 0; pr < kProducts; ++pr) {
      const int qt_ = pr == 0 ? 1 : 0, kt_ = kF32 && pr == 1 ? 1 : 0;
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        wgmma_ss(s, desc_k(q_base + qt_ * L::kQTerm + (ks / 4) * (kRowTile * kBandBytes) + (ks % 4) * 32),
                 desc_k(kbase + kt_ * L::kTerm + (ks / 4) * (KT * kBandBytes) + (ks % 4) * 32), pr > 0 || ks > 0);
    }
    wg_commit();
    wg_wait0();
    fence_acc(s);
    // The online softmax (INT8: K's row scale on the score before the max, V's on the probability
    // after l takes it).
    const float* sc = reinterpret_cast<const float*>(st + 2 * L::B::kKvBytes);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int row = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float v = row < n ? (kI8 ? s[i] * sc[row] : s[i]) : -INFINITY;
      s[i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: the stage's row 0 is valid
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int row = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float pr = expf(s[i] - m[(i >> 1) & 1]);  // 0 at -inf
      lsum[(i >> 1) & 1] += pr;
      s[i] = kI8 ? (row < n ? pr * sc[kRowTile + row] : 0.f) : pr;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + lsum[h];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // O += P . V: P's hi and lo as wgmma's register operand, one k16 step (16 cache rows) at a time.
    uint32_t pa[2][KT / 16][4];  // [term][k16 step][fragment]
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t x[2];
        split_terms<2>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], x);
        pa[0][kk][r] = x[0];
        pa[1][kk][r] = x[1];
      }
    const uint32_t vbase = kbase + (kF32 ? 2 * L::kTerm : L::B::kKvBytes);
    fence_acc(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      if (16 * kk >= n) break;  // the rest of P is 0
      const uint64_t dv = desc_mn(vbase + kk * 16 * kBandBytes, KT * kBandBytes);
      wgmma_rs_mn(o, pa[1][kk], dv);
      if constexpr (kF32) wgmma_rs_mn(o, pa[0][kk], desc_mn(vbase + L::kTerm + kk * 16 * kBandBytes, KT * kBandBytes));
      wgmma_rs_mn(o, pa[0][kk], dv);
    }
    wg_commit();
    wg_wait0();
    fence_acc(o);
    if constexpr (kI8 || kF32) {
      consumer_sync(NT);  // the converted stage is rewritten by the next one
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (kMaxStages + stage));
    }
    if (++stage == NST) {
      stage = 0;
      phase ^= 1u;
    }
    t += n;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  consumer_sync(NT);
  if (tid == 0) stamp(a, 4);

  // The split's partial, straight from the accumulators (each row is one warp's), to the outputs when
  // the split is the only one, else to its workspace slot.
  const bool direct = u.n_s == 1;
  const long slot = u.slot + u.s;
  float* dst = direct ? a.out + (bh * a.R + r0) * HD : a.ws_acc + slot * kRowTile * HD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i)
      *reinterpret_cast<float2*>(dst + (long)r * HD + 8 * i + 2 * t4) = make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    if (t4 == 0) {
      if (direct) {
        a.out_m[bh * a.R + r0 + r] = m[h];
        a.out_l[bh * a.R + r0 + r] = l[h];
      } else {
        a.ws_ml[(slot * kRowTile + r) * 2] = m[h];
        a.ws_ml[(slot * kRowTile + r) * 2 + 1] = l[h];
      }
    }
  }
  if (direct) {
    if (a.stamps != nullptr) {
      consumer_sync(NT);
      if (tid == 0) stamp(a, 5);
    }
    return;
  }
  __threadfence();
  consumer_sync(NT);
  if (tid == 0) stamp(a, 5);
  if (tid == 0) {
    const int old = atomicAdd(a.counters + u.pair, 1);
    flag = old == u.n_s - 1;
    if (flag) a.counters[u.pair] = 0;  // left at zero for the next launch
  }
  consumer_sync(NT);
  if (tid == 0) stamp(a, 6);
  if (!flag) return;
  __threadfence();
  // The last block: the splits merged in split order with the reference's isfinite guards.  One
  // thread a row finds the largest m, writes m and l, and puts each split's weight exp(m_s - m) (0
  // where every m is -inf) in place of that split's m in the workspace, 8 splits' loads at once; then
  // the columns go as float4s, 4 items of a thread and 4 splits at once, each a sum of independent
  // loads.
  const int ns = u.n_s;
  if (tid < rows) {
    float* ml = a.ws_ml + (u.slot * kRowTile + tid) * 2;  // split s at ml + s * kRowTile * 2
    float mm = -INFINITY;
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = s0 + j < ns ? __ldcg(ml + (s0 + j) * kRowTile * 2) : -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mm = fmaxf(mm, x[j]);
    }
    const bool fin = isfinite(mm);
    float lv = 0.f;
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float2 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = s0 + j < ns ? __ldcg(reinterpret_cast<const float2*>(ml + (s0 + j) * kRowTile * 2)) : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s0 + j >= ns) break;
        const float c = fin ? expf(x[j].x - mm) : 0.f;
        ml[(s0 + j) * kRowTile * 2] = c;
        lv = fmaf(x[j].y, c, lv);
      }
    }
    a.out_m[bh * a.R + r0 + tid] = mm;
    a.out_l[bh * a.R + r0 + tid] = lv;
  }
  __threadfence_block();
  consumer_sync(NT);
  constexpr int IT = 4;
  const int items = rows * HD / 4;
  for (int k0 = tid; k0 < items; k0 += IT * NT) {
    float4 acc[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += 4) {
      float c[IT][4];
      float4 p4[IT][4];
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int k = min(k0 + i * NT, items - 1), r = k / (HD / 4), col = k % (HD / 4) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // a slot past the last split reloads it and weighs 0
          const long sl = (u.slot + min(s0 + j, ns - 1)) * kRowTile + r;
          c[i][j] = s0 + j < ns ? __ldcg(a.ws_ml + sl * 2) : 0.f;
          p4[i][j] = __ldcg(reinterpret_cast<const float4*>(a.ws_acc + sl * HD + col));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < IT; ++i)
          acc[i] = make_float4(fmaf(p4[i][j].x, c[i][j], acc[i].x), fmaf(p4[i][j].y, c[i][j], acc[i].y),
                               fmaf(p4[i][j].z, c[i][j], acc[i].z), fmaf(p4[i][j].w, c[i][j], acc[i].w));
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int k = k0 + i * NT;
      if (k >= items) break;
      *reinterpret_cast<float4*>(a.out + (bh * a.R + r0 + k / (HD / 4)) * HD + k % (HD / 4) * 4) = acc[i];
    }
  }
  if (a.stamps != nullptr) {
    consumer_sync(NT);
    if (tid == 0) stamp(a, 7);
  }
}

// ---------------------------------------------------------------- the window kernel past 256
// paged_window_wide_kernel: the window kernel at every head_dim past 256 (a multiple of 128), one
// instance a pool type.  One warpgroup's f32 O for a 64-row tile is hd / 2 registers a thread, so the
// output's columns are cut into slices of 256 (kWideCols; the last one 128 wide where 256 does not
// divide hd), one slice a block: the plan's tiles are the row tiles times the slices, and every split
// of a (request, kv head, row tile) is taken once a slice.  The block keeps the window kernel's shape,
// the producer warp and one consumer warpgroup, and computes the tile's scores once, over the whole
// head, by 64-column bands:
//  * q's terms do not fit in shared memory beside the ring past 256 (64 rows by hd in two bf16 terms
//    is 256 hd bytes), so the warpgroup writes them once, scaled and in wgmma's swizzled layout, to
//    the block's slot of a global scratch, and the producer copies each band's two terms (16 KB, one
//    bulk copy, from L2) into the ring slot that holds the K band of a stage (a TMA box of 16 rows by
//    64 columns; the maps of the wide kernel have 64-element boxes: 128-byte swizzle for bf16, none
//    for INT8 and f32 rows).  Measured and not kept: q resident in shared memory where the block
//    still fits (bf16 pools up to head_dim 512), 4-6% faster, a second instance of each kernel;
//  * S = Q . K^T band by band (m64n64k16, m64n32k16 over an f32 pool; q lo then q hi against K, an f32
//    pool's three terms), an INT8 or f32 band converted to bf16 (hi and lo) in its slot first, band
//    c's products issued while band c - 1's finish, each slot released once its products are done,
//    the ring as deep as the block's shared memory allows (6, 5 and 4 slots over bf16, INT8 and f32
//    pools; 4 slots and a wait after each band were 2-12% slower).  Measured and not kept: L2 cache
//    hints (q's copies kept, K and V evicted first), within 2%;
//  * then, as below 256, the online softmax in registers and O += P . V with P's terms as the
//    register operand (m64n256k16), V from a stage that holds the slice's 256 columns of the stage's
//    rows (an INT8 or f32 stage converted once into a bf16 stage, then released); the partial, the
//    workspace slots, the counters and the last block's merge are the window kernel's, each slice
//    its own columns.
// The scores of a tile are computed once a slice (2, 2 and 3 times at head_dim 384, 512 and 640):
// K is read once a slice, V once.  Past 256 the grid is two waves where one split a unit fills more
// than half a wave (window_grid): one wave held one split per (request, kv head, slice) at the 8B's
// heads, and the longest request's split was the launch (64 stages at position 4064).
constexpr int kWideCols = 256;                     // output columns of a block past 256
constexpr int kQTermBand = kRowTile * kBandBytes;  // one 64-column band of one q term: 8 KB

// Column slices of a window head: one up to 256, else ceil(hd / 256).
__host__ __device__ inline int win_slices(int hd) { return hd <= 256 ? 1 : (hd + kWideCols - 1) / kWideCols; }

// The layout of the kernel past 256 for a pool of T: the barriers, the unit and the split's flag in
// the first kHead bytes, then from the next 1024-byte boundary the ring (each slot: q's hi and lo
// band, the stage's raw K band, its bf16 term(s) for INT8 and f32), the V stages (the slice's raw
// columns, then INT8's K and V row scales) and the converted V stage (INT8 and f32).
template <typename T>
struct WideSmem {
  static constexpr int kEsz = Pool<T>::kEsz;
  static constexpr bool kF32 = kEsz == 4, kI8 = kEsz == 1;
  static constexpr int kT = win_rows<T>();                                   // cache rows of a stage
  static constexpr int kTerms = kF32 ? 2 : kI8 ? 1 : 0;                      // bf16 terms of a converted band
  static constexpr int kRowBytes = 64 * kEsz;                                // a raw row of a 64-column band
  static constexpr int kRawBand = kT * kRowBytes;
  static constexpr int kConvBand = kTerms * kT * kBandBytes;
  static constexpr int kSlot = 2 * kQTermBand + kRawBand + kConvBand;
  static constexpr int kSlots = kF32 ? 4 : kI8 ? 5 : 6;  // as many as fit: 230,656 / 212,224 / 214,272 bytes
  static constexpr int kRawV = kWideCols / 64 * kRawBand;
  static constexpr int kVStage = (kRawV + (kI8 ? 2 * kT * 4 : 0) + 1023) / 1024 * 1024;
  static constexpr int kVStages = 2;
  static constexpr int kConvV = kTerms * (kWideCols / 64) * kT * kBandBytes;
  static constexpr int kHead = 256;
  static constexpr int kUnit = 2 * (kSlots + kVStages) * 8 + 16, kFlag = kUnit + sizeof(Unit);
  static constexpr int kV = kSlots * kSlot, kCV = kV + kVStages * kVStage;
  static constexpr int kBytes = kHead + 1024 + kCV + kConvV;
  static_assert(kSlot % 1024 == 0 && kRawBand % 1024 == 0 && kFlag + 4 <= kHead, "the layout's alignment");
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
  // The mbarriers: a slot's full and empty, a V stage's full and empty.
  __device__ static uint32_t full(uint32_t bars, int i) { return bars + 8 * i; }
  __device__ static uint32_t empty(uint32_t bars, int i) { return bars + 8 * (kSlots + i); }
  __device__ static uint32_t vfull(uint32_t bars, int i) { return bars + 8 * (2 * kSlots + i); }
  __device__ static uint32_t vempty(uint32_t bars, int i) { return bars + 8 * (2 * kSlots + kVStages + i); }
};

// Rows of a raw INT8 or f32 band (kRowBytes a row, no swizzle) into bf16 term bands (f32: hi, and lo
// `term` bytes after it) in the swizzled layout wgmma reads; rows at or past n zero.  `boxes` 64-column
// boxes, the raw and converted boxes kT rows apart; the warpgroup's 128 threads.
template <typename T>
__device__ __forceinline__ void convert_band(const uint8_t* raw, uint8_t* conv, int n, int boxes, int term) {
  using L = WideSmem<T>;
  constexpr int KT = L::kT;
  const int tid = threadIdx.x;
  if constexpr (L::kI8) {
    for (int k = tid; k < boxes * KT * 4; k += 128) {  // (box, row, 16 codes)
      const int bx = k / (KT * 4), row = k / 4 % KT, c = k % 4;
      uint32_t xw[4] = {0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u};  // codes 0 after the flip
      if (row < n) {
        const uint4 x = *reinterpret_cast<const uint4*>(raw + bx * L::kRawBand + row * L::kRowBytes + 16 * c);
        xw[0] = x.x ^ 0x80808080u, xw[1] = x.y ^ 0x80808080u, xw[2] = x.z ^ 0x80808080u, xw[3] = x.w ^ 0x80808080u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)  // bf16 chunk 2 c + h: codes 8 h .. 8 h + 7
        *reinterpret_cast<uint4*>(conv + bx * KT * kBandBytes + swz(row, 2 * c + h)) =
            make_uint4(i8_pair<0, 1>(xw[2 * h]), i8_pair<2, 3>(xw[2 * h]), i8_pair<0, 1>(xw[2 * h + 1]),
                       i8_pair<2, 3>(xw[2 * h + 1]));
    }
  } else {
    for (int k = tid; k < boxes * KT * 16; k += 128) {  // (box, row, 4 columns from 4 c)
      const int bx = k / (KT * 16), row = k / 16 % KT, c = k % 16;
      const float4 x = row < n ? *reinterpret_cast<const float4*>(raw + bx * L::kRawBand + row * L::kRowBytes + 16 * c)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t p01[2], p23[2];
      split_terms<2>(x.x, x.y, p01);
      split_terms<2>(x.z, x.w, p23);
      uint8_t* d = conv + bx * KT * kBandBytes + swz(row, c >> 1) + 8 * (c & 1);
      *reinterpret_cast<uint2*>(d) = make_uint2(p01[0], p23[0]);
      *reinterpret_cast<uint2*>(d + term) = make_uint2(p01[1], p23[1]);
    }
  }
}

// The producer of the kernel past 256 (one thread): for each stage, each band's slot (q's two terms
// by one bulk copy from the block's scratch, the stage's K band by TMA boxes of 16 rows), then the V
// stage (the slice's boxes that lie inside the head; INT8: the K and V row scales).
template <typename T>
__device__ void produce_wide(const Args& a, const Unit& u, uint8_t* ring, uint8_t* vring, uint32_t bars,
                             const uint8_t* qs, int col0, int ncols) {
  using L = WideSmem<T>;
  const int nb = a.hd / 64;
  const int* tab = a.table != nullptr ? a.table + (long)u.b * a.max_pages : nullptr;
  int slot = 0, vs = 0;
  uint32_t ph = 0, vph = 0;
  for (int t = u.lo; t < u.hi;) {
    const int n = stage_rows<L::kT>(a, u, t), r0 = t % a.page;
    const int slab = (tab != nullptr ? __ldg(tab + t / a.page) : u.b) * a.n_kv + u.h;
    const int nbox = (n + kBox - 1) / kBox;
    const uint32_t box_bytes = kBox * L::kRowBytes;
    for (int c = 0; c < nb; ++c) {
      mbar_wait(L::empty(bars, slot), ph ^ 1u);
      const uint32_t full = L::full(bars, slot), dst = smem_u32(ring + slot * L::kSlot);
      mbar_expect_tx(full, 2 * kQTermBand + nbox * box_bytes);
      bulk_copy(dst, qs + (long)c * 2 * kQTermBand, 2 * kQTermBand, full);
      for (int j = 0; j < nbox; ++j)
        tma_box(dst + 2 * kQTermBand + j * box_bytes, &a.kmap, full, c * 64, r0 + j * kBox, slab);
      if (++slot == L::kSlots) slot = 0, ph ^= 1u;
    }
    mbar_wait(L::vempty(bars, vs), vph ^ 1u);
    const uint32_t vfull = L::vfull(bars, vs), vdst = smem_u32(vring + vs * L::kVStage);
    const int boxes = ncols / 64, srows = (n + 3) & ~3;
    mbar_expect_tx(vfull, boxes * nbox * box_bytes + (L::kI8 ? 2 * srows * 4 : 0));
    for (int cb = 0; cb < boxes; ++cb)
      for (int j = 0; j < nbox; ++j)
        tma_box(vdst + cb * L::kRawBand + j * box_bytes, &a.vmap, vfull, col0 + cb * 64, r0 + j * kBox, slab);
    if constexpr (L::kI8) {
      bulk_copy(vdst + L::kRawV, a.ks + ((long)slab * a.page + r0), srows * 4, vfull);
      bulk_copy(vdst + L::kRawV + L::kT * 4, a.vs + ((long)slab * a.page + r0), srows * 4, vfull);
    }
    if (t == u.lo) stamp(a, 2);
    if (++vs == L::kVStages) vs = 0, vph ^= 1u;
    t += n;
  }
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads)
paged_window_wide_kernel(const __grid_constant__ Args a) {
  using L = WideSmem<T>;
  constexpr bool kI8 = L::kI8, kF32 = L::kF32;
  constexpr int KT = L::kT, W = kWinWarps, NT = W * 32;
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  Unit& unit = *reinterpret_cast<Unit*>(smem + L::kUnit);
  int& flag = *reinterpret_cast<int*>(smem + L::kFlag);
  uint8_t* base = smem + L::kHead;
  base += (1024 - (smem_u32(base) & 1023)) & 1023;  // the swizzle's pattern repeats every 1024 bytes
  uint8_t* ring = base;
  uint8_t* vring = base + L::kV;
  uint8_t* convv = base + L::kCV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = a.hd, nb = hd / 64, slices = win_slices(hd);
  const int tiles = (a.R + kRowTile - 1) / kRowTile * slices;
  if (tid == 0) stamp(a, 0);
  if (warp == 0) {
    Unit u;
    const bool ok = plan_unit(a, tiles, kWinMinSpan / kBox, blockIdx.x, u);
    if (lane == 0) {
      unit = u;
      flag = ok;
      for (int i = 0; i < L::kSlots; ++i) {
        mbar_init(L::full(bars, i), 1);
        mbar_init(L::empty(bars, i), W);
      }
      for (int i = 0; i < L::kVStages; ++i) {
        mbar_init(L::vfull(bars, i), 1);
        mbar_init(L::vempty(bars, i), W);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  } else if (warp == W && lane < 2) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(lane ? &a.vmap : &a.kmap)) : "memory");
  }
  __syncthreads();
  if (tid == 0) stamp(a, 1);
  if (!flag) return;
  const Unit u = unit;
  const int rt = u.tile / slices, sl = u.tile % slices;
  const int col0 = sl * kWideCols, ncols = min(kWideCols, hd - col0);
  const long bh = (long)u.b * a.n_kv + u.h;
  const int r0 = rt * kRowTile, rows = min(kRowTile, a.R - r0);
  uint8_t* qs = a.ws_q + (long)blockIdx.x * kRowTile * hd * 4;  // this block's q terms

  // The tile's q rows, scaled, as bf16 hi and lo (rows past R zero) into the scratch, 16 loads of 16
  // bytes in flight a thread; then ordered before the producer's bulk copies read them.
  if (warp < W) {
    auto q_row = [&](int r) {  // row r0 + r = (mul, s) of the tile's kv head
      const int mul = (r0 + r) / a.S, sq = (r0 + r) % a.S;
      return a.q + (((long)u.b * a.S + sq) * a.n_kv * a.kv_mul + (long)u.h * a.kv_mul + mul) * hd;
    };
    const int vecs = kRowTile * hd / 4;  // 16-byte pieces of the tile: a multiple of 16 * NT
    for (int k0 = tid; k0 < vecs; k0 += 16 * NT) {
      float4 x[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j * NT, r = k / (hd / 4);
        x[j] = r < rows ? __ldg(reinterpret_cast<const float4*>(q_row(r)) + k % (hd / 4)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int k = k0 + j * NT, r = k / (hd / 4), c = k % (hd / 4) * 4;  // columns c .. c + 3
        uint32_t p01[2], p23[2];
        split_terms<2>(x[j].x * a.scale, x[j].y * a.scale, p01);
        split_terms<2>(x[j].z * a.scale, x[j].w * a.scale, p23);
        uint8_t* d = qs + (long)(c >> 6) * 2 * kQTermBand + swz(r, (c & 63) >> 3) + (c & 7) * 2;
        *reinterpret_cast<uint2*>(d) = make_uint2(p01[0], p23[0]);
        *reinterpret_cast<uint2*>(d + kQTermBand) = make_uint2(p01[1], p23[1]);
      }
    }
    __threadfence();
    asm volatile("fence.proxy.async.global;\n" ::: "memory");  // read next by the bulk copies
  }
  asm volatile("bar.sync 2, %0;\n" ::"r"(kWinThreads) : "memory");
  if (warp == W) {
    if (lane == 0) produce_wide<T>(a, u, ring, vring, bars, qs, col0, ncols);
    return;
  }

  // This thread's rows of the tile: 16 w + g and 16 w + g + 8 (S's and O's fragments as below 256).
  const int g = lane >> 2, t4 = lane & 3;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, o[kWideCols / 2];
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) o[i] = 0.f;
  int slot = 0, vs = 0;
  uint32_t ph = 0, vph = 0;
  // Stamp 3 (below 256: the first stage landed) here: the warpgroup starts its stages.  Taken inside
  // the loop, the stamp's branch drew C7520 (wgmma serialized); so did the P.V loop's early exit.
  if (tid == 0) stamp(a, 3);
  for (int t = u.lo; t < u.hi;) {
    const int n = stage_rows<KT>(a, u, t);
    float s[KT / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;
    fence_acc(s);
    int prev = 0;
    for (int c = 0; c < nb; ++c) {  // S over the head's bands, band c's products issued while c - 1's finish
      mbar_wait(L::full(bars, slot), ph);
      uint8_t* st = ring + slot * L::kSlot;
      uint8_t* kb = st + 2 * kQTermBand;
      if constexpr (kI8 || kF32) {
        convert_band<T>(kb, kb + L::kRawBand, n, 1, KT * kBandBytes);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        consumer_sync(NT);
        kb += L::kRawBand;
      }
      const uint32_t qa = smem_u32(st), ka = smem_u32(kb);
      wg_fence();
      // q's lo and hi against K (bf16 and INT8 rows are exact); f32 rows: q lo . K hi, q hi . K lo,
      // q hi . K hi.  The small terms first.
      constexpr int kProducts = kF32 ? 3 : 2;
#pragma unroll
      for (int pr = 0; pr < kProducts; ++pr) {
        const int qt_ = pr == 0 ? 1 : 0, kt_ = kF32 && pr == 1 ? 1 : 0;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
          wgmma_ss(s, desc_k(qa + qt_ * kQTermBand + ks * 32), desc_k(ka + kt_ * KT * kBandBytes + ks * 32), 1);
      }
      wg_commit();
      wg_wait1();
      if (c > 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(L::empty(bars, prev));
      }
      prev = slot;
      if (++slot == L::kSlots) slot = 0, ph ^= 1u;
    }
    wg_wait0();
    fence_acc(s);
    __syncwarp();
    if (lane == 0) mbar_arrive(L::empty(bars, prev));
    mbar_wait(L::vfull(bars, vs), vph);
    uint8_t* vst = vring + vs * L::kVStage;
    // The online softmax (INT8: K's row scale on the score before the max, V's on the probability
    // after l takes it).
    const float* sc = reinterpret_cast<const float*>(vst + L::kRawV);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int row = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float v = row < n ? (kI8 ? s[i] * sc[row] : s[i]) : -INFINITY;
      s[i] = v;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], v);
    }
    float corr[2], lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);  // finite: the stage's row 0 is valid
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) {
      const int row = 8 * (i >> 2) + 2 * t4 + (i & 1);
      const float pr = expf(s[i] - m[(i >> 1) & 1]);  // 0 at -inf
      lsum[(i >> 1) & 1] += pr;
      s[i] = kI8 ? (row < n ? pr * sc[KT + row] : 0.f) : pr;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + lsum[h];
#pragma unroll
    for (int i = 0; i < kWideCols / 8; ++i) {
      o[4 * i] *= corr[0];
      o[4 * i + 1] *= corr[0];
      o[4 * i + 2] *= corr[1];
      o[4 * i + 3] *= corr[1];
    }
    // The stage's V: an INT8 or f32 stage converted to bf16 (hi and lo) and released; a bf16 stage's
    // rows at or past n zeroed (they may hold anything, NaN included, and wgmma multiplies them by 0).
    constexpr int kVTerm = kWideCols / 64 * KT * kBandBytes;  // an f32 stage's lo term
    uint8_t* vb = vst;
    if constexpr (kI8 || kF32) {
      convert_band<T>(vst, convv, n, ncols / 64, kVTerm);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync(NT);
      __syncwarp();
      if (lane == 0) mbar_arrive(L::vempty(bars, vs));
      vb = convv;
    } else if (n < KT) {
      for (int k = tid; k < (KT - n) * (ncols / 8); k += NT) {  // (row, 16-byte chunk of the slice)
        const int row = n + k / (ncols / 8), c = k % (ncols / 8);
        *reinterpret_cast<uint4*>(vst + (c >> 3) * L::kRawBand + row * kBandBytes + ((c & 7) << 4)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync(NT);
    }
    // O += P . V: P's hi and lo as wgmma's register operand, one k16 step (16 cache rows) at a time.
    uint32_t pa[2][KT / 16][4];  // [term][k16 step][fragment]
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        uint32_t x[2];
        split_terms<2>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], x);
        pa[0][kk][r] = x[0];
        pa[1][kk][r] = x[1];
      }
    const uint32_t vbase = smem_u32(vb);
    fence_acc(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {  // P is 0 on rows at or past n, and their V rows are zero
      const uint64_t dv = desc_mn(vbase + kk * 16 * kBandBytes, KT * kBandBytes);
      wgmma_rs_mn(o, pa[1][kk], dv);
      if constexpr (kF32) wgmma_rs_mn(o, pa[0][kk], desc_mn(vbase + kVTerm + kk * 16 * kBandBytes, KT * kBandBytes));
      wgmma_rs_mn(o, pa[0][kk], dv);
    }
    wg_commit();
    wg_wait0();
    fence_acc(o);
    if constexpr (kI8 || kF32) {
      consumer_sync(NT);  // the converted stage is rewritten by the next one
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(L::vempty(bars, vs));
    }
    if (++vs == L::kVStages) vs = 0, vph ^= 1u;
    t += n;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  consumer_sync(NT);
  if (tid == 0) stamp(a, 4);

  // The split's partial of the slice's columns, straight from the accumulators, to the outputs when
  // the split is the only one, else to its workspace slot; m and l by slice 0 only (every slice has
  // the same ones).
  const bool direct = u.n_s == 1;
  const long slot_ = u.slot + u.s;
  float* dst = (direct ? a.out + (bh * a.R + r0) * hd : a.ws_acc + slot_ * kRowTile * hd) + col0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < kWideCols / 8; ++i)
      if (8 * i < ncols)
        *reinterpret_cast<float2*>(dst + (long)r * hd + 8 * i + 2 * t4) = make_float2(o[4 * i + 2 * h], o[4 * i + 2 * h + 1]);
    if (t4 == 0) {
      if (!direct) {
        a.ws_ml[(slot_ * kRowTile + r) * 2] = m[h];
        a.ws_ml[(slot_ * kRowTile + r) * 2 + 1] = l[h];
      } else if (sl == 0) {
        a.out_m[bh * a.R + r0 + r] = m[h];
        a.out_l[bh * a.R + r0 + r] = l[h];
      }
    }
  }
  if (direct) {
    if (a.stamps != nullptr) {
      consumer_sync(NT);
      if (tid == 0) stamp(a, 5);
    }
    return;
  }
  __threadfence();
  consumer_sync(NT);
  if (tid == 0) stamp(a, 5);
  if (tid == 0) {
    const int old = atomicAdd(a.counters + u.pair, 1);
    flag = old == u.n_s - 1;
    if (flag) a.counters[u.pair] = 0;  // left at zero for the next launch
  }
  consumer_sync(NT);
  if (tid == 0) stamp(a, 6);
  if (!flag) return;
  __threadfence();
  // The last block of the slice: the window kernel's merge (split order, the reference's isfinite
  // guards) over the slice's columns.
  const int ns = u.n_s;
  if (tid < rows) {
    float* ml = a.ws_ml + (u.slot * kRowTile + tid) * 2;  // split s at ml + s * kRowTile * 2
    float mm = -INFINITY;
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = s0 + j < ns ? __ldcg(ml + (s0 + j) * kRowTile * 2) : -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) mm = fmaxf(mm, x[j]);
    }
    const bool fin = isfinite(mm);
    float lv = 0.f;
    for (int s0 = 0; s0 < ns; s0 += 8) {
      float2 x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = s0 + j < ns ? __ldcg(reinterpret_cast<const float2*>(ml + (s0 + j) * kRowTile * 2)) : make_float2(0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (s0 + j >= ns) break;
        const float c = fin ? expf(x[j].x - mm) : 0.f;
        ml[(s0 + j) * kRowTile * 2] = c;
        lv = fmaf(x[j].y, c, lv);
      }
    }
    if (sl == 0) {
      a.out_m[bh * a.R + r0 + tid] = mm;
      a.out_l[bh * a.R + r0 + tid] = lv;
    }
  }
  __threadfence_block();
  consumer_sync(NT);
  constexpr int IT = 4;
  const int items = rows * ncols / 4;
  for (int k0 = tid; k0 < items; k0 += IT * NT) {
    float4 acc[IT];
#pragma unroll
    for (int i = 0; i < IT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < ns; s0 += 4) {
      float c[IT][4];
      float4 p4[IT][4];
#pragma unroll
      for (int i = 0; i < IT; ++i) {
        const int k = min(k0 + i * NT, items - 1), r = k / (ncols / 4), col = col0 + k % (ncols / 4) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // a slot past the last split reloads it and weighs 0
          const long sl_ = (u.slot + min(s0 + j, ns - 1)) * kRowTile + r;
          c[i][j] = s0 + j < ns ? __ldcg(a.ws_ml + sl_ * 2) : 0.f;
          p4[i][j] = __ldcg(reinterpret_cast<const float4*>(a.ws_acc + sl_ * hd + col));
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < IT; ++i)
          acc[i] = make_float4(fmaf(p4[i][j].x, c[i][j], acc[i].x), fmaf(p4[i][j].y, c[i][j], acc[i].y),
                               fmaf(p4[i][j].z, c[i][j], acc[i].z), fmaf(p4[i][j].w, c[i][j], acc[i].w));
    }
#pragma unroll
    for (int i = 0; i < IT; ++i) {
      const int k = k0 + i * NT;
      if (k >= items) break;
      *reinterpret_cast<float4*>(a.out + (bh * a.R + r0 + k / (ncols / 4)) * hd + col0 + k % (ncols / 4) * 4) = acc[i];
    }
  }
  if (a.stamps != nullptr) {
    consumer_sync(NT);
    if (tid == 0) stamp(a, 7);
  }
}

// Each block's unit as paged_decode_kernel's blocks plan it, one warp a block: units [grid, 10] int
// (planned, b, h, tile, s, n_s, lo, hi, slot, pair; only `planned`, 0, past the last unit).
__global__ void __launch_bounds__(32) plan_kernel(const __grid_constant__ Args a, int min_boxes, int* units) {
  Unit u;
  const bool ok = plan_unit(a, a.kv_mul / a.qm, min_boxes, blockIdx.x, u);
  if (threadIdx.x == 0) {
    int* o = units + blockIdx.x * 10;
    o[0] = ok;
    if (ok) {
      o[1] = u.b; o[2] = u.h; o[3] = u.tile; o[4] = u.s; o[5] = u.n_s;
      o[6] = u.lo; o[7] = u.hi; o[8] = u.slot; o[9] = u.pair;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point query (no link
// against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of one layer's pool as [P * n_kv, page, hd]: boxes of 16 rows by one 128-byte band,
// 128-byte swizzle.  Returns 0, or the negated CUresult minus one.
template <typename T>
int pool_map(CUtensorMap* map, const void* pool, int slabs, int page, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  constexpr int esz = Pool<T>::kEsz;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)page, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * esz, (cuuint64_t)page * hd * esz};
  const cuuint32_t box[3] = {(cuuint32_t)(kBandBytes / esz), (cuuint32_t)kBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, Pool<T>::kMap, 3, const_cast<void*>(pool), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

// The map of the kernel past 256: boxes of 16 rows by 64 elements, with the 128-byte swizzle for bf16
// (wgmma reads the box as it lands) and none for INT8 and f32 rows (converted first).
template <typename T>
int pool_map_wide(CUtensorMap* map, const void* pool, int slabs, int page, int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  constexpr int esz = Pool<T>::kEsz;
  const cuuint64_t dims[3] = {(cuuint64_t)hd, (cuuint64_t)page, (cuuint64_t)slabs};
  const cuuint64_t strides[2] = {(cuuint64_t)hd * esz, (cuuint64_t)page * hd * esz};
  const cuuint32_t box[3] = {64, (cuuint32_t)kBox, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, Pool<T>::kMap, 3, const_cast<void*>(pool), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, esz == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

template <typename T, int HD, int R, int QM, int NT = 2>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&paged_decode_kernel<T, HD, R, QM, NT>);
}

// The instance for (pool type, head_dim, head tile, terms), its shared memory and threads, or null:
// f32 pools on the CUDA cores at 1, 2, 4 or 8 heads a block, bf16 and INT8 pools on mma.sync (the
// heads padded to 8) with NT terms of q and P.
template <typename T, int HD, int NT>
const void* pick_qm(int qm, int* smem, int* threads) {
  constexpr int R = route_of<T>();
  *threads = Shape<T, HD, R>::kThreads;
  if constexpr (R == kMma) {
    *smem = Smem<T, HD, R, kHeadsMma>::kBytes;
    return qm <= kHeadsMma ? kernel_of<T, HD, R, kHeadsMma, NT>() : nullptr;
  } else {
    switch (qm) {
      case 1: *smem = Smem<T, HD, R, 1>::kBytes; return kernel_of<T, HD, R, 1>();
      case 2: *smem = Smem<T, HD, R, 2>::kBytes; return kernel_of<T, HD, R, 2>();
      case 4: *smem = Smem<T, HD, R, 4>::kBytes; return kernel_of<T, HD, R, 4>();
      case 8: *smem = Smem<T, HD, R, 8>::kBytes; return kernel_of<T, HD, R, 8>();
      default: return nullptr;
    }
  }
}

// The kernel past 256 at head_dim hd (a multiple of 128 up to kMaxWideHeadDim), any head tile up to 8.
template <typename T, int NT>
const void* pick_wide(int hd, int qm, int* smem, int* threads) {
  if (hd <= 256 || hd % kWarpCols || hd > kMaxWideHeadDim || qm < 1 || qm > kHeadsMma) return nullptr;
  const DecWide L = dec_wide<T>(hd);
  *smem = L.bytes;
  *threads = (L.warps + 1) * 32;
  return reinterpret_cast<const void*>(&paged_decode_wide_kernel<T, NT>);
}

template <typename T, int NT = 2>
const void* pick_hd(int hd, int qm, int* smem, int* threads) {
  switch (hd) {
    case 128: return pick_qm<T, 128, NT>(qm, smem, threads);
    case 256: return pick_qm<T, 256, NT>(qm, smem, threads);
    default: return pick_wide<T, NT>(hd, qm, smem, threads);
  }
}

const void* pick(int cache_type, int hd, int qm, int* smem, int* threads) {
  switch (cache_type) {
    case 0: return pick_hd<float>(hd, qm, smem, threads);
    case 1: return pick_hd<__nv_bfloat16>(hd, qm, smem, threads);
    case 2: return pick_hd<int8_t>(hd, qm, smem, threads);
    case kExactInt8: return pick_hd<int8_t, 3>(hd, qm, smem, threads);
    default: return nullptr;
  }
}

// Lets the instance use `smem` bytes of dynamic shared memory (once per instance).
int allow_smem(const void* fn, int smem) {
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// The window kernel's instance for (pool type, head_dim), its shared memory and threads, or null: f32,
// bf16 and INT8 pools at head_dim 128 and 256, and past 256 (a multiple of 128) the wide kernel.
template <typename T>
const void* pick_window_hd(int hd, int* smem, int* threads) {
  *threads = kWinThreads;
  switch (hd) {
    case 128: *smem = WinSmem<T, 128>::kBytes; return reinterpret_cast<const void*>(&paged_window_kernel<T, 128>);
    case 256: *smem = WinSmem<T, 256>::kBytes; return reinterpret_cast<const void*>(&paged_window_kernel<T, 256>);
    default:
      if (hd < 384 || hd % 128) return nullptr;
      *smem = WideSmem<T>::kBytes;
      return reinterpret_cast<const void*>(&paged_window_wide_kernel<T>);
  }
}

const void* pick_window(int cache_type, int hd, int* smem, int* threads) {
  switch (cache_type) {
    case 0: return pick_window_hd<float>(hd, smem, threads);
    case 1: return pick_window_hd<__nv_bfloat16>(hd, smem, threads);
    case 2: return pick_window_hd<int8_t>(hd, smem, threads);
    default: return nullptr;
  }
}

// The K and V maps of one layer's pool, and the pointers and sizes both kernels share.  Returns 0, or
// the negated CUresult minus one.
int pool_args(Args& a, int cache_type, const void* k, const void* v, const void* ks, const void* vs,
              const void* table, const void* pos, int B, int n_kv, int n_pages, int page, int max_pages, int hd) {
  int e = 0;
  for (int i = 0; i < 2 && e == 0; ++i) {
    CUtensorMap* map = i ? &a.vmap : &a.kmap;
    const void* pool = i ? v : k;
    switch (cache_type) {
      case 0: e = pool_map<float>(map, pool, n_pages * n_kv, page, hd); break;
      case 1: e = pool_map<__nv_bfloat16>(map, pool, n_pages * n_kv, page, hd); break;
      default: e = pool_map<int8_t>(map, pool, n_pages * n_kv, page, hd); break;
    }
  }
  a.ks = reinterpret_cast<const float*>(ks);
  a.vs = reinterpret_cast<const float*>(vs);
  a.table = reinterpret_cast<const int*>(table);
  a.pos = reinterpret_cast<const int*>(pos);
  a.B = B;
  a.n_kv = n_kv;
  a.page = page;
  a.max_pages = max_pages;
  return e;
}

int launch(const void* fn, int grid, int threads, int smem, Args& a, void* stream) {
  const int e = allow_smem(fn, smem);
  if (e) return e;
  void* args[] = {&a};
  const cudaError_t le = cudaLaunchKernel(fn, dim3(grid), dim3(threads), args, (size_t)smem,
                                          reinterpret_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points.  cache_type 0 = f32, 1 = bf16, 2 = int8, 3 = int8 on three terms (#4's dense
// layer); qm: query heads a block takes, dividing kv_mul (1, 2, 4 or 8 at head_dim 128/256 over f32;
// up to 8 elsewhere); hd: 128, 256, or a multiple of 128 up to 1024 (the kernel past 256).

// Blocks of the instance one SM holds at once (0 for an instance that does not exist).
extern "C" int paged_decode_blocks_per_sm(int cache_type, int hd, int qm) {
  int smem = 0, threads = 0, blocks = 0;
  const void* fn = pick(cache_type, hd, qm, &smem, &threads);
  if (fn == nullptr || allow_smem(fn, smem) != 0) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem) != cudaSuccess) return 0;
  return blocks;
}

// One launch of `grid` blocks (at least B * n_kv * kv_mul / qm).  q [B, n_kv * kv_mul, hd] f32
// (unscaled), k_new/v_new [B, n_kv, hd] f32, k/v the layer's pool [P, n_kv, page, hd] with
// ks/vs [P, n_kv, page] f32 (int8) or null, table [B, max_pages] int32 (or null: page b is request
// b's, max_pages 1) and pos [B] int32; ws_ml
// [grid, qm, 2] and ws_acc [grid, qm, hd] f32 scratch; counters [B * n_kv * kv_mul / qm] int32,
// zero (left zero); out like q; stamps [grid, 8] int64 or null.  page must be a multiple of 16.  Returns a cudaError_t, or a
// tensor map's negated CUresult minus one.
extern "C" int paged_decode_split(const void* q, const void* k_new, const void* v_new, const void* k,
                                  const void* v, const void* ks, const void* vs, const void* table,
                                  const void* pos, int cache_type, int B, int n_kv, int kv_mul,
                                  int qm, int n_pages, int page, int max_pages, int hd, float scale,
                                  int grid, void* ws_ml, void* ws_acc, void* counters, void* out,
                                  void* stamps, void* stream) {
  int smem = 0, threads = 0;
  const void* fn = pick(cache_type, hd, qm, &smem, &threads);
  if (fn == nullptr || B < 1 || kv_mul % qm || page % kBox || grid < B * n_kv * (kv_mul / qm))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  const int e = pool_args(a, cache_type, k, v, ks, vs, table, pos, B, n_kv, n_pages, page, max_pages, hd);
  if (e) return e;
  a.q = reinterpret_cast<const float*>(q);
  a.k_new = reinterpret_cast<const float*>(k_new);
  a.v_new = reinterpret_cast<const float*>(v_new);
  a.ws_ml = reinterpret_cast<float*>(ws_ml);
  a.ws_acc = reinterpret_cast<float*>(ws_acc);
  a.counters = reinterpret_cast<int*>(counters);
  a.out = reinterpret_cast<float*>(out);
  a.stamps = reinterpret_cast<unsigned long long*>(stamps);
  a.kv_mul = kv_mul;
  a.qm = qm;
  a.hd = hd;
  a.scale = scale;
  return launch(fn, grid, threads, smem, a, stream);
}

// Blocks of the window kernel's instance one SM holds at once (0 for an instance that does not exist).
extern "C" int paged_window_blocks_per_sm(int cache_type, int hd) {
  int smem = 0, threads = 0, blocks = 0;
  const void* fn = pick_window(cache_type, hd, &smem, &threads);
  if (fn == nullptr || allow_smem(fn, smem) != 0) return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem) != cudaSuccess) return 0;
  return blocks;
}

// One launch of the window kernel over `grid` blocks (at least B * n_kv * ceil(R / 64) * slices, slices
// = ceil(hd / 256) past 256, else 1).  q [B, S, n_kv * kv_mul, hd] f32 (unscaled, R = S * kv_mul <= 128), the pool and table as paged_decode_split's (cache_type 0 = f32,
// 1 = bf16, 2 = int8); ws_ml [grid, 64, 2] and ws_acc [grid, 64, hd] f32 scratch, ws_q [grid, 64 * hd * 4]
// bytes of scratch past 256 (else unused); counters [B * n_kv * ceil(R / 64) * slices] int32, zero (left
// zero); out_m, out_l [B, n_kv, R] and out_acc [B, n_kv, R, hd] f32;
// stamps [grid, 8] int64 or null (the decode kernel's phases).  Returns a cudaError_t, or a tensor map's negated CUresult minus one.
extern "C" int paged_window_split(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                                  const void* table, const void* pos, int cache_type, int B, int n_kv, int S,
                                  int kv_mul, int n_pages, int page, int max_pages, int hd, float scale, int grid,
                                  void* ws_ml, void* ws_acc, void* ws_q, void* counters, void* out_m, void* out_l,
                                  void* out_acc, void* stamps, void* stream) {
  int smem = 0, threads = 0;
  const void* fn = pick_window(cache_type, hd, &smem, &threads);
  const int R = S * kv_mul;
  if (fn == nullptr || B < 1 || S < 1 || kv_mul < 1 || R > 2 * kRowTile || page % kBox ||
      grid < B * n_kv * ((R + kRowTile - 1) / kRowTile) * win_slices(hd) ||
      (hd > 256 && ws_q == nullptr))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  int e = pool_args(a, cache_type, k, v, ks, vs, table, pos, B, n_kv, n_pages, page, max_pages, hd);
  for (int i = 0; i < 2 && e == 0 && hd > 256; ++i) {  // the wide kernel's maps in their place
    CUtensorMap* map = i ? &a.vmap : &a.kmap;
    const void* pool = i ? v : k;
    switch (cache_type) {
      case 0: e = pool_map_wide<float>(map, pool, n_pages * n_kv, page, hd); break;
      case 1: e = pool_map_wide<__nv_bfloat16>(map, pool, n_pages * n_kv, page, hd); break;
      default: e = pool_map_wide<int8_t>(map, pool, n_pages * n_kv, page, hd); break;
    }
  }
  if (e) return e;
  a.hd = hd;
  a.ws_q = reinterpret_cast<uint8_t*>(ws_q);
  a.q = reinterpret_cast<const float*>(q);
  a.ws_ml = reinterpret_cast<float*>(ws_ml);
  a.ws_acc = reinterpret_cast<float*>(ws_acc);
  a.counters = reinterpret_cast<int*>(counters);
  a.out = reinterpret_cast<float*>(out_acc);
  a.out_m = reinterpret_cast<float*>(out_m);
  a.out_l = reinterpret_cast<float*>(out_l);
  a.stamps = reinterpret_cast<unsigned long long*>(stamps);
  a.R = R;
  a.S = S;
  a.kv_mul = kv_mul;
  a.scale = scale;
  return launch(fn, grid, threads, smem, a, stream);
}

// The plan of a launch of `grid` blocks, as its blocks make it (plan_kernel): pos [B] int32 and
// units [grid, 10] int32 device pointers.  Returns a cudaError_t.  (A window
// launch's plan: min_boxes kWinMinSpan / kBox, the decode's: 1.)
static int plan(const void* pos, int B, int n_kv, int kv_mul, int qm, int page, int max_pages, int grid,
                int min_boxes, void* units, void* stream) {
  if (B < 1 || qm < 1 || kv_mul % qm || grid < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.pos = reinterpret_cast<const int*>(pos);
  a.B = B;
  a.n_kv = n_kv;
  a.kv_mul = kv_mul;
  a.qm = qm;
  a.page = page;
  a.max_pages = max_pages;
  plan_kernel<<<grid, 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(a, min_boxes, reinterpret_cast<int*>(units));
  return (int)cudaGetLastError();
}

extern "C" int paged_decode_plan(const void* pos, int B, int n_kv, int kv_mul, int qm, int page, int max_pages,
                                 int grid, void* units, void* stream) {
  return plan(pos, B, n_kv, kv_mul, qm, page, max_pages, grid, 1, units, stream);
}

// The window kernel's plan of a launch of `grid` blocks for R rows a kv head at head_dim hd: the decode
// plan with the row tiles (ceil(R / 64)) times the column slices (win_slices) in place of head tiles
// and splits of at least kWinMinSpan rows, made by the same device function.
extern "C" int paged_window_plan(const void* pos, int B, int n_kv, int R, int hd, int page, int max_pages,
                                 int grid, void* units, void* stream) {
  if (R < 1 || hd < 128 || hd % 128) return (int)cudaErrorInvalidValue;
  return plan(pos, B, n_kv, (R + kRowTile - 1) / kRowTile * win_slices(hd), 1, page, max_pages, grid,
              kWinMinSpan / kBox, units, stream);
}

// The layout of the window kernel past 256 for a pool type (0 = f32, 1 = bf16, 2 = int8) into out[6]:
// cache rows a stage, ring slots, a slot's bytes, V stages, a V stage's bytes, the block's shared
// memory bytes.  Returns 0, or cudaErrorInvalidValue.
template <typename T>
void wide_layout(int* out) {
  using L = WideSmem<T>;
  const int v[6] = {L::kT, L::kSlots, L::kSlot, L::kVStages, L::kVStage, L::kBytes};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

extern "C" int paged_window_wide_layout(int cache_type, int* out) {
  switch (cache_type) {
    case 0: wide_layout<float>(out); return 0;
    case 1: wide_layout<__nv_bfloat16>(out); return 0;
    case 2: wide_layout<int8_t>(out); return 0;
    default: return (int)cudaErrorInvalidValue;
  }
}

// The layout of the decode kernel past 256 for a cache type (0 = f32, 1 = bf16, 2 and 3 = int8) at
// head_dim hd into out[5]: cache rows a stage, consumer warps, ring slots, a slot's bytes, the block's
// shared memory bytes.  Returns 0, or cudaErrorInvalidValue.
extern "C" int paged_decode_wide_layout(int cache_type, int hd, int* out) {
  if (hd <= 256 || hd % kWarpCols || hd > kMaxWideHeadDim) return (int)cudaErrorInvalidValue;
  DecWide d;
  switch (cache_type) {
    case 0: d = dec_wide<float>(hd); break;
    case 1: d = dec_wide<__nv_bfloat16>(hd); break;
    case 2:
    case kExactInt8: d = dec_wide<int8_t>(hd); break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int v[5] = {kWideRows, d.warps, d.slots, d.slot, d.bytes};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}
