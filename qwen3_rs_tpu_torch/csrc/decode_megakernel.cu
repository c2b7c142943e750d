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
// activation to bf16 at the dot, takes each weight as bf16(bf16(code) * bf16(scale)) (INT4:
// bf16(code * bf16(scale))) and sums in f32; attention runs in f32 with q scaled by 1/sqrt(128)
// after RoPE; an INT8 cache's K scale multiplies the score and its V scale the probability.
// Every sum across blocks is taken in a fixed order (no float atomics): a launch is bitwise
// repeatable.
//
// INT4 layers (the Pallas kernel's Q4 tiles): the four layer matrices of an INT4 checkpoint
// hold nibble-packed codes [L, n/2, d] (group split-half, code + 8; ops/quant.py); each
// plan says its own format, so one launch carries Q4 layers and the INT8 classifier.
//
// Bound on the H100: bytes.  A step streams every weight byte once (7.8 GB at 8B; 4.3 GB with
// INT4 layers) plus the cache rows below each position, against ~2 flops per weight element
// and row.  Design against that bound: the weights are a stream that never waits for the grid.
//  * one persistent, cooperative grid, one block an SM (the ring takes most of the shared
//    memory); each block is one producer warp and eight consumer warps (nine warps cap a thread
//    at 168 registers; the producer is one warp, not a warpgroup, so setmaxnreg has nothing to
//    give, and twelve consumer warps computed no faster);
//  * every block walks one static schedule of the step (item_of, the same for both roles): for
//    each layer the wqkv, wo, w13 and w2 items, then the classifier's; an item is a 512-column
//    strip of one matrix times a split of its contraction (kc rows, the wrapper's plan), the
//    items of a phase dealt to the blocks round robin;
//  * the producer warp copies each item's code rows into a ring of shared-memory stages,
//    chunk_rows code rows a stage: four 2-D TMA boxes of 128 columns (a tensor map per matrix,
//    128-byte swizzle, so that the consumers' 16-byte loads hit every bank), and the bf16 scale
//    rows of their groups as bulk copies; a full mbarrier (the bytes in) and an empty one (the
//    consumer warps out) per stage.  The weights do not depend on the activation, so it waits for a
//    free stage and never for the grid: while the consumers sit at a barrier or in the
//    attention phase, the next phase's weights keep arriving;
//  * the consumers stage an item's activation in shared memory as bf16 once per 1024 contraction
//    slots (the RMSNorm applied on the way), then multiply it against each stage as it arrives on
//    mma.sync.m16n8k16: the weights dequantized from the stage into A fragments (bf16 pairs, one
//    fma.rn.bf16x2), the 1 to 8 rows, zero-padded, as n (mma_stage).  One row takes the same
//    path: on the CUDA cores (dequant16 and an FMA per weight) it computed for longer than the
//    stream took;
//  * grid barriers among the consumers alone (grid_barrier: a named barrier, then one thread's
//    arrival on a counter in device memory and a wait for its top bit to flip), five a layer: after
//    wqkv, attention, wo, w13 and w2; and one before a greedy head's argmax;
//  * each item writes f32 partials (at one split its sums are the result); the last item of a
//    strip to arrive (a counter per strip) sums them in split order: wqkv's into q, k, v
//    (QK-norm, RoPE and the q scale applied), wo's and w2's with the residual into the stream
//    (and the strip's sum of squares, which the next RMSNorm reads instead of the whole row),
//    w13's into SwiGLU's output (a w13 strip holds 256 gate columns and the same 256 up
//    columns), the classifier's into logits and the strip's first max.  The arrival counters
//    are left at zero and the barrier's counter where the next launch can start from it: a
//    step adds no device op;
//  * attention is split over (row, kv head, group of query heads, 128-row chunk) items, as
//    flash decode is, so that B = 1 still gives the card enough blocks (a group is one head where
//    that keeps the items to one round of the grid); the last chunk item of
//    each (row, kv head) to arrive seeds the softmax with the self key, merges the chunks in
//    order and writes the step's K/V row: every read of the layer's cache rows has ended then;
//  * stamps (chip_smoke.py's phase breakdown only): each block writes %globaltimer as it
//    finishes each phase and as it leaves the barrier after it.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

struct MatPlan {
  const void* codes;             // int8 [L, n, d] (the classifier: [n, d]); Q4: uint8 [L, n/2, d]
  const __nv_bfloat16* scales;   // [L, n / g, d]
  int n, d, splits, kc;          // kc: in-rows of a split (a multiple of 64; INT4: of 128)
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
  float* part_a;  // split partials of wqkv, w13 and the classifier: [splits, B, strips * 512]
  float* part_b;  // split partials of wo and w2
  float* qkv;     // [B, ah + 2 kvd]: q (normed, rotated, scaled), k (normed, rotated), v
  float* att;     // attention partials: m, l then acc per (row, kv head, chunk, head)
  float* act;     // [B, ah]: the attention output; then [B, hidden]: SwiGLU's output
  float* ssq;     // [ceil(dim / 512), B]: the stream's sums of squares by strip
  float* red_val;  // [classifier strips, B]: each strip's first max
  int* red_idx;
  unsigned* counters;  // [0] the grid barrier's, then strip_counters strips' and B * n_kv
                       // (row, kv head)s' arrivals, left at zero
  int B, dim, ah, kvd, hidden, n_kv, kv_mul, T, L, g, vocab, v_pad;
  int cache_type, use_qk_norm, has_head, greedy;
  int chunk_rows, scale_slots, stage_bytes, n_stages, strip_counters;
  float eps, scale;
  unsigned long long* stamps;  // [grid, barriers + 2, 2] %globaltimer, or null
};

// The kernel's argument: the wrapper's Params and the tensor maps of the five matrices' codes
// (2-D: [L * code rows, d] uint8, boxes of 128 columns by chunk_rows rows), made by the entry point.
struct Launch : Params {
  CUtensorMap maps[5];
};

namespace {

// Eight consumer warps (four column blocks by two slice groups) and one producer warp.
constexpr int kConsumerWarps = 8;
constexpr int kSliceGroups = kConsumerWarps / 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;
constexpr int kColsPerThread = 16;
constexpr int kStrip = 32 * kColsPerThread;  // 512 output columns per item
constexpr int kBoxCols = 128;                // code columns (bytes) of a TMA box: the 128-byte swizzle
constexpr int kBoxes = kStrip / kBoxCols;    // boxes of a stage
constexpr int kScaleStride = 2 * kStrip;     // a stage's scale row: 512 bf16
constexpr int kPiece = 1024;                 // contraction slots of activation staged at a time
constexpr int kXsStride = kPiece + 16;       // bf16 a staged row of the mma route (2080 bytes)
constexpr int kMaxStages = 16;
constexpr int kHd = 128;                     // head_dim
constexpr int kChunk = 128;                  // cache rows per attention item
constexpr int kRows = 8;                     // cache rows per warp in flight
constexpr int kMaxM = 8;                     // query heads per attention item
constexpr int kBatch = 8;                    // activation values a thread loads before it stores
constexpr int kSumBatch = 8;                 // partials loaded before they are summed (wider spilled)
// Shared memory: [mbarriers, a flag, the positions | scratch | ring of stages, from a 1024-byte
// boundary].  The scratch serves one phase at a time: the attention items need the most (q
// [M][128], the warps' m and l [8][M], their acc [8][M][128]); a matmul item its staged
// activation, its sums [8][512] and a few vectors.
constexpr int kBarBytes = 1024;
constexpr int kFlagOff = 512;
constexpr int kPosOff = 576;  // int [8]: the rows' positions clamped to [0, T]
constexpr int kAttnBytes = 4 * (kMaxM * kHd + 2 * kConsumerWarps * kMaxM + kConsumerWarps * kMaxM * kHd);
constexpr int kXsBytes = 8 * kXsStride * 2;
constexpr int kRedOff = kXsBytes;                   // float [8][512]
constexpr int kMiscOff = kRedOff + 8 * kStrip * 4;  // float inv[8], wv[warps][8]; int wi[warps][8]
constexpr int kMatBytes = kMiscOff + 4 * (8 + 2 * 8 * kConsumerWarps);
constexpr int kScratchBytes = ((kAttnBytes > kMatBytes ? kAttnBytes : kMatBytes) + 1023) / 1024 * 1024;
constexpr int kAlign = 1024;  // the swizzled boxes' alignment: the ring may start up to this late

enum Source { kSrcRms = 0, kSrcAttn = 1, kSrcSwiglu = 2 };
enum Mat { kWqkv = 0, kWo = 1, kW13 = 2, kW2 = 3, kHead = 4 };

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* scratch() {
  extern __shared__ __align__(128) uint8_t smem[];
  return smem + kBarBytes;
}

__device__ __forceinline__ int* smem_flag() {
  extern __shared__ __align__(128) uint8_t smem[];
  return reinterpret_cast<int*>(smem + kFlagOff);
}

// Row b's position clamped to [0, T] (the rows below it are read), as the kernel stored it.
__device__ __forceinline__ int read_rows(int b) {
  extern __shared__ __align__(128) uint8_t smem[];
  return reinterpret_cast<const int*>(smem + kPosOff)[b];
}

// The consumer warps' own barrier (named barrier 1): the producer warp never joins it.
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// (value, index) with first-max order: larger value, then smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// A wait that has not ended after kHangNs traps (the launch then fails with an error) instead
// of holding the card: no wait of a step comes near it.
constexpr unsigned long long kHangNs = 5000000000ull;

struct Watchdog {
  unsigned polls = 0;
  unsigned long long t0 = 0;
  __device__ __forceinline__ void poll() {
    if ((++polls & 1023u) != 0) return;
    const unsigned long long now = global_ns();
    if (t0 == 0) t0 = now;
    else if (now - t0 > kHangNs) __trap();
  }
};

// ------------------------------------------------------------------------------ the ring
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
  Watchdog dog;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    dog.poll();
  }
}

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A 2-D TMA load of the box at (c0, c1) (column, row), counted on `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::
          "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// Byte (row r, column c) of a stage's code boxes, 16-byte aligned c: box c / 128 holds rows of
// 128 bytes whose 16-byte chunks the 128-byte swizzle permutes by the row (box_bytes = R * 128).
__device__ __forceinline__ int code_at(int r, int c, int box_bytes) {
  return (c >> 7) * box_bytes + r * kBoxCols + ((((c >> 4) & 7) ^ (r & 7)) << 4);
}

// A block's ring: stage s at base + s * stage_bytes, its full mbarrier at bars + 8 s and its
// empty one at bars + 8 (kMaxStages + s).  Both roles advance it chunk for chunk.
struct Ring {
  uint8_t* base;
  uint32_t bars;
  int stage_bytes, n, stage;
  uint32_t phase;
  __device__ __forceinline__ uint32_t full() const { return bars + 8 * stage; }
  __device__ __forceinline__ uint32_t empty() const { return bars + 8 * (kMaxStages + stage); }
  __device__ __forceinline__ uint8_t* data() const { return base + (long)stage * stage_bytes; }
  __device__ __forceinline__ void next() {
    if (++stage == n) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// ------------------------------------------------------------------------- the schedule
// One item of a matmul phase: strip si times split ki, code rows [crow0, crow1) (INT4: packed
// rows).  A strip is 512 columns from si * 512, or, for w13 ([gate | up], `hidden` columns each),
// 256 gate columns from si * 256 and the same 256 up columns, so that one item holds both
// halves of SwiGLU; box k of a stage holds the item's columns 128 k .. 128 k + 127.  w: the
// valid columns of the strip (w13: of each half).  The producer and the consumers both walk
// `for (it = blockIdx.x; it < items_of(mp, m); it += gridDim.x)` and each item's chunks
// `for (r0 = crow0; r0 < crow1; r0 += chunk_rows)`: one order, stage for stage
// (ops/kernels/megakernel.py::block_stages mirrors it, and decode_megakernel_stages lists it on
// the host for the tests).
struct Item {
  int si, ki, w;
  int crow0, crow1;
};

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__host__ __device__ __forceinline__ int strips_of(const MatPlan& mp, int m) {
  return m == kW13 ? (mp.d / 2 + kStrip / 2 - 1) / (kStrip / 2) : (mp.d + kStrip - 1) / kStrip;
}
__host__ __device__ __forceinline__ int items_of(const MatPlan& mp, int m) { return strips_of(mp, m) * mp.splits; }

__host__ __device__ __forceinline__ Item item_of(const MatPlan& mp, int m, int it) {
  const int strips = strips_of(mp, m);
  Item t;
  t.si = it % strips;
  t.ki = it / strips;
  t.w = m == kW13 ? imin(kStrip / 2, mp.d / 2 - t.si * (kStrip / 2)) : imin(kStrip, mp.d - t.si * kStrip);
  const int k0 = t.ki * mp.kc, k1 = imin(mp.n, k0 + mp.kc);
  t.crow0 = mp.q4 ? k0 / 2 : k0;
  t.crow1 = mp.q4 ? k1 / 2 : k1;
  return t;
}

// The matrix column of the item's column c (c < 512), and whether box k holds a valid column.
__device__ __forceinline__ int item_col(const MatPlan& mp, int m, const Item& t, int c) {
  if (m != kW13) return t.si * kStrip + c;
  return (c < kStrip / 2 ? 0 : mp.d / 2) + t.si * (kStrip / 2) + (c & (kStrip / 2 - 1));
}
__device__ __forceinline__ bool col_ok(int m, const Item& t, int c) {
  return (m == kW13 ? c & (kStrip / 2 - 1) : c) < t.w;
}

// Code rows of a scale group: INT8 g, INT4 g / 2 packed rows.
__host__ __device__ __forceinline__ int group_rows(int g, const MatPlan& mp) { return mp.q4 ? g / 2 : g; }

// The stage of an item's chunk from code row r0: its code rows (at most R) and its first scale
// group and count of them (gr code rows a group).
struct Stage {
  int rows, g0, ns;
};
__host__ __device__ __forceinline__ Stage stage_of(const Item& t, int r0, int R, int gr) {
  Stage s;
  s.rows = imin(R, t.crow1 - r0);
  s.g0 = r0 / gr;
  s.ns = (r0 + s.rows - 1) / gr - s.g0 + 1;
  return s;
}

// ------------------------------------------------------------------------- the producer
// A stage: the code boxes (kBoxes x R rows x 128 bytes; those with no valid column are not
// loaded, columns past d read zeros), then scale_slots rows of 512 bf16 scales in the item's
// column order.  The boxes always hold R rows (past the item's rows: the next rows of the array,
// or zeros past its end), so a box counts R * 128 bytes.
__device__ void produce_mat(const Launch& p, Ring& ring, int m, int layer) {
  const MatPlan& mp = p.mat[m];
  const int lane = threadIdx.x & 31, D = mp.d, R = p.chunk_rows, gr = group_rows(p.g, mp);
  const int row0 = layer * (mp.q4 ? mp.n / 2 : mp.n);  // the layer's first row of the map
  const __nv_bfloat16* scales = mp.scales + (long)layer * (mp.n / p.g) * D;
  const int halves = m == kW13 ? 2 : 1, half_cols = kStrip / halves;
  for (int it = blockIdx.x; it < items_of(mp, m); it += gridDim.x) {
    const Item t = item_of(mp, m, it);
    int boxes = 0;
    for (int k = 0; k < kBoxes; ++k) boxes += col_ok(m, t, k * kBoxCols);
    const int half_bytes = 2 * min(t.w, half_cols);  // scale bytes of one half of a scale row
    for (int r0 = t.crow0; r0 < t.crow1; r0 += R) {
      const Stage sg = stage_of(t, r0, R, gr);
      const int g0 = sg.g0, ns = sg.ns;
      mbar_wait(ring.empty(), ring.phase ^ 1u);
      if (lane == 0) mbar_expect_tx(ring.full(), (uint32_t)(boxes * R * kBoxCols + ns * halves * half_bytes));
      __syncwarp();
      const uint32_t dst = smem_u32(ring.data());
      if (lane < kBoxes && col_ok(m, t, lane * kBoxCols))
        tma_box(dst + lane * R * kBoxCols, &p.maps[m], ring.full(), item_col(mp, m, t, lane * kBoxCols), row0 + r0);
      for (int k = lane; k < ns * halves; k += 32) {
        const int g = k / halves, h = k % halves;
        bulk_copy(dst + kBoxes * R * kBoxCols + g * kScaleStride + h * half_cols * 2,
                  scales + (long)(g0 + g) * D + item_col(mp, m, t, h * half_cols), half_bytes, ring.full());
      }
      ring.next();
    }
  }
}

// The whole step's weights, in the consumers' order, as fast as stages free up.
__device__ __noinline__ void produce(const Launch& p, Ring& ring) {
  for (int l = 0; l < p.L; ++l)
    for (int m = kWqkv; m <= kW2; ++m) produce_mat(p, ring, m, l);
  if (p.has_head) produce_mat(p, ring, kHead, 0);
}

// ------------------------------------------------------------- consumers: arrivals
// The consumer threads of every block meet; the producer warps never take part.  One counter:
// block 0 adds 2^31 - (grid - 1) and every other block 1, so its top bit flips when the last
// block arrives and each barrier leaves it 2^31 further (mod 2^32): the next barrier, and the
// next launch, start from wherever it stands.
__device__ __noinline__ void grid_barrier(const Params& p) {
  consumer_sync();
  if (threadIdx.x == 0) {
    volatile unsigned* count = p.counters;
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();  // the block's writes (ordered before by the named barrier) go first
    const unsigned old = atomicAdd(p.counters, add);
    Watchdog dog;
    while (((old ^ *count) & 0x80000000u) == 0) dog.poll();
    __threadfence();
  }
  consumer_sync();
}

// Whether this block is the last of `expected` arrivals on `ctr` (it then resets it): every
// consumer thread's writes before the call are visible to the last block after it.
__device__ __forceinline__ bool last_arrival(unsigned* ctr, unsigned expected) {
  int* flag = smem_flag();
  consumer_sync();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(ctr, 1u) == expected - 1;
    if (last) atomicExch(ctr, 0u);
    *flag = last;
  }
  consumer_sync();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// ----------------------------------------------------------- consumers: matmul phases
// bf16(code_a * sa) | bf16(code_b * sb) << 16 for byte k of two code words, the scale pair
// s = sa | sb << 16 in bf16: the codes, exact in bf16, times the scales with one fma.rn.bf16x2,
// which rounds the exact product once, as bf16(f32 product) does.  INT4: words of biased nibbles,
// 0x43nn is 128 + nn (as qmatmul_w8a16.cu's mma route).  INT8: words of raw codes, built without
// a conversion instruction: 0x4300 | (low 7 bits) is 128 + low, 0xC300 | (the sign bit) is -128
// or -256, and their sum is the code, exactly.
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

template <bool Q4>
__device__ __forceinline__ uint32_t deq2(uint32_t wa, uint32_t wb, int k, uint32_t s) {
  if constexpr (Q4) {
    const uint32_t t = (__byte_perm(wa, wb, k | ((k + 4) << 8)) & 0x00FF00FFu) | 0x43004300u;
    return bf16x2_fma(bf16x2_fma(t, 0x3F803F80u, 0xC308C308u), s, 0x80008000u);  // (t - 136) * s
  } else {
    const uint32_t x = __byte_perm(wa, wb, k | ((k + 4) << 8));
    const uint32_t code = bf16x2_fma((x & 0x007F007Fu) | 0x43004300u, 0x3F803F80u, (x & 0x00800080u) | 0xC300C300u);
    return bf16x2_fma(code, s, 0x80008000u);
  }
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) { return *reinterpret_cast<const uint4*>(p); }

// The sum over `splits` partials part[k][b][c] (row stride d) in split order, kSumBatch loads
// in flight at a time.
__device__ __forceinline__ float split_sum(const float* part, int splits, int B, int d, int b, int c) {
  float s = 0.f;
  for (int k0 = 0; k0 < splits; k0 += kSumBatch) {
    float v[kSumBatch];
#pragma unroll
    for (int j = 0; j < kSumBatch; ++j)
      v[j] = k0 + j < splits ? __ldcg(part + ((long)(k0 + j) * B + b) * d + c) : 0.f;
#pragma unroll
    for (int j = 0; j < kSumBatch; ++j)
      if (k0 + j < splits) s += v[j];
  }
  return s;
}

// Row b's activation at in-row n, before its bf16 rounding: the RMSNorm of src, the attention
// output, or SwiGLU's output (w13's strips wrote both into act).
__device__ __forceinline__ float act_value(const Params& p, int src_kind, const float* src, const float* norm_w,
                                           const float* inv, int N, int b, int n) {
  if (src_kind == kSrcRms) return __ldcg(src + (long)b * N + n) * inv[b] * norm_w[n];
  return __ldcg(p.act + (long)b * (src_kind == kSrcAttn ? p.ah : p.hidden) + n);
}

// inv[b] = 1 / sqrt(mean(x^2) + eps) of the RMSNorm's input: over the whole row (`full`: the
// step's input, which no strip summed), else from the strips' sums of squares in order.
__device__ void rms_inv(const Params& p, bool full, const float* src, int N, float* inv, float* wv) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (full) {
    for (int b = 0; b < p.B; ++b) {
      float ss = 0.f;
      for (int i = tid; i < N; i += kConsumers) {
        const float v = __ldcg(src + (long)b * N + i);
        ss = fmaf(v, v, ss);
      }
      ss = warp_sum(ss);
      if (lane == 0) wv[warp * 8 + b] = ss;
    }
    consumer_sync();
    if (tid < p.B) {
      float t = 0.f;
      for (int w = 0; w < kConsumerWarps; ++w) t += wv[w * 8 + tid];
      inv[tid] = 1.f / sqrtf(t / (float)N + p.eps);
    }
  } else if (tid < p.B) {
    const int strips = (p.dim + kStrip - 1) / kStrip;
    inv[tid] = 1.f / sqrtf(split_sum(p.ssq, strips, p.B, 1, tid, 0) / (float)N + p.eps);
  }
  consumer_sync();
}

// The activation of code rows [pc0, pc1) in the mma's k order: xs[b][16 sl + 4 t + j] (bf16) is
// row b's k index 2 t + (j & 1) + 8 (j >> 1) of slice sl, so that thread t4 of a warp finds its B
// fragment (k 2 t4, 2 t4 + 1 | 2 t4 + 8, 2 t4 + 9) in one 8-byte load.  INT8 k index u of slice
// sl is code row pc0 + 16 sl + u; INT4 k index 2 t + (j & 1) + 8 (j >> 1) is packed row
// pc0 + 8 sl + 2 t + (j >> 1), its low (j even) or high nibble.  Slots past the code rows are 0.
// Rows from B on are not staged: the mma's column of such a row (whatever xs holds there) only
// reaches that row's results, which nothing reads.  Eight values of a thread are loaded before
// any is stored.
template <bool Q4>
__device__ void stage(const Params& p, int src_kind, const float* src, const float* norm_w, const float* inv,
                      int N, int pc0, int pc1, __nv_bfloat16* xs) {
  constexpr int SLR = Q4 ? 8 : 16;  // code rows of a 16-slot slice
  const int n_slots = (pc1 - pc0 + SLR - 1) / SLR * 16, total = p.B * n_slots;
  const int h = p.g / 2;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kConsumers) {
    float v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kConsumers, b = i / n_slots, s = i % n_slots;
      const int sl = s >> 4, t = (s >> 2) & 3, jj = s & 3;
      const int crow = pc0 + sl * SLR + (Q4 ? 2 * t + (jj >> 1) : 2 * t + (jj & 1) + 8 * (jj >> 1));
      v[j] = 0.f;
      if (i < total && crow < pc1) {
        const int n = Q4 ? (crow / h) * p.g + crow % h + (jj & 1) * h : crow;
        v[j] = act_value(p, src_kind, src, norm_w, inv, N, b, n);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j * kConsumers;
      if (i < total) xs[(i / n_slots) * kXsStride + i % n_slots] = __float2bfloat16_rn(v[j]);
    }
  }
}

// The scale pair of column c from two rows of scale words: row a's in the low half, b's high.
__device__ __forceinline__ uint32_t scale_pair(const uint32_t (&wa)[8], const uint32_t (&wb)[8], int c) {
  return __byte_perm(wa[c >> 1], wb[c >> 1], (c & 1) ? 0x7632 : 0x5410);
}

__device__ __forceinline__ void scale_words(const uint8_t* p, uint32_t (&w)[8]) {
  const uint4 a = lds128(p), b = lds128(p + 16);
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w, w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}

// The eight m16 tiles of one slice: the A fragments dequantized from the code words w and the
// scale pairs (U: su, the pair of each of the thread's 16 columns; else from sv, a row of scale
// words per fragment row pair), times the B fragment bx.  ok: whether fragment pairs j = 0, 1
// and j = 2, 3 hold weights (Full: both do).
template <bool Q4, bool U, bool Full, int SV>
__device__ __forceinline__ void mma_slice(const uint32_t (&w)[4][4], const uint32_t (&su)[16],
                                          const uint32_t (&sv)[SV][8], uint2 bx, const bool (&ok)[2],
                                          float (&acc)[8][4]) {
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) {
    const int q = mt >> 1, k0 = 2 * (mt & 1);
    uint32_t af[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {  // (fragment row r8 + 8 (e & 1), the slots of pair jj, jj + 1)
      const int cc = 2 * mt + (e & 1), jj = 2 * (e >> 1);
      uint32_t s;
      if constexpr (U) s = su[cc];
      else if constexpr (Q4) s = scale_pair(sv[jj >> 1], sv[jj >> 1], cc);
      else s = scale_pair(sv[jj], sv[jj + 1], cc);
      const uint32_t d = deq2<Q4>(w[jj][q], w[jj + 1][q], k0 + (e & 1), s);
      af[e] = Full || ok[e >> 1] ? d : 0u;
    }
    mma16816(acc[mt], af, bx.x, bx.y);
  }
}

// One stage on mma.sync.m16n8k16, the activation's rows (1 to 8, zero-padded) as n.  Warp w takes
// column block cb = w % 4 (128 columns, one TMA box: eight m16 tiles) and the slices (16
// contraction slots each) of slice group w / 4.  Thread (r8, t4) (lane 4 r8 + t4) holds mma k
// indices 2 t4 + (j & 1) + 8 (j >> 1), j = 0..3: INT8 the slice's code rows of those indices,
// INT4 packed rows 2 t4 and 2 t4 + 1 (low and high nibbles), at columns 16 r8 .. + 15 of its
// block, and dequantizes them into its A fragments; fragment row r of m-tile mt is column
// 16 (r % 8) + 2 mt + r / 8.  A quarter warp's eight 16-byte loads fall in eight different
// swizzled chunks.  Its results: columns 16 r8 + 2 mt + {0, 1} of rows 2 t4 + {0, 1}.  U: a
// slice lies in one scale group, whose pairs are rebuilt only when the group changes.  A slice
// is 16 code rows (INT4 8) or, at the item's end, half of that; the missing rows' fragments are
// zero.
template <bool Q4, bool U>
__device__ __forceinline__ void mma_stage(const uint8_t* st, int scale_off, int box_bytes, int rows, int r0, int g0,
                                          int gr, const __nv_bfloat16* xs, int slot0, unsigned box_ok, int sbase,
                                          float (&acc)[8][4]) {
  constexpr int SLR = Q4 ? 8 : 16;
  constexpr int NL = Q4 ? 2 : 4;  // the thread's 16-byte code loads of a slice
  constexpr int SV = U ? 1 : (Q4 ? 2 : 4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r8 = lane >> 2, t4 = lane & 3, cb = warp & 3;
  if (!((box_ok >> cb) & 1u)) return;  // a box with no valid column
  const int colb = cb * 128 + 16 * r8;
  // The thread's code rows of a slice and their bytes in slice 0 (slices are 8-row aligned, so a
  // slice only adds its rows; the swizzle depends on the row mod 8).
  int crow[NL], off[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    crow[i] = Q4 ? 2 * t4 + i : 2 * t4 + (i & 1) + 8 * (i >> 1);
    off[i] = code_at(crow[i], colb, box_bytes);
  }
  const uint8_t* scales = st + scale_off + 2 * colb;
  const int n_sl = (rows + SLR - 1) / SLR;
  // The item's slices go to the slice groups in turn, counted from its first (sbase: the
  // slices of its earlier stages), so that every group takes an equal share.
  const int first = ((warp >> 2) - sbase % kSliceGroups + kSliceGroups) % kSliceGroups;
  // U: the slice's scale group (relative to g0) and its first row's offset in the group.
  int gq = 0, goff = 0, su_g = -1;
  if constexpr (U) {
    const int r = r0 - g0 * gr + first * SLR;
    gq = r / gr;
    goff = r - gq * gr;
  }
  uint32_t su[16];
  for (int sl = first; sl < n_sl; sl += kSliceGroups) {
    const int rowb = sl * SLR, valid = rows - rowb;
    uint32_t w[4][4];
    uint32_t sv[SV][8];
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      const uint4 v = lds128(st + off[i] + rowb * kBoxCols);
      const uint32_t raw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if constexpr (Q4) {
          w[2 * i][q] = raw[q] & 0x0F0F0F0Fu;
          w[2 * i + 1][q] = (raw[q] >> 4) & 0x0F0F0F0Fu;
        } else {
          w[i][q] = raw[q];
        }
      }
      if constexpr (!U)
        scale_words(scales + ((r0 + min(rowb + crow[i], rows - 1)) / gr - g0) * kScaleStride, sv[i]);
    }
    if constexpr (U) {
      if (gq != su_g) {
        scale_words(scales + gq * kScaleStride, sv[0]);
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) su[cc] = scale_pair(sv[0], sv[0], cc);
        su_g = gq;
      }
      for (goff += kSliceGroups * SLR; goff >= gr; goff -= gr) ++gq;
    }
    const uint2 bx = *reinterpret_cast<const uint2*>(xs + r8 * kXsStride + slot0 + sl * 16 + 4 * t4);
    const bool ok[2] = {Q4 ? 2 * t4 < valid : true, Q4 ? 2 * t4 + 1 < valid : valid > 8};
    if (valid >= SLR) mma_slice<Q4, U, true, SV>(w, su, sv, bx, ok, acc);
    else mma_slice<Q4, U, false, SV>(w, su, sv, bx, ok, acc);
  }
}

// A finished item's column sums fin[b][c] (the item's columns c < 512, b < B) to their
// destination.  Every plan writes its split partials (at one split wqkv, wo, w2 and the
// classifier skip them), and the strip's last item to arrive sums them in split order and writes
// q, k, v (wqkv), the stream and its sums of squares (wo, w2: + res), SwiGLU's output (w13), or
// the logits and the strip's first max.  Partials are [split][B][strips * 512].
__device__ __noinline__ void epilogue(const Params& p, int m, int layer, const Item& t, float* fin, const float* res) {
  const MatPlan& mp = p.mat[m];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, B = p.B, D = mp.d;
  const int c2 = 2 * tid, pd = strips_of(mp, m) * kStrip, pc = t.si * kStrip + c2;
  const bool valid = c2 < kStrip && col_ok(m, t, c2);             // two columns a thread
  float* wv = reinterpret_cast<float*>(scratch() + kMiscOff) + 8;  // [warps][8]
  int* wi = reinterpret_cast<int*>(wv + 8 * kConsumerWarps);       // [warps][8]
  float* part = (m == kWo || m == kW2) ? p.part_b : p.part_a;
  if (mp.splits > 1) {
    if (valid)
      for (int b = 0; b < B; ++b)
        *reinterpret_cast<float2*>(part + ((long)t.ki * B + b) * pd + pc) =
            *reinterpret_cast<const float2*>(fin + b * kStrip + c2);
    if (!last_arrival(p.counters + 1 + t.si, (unsigned)mp.splits)) return;
    if (valid)
      for (int b = 0; b < B; ++b) {
        fin[b * kStrip + c2] = split_sum(part, mp.splits, B, pd, b, pc);
        fin[b * kStrip + c2 + 1] = split_sum(part, mp.splits, B, pd, b, pc + 1);
      }
  }
  consumer_sync();
  if (m == kWqkv) {
    // The strip's heads (128 columns each), one warp a (row, head), lane holding dims
    // lane + 32 j; q and k: QK-norm, then RoPE (pairs d, d + 64); q times the scale.
    const int heads = t.w / kHd, qkv_w = p.ah + 2 * p.kvd;
    for (int hv = warp; hv < B * heads; hv += kConsumerWarps) {
      const int b = hv / heads, hc = (hv % heads) * kHd, c = t.si * kStrip + hc;
      const bool is_q = c < p.ah, rot = c < p.ah + p.kvd;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = fin[b * kStrip + hc + lane + 32 * j];
      if (rot && p.use_qk_norm) {
        const float* nw = (is_q ? p.q_norm : p.k_norm) + (long)layer * kHd;
        const float ss = warp_sum(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]);
        const float inv = 1.f / sqrtf(ss / (float)kHd + p.eps);
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = v[j] * inv * nw[lane + 32 * j];
      }
      if (rot) {
        const float c0 = p.cos[b * (kHd / 2) + lane], s0 = p.sin[b * (kHd / 2) + lane];
        const float c1 = p.cos[b * (kHd / 2) + lane + 32], s1 = p.sin[b * (kHd / 2) + lane + 32];
        const float a0 = v[0] * c0 - v[2] * s0, a2 = v[0] * s0 + v[2] * c0;
        const float a1 = v[1] * c1 - v[3] * s1, a3 = v[1] * s1 + v[3] * c1;
        v[0] = a0, v[1] = a1, v[2] = a2, v[3] = a3;
      }
      const float mul = is_q ? p.scale : 1.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) p.qkv[(long)b * qkv_w + c + lane + 32 * j] = v[j] * mul;
    }
    return;
  }
  if (m == kW13) {
    // act[b, j] = silu(gate) * up: the item's column j (< 256) is gate j, column 256 + j up j.
    const int j = tid;
    if (j < kStrip / 2 && j < t.w)
      for (int b = 0; b < B; ++b) {
        const float gate = fin[b * kStrip + j], up = fin[b * kStrip + kStrip / 2 + j];
        p.act[(long)b * p.hidden + t.si * (kStrip / 2) + j] = gate * (1.f / (1.f + expf(-gate))) * up;
      }
    return;
  }
  const int col = t.si * kStrip + c2;
  if (m == kHead) {
    for (int b = 0; b < B; ++b) {
      const float v0 = fin[b * kStrip + c2], v1 = fin[b * kStrip + c2 + 1];
      if (valid) *reinterpret_cast<float2*>(p.logits + (long)b * p.v_pad + col) = make_float2(v0, v1);
      if (!p.greedy) continue;
      float bv = -INFINITY;
      int bi = kNoIndex;
      if (valid && col < p.vocab) bv = v0, bi = col;
      if (valid && col + 1 < p.vocab && better(v1, col + 1, bv, bi)) bv = v1, bi = col + 1;
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (better(ov, oi, bv, bi)) bv = ov, bi = oi;
      }
      if (lane == 0) wv[warp * 8 + b] = bv, wi[warp * 8 + b] = bi;
    }
    if (!p.greedy) return;
    consumer_sync();
    if (tid < B) {
      float bv = wv[tid];
      int bi = wi[tid];
      for (int w = 1; w < kConsumerWarps; ++w)
        if (better(wv[w * 8 + tid], wi[w * 8 + tid], bv, bi)) bv = wv[w * 8 + tid], bi = wi[w * 8 + tid];
      p.red_val[(long)t.si * B + tid] = bv;
      p.red_idx[(long)t.si * B + tid] = bi;
    }
    return;
  }
  // wo, w2: the stream = res + the sums, one writer per column; the strip's sums of squares.
  for (int b = 0; b < B; ++b) {
    float o0 = 0.f, o1 = 0.f;
    if (valid) {
      const float2 r = __ldcg(reinterpret_cast<const float2*>(res + (long)b * D + col));
      o0 = r.x + fin[b * kStrip + c2];
      o1 = r.y + fin[b * kStrip + c2 + 1];
      *reinterpret_cast<float2*>(p.x_out + (long)b * D + col) = make_float2(o0, o1);
    }
    const float ss = warp_sum(o0 * o0 + o1 * o1);
    if (lane == 0) wv[warp * 8 + b] = ss;
  }
  consumer_sync();
  if (tid < B) {
    float s = 0.f;
    for (int w = 0; w < kConsumerWarps; ++w) s += wv[w * 8 + tid];
    p.ssq[t.si * B + tid] = s;
  }
}

// One matmul phase of this block: its items of plan m, each staged, streamed from the ring stage
// by stage, summed over the warps in a fixed order and handed to the epilogue.
template <bool Q4, bool U>
__device__ __noinline__ void mat_phase(const Params& p, Ring& ring, int m, int layer, int src_kind, const float* src,
                                       const float* norm_w, const float* res, bool full_rms) {
  uint8_t* sc = scratch();
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(sc);
  float* red = reinterpret_cast<float*>(sc + kRedOff);
  float* inv = reinterpret_cast<float*>(sc + kMiscOff);
  const MatPlan& mp = p.mat[m];
  const int N = mp.n, R = p.chunk_rows, gr = group_rows(p.g, mp), box_bytes = R * kBoxCols;
  const int scale_off = kBoxes * box_bytes;
  constexpr int kPieceRows = Q4 ? kPiece / 2 : kPiece;  // code rows of a staged piece
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r8 = lane >> 2, t4 = lane & 3, cb = warp & 3;
  if (src_kind == kSrcRms) rms_inv(p, full_rms, src, N, inv, inv + 8);
  for (int it = blockIdx.x; it < items_of(mp, m); it += gridDim.x) {
    const Item t = item_of(mp, m, it);
    unsigned box_ok = 0;
#pragma unroll
    for (int k = 0; k < kBoxes; ++k) box_ok |= (unsigned)col_ok(m, t, k * kBoxCols) << k;
    int sbase = 0;  // the item's slices before this stage
    float acc[8][4];
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    for (int pc0 = t.crow0; pc0 < t.crow1; pc0 += kPieceRows) {
      const int pc1 = min(t.crow1, pc0 + kPieceRows);
      consumer_sync();  // the last piece (or item) is done with the scratch
      stage<Q4>(p, src_kind, src, norm_w, inv, N, pc0, pc1, xs);
      consumer_sync();
      for (int r0 = pc0; r0 < pc1; r0 += R) {
        const int rows = min(R, pc1 - r0), g0 = r0 / gr, slot0 = (r0 - pc0) * (Q4 ? 2 : 1);
        mbar_wait(ring.full(), ring.phase);
        mma_stage<Q4, U>(ring.data(), scale_off, box_bytes, rows, r0, g0, gr, xs, slot0, box_ok, sbase, acc);
        sbase += (rows + (Q4 ? 7 : 15)) / (Q4 ? 8 : 16);
        __syncwarp();
        if (lane == 0) mbar_arrive(ring.empty());
        ring.next();
      }
    }
    // The slice groups' sums of each column block into red = fin[b][c] (rows b < B), the last
    // group first and the others added in turn: a fixed order.
    const bool on = (box_ok >> cb) & 1u;
    for (int sg = kSliceGroups - 1; sg >= 0; --sg) {
      if ((warp >> 2) == sg && on)
#pragma unroll
        for (int mt = 0; mt < 8; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (2 * t4 + (e & 1) < p.B) {
              float* d = red + (2 * t4 + (e & 1)) * kStrip + cb * 128 + 16 * r8 + 2 * mt + (e >> 1);
              *d = sg == kSliceGroups - 1 ? acc[mt][e] : acc[mt][e] + *d;
            }
          }
      consumer_sync();  // the next group, or the epilogue, reads what this one wrote
    }
    epilogue(p, m, layer, t, red, res);
  }
}

__device__ __forceinline__ void matmul(const Params& p, Ring& ring, int m, int layer, int src_kind, const float* src,
                                       const float* norm_w, const float* res, bool full_rms) {
  const MatPlan& mp = p.mat[m];
  const int gr = group_rows(p.g, mp);
  const bool u = mp.q4 ? gr % 8 == 0 : gr % 16 == 0;
  if (mp.q4) {
    if (u) mat_phase<true, true>(p, ring, m, layer, src_kind, src, norm_w, res, full_rms);
    else mat_phase<true, false>(p, ring, m, layer, src_kind, src, norm_w, res, full_rms);
  } else {
    if (u) mat_phase<false, true>(p, ring, m, layer, src_kind, src, norm_w, res, full_rms);
    else mat_phase<false, false>(p, ring, m, layer, src_kind, src, norm_w, res, full_rms);
  }
}

// -------------------------------------------------------- consumers: attention phase
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

// The merge of (row b, kv head h) = bh, by the last of its chunk items: for each group of up
// to kMaxM query heads the self key seeds the softmax (m = q.k_self, l = 1, acc = v_self) and
// the chunks below pos merge in order; then the step's K/V row.
__device__ __noinline__ void attn_merge(const Params& p, int layer, int bh) {
  const int KM = p.kv_mul, qkv_w = p.ah + 2 * p.kvd;
  const int n_chunks = (p.T + kChunk - 1) / kChunk;
  const float* part_ml = p.att;
  const float* part_acc = p.att + (long)p.B * p.n_kv * n_chunks * KM * 2;
  float* vec = reinterpret_cast<float*>(scratch());  // [kMaxM][128]: a group's q heads
  float* kv = vec + kMaxM * kHd;                      // [2][128]: the step's k, v
  float* sself = kv + 2 * kHd;                        // [kMaxM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = bh / p.n_kv, h = bh % p.n_kv;
  const int active = (read_rows(b) + kChunk - 1) / kChunk;
  const float* row = p.qkv + (long)b * qkv_w;
  for (int m0 = 0; m0 < KM; m0 += kMaxM) {
    const int M = min(kMaxM, KM - m0);
    consumer_sync();  // the previous group (or the chunk item) is done with the scratch
    for (int i = tid; i < M * kHd; i += kConsumers) vec[i] = __ldcg(row + (h * KM + m0) * kHd + i);
    if (m0 == 0)
      for (int i = tid; i < 2 * kHd; i += kConsumers)
        kv[i] = __ldcg(row + p.ah + (i < kHd ? h * kHd + i : p.kvd + h * kHd + i - kHd));
    consumer_sync();
    if (warp < M) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s = fmaf(vec[warp * kHd + lane + 32 * j], kv[lane + 32 * j], s);
      s = warp_sum(s);
      if (lane == 0) sself[warp] = s;
    }
    consumer_sync();
    // Thread (half, d) merges dimension d of query heads half, half + 2, ...: each (head, d) in
    // chunk order, kSumBatch chunks' partials loaded at a time.
    const int d = tid & (kHd - 1);
    const float vd = kv[kHd + d];
    for (int m = tid / kHd; m < M; m += kConsumers / kHd) {
      float mcur = sself[m], l = 1.f, a = vd;
      for (int j0 = 0; j0 < active; j0 += kSumBatch) {
        float mj[kSumBatch], lj[kSumBatch], aj[kSumBatch];
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) {
          const long slot = ((long)bh * n_chunks + min(j0 + j, active - 1)) * KM + m0 + m;
          mj[j] = __ldcg(part_ml + slot * 2);
          lj[j] = __ldcg(part_ml + slot * 2 + 1);
          aj[j] = __ldcg(part_acc + slot * kHd + d);
        }
#pragma unroll
        for (int j = 0; j < kSumBatch; ++j) {
          if (j0 + j >= active) break;
          const float m_new = fmaxf(mcur, mj[j]);
          const float ca = expf(mcur - m_new), cj = expf(mj[j] - m_new);
          l = l * ca + lj[j] * cj;
          a = a * ca + aj[j] * cj;
          mcur = m_new;
        }
      }
      p.act[(long)b * p.ah + (h * KM + m0 + m) * kHd + d] = a / l;
    }
  }
  // The step's K/V row, in place: every chunk item of (b, h) has read its rows.
  if (p.write_ok == nullptr || p.write_ok[b] != 0) {
    const int crow = min(max(p.pos[b], 0), p.T - 1);
    const long r = (((long)layer * p.B + b) * p.n_kv + h) * p.T + crow;
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

// Attention: one partial (m, l, acc) per (row b, kv head, group of query heads, 128-row chunk)
// over the cache rows below min(pos, T); chunks at or past it are never read (a position of 0
// still has its chunk 0 item, which reads nothing and arrives).  Items are dealt over the chunks
// below need_max, the most any row needs.  The kv_mul query heads of a kv head go in groups of up
// to MM, which share each row the item reads.  The last item of a (row, kv head) to arrive merges
// it.
template <typename TC, int MM>
__device__ __noinline__ void attention(const Params& p, int layer, int need_max) {
  const int KM = p.kv_mul, qkv_w = p.ah + 2 * p.kvd;
  const int groups = (KM + MM - 1) / MM;
  const int n_chunks = (p.T + kChunk - 1) / kChunk;
  const long layer_rows = (long)p.B * p.n_kv * p.T;
  const TC* kc = reinterpret_cast<const TC*>(p.k_cache) + layer * layer_rows * kHd;
  const TC* vc = reinterpret_cast<const TC*>(p.v_cache) + layer * layer_rows * kHd;
  const float* ks = p.k_scale != nullptr ? p.k_scale + layer * layer_rows : nullptr;
  const float* vs = p.v_scale != nullptr ? p.v_scale + layer * layer_rows : nullptr;
  float* sq = reinterpret_cast<float*>(scratch());  // [kMaxM][128]
  float* sm_m = sq + kMaxM * kHd;                     // [8 warps][M]
  float* sm_l = sm_m + kConsumerWarps * kMaxM;        // [8 warps][M]
  float* sm_acc = sm_l + kConsumerWarps * kMaxM;      // [8 warps][M][128]
  float* part_ml = p.att;
  float* part_acc = p.att + (long)p.B * p.n_kv * n_chunks * KM * 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int items = p.B * p.n_kv * groups * need_max;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int chunk = it % need_max, rest = it / need_max;
    const int bh = rest / groups, m0 = (rest % groups) * MM;
    const int M = min(MM, KM - m0);  // this item's query heads: m0 .. m0 + M - 1
    const int b = bh / p.n_kv, h = bh % p.n_kv;
    const int pb = read_rows(b);
    const int active = (pb + kChunk - 1) / kChunk, need = max(active, 1);
    if (chunk >= need) continue;  // uniform over the block; no ring stage is involved
    if (chunk < active) {
      const int t0 = chunk * kChunk, t1 = min(pb, t0 + kChunk);
      consumer_sync();  // the previous item is done with the scratch
      for (int i = tid; i < M * kHd; i += kConsumers)
        sq[i] = __ldcg(p.qkv + (long)b * qkv_w + (h * KM + m0) * kHd + i);
      consumer_sync();

      float qr[MM][4], mrun[MM], lrun[MM], acc[MM][4];
#pragma unroll
      for (int m = 0; m < MM; ++m) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qr[m][i] = m < M ? sq[m * kHd + lane * 4 + i] : 0.f;
          acc[m][i] = 0.f;
        }
        mrun[m] = -INFINITY;
        lrun[m] = 0.f;
      }
      const long row0 = (long)bh * p.T;  // first cache row of this (b, kv head)
      for (int tb = t0 + warp * kRows; tb < t1; tb += kConsumerWarps * kRows) {
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
        for (int m = 0; m < MM; ++m) {
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
      for (int m = 0; m < MM; ++m) {
        if (m >= M) break;
        if (lane == 0) {
          sm_m[warp * kMaxM + m] = mrun[m];
          sm_l[warp * kMaxM + m] = lrun[m];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) sm_acc[(warp * kMaxM + m) * kHd + lane * 4 + i] = acc[m][i];
      }
      consumer_sync();
      if (tid < kHd) {
        const long slot = ((long)bh * n_chunks + chunk) * KM + m0;
        for (int m = 0; m < M; ++m) {
          float mm = -INFINITY;
          for (int w = 0; w < kConsumerWarps; ++w) mm = fmaxf(mm, sm_m[w * kMaxM + m]);
          float l = 0.f, a = 0.f;
          for (int w = 0; w < kConsumerWarps; ++w) {
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
    if (last_arrival(p.counters + 1 + p.strip_counters + bh, (unsigned)(groups * need)))
      attn_merge(p, layer, bh);
  }
}

template <int MM>
__device__ void attention_of(const Params& p, int layer, int need_max) {
  if (p.cache_type == 0) attention<float, MM>(p, layer, need_max);
  else if (p.cache_type == 1) attention<__nv_bfloat16, MM>(p, layer, need_max);
  else attention<int8_t, MM>(p, layer, need_max);
}

// One query head an item where the items then still fit one round of the grid (short positions:
// the phase is a chain of latencies, and more items shorten it); else groups of 4 (kv_mul <= 4)
// or kMaxM heads (registers hold them), which read each cache row once for the group.  Every
// block finds the same need_max, so every block deals the same items.
__device__ void attention_phase(const Params& p, int layer) {
  int need_max = 1;
  for (int b = 0; b < p.B; ++b) need_max = max(need_max, (read_rows(b) + kChunk - 1) / kChunk);
  if (p.B * p.n_kv * p.kv_mul * need_max <= (int)gridDim.x) attention_of<1>(p, layer, need_max);
  else if (p.kv_mul <= 4) attention_of<4>(p, layer, need_max);
  else attention_of<kMaxM>(p, layer, need_max);
}

// ------------------------------------------------------------------------- the kernel
__global__ void __launch_bounds__(kThreads, 1) decode_megakernel_kernel(const __grid_constant__ Launch p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t bars = smem_u32(smem);
  uint8_t* ring_base = smem + kBarBytes + kScratchBytes;
  ring_base += (kAlign - (smem_u32(ring_base) & (kAlign - 1))) & (kAlign - 1);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < p.n_stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kMaxStages + s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the last barrier every thread takes part in
  Ring ring{ring_base, bars, p.stage_bytes, p.n_stages, 0, 0u};
  if (tid >= kConsumers) {
    produce(p, ring);
    return;
  }

  if (tid < p.B) reinterpret_cast<int*>(smem + kPosOff)[tid] = min(max(p.pos[tid], 0), p.T);
  consumer_sync();
  // Slot 0 the start, slot k + 1 barrier k (the block's finish, its leave), the last slot the end.
  const int slots = 5 * p.L - 1 + (p.has_head ? 1 + p.greedy : 0) + 2;
  unsigned long long* st = p.stamps != nullptr ? p.stamps + (long)blockIdx.x * slots * 2 : nullptr;
  int bar_k = 0;
  if (st != nullptr && tid == 0) st[0] = st[1] = global_ns();
  auto sync = [&]() {
    if (st != nullptr) {
      consumer_sync();
      if (tid == 0) st[2 * (bar_k + 1)] = global_ns();
    }
    grid_barrier(p);
    if (st != nullptr && tid == 0) st[2 * (bar_k + 1) + 1] = global_ns();
    ++bar_k;
  };
  for (int l = 0; l < p.L; ++l) {
    const float* x = l == 0 ? p.x_in : p.x_out;
    matmul(p, ring, kWqkv, l, kSrcRms, x, p.rms_att + (long)l * p.dim, nullptr, l == 0);
    sync();
    attention_phase(p, l);
    sync();
    matmul(p, ring, kWo, l, kSrcAttn, nullptr, nullptr, x, false);
    sync();
    matmul(p, ring, kW13, l, kSrcRms, p.x_out, p.rms_ffn + (long)l * p.dim, nullptr, false);
    sync();
    matmul(p, ring, kW2, l, kSrcSwiglu, nullptr, nullptr, p.x_out, false);
    if (l + 1 < p.L || p.has_head) sync();
  }
  if (p.has_head) {
    matmul(p, ring, kHead, 0, kSrcRms, p.x_out, p.rms_final, nullptr, false);  // the classifier: INT8
    if (p.greedy) {
      sync();
      if (blockIdx.x == 0 && tid < p.B) {
        // Strips hold increasing columns: the first max over strips in order.
        const int b = tid, strips = (p.v_pad + kStrip - 1) / kStrip;
        float bv = -INFINITY;
        int bi = kNoIndex;
        for (int k0 = 0; k0 < strips; k0 += kSumBatch) {
          float v[kSumBatch];
          int ix[kSumBatch];
#pragma unroll
          for (int j = 0; j < kSumBatch; ++j) {
            const int k = min(k0 + j, strips - 1);
            v[j] = __ldcg(p.red_val + (long)k * p.B + b);
            ix[j] = __ldcg(p.red_idx + (long)k * p.B + b);
          }
#pragma unroll
          for (int j = 0; j < kSumBatch; ++j)
            if (better(v[j], ix[j], bv, bi)) bv = v[j], bi = ix[j];
        }
        p.tokens[b] = bi == kNoIndex ? 0 : bi;
      }
    }
  }
  if (st != nullptr) {
    consumer_sync();
    if (tid == 0) st[2 * (slots - 1)] = st[2 * (slots - 1) + 1] = global_ns();
  }
}

const void* kernel() { return reinterpret_cast<const void*>(&decode_megakernel_kernel); }

int set_smem(int smem) {
  static int set = 0;  // the dynamic shared memory the kernel was last allowed
  if (set == smem) return 0;
  const cudaError_t e = cudaFuncSetAttribute(kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) set = smem;
  return (int)e;
}

}  // namespace

// The kernel's fixed layout, for the wrapper's mirror: threads, the mbarrier and scratch bytes
// in front of the ring, the most stages, a TMA box's columns, a stage's scale row stride, the
// activation slots staged at a time, the ring's alignment, sizeof(Params).
extern "C" void decode_megakernel_layout(int* out) {
  out[0] = kThreads;
  out[1] = kBarBytes;
  out[2] = kScratchBytes;
  out[3] = kMaxStages;
  out[4] = kBoxCols;
  out[5] = kScaleStride;
  out[6] = kPiece;
  out[7] = kAlign;
  out[8] = (int)sizeof(Params);
}

// The stages block `block` of a grid of `grid` streams for plan m (codes and scales unused), as
// produce_mat walks them: (strip, split, first code row, code rows, scale groups) each, at most
// `cap`.  Returns their count.  For the tests' check of the wrapper's mirror.
extern "C" int decode_megakernel_stages(const MatPlan* mp, int m, int g, int chunk_rows, int grid, int block, int* out,
                                        int cap) {
  const int gr = group_rows(g, *mp);
  int n = 0;
  for (int it = block; it < items_of(*mp, m); it += grid) {
    const Item t = item_of(*mp, m, it);
    for (int r0 = t.crow0; r0 < t.crow1; r0 += chunk_rows, ++n) {
      const Stage sg = stage_of(t, r0, chunk_rows, gr);
      if (n < cap) {
        int* o = out + 5 * n;
        o[0] = t.si, o[1] = t.ki, o[2] = r0, o[3] = sg.rows, o[4] = sg.ns;
      }
    }
  }
  return n;
}

// The largest cooperative grid of the kernel with `smem` bytes of dynamic shared memory on the
// current device: blocks per SM times the SM count.  Returns a cudaError_t.
extern "C" int decode_megakernel_grid(int smem, int* grid) {
  const void* k = kernel();
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = (cudaError_t)set_smem(smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *grid = per_sm * sms;
  return (int)e;
}

namespace {

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

// The map of a plan's codes: [rows, d] uint8 (every layer's code rows one after another), boxes of
// 128 columns by `box_rows` rows, 128-byte swizzle; a box past the array reads zeros.  Returns 0,
// or the negated CUresult minus one.
int code_map(CUtensorMap* map, const MatPlan& mp, int rows, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)mp.d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)mp.d};
  const cuuint32_t box[2] = {(cuuint32_t)kBoxCols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(mp.codes), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

}  // namespace

// Plain C entry point: one cooperative launch of the whole step on `stream`.  `p` holds device
// pointers, the plans and the ring's layout (the tensor maps are made here); `grid` must not
// exceed decode_megakernel_grid(smem).  A grid that cannot be co-resident is refused by the
// launch (the error is returned, nothing runs).  Returns a cudaError_t, or a tensor map's
// negated CUresult minus one.
extern "C" int decode_megakernel(const Params* p, int grid, int smem, void* stream) {
  const int R = p->chunk_rows;
  if (p->B < 1 || p->B > 8 || (R != 16 && R != 32 && R != 64) || p->n_stages < 2 ||
      p->n_stages > kMaxStages || p->stage_bytes % kAlign ||
      p->stage_bytes < kBoxes * R * kBoxCols + p->scale_slots * kScaleStride ||
      smem < kBarBytes + kScratchBytes + kAlign + p->n_stages * p->stage_bytes)
    return (int)cudaErrorInvalidValue;
  Launch a;
  memcpy(static_cast<Params*>(&a), p, sizeof(Params));
  for (int m = 0; m < (p->has_head ? 5 : 4); ++m) {
    const MatPlan& mp = p->mat[m];
    const int rows = (mp.q4 ? mp.n / 2 : mp.n) * (m == kHead ? 1 : p->L);
    const int e = code_map(&a.maps[m], mp, rows, R);
    if (e) return e;
  }
  const int e = set_smem(smem);
  if (e) return e;
  void* args[] = {&a};
  const cudaError_t le = cudaLaunchCooperativeKernel(kernel(), dim3(grid), dim3(kThreads), args, (size_t)smem,
                                                     reinterpret_cast<cudaStream_t>(stream));
  if (le != cudaSuccess) return (int)le;
  return (int)cudaGetLastError();
}
