// Causal prefill attention over a fresh window for Hopper (sm_90a), any head_dim a multiple of 128.
//
// Replaces the reference package's Pallas kernel
//   qwen3_rs_tpu/ops/pallas/prefill_attention.py::causal_prefill_attention (the splash MQA
//   kernel vmapped over batch and kv heads).
// Output row i attends to window rows j <= i; query head h reads kv head h / kv_mul.
//
// Numerics, as the splash kernel: q is scaled by bf16(1/sqrt(hd)) and rounded to bf16 before the
// scores (the reference scales q in bf16 outside its kernel; here the same two roundings happen
// as q is loaded); scores accumulate in f32; online softmax in f32 (running max, rescaled sums);
// P.V is taken with P in f32.  The tensor cores take bf16, so P is split into
// hi = bf16(P) and lo = bf16(P - hi) and both are multiplied with V (exact in bf16): the part of
// P that neither carries is below 2^-16 of P, far under the output's bf16 rounding.  The output is
// normalised in f32 and rounded to bf16.
//
// Bound on the H100: 4 * (S(S+1)/2) * hd operations per query head (Q.K^T and P.V over the
// causal triangle) at 989 TFLOP/s bf16; the bytes (q, k, v and out, each once) are far fewer.
// Design at head_dim 128 and 256 (a flash-attention forward in Hopper's shape):
//  * one block per (query tile, kv head and group of M query heads, batch row) holds the M
//    heads, 128 query rows in all (128 / M rows per head), so each K/V tile read from device
//    memory serves the M heads.  M is the largest power of two up to 8 that divides kv_mul, so
//    any kv_mul works (3 or 5 read each tile 3 or 5 times);
//  * a producer warp issues TMA loads of K and V tiles (128 rows at head_dim 128, 64 at 256; a
//    4-D tensor map over [B, S, KV, hd], 64-column boxes with 128-byte swizzle; rows past the
//    window read zeros) into a ring of stages (3 at head_dim 128, 2 at 256: 224 and 192 KB with
//    q), with full and empty mbarriers; it gives its registers to the consumers (setmaxnreg
//    40 / 232);
//  * two consumer warpgroups, each with 64 of the block's query rows (warp w holds the rows
//    16 w .. 16 w + 15 of the block, as the heads are packed).  Q, scaled and rounded as it is
//    loaded, is written once into shared memory in wgmma's K-major 128-byte-swizzled layout;
//    S = Q.K^T is one group of wgmma m64n{tile}k16 with both operands in shared memory; the online
//    softmax runs in f32 registers; O += P.V is a group of register-A wgmma m64n{hd}k16 (hi and
//    lo parts of P, each tile's 16 keys) with V read MN-major from the same stage, O in f32
//    registers (64 or 128 a thread);
//  * key tiles past the block's last query row are never loaded; a warpgroup skips the tiles
//    past its own last row; only tiles on the diagonal or past the window's end are masked
//    element by element; the query tiles with the most key tiles are scheduled first.
// Past head_dim 256 one warpgroup's f32 O for 64 rows (hd / 2 registers a thread) no longer fits
// beside its scores, so the output's columns are split over warpgroups that share one S and P
// (namespace wide):
//  * a block takes 64 query rows (M heads, 64 / M rows each) and a slice of at most 384 output
//    columns: hd / 128 column pieces over ceil(pieces / 3) slices (the y axis of the grid), so the
//    scores are computed once a block, once for each slice of the head: once at 384, twice at 512
//    to 768, three times at 896 to 1152 (the 128-column blocks of the kernels this one replaced
//    computed them hd / 128 times).  A fourth P.V warpgroup (a slice of 512) would leave a thread
//    80 registers, too few for its 64 x 128 accumulator;
//  * warpgroup 0 (the S warpgroup) computes S = Q.K^T for a tile of 32 keys over the whole head,
//    band by band: the contraction runs over 64-column bands of K brought by TMA through a ring of
//    4 KB slots (wgmma m64n32k16, both operands in shared memory, one band's products in flight
//    while the next band's are issued), then masks it, runs the online softmax in f32 registers and
//    writes P's hi and lo terms (bf16, K-major, 128-byte swizzle: row r holds hi of the 32 keys,
//    then lo) and each row's rescale factor and running sum into one of two shared P buffers;
//  * one P.V warpgroup for each 128-column piece of the slice keeps that piece of O (64 f32
//    registers a thread), rescales it, and adds P.V with both operands in shared memory (wgmma
//    m64n128k16, P K-major, V MN-major from a V stage that holds the slice's columns of the tile's
//    32 keys); while it does, the S warpgroup already computes the next tile's scores;
//  * a producer warp issues every TMA load: each tile's K bands, then its V stage; up to 4 V stages,
//    so that the K stream seldom waits on the P.V warpgroups (the V stage of tile t waits for their
//    tile t - 4; with 2 stages a tile took 2.5 to 4.5 us on the card); q (scaled and rounded as
//    above) stays in shared memory where it fits (up to head_dim 1280), else the S warpgroup loads
//    q's 64-column band for each band's products.
// wide::plan_of is the block's shape at a head_dim; prefill_attention.wide_plan is the same in
// Python.  Measured and not kept: the S warpgroup issuing the loads itself, with no producer warp,
// so that a fourth P.V warpgroup fits (20 warps at 96 registers; slices of 512, the scores once at
// 512): 1.1 to 2 times slower at every head_dim; one S warpgroup and P.V warpgroups of 256 columns
// do not fit the registers (a P.V warpgroup's 128 accumulators and a fifth warpgroup's share).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (hi, lo) bf16 pairs of two f32 values: hi = bf16(v), lo = bf16(v - hi).
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// Eight bf16 values of q at p, each scaled by q_scale and rounded to bf16.
__device__ __forceinline__ uint4 q_chunk(const __nv_bfloat16* p, float q_scale) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t words[4] = {x.x, x.y, x.z, x.w};
  uint32_t scaled[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
    scaled[e] = pack_bf16(f.x * q_scale, f.y * q_scale);
  }
  return make_uint4(scaled[0], scaled[1], scaled[2], scaled[3]);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A 4-D TMA load of the box at (c0, c1, c2, c3) (innermost first), counted on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, found through the runtime's entry-point query (no link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult r;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &r) == cudaSuccess &&
        r == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of k or v [B, S, KV, hd] bf16: boxes of 64 columns of one kv head's bkv rows, 128-byte
// swizzle; rows past S read zeros.  Returns 0, or the negated CUresult minus one.
int make_kv_map(CUtensorMap* map, const void* base, int B, int S, int KV, int hd, int bkv) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)KV, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * hd, 2ull * hd * KV, 2ull * hd * KV * S};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)bkv, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r - 1;
}

// ------------------------------------------------------- head_dim 128 and 256: TMA and wgmma
namespace hopper {

constexpr int kWarps = 8;
constexpr int kRows = kWarps * 16;                   // query rows per block, all heads of the group
constexpr int kConsumerWarps = 8;                    // two warpgroups of 64 query rows
constexpr int kThreads = kConsumerWarps * 32 + 128;  // and a producer warpgroup

template <int HD>
struct Tile {
  static constexpr int BKV = HD <= 128 ? 128 : 64;  // key rows per K/V tile
  static constexpr int BOXES = HD / 64;           // 64-column (128-byte) boxes of a row
  static constexpr int BOX = BKV * 128;           // one box of a K or V tile
  static constexpr int Q_BYTES = kRows * HD * 2;  // the block's scaled q
  static constexpr int KV_BYTES = BOXES * BOX;    // one K or V tile
  static constexpr int STAGE = 2 * KV_BYTES;
  static constexpr int STAGES = HD <= 128 ? 3 : 2;
  static constexpr int SMEM = Q_BYTES + STAGES * STAGE + 2 * STAGES * 8 + 1024;  // + barriers, alignment
  static_assert(Q_BYTES % 1024 == 0 && BOX % 1024 == 0, "tiles keep the swizzle's alignment");
};

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                         const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int S,
                         int H, int kv_mul, int M, float q_scale) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024-byte grid
  uint8_t* kv = smem + T::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(kv + T::STAGES * T::STAGE);
  uint64_t* empty = full + T::STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bq = kRows / M;  // query rows per head in this block
  const int n_qt = (S + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;  // longest tiles first
  const int groups = kv_mul / M;
  const int kvh = blockIdx.y / groups, b = blockIdx.z;
  const int wph = kWarps / M;  // warps per head
  const int h0 = kvh * kv_mul + (blockIdx.y % groups) * M;
  constexpr int kBkv = T::BKV;
  const int n_kt = (min(S, q0 + bq) + kBkv - 1) / kBkv;  // keys past the last query row: masked
  if (tid == 0) {
    for (int st = 0; st < T::STAGES; ++st) {
      mbar_init(smem_addr(&full[st]), 1);
      mbar_init(smem_addr(&empty[st]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == kConsumerWarps && lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(smem_addr(&empty[stage]), phase ^ 1);
        const uint32_t bar = smem_addr(&full[stage]);
        mbar_expect_tx(bar, T::STAGE);
        const uint32_t st = smem_addr(kv + stage * T::STAGE);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c) {
          tma_load_4d(st + c * T::BOX, &kmap, bar, c * 64, kvh, kt * kBkv, b);
          tma_load_4d(st + T::KV_BYTES + c * T::BOX, &vmap, bar, c * 64, kvh, kt * kBkv, b);
        }
        if (++stage == T::STAGES) stage = 0, phase ^= 1;
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");

  const int wg = warp >> 2, r8 = lane >> 2, t4 = lane & 3;
  const int h = h0 + warp / wph;
  const int r0 = q0 + (warp % wph) * 16;  // this warp's first query row
  const int row_a = r0 + r8, row_b = row_a + 8;

  // The warpgroup's 64 rows of q (row rr is warp 4 wg + rr / 16's row rr % 16), scaled and
  // rounded, in the K-major swizzled layout: box c holds columns 64 c .. 64 c + 63.
  uint8_t* qw = smem + wg * (T::Q_BYTES / 2);
  for (int i = tid & 127; i < 64 * (HD / 8); i += 128) {
    const int rr = i / (HD / 8), ch = i % (HD / 8);
    const int w = 4 * wg + rr / 16;
    const int row = q0 + (w % wph) * 16 + rr % 16;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S) {
      const uint4 x = *reinterpret_cast<const uint4*>(q + (((long)b * S + row) * H + h0 + w / wph) * HD + ch * 8);
      const uint32_t words[4] = {x.x, x.y, x.z, x.w};
      uint32_t scaled[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
        scaled[e] = pack_bf16(f.x * q_scale, f.y * q_scale);
      }
      val = make_uint4(scaled[0], scaled[1], scaled[2], scaled[3]);
    }
    *reinterpret_cast<uint4*>(qw + (ch / 8) * (64 * 128) + rr * 128 + (((ch % 8) ^ (rr & 7)) << 4)) = val;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // q is read by wgmma
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  int wg_last = 0;  // the warpgroup's last query row
#pragma unroll
  for (int wi = 0; wi < 4; ++wi) wg_last = max(wg_last, q0 + ((4 * wg + wi) % wph) * 16 + 15);
  const uint32_t q_base = smem_addr(qw);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  auto stage_of = [](int kt) { return kt % T::STAGES; };
  auto full_wait = [&](int kt) { mbar_wait(smem_addr(&full[stage_of(kt)]), (kt / T::STAGES) & 1); };
  auto release = [&](int kt) {
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[stage_of(kt)]));
  };
  auto k_base = [&](int kt) { return smem_addr(kv + stage_of(kt) * T::STAGE); };

  // S = Q.K^T of tile kt, issued as one group: 64 rows x kBkv keys; n8 chunk i of a thread holds
  // s[4 i + e], row (e & 2 ? row_b : row_a), key kBkv kt + 8 i + 2 t4 + (e & 1).
  auto issue_s = [&](float (&s)[kBkv / 2], int kt) {
#pragma unroll
    for (int i = 0; i < kBkv / 2; ++i) s[i] = 0.f;
    fence_acc(s);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
      wgmma_ss(s, desc_k(q_base + (ks / 4) * (64 * 128) + (ks % 4) * 32),
                   desc_k(k_base(kt) + (ks / 4) * T::BOX + (ks % 4) * 32), ks > 0);
    wg_commit();
  };
  // The causal mask (only where the tile reaches the diagonal or the window's end) and the online
  // softmax of tile kt: each row's kBkv scores sit in the 4 lanes of a quad.  Key 0 lies in the
  // first tile and below every row, so the running max is finite from the first tile on.
  auto softmax = [&](float (&s)[kBkv / 2], int kt, float& alpha_a, float& alpha_b) {
    const int kv0 = kt * kBkv;
    if (kv0 + kBkv - 1 > r0 || kv0 + kBkv > S) {
#pragma unroll
      for (int i = 0; i < kBkv / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + 8 * i + 2 * t4 + (e & 1);
          const int row = (e & 2) ? row_b : row_a;
          if (key > row || key >= S) s[4 * i + e] = -INFINITY;
        }
    }
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int i = 0; i < kBkv / 8; ++i) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int i = 0; i < kBkv / 8; ++i) {
      s[4 * i] = expf(s[4 * i] - mn_a);
      s[4 * i + 1] = expf(s[4 * i + 1] - mn_a);
      s[4 * i + 2] = expf(s[4 * i + 2] - mn_b);
      s[4 * i + 3] = expf(s[4 * i + 3] - mn_b);
      sum_a += s[4 * i] + s[4 * i + 1];
      sum_b += s[4 * i + 2] + s[4 * i + 3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
  };
  // O = alpha O + P.V of tile kt with P as hi + lo bf16 parts, issued as one group: the A
  // fragment of the keys 16 kk .. 16 kk + 15 is the score chunks 2 kk and 2 kk + 1, all built
  // before the group is issued (no other instruction may define a wgmma's registers while it
  // runs).  The previous tile's P.V must be complete.
  auto issue_pv = [&](float (&s)[kBkv / 2], int kt, float alpha_a, float alpha_b) {
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }
    uint32_t hi[kBkv / 16][4], lo[kBkv / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBkv / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
    fence_acc(o);
    wg_fence();
    const uint32_t v_base = k_base(kt) + T::KV_BYTES;
#pragma unroll
    for (int kk = 0; kk < kBkv / 16; ++kk) {
      const uint64_t dv = desc_mn(v_base + kk * 16 * 128, T::BOX);
      wgmma_rs_mn(o, hi[kk], dv);
      wgmma_rs_mn(o, lo[kk], dv);
    }
    wg_commit();
  };

  // The warpgroup's tiles: those up to its last row (the block's later ones only pass by).
  const int n_act = min(n_kt, wg_last / kBkv + 1);
  float alpha_a, alpha_b;
  float sa[kBkv / 2];
  // S, softmax and P.V in turn; the other warpgroup's work runs beside them.
  for (int kt = 0; kt < n_act; ++kt) {
    full_wait(kt);
    issue_s(sa, kt);
    wg_wait0();
    fence_acc(sa);
    softmax(sa, kt, alpha_a, alpha_b);
    issue_pv(sa, kt, alpha_a, alpha_b);
    wg_wait0();
    fence_acc(o);
    release(kt);
  }
  for (int kt = n_act; kt < n_kt; ++kt) {
    full_wait(kt);
    release(kt);
  }

#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = 8 * i + 2 * t4;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_a) * H + h) * HD + col) =
          pack_bf16(o[4 * i] / l_a, o[4 * i + 1] / l_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_b) * H + h) * HD + col) =
          pack_bf16(o[4 * i + 2] / l_b, o[4 * i + 3] / l_b);
  }
}

template <int HD>
int launch(cudaStream_t s, const __nv_bfloat16* qb, const __nv_bfloat16* kb, const __nv_bfloat16* vb,
           __nv_bfloat16* ob, int B, int S, int H, int KV, int kv_mul, int M, float q_scale) {
  using T = Tile<HD>;
  static bool sized = false;  // the attribute is set once per template
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(prefill_attention_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  CUtensorMap km, vm;
  int e = make_kv_map(&km, kb, B, S, KV, HD, T::BKV);
  if (e == 0) e = make_kv_map(&vm, vb, B, S, KV, HD, T::BKV);
  if (e) return e;
  const int bq = kRows / M;
  const dim3 grid((S + bq - 1) / bq, KV * (kv_mul / M), B);
  prefill_attention_kernel<HD><<<grid, kThreads, T::SMEM, s>>>(km, vm, qb, ob, S, H, kv_mul, M, q_scale);
  return 0;
}

}  // namespace hopper

// ------------------------------------------- past head_dim 256: one S a block, P shared
namespace wide {

constexpr int kQRows = 64;                    // query rows a block, all heads of its group
constexpr int kKeys = 32;                     // keys a K/V tile
constexpr int kPieceCols = 128;               // output columns of a P.V warpgroup
constexpr int kMaxPv = 3;  // P.V warpgroups a block: 17 warps leave 96 registers a thread (21 left 80)
constexpr int kBox = kKeys * 128;             // one 64-column box of a K or V tile: 4 KB
constexpr int kQBand = kQRows * 128;          // one 64-column band of q: 8 KB
constexpr int kPBytes = kQRows * 128;         // a P buffer: row r holds P's hi of the 32 keys, then lo
constexpr int kMaxSlots = 16;                 // K ring slots
constexpr int kAlBytes = 2 * 2 * kQRows * 4;  // each P buffer's rescale factors and running sums
constexpr int kMaxVStages = 4;
constexpr int kBarBytes = (2 * kMaxSlots + 2 * kMaxVStages + 4) * 8;
constexpr int kFixed = 1024 + 2 * kPBytes + kAlBytes + kBarBytes;  // + the 1024-byte alignment
constexpr int kSmemMax = 232448;              // a block's shared memory on the H100
constexpr int kMaxThreads = 128 * (1 + kMaxPv) + 32;

// The block's shape at head_dim hd: hd / 128 column pieces over `slices` blocks of npv pieces (the
// last slice's spare P.V warpgroups idle); q resident (qres) where it fits, else q's bands loaded
// band by band; the most V stages (4, 3, 2 or 1) that leave room for 8 K ring slots (4 at two V
// stages or fewer), and as many slots as the rest holds, at most 16.
struct Plan {
  int npv, slices, qres, vstages, kslots, smem;
};

Plan plan_of(int hd) {
  Plan p = {};
  const int pieces = hd / kPieceCols;
  p.slices = (pieces + kMaxPv - 1) / kMaxPv;
  p.npv = (pieces + p.slices - 1) / p.slices;
  const int vbytes = p.npv * 2 * kBox;
  for (int qres = 1; qres >= 0; --qres)
    for (int vst = kMaxVStages; vst >= 1; --vst) {
      const int qbytes = qres ? kQRows * hd * 2 : 2 * kQBand;
      const int fit = (kSmemMax - kFixed - qbytes - vst * vbytes) / kBox;
      const int slots = fit < kMaxSlots ? fit : kMaxSlots;
      if (slots >= (vst > 2 ? 8 : 4)) {
        p.qres = qres;
        p.vstages = vst;
        p.kslots = slots;
        p.smem = kFixed + qbytes + vst * vbytes + slots * kBox;
        return p;
      }
    }
  return p;  // not reached: q's two bands, four V stages and 16 slots take 198 KB
}

__global__ void __launch_bounds__(kMaxThreads, 1)
prefill_wide_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out, int S, int H, int hd,
                    int kv_mul, int M, float q_scale, const Plan p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);  // the swizzle's 1024-byte grid
  const int qbytes = p.qres ? kQRows * hd * 2 : 2 * kQBand;
  const int vbytes = p.npv * 2 * kBox;  // one V stage: the slice's columns of 32 keys
  uint8_t* qs = smem;
  uint8_t* pbuf = qs + qbytes;
  uint8_t* vring = pbuf + 2 * kPBytes;
  uint8_t* kring = vring + p.vstages * vbytes;
  float* al = reinterpret_cast<float*>(kring + p.kslots * kBox);  // [buffer][alpha 64, l 64]
  uint64_t* kfull = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(al) + kAlBytes);
  uint64_t* kempty = kfull + kMaxSlots;
  uint64_t* vfull = kempty + kMaxSlots;
  uint64_t* vempty = vfull + kMaxVStages;
  uint64_t* pfull = vempty + kMaxVStages;
  uint64_t* pempty = pfull + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bq = kQRows / M;  // query rows per head: block row rr is head rr / bq, position q0 + rr % bq
  const int n_qt = (S + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;  // longest tiles first
  const int groups = kv_mul / M;
  const int slice = blockIdx.y % p.slices, hg = blockIdx.y / p.slices;
  const int kvh = hg / groups, b = blockIdx.z;
  const int h0 = kvh * kv_mul + (hg % groups) * M;
  const int col0 = slice * p.npv * kPieceCols;
  const int active = min(p.npv, (hd - col0) / kPieceCols);  // P.V warpgroups with columns
  const int n_kt = (min(S, q0 + bq) + kKeys - 1) / kKeys;
  const int nb = hd / 64;  // K bands of a tile
  const int n_cons = 128 * (1 + p.npv);
  auto q_at = [&](int rr, int col) { return q + (((long)b * S + q0 + rr % bq) * H + h0 + rr / bq) * hd + col; };
  if (tid == 0) {
    for (int i = 0; i < p.kslots; ++i) {
      mbar_init(smem_addr(&kfull[i]), 1);
      mbar_init(smem_addr(&kempty[i]), 4);
    }
    for (int i = 0; i < p.vstages; ++i) {
      mbar_init(smem_addr(&vfull[i]), 1);
      mbar_init(smem_addr(&vempty[i]), 4 * active);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_addr(&pfull[i]), 4);
      mbar_init(smem_addr(&pempty[i]), 4 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == n_cons / 32) {  // the producer: one thread issues every load, each tile's K bands then V
    if (lane == 0) {
      int ks = 0, vs = 0;
      uint32_t kph = 0, vph = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        for (int c = 0; c < nb; ++c) {
          mbar_wait(smem_addr(&kempty[ks]), kph ^ 1);
          mbar_expect_tx(smem_addr(&kfull[ks]), kBox);
          tma_load_4d(smem_addr(kring + ks * kBox), &kmap, smem_addr(&kfull[ks]), c * 64, kvh, kt * kKeys, b);
          if (++ks == p.kslots) ks = 0, kph ^= 1;
        }
        mbar_wait(smem_addr(&vempty[vs]), vph ^ 1);
        mbar_expect_tx(smem_addr(&vfull[vs]), active * 2 * kBox);
        for (int j = 0; j < 2 * active; ++j)
          tma_load_4d(smem_addr(vring + vs * vbytes + j * kBox), &vmap, smem_addr(&vfull[vs]), col0 + j * 64, kvh,
                      kt * kKeys, b);
        if (++vs == p.vstages) vs = 0, vph ^= 1;
      }
    }
    return;
  }

  // q resident: the block's 64 rows, scaled and rounded, K-major and swizzled (band c holds columns
  // 64 c .. 64 c + 63), by every consumer thread.
  if (p.qres) {
    for (int i = tid; i < kQRows * (hd / 8); i += n_cons) {
      const int rr = i / (hd / 8), ch = i % (hd / 8);
      *reinterpret_cast<uint4*>(qs + (ch / 8) * kQBand + rr * 128 + (((ch % 8) ^ (rr & 7)) << 4)) =
          q0 + rr % bq < S ? q_chunk(q_at(rr, ch * 8), q_scale) : make_uint4(0u, 0u, 0u, 0u);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // q is read by wgmma
  }
  asm volatile("bar.sync 1, %0;\n" ::"r"(n_cons) : "memory");
  const int r8 = lane >> 2, t4 = lane & 3;
  const int rr_a = 16 * (warp & 3) + r8, rr_b = rr_a + 8;  // this thread's rows of the block
  const int pos_a = q0 + rr_a % bq, pos_b = q0 + rr_b % bq;
  const uint32_t p_base = smem_addr(pbuf);

  if (warp < 4) {  // the S warpgroup
    const uint32_t q_base = smem_addr(qs), k_base = smem_addr(kring);
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    int ks = 0;
    uint32_t kph = 0;
    auto release = [&](int slot) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&kempty[slot]));
    };
    for (int kt = 0; kt < n_kt; ++kt) {
      // S = Q.K^T of the tile's 32 keys (n8 chunk i of a thread holds s[4 i + e], row (e & 2 ? b : a),
      // key 32 kt + 8 i + 2 t4 + (e & 1)), band by band: band c's products are issued while band
      // c - 1's finish, and c - 1's slot is released once they have.
      float s[kKeys / 2];
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) s[i] = 0.f;
      fence_acc(s);
      int prev = 0;
      for (int c = 0; c < nb; ++c) {
        if (!p.qres) {  // q's band c into buffer c & 1 (band c - 2's products, which read it, are done)
          for (int i = tid; i < kQRows * 8; i += 128) {
            const int rr = i / 8, ch = i % 8;
            *reinterpret_cast<uint4*>(qs + (c & 1) * kQBand + rr * 128 + ((ch ^ (rr & 7)) << 4)) =
                q0 + rr % bq < S ? q_chunk(q_at(rr, c * 64 + ch * 8), q_scale) : make_uint4(0u, 0u, 0u, 0u);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          asm volatile("bar.sync 2, 128;\n" ::: "memory");
        }
        mbar_wait(smem_addr(&kfull[ks]), kph);
        const uint32_t qa = q_base + (p.qres ? c : c & 1) * kQBand, ka = k_base + ks * kBox;
        wg_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) wgmma_ss(s, desc_k(qa + k * 32), desc_k(ka + k * 32), 1);
        wg_commit();
        wg_wait1();
        if (c > 0) release(prev);
        prev = ks;
        if (++ks == p.kslots) ks = 0, kph ^= 1;
      }
      wg_wait0();
      fence_acc(s);
      release(prev);

      // The causal mask (only where the tile reaches the diagonal or the window's end) and the
      // online softmax: each row's 32 scores sit in the 4 lanes of a quad.  Key 0 lies in the first
      // tile and below every row, so the running max is finite from the first tile on.
      const int kv0 = kt * kKeys;
      if (kv0 + kKeys - 1 > q0 || kv0 + kKeys > S) {
#pragma unroll
        for (int i = 0; i < kKeys / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kv0 + 8 * i + 2 * t4 + (e & 1);
            if (key > ((e & 2) ? pos_b : pos_a) || key >= S) s[4 * i + e] = -INFINITY;
          }
      }
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(s[4 * i], s[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o_));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o_));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        s[4 * i] = expf(s[4 * i] - mn_a);
        s[4 * i + 1] = expf(s[4 * i + 1] - mn_a);
        s[4 * i + 2] = expf(s[4 * i + 2] - mn_b);
        s[4 * i + 3] = expf(s[4 * i + 3] - mn_b);
        sum_a += s[4 * i] + s[4 * i + 1];
        sum_b += s[4 * i + 2] + s[4 * i + 3];
      }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
      }
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;

      // P into buffer kt & 1 once the P.V of tile kt - 2 has read it: key 8 i + 2 t4 of row r is
      // element pair (r, 8 i + 2 t4) of hi and (r, 32 + 8 i + 2 t4) of lo, in 128-byte rows whose
      // 16-byte chunks are permuted by r mod 8; then each row's rescale factor and running sum.
      const int pb = kt & 1;
      mbar_wait(smem_addr(&pempty[pb]), ((kt >> 1) & 1) ^ 1);
      uint8_t* pw = pbuf + pb * kPBytes;
#pragma unroll
      for (int i = 0; i < kKeys / 8; ++i) {
        uint32_t hi, lo;
        split_bf16(s[4 * i], s[4 * i + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(pw + rr_a * 128 + ((i ^ (rr_a & 7)) << 4) + 4 * t4) = hi;
        *reinterpret_cast<uint32_t*>(pw + rr_a * 128 + (((4 + i) ^ (rr_a & 7)) << 4) + 4 * t4) = lo;
        split_bf16(s[4 * i + 2], s[4 * i + 3], hi, lo);
        *reinterpret_cast<uint32_t*>(pw + rr_b * 128 + ((i ^ (rr_b & 7)) << 4) + 4 * t4) = hi;
        *reinterpret_cast<uint32_t*>(pw + rr_b * 128 + (((4 + i) ^ (rr_b & 7)) << 4) + 4 * t4) = lo;
      }
      if (t4 == 0) {
        float* a = al + pb * 2 * kQRows;
        a[rr_a] = alpha_a;
        a[rr_b] = alpha_b;
        a[kQRows + rr_a] = l_a;
        a[kQRows + rr_b] = l_b;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // P is read by wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&pfull[pb]));  // one arrival a warp (128 cost ~1 us a tile)
    }
    return;
  }

  // A P.V warpgroup: output columns [col0 + 128 j, col0 + 128 j + 128) of the block's rows.
  const int j = warp / 4 - 1;
  if (j >= active) return;
  float o[kPieceCols / 2];
#pragma unroll
  for (int i = 0; i < kPieceCols / 2; ++i) o[i] = 0.f;
  float l_a = 1.f, l_b = 1.f;
  int vs = 0;
  uint32_t vph = 0;
  const uint32_t v_base = smem_addr(vring) + j * 2 * kBox;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int pb = kt & 1;
    mbar_wait(smem_addr(&pfull[pb]), (kt >> 1) & 1);
    mbar_wait(smem_addr(&vfull[vs]), vph);
    const float* a = al + pb * 2 * kQRows;
    const float alpha_a = a[rr_a], alpha_b = a[rr_b];
    l_a = a[kQRows + rr_a];
    l_b = a[kQRows + rr_b];
#pragma unroll
    for (int i = 0; i < kPieceCols / 8; ++i) {
      o[4 * i] *= alpha_a;
      o[4 * i + 1] *= alpha_a;
      o[4 * i + 2] *= alpha_b;
      o[4 * i + 3] *= alpha_b;
    }
    fence_acc(o);
    wg_fence();
    const uint32_t pa = p_base + pb * kPBytes, va = v_base + vs * vbytes;
#pragma unroll
    for (int t = 0; t < 2; ++t)  // P's hi, then lo: 32 t + 16 k .. of the K index
#pragma unroll
      for (int k = 0; k < 2; ++k) wgmma_ss_mn(o, desc_k(pa + 64 * t + 32 * k), desc_mn(va + k * 16 * 128, kBox));
    wg_commit();
    wg_wait0();
    fence_acc(o);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(smem_addr(&pempty[pb]));
      mbar_arrive(smem_addr(&vempty[vs]));
    }
    if (++vs == p.vstages) vs = 0, vph ^= 1;
  }
  const int head_a = h0 + rr_a / bq, head_b = h0 + rr_b / bq, cb = col0 + j * kPieceCols;
#pragma unroll
  for (int i = 0; i < kPieceCols / 8; ++i) {
    const int col = cb + 8 * i + 2 * t4;
    if (pos_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + pos_a) * H + head_a) * hd + col) =
          pack_bf16(o[4 * i] / l_a, o[4 * i + 1] / l_a);
    if (pos_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + pos_b) * H + head_b) * hd + col) =
          pack_bf16(o[4 * i + 2] / l_b, o[4 * i + 3] / l_b);
  }
}

int launch(cudaStream_t s, const __nv_bfloat16* qb, const __nv_bfloat16* kb, const __nv_bfloat16* vb,
           __nv_bfloat16* ob, int B, int S, int H, int KV, int hd, int kv_mul, int M, float q_scale) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e =
        cudaFuncSetAttribute(prefill_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const Plan p = plan_of(hd);
  CUtensorMap km, vm;
  int e = make_kv_map(&km, kb, B, S, KV, hd, kKeys);
  if (e == 0) e = make_kv_map(&vm, vb, B, S, KV, hd, kKeys);
  if (e) return e;
  const int bq = kQRows / M;
  const dim3 grid((S + bq - 1) / bq, KV * (kv_mul / M) * p.slices, B);
  prefill_wide_kernel<<<grid, 128 * (1 + p.npv) + 32, p.smem, s>>>(km, vm, qb, ob, S, H, hd, kv_mul, M, q_scale, p);
  return 0;
}

}  // namespace wide

}  // namespace

// Plain C entry point.  q [B, S, H, hd], k/v [B, S, KV, hd] and out [B, S, H, hd] are
// contiguous bf16 device pointers; KV divides H; hd is a multiple of 128; q_scale is
// bf16(1/sqrt(hd)) as a float.  Returns cudaGetLastError() (or cudaErrorInvalidValue for an
// argument it does not take, or the error of cudaFuncSetAttribute).
extern "C" int causal_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                        int B, int S, int H, int KV, int hd, float q_scale,
                                        void* stream) {
  if (KV < 1 || H % KV || hd < 128 || hd % 128) return (int)cudaErrorInvalidValue;
  const int kv_mul = H / KV;
  const int M = (kv_mul & -kv_mul) < 8 ? (kv_mul & -kv_mul) : 8;  // query heads per block
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(k);
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(v);
  auto* ob = reinterpret_cast<__nv_bfloat16*>(out);
  int e;
  switch (hd) {
    case 128: e = hopper::launch<128>(s, qb, kb, vb, ob, B, S, H, KV, kv_mul, M, q_scale); break;
    case 256: e = hopper::launch<256>(s, qb, kb, vb, ob, B, S, H, KV, kv_mul, M, q_scale); break;
    default: e = wide::launch(s, qb, kb, vb, ob, B, S, H, KV, hd, kv_mul, M, q_scale);
  }
  if (e) return e;
  return (int)cudaGetLastError();
}

// The past-256 kernel's block shape at head_dim hd (a multiple of 128 past 256) into out[6]: P.V
// warpgroups a block, column slices, q resident (1) or by band (0), V stages, K ring slots, shared
// memory bytes.  Returns 0, or cudaErrorInvalidValue.
extern "C" int causal_prefill_wide_plan(int hd, int* out) {
  if (hd <= 256 || hd % 128) return (int)cudaErrorInvalidValue;
  const wide::Plan p = wide::plan_of(hd);
  const int v[6] = {p.npv, p.slices, p.qres, p.vstages, p.kslots, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}
