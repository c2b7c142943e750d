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
// The wide kernel (head_dim 384 and 512) keeps the same block and online softmax on 8 warps of
// mma.sync m16n8k16 (16 query rows a warp, K/V tiles of 64 rows loaded by all threads, ldmatrix
// fragments), and keeps a thread's registers near those of head_dim 128 this way:
//  * the block's 128 query rows (scaled and rounded as above) sit in dynamic shared memory, and
//    each Q.K^T step reads its Q fragment from there with ldmatrix;
//  * the output is split over column blocks of 128: a block computes the scores over the whole
//    head and P.V for its 128 output columns only, so the scores are computed once for each
//    column block (3 or 4 times; the P.V work is not repeated).  Q (128 x hd), a 64-row K tile
//    (64 x hd) and the V tile's 128 columns take 167 KB at 384 and 212 KB at 512, within the
//    227 KB a block may have after cudaFuncSetAttribute.
// Past 512 the block's Q no longer fits beside a K tile, and the streaming kernel takes the head:
// the wide kernel's block, column blocks and online softmax, but each Q.K^T step of a key tile
// loads a 128-column piece of Q (scaled and rounded as above) and of the K tile into shared
// memory, 68 KB whatever the head.  Q is read once per key tile and column block (from L2): right
// first, fast later.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_wgmma.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block, all heads of the group

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// ------------------------------------------------------- head_dim 128 and 256: TMA and wgmma
namespace hopper {

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

template <int HD>
int launch(const dim3& grid, cudaStream_t s, const __nv_bfloat16* qb, const __nv_bfloat16* kb,
           const __nv_bfloat16* vb, __nv_bfloat16* ob, int B, int S, int H, int KV, int kv_mul, int M,
           float q_scale) {
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
  prefill_attention_kernel<HD><<<grid, kThreads, T::SMEM, s>>>(km, vm, qb, ob, S, H, kv_mul, M, q_scale);
  return 0;
}

}  // namespace hopper

// Output columns per block of the wide kernel.
constexpr int kWideCols = 128;
constexpr int kWideKv = 64;  // key rows per K/V tile of the wide kernel

__host__ __device__ constexpr int wide_smem_bytes(int hd) {
  return 2 * (kRows * (hd + 8) + kWideKv * (hd + 8) + kWideKv * (kWideCols + 8));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_wide_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                              int S, int H, int KV, int kv_mul, int M, float q_scale) {
  constexpr int BKV = kWideKv;
  constexpr int DC = kWideCols;
  constexpr int NC = HD / DC;             // column blocks of the head
  constexpr int Q_STRIDE = HD + 8;        // bf16 per shared Q or K row
  constexpr int V_STRIDE = DC + 8;        // bf16 per shared V row (this block's columns)
  constexpr int kQPieces = HD / 8;        // 16-byte pieces of a Q or K row
  constexpr int kVPieces = DC / 8;
  constexpr int kQLoads = kRows * kQPieces / kThreads;
  constexpr int kKLoads = BKV * kQPieces / kThreads;
  constexpr int kVLoads = BKV * kVPieces / kThreads;
  static_assert(HD % DC == 0 && kKLoads * kThreads == BKV * kQPieces &&
                    kVLoads * kThreads == BKV * kVPieces && kQLoads * kThreads == kRows * kQPieces,
                "tiles are whole loads of every thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kRows * Q_STRIDE;
  __nv_bfloat16* Vs = Ks + BKV * Q_STRIDE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bq = kRows / M;
  const int n_qt = (S + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;  // longest tiles first
  const int groups = kv_mul / M;
  const int cb = blockIdx.y % NC;                    // this block's column block
  const int hg = blockIdx.y / NC;
  const int kvh = hg / groups, b = blockIdx.z;
  const int warps_per_head = kWarps / M;
  const int h0 = kvh * kv_mul + (hg % groups) * M;   // the group's first query head
  const int h = h0 + warp / warps_per_head;
  const int r0 = q0 + (warp % warps_per_head) * 16;
  const int row_a = r0 + (lane >> 2), row_b = row_a + 8;
  const int c0 = cb * DC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // Q of the block's 128 rows (shared row w*16 + i is warp w's row i), scaled and rounded.
#pragma unroll 2
  for (int i = 0; i < kQLoads; ++i) {
    const int id = tid + i * kThreads, lr = id / kQPieces, ch = id % kQPieces;
    const int w = lr / 16;
    const int row = q0 + (w % warps_per_head) * 16 + lr % 16;
    uint4 val = zero;
    if (row < S) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (((long)b * S + row) * H + h0 + w / warps_per_head) * HD + ch * 8);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      uint32_t scaled[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
        scaled[e] = pack_bf16(f.x * q_scale, f.y * q_scale);
      }
      val = make_uint4(scaled[0], scaled[1], scaled[2], scaled[3]);
    }
    *reinterpret_cast<uint4*>(&Qs[lr * Q_STRIDE + ch * 8]) = val;
  }

  float o[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const __nv_bfloat16* qw = Qs + (warp * 16 + (lane & 15)) * Q_STRIDE + (lane >> 4) * 8;

  const int kv_end = min(S, q0 + bq);
  const int n_kt = (kv_end + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kv0 = kt * BKV;
    __syncthreads();  // Q is stored; the previous tile is consumed
#pragma unroll 2
    for (int i = 0; i < kKLoads; ++i) {
      const int id = tid + i * kThreads, r = id / kQPieces, ch = id % kQPieces;
      const int key = kv0 + r;
      *reinterpret_cast<uint4*>(&Ks[r * Q_STRIDE + ch * 8]) =
          key < S ? *reinterpret_cast<const uint4*>(k + (((long)b * S + key) * KV + kvh) * HD + ch * 8)
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < kVLoads; ++i) {
      const int id = tid + i * kThreads, r = id / kVPieces, ch = id % kVPieces;
      const int key = kv0 + r;
      *reinterpret_cast<uint4*>(&Vs[r * V_STRIDE + ch * 8]) =
          key < S ? *reinterpret_cast<const uint4*>(v + (((long)b * S + key) * KV + kvh) * HD + c0 + ch * 8)
                  : zero;
    }
    __syncthreads();

    // Scores of 16 rows x BKV keys over the whole head.
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(smem_addr(qw + ks * 16), a[0], a[1], a[2], a[3]);
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int key = nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(&Ks[key * Q_STRIDE + col]), b0, b1, b2, b3);
        mma_bf16(s[2 * nj], a, b0, b1);
        mma_bf16(s[2 * nj + 1], a, b2, b3);
      }
    }

    if (kv0 + BKV - 1 > r0 || kv0 + BKV > S) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + ni * 8 + (lane & 3) * 2 + (e & 1);
          const int row = (e & 2) ? row_b : row_a;
          if (key > row || key >= S) s[ni][e] = -INFINITY;
        }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      mx_a = fmaxf(mx_a, fmaxf(s[ni][0], s[ni][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[ni][2], s[ni][3]));
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
    for (int ni = 0; ni < BKV / 8; ++ni) {
      s[ni][0] = expf(s[ni][0] - mn_a);
      s[ni][1] = expf(s[ni][1] - mn_a);
      s[ni][2] = expf(s[ni][2] - mn_b);
      s[ni][3] = expf(s[ni][3] - mn_b);
      sum_a += s[ni][0] + s[ni][1];
      sum_b += s[ni][2] + s[ni][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      o[i][0] *= alpha_a;
      o[i][1] *= alpha_a;
      o[i][2] *= alpha_b;
      o[i][3] *= alpha_b;
    }

    // O[:, c0:c0+DC] += P.V[:, c0:c0+DC], P as hi + lo bf16 parts.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nj = 0; nj < DC / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = nj * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(&Vs[key * V_STRIDE + col]), b0, b1, b2, b3);
        mma_bf16(o[2 * nj], hi, b0, b1);
        mma_bf16(o[2 * nj], lo, b0, b1);
        mma_bf16(o[2 * nj + 1], hi, b2, b3);
        mma_bf16(o[2 * nj + 1], lo, b2, b3);
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < DC / 8; ++ni) {
    const int col = c0 + ni * 8 + (lane & 3) * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_a) * H + h) * HD + col) =
          pack_bf16(o[ni][0] / l_a, o[ni][1] / l_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_b) * H + h) * HD + col) =
          pack_bf16(o[ni][2] / l_b, o[ni][3] / l_b);
  }
}

constexpr int kPiece = 128;  // head columns of Q and K per shared-memory piece
constexpr int kStreamSmem = 2 * (kRows * (kPiece + 8) + kWideKv * (kPiece + 8) + kWideKv * (kWideCols + 8));

__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_stream_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v,
                                __nv_bfloat16* __restrict__ out, int S, int H, int KV, int kv_mul,
                                int M, int hd, float q_scale) {
  constexpr int BKV = kWideKv;
  constexpr int DC = kWideCols;
  constexpr int P_STRIDE = kPiece + 8;   // bf16 per shared Q or K row (one piece)
  constexpr int V_STRIDE = DC + 8;
  constexpr int kChunks = kPiece / 8;    // 16-byte chunks of a piece row
  constexpr int kQLoads = kRows * kChunks / kThreads;
  constexpr int kKLoads = BKV * kChunks / kThreads;
  constexpr int kVLoads = BKV * (DC / 8) / kThreads;
  static_assert(kQLoads * kThreads == kRows * kChunks && kKLoads * kThreads == BKV * kChunks &&
                    kVLoads * kThreads == BKV * (DC / 8),
                "tiles are whole loads of every thread");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kRows * P_STRIDE;
  __nv_bfloat16* Vs = Ks + BKV * P_STRIDE;

  const int nc = hd / DC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bq = kRows / M;
  const int n_qt = (S + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;  // longest tiles first
  const int groups = kv_mul / M;
  const int cb = blockIdx.y % nc;
  const int hg = blockIdx.y / nc;
  const int kvh = hg / groups, b = blockIdx.z;
  const int warps_per_head = kWarps / M;
  const int h0 = kvh * kv_mul + (hg % groups) * M;
  const int h = h0 + warp / warps_per_head;
  const int r0 = q0 + (warp % warps_per_head) * 16;
  const int row_a = r0 + (lane >> 2), row_b = row_a + 8;
  const int c0 = cb * DC;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  float o[DC / 8][4];
#pragma unroll
  for (int i = 0; i < DC / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const __nv_bfloat16* qw = Qs + (warp * 16 + (lane & 15)) * P_STRIDE + (lane >> 4) * 8;

  const int kv_end = min(S, q0 + bq);
  const int n_kt = (kv_end + BKV - 1) / BKV;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kv0 = kt * BKV;
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    for (int pc = 0; pc < hd / kPiece; ++pc) {
      __syncthreads();  // the previous piece (and, at piece 0, the previous V tile) is consumed
#pragma unroll 2
      for (int i = 0; i < kQLoads; ++i) {
        const int id = tid + i * kThreads, lr = id / kChunks, ch = id % kChunks;
        const int w = lr / 16;
        const int row = q0 + (w % warps_per_head) * 16 + lr % 16;
        uint4 val = zero;
        if (row < S) {
          const uint4 raw = *reinterpret_cast<const uint4*>(
              q + (((long)b * S + row) * H + h0 + w / warps_per_head) * hd + pc * kPiece + ch * 8);
          const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t scaled[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&words[e]));
            scaled[e] = pack_bf16(f.x * q_scale, f.y * q_scale);
          }
          val = make_uint4(scaled[0], scaled[1], scaled[2], scaled[3]);
        }
        *reinterpret_cast<uint4*>(&Qs[lr * P_STRIDE + ch * 8]) = val;
      }
#pragma unroll
      for (int i = 0; i < kKLoads; ++i) {
        const int id = tid + i * kThreads, r = id / kChunks, ch = id % kChunks;
        const int key = kv0 + r;
        *reinterpret_cast<uint4*>(&Ks[r * P_STRIDE + ch * 8]) =
            key < S ? *reinterpret_cast<const uint4*>(k + (((long)b * S + key) * KV + kvh) * hd + pc * kPiece + ch * 8)
                    : zero;
      }
      if (pc == 0) {
#pragma unroll
        for (int i = 0; i < kVLoads; ++i) {
          const int id = tid + i * kThreads, r = id / (DC / 8), ch = id % (DC / 8);
          const int key = kv0 + r;
          *reinterpret_cast<uint4*>(&Vs[r * V_STRIDE + ch * 8]) =
              key < S ? *reinterpret_cast<const uint4*>(v + (((long)b * S + key) * KV + kvh) * hd + c0 + ch * 8)
                      : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kPiece / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(smem_addr(qw + ks * 16), a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int nj = 0; nj < BKV / 16; ++nj) {
          uint32_t b0, b1, b2, b3;
          const int key = nj * 16 + (lane & 7) + (lane >> 4) * 8;
          const int col = ks * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(smem_addr(&Ks[key * P_STRIDE + col]), b0, b1, b2, b3);
          mma_bf16(s[2 * nj], a, b0, b1);
          mma_bf16(s[2 * nj + 1], a, b2, b3);
        }
      }
    }

    if (kv0 + BKV - 1 > r0 || kv0 + BKV > S) {
#pragma unroll
      for (int ni = 0; ni < BKV / 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kv0 + ni * 8 + (lane & 3) * 2 + (e & 1);
          const int row = (e & 2) ? row_b : row_a;
          if (key > row || key >= S) s[ni][e] = -INFINITY;
        }
    }

    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int ni = 0; ni < BKV / 8; ++ni) {
      mx_a = fmaxf(mx_a, fmaxf(s[ni][0], s[ni][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[ni][2], s[ni][3]));
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
    for (int ni = 0; ni < BKV / 8; ++ni) {
      s[ni][0] = expf(s[ni][0] - mn_a);
      s[ni][1] = expf(s[ni][1] - mn_a);
      s[ni][2] = expf(s[ni][2] - mn_b);
      s[ni][3] = expf(s[ni][3] - mn_b);
      sum_a += s[ni][0] + s[ni][1];
      sum_b += s[ni][2] + s[ni][3];
    }
#pragma unroll
    for (int o_ = 1; o_ < 4; o_ <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o_);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o_);
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int i = 0; i < DC / 8; ++i) {
      o[i][0] *= alpha_a;
      o[i][1] *= alpha_a;
      o[i][2] *= alpha_b;
      o[i][3] *= alpha_b;
    }

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nj = 0; nj < DC / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = nj * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(&Vs[key * V_STRIDE + col]), b0, b1, b2, b3);
        mma_bf16(o[2 * nj], hi, b0, b1);
        mma_bf16(o[2 * nj], lo, b0, b1);
        mma_bf16(o[2 * nj + 1], hi, b2, b3);
        mma_bf16(o[2 * nj + 1], lo, b2, b3);
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < DC / 8; ++ni) {
    const int col = c0 + ni * 8 + (lane & 3) * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_a) * H + h) * hd + col) =
          pack_bf16(o[ni][0] / l_a, o[ni][1] / l_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_b) * H + h) * hd + col) =
          pack_bf16(o[ni][2] / l_b, o[ni][3] / l_b);
  }
}

int launch_stream(const dim3& grid, cudaStream_t s, const __nv_bfloat16* qb, const __nv_bfloat16* kb,
                  const __nv_bfloat16* vb, __nv_bfloat16* ob, int S, int H, int KV, int kv_mul, int M,
                  int hd, float q_scale) {
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(prefill_attention_stream_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, kStreamSmem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 cols(grid.x, grid.y * (hd / kWideCols), grid.z);
  prefill_attention_stream_kernel<<<cols, kThreads, kStreamSmem, s>>>(qb, kb, vb, ob, S, H, KV,
                                                                      kv_mul, M, hd, q_scale);
  return 0;
}

template <int HD>
int launch_wide(const dim3& grid, cudaStream_t s, const __nv_bfloat16* qb, const __nv_bfloat16* kb,
                const __nv_bfloat16* vb, __nv_bfloat16* ob, int S, int H, int KV, int kv_mul, int M,
                float q_scale) {
  constexpr int bytes = wide_smem_bytes(HD);
  static bool sized = false;  // the attribute is set once per template
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(prefill_attention_wide_kernel<HD>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 wide(grid.x, grid.y * (HD / kWideCols), grid.z);
  prefill_attention_wide_kernel<HD><<<wide, kThreads, bytes, s>>>(qb, kb, vb, ob, S, H, KV, kv_mul,
                                                                   M, q_scale);
  return 0;
}

}  // namespace

// Plain C entry point.  q [B, S, H, hd], k/v [B, S, KV, hd] and out [B, S, H, hd] are
// contiguous bf16 device pointers; KV divides H; hd is a multiple of 128; q_scale is
// bf16(1/sqrt(hd)) as a float.  Returns cudaGetLastError() (or cudaErrorInvalidValue for an
// argument it does not take, or the error of cudaFuncSetAttribute).
extern "C" int causal_prefill_attention(const void* q, const void* k, const void* v, void* out,
                                        int B, int S, int H, int KV, int hd, float q_scale,
                                        void* stream) {
  if (KV < 1 || H % KV) return (int)cudaErrorInvalidValue;
  const int kv_mul = H / KV;
  const int M = (kv_mul & -kv_mul) < 8 ? (kv_mul & -kv_mul) : 8;  // query heads per block
  const int bq = kRows / M;
  const dim3 grid((S + bq - 1) / bq, KV * (kv_mul / M), B);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const auto* qb = reinterpret_cast<const __nv_bfloat16*>(q);
  const auto* kb = reinterpret_cast<const __nv_bfloat16*>(k);
  const auto* vb = reinterpret_cast<const __nv_bfloat16*>(v);
  auto* ob = reinterpret_cast<__nv_bfloat16*>(out);
  switch (hd) {
    case 128: {
      const int e = hopper::launch<128>(grid, s, qb, kb, vb, ob, B, S, H, KV, kv_mul, M, q_scale);
      if (e) return e;
      break;
    }
    case 256: {
      const int e = hopper::launch<256>(grid, s, qb, kb, vb, ob, B, S, H, KV, kv_mul, M, q_scale);
      if (e) return e;
      break;
    }
    case 384: {
      const int e = launch_wide<384>(grid, s, qb, kb, vb, ob, S, H, KV, kv_mul, M, q_scale);
      if (e) return e;
      break;
    }
    case 512: {
      const int e = launch_wide<512>(grid, s, qb, kb, vb, ob, S, H, KV, kv_mul, M, q_scale);
      if (e) return e;
      break;
    }
    default: {
      if (hd % kPiece || hd < kPiece) return (int)cudaErrorInvalidValue;
      const int e = launch_stream(grid, s, qb, kb, vb, ob, S, H, KV, kv_mul, M, hd, q_scale);
      if (e) return e;
    }
  }
  return (int)cudaGetLastError();
}


