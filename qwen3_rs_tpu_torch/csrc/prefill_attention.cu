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
// Design (a flash-attention forward):
//  * one block per (query tile, kv head and group of M query heads, batch row) holds the M
//    heads, 128 query rows in all (128 / M rows per head), so each K/V tile read from device
//    memory serves the M heads; 8 warps of 16 query rows each.  M is the largest power of two
//    up to 8 that divides kv_mul, so any kv_mul works (3 or 5 read each tile 3 or 5 times);
//  * K/V tiles of 64 rows in shared memory (rows padded by 16 bytes: ldmatrix without bank
//    conflicts), mma.sync m16n8k16 for Q.K^T and for P.V, the score tile and the output
//    accumulator in registers;
//  * head_dim is a template parameter.  At 256 the K/V tiles hold 32 rows, so that both fit the
//    48 KB of static shared memory; the Q fragments and the output accumulator double, to 192
//    registers a thread.  Wider heads (384, 512) would need 288 and 384 registers a thread this
//    way, past the 255 a thread may use, so they take the wide kernel below;
//  * key tiles past the block's last query row are never visited (fully masked), only tiles on
//    the diagonal or past the window's end are masked element by element;
//  * the query tiles with the most key tiles are scheduled first.
// The wide kernel (head_dim 384 and 512) keeps the same block, warps and online softmax, with two
// changes that keep a thread's registers near those of head_dim 128:
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;  // query rows per block, all heads of the group

// Key rows per K/V tile: both tiles stay within 48 KB of static shared memory.
__host__ __device__ constexpr int kv_tile(int hd) { return hd <= 128 ? 64 : 32; }

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

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                         int S, int H, int KV, int kv_mul, int M, float q_scale) {
  constexpr int BKV = kv_tile(HD);        // key rows per tile
  constexpr int KV_STRIDE = HD + 8;       // bf16 per shared K/V row
  constexpr int kPieces = HD / 8;         // 16-byte pieces of a K/V row
  constexpr int kLoads = BKV * kPieces / kThreads;
  static_assert(kLoads * kThreads == BKV * kPieces, "a K/V tile is whole loads of every thread");
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV * KV_STRIDE];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV * KV_STRIDE];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bq = kRows / M;  // query rows per head in this block
  const int n_qt = (S + bq - 1) / bq;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * bq;  // longest tiles first
  const int groups = kv_mul / M;
  const int kvh = blockIdx.y / groups, b = blockIdx.z;
  const int warps_per_head = kWarps / M;
  const int h = kvh * kv_mul + (blockIdx.y % groups) * M + warp / warps_per_head;
  const int r0 = q0 + (warp % warps_per_head) * 16;  // this warp's first query row
  const int row_a = r0 + (lane >> 2), row_b = row_a + 8;  // this thread's two rows

  // Q fragments of the warp's 16 rows x HD, scaled and rounded to bf16 as they are loaded.
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (r & 1) ? row_b : row_a;
      const int col = ks * 16 + (lane & 3) * 2 + ((r & 2) ? 8 : 0);
      uint32_t val = 0u;
      if (row < S) {
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(
            q + (((long)b * S + row) * H + h) * HD + col);
        const float2 f = __bfloat1622float2(x2);
        val = pack_bf16(f.x * q_scale, f.y * q_scale);
      }
      qf[ks][r] = val;
    }
  }

  float o[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  const int kv_end = min(S, q0 + bq);  // keys past the block's last query row are all masked
  const int n_kt = (kv_end + BKV - 1) / BKV;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int kv0 = kt * BKV;
    __syncthreads();  // the previous tile is consumed
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int id = tid + i * kThreads, r = id / kPieces, ch = id % kPieces;
      const int key = kv0 + r;
      const long src = (((long)b * S + key) * KV + kvh) * HD + ch * 8;
      *reinterpret_cast<uint4*>(&Ks[r * KV_STRIDE + ch * 8]) =
          key < S ? *reinterpret_cast<const uint4*>(k + src) : zero;
      *reinterpret_cast<uint4*>(&Vs[r * KV_STRIDE + ch * 8]) =
          key < S ? *reinterpret_cast<const uint4*>(v + src) : zero;
    }
    __syncthreads();

    // Scores of 16 rows x BKV keys.
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
#pragma unroll
      for (int nj = 0; nj < BKV / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int key = nj * 16 + (lane & 7) + (lane >> 4) * 8;
        const int col = ks * 16 + ((lane >> 3) & 1) * 8;
        ldsm_x4(smem_addr(&Ks[key * KV_STRIDE + col]), b0, b1, b2, b3);
        mma_bf16(s[2 * nj], qf[ks], b0, b1);
        mma_bf16(s[2 * nj + 1], qf[ks], b2, b3);
      }
    }

    // Causal mask and the window's end, only where the tile reaches them.
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

    // Online softmax: each row's BKV scores sit in the 4 lanes of a quad.
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
    // Key 0 lies in the first tile and below every row, so the running max is finite from
    // the first tile on.
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
    for (int i = 0; i < HD / 8; ++i) {
      o[i][0] *= alpha_a;
      o[i][1] *= alpha_a;
      o[i][2] *= alpha_b;
      o[i][3] *= alpha_b;
    }

    // O += P.V, P as hi + lo bf16 parts; the score accumulators' layout is the A operand's.
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int nj = 0; nj < HD / 16; ++nj) {
        uint32_t b0, b1, b2, b3;
        const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = nj * 16 + (lane >> 4) * 8;
        ldsm_x4_trans(smem_addr(&Vs[key * KV_STRIDE + col]), b0, b1, b2, b3);
        mma_bf16(o[2 * nj], hi, b0, b1);
        mma_bf16(o[2 * nj], lo, b0, b1);
        mma_bf16(o[2 * nj + 1], hi, b2, b3);
        mma_bf16(o[2 * nj + 1], lo, b2, b3);
      }
    }
  }

#pragma unroll
  for (int ni = 0; ni < HD / 8; ++ni) {
    const int col = ni * 8 + (lane & 3) * 2;
    if (row_a < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_a) * H + h) * HD + col) =
          pack_bf16(o[ni][0] / l_a, o[ni][1] / l_a);
    if (row_b < S)
      *reinterpret_cast<uint32_t*>(out + (((long)b * S + row_b) * H + h) * HD + col) =
          pack_bf16(o[ni][2] / l_b, o[ni][3] / l_b);
  }
}

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
    case 128: prefill_attention_kernel<128><<<grid, kThreads, 0, s>>>(qb, kb, vb, ob, S, H, KV, kv_mul, M, q_scale); break;
    case 256: prefill_attention_kernel<256><<<grid, kThreads, 0, s>>>(qb, kb, vb, ob, S, H, KV, kv_mul, M, q_scale); break;
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
