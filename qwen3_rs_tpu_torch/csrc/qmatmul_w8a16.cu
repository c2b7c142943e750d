// W8A16 grouped-dequant matmul for Hopper (sm_90a): out = prologue(x) · dequant(W).
//
// Replaces the reference package's Pallas kernels
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas               (2-D weights),
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked       (layer of [L, N, D]),
//   qwen3_rs_tpu/ops/pallas/qmatmul.py::qmatmul_pallas_stacked_fused (+ RMSNorm or SwiGLU
//                                                                    prologue, residual epilogue).
// The layer offset is a pointer offset made by the wrapper, so one kernel covers all three.
// A template parameter picks the code format: int8 codes [N, D], or INT4 codes nibble-packed
// [N/2, D] (the Q4 variant of the same three kernels, qmatmul.py::_dequant_tile_q4 "int"):
// byte row k*g/2 + j of group k holds in-row k*g + j in its low nibble and in-row k*g + g/2 + j
// in its high nibble, each stored as code + 8.
//
// Numerics ("scale_w", as the Pallas kernel): the prologue runs in f32 and the activation is
// rounded to bf16 after it; each weight element is bf16(bf16(code) * bf16(scale)); products
// accumulate in f32.  The residual, when given, is added once, in the last pass.  INT4 codes
// (-8..7) take the same rounding.
//
// Bound on the H100: at decode (B = 1) a call streams every weight byte once and does ~2 flops
// per byte, so it is bound by device-memory bytes (codes N*D, INT4 N*D/2, + bf16 scales 2*N*D/g).
// Three routes, by the window's rows (qmatmul.py route): one row takes the row kernel (below), 2 to
// 8 rows the mma kernel, 9 or more the tensor-core kernel.
//
// The tensor-core route (qmatmul_w8a16_tc, the wrapper's route for windows of 9 or more rows):
// on CUDA cores a window of B rows would read every weight B / 8 times.  Instead a small pass
// (tc::stage_x_kernel) writes the prologue's bf16 activation once, in the kernel's slot order,
// and w8a16_wgmma.cuh's kernel streams each weight byte once for all the rows: wgmma with the
// dequantized weights as the register A operand and the rows as N (64, 128 or 256: the row tile
// the wrapper picks), the contraction split over blocks (tc_plan in the wrapper), the splits
// summed in split order by a second pass (qmatmul_reduce_kernel), which adds the residual;
// unsplit, the residual is added in the store.
//
// The mma route (qmatmul_w8a16_mma, the wrapper's route for windows of MMA_MIN_ROWS to
// TC_MIN_ROWS - 1 rows; it takes 1 to 16): on the CUDA cores every weight element is multiplied
// once per activation row, so a window of 8 rows does 8 times the arithmetic of one row for the
// same bytes.  Here the weights are mma.sync.m16n8k16's A operand (output columns on M, the
// contraction on K) and the window's rows, zero-padded to 8 or 16, its B operand (one or two n8
// tiles): the tensor cores take the products and the CUDA cores only dequantize, once per
// weight element:
//  * a small pass (mma_route::stage_kernel) writes the prologue's bf16 activation once, in the
//    kernel's slot order; the mma kernel is launched as its programmatic dependent, so its
//    blocks start and load their first codes while the pass runs;
//  * a block owns 128 output columns (eight m16 tiles) and a split of the contraction (the
//    plan: qmatmul.py mma_plan); its 8 warps each stream a contiguous run of k-slices of 16
//    slots, and their sums meet in shared memory in a fixed order.  Split, each block writes f32
//    partials and the column strip's last block to finish adds them in split order (with the
//    residual): deterministic, and no second launch;
//  * within a slice the slots and the columns are relabelled so that thread (r8, t4) of a warp
//    (lane = 4 r8 + t4) reads its codes as four 16-byte loads, code rows 4 t4 .. 4 t4 + 3 of the
//    slice by columns 16 r8 .. 16 r8 + 15, and dequantizes them straight into its A fragments:
//    mma k index 2 t + j + 8 h is slot 4 t + 2 h + j of the slice, and fragment row r of m-tile
//    mt is column 16 (r % 8) + 2 mt + r / 8 (qmatmul.py mma_k_slots and mma_cols state the same
//    maps).  The thread's B fragment is then slots 4 t4 .. 4 t4 + 3 of activation row r8, 8
//    bytes, and its results rows 2 t4, 2 t4 + 1 of its own 16 columns;
//  * INT4: slot 2 p + h of the staged order is packed row p's low (h = 0) or high nibble, so a
//    thread's four slots are the two nibbles of two packed rows: two 16-byte loads;
//  * no copy of the weights goes through shared memory: a thread loads its code rows straight
//    into registers, two slices ahead (each slice's loads go out while the one before it is
//    dequantized; on this card that streams faster than a cp.async ring of the same codes), and
//    copies its B fragments with cp.async into a ring of 4 slices of its own;
//  * the dequantization works on bf16 pairs: the codes, exact in bf16, times a pair of bf16
//    scales with one fma.rn.bf16x2, which rounds the exact product once, as bf16(f32 product).
//    INT4 codes become bf16 with a byte permute (0x43nn is 128 + nn) and one bf16x2 fma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "w8a16_wgmma.cuh"

namespace {

__device__ __forceinline__ float load_act(const void* p, int is_bf16, long i) {
  return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                 : reinterpret_cast<const float*>(p)[i];
}

// out = residual + sum over splits of the partials, in split order.
__global__ void qmatmul_reduce_kernel(const float* __restrict__ partial,
                                      const void* __restrict__ residual, int res_bf16,
                                      float* __restrict__ out, int splits, long bd) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= bd) return;
  float s = residual != nullptr ? load_act(residual, res_bf16, i) : 0.f;
  for (int k = 0; k < splits; ++k) s += partial[k * bd + i];
  out[i] = s;
}

}  // namespace

// Plain C entry point of the tensor-core route.  Pointers are device pointers (codes/scales/norm_w
// already offset to the layer); `q4`: codes are nibble-packed [N/2, D] (g even); xs, scratch of
// B * ceil(N / 64) * 64 bf16 for the staged activation.  n_tile is the row tile (64, 128 or 256, at least B); the contraction's k-tiles (64 in-rows)
// go kts to a split; `partial` holds splits * B * D floats when splits > 1.  Returns cudaGetLastError() (or the error of a tensor map, negated).
extern "C" int qmatmul_w8a16_tc(const void* x, int x_bf16, void* xs, const void* codes,
                                const void* scales, const void* norm_w, const void* residual,
                                int res_bf16, void* out, void* partial, int B, int N, int D, int g,
                                int prologue, float eps, int q4, int n_tile, int splits, int kts,
                                void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int kp = (N + tc::kSlots - 1) / tc::kSlots * tc::kSlots;
  auto* xb = reinterpret_cast<__nv_bfloat16*>(xs);
  tc::stage_x(s, x, x_bf16, reinterpret_cast<const float*>(norm_w), prologue, eps, B, N, g, q4, kp, xb);
  CUtensorMap xm, cm;
  const int e = tc::make_maps(&xm, &cm, xb, B, kp, n_tile, codes, q4 ? N / 2 : N, D, q4 != 0);
  if (e) return e;
  const int bd = tc::tile_cols(n_tile);
  auto* o = reinterpret_cast<float*>(out);
  auto* p = reinterpret_cast<float*>(partial);
  const tc::Args a{reinterpret_cast<const __nv_bfloat16*>(scales), D, N / g, g, B, D, 0,
                   (D + bd - 1) / bd, 1, splits, kts, kp / tc::kSlots, splits > 1 ? p : o,
                   residual, res_bf16};
  const bool uniform = g % 64 == 0;
  int rc;
  switch (n_tile) {
    case 64: rc = tc::launch_for<64>(q4 != 0, uniform, xm, cm, a, s); break;
    case 128: rc = tc::launch_for<128>(q4 != 0, uniform, xm, cm, a, s); break;
    case 256: rc = tc::launch_for<256>(q4 != 0, uniform, xm, cm, a, s); break;
    default: rc = (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  if (splits > 1) {
    const long bd_ = (long)B * D;
    qmatmul_reduce_kernel<<<(unsigned)((bd_ + 255) / 256), 256, 0, s>>>(p, residual, res_bf16, o,
                                                                         splits, bd_);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------------- the mma route
namespace {
namespace mma_route {

constexpr int kWarps = 8;          // warps of a block, each streaming a contiguous run of its slices
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;         // contraction slots of a k-slice: one mma k-step
constexpr int kBlockCols = 128;    // output columns of a block: eight m16 tiles
constexpr int kStages = 4;         // a warp's ring of B fragments: three slices ahead
constexpr int kStageSlots = 1024;  // slots a staging block writes

// A warp's ring of B fragments in shared memory: per stage and lane, 8 bytes for each n8 tile,
// each lane's own copy (cp.async writes it and the same lane reads it, so cp.async.wait_group is
// the only wait).  After the loop the warps' sums [8][NR][128] f32 take the block's shared memory.
template <int NT>
struct Ring {
  static constexpr int STAGE = NT * 32 * 8;
  static constexpr int WARP = kStages * STAGE;
  static constexpr int RED = 8 * NT * kWarps * kBlockCols * 4;
  static constexpr int SMEM = kWarps * WARP > RED ? kWarps * WARP : RED;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 8 bytes from global to shared memory, asynchronously; past `src_bytes` zeros.
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a * b + c on bf16 pairs, rounded once (c = -0: the product alone, rounded to bf16).
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// bf16(code_a * sa) | bf16(code_b * sb) << 16 for byte k of two code words, the scale pair
// s = sa | sb << 16 in bf16: the codes (exact in bf16) times the scales, rounded once, as
// bf16(f32(code) * f32(scale)) is (the f32 product is exact).  INT8: words of codes xor 0x80,
// through f32 (the exponent trick); INT4: words of biased nibbles, straight into bf16 (0x43nn is
// 128 + nn).
template <bool Q4>
__device__ __forceinline__ uint32_t deq2(uint32_t wa, uint32_t wb, int k, uint32_t s) {
  if constexpr (Q4) {
    const uint32_t t = (__byte_perm(wa, wb, k | ((k + 4) << 8)) & 0x00FF00FFu) | 0x43004300u;
    return bf16x2_fma(bf16x2_fma(t, 0x3F803F80u, 0xC308C308u), s, 0x80008000u);  // (t - 136) * s
  } else {
    const __nv_bfloat162 c = __floats2bfloat162_rn(tc::code_byte<false>(wa, k), tc::code_byte<false>(wb, k));
    return bf16x2_fma(*reinterpret_cast<const uint32_t*>(&c), s, 0x80008000u);
  }
}

// Slots [1024 blockIdx.y, 1024 blockIdx.y + 1024) of row blockIdx.x of the prologue's bf16
// activation, in the mma kernel's slot order: INT8 slot s is in-row s; INT4 slot 2 p + h is
// packed row p's low (h = 0) or high (h = 1) nibble, in-row (p / (g/2)) g + p % (g/2) + h g/2.
// Slots past N are 0.  The prologue (0 none, 1 RMSNorm with norm_w, 2 SwiGLU of x = gate|up)
// runs in f32 and rounds once to bf16; each block of a row sums its squares over the whole row
// (thread t takes elements t, t + 256, ..., the warps' sums added in warp order).
__global__ void __launch_bounds__(256)
stage_kernel(const void* __restrict__ x, int x_bf16, const float* __restrict__ norm_w, int prologue,
             float eps, int n, int g, int q4, int kp, __nv_bfloat16* __restrict__ xs) {
  __shared__ float red[8];
  __shared__ float inv_s;
  // The mma kernel behind this pass may start now: it reads the staged rows only after its
  // griddepcontrol.wait, which waits for this grid to finish.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int row = blockIdx.x, tid = threadIdx.x;
  const long base = (long)row * (prologue == 2 ? 2L * n : (long)n);
  if (prologue == 1) {
    float ss = 0.f;
#pragma unroll 8
    for (int i = tid; i < n; i += 256) {
      const float v = load_act(x, x_bf16, base + i);
      ss = fmaf(v, v, ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if ((tid & 31) == 0) red[tid >> 5] = ss;
    __syncthreads();
    if (tid == 0) {
      float t = 0.f;
      for (int w = 0; w < 8; ++w) t += red[w];
      inv_s = rsqrtf(t / (float)n + eps);
    }
    __syncthreads();
  }
  const int h = g / 2;
#pragma unroll
  for (int j = 0; j < kStageSlots / 256; ++j) {
    const int s = blockIdx.y * kStageSlots + j * 256 + tid;
    if (s >= kp) break;
    const int p = s >> 1;
    const int in = q4 ? (p / h) * g + p % h + (s & 1) * h : s;
    float v = 0.f;
    if (s < n) {
      v = load_act(x, x_bf16, base + in);
      if (prologue == 2) {
        const float up = load_act(x, x_bf16, base + n + in);
        v = v * (1.f / (1.f + expf(-v))) * up;
      } else if (prologue == 1) {
        v = v * inv_s * norm_w[in];
      }
    }
    xs[(long)row * kp + s] = __float2bfloat16_rn(v);
  }
}

// NT n8 tiles of activation rows (8 NT rows; rows past B read as zeros); Q4: packed INT4 codes;
// Uniform: a thread's four slots of a slice always share a group (INT8: g % 4 == 0; INT4: g / 2
// even).  Two blocks an SM at one n8 tile (128 registers); one at two.
template <int NT, bool Q4, bool Uniform>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
mma_kernel(const uint8_t* __restrict__ codes, const __nv_bfloat16* __restrict__ scales,
           const __nv_bfloat16* __restrict__ xs, const void* residual, int res_bf16, float* __restrict__ out,
           float* __restrict__ partial, int* __restrict__ counters, int B, int N, int D, int g, int kp, int spb) {
  using R = Ring<NT>;
  constexpr int NR = 8 * NT;
  constexpr int KL = Q4 ? 2 : 4;  // 16-byte code loads of a thread per slice
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r8 = lane >> 2, t4 = lane & 3;
  const int s0 = blockIdx.y * spb, ns = min(kp / kSlice - s0, spb);
  const int per = (ns + kWarps - 1) / kWarps;
  const int first = s0 + min(ns, warp * per), last = s0 + min(ns, (warp + 1) * per);  // this warp's slices
  const int col = blockIdx.x * kBlockCols + 16 * r8;  // the thread's 16 columns
  const bool col_ok = col < D;
  const int code_rows = Q4 ? N / 2 : N;
  const int h = g / 2;
  const int groups = N / g;
  uint8_t* ring = smem + warp * R::WARP;
  const uint32_t ring_s = smem_u32(ring);

  // The thread's code rows of slice sl (INT8 rows 16 sl + 4 t4 + j, INT4 packed rows
  // 8 sl + 2 t4 + j), 16 bytes each; rows past the weight read as zeros.
  auto load_codes = [&](int sl, uint4 (&c)[KL]) {
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int row = sl * (Q4 ? kSlice / 2 : kSlice) + KL * t4 + j;
      c[j] = col_ok && row < code_rows ? __ldg(reinterpret_cast<const uint4*>(codes + (long)row * D + col))
                                       : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  // The copy of slots 16 sl + 4 t4 .. + 3 of activation rows r8 and 8 + r8 (zeros past B) into
  // stage st of the ring, as one commit group (empty past the warp's run).
  auto issue_x = [&](int sl, int st) {
    if (sl < last) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = 8 * nt + r8;
        const bool ok = r < B;
        cp_async8(ring_s + st * R::STAGE + (nt * 32 + lane) * 8, xs + (ok ? (long)r * kp + sl * kSlice + 4 * t4 : 0L),
                  ok ? 8 : 0);
      }
    }
    cp_async_commit();
  };
  // The group of the thread's slot j of slice sl.
  auto group = [&](int sl, int j) {
    const int slot = sl * kSlice + 4 * t4 + j;
    return min(Q4 ? (slot >> 1) / h : slot / g, groups - 1);
  };
  // The 16 bf16 scales of group grp at the thread's columns, as 8 words.
  auto scale_row = [&](int grp, uint32_t (&wds)[8]) {
    const uint4* sp = reinterpret_cast<const uint4*>(scales + (long)grp * D + (col_ok ? col : 0));
    const uint4 v0 = __ldg(sp), v1 = __ldg(sp + 1);
    wds[0] = v0.x, wds[1] = v0.y, wds[2] = v0.z, wds[3] = v0.w;
    wds[4] = v1.x, wds[5] = v1.y, wds[6] = v1.z, wds[7] = v1.w;
  };
  // The scale pair of column c from two rows of scale words: row a's in the low half, b's high.
  auto pair = [](const uint32_t (&wa)[8], const uint32_t (&wb)[8], int c) {
    return __byte_perm(wa[c >> 1], wb[c >> 1], (c & 1) ? 0x7632 : 0x5410);
  };

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) acc[nt][mt][0] = acc[nt][mt][1] = acc[nt][mt][2] = acc[nt][mt][3] = 0.f;
  uint32_t su[16];  // Uniform: the current group's scale pairs, (s_c, s_c) for column c
  uint32_t sn[8];   // the next group's scale words, loaded one slice ahead
  int cur_grp = -1, next_grp = -1;
  int stage = 0;

  // Slice sl with its codes c: the B fragments from the ring, the scales, the A fragments, and
  // eight (sixteen) mma.
  auto slice = [&](int sl, const uint4 (&c)[KL]) {
    cp_async_wait<kStages - 2>();  // this thread's copy of slice sl's activation is in
    uint2 bx[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      bx[nt] = *reinterpret_cast<const uint2*>(ring + stage * R::STAGE + (nt * 32 + lane) * 8);
    issue_x(sl + kStages - 1, stage == 0 ? kStages - 1 : stage - 1);  // the stage read last time
    stage = stage + 1 == kStages ? 0 : stage + 1;

    // The words of the thread's four slots (biased codes), by slot and column word.
    uint32_t w[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 v = c[Q4 ? j >> 1 : j];
      const uint32_t raw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) w[j][q] = Q4 ? (raw[q] >> (4 * (j & 1))) & 0x0F0F0F0Fu : raw[q] ^ 0x80808080u;
    }
    uint32_t sv[Uniform ? 1 : 4][8];
    if constexpr (Uniform) {
      const int grp = group(sl, 0);
      if (grp != cur_grp) {
        if (grp != next_grp) scale_row(grp, sn);
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) su[cc] = pair(sn, sn, cc);
        cur_grp = grp;
      }
      const int gn = group(sl + 1, 0);
      if (sl + 1 < last && gn != cur_grp && gn != next_grp) {
        scale_row(gn, sn);
        next_grp = gn;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) scale_row(group(sl, j), sv[j]);
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int q = mt >> 1, k0 = 2 * (mt & 1);  // columns 2 mt, 2 mt + 1: word q, bytes k0, k0 + 1
      uint32_t af[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // fragment (row r8 + 8 (e & 1), slots 4 t4 + 2 (e >> 1) + {0, 1})
        const int cc = 2 * mt + (e & 1), jj = 2 * (e >> 1);
        uint32_t sp;
        if constexpr (Uniform) sp = su[cc];
        else sp = pair(sv[jj], sv[jj + 1], cc);
        af[e] = deq2<Q4>(w[jj][q], w[jj + 1][q], k0 + (e & 1), sp);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma16816(acc[nt][mt], af, bx[nt].x, bx[nt].y);
    }
  };

  // Two slices' codes in flight in registers (each slice's loads go out while the one before it
  // is dequantized), the activation three slices ahead in the ring.  The codes do not depend on
  // the staging pass, so their first loads go out before the wait for it (programmatic
  // dependent launch).
  uint4 ca[KL], cb[KL];
  if (first < last) load_codes(first, ca);
  if (first + 1 < last) load_codes(first + 1, cb);
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) issue_x(first + st, st);
  for (int sl = first; sl < last; sl += 2) {
    slice(sl, ca);
    if (sl + 2 < last) load_codes(sl + 2, ca);
    if (sl + 1 < last) {
      slice(sl + 1, cb);
      if (sl + 3 < last) load_codes(sl + 3, cb);
    }
  }
  cp_async_wait<0>();

  // The k-warps' sums: red[(warp NR + n) 128 + c]; C fragment (rows r8, r8 + 8 of m-tile mt;
  // columns 2 t4, 2 t4 + 1 of n-tile nt) is columns 16 r8 + 2 mt + {0, 1}, rows 8 nt + 2 t4 + {0, 1}.
  __syncthreads();  // every warp is done with its ring
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float* dst = red + (warp * NR + 8 * nt + 2 * t4 + e) * kBlockCols + 16 * r8;
#pragma unroll
      for (int mt = 0; mt < 8; mt += 2)
        *reinterpret_cast<float4*>(dst + 2 * mt) =
            make_float4(acc[nt][mt][e], acc[nt][mt][2 + e], acc[nt][mt + 1][e], acc[nt][mt + 1][2 + e]);
    }
  __syncthreads();
  const int c0 = blockIdx.x * kBlockCols;
  const int splits = gridDim.y;
  for (int o = tid; o < NR * kBlockCols; o += kThreads) {
    const int n = o / kBlockCols, c = o % kBlockCols;
    if (n >= B || c0 + c >= D) continue;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[(k * NR + n) * kBlockCols + c];
    const long idx = (long)n * D + c0 + c;
    if (splits == 1) {
      if (residual != nullptr) s = load_act(residual, res_bf16, idx) + s;
      out[idx] = s;
    } else {
      partial[(long)blockIdx.y * B * D + idx] = s;
    }
  }
  if (splits == 1) return;
  // The column strip's last block to finish sums the splits' partials in split order (the
  // result does not depend on which block that is) and resets the strip's counter.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int o = tid; o < NR * kBlockCols; o += kThreads) {
    const int n = o / kBlockCols, c = o % kBlockCols;
    if (n >= B || c0 + c >= D) continue;
    const long idx = (long)n * D + c0 + c;
    float s = residual != nullptr ? load_act(residual, res_bf16, idx) : 0.f;
    for (int k = 0; k < splits; ++k) s += __ldcg(partial + (long)k * B * D + idx);
    out[idx] = s;
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

template <int NT, bool Q4, bool Uniform>
int launch(const uint8_t* codes, const __nv_bfloat16* scales, const __nv_bfloat16* xs, const void* residual,
           int res_bf16, float* out, float* partial, int* counters, int B, int N, int D, int g, int kp, int spb,
           int splits, cudaStream_t s) {
  auto* kernel = mma_kernel<NT, Q4, Uniform>;
  static bool sized = false;  // the attribute is set once per instance
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Ring<NT>::SMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  // Launched as the staging pass's programmatic dependent: its blocks start while the pass runs.
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kBlockCols - 1) / kBlockCols, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Ring<NT>::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, codes, scales, xs, residual, res_bf16, out, partial, counters, B, N,
                                 D, g, kp, spb);
}

}  // namespace mma_route
}  // namespace

// Plain C entry point of the mma route: the arguments of qmatmul_w8a16 but for its tiling, and
// xs, scratch of B * kp bf16 for the staged activation (kp = N rounded up to 16); B is 1..16
// rows; spb k-slices of 16 slots per block, splits blocks along the contraction; where
// splits > 1, `partial` holds splits * B * D floats and `counters` one zero int per 128-column
// strip (the kernel leaves them zero).  The wrapper guarantees N % 8 == 0, D % 16 == 0, INT4 g
// even.  Returns cudaGetLastError().
extern "C" int qmatmul_w8a16_mma(const void* x, int x_bf16, void* xs, const void* codes, const void* scales,
                                 const void* norm_w, const void* residual, int res_bf16, void* out,
                                 void* partial, void* counters, int B, int N, int D, int g, int prologue,
                                 float eps, int q4, int spb, int splits, void* stream) {
  if (B < 1 || B > 16 || spb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int kp = (N + mma_route::kSlice - 1) / mma_route::kSlice * mma_route::kSlice;
  auto* xb = reinterpret_cast<__nv_bfloat16*>(xs);
  mma_route::stage_kernel<<<dim3(B, (kp + mma_route::kStageSlots - 1) / mma_route::kStageSlots), 256, 0, s>>>(
      x, x_bf16, reinterpret_cast<const float*>(norm_w), prologue, eps, N, g, q4, kp, xb);
  const auto* cq = reinterpret_cast<const uint8_t*>(codes);
  const auto* cs = reinterpret_cast<const __nv_bfloat16*>(scales);
  auto* o = reinterpret_cast<float*>(out);
  auto* p = reinterpret_cast<float*>(partial);
  auto* cnt = reinterpret_cast<int*>(counters);
  const bool uniform = q4 ? (g / 2) % 2 == 0 : g % 4 == 0;
#define MMA_LAUNCH(NT, Q4, U) \
  mma_route::launch<NT, Q4, U>(cq, cs, xb, residual, res_bf16, o, p, cnt, B, N, D, g, kp, spb, splits, s)
  int rc;
  if (B <= 8)
    rc = q4 ? (uniform ? MMA_LAUNCH(1, true, true) : MMA_LAUNCH(1, true, false))
            : (uniform ? MMA_LAUNCH(1, false, true) : MMA_LAUNCH(1, false, false));
  else
    rc = q4 ? (uniform ? MMA_LAUNCH(2, true, true) : MMA_LAUNCH(2, true, false))
            : (uniform ? MMA_LAUNCH(2, false, true) : MMA_LAUNCH(2, false, false));
#undef MMA_LAUNCH
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------------------- the row route
// The route of one activation row (decode at b = 1), one launch a call.  On the CUDA-core kernel
// this route replaced, a row took a second launch to sum its splits, every block summed the squares of the whole
// row in a loop of dependent loads before its first code load, its 8 warps stopped at two barriers
// per 256-row tile, so the weight stream drained at every tile, and at INT4 its dequantization
// took ~6 instructions a weight (more than the byte time of the INT4 projections).  Here:
//  * the products run on mma.sync as in the mma route (the row zero-padded to n8: lanes of fragment
//    row 0 hold the activation, the others zeros), so the CUDA cores only dequantize, on bf16 pairs
//    and with no conversion instruction: INT4 a byte permute and mask to 0x430n (128 + n), one
//    fma.rn.bf16x2 to the code and one to the rounded product; INT8 the byte's low 7 bits masked
//    to 0x43nn and its sign to -128 or -256, one fma.rn.bf16x2 to their sum (the code) and one to
//    the product (~2.5 instructions a weight against ~5 through f32);
//  * a block owns 128 output columns and a split of the contraction (qmatmul.py row_plan: the
//    fewest splits that fill a wave of resident blocks), its 8 warps each a contiguous run of
//    16-slot k-slices; a thread keeps 64 bytes of codes in flight in registers (one INT8 slice, two
//    INT4 slices ahead), so that three blocks fit an SM: on the card more warps to hide the
//    dequantization's latency streamed faster than deeper prefetch in fewer of them (and a per-lane
//    cp.async ring in shared memory, an L2 prefetch of the next slices, and the splits summed in a
//    cluster's shared memory were all slower);
//  * nothing waits before the block's scale rows are on their way to shared memory (cp.async) and
//    its first codes to registers; the RMS of the row is summed (its loads, and the first of the
//    warp's activation slots, out before any is used) while they land;
//  * each warp stages its own run's activation (the prologue applied, rounded to bf16, in slot
//    order) in shared memory, so no barrier stands between the warps after the start;
//  * split, a block writes its 128 f32 partials and the column strip's last block to arrive sums
//    them in split order with the residual (counters left at zero: a CUDA graph can replay it).
namespace {
namespace row_route {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;        // contraction slots of a k-slice: one mma k-step
constexpr int kBlockCols = 128;   // output columns of a block: eight m16 tiles
constexpr int kMaxSpb = 1024;     // k-slices of a block at most (32 KB of staged activation)
constexpr int kScaleRow = kBlockCols * 2;  // bytes of one group's scales over a block's columns
constexpr int kSmemCap = 64 * 1024;        // a block's dynamic shared memory at most (qmatmul.py row_max_spb)

// Code slices a thread keeps in flight in registers: an INT8 slice is 4 loads of 16 bytes, an INT4
// slice 2; 64 bytes a thread either way, so that three blocks fit an SM (85 registers a thread).
// On the card three blocks of one slice ahead streamed faster than two of two slices ahead (more
// warps to hide the dequantization's latency, the same bytes in flight).
template <bool Q4>
__host__ __device__ constexpr int ahead() { return Q4 ? 2 : 1; }

// bf16(code_a * s) | bf16(code_b * s) << 16 for byte k of two words of INT4 nibbles (the low
// nibble of each byte is the code + 8): the nibbles masked into 0x430n (128 + n), (t - 136) exact,
// then the product rounded once.
__device__ __forceinline__ uint32_t deq2_q4(uint32_t wa, uint32_t wb, int k, uint32_t s) {
  const uint32_t t = (__byte_perm(wa, wb, k | ((k + 4) << 8)) & 0x000F000Fu) | 0x43004300u;
  return mma_route::bf16x2_fma(mma_route::bf16x2_fma(t, 0x3F803F80u, 0xC308C308u), s, 0x80008000u);
}

// 16 bytes from global to shared memory, asynchronously, through L2 only; past `src_bytes` zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// bf16(code_a * s) | bf16(code_b * s) << 16 for byte k of two words of int8 codes: the byte's
// low 7 bits masked into 0x43nn (128 + nn), its sign into 0xC300 (-128) or 0xC380 (-256), their
// sum the code exactly, then the product rounded once; no conversion instruction.
__device__ __forceinline__ uint32_t deq2_i8(uint32_t wa, uint32_t wb, int k, uint32_t s) {
  const uint32_t p = __byte_perm(wa, wb, k | ((k + 4) << 8));
  const uint32_t t = (p & 0x007F007Fu) | 0x43004300u, c = (p & 0x00800080u) | 0xC300C300u;
  return mma_route::bf16x2_fma(mma_route::bf16x2_fma(t, 0x3F803F80u, c), s, 0x80008000u);
}

// The groups of a block's slots [16 s0, 16 (s0 + ns)): the first and the count.
__device__ __forceinline__ int2 block_groups(int s0, int ns, int N, int g, bool q4) {
  const int groups = N / g;
  auto grp = [&](int slot) { return min(q4 ? (slot >> 1) / (g / 2) : slot / g, groups - 1); };
  const int first = grp(16 * s0), last = grp(16 * (s0 + ns) - 1);
  return make_int2(first, last - first + 1);
}

__device__ __forceinline__ float act(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float act(const __nv_bfloat16* p, long i) { return __bfloat162float(p[i]); }

// The prologue's inputs for a block: the RMS of the whole row (prologue 1; every block sums the
// squares in the mma route's staging order: thread t takes elements t, t + 256, ..., the warps'
// sums added in warp order), then this warp's slots [16 first, 16 last) of the activation, the
// prologue applied in f32 and rounded to bf16, in slot order (INT4 slot 2 p + hf is packed row p's
// low (hf = 0) or high nibble), into xs from slot 16 s0; slots past N are 0.  A thread's loads go
// out kBatch at a time before any is used, and its first batch of slots before the RMS: a loop of
// dependent loads took several round trips to the cache, while the block's weight stream waited.
template <typename XT>
__device__ __forceinline__ void stage_run(const XT* __restrict__ x, const float* __restrict__ norm_w, int prologue,
                                          float eps, int N, int g, bool q4, int first, int last, int s0,
                                          __nv_bfloat16* xs, float* rms_part) {
  constexpr int kBatch = 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = g / 2, end = kSlice * last, b_first = kSlice * first + lane;
  const int hs = (h & (h - 1)) == 0 ? __ffs(h) - 1 : -1;  // log2(h) where h is a power of two
  float v[kBatch], u[kBatch];
  auto load_batch = [&](int b0) {  // slots b0, b0 + 32, ...: x and the prologue's second input
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = b0 + 32 * j, p = s >> 1;
      const int in = !q4 ? s : hs >= 0 ? ((p >> hs) << (hs + 1)) + (p & (h - 1)) + (s & 1) * h
                                       : (p / h) * g + p % h + (s & 1) * h;
      const bool ok = s < end && s < N;
      v[j] = ok ? act(x, in) : 0.f;
      u[j] = !ok ? 0.f : prologue == 2 ? act(x, (long)N + in) : prologue == 1 ? norm_w[in] : 0.f;
    }
  };
  if (b_first < end) load_batch(b_first);  // the first batch does not wait for the RMS
  float inv = 0.f;
  if (prologue == 1) {
    float ss = 0.f;
    for (int i0 = tid; i0 < N; i0 += kBatch * kThreads) {
      float r[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) r[j] = i0 + j * kThreads < N ? act(x, i0 + j * kThreads) : 0.f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j) ss = fmaf(r[j], r[j], ss);
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) rms_part[warp] = ss;
    __syncthreads();
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += rms_part[w];
    inv = rsqrtf(t / (float)N + eps);
  }
  for (int b0 = b_first; b0 < end; b0 += kBatch * 32) {
    if (b0 != b_first) load_batch(b0);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int s = b0 + 32 * j;
      if (s >= end) break;
      float w = v[j];
      if (prologue == 2) w = w * (1.f / (1.f + expf(-w))) * u[j];
      else if (prologue == 1) w = w * inv * u[j];
      xs[s - kSlice * s0] = __float2bfloat16_rn(w);
    }
  }
}

// One activation row: Q4 packed INT4 codes; Uniform: a thread's four slots of a slice share a group.
template <bool Q4, bool Uniform>
__global__ void __launch_bounds__(kThreads, 3)
row_kernel(const void* __restrict__ x, int x_bf16, const uint8_t* __restrict__ codes,
           const __nv_bfloat16* __restrict__ scales, const float* __restrict__ norm_w, const void* residual,
           int res_bf16, float* __restrict__ out, float* __restrict__ partial, int* __restrict__ counters,
           int N, int D, int g, int prologue, float eps, int kp, int spb) {
  constexpr int R = ahead<Q4>();
  constexpr int KL = Q4 ? 2 : 4;  // 16-byte code loads of a thread per slice
  extern __shared__ __align__(16) uint8_t smem[];  // the block's scale rows, then its staged slots
  __shared__ __align__(16) float red[kWarps][kBlockCols];
  __shared__ float rms_part[kWarps];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r8 = lane >> 2, t4 = lane & 3;
  const int s0 = blockIdx.y * spb, ns = min(kp / kSlice - s0, spb);
  const int per = (ns + kWarps - 1) / kWarps;
  const int first = s0 + min(ns, warp * per), last = s0 + min(ns, (warp + 1) * per);  // this warp's slices
  const int c0 = blockIdx.x * kBlockCols;
  const int col = c0 + 16 * r8;  // the thread's 16 columns
  const bool col_ok = col < D;
  const int code_rows = Q4 ? N / 2 : N;
  const int h = g / 2, groups = N / g;
  const int2 bg = block_groups(s0, ns, N, g, Q4);
  uint8_t* sc_rows = smem;  // [bg.y][128] bf16
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + ((bg.y * kScaleRow + 15) & ~15));

  // The thread's code rows of slice sl (INT8 rows 16 sl + 4 t4 + j, INT4 packed rows
  // 8 sl + 2 t4 + j), 16 bytes each; rows past the weight read as zeros.
  auto load_codes = [&](int sl, uint4 (&c)[KL]) {
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      const int row = sl * (Q4 ? kSlice / 2 : kSlice) + KL * t4 + j;
      c[j] = col_ok && row < code_rows ? __ldcs(reinterpret_cast<const uint4*>(codes + (long)row * D + col))
                                       : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  // 1. The block's scale rows into shared memory, asynchronously (zeros past D), then the first R
  // slices' codes into registers.
  for (int k = tid; k < bg.y * (kScaleRow / 16); k += kThreads) {
    const int gr = k / (kScaleRow / 16), ch = k % (kScaleRow / 16);
    const bool ok = c0 + 8 * ch < D;
    cp_async16(mma_route::smem_u32(sc_rows + gr * kScaleRow + 16 * ch),
               scales + (long)(bg.x + gr) * D + (ok ? c0 + 8 * ch : 0), ok ? 16 : 0);
  }
  mma_route::cp_async_commit();
  uint4 c[R][KL];
#pragma unroll
  for (int j = 0; j < R; ++j)
    if (first + j < last) load_codes(first + j, c[j]);
  // 2. The RMS of the whole row and this warp's slots, while the loads land.
  if (x_bf16)
    stage_run(reinterpret_cast<const __nv_bfloat16*>(x), norm_w, prologue, eps, N, g, Q4, first, last, s0, xs, rms_part);
  else
    stage_run(reinterpret_cast<const float*>(x), norm_w, prologue, eps, N, g, Q4, first, last, s0, xs, rms_part);
  mma_route::cp_async_wait<0>();
  __syncthreads();  // the scale rows are in; each warp's slots were written by its own lanes

  // The 16 bf16 scales of group grp at the thread's columns, as 8 words.
  auto scale_row = [&](int grp, uint32_t (&wds)[8]) {
    const uint4* sp = reinterpret_cast<const uint4*>(sc_rows + (grp - bg.x) * kScaleRow + 32 * r8);
    const uint4 v0 = sp[0], v1 = sp[1];
    wds[0] = v0.x, wds[1] = v0.y, wds[2] = v0.z, wds[3] = v0.w;
    wds[4] = v1.x, wds[5] = v1.y, wds[6] = v1.z, wds[7] = v1.w;
  };
  auto group = [&](int sl, int j) {  // the group of the thread's slot j of slice sl
    const int slot = sl * kSlice + 4 * t4 + j;
    return min(Q4 ? (slot >> 1) / h : slot / g, groups - 1);
  };
  auto pair = [](const uint32_t (&wa)[8], const uint32_t (&wb)[8], int cc) {
    return __byte_perm(wa[cc >> 1], wb[cc >> 1], (cc & 1) ? 0x7632 : 0x5410);
  };

  float acc[8][4];
#pragma unroll
  for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
  uint32_t su[16];  // Uniform: the current group's scale pairs (s_c, s_c), column c
  int grp_end = -1;  // Uniform: the first slice whose slots leave the current group

  // Slice sl from its codes cw: the B fragment (fragment row 0's lanes), the scales, eight mma.
  auto slice = [&](int sl, const uint4 (&cw)[KL]) {
    uint2 bx = make_uint2(0u, 0u);
    if (r8 == 0) bx = *reinterpret_cast<const uint2*>(xs + (sl - s0) * kSlice + 4 * t4);
    uint32_t w[4][4];  // the words of the thread's four slots, by slot and column word
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint4 v = cw[Q4 ? j >> 1 : j];
      const uint32_t raw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q) w[j][q] = Q4 ? raw[q] >> (4 * (j & 1)) : raw[q];
    }
    uint32_t sv[Uniform ? 1 : 4][8];
    if constexpr (Uniform) {
      if (sl >= grp_end) {  // the thread's slot 4 t4 (INT4: packed row 2 t4) has entered a new group
        const int grp = group(sl, 0);
        scale_row(grp, sv[0]);
#pragma unroll
        for (int cc = 0; cc < 16; ++cc) su[cc] = pair(sv[0], sv[0], cc);
        grp_end = Q4 ? ((grp + 1) * h - 2 * t4 + kSlice / 2 - 1) / (kSlice / 2)
                     : ((grp + 1) * g - 4 * t4 + kSlice - 1) / kSlice;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) scale_row(group(sl, j), sv[j]);
    }
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      const int q = mt >> 1, k0 = 2 * (mt & 1);  // columns 2 mt, 2 mt + 1: word q, bytes k0, k0 + 1
      uint32_t af[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // fragment (row r8 + 8 (e & 1), slots 4 t4 + 2 (e >> 1) + {0, 1})
        const int cc = 2 * mt + (e & 1), jj = 2 * (e >> 1);
        uint32_t sp;
        if constexpr (Uniform) sp = su[cc];
        else sp = pair(sv[jj], sv[jj + 1], cc);
        if constexpr (Q4) af[e] = deq2_q4(w[jj][q], w[jj + 1][q], k0 + (e & 1), sp);
        else af[e] = deq2_i8(w[jj][q], w[jj + 1][q], k0 + (e & 1), sp);
      }
      mma_route::mma16816(acc[mt], af, bx.x, bx.y);
    }
  };

  // 3. The run: slice sl's codes sit in register slot (sl - first) % R; each slot is refilled R
  // slices on right after it is used.
  for (int base = first; base < last; base += R) {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int sl = base + j;
      if (sl < last) {
        slice(sl, c[j]);
        if (sl + R < last) load_codes(sl + R, c[j]);
      }
    }
  }

  // 4. The warps' sums in warp order: lanes t4 = 0 hold the row's columns 16 r8 + 2 mt (C element
  // 0, fragment row r8) and 16 r8 + 2 mt + 1 (element 2, fragment row r8 + 8).
  if (t4 == 0) {
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) {
      red[warp][16 * r8 + 2 * mt] = acc[mt][0];
      red[warp][16 * r8 + 2 * mt + 1] = acc[mt][2];
    }
  }
  __syncthreads();
  const int splits = gridDim.y;
  const int oc = c0 + tid;
  if (tid < kBlockCols && oc < D) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    if (splits == 1) {
      if (residual != nullptr) s = load_act(residual, res_bf16, oc) + s;
      out[oc] = s;
    } else {
      partial[(long)blockIdx.y * D + oc] = s;
    }
  }
  if (splits == 1) return;
  // The column strip's last block to finish sums the splits' partials in split order (the result
  // does not depend on which block that is) and resets the strip's counter.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(&counters[blockIdx.x], 1) == splits - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  if (tid < kBlockCols && oc < D) {
    float s = residual != nullptr ? load_act(residual, res_bf16, oc) : 0.f;
#pragma unroll 8
    for (int k = 0; k < splits; ++k) s += __ldcg(partial + (long)k * D + oc);
    out[oc] = s;
  }
  if (tid == 0) counters[blockIdx.x] = 0;
}

// Shared memory of a block of spb slices: its scale rows (at most spb * 16 / g + 2 groups), then
// its staged slots.
__host__ __device__ inline int smem_bytes(int spb, int g) {
  return ((spb * kSlice / g + 2) * kScaleRow + 15) / 16 * 16 + spb * kSlice * 2;
}

template <bool Q4, bool Uniform>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&row_kernel<Q4, Uniform>);
}

template <bool Q4, bool Uniform>
int launch(const void* x, int x_bf16, const uint8_t* codes, const __nv_bfloat16* scales, const float* norm_w,
           const void* residual, int res_bf16, float* out, float* partial, int* counters, int N, int D, int g,
           int prologue, float eps, int kp, int spb, int splits, cudaStream_t s) {
  auto* kernel = row_kernel<Q4, Uniform>;
  const int smem = smem_bytes(spb, g);
  if (smem > kSmemCap) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((D + kBlockCols - 1) / kBlockCols, splits), kThreads, smem, s>>>(
      x, x_bf16, codes, scales, norm_w, residual, res_bf16, out, partial, counters, N, D, g, prologue, eps, kp, spb);
  return 0;
}

}  // namespace row_route
}  // namespace

// Plain C entry point of the row route: one activation row (x [N], [2N] with SwiGLU), the
// arguments of qmatmul_w8a16 but for its tiling: spb k-slices of 16 slots per block (a multiple
// of 8, at most 1024), splits blocks along the contraction; where splits > 1, `partial` holds
// splits * D floats and `counters` one zero int per 128-column strip (the kernel leaves them
// zero).  The wrapper guarantees N % 8 == 0, D % 16 == 0, INT4 g even.  Returns cudaGetLastError().
extern "C" int qmatmul_w8a16_row(const void* x, int x_bf16, const void* codes, const void* scales,
                                 const void* norm_w, const void* residual, int res_bf16, void* out,
                                 void* partial, void* counters, int N, int D, int g, int prologue, float eps,
                                 int q4, int spb, int splits, void* stream) {
  if (spb < 8 || spb % 8 || spb > row_route::kMaxSpb || splits < 1 ||
      (splits > 1 && (counters == nullptr || partial == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int kp = (N + row_route::kSlice - 1) / row_route::kSlice * row_route::kSlice;
  const auto* cq = reinterpret_cast<const uint8_t*>(codes);
  const auto* cs = reinterpret_cast<const __nv_bfloat16*>(scales);
  const auto* nw = reinterpret_cast<const float*>(norm_w);
  auto* o = reinterpret_cast<float*>(out);
  auto* p = reinterpret_cast<float*>(partial);
  auto* cnt = reinterpret_cast<int*>(counters);
  const bool uniform = q4 ? (g / 2) % 2 == 0 : g % 4 == 0;
#define ROW_LAUNCH(Q4, U) \
  row_route::launch<Q4, U>(x, x_bf16, cq, cs, nw, residual, res_bf16, o, p, cnt, N, D, g, prologue, eps, kp, spb, splits, s)
  const int rc = q4 ? (uniform ? ROW_LAUNCH(true, true) : ROW_LAUNCH(true, false))
                    : (uniform ? ROW_LAUNCH(false, true) : ROW_LAUNCH(false, false));
#undef ROW_LAUNCH
  if (rc) return rc;
  return (int)cudaGetLastError();
}

// Row-kernel blocks of an instance one SM holds at once, by registers and static shared memory (0
// if the query fails).
extern "C" int qmatmul_w8a16_row_blocks_per_sm(int q4, int uniform) {
  const void* fn = q4 ? (uniform ? row_route::kernel_of<true, true>() : row_route::kernel_of<true, false>())
                      : (uniform ? row_route::kernel_of<false, true>() : row_route::kernel_of<false, false>());
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, row_route::kThreads, 0) != cudaSuccess) return 0;
  return blocks;
}
