// The launch-boundary probe's one-call arm for Hopper (sm_90a): y[l] = x . dequant(W[l]) for
// every layer of a stacked INT8-g weight, all layers streamed reps times by one launch.
//
// Replaces the Pallas kernel of scripts/boundary_probe.py:98 (`onecall`: one pallas_call whose
// grid has a leading layer axis over reps*L layers, body qwen3_rs_tpu/ops/pallas/qmatmul.py:480
// `_kernel_stacked`).  The probe sets it against L separate launches of #2 at one row, which run
// the row kernel (csrc/qmatmul_w8a16.cu, row route), eager and in a CUDA graph: the difference
// per layer is the price of a launch boundary.  So this kernel is the row kernel with the
// boundary taken out, and otherwise the same design:
//  * kept from the row kernel: the products on mma.sync with the weights as the A operand and the
//    row zero-padded to n8; the int8 codes made bf16 pairs with no conversion instruction
//    (deq2_i8); a thread's codes loaded straight into registers one 16-slot k-slice ahead with
//    __ldcs; the scale rows brought to shared memory by cp.async; blocks of 128 output columns
//    and 8 warps, each warp a contiguous run of its split's k-slices, three blocks an SM; split
//    sums added by the column strip's last block in split order, counters left at zero;
//  * new, the walk across the boundary: a persistent grid of at most one wave of resident blocks
//    walks units (pass, column strip, split) in that order, pass p being layer p % L and unit u
//    going to block u % grid (probes.py onecall_plan picks the splits so that the L layers' units
//    fill whole waves, onecall_walk mirrors the walk); x is staged once, since every layer reads
//    the same x; a block issues the next unit's scale rows as it starts a unit, and each warp
//    loads the next unit's first code slice as it finishes its run, before the unit's sum is
//    written and merged, so the weight stream does not drain at a unit or layer boundary;
//    partials and counters are indexed by pass, so a fast block on a later pass never touches
//    what the last block of an earlier one is still merging.
//
// Numerics, as #2 ("scale_w"): x is rounded to bf16, each weight element is
// bf16(bf16(code) * bf16(scale)), products accumulate in f32.  Each rep overwrites y[l] with the
// same value (a fixed split plan and summation order), so a launch is deterministic and layer l
// equals #2's within #2's tolerance (another f32 summation order).
//
// Bound on the H100: the bytes of the weights, reps * L * (N*D codes + 2*N*D/g scale bytes), at
// 3.35 TB/s; two flops per code byte are far under the tensor cores' rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlice = 16;                 // contraction slots of a k-slice: one mma k-step
constexpr int kBlockCols = 128;            // output columns of a block: eight m16 tiles
constexpr int kScaleRow = kBlockCols * 2;  // bytes of one group's scales over a block's columns
constexpr int kWalkInts = 6;               // a unit's record: block, layer, columns [c0, c1), rows [r0, r1)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously, through L2 only; past `src_bytes` zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
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

// bf16(code_a * s) | bf16(code_b * s) << 16 for byte k of two words of int8 codes: the byte's
// low 7 bits masked into 0x43nn (128 + nn), its sign into 0xC300 (-128) or 0xC380 (-256), their
// sum the code exactly, then the product rounded once; no conversion instruction.
__device__ __forceinline__ uint32_t deq2_i8(uint32_t wa, uint32_t wb, int k, uint32_t s) {
  const uint32_t p = __byte_perm(wa, wb, k | ((k + 4) << 8));
  const uint32_t t = (p & 0x007F007Fu) | 0x43004300u, c = (p & 0x00800080u) | 0xC300C300u;
  return bf16x2_fma(bf16x2_fma(t, 0x3F803F80u, c), s, 0x80008000u);
}

struct Params {
  const float* x;                // [N] f32
  const uint8_t* codes;          // [L, N, D] int8
  const __nv_bfloat16* scales;   // [L, N/g, D]
  float* y;                      // [L, D]
  float* partial;                // [passes, splits, D] where splits > 1
  int* counters;                 // [passes, strips], zero, left zero
  int* walk;                     // [L * strips * splits, kWalkInts] or null: the first rep's units
  int N, D, g, L, passes, splits, spb, strips, slices, kp, scale_buf;
};

// Unit u of the walk and this warp's run of its k-slices [first, last); its scale groups
// [g0, g0 + ng).
struct Unit {
  int pass, layer, strip, split, s0, ns, first, last, g0, ng;
};

__device__ __forceinline__ Unit unit_of(const Params& p, int u) {
  Unit t;
  const int per_pass = p.strips * p.splits, r = u % per_pass, warp = threadIdx.x >> 5;
  t.pass = u / per_pass;
  t.layer = t.pass % p.L;
  t.strip = r / p.splits;
  t.split = r % p.splits;
  t.s0 = t.split * p.spb;
  t.ns = min(p.slices - t.s0, p.spb);
  const int per = (t.ns + kWarps - 1) / kWarps;
  t.first = t.s0 + min(t.ns, warp * per);
  t.last = t.s0 + min(t.ns, (warp + 1) * per);
  const int groups = p.N / p.g;
  t.g0 = min(kSlice * t.s0 / p.g, groups - 1);
  t.ng = min((kSlice * (t.s0 + t.ns) - 1) / p.g, groups - 1) - t.g0 + 1;
  return t;
}

// Uniform: a thread's four slots of a slice share a group (g % 4 == 0).
template <bool Uniform>
__global__ void __launch_bounds__(kThreads, 3) onecall_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t smem[];  // x as bf16 slots [kp], then two scale buffers
  __shared__ __align__(16) float red[kWarps][kBlockCols];
  __shared__ int last_block;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r8 = lane >> 2, t4 = lane & 3;
  const int total = p.passes * p.strips * p.splits, groups = p.N / p.g;
  const long layer_codes = (long)p.N * p.D, layer_scales = (long)groups * p.D;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* sbuf = smem + 2 * p.kp;

  // The unit's scale rows (zeros past D) into scale buffer buf, as one commit group.
  auto scales_in = [&](const Unit& t, int buf) {
    const int c0 = t.strip * kBlockCols;
    uint8_t* dst = sbuf + buf * p.scale_buf;
    const __nv_bfloat16* src = p.scales + t.layer * layer_scales;
    for (int k = tid; k < t.ng * (kScaleRow / 16); k += kThreads) {
      const int gr = k / (kScaleRow / 16), ch = k % (kScaleRow / 16);
      const bool ok = c0 + 8 * ch < p.D;
      cp_async16(smem_u32(dst + gr * kScaleRow + 16 * ch), src + (long)(t.g0 + gr) * p.D + (ok ? c0 + 8 * ch : 0),
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };
  // The thread's code rows 16 sl + 4 t4 + j of the unit's layer at its 16 columns, 16 bytes each;
  // rows past the weight read as zeros.
  auto load_codes = [&](const Unit& t, int sl, uint4 (&c)[4]) {
    const int col = t.strip * kBlockCols + 16 * r8;
    const uint8_t* base = p.codes + t.layer * layer_codes;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = sl * kSlice + 4 * t4 + j;
      c[j] = col < p.D && row < p.N ? __ldcs(reinterpret_cast<const uint4*>(base + (long)row * p.D + col))
                                    : make_uint4(0u, 0u, 0u, 0u);
    }
  };

  int u = blockIdx.x;
  Unit cur = unit_of(p, u);
  uint4 c[4];
  scales_in(cur, 0);
  if (cur.first < cur.last) load_codes(cur, cur.first, c);
  for (int i = tid; i < p.kp; i += kThreads) xs[i] = __float2bfloat16_rn(i < p.N ? p.x[i] : 0.f);

  float acc[8][4];
  uint32_t su[16];  // Uniform: the current group's scale pairs (s_c, s_c), column c
  for (int i = 0; u < total; u += gridDim.x, ++i) {
    const int nu = u + gridDim.x;
    cp_async_wait_all();
    __syncthreads();  // the unit's scale rows (and x) are in; the last unit's sums are read
    if (nu < total) scales_in(unit_of(p, nu), (i + 1) & 1);
    const uint8_t* sc_rows = sbuf + (i & 1) * p.scale_buf;

    // The 16 bf16 scales of group grp at the thread's columns, as 8 words.
    auto scale_row = [&](int grp, uint32_t (&wds)[8]) {
      const uint4* sp = reinterpret_cast<const uint4*>(sc_rows + (grp - cur.g0) * kScaleRow + 32 * r8);
      const uint4 v0 = sp[0], v1 = sp[1];
      wds[0] = v0.x, wds[1] = v0.y, wds[2] = v0.z, wds[3] = v0.w;
      wds[4] = v1.x, wds[5] = v1.y, wds[6] = v1.z, wds[7] = v1.w;
    };
    auto group = [&](int sl, int j) { return min((sl * kSlice + 4 * t4 + j) / p.g, groups - 1); };
    auto pair = [](const uint32_t (&wa)[8], const uint32_t (&wb)[8], int cc) {
      return __byte_perm(wa[cc >> 1], wb[cc >> 1], (cc & 1) ? 0x7632 : 0x5410);
    };
#pragma unroll
    for (int mt = 0; mt < 8; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;
    int grp_end = -1;  // Uniform: the first slice whose slots leave the current group

    // Slice sl from its codes cw: the B fragment (fragment row 0's lanes), the scales, eight mma.
    auto slice = [&](int sl, const uint4 (&cw)[4]) {
      uint2 bx = make_uint2(0u, 0u);
      if (r8 == 0) bx = *reinterpret_cast<const uint2*>(xs + sl * kSlice + 4 * t4);
      uint32_t w[4][4];  // the words of the thread's four slots, by slot and column word
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j][0] = cw[j].x, w[j][1] = cw[j].y, w[j][2] = cw[j].z, w[j][3] = cw[j].w;
      uint32_t sv[Uniform ? 1 : 4][8];
      if constexpr (Uniform) {
        if (sl >= grp_end) {  // the thread's slot 4 t4 has entered a new group
          const int grp = group(sl, 0);
          scale_row(grp, sv[0]);
#pragma unroll
          for (int cc = 0; cc < 16; ++cc) su[cc] = pair(sv[0], sv[0], cc);
          grp_end = ((grp + 1) * p.g - 4 * t4 + kSlice - 1) / kSlice;
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
          af[e] = deq2_i8(w[jj][q], w[jj + 1][q], k0 + (e & 1), sp);
        }
        mma16816(acc[mt], af, bx.x, bx.y);
      }
    };

    // The warp's run: slice sl's codes are in c; the next load is the run's next slice or, after
    // its last, the next unit's first.
    auto load_next_unit = [&]() {
      if (nu < total) {
        const Unit nx = unit_of(p, nu);
        if (nx.first < nx.last) load_codes(nx, nx.first, c);
      }
    };
    for (int sl = cur.first; sl < cur.last; ++sl) {
      slice(sl, c);
      if (sl + 1 < cur.last) load_codes(cur, sl + 1, c);
      else load_next_unit();
    }
    if (cur.first == cur.last) load_next_unit();

    const int c0 = cur.strip * kBlockCols, oc = c0 + tid;
    if (p.walk != nullptr && tid == 0 && u < p.L * p.strips * p.splits) {
      int* rec = p.walk + (long)u * kWalkInts;
      rec[0] = blockIdx.x, rec[1] = cur.layer, rec[2] = c0, rec[3] = min(c0 + kBlockCols, p.D);
      rec[4] = kSlice * cur.s0, rec[5] = min(kSlice * (cur.s0 + cur.ns), p.N);
    }
    // The warps' sums in warp order: lanes t4 = 0 hold the row's columns 16 r8 + 2 mt (C element
    // 0, fragment row r8) and 16 r8 + 2 mt + 1 (element 2, fragment row r8 + 8).
    if (t4 == 0) {
#pragma unroll
      for (int mt = 0; mt < 8; ++mt) {
        red[warp][16 * r8 + 2 * mt] = acc[mt][0];
        red[warp][16 * r8 + 2 * mt + 1] = acc[mt][2];
      }
    }
    __syncthreads();
    float* yl = p.y + (long)cur.layer * p.D;
    if (tid < kBlockCols && oc < p.D) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][tid];
      if (p.splits == 1) yl[oc] = s;
      else p.partial[((long)cur.pass * p.splits + cur.split) * p.D + oc] = s;
    }
    if (p.splits > 1) {
      // The column strip's last block of the pass to finish sums the splits' partials in split
      // order (the result does not depend on which block that is) and resets the strip's counter.
      int* cnt = p.counters + (long)cur.pass * p.strips + cur.strip;
      __threadfence();
      __syncthreads();
      if (tid == 0) last_block = atomicAdd(cnt, 1) == p.splits - 1;
      __syncthreads();
      if (last_block) {
        __threadfence();
        if (tid < kBlockCols && oc < p.D) {
          const float* pp = p.partial + (long)cur.pass * p.splits * p.D + oc;
          float s = 0.f;
#pragma unroll 4
          for (int k = 0; k < p.splits; ++k) s += __ldcg(pp + (long)k * p.D);
          yl[oc] = s;
        }
        if (tid == 0) *cnt = 0;
      }
    }
    if (nu < total) cur = unit_of(p, nu);
  }
}

// Bytes of a block's dynamic shared memory (probes.py onecall_smem): x's kp bf16 slots, then two
// buffers of the scale rows a unit of spb k-slices touches (at most spb * 16 / g + 2 groups).
int smem_bytes(int N, int spb, int g) {
  const int kp = (N + kSlice - 1) / kSlice * kSlice;
  return 2 * kp + 2 * (((spb * kSlice / g + 2) * kScaleRow + 15) / 16 * 16);
}

template <bool Uniform>
const void* kernel_of() {
  return reinterpret_cast<const void*>(&onecall_kernel<Uniform>);
}

}  // namespace

// Plain C entry point.  x f32 [N], codes int8 [L, N, D], scales bf16 [L, N/g, D], y f32 [L, D],
// all contiguous device pointers; `passes` = reps * L layers are streamed in the order
// 0, 1, .., L-1, 0, ..; splits blocks along the contraction of spb k-slices of 16 rows each
// (a multiple of 8), over `grid` persistent blocks (probes.py onecall_plan).  Where splits > 1,
// `partial` holds passes * splits * D floats and `counters` passes * ceil(D / 128) zero ints (the
// kernel leaves them zero).  `walk`, if not null, gets the first rep's units' records.  N % 8 == 0,
// g divides N, D % 16 == 0.  Returns cudaGetLastError().
extern "C" int boundary_onecall(const void* x, const void* codes, const void* scales, void* y, void* partial,
                                void* counters, void* walk, int N, int D, int g, int L, int passes, int splits,
                                int spb, int grid, void* stream) {
  const int slices = (N + kSlice - 1) / kSlice;
  if (N % 8 || g <= 0 || N % g || D % 16 || L < 1 || passes < 1 || splits < 1 || spb < 8 || spb % kWarps ||
      (splits - 1) * spb >= slices || splits * spb < slices || grid < 1 ||
      (splits > 1 && (partial == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int kp = slices * kSlice;
  const int smem = smem_bytes(N, spb, g);
  const Params p{reinterpret_cast<const float*>(x), reinterpret_cast<const uint8_t*>(codes),
                 reinterpret_cast<const __nv_bfloat16*>(scales), reinterpret_cast<float*>(y),
                 reinterpret_cast<float*>(partial), reinterpret_cast<int*>(counters), reinterpret_cast<int*>(walk),
                 N, D, g, L, passes, splits, spb, (D + kBlockCols - 1) / kBlockCols, slices, kp,
                 (smem - 2 * kp) / 2};
  auto* kernel = g % 4 == 0 ? onecall_kernel<true> : onecall_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, kThreads, smem, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// One-call blocks one SM holds at once with `smem` bytes of dynamic shared memory each (0 if the
// query fails).
extern "C" int boundary_onecall_blocks_per_sm(int uniform, int smem) {
  const void* fn = uniform ? kernel_of<true>() : kernel_of<false>();
  int blocks = 0;
  if (smem > 48 * 1024 &&
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem) != cudaSuccess) return 0;
  return blocks;
}
