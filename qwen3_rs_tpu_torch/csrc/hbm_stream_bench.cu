// The device-memory read stream for Hopper (sm_90a): the exact sum of every byte of a large
// int8 array, each block streaming one contiguous span of it.
//
// Replaces the Pallas kernel of scripts/hbm_stream_bench.py:57 (a grid that streams an int8
// [rows, 8192] array block by block into VMEM and touches a small slice of each block).  On the
// TPU the DMA brings the whole block whatever the kernel reads; on a GPU a byte that is never
// loaded is never read, so this kernel loads and sums every byte, which also makes its result
// checkable: the total equals x.sum(dtype=int64) exactly.
//
// Bound on the H100: the array's bytes at 3.35 TB/s (the data sheet's rate); the summing is
// four dp4a instructions per 16 bytes, far under any compute limit.
// Design:
//  * the bytes each block streams are the counterpart of the TPU block (`block_mb`), a launch
//    argument the probe sweeps;
//  * 16-byte loads, neighbouring threads on neighbouring addresses, 4 loads in flight a thread
//    (a warp reads 2 KB at a time);
//  * a thread sums its bytes in int32 (dp4a against 0x01010101; a thread of a 16 MB span sums
//    2^16 bytes of magnitude at most 128, under 2^31), the block's sum is formed in int64 by warp
//    shuffles and one shared-memory pass, and a second one-block launch adds the blocks'
//    partials in order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;

__device__ __forceinline__ int sum16(const int4& v, int acc) {
  acc = __dp4a(v.x, 0x01010101, acc);
  acc = __dp4a(v.y, 0x01010101, acc);
  acc = __dp4a(v.z, 0x01010101, acc);
  return __dp4a(v.w, 0x01010101, acc);
}

__device__ __forceinline__ long long block_sum(long long v) {
  __shared__ long long part[kThreads / 32];
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  long long t = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) t += part[w];
  return t;
}

// Block b sums the 16-byte words [b * span, min((b + 1) * span, n16)).
__global__ void __launch_bounds__(kThreads)
hbm_stream_kernel(const int4* __restrict__ x, long n16, long span, long long* __restrict__ partial) {
  const long w0 = (long)blockIdx.x * span;
  const long w1 = w0 + span < n16 ? w0 + span : n16;
  int acc = 0;
  long i = w0 + threadIdx.x;
  for (; i + (kInFlight - 1) * kThreads < w1; i += kInFlight * kThreads) {
    int4 v[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) v[j] = __ldcs(x + i + j * kThreads);
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) acc = sum16(v[j], acc);
  }
  for (; i < w1; i += kThreads) acc = sum16(__ldcs(x + i), acc);
  const long long t = block_sum(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = t;
}

// out[0] = the partials' sum, taken in block order by one block.
__global__ void __launch_bounds__(kThreads)
hbm_stream_total_kernel(const long long* __restrict__ partial, int n, long long* __restrict__ out) {
  long long v = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) v += partial[i];
  const long long t = block_sum(v);
  if (threadIdx.x == 0) out[0] = t;
}

}  // namespace

// Plain C entry point.  x: nbytes of int8 (a multiple of 16, 16-byte aligned); span_bytes: the
// bytes each block streams (a multiple of 16, at most 16 MB); partial: ceil(nbytes / span_bytes)
// int64 of scratch; out: one int64, the sum of every byte as a signed value.  Returns
// cudaGetLastError().
extern "C" int hbm_stream(const void* x, long nbytes, long span_bytes, void* partial, void* out,
                          void* stream) {
  if (nbytes <= 0 || nbytes % 16 || span_bytes <= 0 || span_bytes % 16 || span_bytes > (16L << 20))
    return (int)cudaErrorInvalidValue;
  const long blocks = (nbytes + span_bytes - 1) / span_bytes;
  if (blocks > 0x7fffffffL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  auto* p = reinterpret_cast<long long*>(partial);
  hbm_stream_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(reinterpret_cast<const int4*>(x),
                                                         nbytes / 16, span_bytes / 16, p);
  hbm_stream_total_kernel<<<1, kThreads, 0, s>>>(p, (int)blocks, reinterpret_cast<long long*>(out));
  return (int)cudaGetLastError();
}
