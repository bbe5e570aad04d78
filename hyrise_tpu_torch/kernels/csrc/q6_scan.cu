// Fused TPC-H Q6 scans for Hopper (sm_90a), behind a plain C interface that
// hyrise_tpu_torch/kernels/q6.py loads with ctypes.
//
// q6_scan_f32 replaces hyrise_tpu/kernels/pallas_scan.py
// _q6_scan_tile_kernel_v2, the body of both q6_pallas and q6_pallas_chain:
// over the dense columns (int32 shipdate codes; float32 discount, quantity
// and extendedprice; uint8 live) it sums price * discount in float32 under
//   live && lo <= ship < hi && 0.05f <= disc <= 0.07001f && qty < 24.0f.
// q6_encoded_i64 replaces the XLA body of hyrise_tpu/kernels/q6.py
// q6_encoded_chain: the same predicate over encoded columns (int16 shipdate
// codes, int8 discount cents, int8 integral quantity, int32 price cents),
// with an int32 product per row and an exact int64 sum.
//
// What bounds them: device-memory bytes. Each row costs a handful of
// compares and one multiply against 17 bytes read (q6_scan_f32) or 8 bytes
// (q6_encoded_i64), far below the card's operations-per-byte balance. So
// the design only keeps wide loads in flight: a grid-stride loop over rows
// with enough 256-thread blocks to fill every SM, 16-byte vector loads when
// every column is aligned for them and a scalar loop for the ragged tail
// (base tables are unpadded, so no length is a multiple of anything). Each
// block reduces through warp shuffles into one partial. No atomics touch a
// sum, so every run gives the same result for the same launch shape.
// - q6_scan_f32 writes its partials; the caller sums them in float64.
// - q6_encoded_i64 is one kernel a call: 16 rows a thread a step, all eight
//   16-byte loads of a step (two of codes, one of cents, one of quantity,
//   four of prices) issued before any compare, at 2 resident blocks an SM;
//   the last block to take a ticket after a __threadfence folds the
//   partials into the int64 result and puts the ticket back to 0.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEncodedRows = 16;        // q6_encoded_i64: rows a thread a step
constexpr int kEncodedBlocksPerSm = 2;  // its resident blocks an SM

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// Sum of v over the block; the result is valid in thread 0.
template <typename T>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_partials[kWarps];
  v = warp_sum(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_partials[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_partials[lane] : T(0);
    v = warp_sum(v);
  }
  return v;
}

__device__ __forceinline__ float q6_f32_row(int ship, float disc, float qty,
                                            float price, unsigned char live,
                                            int lo, int hi) {
  const bool keep = live != 0 && ship >= lo && ship < hi && disc >= 0.05f &&
                    disc <= 0.07001f && qty < 24.0f;
  // __fmul_rn keeps the product rounded on its own, as in the TPU kernel,
  // instead of letting the compiler contract it into an FMA with the sum.
  return keep ? __fmul_rn(price, disc) : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
q6_scan_f32_kernel(const int* __restrict__ ship, const float* __restrict__ disc,
                   const float* __restrict__ qty,
                   const float* __restrict__ price,
                   const unsigned char* __restrict__ live, long long n, int lo,
                   int hi, float* __restrict__ partials) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  float acc = 0.0f;
  long long tail = 0;
  const uintptr_t wide = reinterpret_cast<uintptr_t>(ship) |
                         reinterpret_cast<uintptr_t>(disc) |
                         reinterpret_cast<uintptr_t>(qty) |
                         reinterpret_cast<uintptr_t>(price);
  if ((wide & 15) == 0 && (reinterpret_cast<uintptr_t>(live) & 3) == 0) {
    const long long n4 = n / 4;
    const int4* ship4 = reinterpret_cast<const int4*>(ship);
    const float4* disc4 = reinterpret_cast<const float4*>(disc);
    const float4* qty4 = reinterpret_cast<const float4*>(qty);
    const float4* price4 = reinterpret_cast<const float4*>(price);
    const uchar4* live4 = reinterpret_cast<const uchar4*>(live);
    for (long long i = tid; i < n4; i += stride) {
      const int4 s = ship4[i];
      const float4 d = disc4[i];
      const float4 q = qty4[i];
      const float4 p = price4[i];
      const uchar4 l = live4[i];
      acc += q6_f32_row(s.x, d.x, q.x, p.x, l.x, lo, hi);
      acc += q6_f32_row(s.y, d.y, q.y, p.y, l.y, lo, hi);
      acc += q6_f32_row(s.z, d.z, q.z, p.z, l.z, lo, hi);
      acc += q6_f32_row(s.w, d.w, q.w, p.w, l.w, lo, hi);
    }
    tail = n4 * 4;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    acc += q6_f32_row(ship[i], disc[i], qty[i], price[i], live[i], lo, hi);
  }
  const float total = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

__device__ __forceinline__ long long q6_encoded_row(int ship, int disc_cents,
                                                    int qty, int price_cents,
                                                    int lo, unsigned span) {
  // lo <= ship < lo + span and 5 <= disc_cents <= 7, each as one unsigned compare
  const bool keep = static_cast<unsigned>(ship - lo) < span &&
                    static_cast<unsigned>(disc_cents - 5) < 3u && qty < 24;
  // int32 product with two's-complement wrap, as the XLA form computes it
  const int prod = static_cast<int>(static_cast<unsigned>(price_cents) *
                                    static_cast<unsigned>(disc_cents));
  return keep ? static_cast<long long>(prod) : 0LL;
}

__global__ void __launch_bounds__(kThreads, kEncodedBlocksPerSm)
q6_encoded_i64_kernel(const int16_t* __restrict__ ship,
                      const int8_t* __restrict__ disc_cents,
                      const int8_t* __restrict__ qty,
                      const int32_t* __restrict__ price_cents, long long n,
                      int lo, unsigned span, long long* __restrict__ partials,
                      unsigned* __restrict__ ticket, long long* __restrict__ out) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long acc = 0;
  long long tail = 0;
  const uintptr_t columns = reinterpret_cast<uintptr_t>(ship) |
                            reinterpret_cast<uintptr_t>(disc_cents) |
                            reinterpret_cast<uintptr_t>(qty) |
                            reinterpret_cast<uintptr_t>(price_cents);
  if ((columns & 15) == 0) {
    // kEncodedRows rows a step: 32 bytes of codes, 16 + 16 bytes of cents and
    // quantity, 64 bytes of prices, all eight 16-byte loads issued first
    const long long steps = n / kEncodedRows;
    const uint4* ship4 = reinterpret_cast<const uint4*>(ship);
    const uint4* disc4 = reinterpret_cast<const uint4*>(disc_cents);
    const uint4* qty4 = reinterpret_cast<const uint4*>(qty);
    const int4* price4 = reinterpret_cast<const int4*>(price_cents);
    for (long long i = tid; i < steps; i += stride) {
      const uint4 s0 = __ldcs(ship4 + 2 * i);
      const uint4 s1 = __ldcs(ship4 + 2 * i + 1);
      const uint4 d = __ldcs(disc4 + i);
      const uint4 q = __ldcs(qty4 + i);
      const int4 p0 = __ldcs(price4 + 4 * i);
      const int4 p1 = __ldcs(price4 + 4 * i + 1);
      const int4 p2 = __ldcs(price4 + 4 * i + 2);
      const int4 p3 = __ldcs(price4 + 4 * i + 3);
      const unsigned s_words[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      const unsigned d_words[4] = {d.x, d.y, d.z, d.w};
      const unsigned q_words[4] = {q.x, q.y, q.z, q.w};
      const int prices[kEncodedRows] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                                        p2.x, p2.y, p2.z, p2.w, p3.x, p3.y, p3.z, p3.w};
#pragma unroll
      for (int k = 0; k < kEncodedRows; ++k) {
        const int sk = static_cast<int16_t>(s_words[k >> 1] >> (16 * (k & 1)));
        const int dk = static_cast<int8_t>(d_words[k >> 2] >> (8 * (k & 3)));
        const int qk = static_cast<int8_t>(q_words[k >> 2] >> (8 * (k & 3)));
        acc += q6_encoded_row(sk, dk, qk, prices[k], lo, span);
      }
    }
    tail = steps * kEncodedRows;
  }
  for (long long i = tail + tid; i < n; i += stride) {
    acc += q6_encoded_row(ship[i], disc_cents[i], qty[i], price_cents[i], lo,
                          span);
  }
  // one partial a block; the last block to take a ticket (after a fence that
  // publishes its partial) folds them all and puts the ticket back to 0
  __shared__ bool is_last;
  const long long total = block_sum(acc);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();
    is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  long long sum = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) sum += __ldcg(partials + b);
  sum = block_sum(sum);
  if (threadIdx.x == 0) {
    *out = sum;
    *ticket = 0u;
  }
}

}  // namespace

extern "C" {

int q6_threads_per_block() { return kThreads; }

// Each entry point launches on `stream` and returns cudaGetLastError(), so a
// refused launch is reported to the caller; it does not synchronise.
int q6_scan_f32(const void* ship, const void* disc, const void* qty,
                const void* price, const void* live, long long n, int lo,
                int hi, void* partials, int blocks, void* stream) {
  q6_scan_f32_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ship), static_cast<const float*>(disc),
      static_cast<const float*>(qty), static_cast<const float*>(price),
      static_cast<const unsigned char*>(live), n, lo, hi,
      static_cast<float*>(partials));
  return static_cast<int>(cudaGetLastError());
}

// The total over all n rows into *out (int64), in one kernel: `partials`
// holds `blocks` int64 of scratch, `ticket` a zeroed 32-bit word that the
// launch leaves at 0 (launches sharing it run one after another).
int q6_encoded_i64(const void* ship, const void* disc_cents, const void* qty,
                   const void* price_cents, long long n, int lo, int hi,
                   void* partials, void* ticket, void* out, int blocks,
                   void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned span = hi > lo ? static_cast<unsigned>(hi - lo) : 0u;
  q6_encoded_i64_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(ship),
      static_cast<const int8_t*>(disc_cents), static_cast<const int8_t*>(qty),
      static_cast<const int32_t*>(price_cents), n, lo, span,
      static_cast<long long*>(partials), static_cast<unsigned*>(ticket),
      static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

int q6_encoded_rows_per_step() { return kEncodedRows; }
int q6_encoded_blocks_per_sm() { return kEncodedBlocksPerSm; }

}  // extern "C"
