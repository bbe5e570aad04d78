// Join kernels for Hopper (sm_90a), behind a plain C interface that
// hyrise_tpu_torch/kernels/join_probe.py loads with ctypes.
//
// lut_build + lut_probe replace hyrise_tpu/kernels/tpu_prims.py
// lookup_last_eq_lut (XLA scatter-max and take): an equi-join probe for
// integer keys known to lie in [key_lo, key_lo + size). The build writes
// each valid build row's id into lut[key - key_lo] with atomicMax, so the
// table ends up holding the LAST (highest) row of every key whatever order
// the threads ran in: max is order-free, the result is the same every run.
// Invalid rows and keys outside the range are skipped. The probe is one
// bounds check and one gather per probe row and writes (matched, row id or
// 0). The caller fills the table with -1 first.
//
// expand_pairs replaces hyrise_tpu/ops/join.py _expand_pairs (XLA repeat and
// prefix-sum arithmetic): every probe row p owns the range
// [lo[p], lo[p] + counts[p]) of the sorted build side, and the output lists
// all (p, build_perm[lo[p] + rank]) pairs probe-major. offsets is the
// exclusive prefix sum of counts, computed by the caller.
//
// What bounds them: device-memory bytes, and for the two gathers the
// latency of scattered 4- and 8-byte accesses (the table of a TPC-H key at
// scale factor 1 is at most 24 MB and stays in the 50 MB L2). None does
// arithmetic worth counting. So each is a flat grid-stride loop, one thread
// per row (or per output pair), coalesced on the streamed side.
// expand_pairs finds the probe row that owns output position j by a binary
// search over offsets (the last p with offsets[p] <= j; rows with a zero
// count share their successor's offset and are never the last). That costs
// log2(n_probe) cached reads per pair, but no probe row's fan-out, however
// skewed, lands on one thread, which a non-equi join's ranges would do to a
// thread-per-probe-row loop.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
lut_build_kernel(const long long* __restrict__ keys,
                 const unsigned char* __restrict__ valid, long long n,
                 long long key_lo, unsigned long long size,
                 int* __restrict__ lut) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    if (!valid[i]) continue;
    // unsigned difference: a key below key_lo wraps to a huge value
    const unsigned long long slot = static_cast<unsigned long long>(keys[i]) -
                                    static_cast<unsigned long long>(key_lo);
    if (slot < size) atomicMax(lut + slot, static_cast<int>(i));
  }
}

__global__ void __launch_bounds__(kThreads)
lut_probe_kernel(const long long* __restrict__ keys, long long n,
                 long long key_lo, unsigned long long size,
                 const int* __restrict__ lut,
                 unsigned char* __restrict__ matched,
                 long long* __restrict__ build_row) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const unsigned long long slot = static_cast<unsigned long long>(keys[i]) -
                                    static_cast<unsigned long long>(key_lo);
    const int row = slot < size ? lut[slot] : -1;
    matched[i] = row >= 0;
    build_row[i] = row >= 0 ? row : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
expand_pairs_kernel(const int* __restrict__ lo, const long long* __restrict__ offsets,
                    long long n_probe, const long long* __restrict__ build_perm,
                    long long total,
                    long long* __restrict__ probe_out,
                    long long* __restrict__ build_out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < total; j += stride) {
    // first p with offsets[p] > j; its predecessor owns position j
    long long left = 0, right = n_probe;
    while (left < right) {
      const long long mid = (left + right) >> 1;
      if (offsets[mid] <= j) {
        left = mid + 1;
      } else {
        right = mid;
      }
    }
    const long long p = left - 1;
    // the wrapper has checked that every range lies inside build_perm
    probe_out[j] = p;
    build_out[j] = build_perm[lo[p] + (j - offsets[p])];
  }
}

}  // namespace

extern "C" {

int join_threads_per_block() { return kThreads; }

// Each entry point launches on `stream` and returns cudaGetLastError(); none
// synchronises or allocates.

int lut_build(const void* keys, const void* valid, long long n,
              long long key_lo, long long size, void* lut, int blocks,
              void* stream) {
  lut_build_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys),
      static_cast<const unsigned char*>(valid), n, key_lo,
      static_cast<unsigned long long>(size), static_cast<int*>(lut));
  return static_cast<int>(cudaGetLastError());
}

int lut_probe(const void* keys, long long n, long long key_lo, long long size,
              const void* lut, void* matched, void* build_row, int blocks,
              void* stream) {
  lut_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), n, key_lo,
      static_cast<unsigned long long>(size), static_cast<const int*>(lut),
      static_cast<unsigned char*>(matched), static_cast<long long*>(build_row));
  return static_cast<int>(cudaGetLastError());
}

int expand_pairs(const void* lo, const void* offsets, long long n_probe,
                 const void* build_perm, long long total,
                 void* probe_out, void* build_out, int blocks, void* stream) {
  expand_pairs_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lo), static_cast<const long long*>(offsets),
      n_probe, static_cast<const long long*>(build_perm), total,
      static_cast<long long*>(probe_out), static_cast<long long*>(build_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
