// Reduction over sorted segments for Hopper (sm_90a), behind a plain C
// interface that hyrise_tpu_torch/kernels/segment_reduce.py loads with ctypes.
//
// segment_reduce_sorted replaces hyrise_tpu/kernels/tpu_prims.py
// segment_sums_sorted (a flat cumsum and a gather at the segment ends) and
// the scatter-style segment_min/max beside it in the general group-by: with
// the rows already in group order, group g is rows [starts[g], starts[g+1])
// of that order, and per group the kernel gives the count of valid inputs
// and their sum, minimum or maximum. Optionally the rows are named by a
// permutation (`rows`), so the gather into group order happens here, and a
// validity column (indexed like the values) drops NULL inputs.
//
// What bounds it: device-memory bytes: per row 8 bytes of permutation, the
// value and a validity byte, gathered at random through `rows`; per group
// 8 bytes of `starts` and 16 bytes out.
//
// Design: no atomics, two forms, chosen by the wrapper from the mean group
// size. Short groups (about 4 rows a group when lineitem is grouped by its
// order key): one thread per group walks its rows in order, so a float64 sum
// is the sequential sum. Long groups (32 rows or more on average): one warp
// per group, lane l folding rows l, l + 32, ... in order and the 32 lanes
// folded in a fixed shuffle tree, so that a few long groups still spread over
// the card. Either form gives the same bits every launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Op { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// min/max keep a NaN once they have seen one, as amin/amax do.
template <int OP, typename Acc>
__device__ __forceinline__ Acc fold(Acc a, Acc b) {
  if (OP == kMin) return (b < a || b != b) ? b : a;
  if (OP == kMax) return (b > a || b != b) ? b : a;
  return a + b;
}

template <typename T, typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
segment_kernel(const T* __restrict__ values, const long long* __restrict__ rows,
               const unsigned char* __restrict__ validity,
               const long long* __restrict__ starts, long long n_groups,
               Acc init, Acc* __restrict__ out, long long* __restrict__ n_valid) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g < n_groups; g += step) {
    const long long end = starts[g + 1];
    Acc acc = init;
    long long count = 0;
    for (long long j = starts[g]; j < end; ++j) {
      const long long r = rows != nullptr ? rows[j] : j;
      if (validity != nullptr && !validity[r]) continue;
      ++count;
      if (OP != kCount) acc = fold<OP>(acc, static_cast<Acc>(values[r]));
    }
    n_valid[g] = count;
    if (OP != kCount) out[g] = acc;
  }
}

template <typename Acc>
__device__ __forceinline__ Acc shuffle_down(Acc v, int d);
template <>
__device__ __forceinline__ double shuffle_down<double>(double v, int d) {
  return __shfl_down_sync(0xFFFFFFFFu, v, d);
}
template <>
__device__ __forceinline__ long long shuffle_down<long long>(long long v, int d) {
  return __shfl_down_sync(0xFFFFFFFFu, v, d);
}

// One warp per group (kThreads / 32 groups a block).
template <typename T, typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
segment_warp_kernel(const T* __restrict__ values,
                    const long long* __restrict__ rows,
                    const unsigned char* __restrict__ validity,
                    const long long* __restrict__ starts, long long n_groups,
                    Acc init, Acc* __restrict__ out,
                    long long* __restrict__ n_valid) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long g = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                     (threadIdx.x >> 5);
       g < n_groups; g += warps) {
    const long long end = starts[g + 1];
    Acc acc = init;
    long long count = 0;
    for (long long j = starts[g] + lane; j < end; j += 32) {
      const long long r = rows != nullptr ? rows[j] : j;
      if (validity != nullptr && !validity[r]) continue;
      ++count;
      if (OP != kCount) acc = fold<OP>(acc, static_cast<Acc>(values[r]));
    }
    for (int d = 16; d > 0; d >>= 1) {
      count += shuffle_down<long long>(count, d);
      if (OP != kCount) acc = fold<OP>(acc, shuffle_down<Acc>(acc, d));
    }
    if (lane == 0) {
      n_valid[g] = count;
      if (OP != kCount) out[g] = acc;
    }
  }
}

template <typename T, typename Acc, int OP>
int launch(const void* values, const void* rows, const void* validity,
           const void* starts, long long n_groups, Acc init, void* out,
           void* n_valid, int blocks, bool warp_per_group,
           cudaStream_t stream) {
  if (warp_per_group) {
    segment_warp_kernel<T, Acc, OP><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(values), static_cast<const long long*>(rows),
        static_cast<const unsigned char*>(validity),
        static_cast<const long long*>(starts), n_groups, init,
        static_cast<Acc*>(out), static_cast<long long*>(n_valid));
    return static_cast<int>(cudaGetLastError());
  }
  segment_kernel<T, Acc, OP><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const long long*>(rows),
      static_cast<const unsigned char*>(validity),
      static_cast<const long long*>(starts), n_groups, init,
      static_cast<Acc*>(out), static_cast<long long*>(n_valid));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_op(int op, const void* values, const void* rows,
              const void* validity, const void* starts, long long n_groups,
              Acc init, void* out, void* n_valid, int blocks,
              bool warp_per_group, cudaStream_t stream) {
  switch (op) {
    case kSum:
      return launch<T, Acc, kSum>(values, rows, validity, starts, n_groups,
                                  Acc(0), out, n_valid, blocks, warp_per_group,
                                  stream);
    case kMin:
      return launch<T, Acc, kMin>(values, rows, validity, starts, n_groups,
                                  init, out, n_valid, blocks, warp_per_group,
                                  stream);
    case kMax:
      return launch<T, Acc, kMax>(values, rows, validity, starts, n_groups,
                                  init, out, n_valid, blocks, warp_per_group,
                                  stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int segment_threads_per_block() { return kThreads; }

// value_type: 0 float64, 1 float32, 2 int64, 3 int32 (ignored by a count,
// whose `values` and `out` may be null). op: 0 sum, 1 min, 2 max, 3 count.
// `rows` (int64 permutation) and `validity` (bytes, indexed like the values)
// may be null. `starts` holds n_groups + 1 int64 offsets into the group
// order. Float types accumulate in float64 from init_f, integers in int64
// from init_i (sums from 0); `out` holds n_groups accumulators, `n_valid`
// n_groups int64. warp_per_group picks the form: 0 one thread per group,
// else one warp (a block then covers 8 groups at a time). Launches on
// `stream`, does not synchronise, returns the first CUDA error.
int segment_reduce_sorted(const void* values, int value_type, const void* rows,
                          const void* validity, const void* starts,
                          long long n_groups, int op, double init_f,
                          long long init_i, void* out, void* n_valid,
                          int blocks, int warp_per_group, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_groups < 1 || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (op == kCount) {
    return launch<int, long long, kCount>(nullptr, rows, validity, starts,
                                          n_groups, 0LL, nullptr, n_valid,
                                          blocks, warp_per_group != 0, stream);
  }
  switch (value_type) {
    case 0:
      return launch_op<double, double>(op, values, rows, validity, starts,
                                       n_groups, init_f, out, n_valid, blocks,
                                       warp_per_group != 0, stream);
    case 1:
      return launch_op<float, double>(op, values, rows, validity, starts,
                                      n_groups, init_f, out, n_valid, blocks,
                                      warp_per_group != 0, stream);
    case 2:
      return launch_op<long long, long long>(op, values, rows, validity, starts,
                                             n_groups, init_i, out, n_valid,
                                             blocks, warp_per_group != 0, stream);
    case 3:
      return launch_op<int, long long>(op, values, rows, validity, starts,
                                       n_groups, init_i, out, n_valid, blocks,
                                       warp_per_group != 0, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
