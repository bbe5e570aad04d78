// Group reduce into a small dense cell space for Hopper (sm_90a), behind a
// plain C interface that hyrise_tpu_torch/kernels/group_reduce.py loads with
// ctypes.
//
// group_reduce replaces hyrise_tpu/kernels/tpu_prims.py segment_reduce_cells
// (the XLA form: one masked whole-column reduction per cell): for every row i
// with 0 <= cell[i] < n_cells it folds values[i] into out[cell[i]], as a sum,
// a row count, a minimum or a maximum. n_cells is at most 64. Sums and counts
// accumulate in float64 (float inputs) or int64 (integer inputs); min and max
// are taken in the same wide type, which holds every input value exactly.
//
// What bounds it: device-memory bytes. A row costs one add or compare
// against 4 bytes of cell id and 4 or 8 bytes of value (none for a count).
//
// Design. Atomics are what made the plain version slow (every row of a
// low-cardinality group-by lands on the same few addresses) and what would
// make a float sum differ from run to run. So there are none: every thread
// of a block owns a private row of n_cells accumulators in shared memory,
// laid out accumulator-major (slot = cell * kThreads + thread), so the 32
// threads of a warp always touch 32 different banks whatever their cells
// are. A thread folds its rows in grid-stride order, kUnroll independent
// loads in flight per step. The block then folds its kThreads rows in a
// fixed tree and writes one [n_cells] partial; a second kernel folds the
// partials of all blocks in a fixed order. The same launch shape therefore
// gives the same bits every time, which joins on a float sum rely on.
// Shared memory per block is n_cells * kThreads * 8 bytes (128 KB at 64
// cells), requested as dynamic shared memory.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxCells = 64;

enum Op { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// The fold of two accumulators. min/max keep a NaN once they have seen one,
// as the plain version's amin/amax do.
template <int OP, typename Acc>
__device__ __forceinline__ Acc fold(Acc a, Acc b) {
  if (OP == kMin) return (b < a || b != b) ? b : a;
  if (OP == kMax) return (b > a || b != b) ? b : a;
  return a + b;
}

template <typename T, typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
reduce_cells_kernel(const T* __restrict__ values, const int* __restrict__ cell,
                    long long n, int n_cells, Acc init,
                    Acc* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Acc* acc = reinterpret_cast<Acc*>(shared_raw);
  const int t = threadIdx.x;
  for (int c = 0; c < n_cells; ++c) acc[c * kThreads + t] = init;

  const long long step = static_cast<long long>(gridDim.x) * kThreads * kUnroll;
  for (long long base =
           static_cast<long long>(blockIdx.x) * kThreads * kUnroll + t;
       base < n; base += step) {
    Acc v[kUnroll];
    int c[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + static_cast<long long>(k) * kThreads;
      c[k] = -1;
      v[k] = Acc(1);
      if (i < n) {
        c[k] = cell[i];
        if (OP != kCount) v[k] = static_cast<Acc>(values[i]);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (static_cast<unsigned>(c[k]) < static_cast<unsigned>(n_cells)) {
        Acc* slot = acc + c[k] * kThreads + t;
        *slot = fold<OP>(*slot, v[k]);
      }
    }
  }

  // fold the block's kThreads private rows, a fixed tree per cell
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    __syncthreads();
    for (int idx = t; idx < n_cells * half; idx += kThreads) {
      const int c = idx / half;
      const int j = idx - c * half;
      Acc* slot = acc + c * kThreads + j;
      *slot = fold<OP>(slot[0], slot[half]);
    }
  }
  __syncthreads();
  if (t < n_cells) {
    partials[static_cast<long long>(blockIdx.x) * n_cells + t] =
        acc[t * kThreads];
  }
}

// One block per cell folds that cell's partials of all blocks, fixed order.
template <typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const Acc* __restrict__ partials, int blocks, int n_cells,
               Acc init, Acc* __restrict__ out) {
  __shared__ Acc rows[kThreads];
  const int t = threadIdx.x;
  const int c = blockIdx.x;
  Acc a = init;
  for (int b = t; b < blocks; b += kThreads) {
    a = fold<OP>(a, partials[static_cast<long long>(b) * n_cells + c]);
  }
  rows[t] = a;
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (t < half) rows[t] = fold<OP>(rows[t], rows[t + half]);
  }
  if (t == 0) out[c] = rows[0];
}

template <typename T, typename Acc, int OP>
int launch(const void* values, const void* cell, long long n, int n_cells,
           Acc init, void* partials, void* out, int blocks,
           cudaStream_t stream) {
  // a count folds ones in the main pass and sums the partials after it
  constexpr int kCombine = OP == kCount ? kSum : OP;
  const size_t shared = static_cast<size_t>(n_cells) * kThreads * sizeof(Acc);
  cudaError_t err = cudaFuncSetAttribute(
      reduce_cells_kernel<T, Acc, OP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxCells * kThreads * static_cast<int>(sizeof(Acc)));
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_cells_kernel<T, Acc, OP><<<blocks, kThreads, shared, stream>>>(
      static_cast<const T*>(values), static_cast<const int*>(cell), n, n_cells,
      init, static_cast<Acc*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<Acc, kCombine><<<n_cells, kThreads, 0, stream>>>(
      static_cast<const Acc*>(partials), blocks, n_cells, init,
      static_cast<Acc*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_op(int op, const void* values, const void* cell, long long n,
              int n_cells, Acc init, void* partials, void* out, int blocks,
              cudaStream_t stream) {
  switch (op) {
    case kSum:
      return launch<T, Acc, kSum>(values, cell, n, n_cells, Acc(0), partials,
                                  out, blocks, stream);
    case kMin:
      return launch<T, Acc, kMin>(values, cell, n, n_cells, init, partials,
                                  out, blocks, stream);
    case kMax:
      return launch<T, Acc, kMax>(values, cell, n, n_cells, init, partials,
                                  out, blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int group_reduce_threads_per_block() { return kThreads; }
int group_reduce_rows_per_step() { return kUnroll; }
int group_reduce_max_cells() { return kMaxCells; }

// value_type: 0 float64, 1 float32, 2 int64, 3 int32 (ignored by a count,
// whose `values` may be null). op: 0 sum, 1 min, 2 max, 3 count. Float types
// accumulate into float64 starting from init_f, integer types and counts
// into int64 starting from init_i (sums and counts start from 0). `partials`
// holds blocks * n_cells accumulators, `out` n_cells. Launches on `stream`
// and returns the first CUDA error; it does not synchronise.
int group_reduce(const void* values, int value_type, const void* cell,
                 long long n, int n_cells, int op, double init_f,
                 long long init_i, void* partials, void* out, int blocks,
                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_cells < 1 || n_cells > kMaxCells || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (op == kCount) {
    return launch<int, long long, kCount>(nullptr, cell, n, n_cells, 0LL,
                                          partials, out, blocks, stream);
  }
  switch (value_type) {
    case 0:
      return launch_op<double, double>(op, values, cell, n, n_cells, init_f,
                                       partials, out, blocks, stream);
    case 1:
      return launch_op<float, double>(op, values, cell, n, n_cells, init_f,
                                      partials, out, blocks, stream);
    case 2:
      return launch_op<long long, long long>(op, values, cell, n, n_cells,
                                             init_i, partials, out, blocks,
                                             stream);
    case 3:
      return launch_op<int, long long>(op, values, cell, n, n_cells, init_i,
                                       partials, out, blocks, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
