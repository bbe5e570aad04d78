// Fused filter + dense-cell aggregate for Hopper (sm_90a), behind a plain C
// interface that hyrise_tpu_torch/kernels/fused_reduce.py loads with ctypes.
//
// fused_cells_reduce replaces the traced `compute` of
// hyrise_tpu/kernels/fused.py (FusedFilterAggregate._build): from a row mask,
// up to 8 dictionary-code columns and a list of aggregate inputs it derives
// each row's cell (the mixed-radix number of its codes; masked-out rows take
// no part) and, in ONE pass over the rows, accumulates per cell
//   - the row count,
//   - per distinct validity column the count of valid rows,
//   - per slot a sum, a minimum or a maximum of its value column over the
//     rows its validity column admits.
// Float inputs (float64, float32) accumulate in float64, integer inputs
// (int64, int32) exactly in int64; inputs are widened in registers.
//
// What bounds it: device-memory bytes. The mask, every code column and every
// value column are read once (value columns only where the mask holds).
//
// Design: that of group_reduce.cu, widened to many accumulators. No atomics:
// every thread owns n_acc * n_cells private 8-byte accumulators in shared
// memory (slot = (acc * n_cells + cell) * threads + thread, so a warp never
// conflicts on a bank), folds its rows in grid-stride order, the block folds
// its threads in a fixed tree, and a second kernel folds the blocks' partials
// in a fixed order. Equal inputs and an equal launch shape give equal bits.
// Shared memory is n_acc * n_cells * threads * 8 bytes; the wrapper picks
// the thread count (256 down to 32) so that it fits one block's 227 KB and
// splits the slots over several launches where 32 threads do not fit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxKeys = 8;
constexpr int kMaxSlots = 16;
constexpr int kMaxCells = 64;
constexpr int kMaxShared = 227 * 1024;

enum Op { kSum = 0, kMin = 1, kMax = 2 };
enum Type { kF64 = 0, kF32 = 1, kI64 = 2, kI32 = 3 };

typedef unsigned long long Bits;  // one accumulator: a double or a long long

struct Slot {
  const void* values;
  int type;
  int op;
  int validity;  // index into Args::validities, or -1: every masked row counts
};

struct Args {
  const unsigned char* mask;  // null: every row takes part
  const int* keys[kMaxKeys];
  int sizes[kMaxKeys];
  const unsigned char* validities[kMaxSlots];
  Slot slots[kMaxSlots];
  int n_keys;
  int n_validities;
  int n_slots;
  int n_cells;
  long long n;
};

// Accumulator k of a launch: 0 the row count, then the validity counts, then
// the slots.
__device__ __forceinline__ void acc_kind(const Args& a, int k, int* op,
                                         bool* is_float) {
  const int s = k - 1 - a.n_validities;
  if (s < 0) {
    *op = kSum;
    *is_float = false;
  } else {
    *op = a.slots[s].op;
    *is_float = a.slots[s].type <= kF32;
  }
}

__device__ __forceinline__ Bits init_bits(int op, bool is_float) {
  if (op == kSum) return 0ULL;  // 0 and 0.0 share their bits
  // the bits of +infinity and -infinity
  if (is_float) return op == kMin ? 0x7FF0000000000000ULL : 0xFFF0000000000000ULL;
  return static_cast<Bits>(op == kMin ? INT64_MAX : INT64_MIN);
}

// min/max keep a NaN once they have seen one, as amin/amax do.
__device__ __forceinline__ double fold_f(double a, double b, int op) {
  if (op == kMin) return (b < a || b != b) ? b : a;
  if (op == kMax) return (b > a || b != b) ? b : a;
  return a + b;
}

__device__ __forceinline__ long long fold_i(long long a, long long b, int op) {
  if (op == kMin) return b < a ? b : a;
  if (op == kMax) return b > a ? b : a;
  return static_cast<long long>(static_cast<Bits>(a) + static_cast<Bits>(b));
}

__device__ __forceinline__ Bits fold_bits(Bits a, Bits b, int op,
                                          bool is_float) {
  if (is_float) {
    return static_cast<Bits>(__double_as_longlong(
        fold_f(__longlong_as_double(static_cast<long long>(a)),
               __longlong_as_double(static_cast<long long>(b)), op)));
  }
  return static_cast<Bits>(
      fold_i(static_cast<long long>(a), static_cast<long long>(b), op));
}

__global__ void __launch_bounds__(kMaxThreads)
fused_kernel(const Args a, Bits* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  Bits* acc = reinterpret_cast<Bits*>(shared_raw);
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int n_cells = a.n_cells;
  const int n_acc = 1 + a.n_validities + a.n_slots;

  for (int k = 0; k < n_acc; ++k) {
    int op;
    bool is_float;
    acc_kind(a, k, &op, &is_float);
    const Bits init = init_bits(op, is_float);
    for (int c = 0; c < n_cells; ++c) acc[(k * n_cells + c) * T + t] = init;
  }

  const long long step = static_cast<long long>(gridDim.x) * T;
  for (long long i = static_cast<long long>(blockIdx.x) * T + t; i < a.n;
       i += step) {
    if (a.mask != nullptr && !a.mask[i]) continue;
    int cell = 0;
    for (int g = 0; g < a.n_keys; ++g) cell = cell * a.sizes[g] + a.keys[g][i];
    if (static_cast<unsigned>(cell) >= static_cast<unsigned>(n_cells)) continue;
    acc[cell * T + t] += 1ULL;
    unsigned valid_bits = 0;
    for (int v = 0; v < a.n_validities; ++v) {
      if (a.validities[v][i]) {
        valid_bits |= 1u << v;
        acc[((1 + v) * n_cells + cell) * T + t] += 1ULL;
      }
    }
    for (int s = 0; s < a.n_slots; ++s) {
      const Slot slot = a.slots[s];
      if (slot.validity >= 0 && !((valid_bits >> slot.validity) & 1u)) continue;
      Bits* p = acc + ((1 + a.n_validities + s) * n_cells + cell) * T + t;
      if (slot.type <= kF32) {
        const double v =
            slot.type == kF64
                ? static_cast<const double*>(slot.values)[i]
                : static_cast<double>(static_cast<const float*>(slot.values)[i]);
        *p = static_cast<Bits>(__double_as_longlong(fold_f(
            __longlong_as_double(static_cast<long long>(*p)), v, slot.op)));
      } else {
        const long long v =
            slot.type == kI64
                ? static_cast<const long long*>(slot.values)[i]
                : static_cast<long long>(static_cast<const int*>(slot.values)[i]);
        *p = static_cast<Bits>(fold_i(static_cast<long long>(*p), v, slot.op));
      }
    }
  }

  // fold the block's T private rows, a fixed tree per accumulator and cell
  const int n_rows = n_acc * n_cells;
  for (int half = T / 2; half > 0; half >>= 1) {
    __syncthreads();
    for (int idx = t; idx < n_rows * half; idx += T) {
      const int r = idx / half;
      const int j = idx - r * half;
      int op;
      bool is_float;
      acc_kind(a, r / n_cells, &op, &is_float);
      Bits* p = acc + r * T + j;
      *p = fold_bits(p[0], p[half], op, is_float);
    }
  }
  __syncthreads();
  for (int r = t; r < n_rows; r += T) {
    partials[static_cast<long long>(blockIdx.x) * n_rows + r] = acc[r * T];
  }
}

// One block per (accumulator, cell) folds that entry's partials of all
// blocks in a fixed order.
__global__ void __launch_bounds__(kMaxThreads)
fused_combine_kernel(const Args a, const Bits* __restrict__ partials,
                     int blocks, Bits* __restrict__ out) {
  __shared__ Bits rows[kMaxThreads];
  const int t = threadIdx.x;
  const int r = blockIdx.x;
  const int n_rows = (1 + a.n_validities + a.n_slots) * a.n_cells;
  int op;
  bool is_float;
  acc_kind(a, r / a.n_cells, &op, &is_float);
  Bits v = init_bits(op, is_float);
  for (int b = t; b < blocks; b += kMaxThreads) {
    v = fold_bits(v, partials[static_cast<long long>(b) * n_rows + r], op,
                  is_float);
  }
  rows[t] = v;
  for (int half = kMaxThreads / 2; half > 0; half >>= 1) {
    __syncthreads();
    if (t < half) rows[t] = fold_bits(rows[t], rows[t + half], op, is_float);
  }
  if (t == 0) out[r] = rows[0];
}

}  // namespace

extern "C" {

int fused_max_keys() { return kMaxKeys; }
int fused_max_slots() { return kMaxSlots; }
int fused_max_cells() { return kMaxCells; }
int fused_max_shared() { return kMaxShared; }

// mask: n bytes or null. keys/sizes: n_keys int32 code columns and their
// radixes. validities: n_validities byte columns. Slot s reads
// slot_values[s] of slot_types[s] (0 float64, 1 float32, 2 int64, 3 int32),
// folds with slot_ops[s] (0 sum, 1 min, 2 max) and skips rows where
// validities[slot_validity[s]] is 0 (-1: none). `partials` holds
// blocks * n_acc * n_cells 8-byte accumulators and `out` n_acc * n_cells,
// with n_acc = 1 + n_validities + n_slots: accumulator 0 is the row count,
// then the validity counts, then the slots (float64 bits for float inputs,
// int64 otherwise). `threads` is a power of two in [32, 256]. Launches on
// `stream`, does not synchronise, returns the first CUDA error.
int fused_cells_reduce(const void* mask, int n_keys, const void* const* keys,
                       const int* sizes, int n_validities,
                       const void* const* validities, int n_slots,
                       const void* const* slot_values, const int* slot_types,
                       const int* slot_ops, const int* slot_validity,
                       long long n, int n_cells, int threads, int blocks,
                       void* partials, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_keys < 0 || n_keys > kMaxKeys || n_validities < 0 ||
      n_validities > kMaxSlots || n_slots < 0 || n_slots > kMaxSlots ||
      n_cells < 1 || n_cells > kMaxCells || blocks < 1 || threads < 32 ||
      threads > kMaxThreads || (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a = {};
  a.mask = static_cast<const unsigned char*>(mask);
  for (int g = 0; g < n_keys; ++g) {
    a.keys[g] = static_cast<const int*>(keys[g]);
    a.sizes[g] = sizes[g];
  }
  for (int v = 0; v < n_validities; ++v) {
    a.validities[v] = static_cast<const unsigned char*>(validities[v]);
  }
  for (int s = 0; s < n_slots; ++s) {
    if (slot_types[s] < kF64 || slot_types[s] > kI32 || slot_ops[s] < kSum ||
        slot_ops[s] > kMax || slot_validity[s] >= n_validities) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.slots[s].values = slot_values[s];
    a.slots[s].type = slot_types[s];
    a.slots[s].op = slot_ops[s];
    a.slots[s].validity = slot_validity[s];
  }
  a.n_keys = n_keys;
  a.n_validities = n_validities;
  a.n_slots = n_slots;
  a.n_cells = n_cells;
  a.n = n;
  const int n_rows = (1 + n_validities + n_slots) * n_cells;
  const size_t shared = static_cast<size_t>(n_rows) * threads * sizeof(Bits);
  if (shared > static_cast<size_t>(kMaxShared)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_kernel<<<blocks, threads, shared, stream>>>(
      a, static_cast<Bits*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_combine_kernel<<<n_rows, kMaxThreads, 0, stream>>>(
      a, static_cast<const Bits*>(partials), blocks, static_cast<Bits*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
