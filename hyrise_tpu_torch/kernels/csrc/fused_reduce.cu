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
// What bounds it: device-memory bytes. The mask, every code column,
// validity column and distinct value column are read once.
//
// Design: the engine of cells_reduce.cuh (its header note says how tiles
// are staged, folded without atomics and finished in one kernel). K6's part
// is the decode and the dispatch: a tile's cells are computed once, from the
// staged mask and code columns, and each accumulator then takes one switch a
// tile on its (input type, fold) into an inner loop compiled for that pair
// and for the bucket of the cell count; a slot's validity column is a staged
// byte per row that turns the row's cell off. Value columns that several
// slots read (SUM and AVG of one input) are staged once. The tile (8 or 4
// rows a thread) and the folders come from the wrapper, which splits the
// slots over launches where even the smallest shape exceeds a block's
// 227 KB.

#include <initializer_list>

#include "cells_reduce.cuh"

namespace {

using cells::Bits;
using cells::Column;
using cells::kThreads;
using cells::kWarps;

constexpr int kMaxKeys = 8;
constexpr int kMaxSlots = 16;
constexpr int kMaxColumns = 1 + kMaxKeys + 2 * kMaxSlots;

enum Type { kF64 = 0, kF32 = 1, kI64 = 2, kI32 = 3 };

struct Slot {
  int column;    // index into Args::cols of its values
  int type;
  int op;
  int validity;  // index into Args::validities, or -1: every masked row counts
};

struct Args {
  Column cols[kMaxColumns];
  int n_cols;
  int mask;  // column index, or -1: every row takes part
  int keys[kMaxKeys];
  int sizes[kMaxKeys];
  int n_keys;
  int validities[kMaxSlots];  // column indices
  int n_validities;
  Slot slots[kMaxSlots];
  int n_slots;
  long long n;
  int n_cells;
  int n_entries;  // (1 + n_validities + n_slots) * n_cells
};

// Accumulator k: 0 the row count, then the validity counts, then the slots.
__device__ __forceinline__ void acc_kind(const Args& a, int k, int* op, bool* is_float) {
  const int s = k - 1 - a.n_validities;
  *op = s < 0 ? cells::kSum : a.slots[s].op;
  *is_float = s >= 0 && a.slots[s].type <= kF32;
}

__device__ __forceinline__ Bits init_bits(int op, bool is_float) {
  if (op == cells::kSum) return 0ULL;  // 0 and 0.0 share their bits
  // the bits of +infinity and -infinity
  if (is_float) return op == cells::kMin ? 0x7FF0000000000000ULL : 0xFFF0000000000000ULL;
  return static_cast<Bits>(op == cells::kMin ? INT64_MAX : INT64_MIN);
}

// What a launch is given: its arguments and what the engine reads.
struct JobData {
  Args a;
  int n_cols;
  long long n;
  int n_entries;
};

// The job, read from the block's copy of the JobData in shared memory.
template <int B, int RPT>
struct Job : JobData {
  static constexpr bool kFolders = B > 8;

  __device__ __forceinline__ const Column* columns() const { return a.cols; }

  // an entry's kind: its op times 2, plus 1 for a float accumulator
  __device__ __forceinline__ int kind(int e) const {
    int op;
    bool is_float;
    acc_kind(a, e / a.n_cells, &op, &is_float);
    return op * 2 + (is_float ? 1 : 0);
  }

  __device__ __forceinline__ Bits init_of(int kind) const {
    return init_bits(kind >> 1, (kind & 1) != 0);
  }

  __device__ __forceinline__ int decode(const unsigned char* stage, int j) const {
    if (a.mask >= 0 && cells::staged(stage, a.cols[a.mask])[j] == 0) return cells::kOut;
    int cell = 0;
    for (int g = 0; g < a.n_keys; ++g) {
      cell = cell * a.sizes[g] +
             reinterpret_cast<const int*>(cells::staged(stage, a.cols[a.keys[g]]))[j];
    }
    return static_cast<unsigned>(cell) < static_cast<unsigned>(a.n_cells) ? cell
                                                                           : cells::kOut;
  }

  template <int OP, typename T, typename Acc>
  __device__ __forceinline__ void fold_column(const unsigned char* rows,
                                              const unsigned char* valid, Bits init,
                                              const int (&cb)[RPT], const cells::Tile& t,
                                              Bits* wacc) const {
    cells::fold_tile<B, RPT, OP, Acc>(cells::ColumnInput<T, Acc>{rows}, valid, cb, t,
                                      cells::from_bits<Acc>(init), wacc);
  }

  __device__ __forceinline__ void fold(const unsigned char* stage, const int (&cb)[RPT],
                                       const cells::Tile& t) const {
    const int per_acc = a.n_cells * t.width;
    cells::fold_tile<B, RPT, cells::kSum, long long>(cells::CountInput{}, nullptr, cb, t, 0LL,
                                                     t.wacc);
    for (int v = 0; v < a.n_validities; ++v) {
      cells::fold_tile<B, RPT, cells::kSum, long long>(
          cells::CountInput{}, cells::staged(stage, a.cols[a.validities[v]]), cb, t, 0LL,
          t.wacc + (1 + v) * per_acc);
    }
    for (int s = 0; s < a.n_slots; ++s) {
      const Slot slot = a.slots[s];
      const unsigned char* rows = cells::staged(stage, a.cols[slot.column]);
      const unsigned char* valid =
          slot.validity < 0 ? nullptr
                            : cells::staged(stage, a.cols[a.validities[slot.validity]]);
      const Bits init = init_bits(slot.op, slot.type <= kF32);
      Bits* wacc = t.wacc + (1 + a.n_validities + s) * per_acc;
      switch (slot.type * 3 + slot.op) {
        case kF64 * 3 + cells::kSum:
          fold_column<cells::kSum, double, double>(rows, valid, init, cb, t, wacc); break;
        case kF64 * 3 + cells::kMin:
          fold_column<cells::kMin, double, double>(rows, valid, init, cb, t, wacc); break;
        case kF64 * 3 + cells::kMax:
          fold_column<cells::kMax, double, double>(rows, valid, init, cb, t, wacc); break;
        case kF32 * 3 + cells::kSum:
          fold_column<cells::kSum, float, double>(rows, valid, init, cb, t, wacc); break;
        case kF32 * 3 + cells::kMin:
          fold_column<cells::kMin, float, double>(rows, valid, init, cb, t, wacc); break;
        case kF32 * 3 + cells::kMax:
          fold_column<cells::kMax, float, double>(rows, valid, init, cb, t, wacc); break;
        case kI64 * 3 + cells::kSum:
          fold_column<cells::kSum, long long, long long>(rows, valid, init, cb, t, wacc);
          break;
        case kI64 * 3 + cells::kMin:
          fold_column<cells::kMin, long long, long long>(rows, valid, init, cb, t, wacc);
          break;
        case kI64 * 3 + cells::kMax:
          fold_column<cells::kMax, long long, long long>(rows, valid, init, cb, t, wacc);
          break;
        case kI32 * 3 + cells::kSum:
          fold_column<cells::kSum, int, long long>(rows, valid, init, cb, t, wacc); break;
        case kI32 * 3 + cells::kMin:
          fold_column<cells::kMin, int, long long>(rows, valid, init, cb, t, wacc); break;
        default:
          fold_column<cells::kMax, int, long long>(rows, valid, init, cb, t, wacc); break;
      }
    }
  }

  __device__ __forceinline__ Bits combine(int kind, Bits x, Bits y) const {
    return cells::fold_bits(x, y, kind >> 1, (kind & 1) != 0);
  }
};

template <int B, int RPT>
__global__ void __launch_bounds__(kThreads, cells::kMinBlocks)
fused_kernel(const __grid_constant__ JobData job, const cells::Shape shape, Bits* partials,
             Bits* out, unsigned* ticket) {
  cells::run<RPT>(static_cast<const Job<B, RPT>&>(job), shape, partials, out, ticket);
}

typedef void (*Kernel)(const JobData, const cells::Shape, Bits*, Bits*, unsigned*);

template <int RPT>
Kernel kernel_for(int n_cells) {
  switch (cells::bucket(n_cells)) {
    case 1: return fused_kernel<1, RPT>;
    case 2: return fused_kernel<2, RPT>;
    case 3: return fused_kernel<3, RPT>;
    case 4: return fused_kernel<4, RPT>;
    case 5: return fused_kernel<5, RPT>;
    case 6: return fused_kernel<6, RPT>;
    case 7: return fused_kernel<7, RPT>;
    case 8: return fused_kernel<8, RPT>;
    default: return fused_kernel<cells::kWide, RPT>;
  }
}

Kernel kernel_for(int n_cells, int rows_per_thread) {
  return rows_per_thread == 8 ? kernel_for<8>(n_cells) : kernel_for<4>(n_cells);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      sms = 0;
      return 1;
    }
  }
  return sms;
}

}  // namespace

extern "C" {

int fused_max_keys() { return kMaxKeys; }
int fused_max_slots() { return kMaxSlots; }
int fused_max_cells() { return cells::kMaxCells; }
int fused_max_shared() { return cells::kMaxShared; }
int fused_warps() { return kWarps; }

// The dynamic shared memory of a block whose columns have the given element
// bytes, with n_entries accumulators of `width` each.
int fused_shared_bytes(int n_columns, const int* column_bytes, int n_entries,
                       int rows_per_thread, int width) {
  const int tile = rows_per_thread * kThreads;
  int stage = 0;
  for (int c = 0; c < n_columns; ++c) stage += cells::region_bytes(tile, column_bytes[c]);
  return cells::shared_bytes(stage, tile, n_entries, width);
}

// Allows every kernel all the dynamic shared memory a block may have;
// called once, when the library is loaded. Returns the first error.
int fused_init() {
  for (int rows_per_thread : {4, 8}) {
    for (int n_cells : {1, 2, 3, 4, 5, 6, 7, 8, cells::kWide}) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel_for(n_cells, rows_per_thread),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, cells::kMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// mask: n bytes or null. keys/sizes: n_keys int32 code columns and their
// radixes. validities: n_validities byte columns. values: n_values distinct
// value columns of value_types (0 float64, 1 float32, 2 int64, 3 int32).
// Slot s folds values[slot_values[s]] with slot_ops[s] (0 sum, 1 min, 2 max)
// and skips rows where validities[slot_validity[s]] is 0 (-1: none). `out`
// holds n_acc * n_cells 8-byte accumulators and, behind them, room for
// max_blocks times as many partials, n_acc = 1 + n_validities + n_slots:
// accumulator 0 is the row count, then the validity counts, then the slots
// (float64 bits for float inputs, int64 otherwise). `ticket` is a zeroed
// word that no other launch uses while this one runs; the kernel leaves it
// zeroed. rows_per_thread (8 or 4) sets the tile, `folders` (32, 64 or
// 128) the threads with private accumulators where n_cells > 8 (ignored
// below). One kernel on `stream`,
// no synchronisation; returns the first CUDA error.
int fused_cells_reduce(const void* mask, int n_keys, const void* const* keys,
                       const int* sizes, int n_validities, const void* const* validities,
                       int n_values, const void* const* values, const int* value_types,
                       int n_slots, const int* slot_values, const int* slot_ops,
                       const int* slot_validity, long long n, int n_cells, void* out,
                       void* ticket, int max_blocks, int rows_per_thread, int folders,
                       void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 0 || n_keys < 0 || n_keys > kMaxKeys || n_validities < 0 ||
      n_validities > kMaxSlots || n_values < 0 || n_values > kMaxSlots || n_slots < 0 ||
      n_slots > kMaxSlots || n_cells < 1 || n_cells > cells::kMaxCells || max_blocks < 1 ||
      (rows_per_thread != 4 && rows_per_thread != 8) ||
      (n_cells > 8 && folders != 32 && folders != 64 && folders != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile = rows_per_thread * kThreads;
  JobData job = {};
  Args& a = job.a;
  int stage = 0;
  auto add_column = [&](const void* base, int bytes) {
    a.cols[a.n_cols] = {static_cast<const unsigned char*>(base), bytes, stage};
    stage += cells::region_bytes(tile, bytes);
    return a.n_cols++;
  };
  a.mask = mask == nullptr ? -1 : add_column(mask, 1);
  for (int g = 0; g < n_keys; ++g) {
    a.keys[g] = add_column(keys[g], 4);
    a.sizes[g] = sizes[g];
  }
  for (int v = 0; v < n_validities; ++v) a.validities[v] = add_column(validities[v], 1);
  int first_value = a.n_cols;
  for (int c = 0; c < n_values; ++c) {
    if (value_types[c] < kF64 || value_types[c] > kI32) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    add_column(values[c], value_types[c] == kF64 || value_types[c] == kI64 ? 8 : 4);
  }
  for (int s = 0; s < n_slots; ++s) {
    if (slot_values[s] < 0 || slot_values[s] >= n_values || slot_ops[s] < cells::kSum ||
        slot_ops[s] > cells::kMax || slot_validity[s] >= n_validities) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    a.slots[s] = {first_value + slot_values[s], value_types[slot_values[s]], slot_ops[s],
                  slot_validity[s]};
  }
  a.n_keys = n_keys;
  a.n_validities = n_validities;
  a.n_slots = n_slots;
  a.n = n;
  a.n_cells = n_cells;
  a.n_entries = (1 + n_validities + n_slots) * n_cells;
  job.n_cols = a.n_cols;
  job.n = n;
  job.n_entries = a.n_entries;
  const cells::Shape shape = {stage, n_cells <= 8 ? kWarps : folders};
  const int shared = cells::shared_bytes(stage, tile, a.n_entries, shape.width);
  if (shared > cells::kMaxShared) return static_cast<int>(cudaErrorInvalidValue);

  const Kernel kernel = kernel_for(n_cells, rows_per_thread);
  int per_sm = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (n + tile - 1) / tile;
  long long blocks = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;  // no rows: one block writes the identities
  Bits* acc = static_cast<Bits*>(out);
  kernel<<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(
      job, shape, acc + a.n_entries, acc, static_cast<unsigned*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
