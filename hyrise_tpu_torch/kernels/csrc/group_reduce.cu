// Group reduce into a small dense cell space for Hopper (sm_90a), behind a
// plain C interface that hyrise_tpu_torch/kernels/group_reduce.py loads with
// ctypes.
//
// group_reduce_cells replaces hyrise_tpu/kernels/tpu_prims.py
// segment_reduce_cells (the XLA form: one masked whole-column reduction per
// cell) for every reduction of a dense-cell Aggregate at once. From one int32
// cell column (rows whose cell lies outside [0, n_cells) take no part;
// n_cells <= 64) one pass over the rows gives, per cell,
//   - the row count,
//   - the valid rows of each validity column,
//   - for each fold (a value column, sum / min / max, and the validity column
//     whose rows it takes, if any) its result.
// Float inputs fold in float64, integer inputs exactly in int64 (sums wrap as
// torch's int64 does); min and max start from the caller's sentinel, which
// they keep for an empty cell, and keep a NaN once they have seen one.
//
// What bounds it: device-memory bytes. The cell column and each validity and
// value column are read once.
//
// Design. The unit of work is the Aggregate, not one reduction: the earlier
// form made two launches for every reduction, each reading the cell column
// again. Now:
// - One kernel a call, no memset: each block writes one partial of every
//   accumulator, and the last block to finish (a ticket after
//   __threadfence) folds them in block order and puts the ticket back to 0.
//   The only atomic is the ticket's.
// - Tiles of 2,048 rows up to 8 cells, 1,024 above: thread t takes rows
//   4t .. 4t + 3 of a tile, and up to 8 cells 4t + 1024 .. 4t + 1027 too,
//   each four a 16-byte load of a 4-byte column (two of an 8-byte one, a
//   4-byte load of a validity column) where the column is aligned, a load a
//   row where it is not or the rows run out. The first fold's loads are
//   issued with the cells', before any row is folded. A thread keeps little
//   (the tile's cells and what one fold reads), so 3 blocks of 256 threads
//   fit an SM and their loads keep the memory busy; the grid is min(tiles,
//   3 blocks an SM), so a small call runs on few blocks. (Columns staged in
//   shared memory by bulk copies, or by cp.async, with two blocks an SM,
//   measured slower here, and so did 32 folder threads a block above 8
//   cells.)
// - The cells are decoded once a tile, into registers, and each validity
//   column into 8 bits a thread in shared memory; every accumulator reuses
//   them. One switch a fold a tile picks an inner loop compiled for its
//   (input type, fold) and for the cell count's bucket.
// - 1 to 8 cells: every thread counts its rows a cell in registers, and
//   folds them into a private row of accumulators in shared memory
//   (accumulator-major, thread-minor, so a warp's 32 threads touch 32 banks
//   whatever their cells): n_acc * n_cells * 2 KB a block.
// - 9 to 64 cells: per 32-row step of a warp, __match_any_sync groups the
//   lanes of one cell once a tile; pointer jumping along each group (lane
//   order, at most five shuffles, as many as the largest group needs) folds
//   a group into its lowest lane, which folds it into the warp's row. Counts
//   are the groups' popcounts. A warp's row holds n_acc * n_cells 8-byte
//   accumulators (4 KB an accumulator at 64 cells for the 8 warps, against
//   the 128 KB a block of per-thread rows took). This tier is 2 to 2.5 times
//   slower than those per-thread rows for one sum (PERF.md section 6).
// - Bits: a row's place in the fold (its thread, its step, its group's tree,
//   the block's fixed order over its threads or warps) depends only on n and
//   the cells, never on which other accumulators share the launch, so a
//   reduction gives the same bits alone, batched or split over launches, and
//   on every call. Joins on a float sum rely on that.
// - cudaFuncSetAttribute runs once, when the library is loaded. The fold
//   helpers are cells_reduce.cuh's (K6's engine).

#include <cstdint>
#include <cstring>
#include <initializer_list>

#include "cells_reduce.cuh"

namespace {

using cells::Bits;
using cells::kFullWarp;
using cells::kSum;
using cells::kMin;
using cells::kMax;

constexpr int kThreads = cells::kThreads;  // 256
constexpr int kWarps = cells::kWarps;
constexpr int kVec = 4;                    // rows a vector

// Rows a thread a tile: two vectors up to 8 cells, one above (where a
// thread holds each row's group plan too); a tile is kThreads times as many.
__host__ __device__ constexpr int rows_for(int n_cells) { return n_cells <= 8 ? 8 : 4; }
constexpr int kMaxCells = cells::kMaxCells;
constexpr int kWide = cells::kWide;        // the bucket of 9 to 64 cells
constexpr int kMaxValidities = 16;
constexpr int kMaxFolds = 16;
constexpr int kMaxShared = cells::kMaxShared;
constexpr int kHeader = 16;                // the last-block flag
constexpr int kMinBlocks = 3;              // blocks an SM the registers leave room for

enum Type { kF64 = 0, kF32 = 1, kI64 = 2, kI32 = 3 };

struct FoldArg {
  const void* values;
  Bits init;     // 0 for a sum, the sentinel's bits in the wide type for min / max
  int type;
  int op;
  int validity;  // index into Job::validities, or -1: every row counts
  int aligned;   // values on a 16-byte boundary
};

// A launch's arguments, a __grid_constant__ kernel parameter. Accumulator a
// of cell c is entry a * n_cells + c: a = 0 the row count, then one count a
// validity column, then one a fold.
struct Job {
  const int* cell;
  const unsigned char* validities[kMaxValidities];
  FoldArg folds[kMaxFolds];
  Bits* out;  // n_entries results, then gridDim.x * n_entries partials
  unsigned* ticket;
  long long n;
  int n_cells;
  int n_validities;
  int n_folds;
  int n_entries;
  int cell_aligned;
  unsigned validity_aligned;  // bit v: validities[v] on a 4-byte boundary
};

__host__ __device__ constexpr int bucket(int n_cells) {
  return n_cells <= 8 ? n_cells : kWide;
}

// The dynamic shared memory of a block: the flag, the accumulators (a row
// a thread up to 8 cells, a row a warp above) and a byte a thread a validity
// column.
__host__ __device__ constexpr int shared_bytes(int n_entries, int n_validities, int n_cells) {
  return kHeader + (n_cells <= 8 ? kThreads : kWarps) * n_entries * 8 + n_validities * kThreads;
}

// Entry e's kind (its op times 2, plus 1 for a float accumulator) and start.
__device__ __forceinline__ int kind_of(const Job& job, int e) {
  const int f = e / job.n_cells - 1 - job.n_validities;
  if (f < 0) return kSum * 2;
  return job.folds[f].op * 2 + (job.folds[f].type <= kF32 ? 1 : 0);
}

__device__ __forceinline__ Bits init_of(const Job& job, int e) {
  const int f = e / job.n_cells - 1 - job.n_validities;
  return f < 0 ? 0ULL : job.folds[f].init;
}

__device__ __forceinline__ Bits combine(int kind, Bits a, Bits b) {
  return cells::fold_bits(a, b, kind >> 1, (kind & 1) != 0);
}

// Entry e's result as the wrapper reads it: the min or max of float32 or
// int32 inputs in that type, in the low 4 bytes of the entry (it holds the
// value exactly), so no conversion follows the kernel.
__device__ __forceinline__ Bits finish(const Job& job, int e, Bits a) {
  const int f = e / job.n_cells - 1 - job.n_validities;
  if (f < 0 || job.folds[f].op == kSum) return a;
  if (job.folds[f].type == kF32) {
    return __float_as_uint(static_cast<float>(cells::from_bits<double>(a)));
  }
  if (job.folds[f].type == kI32) {
    return static_cast<unsigned>(static_cast<int>(cells::from_bits<long long>(a)));
  }
  return a;
}

// -- loads ------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T from_word(unsigned long long w) {
  T v;
  memcpy(&v, &w, sizeof(T));
  return v;
}

// Row r0 of this thread's vector k of the tile.
template <int R>
__device__ __forceinline__ long long row_of(long long tile, int k) {
  return tile * kThreads * R + kVec * (threadIdx.x + kThreads * k);
}

// This thread's rows of the tile of a column (vector k: rows row_of(tile,
// k) .. + 3, as out[4 k .. 4 k + 3]): 16-byte loads (one 4-byte load of a
// byte column) where the column is aligned and the four rows exist, else a
// load a row, `fill` past the end.
template <int R, typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ p, long long tile, long long n,
                                          bool aligned, T fill, T (&out)[R]) {
#pragma unroll
  for (int k = 0; k < R / kVec; ++k) {
    const long long r0 = row_of<R>(tile, k);
    T* o = out + kVec * k;
    if (aligned && r0 + kVec <= n) {
      if constexpr (sizeof(T) == 1) {
        const unsigned w = __ldcs(reinterpret_cast<const unsigned*>(p + r0));
#pragma unroll
        for (int j = 0; j < kVec; ++j) o[j] = static_cast<T>((w >> (8 * j)) & 0xFFu);
      } else if constexpr (sizeof(T) == 4) {
        const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p + r0));
        o[0] = from_word<T>(q.x);
        o[1] = from_word<T>(q.y);
        o[2] = from_word<T>(q.z);
        o[3] = from_word<T>(q.w);
      } else {
        const ulonglong2 a = __ldcs(reinterpret_cast<const ulonglong2*>(p + r0));
        const ulonglong2 b = __ldcs(reinterpret_cast<const ulonglong2*>(p + r0 + 2));
        o[0] = from_word<T>(a.x);
        o[1] = from_word<T>(a.y);
        o[2] = from_word<T>(b.x);
        o[3] = from_word<T>(b.y);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) o[j] = r0 + j < n ? p[r0 + j] : fill;
    }
  }
}

// A fold's rows of the tile as raw 8-byte words (a 4-byte value in the low
// half), so that its loads can be issued before the fold's type is looked at.
template <int R>
__device__ __forceinline__ void load_words(const Job& job, const FoldArg& f, long long tile,
                                           Bits (&w)[R]) {
  if (f.type == kF64 || f.type == kI64) {
    load_rows<R, Bits>(static_cast<const Bits*>(f.values), tile, job.n, f.aligned != 0, 0ULL, w);
  } else {
    unsigned v[R];
    load_rows<R, unsigned>(static_cast<const unsigned*>(f.values), tile, job.n, f.aligned != 0,
                           0u, v);
#pragma unroll
    for (int j = 0; j < R; ++j) w[j] = v[j];
  }
}

// -- a fold of a value column over the tile -------------------------------------

// Up to 8 cells: folds the thread's rows whose bit of `valid` is set into its
// private accumulators `acc` (n_cells of them, kThreads apart).
template <int R, int OP, typename T, typename Acc>
__device__ __forceinline__ void fold_private(const FoldArg& f, const Bits (&w)[R],
                                             unsigned valid, const int (&c)[R], Bits* acc) {
  Acc* a = reinterpret_cast<Acc*>(acc);
#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (((valid >> j) & 1u) && c[j] >= 0) {
      Acc& slot = a[c[j] * kThreads];
      slot = cells::fold<OP>(slot, static_cast<Acc>(from_word<T>(w[j])));
    }
  }
}

// 9 to 64 cells: a step's plan, one word a lane (a step is a row of each
// lane of the warp): bits 0-2 the jumps the step needs (the largest group
// of lanes with one cell, its size rounded up to a power of two, as a log),
// bits 3 + 5 s .. 7 + 5 s the lane 2^s places further along this lane's
// group (this lane itself where there is none), bit 31 set on the group's
// lowest lane.
__device__ __forceinline__ unsigned make_plan(int cq, unsigned* peers_out) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullWarp, cq);
  const unsigned below = (1u << lane) - 1u;
  const unsigned above = peers & ~below & ~(1u << lane);
  int next = above ? __ffs(above) - 1 : lane;
  const int biggest = static_cast<int>(__reduce_max_sync(kFullWarp, __popc(peers)));
  const int jumps = biggest <= 1 ? 0 : 32 - __clz(biggest - 1);
  unsigned plan = static_cast<unsigned>(jumps) | ((peers & below) == 0 ? 1u << 31 : 0u);
  for (int s = 0; s < jumps; ++s) {
    plan |= static_cast<unsigned>(next) << (3 + 5 * s);
    const int further = __shfl_sync(kFullWarp, next, next);
    next = (next == lane || further == next) ? lane : further;
  }
  *peers_out = peers;
  return plan;
}

// 9 to 64 cells: folds one accumulator over the thread's rows, a step at a
// time: rows whose bit of `valid` is clear take part as `identity`, so every
// group keeps its shape; pointer jumping folds each group, in lane order,
// into its lowest lane, which folds it into the warp's row `acc`.
template <int R, int OP, typename T, typename Acc>
__device__ __forceinline__ void fold_groups(const FoldArg& f, const Bits (&w)[R],
                                            unsigned valid, const int (&c)[R],
                                            const unsigned (&plan)[R], Bits* acc) {
  Acc* a = reinterpret_cast<Acc*>(acc);
  const Acc identity = OP == kSum ? Acc(0) : cells::from_bits<Acc>(f.init);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    Acc v = (valid >> j) & 1u ? static_cast<Acc>(from_word<T>(w[j])) : identity;
    const unsigned p = plan[j];
    const int jumps = p & 7u;
    for (int s = 0; s < jumps; ++s) {
      const int src = (p >> (3 + 5 * s)) & 31u;
      const Acc got = __shfl_sync(kFullWarp, v, src);
      if (src != lane) v = cells::fold<OP>(v, got);
    }
    if ((p >> 31) && c[j] >= 0) a[c[j]] = cells::fold<OP>(a[c[j]], v);
    __syncwarp();
  }
}

// One fold of the tile: up to 8 cells each thread into its private row,
// above by groups into the warp's row.
template <int B, int R>
__device__ __forceinline__ void fold_slot(const FoldArg& f, const Bits (&w)[R],
                                          unsigned valid, const int (&c)[R],
                                          const unsigned (&plan)[R], Bits* acc) {
#define K3_FOLD(OP, T, ACC)                                       \
  if constexpr (B <= 8) {                                         \
    fold_private<R, OP, T, ACC>(f, w, valid, c, acc);             \
  } else {                                                        \
    fold_groups<R, OP, T, ACC>(f, w, valid, c, plan, acc);        \
  }                                                               \
  break;
  switch (f.type * 3 + f.op) {
    case kF64 * 3 + kSum: K3_FOLD(kSum, double, double)
    case kF64 * 3 + kMin: K3_FOLD(kMin, double, double)
    case kF64 * 3 + kMax: K3_FOLD(kMax, double, double)
    case kF32 * 3 + kSum: K3_FOLD(kSum, float, double)
    case kF32 * 3 + kMin: K3_FOLD(kMin, float, double)
    case kF32 * 3 + kMax: K3_FOLD(kMax, float, double)
    case kI64 * 3 + kSum: K3_FOLD(kSum, long long, long long)
    case kI64 * 3 + kMin: K3_FOLD(kMin, long long, long long)
    case kI64 * 3 + kMax: K3_FOLD(kMax, long long, long long)
    case kI32 * 3 + kSum: K3_FOLD(kSum, int, long long)
    case kI32 * 3 + kMin: K3_FOLD(kMin, int, long long)
    default: K3_FOLD(kMax, int, long long)
  }
#undef K3_FOLD
}

// -- the kernel -----------------------------------------------------------------

template <int B>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
group_reduce_kernel(const __grid_constant__ Job job) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  int* is_last = reinterpret_cast<int*>(shared_raw);
  const int ne = job.n_entries;
  const int n_cells = job.n_cells;
  // accumulator a of cell c is entry e = a * n_cells + c: up to 8 cells a
  // row a thread, acc[e * kThreads + thread]; above a row a warp,
  // acc[warp * ne + e]
  constexpr int kWidth = B <= 8 ? kThreads : kWarps;
  auto at = [&](int e, int t) { return B <= 8 ? e * kThreads + t : t * ne + e; };
  Bits* acc = reinterpret_cast<Bits*>(shared_raw + kHeader);
  unsigned char* masks = reinterpret_cast<unsigned char*>(acc + kWidth * ne);  // 8 bits a thread
  for (int i = threadIdx.x; i < kWidth * ne; i += kThreads) {
    acc[i] = init_of(job, B <= 8 ? i / kThreads : i % ne);
  }
  __syncthreads();
  // accumulator a of this thread's cell 0, cells kThreads apart (up to 8
  // cells) or adjacent (above, the warp's)
  auto mine = [&](int a) { return acc + at(a * n_cells, B <= 8 ? threadIdx.x : threadIdx.x >> 5); };

  const long long n = job.n;
  constexpr int R = rows_for(B);
  constexpr int kTile = kThreads * R;
  const long long tiles = (n + kTile - 1) / kTile;
  int counts[B <= 8 ? B : 1];  // up to 8 cells: this thread's rows a cell
#pragma unroll
  for (int k = 0; k < (B <= 8 ? B : 1); ++k) counts[k] = 0;
  int c[R];
  unsigned plan[R];
  unsigned peers[R];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // the cells and the first fold's values, both loads in flight at once
    int raw[R];
    load_rows<R, int>(job.cell, tile, n, job.cell_aligned != 0, -1, raw);
    Bits first[R];
    if (job.n_folds > 0) load_words<R>(job, job.folds[0], tile, first);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      c[j] = static_cast<unsigned>(raw[j]) < static_cast<unsigned>(n_cells) ? raw[j] : -1;
    }
    if constexpr (B <= 8) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int k = 0; k < B; ++k) counts[k] += c[j] == k ? 1 : 0;
      }
    } else {
      long long* count = reinterpret_cast<long long*>(mine(0));
#pragma unroll
      for (int j = 0; j < R; ++j) {
        plan[j] = make_plan(c[j], &peers[j]);
        if ((plan[j] >> 31) && c[j] >= 0) count[c[j]] += __popc(peers[j]);
        __syncwarp();
      }
    }
    // each validity column: its 8 bits of this thread's rows for the folds
    // that read it, and its valid rows a cell
    for (int v = 0; v < job.n_validities; ++v) {
      unsigned char b[R];
      load_rows<R, unsigned char>(job.validities[v], tile, n,
                               ((job.validity_aligned >> v) & 1u) != 0,
                               static_cast<unsigned char>(0), b);
      unsigned bits = 0;
#pragma unroll
      for (int j = 0; j < R; ++j) bits |= (b[j] != 0 ? 1u : 0u) << j;
      masks[v * kThreads + threadIdx.x] = static_cast<unsigned char>(bits);
      long long* count = reinterpret_cast<long long*>(mine(1 + v));
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if constexpr (B <= 8) {
          if (((bits >> j) & 1u) && c[j] >= 0) count[c[j] * kThreads] += 1;
        } else {
          const unsigned voted = __ballot_sync(kFullWarp, (bits >> j) & 1u);
          if ((plan[j] >> 31) && c[j] >= 0) count[c[j]] += __popc(peers[j] & voted);
          __syncwarp();
        }
      }
    }
    for (int f = 0; f < job.n_folds; ++f) {
      const FoldArg& fa = job.folds[f];
      const unsigned valid = fa.validity < 0 ? 0xFFu : masks[fa.validity * kThreads + threadIdx.x];
      Bits w[R];
      if (f == 0) {
#pragma unroll
        for (int j = 0; j < R; ++j) w[j] = first[j];
      } else {
        load_words<R>(job, fa, tile, w);
      }
      fold_slot<B, R>(fa, w, valid, c, plan, mine(1 + job.n_validities + f));
    }
  }
  if constexpr (B <= 8) {
    long long* count = reinterpret_cast<long long*>(mine(0));
#pragma unroll
    for (int k = 0; k < B; ++k) count[k * kThreads] = counts[k];
  }

  // the block's partial of each entry: a warp an entry, lane l folding the
  // rows (threads or warps) l, l + 32, ... in order, then a fixed butterfly
  __syncthreads();
  Bits* out = job.out;
  const bool alone = gridDim.x == 1;
  const int lane = threadIdx.x & 31;
  for (int e = threadIdx.x >> 5; e < ne; e += kWarps) {
    const int kind = kind_of(job, e);
    Bits a = init_of(job, e);
    for (int t = lane; t < kWidth; t += 32) a = combine(kind, a, acc[at(e, t)]);
#pragma unroll
    for (int off = 16; off >= 1; off /= 2) {
      a = combine(kind, a, __shfl_xor_sync(kFullWarp, a, off));
    }
    if (lane == 0) {
      if (alone) {
        out[e] = finish(job, e, a);
      } else {
        out[ne + static_cast<long long>(blockIdx.x) * ne + e] = a;
      }
    }
  }
  if (alone) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *is_last = atomicAdd(job.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*is_last == 0) return;
  __threadfence();

  // the last block: a warp two entries at a time, lane l folding blocks l,
  // l + 32, ... in order (four loads in flight an entry), then a fixed
  // butterfly
  constexpr int kEntries = 2;
  constexpr int kLoads = 4;
  const Bits* partials = out + ne;
  const int blocks = static_cast<int>(gridDim.x);
  for (int e0 = (threadIdx.x >> 5) * kEntries; e0 < ne; e0 += kWarps * kEntries) {
    Bits a[kEntries];
    int kind[kEntries];
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      kind[i] = e0 + i < ne ? kind_of(job, e0 + i) : 0;
      a[i] = e0 + i < ne ? init_of(job, e0 + i) : 0ULL;
    }
    for (int b0 = lane; b0 < blocks; b0 += 32 * kLoads) {
      Bits v[kEntries][kLoads];
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int b = b0 + 32 * q;
          v[i][q] = e0 + i < ne && b < blocks
                        ? __ldcg(partials + static_cast<long long>(b) * ne + e0 + i) : a[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          if (b0 + 32 * q < blocks) a[i] = combine(kind[i], a[i], v[i][q]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      if (e0 + i >= ne) continue;  // the same for every lane of the warp
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) {
        a[i] = combine(kind[i], a[i], __shfl_xor_sync(kFullWarp, a[i], off));
      }
      if (lane == 0) out[e0 + i] = finish(job, e0 + i, a[i]);
    }
  }
  if (threadIdx.x == 0) *job.ticket = 0u;  // every block has taken its ticket
}

typedef void (*Kernel)(const Job);

Kernel kernel_for(int n_cells) {
  switch (bucket(n_cells)) {
    case 1: return group_reduce_kernel<1>;
    case 2: return group_reduce_kernel<2>;
    case 3: return group_reduce_kernel<3>;
    case 4: return group_reduce_kernel<4>;
    case 5: return group_reduce_kernel<5>;
    case 6: return group_reduce_kernel<6>;
    case 7: return group_reduce_kernel<7>;
    case 8: return group_reduce_kernel<8>;
    default: return group_reduce_kernel<kWide>;
  }
}

bool aligned_to(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" {

int group_reduce_threads_per_block() { return kThreads; }
int group_reduce_tile_rows(int n_cells) { return kThreads * rows_for(n_cells); }
int group_reduce_max_cells() { return kMaxCells; }
int group_reduce_max_folds() { return kMaxFolds; }
int group_reduce_max_validities() { return kMaxValidities; }

// Dynamic shared memory of a block with n_entries accumulators, n_validities
// validity columns and n_cells cells.
int group_reduce_shared_bytes(int n_entries, int n_validities, int n_cells) {
  return shared_bytes(n_entries, n_validities, n_cells);
}

// Allows every kernel all the dynamic shared memory a block may have; called
// once, when the library is loaded. Returns the first error.
int group_reduce_init() {
  for (int n_cells : {1, 2, 3, 4, 5, 6, 7, 8, kWide}) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel_for(n_cells), cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// cell: n int32 cell ids. validities: n_validities byte columns. Fold f reads
// values[f] of value_types[f] (0 float64, 1 float32, 2 int64, 3 int32) with
// ops[f] (0 sum, 1 min, 2 max), takes the rows where
// validities[fold_validity[f]] is not 0 (-1: every row) and starts from
// inits[f] (the bits of a double for float inputs, an int64 otherwise; 0 for
// a sum). `out` holds n_acc * n_cells 8-byte results, n_acc = 1 +
// n_validities + n_folds (the row count, the validity counts, the folds; the
// min or max of float32 or int32 values in that type, in an entry's low 4
// bytes), and behind them, where blocks > 1, blocks times as many partials.
// `ticket` is a zeroed word no other launch uses while this one runs; the
// kernel leaves it zeroed. One kernel on `stream` over `blocks` blocks, no
// synchronisation; returns the first CUDA error.
int group_reduce_cells(const void* cell, long long n, int n_cells, int n_validities,
                       const void* const* validities, int n_folds, const void* const* values,
                       const int* value_types, const int* ops, const int* fold_validity,
                       const long long* inits, void* out, void* ticket, int blocks,
                       void* stream_ptr) {
  if (n < 0 || n_cells < 1 || n_cells > kMaxCells || n_validities < 0 ||
      n_validities > kMaxValidities || n_folds < 0 || n_folds > kMaxFolds || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Job job = {};
  job.cell = static_cast<const int*>(cell);
  job.cell_aligned = aligned_to(cell, 16) ? 1 : 0;
  for (int v = 0; v < n_validities; ++v) {
    job.validities[v] = static_cast<const unsigned char*>(validities[v]);
    if (aligned_to(validities[v], 4)) job.validity_aligned |= 1u << v;
  }
  for (int f = 0; f < n_folds; ++f) {
    if (value_types[f] < kF64 || value_types[f] > kI32 || ops[f] < kSum || ops[f] > kMax ||
        fold_validity[f] < -1 || fold_validity[f] >= n_validities) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    job.folds[f] = {values[f], static_cast<Bits>(ops[f] == kSum ? 0LL : inits[f]),
                    value_types[f], ops[f], fold_validity[f], aligned_to(values[f], 16) ? 1 : 0};
  }
  job.out = static_cast<Bits*>(out);
  job.ticket = static_cast<unsigned*>(ticket);
  job.n = n;
  job.n_cells = n_cells;
  job.n_validities = n_validities;
  job.n_folds = n_folds;
  job.n_entries = (1 + n_validities + n_folds) * n_cells;
  const int shared = shared_bytes(job.n_entries, n_validities, n_cells);
  if (shared > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  kernel_for(n_cells)<<<static_cast<unsigned>(blocks), kThreads, shared, stream>>>(job);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
