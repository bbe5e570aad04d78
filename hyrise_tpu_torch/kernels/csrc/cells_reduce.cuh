// The dense-cell reduction engine of fused_reduce.cu (K6), for Hopper
// (sm_90a).
//
// It folds rows into at most 64 cells: every row has a cell (0..n_cells-1,
// or none), and every accumulator folds one input of the rows of a cell as
// a sum, a minimum, a maximum or a row count. What bounds it on this card is
// device-memory bytes: each input column is read once. What held K6's
// earlier form back was everything else (PERF.md section 6): one row a thread a
// step behind dependent 1- to 8-byte loads, the cell and every slot's type
// and fold decoded again for every row, and n_acc * n_cells * threads
// 8-byte accumulators in shared memory that left one to three blocks an SM.
// The design, piece by piece:
//
// - Tiles of RPT * 256 rows (RPT = 8 or 4 rows a thread), double-buffered
//   in shared memory by the tensor memory accelerator: one thread starts
//   one bulk copy a column a tile, counted on the stage's mbarrier, and the
//   next tile's copies are in flight while the block folds the current one.
//   The wrapper picks the tile so that two blocks fit an SM wherever they
//   can. A column's copy covers the 16-byte-aligned range around the
//   tile's bytes (views one element into a buffer are common); that range
//   never leaves the 16-byte granules of the tensor's own allocation. Row j
//   of the tile then sits at the stage's region of the column plus
//   (base % 16) plus j * element size. (Per-thread 16-byte cp.async copies
//   read the same; three or four stages read no faster than two.)
// - Decode once a tile: each thread computes the cell of its RPT rows
//   (mask, mixed-radix codes, range check) into registers, and, where
//   folders need them, into a byte array of the tile; every accumulator
//   reuses them.
// - One switch a slot a tile picks an inner loop specialised at compile
//   time on (input type, fold) and on the cell count's bucket: no slot list
//   is walked and no op branch is taken per row.
// - Accumulators without atomics and in a fixed order, two ways:
//   1 to 8 cells (a bucket each): a thread folds its rows into n_cells
//   registers by predicated compares, then a warp reduce-scatter by
//   shuffles leaves one lane per cell, which folds into the warp's
//   accumulator in shared memory (n_acc * n_cells * 8 warps * 8 bytes).
//   9 to 64 cells (one bucket): private accumulators for a fraction of the
//   threads, `folders` = 128, 64 or 32 of the 256, thread t folding rows t,
//   t + folders, ... of every tile into its own row of shared memory
//   (n_acc * n_cells * folders * 8 bytes, at most half the earlier layout);
//   the other threads only decode.
// - One kernel a call: each block folds its warps' or folders' rows of an
//   entry (a warp an entry: lanes in index order, then a fixed butterfly)
//   and writes one partial; the last block to finish (a ticket after
//   __threadfence) folds all partials the same way, lane l taking blocks l,
//   l + 32, ... The bits depend on the inputs and the launch shape, never on
//   which block finished last. The last block puts the ticket back to 0, so
//   no memset precedes a call.
// - The block copies the launch's job (its arguments) into shared memory
//   first: read through a pointer to the kernel parameter, per row and per
//   fold, it cost more than the loads.
//
// K3 (group_reduce.cu) uses this file's fold helpers (fold, from_bits,
// fold_bits) in a loop of its own.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace cells {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 64;
constexpr int kWide = kMaxCells;  // the bucket of 9 to 64 cells
constexpr int kOut = 0xFF;        // the cell byte of a row that takes no part
constexpr unsigned kFullWarp = 0xFFFFFFFFu;
constexpr int kMaxShared = 227 * 1024;
constexpr int kStages = 2;       // the tiles a block holds: one folded, one in flight
constexpr int kJobBytes = 1280;  // a launch's job, copied into shared memory
constexpr int kMinBlocks = 3;    // blocks an SM the registers must leave room for

enum Op { kSum = 0, kMin = 1, kMax = 2 };

typedef unsigned long long Bits;  // one accumulator: a double or a long long

// The bucket of a cell count: the B of the inner loops.
__host__ __device__ constexpr int bucket(int n_cells) {
  return n_cells <= 8 ? n_cells : kWide;
}

// A staged column: its device base, element bytes, and the offset of its
// region inside a stage.
struct Column {
  const unsigned char* base;
  int bytes;
  int offset;
};

// Bytes one stage gives a column of `bytes`-byte elements.
__host__ __device__ constexpr int region_bytes(int tile_rows, int bytes) {
  return tile_rows * bytes + 16;
}

// The dynamic shared memory of a block: the job, the two stages, the
// accumulators (n_entries of `width`: 8 warps, or the folders), the tile's
// cell bytes, a flag word and the stages' barriers. The kernels keep no
// static shared memory.
__host__ __device__ constexpr int shared_bytes(int stage_bytes, int tile_rows, int n_entries,
                                               int width) {
  return kJobBytes + kStages * stage_bytes + n_entries * width * 8 + tile_rows + 16 +
         8 * kStages;
}

// What a launch is given beside its job: a stage's bytes and the
// accumulators' width.
struct Shape {
  int stage_bytes;
  int width;  // kWarps for 1 to 8 cells, else the folders
};

// min/max keep a NaN once they have seen one, as amin/amax do; integer sums
// wrap as int64 does in torch.
template <int OP, typename Acc>
__device__ __forceinline__ Acc fold(Acc a, Acc b) {
  if constexpr (OP == kMin) {
    return (b < a || b != b) ? b : a;
  } else if constexpr (OP == kMax) {
    return (b > a || b != b) ? b : a;
  } else if constexpr (std::is_same<Acc, long long>::value) {
    return static_cast<long long>(static_cast<Bits>(a) + static_cast<Bits>(b));
  } else {
    return a + b;
  }
}

template <typename Acc>
__device__ __forceinline__ Bits to_bits(Acc a) {
  if constexpr (std::is_same<Acc, double>::value) {
    return static_cast<Bits>(__double_as_longlong(a));
  } else {
    return static_cast<Bits>(a);
  }
}

template <typename Acc>
__device__ __forceinline__ Acc from_bits(Bits b) {
  if constexpr (std::is_same<Acc, double>::value) {
    return __longlong_as_double(static_cast<long long>(b));
  } else {
    return static_cast<long long>(b);
  }
}

// The fold of two accumulators whose op and type are known only at run time
// (the last block's combine of K6).
__device__ __forceinline__ Bits fold_bits(Bits a, Bits b, int op, bool is_float) {
  if (is_float) {
    const double x = from_bits<double>(a), y = from_bits<double>(b);
    return to_bits(op == kMin ? fold<kMin>(x, y) : op == kMax ? fold<kMax>(x, y)
                                                              : fold<kSum>(x, y));
  }
  const long long x = from_bits<long long>(a), y = from_bits<long long>(b);
  return to_bits(op == kMin ? fold<kMin>(x, y) : op == kMax ? fold<kMax>(x, y)
                                                            : fold<kSum>(x, y));
}

// -- staging -------------------------------------------------------------------

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// Arrives once and tells the barrier how many bytes the copies will bring.
__device__ __forceinline__ void barrier_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void barrier_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One bulk copy by the tensor memory accelerator, counted on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Called by one thread: the copies of rows [first, end) of every column into
// `stage`, one bulk copy a column, all counted on `bar`.
__device__ __forceinline__ void stage_tile(const Column* cols, int n_cols, long long first,
                                           long long end, unsigned char* stage,
                                           unsigned bar) {
  unsigned total = 0;
  for (int c = 0; c < n_cols; ++c) {
    const Column col = cols[c];
    const uintptr_t lo =
        reinterpret_cast<uintptr_t>(col.base + first * col.bytes) & ~uintptr_t(15);
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(col.base + end * col.bytes) + 15) & ~uintptr_t(15);
    total += static_cast<unsigned>(hi - lo);
  }
  barrier_expect(bar, total);
  const unsigned stage_addr = shared_address(stage);
  for (int c = 0; c < n_cols; ++c) {
    const Column col = cols[c];
    const uintptr_t lo =
        reinterpret_cast<uintptr_t>(col.base + first * col.bytes) & ~uintptr_t(15);
    const uintptr_t hi =
        (reinterpret_cast<uintptr_t>(col.base + end * col.bytes) + 15) & ~uintptr_t(15);
    bulk_copy(stage_addr + col.offset, reinterpret_cast<const void*>(lo),
              static_cast<unsigned>(hi - lo), bar);
  }
}

// Row 0 of the current tile of `col` inside `stage`.
__device__ __forceinline__ const unsigned char* staged(const unsigned char* stage,
                                                       const Column& col) {
  return stage + col.offset + (reinterpret_cast<uintptr_t>(col.base) & 15);
}

// -- the inner loops -------------------------------------------------------------

// Inputs of a fold: a staged column widened to Acc, or a 1 for every row.
template <typename T, typename Acc>
struct ColumnInput {
  const unsigned char* rows;
  __device__ __forceinline__ Acc operator()(int j) const {
    return static_cast<Acc>(reinterpret_cast<const T*>(rows)[j]);
  }
};

struct CountInput {
  __device__ __forceinline__ long long operator()(int) const { return 1LL; }
};

// 1 to 8 cells: registers, then a reduce-scatter across the warp into the
// warp's accumulators wacc[cell * kWarps + warp].
template <int B, int RPT, int OP, typename Acc, class Input>
__device__ __forceinline__ void fold_select(const Input& input, const unsigned char* valid,
                                            const int (&cb)[RPT], Acc init, Acc* wacc) {
  constexpr int P = B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;  // cells padded to 2^k
  Acc a[P];
#pragma unroll
  for (int k = 0; k < P; ++k) a[k] = init;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int j = threadIdx.x + i * kThreads;
    int c = cb[i];
    if (valid != nullptr && valid[j] == 0) c = kOut;
    const Acc v = input(j);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (c == k) a[k] = fold<OP>(a[k], v);
    }
  }
  // each step halves the cells a lane holds and doubles the lanes behind
  // each of them; lane bit `off` says which half it keeps
  const int lane = threadIdx.x & 31;
  int cell = 0;
#pragma unroll
  for (int h = P / 2; h >= 1; h /= 2) {
    const int off = 32 * h / P;
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int k = 0; k < h; ++k) {
      const Acc send = upper ? a[k] : a[k + h];
      const Acc keep = upper ? a[k + h] : a[k];
      const Acc got = __shfl_xor_sync(kFullWarp, send, off);
      a[k] = upper ? fold<OP>(got, keep) : fold<OP>(keep, got);
    }
    if (upper) cell += h;
  }
#pragma unroll
  for (int off = 16 / P; off >= 1; off /= 2) {
    a[0] = fold<OP>(a[0], __shfl_xor_sync(kFullWarp, a[0], off));
  }
  if ((lane & (32 / P - 1)) == 0 && cell < B) {
    Acc& w = wacc[cell * kWarps + (threadIdx.x >> 5)];
    w = fold<OP>(w, a[0]);
  }
}

// 9 to 64 cells: thread t < folders folds rows t, t + folders, ... of the
// tile into its own accumulators pacc[cell * folders + t], four rows' loads
// ahead of their folds.
template <int RPT, int OP, typename Acc, class Input>
__device__ __forceinline__ void fold_private(const Input& input, const unsigned char* valid,
                                             const unsigned char* tile_cells, int folders,
                                             Acc* pacc) {
  constexpr int kTile = RPT * kThreads;
  if (static_cast<int>(threadIdx.x) >= folders) return;
  Acc* mine = pacc + threadIdx.x;
  for (int j0 = threadIdx.x; j0 < kTile; j0 += 4 * folders) {
    int c[4];
    Acc v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q * folders;
      c[q] = tile_cells[j];
      if (valid != nullptr && valid[j] == 0) c[q] = kOut;
      v[q] = input(j);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c[q] != kOut) {
        Acc& p = mine[c[q] * folders];
        p = fold<OP>(p, v[q]);
      }
    }
  }
}

// The current tile as the folds see it.
struct Tile {
  const unsigned char* cells;  // a byte a row: its cell, or kOut
  Bits* wacc;                  // n_entries * width accumulators
  int width;
};

// Fold one accumulator, whose entries start at `wacc_bits`, over the tile.
template <int B, int RPT, int OP, typename Acc, class Input>
__device__ __forceinline__ void fold_tile(const Input& input, const unsigned char* valid,
                                          const int (&cb)[RPT], const Tile& t, Acc init,
                                          Bits* wacc_bits) {
  Acc* wacc = reinterpret_cast<Acc*>(wacc_bits);
  if constexpr (B <= 8) {
    fold_select<B, RPT, OP, Acc>(input, valid, cb, init, wacc);
  } else {
    fold_private<RPT, OP, Acc>(input, valid, t.cells, t.width, wacc);
  }
}

// Folds `width` accumulators a entry into one, a warp an entry: lane l takes
// l, l + 32, ... in order, then a fixed butterfly; lane 0 calls
// write(e, result). A warp takes two entries at a time and has eight loads
// in flight before it folds them (the last block reads the partials from
// L2); more would hold registers that the whole kernel then pays for.
template <class Job, class Load, class Write>
__device__ __forceinline__ void fold_entries(const Job& job, int n_entries, int width,
                                             const Load& load, const Write& write) {
  constexpr int kEntries = 2;
  constexpr int kLoads = 4;
  const int lane = threadIdx.x & 31;
  for (int e0 = (threadIdx.x >> 5) * kEntries; e0 < n_entries; e0 += kWarps * kEntries) {
    Bits a[kEntries];
    int kind[kEntries];
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      kind[i] = e0 + i < n_entries ? job.kind(e0 + i) : 0;
      a[i] = job.init_of(kind[i]);
    }
    for (int k0 = lane; k0 < width; k0 += 32 * kLoads) {
      Bits v[kEntries][kLoads];
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          const int k = k0 + 32 * q;
          v[i][q] = e0 + i < n_entries && k < width ? load(e0 + i, k) : a[i];
        }
      }
#pragma unroll
      for (int i = 0; i < kEntries; ++i) {
        if (e0 + i >= n_entries) continue;
        const Bits init = job.init_of(kind[i]);
#pragma unroll
        for (int q = 0; q < kLoads; ++q) {
          a[i] = job.combine(kind[i], a[i], k0 + 32 * q < width ? v[i][q] : init);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kEntries; ++i) {
      if (e0 + i >= n_entries) continue;  // the same for every lane of the warp
#pragma unroll
      for (int off = 16; off >= 1; off /= 2) {
        a[i] = job.combine(kind[i], a[i], __shfl_xor_sync(kFullWarp, a[i], off));
      }
      if (lane == 0) write(e0 + i, a[i]);
    }
  }
}

// Runs a block over tiles of RPT * kThreads rows: `job` supplies
//   columns() / n_cols (the staged columns), n, n_entries,
//   kind(e) (what entry e folds: a small number), init_of(kind) (its
//   identity bits), combine(kind, a, b) (the fold of two of its bits),
//   decode(stage, j) -> the cell of tile row j, or kOut,
//   fold(stage, cb, tile) (every accumulator over the tile),
//   kFolders (whether folders fold the tile, from its cell bytes),
// and the block writes its partial to partials[blockIdx.x * n_entries + e];
// the last block to finish folds them all into out[e]. The block reads the
// job from a copy in shared memory: a kernel parameter read through a
// pointer, per row and per fold, cost K6 more than its loads.
template <int RPT, class Job>
__device__ __forceinline__ void run(const Job& param, const Shape& shape, Bits* partials,
                                    Bits* out, unsigned* ticket) {
  static_assert(sizeof(Job) <= kJobBytes && sizeof(Job) % 4 == 0, "the job's copy");
  constexpr int kTile = RPT * kThreads;
  extern __shared__ __align__(16) unsigned char shared_raw[];
  for (int w = threadIdx.x; w < static_cast<int>(sizeof(Job) / 4); w += kThreads) {
    reinterpret_cast<unsigned*>(shared_raw)[w] = reinterpret_cast<const unsigned*>(&param)[w];
  }
  __syncthreads();
  const Job& job = *reinterpret_cast<const Job*>(shared_raw);
  unsigned char* ring = shared_raw + kJobBytes;
  const int n_entries = job.n_entries;
  Tile t;
  t.wacc = reinterpret_cast<Bits*>(ring + kStages * shape.stage_bytes);
  t.width = shape.width;
  unsigned char* tile_cells = reinterpret_cast<unsigned char*>(t.wacc + n_entries * t.width);
  t.cells = tile_cells;
  int* is_last = reinterpret_cast<int*>(tile_cells + kTile);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(tile_cells + kTile + 16);
  for (int e = threadIdx.x; e < n_entries * t.width; e += kThreads) {
    t.wacc[e] = job.init_of(job.kind(e / t.width));
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < kStages; ++k) barrier_init(shared_address(bars + k));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long tiles = (job.n + kTile - 1) / kTile;
  const long long grid = gridDim.x;
  auto stage_of = [&](int slot) { return ring + slot * shape.stage_bytes; };
  // one thread starts the copies of a tile; the others wait on its barrier
  auto fetch = [&](long long tile, int slot) {
    if (threadIdx.x == 0 && tile < tiles) {
      stage_tile(job.columns(), job.n_cols, tile * kTile, min(job.n, (tile + 1) * kTile),
                 stage_of(slot), shared_address(bars + slot));
    }
  };
  fetch(blockIdx.x, 0);
  int slot = 0;
  unsigned parity = 0;  // of the current slot's barrier: its uses so far, mod 2
  for (long long tile = blockIdx.x; tile < tiles; tile += grid) {
    // the slot the previous tile used, freed by the barrier that ended it
    fetch(tile + grid, slot ^ 1);
    barrier_wait(shared_address(bars + slot), parity);
    const unsigned char* stage = stage_of(slot);
    const int rows = static_cast<int>(min(static_cast<long long>(kTile),
                                          job.n - tile * kTile));
    int cb[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int j = threadIdx.x + i * kThreads;
      cb[i] = j < rows ? job.decode(stage, j) : kOut;
      if (Job::kFolders) tile_cells[j] = static_cast<unsigned char>(cb[i]);
    }
    // only the folders read other threads' rows
    if (Job::kFolders) __syncthreads();
    job.fold(stage, cb, t);
    __syncthreads();
    slot ^= 1;
    if (slot == 0) parity ^= 1u;
  }

  // the block's partial
  __syncthreads();
  const Bits* wacc = t.wacc;
  const int width = t.width;
  fold_entries(
      job, n_entries, width, [&](int e, int k) { return wacc[e * width + k]; },
      [&](int e, Bits a) { partials[static_cast<long long>(blockIdx.x) * n_entries + e] = a; });
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (*is_last == 0) return;
  __threadfence();
  fold_entries(
      job, n_entries, static_cast<int>(gridDim.x),
      [&](int e, int b) { return __ldcg(partials + static_cast<long long>(b) * n_entries + e); },
      [&](int e, Bits a) { out[e] = a; });
  if (threadIdx.x == 0) *ticket = 0u;  // every block has taken its ticket
}

}  // namespace cells
