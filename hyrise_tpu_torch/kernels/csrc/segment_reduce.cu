// Reduction over sorted segments for Hopper (sm_90a), behind a plain C
// interface that hyrise_tpu_torch/kernels/segment_reduce.py loads with ctypes.
//
// segment_reduce_sorted replaces hyrise_tpu/kernels/tpu_prims.py
// segment_sums_sorted (a flat cumsum and a gather at the segment ends) and
// the scatter-style segment_min/max beside it in the general group-by: with
// the rows already in group order, group g is positions [starts[g],
// starts[g+1]) of that order, and per group the kernel gives the count of
// valid inputs and their sum, minimum or maximum. Optionally the rows are
// named by a permutation (`rows`), so the gather into group order happens
// here, and a validity column (indexed like the values) drops NULL inputs.
//
// What bounds it: device-memory bytes: per position 8 bytes of permutation,
// the value and a validity byte, gathered at random through `rows` (a random
// 8-byte gather moves a 32-byte sector); per group 8 bytes of `starts` and 16
// bytes out. The lever is the number of gathers in flight.
//
// Design: the work is balanced over positions of the group order, not over
// groups, so one form serves 4 rows a group, a thousand groups, and a key of
// which one group holds a third of the rows.
//   tile_kernel: a block owns the kTile consecutive positions [t * kTile,
//     (t + 1) * kTile). Each thread loads kPerThread row ids (16-byte loads
//     where the tile lies inside the groups and `rows` is 16-byte aligned),
//     starts all its gathers of values and validity bytes before it uses any,
//     and stages value (a NULL input as the fold's identity) and valid flag
//     in shared memory in position order. Two warps find, by a 33-way search
//     of `starts`, the groups that start in the tile. The tile then folds
//     from shared memory, in position order: the part of the group that
//     began in an earlier tile (the tile's head), and every group that
//     starts here. A part of at most kShort positions is folded by one
//     thread, a longer one by a warp (lane l folds positions l, l + 32, ...
//     in order, then a fixed shuffle tree). A group that lies wholly in the
//     tile is written out; the head, and the part of a group that runs on
//     into the next tile (the tile's tail), go to per-tile partials.
//   straddle_kernel: a warp per tile folds the tile's tail with the heads of
//     the following tiles that belong to the same group (lane-strided, then
//     the same tree), so a group over a thousand tiles is as parallel as the
//     card.
//   group_sizes_kernel: a count without a validity column is starts[g + 1] -
//     starts[g]; no position is read.
// No atomics touch a result: equal inputs give equal bits on every launch.
// A float64 sum is the sequential sum in position order for a group of at
// most kShort positions inside one tile, and otherwise a fixed tree of
// sequential partial sums whose shape depends only on `starts`.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kWarps = kThreads / 32;
// parts of more positions than this are folded by a warp, not a thread
constexpr int kShort = 32;
constexpr int kLongSlots = kTile / (kShort + 1) + 1;
// items whose offsets a thread loads before it folds the first of them
constexpr int kItemBatch = 4;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

enum Op { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// min/max keep a NaN once they have seen one, as amin/amax do.
template <int OP, typename Acc>
__device__ __forceinline__ Acc fold(Acc a, Acc b) {
  if (OP == kMin) return (b < a || b != b) ? b : a;
  if (OP == kMax) return (b > a || b != b) ? b : a;
  return a + b;
}

// Lane 0 receives the fold of the 32 lanes' (acc, count) in a fixed tree.
template <int OP, typename Acc>
__device__ __forceinline__ void warp_fold(Acc& acc, long long& count) {
  for (int d = 16; d > 0; d >>= 1) {
    count += __shfl_down_sync(kFullWarp, count, d);
    if (OP != kCount) acc = fold<OP>(acc, __shfl_down_sync(kFullWarp, acc, d));
  }
}

// Per-tile partials: the head is the tile's share of the group that began in
// an earlier tile, the tail the share of the group that runs on into the
// next; tail_group names that group, or is -1.
template <typename Acc>
struct Partials {
  Acc* head_value;
  long long* head_count;
  Acc* tail_value;
  long long* tail_count;
  long long* tail_group;
};

template <typename Acc>
Partials<Acc> partials_in(void* scratch, long long tiles) {
  long long* base = static_cast<long long*>(scratch);
  return {reinterpret_cast<Acc*>(base), base + tiles,
          reinterpret_cast<Acc*>(base + 2 * tiles), base + 3 * tiles,
          base + 4 * tiles};
}

template <typename T, typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const T* __restrict__ values, const long long* __restrict__ rows,
            const unsigned char* __restrict__ validity,
            const long long* __restrict__ starts, long long n_groups,
            long long n_positions, Acc init, Acc* __restrict__ out,
            long long* __restrict__ n_valid, Partials<Acc> partials) {
  __shared__ Acc staged[OP == kCount ? 1 : kTile];
  __shared__ unsigned char valid[kTile];
  __shared__ long long group_range[2];
  // the parts of more than kShort positions: item, positions, the group's end
  __shared__ long long long_item[kLongSlots];
  __shared__ int long_from[kLongSlots];
  __shared__ int long_to[kLongSlots];
  __shared__ long long long_end[kLongSlots];
  __shared__ int n_long;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long tile = blockIdx.x;
  const bool last_tile = tile == static_cast<long long>(gridDim.x) - 1;
  const long long tile_lo = tile * kTile;
  const long long tile_hi = tile_lo + kTile;
  // the positions of this tile that belong to a group
  const long long lo = max(tile_lo, starts[0]);
  const long long hi = min(min(tile_hi, starts[n_groups]), n_positions);
  const bool wide_loads = (reinterpret_cast<uintptr_t>(rows) & 15) == 0;

  // Thread i holds positions tile_lo + k * 2 * kThreads + 2 * i + {0, 1}.
  long long row[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) {
    const long long p = tile_lo + k * 2 * kThreads + 2 * threadIdx.x;
    if (rows == nullptr) {
      row[2 * k] = p;
      row[2 * k + 1] = p + 1;
    } else if (wide_loads && p >= lo && p + 2 <= hi) {
      const longlong2 pair = *reinterpret_cast<const longlong2*>(rows + p);
      row[2 * k] = pair.x;
      row[2 * k + 1] = pair.y;
    } else {
      row[2 * k] = (p >= lo && p < hi) ? rows[p] : 0;
      row[2 * k + 1] = (p + 1 >= lo && p + 1 < hi) ? rows[p + 1] : 0;
    }
  }
  // every gather is started before any is used
  T value[OP == kCount ? 1 : kPerThread];
  unsigned char ok[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long p = tile_lo + (j / 2) * 2 * kThreads + 2 * threadIdx.x + (j & 1);
    const bool inside = p >= lo && p < hi;
    ok[j] = inside ? (validity != nullptr ? validity[row[j]] : 1) : 0;
    if constexpr (OP != kCount) value[j] = inside ? values[row[j]] : T(0);
  }
  // The groups that start in this tile are [group_range[0], group_range[1]):
  // the first group whose start is >= tile_lo, and >= tile_hi. The last tile
  // owns every later start as well (empty groups at the very end). Warp 0
  // looks for the one and warp 1 for the other while the gathers are in
  // flight: 32 probes of `starts` a step cut the range to a 33rd, so 1.5 M
  // groups take 5 dependent loads.
  if (warp < 2) {
    const long long key = warp == 0 ? tile_lo : tile_hi;
    long long a = (warp == 1 && last_tile) ? n_groups : 0;  // the answer is in [a, b]
    long long b = n_groups;
    while (a < b) {
      const long long step = (b - a + 32) / 33;
      const long long probe = a + (lane + 1) * step - 1;
      const bool below = probe < b && starts[probe] < key;
      const int n_below = __popc(__ballot_sync(kFullWarp, below));
      // probe n_below, the first not below, bounds the answer; when all 32
      // are below there is no such probe and b stays (b - a may be 33 steps)
      if (n_below < 32) b = min(b, a + (n_below + 1) * step - 1);
      a += n_below * step;
    }
    if (lane == 0) group_range[warp] = a;
  }
  if (threadIdx.x == 0) n_long = 0;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int at = (j / 2) * 2 * kThreads + 2 * threadIdx.x + (j & 1);
    valid[at] = ok[j] ? 1 : 0;
    if constexpr (OP != kCount) staged[at] = ok[j] ? static_cast<Acc>(value[j]) : init;
  }
  __syncthreads();

  const long long g_first = group_range[0];
  const long long g_end = group_range[1];
  // group g_first - 1 began before tile_lo; it has positions here if it ends
  // after tile_lo
  const bool has_head = g_first > 0 && starts[g_first] > tile_lo;
  const long long n_items = (has_head ? 1 : 0) + (g_end - g_first);
  if (threadIdx.x == 0) {
    const bool runs_on = !last_tile && g_end > g_first && starts[g_end] > tile_hi;
    partials.tail_group[tile] = runs_on ? g_end - 1 : -1;
  }

  // Item i is the head (i == 0, if there is one) or a group that starts
  // here: group g, whose positions in this tile are [s, min(end, tile_hi)).
  auto emit = [&](long long i, long long end, Acc acc, long long count) {
    if (has_head && i == 0) {
      if (OP != kCount) partials.head_value[tile] = acc;
      partials.head_count[tile] = count;
    } else if (last_tile || end <= tile_hi) {
      const long long g = g_first - (has_head ? 1 : 0) + i;
      if (OP != kCount) out[g] = acc;
      n_valid[g] = count;
    } else {
      if (OP != kCount) partials.tail_value[tile] = acc;
      partials.tail_count[tile] = count;
    }
  };

  // A thread takes kItemBatch items at a time and loads all their offsets
  // before it folds any, so a tile waits for `starts` once.
  for (long long base = 0; base < n_items; base += kItemBatch * kThreads) {
    long long s[kItemBatch], end[kItemBatch];
#pragma unroll
    for (int k = 0; k < kItemBatch; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < n_items) {
        const long long g = g_first - (has_head ? 1 : 0) + i;
        s[k] = (has_head && i == 0) ? tile_lo : starts[g];
        end[k] = starts[g + 1];
      }
    }
#pragma unroll
    for (int k = 0; k < kItemBatch; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i >= n_items) break;
      const int from = static_cast<int>(s[k] - tile_lo);
      const int to = static_cast<int>(min(end[k], tile_hi) - tile_lo);
      if (to - from > kShort) {
        // the order of this list changes no result
        const int slot = atomicAdd(&n_long, 1);
        long_item[slot] = i;
        long_from[slot] = from;
        long_to[slot] = to;
        long_end[slot] = end[k];
        continue;
      }
      Acc acc = init;
      long long count = validity != nullptr ? 0 : to - from;
      for (int at = from; at < to; ++at) {
        if (validity != nullptr) count += valid[at];
        if constexpr (OP != kCount) acc = fold<OP>(acc, staged[at]);
      }
      emit(i, end[k], acc, count);
    }
  }
  __syncthreads();
  for (int k = warp; k < n_long; k += kWarps) {
    const int from = long_from[k];
    const int to = long_to[k];
    Acc acc = init;
    long long count = 0;
    for (int at = from + lane; at < to; at += 32) {
      count += valid[at];
      if constexpr (OP != kCount) acc = fold<OP>(acc, staged[at]);
    }
    warp_fold<OP>(acc, count);
    if (lane == 0) {
      emit(long_item[k], long_end[k], acc, validity != nullptr ? count : to - from);
    }
  }
}

// One warp per tile: the tile's tail and the heads of the tiles after it
// that hold the rest of the same group.
template <typename Acc, int OP>
__global__ void __launch_bounds__(kThreads)
straddle_kernel(const long long* __restrict__ starts, long long tiles, Acc init,
                Acc* __restrict__ out, long long* __restrict__ n_valid,
                Partials<Acc> partials) {
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (tile >= tiles) return;
  const long long g = partials.tail_group[tile];
  if (g < 0) return;
  const long long last = min((starts[g + 1] - 1) / kTile, tiles - 1);
  Acc acc = init;
  long long count = 0;
  if (lane == 0) {
    if (OP != kCount) acc = partials.tail_value[tile];
    count = partials.tail_count[tile];
  }
  for (long long t = tile + 1 + lane; t <= last; t += 32) {
    if (OP != kCount) acc = fold<OP>(acc, partials.head_value[t]);
    count += partials.head_count[t];
  }
  warp_fold<OP>(acc, count);
  if (lane == 0) {
    if (OP != kCount) out[g] = acc;
    n_valid[g] = count;
  }
}

__global__ void __launch_bounds__(kThreads)
group_sizes_kernel(const long long* __restrict__ starts, long long n_groups,
                   long long* __restrict__ n_valid) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g < n_groups) n_valid[g] = starts[g + 1] - starts[g];
}

template <typename T, typename Acc, int OP>
int launch(const void* values, const void* rows, const void* validity,
           const void* starts, long long n_groups, long long n_positions, Acc init,
           void* out, void* n_valid, void* scratch, long long tiles,
           cudaStream_t stream) {
  const Partials<Acc> partials = partials_in<Acc>(scratch, tiles);
  tile_kernel<T, Acc, OP><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const T*>(values), static_cast<const long long*>(rows),
      static_cast<const unsigned char*>(validity),
      static_cast<const long long*>(starts), n_groups, n_positions, init,
      static_cast<Acc*>(out), static_cast<long long*>(n_valid), partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  straddle_kernel<Acc, OP>
      <<<static_cast<unsigned>((tiles + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
          static_cast<const long long*>(starts), tiles, init, static_cast<Acc*>(out),
          static_cast<long long*>(n_valid), partials);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename Acc>
int launch_op(int op, const void* values, const void* rows,
              const void* validity, const void* starts, long long n_groups,
              long long n_positions, Acc init, void* out, void* n_valid,
              void* scratch, long long tiles, cudaStream_t stream) {
  switch (op) {
    case kSum:
      return launch<T, Acc, kSum>(values, rows, validity, starts, n_groups,
                                  n_positions, Acc(0), out, n_valid, scratch, tiles,
                                  stream);
    case kMin:
      return launch<T, Acc, kMin>(values, rows, validity, starts, n_groups,
                                  n_positions, init, out, n_valid, scratch, tiles,
                                  stream);
    case kMax:
      return launch<T, Acc, kMax>(values, rows, validity, starts, n_groups,
                                  n_positions, init, out, n_valid, scratch, tiles,
                                  stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int segment_tile_positions() { return kTile; }

// int64 words of scratch a call over `tiles` tiles needs.
long long segment_scratch_words(long long tiles) { return 5 * tiles; }

// value_type: 0 float64, 1 float32, 2 int64, 3 int32 (ignored by a count,
// whose `values` and `out` may be null). op: 0 sum, 1 min, 2 max, 3 count.
// `rows` (int64 permutation) and `validity` (bytes, indexed like the values)
// may be null. `starts` holds n_groups + 1 ascending int64 offsets into the
// group order; every one is at most n_positions, the length of `rows` (or,
// without `rows`, of the values). Float types accumulate in float64 from
// init_f, integers in int64 from init_i (sums from 0); `out` holds n_groups
// accumulators, `n_valid` n_groups int64. tiles must be
// max(1, ceil(n_positions / segment_tile_positions())), and `scratch` hold
// segment_scratch_words(tiles) int64 (it need not be cleared). A count
// without `validity` reads no position and takes no scratch. Launches on
// `stream`, does not synchronise, returns the first CUDA error.
int segment_reduce_sorted(const void* values, int value_type, const void* rows,
                          const void* validity, const void* starts,
                          long long n_groups, long long n_positions, int op,
                          double init_f, long long init_i, void* out,
                          void* n_valid, void* scratch, long long tiles,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_groups < 1 || n_groups > 0x7FFFFFFFLL * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (op == kCount && validity == nullptr) {
    group_sizes_kernel<<<static_cast<unsigned>((n_groups + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
        static_cast<const long long*>(starts), n_groups,
        static_cast<long long*>(n_valid));
    return static_cast<int>(cudaGetLastError());
  }
  if (n_positions < 0 || tiles > 0x7FFFFFFFLL ||
      tiles != (n_positions + kTile - 1) / kTile + (n_positions == 0 ? 1 : 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (op == kCount) {
    return launch<int, long long, kCount>(nullptr, rows, validity, starts, n_groups,
                                          n_positions, 0LL, nullptr, n_valid, scratch,
                                          tiles, stream);
  }
  switch (value_type) {
    case 0:
      return launch_op<double, double>(op, values, rows, validity, starts, n_groups,
                                       n_positions, init_f, out, n_valid, scratch,
                                       tiles, stream);
    case 1:
      return launch_op<float, double>(op, values, rows, validity, starts, n_groups,
                                      n_positions, init_f, out, n_valid, scratch,
                                      tiles, stream);
    case 2:
      return launch_op<long long, long long>(op, values, rows, validity, starts,
                                             n_groups, n_positions, init_i, out,
                                             n_valid, scratch, tiles, stream);
    case 3:
      return launch_op<int, long long>(op, values, rows, validity, starts, n_groups,
                                       n_positions, init_i, out, n_valid, scratch,
                                       tiles, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
