// Join kernels for Hopper (sm_90a), behind a plain C interface that
// hyrise_tpu_torch/kernels/join_probe.py loads with ctypes.
//
// K4: lut_lookup replaces hyrise_tpu/kernels/tpu_prims.py
// lookup_last_eq_lut (XLA scatter-max and take): an equi-join probe for
// integer keys known to lie in [key_lo, key_lo + size). For each probe key
// it gives (matched, the LAST valid build row with an equal key, or 0).
//
//   What bounds it: device-memory bytes on the streamed side (8 bytes of key
//   in, 9 bytes out per probe row, 9 bytes in per build row) and, for the
//   one gather per probe row, the latency of scattered 4-byte reads of the
//   table, which is the only thing worth keeping in the L2 (the table of a
//   TPC-H key at scale factor 1 is at most 24 MB of the 50 MB).
//   The design: one C call enqueues a memset of the int32 table to -1 (every
//   byte 0xFF), the build and the probe. The build writes each valid build
//   row's id into table[key - key_lo] with atomicMax, two rows a thread: max
//   is order-free, so the table holds the highest row of every key whatever
//   order the threads ran in and the result is the same bits every run.
//   Invalid rows and keys outside the range are skipped. The probe takes
//   four consecutive rows a thread: keys by 16-byte loads (8-byte where the
//   key column starts off a 16-byte boundary), all four table gathers started
//   before any is used, `matched` written as one packed 4-byte store and the
//   rows by 16-byte stores; the last n % 4 rows go one to a thread. The
//   streamed loads and stores carry the evict-first hint (ld/st .cs) and the
//   gathers an L2 evict-last policy, so that keys and outputs pass through
//   the L2 without pushing the table out of it (5% over default accesses at
//   6.0 M probes of a 24 MB table; a persisting access-policy window over
//   the table was slower than either and leaves its lines persisting until
//   the host releases them). What is left is the gathers themselves: a
//   scattered 4-byte read moves a 32-byte sector, so probe keys in random
//   order take about twice as long as keys in order.
//
// K5: expand_pairs replaces hyrise_tpu/ops/join.py _expand_pairs (XLA repeat
// and prefix-sum arithmetic): every probe row p owns the range
// [lo[p], lo[p] + counts[p]) of the sorted build side, and the output lists
// all (p, build_perm[lo[p] + rank]) pairs probe-major.
//
//   What bounds it: device-memory bytes, 16 bytes out per pair and 8 bytes in
//   per range; a per-row prefix sum kept in device memory would move more
//   than the function itself, and the length of the output is known only
//   after all the counting.
//   The design: two launches from one C call. (1) ranges_scan_kernel sums
//   the counts over tiles of 16,384 ranges (16-byte loads, int64 sums) and
//   hands the tiles' sums on by decoupled look-back (lookback.cuh). It
//   writes one int64 end offset per segment of 512 ranges, not one per
//   range, and folds the range check in: the least count, the least lo and
//   the least and largest lo + count (in int32, as the plain version takes
//   them: an end past 2^31 wraps below 0 and is refused for that), through
//   four atomicMax words (order-free). The last tile writes the total, and
//   whether the bounds leave the build side, as one word into pinned host
//   memory, so the host learns them without a stream synchronisation,
//   refuses bad ranges and has the outputs allocated before
//   (2) expand_kernel, whose blocks each own 2,048 consecutive OUTPUT
//   positions, so one range of 100,000 pairs or a non-equi join's triangular
//   ranges cost every block the same. A block finds the segment of its first
//   position by a warp-wide 32-way search over the segment ends, loads 2,048
//   ranges from there (16-byte loads), rebuilds their offsets with a block
//   scan, and lets every range that begins inside the block's positions (or
//   covers the first of them) drop one mark (range, source position) at its
//   first position in shared memory; it goes on to the next segment that
//   holds a pair while its positions are not covered. A running maximum over
//   the marks then gives every position its range without any search. Each
//   thread emits 8 pairs: all build_perm gathers started before any is used,
//   both outputs written by 16-byte stores.
//
//   expand_pairs_cap is the capacity form (plan/compiler.py), which
//   replaces hyrise_tpu/ops/join.py _expand_pairs(lo, counts, build_perm,
//   out_cap): the first min(total, cap) pairs, 0 in the rest of both
//   outputs, nothing at or past cap. Nothing waits on the host, so a CUDA
//   graph can capture the call.
//
//   What bounds it: device-memory bytes, 8 bytes in per range and cap x 16
//   bytes out, each written once.
//   The design: the scan writes the total and the range check's verdict
//   into two words of device memory instead of the host slot, and the
//   expansion (expand_kernel<true>) runs over a grid sized from cap, each
//   block reading both words. A block at or past the total (cut to cap; 0
//   under a refusal) writes zeros over its 2,048 positions below cap as
//   16-byte stores; the block that straddles the total writes its pairs and
//   zeros after them. So every output byte below cap is written once, by
//   the kernel, and no memset of the outputs precedes it. A refused range
//   writes no pair and sets the verdict's word, which the host reads with
//   the other counts. A call is a memset of the scratch (more than one scan
//   tile) and two kernels; the wrapper returns views of the two words.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

using lookback::kFullWarp;
using lookback::kHasPrefix;
using lookback::kHasSum;
using lookback::status_word;
using lookback::store_status;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;

// ---- K4 ---------------------------------------------------------------------

constexpr int kBuildRows = 2;  // build rows a thread takes at a time
constexpr int kProbeRows = 4;  // probe rows a thread takes at a time

// An L2 policy that keeps what is read through it for as long as it can.
__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ int load_kept(const int* p, unsigned long long policy) {
  int v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

// Two keys from a streamed column, keys[0] and keys[1].
__device__ __forceinline__ void load_keys2(const long long* __restrict__ keys,
                                           bool aligned, long long out[2]) {
  if (aligned) {
    const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(keys));
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = __ldcs(keys);
    out[1] = __ldcs(keys + 1);
  }
}

__device__ __forceinline__ void build_row(long long key, bool valid, long long row,
                                          long long key_lo, unsigned long long size,
                                          int* __restrict__ lut) {
  // unsigned difference: a key below key_lo wraps to a huge value
  const unsigned long long slot = static_cast<unsigned long long>(key) -
                                  static_cast<unsigned long long>(key_lo);
  if (valid && slot < size) atomicMax(lut + slot, static_cast<int>(row));
}

__global__ void __launch_bounds__(kThreads)
lut_build_kernel(const long long* __restrict__ keys,
                 const unsigned char* __restrict__ valid, long long n, bool aligned,
                 long long key_lo, unsigned long long size, int* __restrict__ lut) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = n / kBuildRows;
  for (long long g = first; g < groups; g += stride) {
    const long long row = g * kBuildRows;
    long long k[kBuildRows];
    load_keys2(keys + row, aligned, k);
    const bool v0 = valid[row] != 0, v1 = valid[row + 1] != 0;
    build_row(k[0], v0, row, key_lo, size, lut);
    build_row(k[1], v1, row + 1, key_lo, size, lut);
  }
  const long long tail = groups * kBuildRows + first;
  if (tail < n) build_row(keys[tail], valid[tail] != 0, tail, key_lo, size, lut);
}

__device__ __forceinline__ int probe_row(long long key, long long key_lo,
                                         unsigned long long size,
                                         const int* __restrict__ lut,
                                         unsigned long long policy) {
  const unsigned long long slot = static_cast<unsigned long long>(key) -
                                  static_cast<unsigned long long>(key_lo);
  return slot < size ? load_kept(lut + slot, policy) : -1;
}

__global__ void __launch_bounds__(kThreads)
lut_probe_kernel(const long long* __restrict__ keys, long long n, bool aligned,
                 long long key_lo, unsigned long long size,
                 const int* __restrict__ lut, unsigned char* __restrict__ matched,
                 long long* __restrict__ build_row_out) {
  const unsigned long long policy = evict_last_policy();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = n / kProbeRows;
  for (long long g = first; g < groups; g += stride) {
    const long long at = g * kProbeRows;
    long long k[kProbeRows];
    load_keys2(keys + at, aligned, k);
    load_keys2(keys + at + 2, aligned, k + 2);
    int row[kProbeRows];
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {
      row[j] = probe_row(k[j], key_lo, size, lut, policy);
    }
    unsigned flags = 0u;
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {
      flags |= (row[j] >= 0 ? 1u : 0u) << (8 * j);
      row[j] = max(row[j], 0);
    }
    __stcs(reinterpret_cast<unsigned*>(matched + at), flags);
    __stcs(reinterpret_cast<longlong2*>(build_row_out + at), make_longlong2(row[0], row[1]));
    __stcs(reinterpret_cast<longlong2*>(build_row_out + at + 2),
           make_longlong2(row[2], row[3]));
  }
  const long long tail = groups * kProbeRows + first;
  if (tail < n) {
    const int row = probe_row(keys[tail], key_lo, size, lut, policy);
    matched[tail] = row >= 0;
    build_row_out[tail] = max(row, 0);
  }
}

// ---- K5 ---------------------------------------------------------------------

constexpr int kSegRows = 512;     // ranges per segment: one end offset each
constexpr int kScanThreads = 1024;  // the scan's blocks: many warps, few registers
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanLoads = 4;     // 16-byte loads of each column a thread, scan
constexpr int kScanTile = kScanThreads * 4 * kScanLoads;  // 16,384 ranges
constexpr int kSegsPerTile = kScanTile / kSegRows;       // 32: a lane of a warp each
constexpr int kWarpsPerSeg = kSegRows / (32 * 4);        // 4 warps' loads a segment
constexpr int kSegsPerLoad = kScanWarps / kWarpsPerSeg;  // 8
constexpr int kPerThread = 8;     // ranges a thread loads, pairs a thread emits
constexpr int kChunkRows = kThreads * kPerThread;        // 2,048 ranges
constexpr int kOutTile = kThreads * kPerThread;          // 2,048 pairs
constexpr int kMarkWords = kOutTile + kOutTile / 8;      // one word of padding in 8

// scratch, int64 words: [0] ticket counter; [1..4] the ranges' bounds, each
// as an unsigned key that atomicMax can take from a cleared word; [5 + t]
// status word of tile t (lookback.cuh); then one end offset per segment.
constexpr int kTicketWord = 0;
constexpr int kBoundWords = 1;
constexpr int kBounds = 4;  // least count, least lo, least end, largest end
constexpr int kStatusWords = kBoundWords + kBounds;
constexpr long long kBias = 1LL << 32;

// slot words the last tile writes for the host: word 0 is the total with
// kRefused set if a count is negative or a range leaves the build side (one
// word, so the host sees both or neither without a system-wide fence); words
// 1..4 are the bounds, which the host reads only to word its refusal, after
// the stream has ended
constexpr int kStats = 1 + kBounds;
constexpr long long kRefused = 1LL << 62;
// the capacity form's stats (device memory): word 0 the total alone, words
// 1..4 the bounds, word kRefusedWord 1 if refused, else 0
constexpr int kRefusedWord = kStats;
constexpr int kCapStats = kStats + 1;

// Rows first .. first + 3 of an int32 column. kWhole: all four exist and
// col + first lies on a 16-byte boundary, so the load is one instruction
// with no branch around it (a branch per load would make each load wait for
// the one before). Otherwise rows at or past n read as 0.
template <bool kWhole>
__device__ __forceinline__ void load_rows4(const int* __restrict__ col, long long first,
                                           long long n, int out[4]) {
  if (kWhole) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(col + first));
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = first + j < n ? col[first + j] : 0;
  }
}

__device__ __forceinline__ unsigned long long max_u64(unsigned long long a,
                                                      unsigned long long b) {
  return a > b ? a : b;
}

// A thread's part of a scan tile: load w covers rows
// (w * kScanThreads + thread) * 4 .. + 3 of the tile, so a warp's load lies
// in one segment: segment w * kSegsPerLoad + warp / kWarpsPerSeg. sums[w]
// receives the sum of the load's counts, bounds the tile's four bounds.
template <bool kWhole>
__device__ __forceinline__ void scan_rows(const int* __restrict__ lo,
                                          const int* __restrict__ counts,
                                          long long tile_first, long long n,
                                          long long sums[], int bounds[]) {
#pragma unroll
  for (int w = 0; w < kScanLoads; ++w) {
    const long long first = tile_first + (w * kScanThreads + threadIdx.x) * 4;
    int c[4], l[4];
    load_rows4<kWhole>(counts, first, n, c);
    load_rows4<kWhole>(lo, first, n, l);
    long long sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!kWhole && first + j >= n) continue;
      // a negative count is refused by the host; here it must not reach the
      // status word's state bits
      sum += max(c[j], 0);
      // the end in int32, as the plain version takes it: past 2^31 it wraps
      // below 0 and is refused for that
      const int end = static_cast<int>(static_cast<unsigned>(l[j]) +
                                       static_cast<unsigned>(c[j]));
      bounds[0] = min(bounds[0], c[j]);
      bounds[1] = min(bounds[1], l[j]);
      bounds[2] = min(bounds[2], end);
      bounds[3] = max(bounds[3], end);
    }
    sums[w] = sum;
  }
}

// a bound as a key that atomicMax can take from a cleared word: the three
// least values as kBias - v, the largest as kBias + v, all above 0
__device__ __forceinline__ unsigned long long bound_key(int b, int v) {
  return static_cast<unsigned long long>(b == kBounds - 1 ? kBias + v : kBias - v);
}

__device__ __forceinline__ long long bound_of_key(int b, unsigned long long key) {
  const long long v = static_cast<long long>(key);
  return b == kBounds - 1 ? v - kBias : kBias - v;
}

__global__ void __launch_bounds__(kScanThreads)
ranges_scan_kernel(const int* __restrict__ lo, const int* __restrict__ counts,
                   long long n, long long n_build, bool aligned, long long tiles,
                   long long segments, unsigned long long* __restrict__ scratch,
                   volatile long long* host_stats, long long* refused_out) {
  __shared__ long long warp_sums[kScanLoads][kScanWarps];
  __shared__ int warp_bounds[kBounds][kScanWarps];
  __shared__ long long seg_ends[kSegsPerTile];  // inclusive, within the tile
  __shared__ long long shared_tile;
  __shared__ long long shared_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the ticket comes first: a tile only ever waits on tiles handed out earlier
  if (threadIdx.x == 0) {
    shared_tile = tiles == 1 ? 0 : static_cast<long long>(
        atomicAdd(scratch + kTicketWord, 1ULL));
  }
  __syncthreads();
  const long long tile = shared_tile;
  unsigned long long* status = scratch + kStatusWords;
  long long* seg_end_out = reinterpret_cast<long long*>(status + tiles);

  // all loads come before the first shuffle: a shuffle between two loads
  // would make the second wait for the first
  const long long tile_first = tile * kScanTile;
  int bounds[kBounds] = {INT_MAX, INT_MAX, INT_MAX, INT_MIN};
  long long sums[kScanLoads];
  if (aligned && tile_first + kScanTile <= n) {
    scan_rows<true>(lo, counts, tile_first, n, sums, bounds);
  } else {
    scan_rows<false>(lo, counts, tile_first, n, sums, bounds);
  }
#pragma unroll
  for (int w = 0; w < kScanLoads; ++w) {
    long long sum = sums[w];
    for (int d = 16; d > 0; d >>= 1) sum += __shfl_xor_sync(kFullWarp, sum, d);
    if (lane == 0) warp_sums[w][warp] = sum;
  }
#pragma unroll
  for (int b = 0; b < kBounds; ++b) {
    for (int d = 16; d > 0; d >>= 1) {
      const int other = __shfl_xor_sync(kFullWarp, bounds[b], d);
      bounds[b] = b == kBounds - 1 ? max(bounds[b], other) : min(bounds[b], other);
    }
    if (lane == 0) warp_bounds[b][warp] = bounds[b];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    // lane s sums segment s and the warp scans the segments
    static_assert(kSegsPerTile == 32 && kScanWarps <= 32,
                  "a lane of the first warp per segment, and per warp");
    long long upto = 0;
    for (int k = 0; k < kWarpsPerSeg; ++k) {
      upto += warp_sums[lane / kSegsPerLoad][(lane % kSegsPerLoad) * kWarpsPerSeg + k];
    }
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(kFullWarp, upto, d);
      if (lane >= d) upto += up;
    }
    seg_ends[lane] = upto;
    const long long total = __shfl_sync(kFullWarp, upto, 31);
    // lane k holds warp k's bounds; lane 0 ends up with the tile's
    unsigned long long tile_bounds[kBounds];
#pragma unroll
    for (int b = 0; b < kBounds; ++b) {
      tile_bounds[b] = lane < kScanWarps ? bound_key(b, warp_bounds[b][lane]) : 0ULL;
      for (int d = 16; d > 0; d >>= 1) {
        tile_bounds[b] = max_u64(tile_bounds[b],
                                 __shfl_xor_sync(kFullWarp, tile_bounds[b], d));
      }
    }
    if (threadIdx.x == 0) {
      for (int b = 0; b < kBounds; ++b) {
        // before the status word: whoever sees the word sees the bounds
        if (tiles > 1) atomicMax(scratch + kBoundWords + b, tile_bounds[b]);
      }
      store_status(status + tile, status_word(tile == 0 ? kHasPrefix : kHasSum, total));
    }
    const long long before = tile == 0 ? 0 : lookback::sum_before(status, tile);
    if (threadIdx.x == 0) {
      if (tile != 0) store_status(status + tile, status_word(kHasPrefix, before + total));
      if (tile == tiles - 1) {
        // every earlier tile's bounds were in place before its status word
        __threadfence();
        bool refused = false;
        for (int b = 0; b < kBounds; ++b) {
          const unsigned long long key = tiles > 1
              ? atomicMax(scratch + kBoundWords + b, 0ULL) : tile_bounds[b];
          const long long v = bound_of_key(b, key);
          refused = refused || (b == kBounds - 1 ? v > n_build : v < 0);
          host_stats[1 + b] = v;
        }
        if (refused_out != nullptr) {  // the capacity form: two words
          host_stats[0] = before + total;
          *refused_out = refused ? 1 : 0;
        } else {
          host_stats[0] = (before + total) | (refused ? kRefused : 0LL);
        }
      }
      shared_before = before;
    }
  }
  __syncthreads();
  if (threadIdx.x < kSegsPerTile) {
    const long long segment = tile * kSegsPerTile + threadIdx.x;
    if (segment < segments) seg_end_out[segment] = shared_before + seg_ends[threadIdx.x];
  }
}

// The first segment in [from, segments) whose end offset lies past `pos`
// (there is one: pos is less than the last end). Called by one whole warp,
// which narrows the interval 32 ways a step.
__device__ __forceinline__ long long first_segment_past(
    const long long* __restrict__ seg_end, long long from, long long segments,
    long long pos) {
  const int lane = threadIdx.x & 31;
  long long right = segments - 1, left = min(from, right);  // the answer lies between
  while (left < right) {
    const long long step = (right - left) / 32 + 1;
    const long long at = left + (lane + 1) * step - 1;
    const bool past = at >= right || seg_end[at] > pos;
    const int first = __ffs(static_cast<int>(__ballot_sync(kFullWarp, past))) - 1;
    right = min(right, left + (first + 1) * step - 1);
    left = left + first * step;
  }
  return left;
}

// Inclusive sum of `v` over the block's threads in thread order; `total`
// receives the block's sum.
__device__ __forceinline__ long long block_inclusive_sum(long long v, long long* warp_vals,
                                                         long long* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const long long up = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) warp_vals[warp] = v;
  __syncthreads();
  long long before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    const long long s = warp_vals[w];
    if (w < warp) before += s;
    all += s;
  }
  *total = all;
  return v + before;
}

// where position q of the block's outputs keeps its mark
__device__ __forceinline__ int mark_at(int q) { return q + (q >> 3); }

// kCap: the capacity form, whose total (cut to cap, 0 under a refusal) is
// read from `stats`; every position below cap is written, zeros past the
// total. Otherwise `total` is given and the grid covers it exactly.
template <bool kCap>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const int* __restrict__ lo, const int* __restrict__ counts,
              long long n_probe, bool aligned, const long long* __restrict__ seg_end,
              long long segments, const long long* __restrict__ build_perm,
              long long total, const long long* __restrict__ stats, long long cap,
              long long* __restrict__ probe_out, long long* __restrict__ build_out) {
  // a mark: the range in the high half, and in the low half the position in
  // build_perm of the range's pair at the block's first output (it may lie
  // up to kOutTile before the range, so it is signed); -1 where no range begins
  __shared__ long long marks[kMarkWords];
  __shared__ long long warp_vals[kWarps];
  __shared__ long long shared_segment;
  __shared__ long long shared_base;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (kCap) total = stats[kRefusedWord] != 0 ? 0 : min(stats[0], cap);
  const long long out_first = static_cast<long long>(blockIdx.x) * kOutTile;
  // the capacity form writes every position of the block below cap
  const int width = kCap ? static_cast<int>(min(static_cast<long long>(kOutTile),
                                                cap - out_first)) : 0;
  if (out_first >= total) {  // the whole block: no barrier is skipped
    if (kCap) {
#pragma unroll
      for (int k = 0; k < kPerThread / 2; ++k) {
        const int q = (k * kThreads + threadIdx.x) * 2;
        if (q + 1 < width) {
          *reinterpret_cast<longlong2*>(probe_out + out_first + q) = make_longlong2(0, 0);
          *reinterpret_cast<longlong2*>(build_out + out_first + q) = make_longlong2(0, 0);
        } else if (q < width) {
          probe_out[out_first + q] = 0;
          build_out[out_first + q] = 0;
        }
      }
    }
    return;
  }
  const long long out_end = min(out_first + kOutTile, total);
  const int n_out = static_cast<int>(out_end - out_first);
  for (int q = threadIdx.x; q < kMarkWords; q += kThreads) marks[q] = -1;

  long long pos = out_first;  // the first position no loaded range has covered
  long long next_segment = 0;
  while (pos < out_end) {
    if (warp == 0) {
      const long long segment = first_segment_past(seg_end, next_segment, segments, pos);
      if (lane == 0) {
        shared_segment = segment;
        shared_base = segment == 0 ? 0 : seg_end[segment - 1];
      }
    }
    __syncthreads();
    const long long segment = shared_segment;
    const long long base = shared_base;  // the offset of the segment's first range
    const long long row = segment * kSegRows + threadIdx.x * kPerThread;
    int c[kPerThread], l[kPerThread];
    if (aligned && row + kPerThread <= n_probe) {
      load_rows4<true>(counts, row, n_probe, c);
      load_rows4<true>(counts, row + 4, n_probe, c + 4);
      load_rows4<true>(lo, row, n_probe, l);
      load_rows4<true>(lo, row + 4, n_probe, l + 4);
    } else {
      load_rows4<false>(counts, row, n_probe, c);
      load_rows4<false>(counts, row + 4, n_probe, c + 4);
      load_rows4<false>(lo, row, n_probe, l);
      load_rows4<false>(lo, row + 4, n_probe, l + 4);
    }
    long long mine = 0;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) mine += c[j];
    long long chunk_total;
    long long offset = base - mine + block_inclusive_sum(mine, warp_vals, &chunk_total);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      if (c[j] > 0 && offset < out_end && offset + c[j] > out_first) {
        const int q = static_cast<int>(max(offset - out_first, 0LL));
        const long long source = l[j] + (out_first - offset);
        marks[mark_at(q)] = ((row + j) << 32) |
                            static_cast<long long>(static_cast<unsigned>(source));
      }
      offset += c[j];
    }
    pos = base + chunk_total;
    next_segment = segment + kChunkRows / kSegRows;
  }
  __syncthreads();

  // every position's mark: the running maximum (ranges rise with positions)
  {
    const int q = threadIdx.x * kPerThread;
    long long v[kPerThread];
    long long run = -1;
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      run = max(run, marks[mark_at(q + j)]);
      v[j] = run;
    }
    long long upto = run;
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(kFullWarp, upto, d);
      if (lane >= d) upto = max(upto, up);
    }
    if (lane == 31) warp_vals[warp] = upto;
    long long carry = __shfl_up_sync(kFullWarp, upto, 1);
    if (lane == 0) carry = -1;
    __syncthreads();
    for (int w = 0; w < warp; ++w) carry = max(carry, warp_vals[w]);
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) marks[mark_at(q + j)] = max(v[j], carry);
  }
  __syncthreads();

  // 8 pairs a thread, two neighbours at a time so that a warp's 16-byte
  // stores are contiguous; all gathers first; zeros past n_out up to the
  // block's width in the capacity form
  const int stored = kCap ? width : n_out;
  long long probe[kPerThread], row_of[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int q = (k * kThreads + threadIdx.x) * 2 + e;
      probe[2 * k + e] = 0;
      row_of[2 * k + e] = 0;
      if (q < n_out) {
        const long long mark = marks[mark_at(q)];
        probe[2 * k + e] = mark >> 32;
        row_of[2 * k + e] = __ldg(build_perm + (static_cast<int>(mark) + q));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPerThread / 2; ++k) {
    const int q = (k * kThreads + threadIdx.x) * 2;
    if (q + 1 < stored) {
      *reinterpret_cast<longlong2*>(probe_out + out_first + q) =
          make_longlong2(probe[2 * k], probe[2 * k + 1]);
      *reinterpret_cast<longlong2*>(build_out + out_first + q) =
          make_longlong2(row_of[2 * k], row_of[2 * k + 1]);
    } else if (q < stored) {
      probe_out[out_first + q] = probe[2 * k];
      build_out[out_first + q] = row_of[2 * k];
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Resident blocks that fill the current device once: read once per device.
int full_grid() {
  static int blocks[64] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 1024;
  if (blocks[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess || sms <= 0) {
      return 1024;
    }
    blocks[device] = sms * kBlocksPerSm;
  }
  return blocks[device];
}

int grid_for(long long items) {
  return static_cast<int>(std::max(1LL, std::min(ceil_div(items, kThreads),
                                                 static_cast<long long>(full_grid()))));
}

}  // namespace

extern "C" {

// K4. matched[i] and build_row[i] for the nq probe keys against the nb build
// rows; `table` holds `size` int32 of scratch. matched and build_row are
// 16-byte aligned (whole allocations), the inputs may be views. Enqueues a
// memset and two kernels (one if nb == 0) on `stream`; returns the first CUDA
// error, or 0. Neither synchronises nor allocates.
int lut_lookup(const void* build_keys, const void* build_valid, long long nb,
               const void* probe_keys, long long nq, long long key_lo, long long size,
               void* table, void* matched, void* build_row, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nq < 1 || nb < 0 || size < 1 || !aligned16(matched) || !aligned16(build_row)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(table, 0xFF, static_cast<size_t>(size) * 4, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb > 0) {
    lut_build_kernel<<<grid_for(ceil_div(nb, kBuildRows)), kThreads, 0, stream>>>(
        static_cast<const long long*>(build_keys),
        static_cast<const unsigned char*>(build_valid), nb, aligned16(build_keys),
        key_lo, static_cast<unsigned long long>(size), static_cast<int*>(table));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  lut_probe_kernel<<<grid_for(ceil_div(nq, kProbeRows)), kThreads, 0, stream>>>(
      static_cast<const long long*>(probe_keys), nq, aligned16(probe_keys), key_lo,
      static_cast<unsigned long long>(size), static_cast<const int*>(table),
      static_cast<unsigned char*>(matched), static_cast<long long*>(build_row));
  return static_cast<int>(cudaGetLastError());
}

int expand_scan_tile_rows() { return kScanTile; }
int expand_out_tile_pairs() { return kOutTile; }

// int64 words of scratch a call over n_probe ranges needs.
long long expand_scratch_words(long long n_probe) {
  return kStatusWords + ceil_div(n_probe, kScanTile) + ceil_div(n_probe, kSegRows);
}

// Given the number of pairs, `allocate` provides the two outputs of that many
// int64 each, 16-byte aligned, as outputs[0] (probe rows) and outputs[1]
// (build rows), and returns 0; anything else stops the call.
typedef int (*allocate_fn)(long long total, void** outputs);

// K5. The pairs of the n_probe >= 1 ranges [lo[p], lo[p] + counts[p]) over
// build_perm's n_build rows. `scratch` holds expand_scratch_words(n_probe)
// int64. Launches the scan on `stream` and takes the number of pairs from
// the host slot its last tile writes (no stream synchronisation) into
// stats[0]. If a count is negative or a range leaves [0, n_build] it waits
// for the stream, fills stats[1..4] with the least count, the least lo and
// the least and largest lo + count, and returns -1. Else it calls `allocate`
// (-2 if that fails) and launches the expansion unless there is no pair.
// Returns 0, or the first CUDA error.
int expand_pairs(const void* lo, const void* counts, long long n_probe,
                 const void* build_perm, long long n_build, void* scratch,
                 allocate_fn allocate, long long* stats, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tiles = ceil_div(n_probe, kScanTile);
  const long long segments = ceil_div(n_probe, kSegRows);
  if (n_probe < 1 || tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  volatile long long* slot = nullptr;
  long long* slot_on_device = nullptr;
  cudaError_t err = lookback::take_slot(&slot, &slot_on_device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 1) {  // one tile takes no ticket, no atomics and no status word
    err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = aligned16(lo) && aligned16(counts);
  ranges_scan_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(counts), n_probe, n_build,
      aligned, tiles, segments, static_cast<unsigned long long*>(scratch),
      slot_on_device, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = lookback::wait_for_slot(slot, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = slot[0] & ~kRefused;
  stats[0] = total;
  if ((slot[0] & kRefused) != 0) {
    err = cudaStreamSynchronize(stream);  // the bounds are there once it has ended
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int i = 1; i < kStats; ++i) stats[i] = slot[i];
    return -1;
  }
  void* outputs[2] = {nullptr, nullptr};
  if (allocate(total, outputs) != 0) return -2;
  if (total == 0) return 0;
  const long long blocks = ceil_div(total, kOutTile);
  if (blocks > INT_MAX || !aligned16(outputs[0]) || !aligned16(outputs[1])) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* seg_end = static_cast<const long long*>(scratch) + kStatusWords + tiles;
  expand_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(counts), n_probe, aligned,
      seg_end, segments, static_cast<const long long*>(build_perm), total, nullptr, 0,
      static_cast<long long*>(outputs[0]), static_cast<long long*>(outputs[1]));
  return static_cast<int>(cudaGetLastError());
}

// K5, the capacity form. The pairs of the n_probe >= 1 ranges into
// probe_out[0..min(total, cap)) and build_out, both of cap >= 1 int64 and
// 16-byte aligned, 0 in the rest of both and nothing at or past cap.
// `stats` (device memory, expand_stats_words() int64) receives the total in
// word 0, the ranges' bounds in words 1..4, and in word
// expand_refused_word() 1 if a count is negative or a range leaves
// [0, n_build] (then no pair is written), else 0. `scratch` as for
// expand_pairs. Enqueues a memset of the scratch (if the scan has more than
// one tile) and two kernels on `stream`; returns the first CUDA error, or 0.
// Neither waits nor allocates.
int expand_pairs_cap(const void* lo, const void* counts, long long n_probe,
                     const void* build_perm, long long n_build, void* scratch, void* stats,
                     void* probe_out, void* build_out, long long cap, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tiles = ceil_div(n_probe, kScanTile);
  const long long segments = ceil_div(n_probe, kSegRows);
  const long long blocks = ceil_div(cap, kOutTile);
  if (n_probe < 1 || cap < 1 || tiles > INT_MAX || blocks > INT_MAX ||
      !aligned16(probe_out) || !aligned16(build_out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles > 1) {  // one tile takes no ticket, no atomics and no status word
    cudaError_t err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = aligned16(lo) && aligned16(counts);
  long long* words = static_cast<long long*>(stats);
  ranges_scan_kernel<<<static_cast<unsigned>(tiles), kScanThreads, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(counts), n_probe, n_build,
      aligned, tiles, segments, static_cast<unsigned long long*>(scratch), words,
      words + kRefusedWord);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* seg_end = static_cast<const long long*>(scratch) + kStatusWords + tiles;
  expand_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const int*>(lo), static_cast<const int*>(counts), n_probe, aligned,
      seg_end, segments, static_cast<const long long*>(build_perm), 0, words, cap,
      static_cast<long long*>(probe_out), static_cast<long long*>(build_out));
  return static_cast<int>(cudaGetLastError());
}

int expand_stats_words() { return kCapStats; }
int expand_refused_word() { return kRefusedWord; }

}  // extern "C"
