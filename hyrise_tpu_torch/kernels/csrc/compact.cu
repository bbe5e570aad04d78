// Stream compaction for Hopper (sm_90a), behind a plain C interface that
// hyrise_tpu_torch/kernels/compact.py loads with ctypes.
//
// compact_select replaces hyrise_tpu/kernels/tpu_prims.py compact_indices /
// positions_of_true (a prefix count and a scatter, or a sort of the masked
// positions): the ordered int64 positions of the nonzero bytes of a bool
// mask.
//
// What bounds it: device-memory bytes, n mask bytes in (read once) and 8
// bytes out per True row; and, for the caller, the one host read of the
// count that a result of data-dependent length costs.
//
// Design: one pass in one launch, a select with decoupled look-back. A block
// takes its tile number from a ticket counter before anything else, so every
// earlier tile is held by a block that already runs and no tile ever waits
// on a later one. It owns kTile consecutive rows, a thread kPerThread
// consecutive rows of them, read as 8-byte words where the mask is aligned.
// It counts its True rows (popcounts, warp shuffles, the warps' totals
// through shared memory) and publishes the count as one 8-byte word of
// status and value; then its first warp looks back over the earlier tiles'
// words, 32 at a time, adding counts until it meets a tile that has
// published its inclusive prefix, and publishes its own inclusive prefix.
// Meanwhile every True row is placed at its rank in a shared-memory copy of
// the tile's output, which is then written at the tile's offset,
// neighbouring threads to neighbouring positions. No atomics touch the
// output, so the positions come out in order. A status word and its value
// travel in one store (st.release, read with ld.acquire), so a reader sees
// both or neither.
//
// The output is sized for the worst case before the launch. The last tile
// writes the total into pinned host memory that the card sees, and the C
// call returns it as soon as it is there: the host learns the length
// without a stream synchronisation, and whatever uses the positions is
// ordered behind the kernel by the stream as usual.
//
// compact_select_cap is the capacity form (plan/compiler.py), which
// replaces tpu_prims.py compact_indices(mask, cap) (nonzero(size=cap,
// fill_value=0)): the first min(count, cap) positions into an output of cap
// int64, 0 in the rest of it, nothing at or past cap, and the count into
// device memory. Nothing waits on the host, so a CUDA graph can capture the
// call; the host reads the count later, with the other sites' counts.
// What bounds it: device-memory bytes, n mask bytes in and cap x 8 bytes
// out, each written once.
// Design (select_cap_kernel, one launch after a memset of the scratch's
// tiles + 1 words): the grid holds the select tiles and, after them,
// ceil(cap / kFillEntries) fill blocks, at most kFillBlocksPerSm an SM; a
// mask of one tile under a capacity of one fill block's share (the plans'
// many small sites) is one block that zeroes its own tail, with no memset.
// Tiles and fill blocks take one ticket order, so a fill block starts only
// once every select tile is held by a running block; it waits on the last
// tile's inclusive prefix (the count) and zeroes an equal share of
// [count, cap), wherever the count falls. No memset of the output: the
// select tiles write [0, min(count, cap)), the fill blocks the rest, each
// entry once. A select tile owns kCapTile = 16,384 rows (half the tiles of
// K9's 8,192, so half the look-back). A lane reads 4 consecutive rows a
// load, so a warp's load is 128 consecutive bytes and neighbouring lanes'
// True rows take neighbouring entries of the tile's staging in shared
// memory: the ranks come from one warp ballot per byte of a load (no
// shuffles), and the staging stores meet few bank conflicts. (A first form,
// 16 rows a lane read by 16-byte loads and ranked by a scan of per-lane
// counts, spent its time in bank-conflicted staging stores, which held back
// the co-resident tiles' counts and so every tile's prefix; PERF.md has
// both forms' times.) The first warp looks back before it stages its
// own rows, so the tile's prefix is out sooner. The staging goes to the
// output as 16-byte stores of two positions each.

#include <algorithm>
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
constexpr int kWordRows = 8;  // mask bytes in one loaded word
constexpr int kWords = 4;
constexpr int kPerThread = kWords * kWordRows;
constexpr int kTile = kThreads * kPerThread;

// scratch: [0] ticket counter, [1 + t] status word of tile t (lookback.cuh)
constexpr int kTicketWord = 0;
constexpr int kStatusWords = 1;

// kWordRows mask bytes as one word, byte j = row first + j; rows at or past
// n read as 0.
__device__ __forceinline__ unsigned long long load_rows(
    const unsigned char* __restrict__ mask, long long first, long long n,
    bool aligned) {
  if (first >= n) return 0ULL;
  if (aligned && first + kWordRows <= n) {
    return *reinterpret_cast<const unsigned long long*>(mask + first);
  }
  unsigned long long w = 0ULL;
  for (int j = 0; j < kWordRows && first + j < n; ++j) {
    w |= static_cast<unsigned long long>(mask[first + j]) << (8 * j);
  }
  return w;
}

// 0x80 in every byte of w that is not 0.
__device__ __forceinline__ unsigned long long nonzero_bytes(unsigned long long w) {
  const unsigned long long low7 = 0x7F7F7F7F7F7F7F7FULL;
  return (((w & low7) + low7) | w) & ~low7;
}

// Inclusive sum of `v` over the block's threads in thread order; `total`
// receives the block's sum. `warp_sums` holds kThreads / 32 ints.
__device__ __forceinline__ int block_inclusive_scan(int v, int* warp_sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFullWarp, v, d);
    if (lane >= d) v += up;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  int before = 0;
  int all = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    const int s = warp_sums[w];
    if (w < warp) before += s;
    all += s;
  }
  *total = all;
  return v + before;
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const unsigned char* __restrict__ mask, long long n, bool aligned,
              long long tiles, unsigned long long* __restrict__ scratch,
              long long* __restrict__ out, long long cap,
              volatile long long* total_out) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ short staged[kTile];  // the tile's True rows, as offsets into it
  __shared__ long long shared_tile;
  __shared__ long long shared_before;
  // the ticket comes first: a tile only ever waits on tiles handed out earlier
  if (threadIdx.x == 0) {
    shared_tile = tiles == 1 ? 0 : static_cast<long long>(
        atomicAdd(scratch + kTicketWord, 1ULL));
  }
  __syncthreads();
  const long long tile = shared_tile;
  unsigned long long* status = scratch + kStatusWords;

  const int own = threadIdx.x * kPerThread;
  const long long tile_first = tile * kTile;
  unsigned long long set[kWords];
  int mine = 0;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    set[w] = nonzero_bytes(
        load_rows(mask, tile_first + own + w * kWordRows, n, aligned));
    mine += __popcll(set[w]);
  }
  int total;
  int at = block_inclusive_scan(mine, warp_sums, &total) - mine;
  if (threadIdx.x == 0) {
    store_status(status + tile, status_word(tile == 0 ? kHasPrefix : kHasSum, total));
  }
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    while (set[w] != 0ULL) {
      const int bit = __ffsll(static_cast<long long>(set[w])) - 1;  // 8 * j + 7
      staged[at++] = static_cast<short>(own + w * kWordRows + (bit >> 3));
      set[w] &= set[w] - 1ULL;
    }
  }
  if (threadIdx.x < 32) {
    const long long before = tile == 0 ? 0 : lookback::sum_before(status, tile);
    if (threadIdx.x == 0) {
      if (tile != 0) {
        store_status(status + tile, status_word(kHasPrefix, before + total));
      }
      if (tile == tiles - 1) *total_out = before + total;
      shared_before = before;
    }
  }
  __syncthreads();
  // neighbouring threads write neighbouring positions, none at or past cap
  long long* dst = out + shared_before;
  const long long room = cap - shared_before;
  const int written = room < total ? static_cast<int>(max(room, 0LL)) : total;
  for (int k = threadIdx.x; k < written; k += kThreads) {
    dst[k] = tile_first + staged[k];
  }
}

// ---- K9c: the capacity form -----------------------------------------------

constexpr int kCapGroups = 16;  // loads a thread: groups of 128 rows a warp
constexpr int kCapWarpRows = kCapGroups * 128;  // 2,048 rows a warp
constexpr int kCapTile = kThreads / 32 * kCapWarpRows;  // 16,384 rows
constexpr long long kFillEntries = 16384;  // output entries a fill block is given, at most
constexpr int kFillBlocksPerSm = 2;       // fill blocks per SM, at most
static_assert(kCapTile <= 65536, "a row of the tile is kept as an unsigned short");

// Bit c of the result: byte c of w is not 0.
__device__ __forceinline__ unsigned nonzero_bits4(unsigned w) {
  unsigned m = w | (w >> 4);
  m |= m >> 2;
  m |= m >> 1;
  // bit 8c of m -> bit 24 + c
  return ((m & 0x01010101u) * 0x01020408u) >> 24;
}

// The flags of the lane's rows of the warp's 16 groups: bit c of flags[g] is
// row warp_first + 128 g + 4 lane + c. kWhole: every row exists and the mask
// is 4-byte aligned, so a group is one 4-byte load a lane (128 consecutive
// bytes a warp); otherwise byte by byte, rows at or past n False.
template <bool kWhole>
__device__ __forceinline__ void load_cap_flags(const unsigned char* __restrict__ mask,
                                               long long warp_first, long long n,
                                               unsigned flags[kCapGroups]) {
  const int lane = threadIdx.x & 31;
  if (kWhole) {
    unsigned words[kCapGroups];
#pragma unroll
    for (int g = 0; g < kCapGroups; ++g) {
      words[g] = __ldg(reinterpret_cast<const unsigned*>(mask + warp_first + g * 128 +
                                                         4 * lane));
    }
#pragma unroll
    for (int g = 0; g < kCapGroups; ++g) flags[g] = nonzero_bits4(words[g]);
  } else {
#pragma unroll
    for (int g = 0; g < kCapGroups; ++g) {
      unsigned f = 0;
      for (int c = 0; c < 4; ++c) {
        const long long row = warp_first + g * 128 + 4 * lane + c;
        if (row < n && mask[row] != 0) f |= 1u << c;
      }
      flags[g] = f;
    }
  }
}

// Fill block `fill` of `fills`: its share of zeros over out[from, to), 16
// bytes a store (out is 16-byte aligned). The pairs of entries from the
// first even one are cut into `fills` runs of equal length, so every fill
// block writes as much wherever the count falls; fill block 0 also writes
// the odd entries at either end. Called by the whole block.
__device__ __forceinline__ void zero_share(long long* __restrict__ out, long long from,
                                           long long to, long long fill, long long fills) {
  if (from >= to) return;
  const long long even = from + (from & 1);
  if (fill == 0 && threadIdx.x == 0) {
    if (even != from) out[from] = 0;
    if (((to - even) & 1) != 0) out[to - 1] = 0;
  }
  const long long pairs = (to - even) / 2;
  const long long per = (pairs + fills - 1) / fills;
  const long long last = min((fill + 1) * per, pairs);
  for (long long p = fill * per + threadIdx.x; p < last; p += kThreads) {
    *reinterpret_cast<longlong2*>(out + even + 2 * p) = make_longlong2(0, 0);
  }
}

__global__ void __launch_bounds__(kThreads)
select_cap_kernel(const unsigned char* __restrict__ mask, long long n, bool aligned4,
                  long long tiles, unsigned long long* __restrict__ scratch,
                  long long* __restrict__ out, long long cap,
                  long long* __restrict__ count_out) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ unsigned short staged[kCapTile];  // the tile's True rows, as offsets into it
  __shared__ long long shared_ticket;
  __shared__ long long shared_before;
  // the ticket comes first: select tiles take 0 .. tiles - 1, fill blocks
  // the rest, so a block only ever waits on blocks that already run. A grid
  // of one block (one tile, cap <= kFillEntries) takes no ticket and looks
  // at no status word: it zeroes [count, cap) itself
  const bool alone = gridDim.x == 1;
  if (threadIdx.x == 0) {
    shared_ticket = alone ? 0 : static_cast<long long>(
        atomicAdd(scratch + kTicketWord, 1ULL));
  }
  __syncthreads();
  const long long ticket = shared_ticket;
  unsigned long long* status = scratch + kStatusWords;

  if (ticket >= tiles) {  // a fill block: zeroes its share of [count, cap)
    if (threadIdx.x == 0) {
      unsigned long long w = lookback::load_status(status + tiles - 1);
      for (unsigned sleep = 32; (w >> lookback::kStatusShift) != kHasPrefix;
           sleep = min(2 * sleep, 1024u)) {
        __nanosleep(sleep);
        w = lookback::load_status(status + tiles - 1);
      }
      shared_before = static_cast<long long>(w & lookback::kValueMask);
    }
    __syncthreads();
    zero_share(out, shared_before, cap, ticket - tiles, gridDim.x - tiles);
    return;
  }

  const long long tile = ticket;
  const long long tile_first = tile * kCapTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp_first = tile_first + warp * kCapWarpRows;
  unsigned flags[kCapGroups];
  if (aligned4 && tile_first + kCapTile <= n) {
    load_cap_flags<true>(mask, warp_first, n, flags);
  } else {
    load_cap_flags<false>(mask, warp_first, n, flags);
  }
  // the rank within the warp of the lane's first True row of each group:
  // the warp's True rows of the groups before it, and of the lanes before
  // it in this one, from one ballot per byte of the group's loads
  const unsigned lanes_before = (1u << lane) - 1u;
  int rank[kCapGroups];
  int warp_total = 0;
#pragma unroll
  for (int g = 0; g < kCapGroups; ++g) {
    int before_lane = 0;
    int in_group = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned m = __ballot_sync(kFullWarp, (flags[g] >> c) & 1u);
      before_lane += __popc(m & lanes_before);
      in_group += __popc(m);
    }
    rank[g] = warp_total + before_lane;
    warp_total += in_group;
  }
  if (lane == 0) warp_sums[warp] = warp_total;
  __syncthreads();
  int warp_before = 0;
  int total = 0;
#pragma unroll
  for (int k = 0; k < kThreads / 32; ++k) {
    const int s = warp_sums[k];
    if (k < warp) warp_before += s;
    total += s;
  }
  if (threadIdx.x == 0 && !alone) {
    store_status(status + tile, status_word(tile == 0 ? kHasPrefix : kHasSum, total));
  }
  // the first warp looks back before it places its rows, so that the
  // tile's inclusive prefix, which later tiles wait on, is out sooner
  if (threadIdx.x < 32) {
    const long long before = tile == 0 ? 0 : lookback::sum_before(status, tile);
    if (threadIdx.x == 0) {
      if (tile != 0) {
        store_status(status + tile, status_word(kHasPrefix, before + total));
      }
      if (tile == tiles - 1) *count_out = before + total;
      shared_before = before;
    }
  }
  // neighbouring lanes' True rows take neighbouring entries: few bank conflicts
#pragma unroll
  for (int g = 0; g < kCapGroups; ++g) {
    int k = warp_before + rank[g];
    const int row = warp * kCapWarpRows + g * 128 + 4 * lane;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if ((flags[g] >> c) & 1u) staged[k++] = static_cast<unsigned short>(row + c);
    }
  }
  __syncthreads();
  if (alone) zero_share(out, total, cap, 0, 1);
  // out[before, before + written) from staged[0, written), none at or past
  // cap; two positions a 16-byte store where out + before + k is aligned
  const long long before = shared_before;
  const long long room = cap - before;
  const int written = room < total ? static_cast<int>(max(room, 0LL)) : total;
  if (written == 0) return;
  long long* dst = out + before;
  const int head = static_cast<int>(before & 1);  // out is 16-byte aligned
  if (threadIdx.x == 0) {
    if (head != 0) dst[0] = tile_first + staged[0];
    if (((written - head) & 1) != 0) {
      dst[written - 1] = tile_first + staged[written - 1];
    }
  }
  for (int k = head + 2 * threadIdx.x; k + 1 < written; k += 2 * kThreads) {
    *reinterpret_cast<longlong2*>(dst + k) =
        make_longlong2(tile_first + staged[k], tile_first + staged[k + 1]);
  }
}

}  // namespace

extern "C" {

int compact_tile_rows() { return kTile; }

// int64 words of scratch a call over `tiles` tiles needs.
long long compact_scratch_words(long long tiles) { return kStatusWords + tiles; }

// Positions of the nonzero bytes of mask[0..n), ascending, into `out`, which
// holds n int64 (the worst case). `scratch` holds
// compact_scratch_words(tiles) int64 and is cleared here. tiles must be
// ceil(n / compact_tile_rows()). Launches on `stream` and returns the number
// of True rows as soon as the kernel has written it to the host, without
// waiting for the kernel's end; or minus the first CUDA error.
long long compact_select(const void* mask, long long n, long long tiles,
                         void* scratch, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || tiles != (n + kTile - 1) / kTile || tiles > 0x7FFFFFFFLL) {
    return -static_cast<long long>(cudaErrorInvalidValue);
  }
  volatile long long* total = nullptr;
  long long* total_on_device = nullptr;
  cudaError_t err = lookback::take_slot(&total, &total_on_device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (tiles > 1) {  // one tile takes no ticket and looks at no status word
    err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return -static_cast<long long>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  select_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, aligned, tiles,
      static_cast<unsigned long long*>(scratch), static_cast<long long*>(out), n,
      total_on_device);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<long long>(err);
  err = lookback::wait_for_slot(total, stream);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  return *total;
}

int compact_cap_tile_rows() { return kCapTile; }

// The capacity form: the positions of the nonzero bytes of mask[0..n),
// ascending, into out[0..min(count, cap)), 0 in the rest of `out` (cap
// int64, 16-byte aligned), nothing at or past cap, and the count into
// *count (device memory). `scratch` holds compact_scratch_words(tiles) int64;
// tiles must be ceil(n / compact_cap_tile_rows()). Enqueues a memset of the
// scratch (unless the grid is one block) and one kernel on `stream`; returns
// the first CUDA error, or 0. Neither waits nor allocates.
int compact_select_cap(const void* mask, long long n, long long tiles, void* scratch,
                       void* out, long long cap, void* count, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int device = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  // one tile with a capacity of one fill block's share is one block alone
  const long long fills = tiles == 1 && cap <= kFillEntries ? 0 : std::min(
      (cap + kFillEntries - 1) / kFillEntries, static_cast<long long>(kFillBlocksPerSm) * sms);
  if (n < 1 || cap < 1 || tiles != (n + kCapTile - 1) / kCapTile ||
      tiles + fills > 0x7FFFFFFFLL || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tiles + fills > 1) {
    err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  select_cap_kernel<<<static_cast<unsigned>(tiles + fills), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, reinterpret_cast<uintptr_t>(mask) % 4 == 0,
      tiles,
      static_cast<unsigned long long*>(scratch), static_cast<long long*>(out), cap,
      static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
