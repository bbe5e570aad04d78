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
// compact_select_cap is the capacity form (plan/compiler.py; JAX
// compact_indices(mask, cap), nonzero(size=cap, fill_value=0)): the same
// kernel writes the first min(count, cap) positions into an output of cap
// int64, never past it, after a memset of the output to 0, and the count
// into device memory. Nothing waits on the host, so a CUDA graph can capture
// the call; the host reads the count later, with the other sites' counts.
// What bounds it: n mask bytes in, cap x 8 bytes out (the memset and the
// positions).

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

// The capacity form: the positions of the nonzero bytes of mask[0..n),
// ascending, into out[0..min(count, cap)), the rest of `out` (cap int64) 0,
// and the count into *count (device memory). `scratch` as for
// compact_select. Enqueues two memsets and the kernel on `stream`; returns
// the first CUDA error, or 0. Neither waits nor allocates.
int compact_select_cap(const void* mask, long long n, long long tiles, void* scratch,
                       void* out, long long cap, void* count, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || cap < 1 || tiles != (n + kTile - 1) / kTile || tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaMemsetAsync(out, 0, cap * 8, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tiles > 1) {
    err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  select_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, aligned, tiles,
      static_cast<unsigned long long*>(scratch), static_cast<long long*>(out), cap,
      static_cast<long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
