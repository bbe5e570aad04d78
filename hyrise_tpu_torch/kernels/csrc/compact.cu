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

#include <atomic>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordRows = 8;  // mask bytes in one loaded word
constexpr int kWords = 4;
constexpr int kPerThread = kWords * kWordRows;
constexpr int kTile = kThreads * kPerThread;
constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// A tile's status word: the top two bits say what the low 62 hold.
constexpr int kStatusShift = 62;
constexpr unsigned long long kHasCount = 1ULL;   // the tile's own True rows
constexpr unsigned long long kHasPrefix = 2ULL;  // those of tiles 0..this one
constexpr unsigned long long kValueMask = (1ULL << kStatusShift) - 1ULL;

// scratch: [0] ticket counter, [1 + t] status word of tile t
constexpr int kTicketWord = 0;
constexpr int kStatusWords = 1;

// Totals come back through pinned host memory mapped into the card's address
// space: a ring of slots, so that calls from several host threads each have
// their own.
constexpr int kSlots = 64;
constexpr long long kPending = -1;
constexpr unsigned kSpinsPerQuery = 1u << 16;
std::mutex slots_mutex;
long long* host_slots = nullptr;
std::atomic<unsigned> next_slot{0};

cudaError_t take_slot(volatile long long** host, long long** device) {
  {
    std::lock_guard<std::mutex> lock(slots_mutex);
    if (host_slots == nullptr) {
      void* p = nullptr;
      cudaError_t err = cudaHostAlloc(&p, kSlots * sizeof(long long),
                                      cudaHostAllocPortable | cudaHostAllocMapped);
      if (err != cudaSuccess) return err;
      host_slots = static_cast<long long*>(p);
    }
  }
  long long* slot = host_slots + next_slot.fetch_add(1) % kSlots;
  void* on_device = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&on_device, slot, 0);
  if (err != cudaSuccess) return err;
  *host = slot;
  *device = static_cast<long long*>(on_device);
  **host = kPending;
  return cudaSuccess;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* word) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(word) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* word,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" :: "l"(word), "l"(v) : "memory");
}

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

// The True rows of every tile before `tile` (called by one whole warp, tile
// > 0): looks back over the status words of tiles tile - 1, tile - 2, ...,
// a lane each, until one of them holds an inclusive prefix.
__device__ __forceinline__ long long rows_before(const unsigned long long* status,
                                                 long long tile) {
  const int lane = threadIdx.x & 31;
  long long before = 0;
  for (long long look = tile - 1 - lane;; look -= 32) {
    // a lane that has run off the front reads as "prefix 0"
    unsigned long long w;
    do {
      w = look >= 0 ? load_status(status + look) : (kHasPrefix << kStatusShift);
    } while (__any_sync(kFullWarp, (w >> kStatusShift) == 0ULL));
    const unsigned with_prefix =
        __ballot_sync(kFullWarp, (w >> kStatusShift) == kHasPrefix);
    // the nearest earlier tile that knows its prefix ends the walk
    const int stop = with_prefix != 0u ? __ffs(static_cast<int>(with_prefix)) - 1 : 31;
    long long part = lane <= stop ? static_cast<long long>(w & kValueMask) : 0;
    for (int d = 16; d > 0; d >>= 1) part += __shfl_xor_sync(kFullWarp, part, d);
    before += part;
    if (with_prefix != 0u) return before;
  }
}

__global__ void __launch_bounds__(kThreads)
select_kernel(const unsigned char* __restrict__ mask, long long n, bool aligned,
              long long tiles, unsigned long long* __restrict__ scratch,
              long long* __restrict__ out, volatile long long* host_total) {
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
    store_status(status + tile, ((tile == 0 ? kHasPrefix : kHasCount) << kStatusShift) |
                                    static_cast<unsigned long long>(total));
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
    const long long before = tile == 0 ? 0 : rows_before(status, tile);
    if (threadIdx.x == 0) {
      if (tile != 0) {
        store_status(status + tile, (kHasPrefix << kStatusShift) |
                                        static_cast<unsigned long long>(before + total));
      }
      if (tile == tiles - 1) *host_total = before + total;
      shared_before = before;
    }
  }
  __syncthreads();
  // neighbouring threads write neighbouring positions
  long long* dst = out + shared_before;
  for (int k = threadIdx.x; k < total; k += kThreads) {
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
  cudaError_t err = take_slot(&total, &total_on_device);
  if (err != cudaSuccess) return -static_cast<long long>(err);
  if (tiles > 1) {  // one tile takes no ticket and looks at no status word
    err = cudaMemsetAsync(scratch, 0, (kStatusWords + tiles) * 8, stream);
    if (err != cudaSuccess) return -static_cast<long long>(err);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  select_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, aligned, tiles,
      static_cast<unsigned long long*>(scratch), static_cast<long long*>(out),
      total_on_device);
  err = cudaGetLastError();
  if (err != cudaSuccess) return -static_cast<long long>(err);
  // wait for the total; now and then ask whether the stream has ended, since
  // one that ends without a total has failed
  for (unsigned spins = 1; *total == kPending; ++spins) {
    if (spins % kSpinsPerQuery != 0) continue;
    err = cudaStreamQuery(stream);
    if (err == cudaErrorNotReady) continue;
    if (*total != kPending) break;
    return -static_cast<long long>(err == cudaSuccess ? cudaErrorUnknown : err);
  }
  return *total;
}

}  // extern "C"
