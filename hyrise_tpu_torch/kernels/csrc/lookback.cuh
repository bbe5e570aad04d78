// What the one-pass kernels with decoupled look-back share (compact.cu's
// select and join_probe.cu's scan of the match counts): the tiles' status
// words, the warp-wide walk back over them, and the pinned host slots
// through which a kernel's last tile hands its totals to the host.
//
// A tile's status word carries two bits of state and 62 of value in one
// 8-byte store (st.release, read with ld.acquire), so a reader sees both or
// neither. A tile first publishes its own sum (kHasSum) and, once it has
// added the sums of the tiles before it, its inclusive prefix (kHasPrefix).
// Tiles are handed out by a ticket counter, so a tile only ever waits on
// tiles held by blocks that already run.
//
// kernels/build.py hashes this file with every source that includes it.

#pragma once

#include <atomic>
#include <mutex>

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The top two bits of a status word say what the low 62 hold.
constexpr int kStatusShift = 62;
constexpr unsigned long long kHasSum = 1ULL;     // the tile's own sum
constexpr unsigned long long kHasPrefix = 2ULL;  // the sum of tiles 0..this one
constexpr unsigned long long kValueMask = (1ULL << kStatusShift) - 1ULL;

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

__device__ __forceinline__ unsigned long long status_word(unsigned long long state,
                                                          long long value) {
  return (state << kStatusShift) | static_cast<unsigned long long>(value);
}

// The sum of every tile before `tile` (called by one whole warp, tile > 0):
// looks back over the status words of tiles tile - 1, tile - 2, ..., a lane
// each, until one of them holds an inclusive prefix.
__device__ __forceinline__ long long sum_before(const unsigned long long* status,
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

// Totals come back through pinned host memory mapped into the card's address
// space: a ring of slots of kSlotWords int64 each, so that calls from several
// host threads each have their own. The host waits on word 0; what a kernel
// writes into the other words is there once its stream has ended.
constexpr int kSlots = 64;
constexpr int kSlotWords = 8;
constexpr long long kPending = -1;
constexpr unsigned kSpinsPerQuery = 1u << 16;
inline std::mutex slots_mutex;
inline long long* host_slots = nullptr;
inline std::atomic<unsigned> next_slot{0};

inline cudaError_t take_slot(volatile long long** host, long long** device) {
  {
    std::lock_guard<std::mutex> lock(slots_mutex);
    if (host_slots == nullptr) {
      void* p = nullptr;
      cudaError_t err = cudaHostAlloc(&p, kSlots * kSlotWords * sizeof(long long),
                                      cudaHostAllocPortable | cudaHostAllocMapped);
      if (err != cudaSuccess) return err;
      host_slots = static_cast<long long*>(p);
    }
  }
  long long* slot = host_slots + (next_slot.fetch_add(1) % kSlots) * kSlotWords;
  void* on_device = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&on_device, slot, 0);
  if (err != cudaSuccess) return err;
  *host = slot;
  *device = static_cast<long long*>(on_device);
  **host = kPending;
  return cudaSuccess;
}

// Waits until the kernel launched on `stream` has written word 0 of the
// slot, without waiting for the kernel's end. Now and then it asks whether
// the stream has ended, since one that ends without the word has failed.
inline cudaError_t wait_for_slot(volatile long long* slot, cudaStream_t stream) {
  for (unsigned spins = 1; *slot == kPending; ++spins) {
    if (spins % kSpinsPerQuery != 0) continue;
    cudaError_t err = cudaStreamQuery(stream);
    if (err == cudaErrorNotReady) continue;
    if (*slot != kPending) break;
    return err == cudaSuccess ? cudaErrorUnknown : err;
  }
  std::atomic_thread_fence(std::memory_order_acquire);
  return cudaSuccess;
}

}  // namespace lookback
