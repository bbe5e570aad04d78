// Hash-table equi-join lookup for Hopper (sm_90a), behind a plain C interface
// that hyrise_tpu_torch/kernels/hash_lookup.py loads with ctypes.
//
// hash_build + hash_probe replace the general form of
// hyrise_tpu/kernels/tpu_prims.py lookup_last_eq (one merged sort of build
// and probe keys and a fill): for every probe key, whether some valid build
// row carries an equal key and the LAST such row (the highest row id), for
// keys of any range, int64 or float64.
//
// What bounds it: device-memory bytes, 9 bytes per build row, 8 bytes in and
// 9 bytes out per probe row, and the table's 12 bytes per slot written once;
// the table accesses are random, one 32-byte sector each.
//
// Design: an open-addressing table with linear probing and a power-of-two
// capacity of at least twice the build rows. A slot's key doubles as its
// occupancy: empty slots hold kEmpty and a build thread claims one with a
// 64-bit atomicCAS, then records its row with atomicMax, which gives "last
// matching row" whatever order the threads run in (as the direct-address
// kernel does). Both atomics are skipped where a plain read shows them
// unnecessary (the slot already holds the key; the row already recorded is
// higher), which is what keeps a heavily repeated key from serialising. Keys are compared as 64-bit patterns: a float key is first
// brought to one pattern per value (-0.0 becomes 0.0; a NaN equals nothing,
// so it is neither inserted nor looked up). kEmpty is the pattern of INT64_MIN
// and of -0.0: no float key has it after that step, and the one integer key
// that does lives in an extra slot behind the table.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned long long kEmpty = 0x8000000000000000ULL;

// The key's canonical 64-bit pattern; false for a key that equals nothing.
__device__ __forceinline__ bool canonical(const void* keys, long long i,
                                          bool is_float,
                                          unsigned long long* bits) {
  if (is_float) {
    const double d = static_cast<const double*>(keys)[i] + 0.0;  // -0.0 -> 0.0
    if (d != d) return false;
    *bits = static_cast<unsigned long long>(__double_as_longlong(d));
  } else {
    *bits = static_cast<const unsigned long long*>(keys)[i];
  }
  return true;
}

__device__ __forceinline__ unsigned long long mix(unsigned long long h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

__global__ void __launch_bounds__(kThreads)
build_kernel(const void* __restrict__ keys, bool is_float,
             const unsigned char* __restrict__ valid, long long n,
             unsigned long long* slot_keys, int* slot_rows,
             unsigned long long capacity_mask) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  // From the last row down: a key's highest row tends to arrive first, and
  // the rows after it see that with a plain read and skip their atomics, so
  // a key that many rows share does not serialise them on one address.
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       j < n; j += step) {
    const long long i = n - 1 - j;
    unsigned long long k;
    if (!valid[i] || !canonical(keys, i, is_float, &k)) continue;
    if (k == kEmpty) {
      atomicMax(slot_rows + capacity_mask + 1, static_cast<int>(i));
      continue;
    }
    unsigned long long s = mix(k) & capacity_mask;
    while (true) {
      // volatile: another thread may have claimed the slot since
      unsigned long long seen =
          *static_cast<volatile unsigned long long*>(slot_keys + s);
      if (seen == kEmpty) seen = atomicCAS(slot_keys + s, kEmpty, k);
      if (seen == kEmpty || seen == k) {
        if (*static_cast<volatile int*>(slot_rows + s) < static_cast<int>(i)) {
          atomicMax(slot_rows + s, static_cast<int>(i));
        }
        break;
      }
      s = (s + 1) & capacity_mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const void* __restrict__ keys, bool is_float, long long n,
             const unsigned long long* __restrict__ slot_keys,
             const int* __restrict__ slot_rows, unsigned long long capacity_mask,
             unsigned char* __restrict__ matched, long long* __restrict__ rows) {
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    int row = -1;
    unsigned long long k;
    if (canonical(keys, i, is_float, &k)) {
      if (k == kEmpty) {
        row = slot_rows[capacity_mask + 1];
      } else {
        unsigned long long s = mix(k) & capacity_mask;
        while (true) {
          const unsigned long long seen = slot_keys[s];
          if (seen == k) {
            row = slot_rows[s];
            break;
          }
          if (seen == kEmpty) break;
          s = (s + 1) & capacity_mask;
        }
      }
    }
    matched[i] = row >= 0;
    rows[i] = row >= 0 ? row : 0;
  }
}

}  // namespace

extern "C" {

int hash_threads_per_block() { return kThreads; }

// slot_keys: `capacity` 8-byte slots, every one holding 0x8000000000000000;
// slot_rows: capacity + 1 int32, every one -1. capacity is a power of two
// and at least twice n, so a probe sequence always meets an empty slot.
// is_float: the keys are float64, else int64. Launches on `stream`, does not
// synchronise, returns the first CUDA error.
int hash_build(const void* keys, int is_float, const void* valid, long long n,
               void* slot_keys, void* slot_rows, long long capacity, int blocks,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || blocks < 1 || capacity < 2 * n || (capacity & (capacity - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  build_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, is_float != 0, static_cast<const unsigned char*>(valid), n,
      static_cast<unsigned long long*>(slot_keys), static_cast<int*>(slot_rows),
      static_cast<unsigned long long>(capacity - 1));
  return static_cast<int>(cudaGetLastError());
}

// matched: n bytes; rows: n int64 (0 where nothing matched).
int hash_probe(const void* keys, int is_float, long long n,
               const void* slot_keys, const void* slot_rows, long long capacity,
               void* matched, void* rows, int blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || blocks < 1 || capacity < 1 || (capacity & (capacity - 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  probe_kernel<<<blocks, kThreads, 0, stream>>>(
      keys, is_float != 0, n, static_cast<const unsigned long long*>(slot_keys),
      static_cast<const int*>(slot_rows),
      static_cast<unsigned long long>(capacity - 1),
      static_cast<unsigned char*>(matched), static_cast<long long*>(rows));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
