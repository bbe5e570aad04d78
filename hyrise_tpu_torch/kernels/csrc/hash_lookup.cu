// Hash-table equi-join lookup for Hopper (sm_90a), behind a plain C interface
// that hyrise_tpu_torch/kernels/hash_lookup.py loads with ctypes.
//
// hash_lookup replaces the general form of hyrise_tpu/kernels/tpu_prims.py
// lookup_last_eq (one merged sort of build and probe keys and a fill): for
// every probe key, whether some valid build row carries an equal key and the
// LAST such row (the highest row id), for keys of any range, int64 or
// float64.
//
// What bounds it: not the streamed bytes (9 per build row; 8 in and 9 out per
// probe row) but the table's scattered accesses: in the build one 64-bit
// compare-and-swap per distinct key, whose rate sets the build's time, and in
// the probe one filter word and, where its bit is set, one 32-byte sector of
// the table per probe row, most of them out of the L2.
//
// Design: one C call enqueues a memset of the table and its filter, the
// build and the probe; nothing runs on the host between them.
// - The table is open addressing with linear probing over 16-byte slots, two
//   to a 32-byte sector: {key ^ 0x8000000000000000, row + 1, unused}. Empty
//   is all-zero bytes, so a memset clears it. A probe sequence starts on the
//   first slot of a sector (a multiply-high of the key's hash picks the
//   sector, so any even number of slots works), so the sector's second slot
//   is walked before the next sector is touched, and the key and its row
//   arrive in one 16-byte load: a hit costs one sector. The one key whose
//   stored pattern is zero (the int64 key INT64_MIN; no float key has it,
//   see below) lives in an extra slot behind the table. The wrapper gives
//   two slots a build row (hash_lookup.table_slots), so the load is at most
//   a half: with all build keys distinct a smaller table walks far longer.
// - Behind the table lies a filter of 8 to 16 bits a build row
//   (hash_lookup.filter_bits), one bit a key by the hash's low bits, set by
//   the thread that claims the key's slot. A probe key whose bit is clear
//   reads no slot: most misses, which are half of the probes of a join on a
//   foreign key and, at a load of a half, the longest walks, cost one read
//   of a filter that stays in the L2.
// - Keys compare as 64-bit patterns: a float key is first brought to one
//   pattern per value (-0.0 becomes 0.0; a NaN equals nothing, so it is
//   neither inserted nor looked up).
// - Build: one row a thread, rows taken from the last one down. The lanes of
//   a warp that hold the same key leave its insert to the one with the
//   highest row, so a key shared by many rows costs one insert a warp. An
//   inserting lane first reads its slot with a plain load and uses an atomic
//   only where that read shows it necessary: a 64-bit atomicCAS to claim an
//   empty slot, an atomicMax on the row word where the row seen is lower.
//   Keys never change once claimed and rows only grow, so a stale plain read
//   can only cause an atomic that was not needed, never a missed one;
//   atomicMax makes "last row" independent of the order the threads run in,
//   so two launches give the same bits. (Two or four rows a thread, their
//   claims issued together, took more registers and fewer threads and were
//   slower at every size timed.)
// - Probe: four consecutive rows a thread, keys by 16-byte loads where the
//   view is 16-byte aligned (8-byte loads otherwise); the four filter words,
//   then the slots of the rows whose bit is set, each issued before any is
//   used (an L2 evict-last policy on them, evict-first on the streamed keys
//   and outputs); `matched` stored as one 4-byte word and the rows by two
//   16-byte stores; the last nq % 4 rows go one to a thread.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kProbeRows = 4;    // consecutive probe rows a thread takes at a time
static_assert(kProbeRows == 4, "a thread stores its rows' matched flags as one word");
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr unsigned long long kSign = 0x8000000000000000ULL;

struct alignas(16) Slot {
  unsigned long long key;  // the key's pattern ^ kSign; 0: empty
  unsigned row;            // row + 1; 0: none
  unsigned unused;
};

// The key's stored pattern in *enc; false for a key that equals nothing.
__device__ __forceinline__ bool encode(long long bits, bool is_float,
                                       unsigned long long* enc) {
  if (is_float) {
    const double d = __longlong_as_double(bits) + 0.0;  // -0.0 -> 0.0
    if (d != d) return false;
    bits = __double_as_longlong(d);
  }
  *enc = static_cast<unsigned long long>(bits) ^ kSign;
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

// The first slot of the probe sequence of a key whose mixed hash is h: the
// first slot of a sector, picked by h's high bits.
__device__ __forceinline__ unsigned long long first_slot(unsigned long long h,
                                                         unsigned long long sectors) {
  return 2 * __umul64hi(h, sectors);
}

__device__ __forceinline__ unsigned long long next_slot(unsigned long long s,
                                                        unsigned long long slots) {
  return s + 1 == slots ? 0 : s + 1;
}

// A plain 16-byte read of a slot (may be stale while the build runs).
__device__ __forceinline__ ulonglong2 read_slot(const Slot* slot) {
  ulonglong2 v;
  asm volatile("ld.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(v.x), "=l"(v.y)
               : "l"(slot));
  return v;
}

// The same for the probe, which runs after the build: keep the table in L2.
__device__ __forceinline__ ulonglong2 read_slot_kept(const Slot* slot,
                                                     unsigned long long policy) {
  ulonglong2 v;
  asm("ld.global.L2::cache_hint.v2.u64 {%0, %1}, [%2], %3;"
      : "=l"(v.x), "=l"(v.y)
      : "l"(slot), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned load_kept(const unsigned* p, unsigned long long policy) {
  unsigned v;
  asm("ld.global.L2::cache_hint.b32 %0, [%1], %2;" : "=r"(v) : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ unsigned long long evict_last_policy() {
  unsigned long long policy;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// Sets the filter bit of the key whose mixed hash is h.
__device__ __forceinline__ void mark(unsigned* filter, unsigned long long filter_mask,
                                     unsigned long long h) {
  atomicOr(filter + ((h & filter_mask) >> 5), 1u << (h & 31));
}

// Records row1 (row + 1) for the key enc (not 0, mixed hash h) from slot s of
// its probe sequence on, where `seen` is a plain read of slot s.
__device__ __noinline__ void insert_from(Slot* table, unsigned long long slots,
                                         unsigned* filter, unsigned long long filter_mask,
                                         unsigned long long enc, unsigned long long h,
                                         unsigned row1, unsigned long long s,
                                         ulonglong2 seen) {
  while (true) {
    unsigned long long key = seen.x;
    if (key == 0) {
      key = atomicCAS(&table[s].key, 0ULL, enc);
      if (key == 0) {  // claimed
        key = enc;
        mark(filter, filter_mask, h);
      }
    }
    if (key == enc) {
      if (static_cast<unsigned>(seen.y) < row1) atomicMax(&table[s].row, row1);
      return;
    }
    s = next_slot(s, slots);
    seen = read_slot(table + s);
  }
}

__global__ void __launch_bounds__(kThreads)
build_kernel(const long long* __restrict__ keys, bool is_float,
             const unsigned char* __restrict__ valid, long long n, Slot* table,
             unsigned long long slots, unsigned* filter, unsigned long long filter_mask) {
  const int lane = threadIdx.x & 31;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  // every lane of a warp runs the same iterations: match.any needs them all
  for (long long w = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
       w * 32 < n; w += warps) {
    const long long j = w * 32 + lane;
    const long long row = n - 1 - j;  // from the last row down
    unsigned long long enc = 0;
    const bool active = j < n && valid[row] && encode(keys[row], is_float, &enc);
    // lanes whose keys agree in their low 32 bits find the lowest of them,
    // which holds the highest row, and leave the insert to it if its key is
    // theirs (a 32-bit match costs less than a 64-bit one)
    const unsigned peers = __match_any_sync(kFullWarp, static_cast<unsigned>(enc)) &
                           __ballot_sync(kFullWarp, active);
    const int first = __ffs(static_cast<int>(peers)) - 1;
    const unsigned long long first_enc = __shfl_sync(kFullWarp, enc, max(first, 0));
    if (!active || (lane != first && first_enc == enc)) continue;
    const unsigned long long h = mix(enc);
    const unsigned long long s = enc == 0 ? slots : first_slot(h, slots / 2);
    const ulonglong2 seen = read_slot(table + s);
    unsigned long long key = seen.x;
    if (enc != 0 && key == 0) {  // an empty first slot: claim it
      key = atomicCAS(&table[s].key, 0ULL, enc);
      if (key == 0) mark(filter, filter_mask, h);
    }
    const unsigned row1 = static_cast<unsigned>(row + 1);
    if (enc == 0 || key == 0 || key == enc) {
      // the slot behind the table, a slot just claimed, or the key's own
      if (static_cast<unsigned>(seen.y) < row1) atomicMax(&table[s].row, row1);
    } else {  // another key's slot: walk on
      const unsigned long long t = next_slot(s, slots);
      insert_from(table, slots, filter, filter_mask, enc, h, row1, t, read_slot(table + t));
    }
  }
}

// row + 1 of the key enc, or 0, where `seen` is slot s, the first of its
// probe sequence.
__device__ __forceinline__ unsigned find(const Slot* __restrict__ table,
                                         unsigned long long slots,
                                         unsigned long long enc, unsigned long long s,
                                         ulonglong2 seen, unsigned long long policy) {
  if (enc == 0) return static_cast<unsigned>(seen.y);
  while (seen.x != enc) {
    if (seen.x == 0) return 0;
    s = next_slot(s, slots);
    seen = read_slot_kept(table + s, policy);
  }
  return static_cast<unsigned>(seen.y);
}

// Whether the key may be in the table: encodable, and either the key of the
// slot behind the table or one whose filter bit is set. Sets *enc and *s,
// the first slot of its probe sequence; `word` is read from the filter.
__device__ __forceinline__ bool probe_start(long long key, bool is_float,
                                            unsigned long long slots,
                                            const unsigned* __restrict__ filter,
                                            unsigned long long filter_mask,
                                            unsigned long long policy,
                                            unsigned long long* enc,
                                            unsigned long long* s, unsigned* word,
                                            unsigned* bit) {
  if (!encode(key, is_float, enc)) return false;
  if (*enc == 0) {
    *s = slots;
    *word = *bit = 1;
    return true;
  }
  const unsigned long long h = mix(*enc);
  *s = first_slot(h, slots / 2);
  *bit = 1u << (h & 31);
  *word = load_kept(filter + ((h & filter_mask) >> 5), policy);
  return true;
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const long long* __restrict__ keys, bool is_float, long long n,
             bool aligned, const Slot* __restrict__ table, unsigned long long slots,
             const unsigned* __restrict__ filter, unsigned long long filter_mask,
             unsigned char* __restrict__ matched, long long* __restrict__ rows) {
  const unsigned long long policy = evict_last_policy();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long groups = n / kProbeRows;
  for (long long g = first; g < groups; g += stride) {
    const long long at = g * kProbeRows;
    long long k[kProbeRows];
#pragma unroll
    for (int j = 0; j < kProbeRows; j += 2) {
      if (aligned) {
        const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(keys + at + j));
        k[j] = v.x;
        k[j + 1] = v.y;
      } else {
        k[j] = __ldcs(keys + at + j);
        k[j + 1] = __ldcs(keys + at + j + 1);
      }
    }
    unsigned long long enc[kProbeRows], s[kProbeRows];
    unsigned word[kProbeRows], bit[kProbeRows];
    bool ok[kProbeRows];
    ulonglong2 seen[kProbeRows];
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {  // every filter word read first
      ok[j] = probe_start(k[j], is_float, slots, filter, filter_mask, policy, &enc[j],
                          &s[j], &word[j], &bit[j]);
    }
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {  // then every slot read before any compare
      ok[j] = ok[j] && (word[j] & bit[j]) != 0;
      if (ok[j]) seen[j] = read_slot_kept(table + s[j], policy);
    }
    unsigned flags = 0;
    long long out[kProbeRows];
#pragma unroll
    for (int j = 0; j < kProbeRows; ++j) {
      const unsigned row1 = ok[j] ? find(table, slots, enc[j], s[j], seen[j], policy) : 0;
      flags |= (row1 != 0 ? 1u : 0u) << (8 * j);
      out[j] = row1 != 0 ? static_cast<long long>(row1) - 1 : 0;
    }
    __stcs(reinterpret_cast<unsigned*>(matched + at), flags);
#pragma unroll
    for (int j = 0; j < kProbeRows; j += 2) {
      __stcs(reinterpret_cast<longlong2*>(rows + at + j), make_longlong2(out[j], out[j + 1]));
    }
  }
  const long long tail = groups * kProbeRows + first;
  if (tail < n) {
    unsigned long long enc, s;
    unsigned word, bit, row1 = 0;
    if (probe_start(keys[tail], is_float, slots, filter, filter_mask, policy, &enc, &s,
                    &word, &bit) && (word & bit) != 0) {
      row1 = find(table, slots, enc, s, read_slot_kept(table + s, policy), policy);
    }
    matched[tail] = row1 != 0;
    rows[tail] = row1 != 0 ? static_cast<long long>(row1) - 1 : 0;
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

int hash_threads_per_block() { return kThreads; }
int hash_probe_rows_per_thread() { return kProbeRows; }

// matched[i] and rows[i] (0 where nothing matched) for the nq >= 1 probe
// keys against the nb >= 0 build rows; keys are float64 if is_float, else
// int64. `table` is scratch: slots + 1 slots of 16 bytes, then the filter of
// filter_bits bits; slots is even and larger than nb, so a probe sequence
// always meets an empty slot, and filter_bits is a power of two, at least 32.
// matched and rows are 16-byte aligned (whole allocations); the inputs may be
// views. Enqueues a memset and two kernels (no build if nb == 0) on `stream`
// with build_blocks and probe_blocks blocks; returns the first CUDA error,
// or 0. Neither synchronises nor allocates.
int hash_lookup(const void* build_keys, const void* build_valid, long long nb,
                const void* probe_keys, long long nq, int is_float, void* table,
                long long slots, long long filter_bits, void* matched, void* rows,
                int build_blocks, int probe_blocks, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nq < 1 || nb < 0 || slots <= nb || slots < 2 || (slots & 1) || filter_bits < 32 ||
      (filter_bits & (filter_bits - 1)) || build_blocks < 1 || probe_blocks < 1 ||
      !aligned16(table) || !aligned16(matched) || !aligned16(rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t table_bytes = static_cast<size_t>(slots + 1) * sizeof(Slot);
  cudaError_t err = cudaMemsetAsync(table, 0, table_bytes + filter_bits / 8, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  Slot* slot_table = static_cast<Slot*>(table);
  unsigned* filter = reinterpret_cast<unsigned*>(static_cast<char*>(table) + table_bytes);
  const unsigned long long filter_mask = static_cast<unsigned long long>(filter_bits - 1);
  if (nb > 0) {
    build_kernel<<<build_blocks, kThreads, 0, stream>>>(
        static_cast<const long long*>(build_keys), is_float != 0,
        static_cast<const unsigned char*>(build_valid), nb, slot_table,
        static_cast<unsigned long long>(slots), filter, filter_mask);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  probe_kernel<<<probe_blocks, kThreads, 0, stream>>>(
      static_cast<const long long*>(probe_keys), is_float != 0, nq,
      aligned16(probe_keys), slot_table, static_cast<unsigned long long>(slots), filter,
      filter_mask, static_cast<unsigned char*>(matched), static_cast<long long*>(rows));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
