// Stream compaction for Hopper (sm_90a), behind a plain C interface that
// hyrise_tpu_torch/kernels/compact.py loads with ctypes.
//
// compact_count + compact_write replace hyrise_tpu/kernels/tpu_prims.py
// compact_indices / positions_of_true (a prefix count and a scatter, or a
// sort of the masked positions): the ordered int64 positions of the nonzero
// bytes of a bool mask.
//
// What bounds it: device-memory bytes, n mask bytes in and 8 bytes out per
// True row (the mask is read twice: once to count, once to write).
//
// Design: three kernels, no atomics, so the positions come out in order.
// A block owns a tile of kTile consecutive rows, a thread kPerThread
// consecutive rows of it, read as one 8-byte word where the mask is aligned.
// compact_count writes each tile's number of True rows; scan_tiles (one
// block) turns the counts into exclusive offsets and the total, which the
// host reads to size the output; compact_write recounts its tile, scans its
// threads' counts (warp shuffles, then the warps' totals through shared
// memory), places every True row at its rank in a shared-memory copy of the
// tile's output and writes that copy out at the tile's offset, neighbouring
// threads to neighbouring positions.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kTile = kThreads * kPerThread;
constexpr int kScanThreads = 1024;

// The thread's kPerThread mask bytes as one word, byte j = row first + j;
// rows at or past n read as 0.
__device__ __forceinline__ unsigned long long load_rows(
    const unsigned char* __restrict__ mask, long long first, long long n,
    bool aligned) {
  if (first >= n) return 0ULL;
  if (aligned && first + kPerThread <= n) {
    return *reinterpret_cast<const unsigned long long*>(mask + first);
  }
  unsigned long long w = 0ULL;
  for (int j = 0; j < kPerThread && first + j < n; ++j) {
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
    const int up = __shfl_up_sync(0xFFFFFFFFu, v, d);
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
count_kernel(const unsigned char* __restrict__ mask, long long n, bool aligned,
             int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kThreads / 32];
  const long long first =
      static_cast<long long>(blockIdx.x) * kTile + threadIdx.x * kPerThread;
  const int mine = __popcll(nonzero_bytes(load_rows(mask, first, n, aligned)));
  int total;
  block_inclusive_scan(mine, warp_sums, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

// One block: offsets[t] = sum of counts[0..t), offsets[tiles] = the total.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const int* __restrict__ counts, long long tiles,
                  long long* __restrict__ offsets) {
  __shared__ long long warp_sums[kScanThreads / 32];
  __shared__ long long carry;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < tiles; base += kScanThreads) {
    const long long i = base + threadIdx.x;
    const long long mine = i < tiles ? counts[i] : 0;
    long long v = mine;
    for (int d = 1; d < 32; d <<= 1) {
      const long long up = __shfl_up_sync(0xFFFFFFFFu, v, d);
      if (lane >= d) v += up;
    }
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    long long before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    if (i < tiles) offsets[i] = before + v - mine;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry = before + v;
    __syncthreads();
  }
  if (threadIdx.x == 0) offsets[tiles] = carry;
}

__global__ void __launch_bounds__(kThreads)
write_kernel(const unsigned char* __restrict__ mask, long long n, bool aligned,
             const long long* __restrict__ offsets, long long* __restrict__ out) {
  __shared__ int warp_sums[kThreads / 32];
  __shared__ short staged[kTile];  // the tile's True rows, as offsets into it
  const int own = threadIdx.x * kPerThread;
  const long long tile_first = static_cast<long long>(blockIdx.x) * kTile;
  unsigned long long set =
      nonzero_bytes(load_rows(mask, tile_first + own, n, aligned));
  const int mine = __popcll(set);
  int total;
  int at = block_inclusive_scan(mine, warp_sums, &total) - mine;
  while (set != 0ULL) {
    const int bit = __ffsll(static_cast<long long>(set)) - 1;  // 8 * j + 7
    staged[at++] = static_cast<short>(own + (bit >> 3));
    set &= set - 1ULL;
  }
  __syncthreads();
  // neighbouring threads write neighbouring positions
  long long* dst = out + offsets[blockIdx.x];
  for (int k = threadIdx.x; k < total; k += kThreads) {
    dst[k] = tile_first + staged[k];
  }
}

}  // namespace

extern "C" {

int compact_tile_rows() { return kTile; }

// Pass 1 and the scan: tile_counts holds `tiles` ints, offsets tiles + 1
// int64; offsets[tiles] is the number of True rows. tiles must be
// ceil(n / compact_tile_rows()).
int compact_count(const void* mask, long long n, long long tiles,
                  void* tile_counts, void* offsets, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || tiles != (n + kTile - 1) / kTile || tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, aligned,
      static_cast<int*>(tile_counts));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_tiles_kernel<<<1, kScanThreads, 0, stream>>>(
      static_cast<const int*>(tile_counts), tiles,
      static_cast<long long*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: `out` holds offsets[tiles] int64 positions.
int compact_write(const void* mask, long long n, long long tiles,
                  const void* offsets, void* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n < 1 || tiles != (n + kTile - 1) / kTile || tiles > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = reinterpret_cast<uintptr_t>(mask) % 8 == 0;
  write_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
      static_cast<const unsigned char*>(mask), n, aligned,
      static_cast<const long long*>(offsets), static_cast<long long*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
