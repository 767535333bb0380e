// Survivor compaction: the counterpart of
// pfac_tpu/backends/pallas_sieve.py::_compact (the XLA bitmap compaction
// after the sieve kernel, with its MXU prefix sums). It lists the
// positions of the set bits of K1's survivor bitmap in ascending order,
// skipping every block the dense-block escape (K3) walks whole.
//
// Input: bits (bit j of word w is position 32w + j), K1's per-block counts
// (counts[b] = set bits of block b) and the dense threshold: a block with
// counts[b] >= thresh is K3's and counts as empty. Two launches:
// * compact_scan_kernel (one CTA): offsets[b] = the exclusive prefix sum of
//   the blocks' counts with dense blocks as 0, offsets[nblocks] = total.
//   The wrapper copies the total to the host (4 bytes, the path's one host
//   round trip; torch.nonzero made the same one) to size the positions;
// * compact_kernel (one CTA per block): a block that is empty or dense
//   returns at once; otherwise each thread takes block / 8192 consecutive
//   bitmap words, the CTA scans the threads' popcounts (__shfl_up_sync in
//   each warp, then the warp totals) and each thread writes its set bits'
//   positions from offsets[b] + its prefix on.
// Bound: device memory. The bitmap of the blocks with survivors (npad / 8
// bytes at most, 16 MiB at 128 MiB of input, 5 us at 3.35 TB/s), the
// counts and 4 bytes per survivor; the scan reads nblocks counts. Positions
// come out in ascending order by construction: blocks in order of b, words
// in order inside a block, bits in order inside a word.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kBlockGrain = 32 * kThreads;   // block % kBlockGrain == 0

// Inclusive scan of x across the warp.
__device__ __forceinline__ int32_t warp_scan(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kScanThreads)
compact_scan_kernel(const int32_t* __restrict__ counts, int32_t nblocks,
                    int32_t thresh, int32_t* __restrict__ offsets) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  for (int32_t base = 0; base < nblocks; base += kScanThreads) {
    const int32_t i = base + threadIdx.x;
    int32_t c = i < nblocks ? counts[i] : 0;
    if (c >= thresh) c = 0;                  // K3 walks this block whole
    const int32_t x = warp_scan(c, lane);
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();                         // also publishes carry
    if (warp == 0) warp_sum[lane] = warp_scan(warp_sum[lane], lane);
    __syncthreads();
    const int32_t excl = carry + (warp ? warp_sum[warp - 1] : 0) + x - c;
    if (i < nblocks) offsets[i] = excl;
    __syncthreads();                         // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = excl + c;
  }
  __syncthreads();
  if (threadIdx.x == 0) offsets[nblocks] = carry;
}

__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint32_t* __restrict__ bits,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ offsets, int32_t block,
               int32_t thresh, int32_t* __restrict__ pos) {
  const int32_t b = blockIdx.x;
  const int32_t cnt = counts[b];
  if (cnt == 0 || cnt >= thresh) return;     // uniform across the CTA
  __shared__ int32_t warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = block / kBlockGrain;       // words per thread
  const int64_t w0 = static_cast<int64_t>(b) * (block / 32) +
                     static_cast<int64_t>(threadIdx.x) * per;
  const uint32_t* src = bits + w0;
  int32_t c = 0;
  for (int k = 0; k < per; ++k) c += __popc(__ldg(src + k));
  const int32_t x = warp_scan(c, lane);
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int32_t off = offsets[b] + x - c;
  for (int k = 0; k < warp; ++k) off += warp_sum[k];
  for (int k = 0; k < per && c != 0; ++k) {
    uint32_t word = __ldg(src + k);
    const int32_t p = static_cast<int32_t>((w0 + k) * 32);
    while (word) {
      pos[off++] = p + __ffs(word) - 1;
      word &= word - 1;
    }
  }
}

}  // namespace

// counts: int32[nblocks]; offsets: int32[nblocks + 1]. Launches on
// `stream`; returns cudaGetLastError().
extern "C" int pfac_compact_scan(int device, const void* counts,
                                 int32_t nblocks, int32_t thresh,
                                 void* offsets, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks < 0) return static_cast<int>(cudaErrorInvalidValue);
  compact_scan_kernel<<<1, kScanThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), nblocks, thresh,
      static_cast<int32_t*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// bits: int32[nblocks * block / 32]; counts: int32[nblocks]; offsets: the
// scan's; pos: int32[offsets[nblocks]]; block % 8192 == 0, else
// cudaErrorInvalidValue. Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_compact(int device, const void* bits, const void* counts,
                            const void* offsets, int32_t nblocks,
                            int32_t block, int32_t thresh, void* pos,
                            void* stream) {
  if (block <= 0 || block % kBlockGrain != 0 || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks == 0) return 0;
  compact_kernel<<<static_cast<unsigned>(nblocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(offsets), block, thresh,
      static_cast<int32_t*>(pos));
  return static_cast<int>(cudaGetLastError());
}
