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
//   The total stays on the device: the walkers read it there, and the
//   positions go into a buffer sized without it (a block listed has fewer
//   than thresh survivors), so the host never waits for the count. Given
//   a program's counter words (backends/program.py; null from the
//   per-kernel entry point), one thread adds the total to counters[0] and
//   the number of dense blocks to counters[1], an atomic each;
// * compact_kernel (one CTA per block): a block that is empty or dense
//   returns at once; otherwise each warp takes a run of block / 256
//   consecutive bitmap words and counts them, the CTA adds up the warp
//   totals before it, and the warp lists its positions 32 words at a time,
//   a word a lane, with a warp scan of the words' popcounts: where the 32
//   words hold at most 32 set bits each lane writes its own word's
//   positions; where they hold more, the warp takes the words one by one,
//   lane j writing position 32w + j at the word's slot + __popc of its bits
//   below j. Either way a store instruction of the warp falls on
//   consecutive slots, so dense blocks write whole lines (a thread walking
//   dense words of its own would write 32 lines a store).
// Bound: device memory. The bitmap of the blocks with survivors (npad / 8
// bytes at most, 16 MiB at 128 MiB of input, 5 us at 3.35 TB/s), the
// counts and 4 bytes per survivor; the scan reads nblocks counts. Positions
// come out in ascending order by construction: blocks in order of b, words
// in order inside a block, bits in order inside a word.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kBlockGrain = 32 * kThreads;   // block % kBlockGrain == 0
constexpr int kSparseChunk = 32;   // set bits in 32 words listed lane-wise

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
                    int32_t thresh, int32_t* __restrict__ offsets,
                    unsigned long long* __restrict__ counters) {
  __shared__ int32_t warp_sum[kScanThreads / 32];
  __shared__ int32_t carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  int32_t dense = 0;                         // the same in every thread
  for (int32_t base = 0; base < nblocks; base += kScanThreads) {
    const int32_t i = base + threadIdx.x;
    int32_t c = i < nblocks ? counts[i] : 0;
    const bool escaped = i < nblocks && c >= thresh;
    if (escaped) c = 0;                      // K3 walks this block whole
    const int32_t x = warp_scan(c, lane);
    if (lane == 31) warp_sum[warp] = x;
    dense += __syncthreads_count(escaped);   // also publishes carry
    if (warp == 0) warp_sum[lane] = warp_scan(warp_sum[lane], lane);
    __syncthreads();
    const int32_t excl = carry + (warp ? warp_sum[warp - 1] : 0) + x - c;
    if (i < nblocks) offsets[i] = excl;
    __syncthreads();                         // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = excl + c;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    offsets[nblocks] = carry;
    if (counters != nullptr) {
      atomicAdd(counters, static_cast<unsigned long long>(carry));
      atomicAdd(counters + 1, static_cast<unsigned long long>(dense));
    }
  }
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
  const int per_warp = block / (32 * (kThreads / 32));   // words, % 32 == 0
  const int64_t wb = static_cast<int64_t>(b) * (block / 32) +
                     static_cast<int64_t>(warp) * per_warp;
  const uint32_t* src = bits + wb;
  int32_t c = 0;
#pragma unroll 8
  for (int k = lane; k < per_warp; k += 32) c += __popc(__ldg(src + k));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) c += __shfl_xor_sync(kFull, c, d);
  if (lane == 0) warp_sum[warp] = c;
  __syncthreads();
  int32_t off = offsets[b];                  // the same in every lane
  for (int k = 0; k < warp; ++k) off += warp_sum[k];
  if (c == 0) return;
  const uint32_t below = (1u << lane) - 1u;
  for (int k0 = 0; k0 < per_warp; k0 += 32) {
    uint32_t mine = __ldg(src + k0 + lane);
    if (!__any_sync(kFull, mine != 0)) continue;
    const int32_t n = __popc(mine);
    const int32_t incl = warp_scan(n, lane);
    const int32_t total = __shfl_sync(kFull, incl, 31);
    if (total <= kSparseChunk) {
      // a bit a lane or fewer: each lane lists its own word's positions,
      // and the warp's stores still fall on consecutive slots
      int32_t slot = off + incl - n;
      const int32_t p = static_cast<int32_t>((wb + k0 + lane) * 32);
      while (mine) {
        const int32_t q = p + __ffs(mine) - 1;
        pos[slot] = q;
        ++slot;
        mine &= mine - 1;
      }
    } else {
      // dense: word by word across the warp, lane j taking position
      // 32w + j, so a word's stores go to consecutive slots
      uint32_t live = __ballot_sync(kFull, mine != 0);
      int32_t woff = off;
      while (live) {
        const int j = __ffs(live) - 1;
        live &= live - 1;
        const uint32_t word = __shfl_sync(kFull, mine, j);
        if ((word >> lane) & 1u)
          pos[woff + __popc(word & below)] =
              static_cast<int32_t>((wb + k0 + j) * 32) + lane;
        woff += __popc(word);
      }
    }
    off += total;
  }
}

}  // namespace

// counts: int32[nblocks]; offsets: int32[nblocks + 1]; counters: int64[2]
// (survivors, dense blocks) added to, or null.
cudaError_t pfac::compact_scan_launch(const void* counts, int32_t nblocks,
                                      int32_t thresh, void* offsets,
                                      void* counters, Launch* l) {
  *l = Launch{};
  if (nblocks < 0) return cudaErrorInvalidValue;
  l->set(compact_scan_kernel, 1, kScanThreads, 0,
         static_cast<const int32_t*>(counts), nblocks, thresh,
         static_cast<int32_t*>(offsets),
         static_cast<unsigned long long*>(counters));
  return cudaSuccess;
}

// bits: int32[nblocks * block / 32]; counts: int32[nblocks]; offsets: the
// scan's; pos: int32[>= offsets[nblocks]]; block % 8192 == 0, else
// cudaErrorInvalidValue.
cudaError_t pfac::compact_launch(const void* bits, const void* counts,
                                 const void* offsets, int32_t nblocks,
                                 int32_t block, int32_t thresh, void* pos,
                                 Launch* l) {
  *l = Launch{};
  if (block <= 0 || block % kBlockGrain != 0 || nblocks < 0)
    return cudaErrorInvalidValue;
  if (nblocks == 0) return cudaSuccess;
  l->set(compact_kernel, static_cast<unsigned>(nblocks), kThreads, 0,
         static_cast<const uint32_t*>(bits),
         static_cast<const int32_t*>(counts),
         static_cast<const int32_t*>(offsets), block, thresh,
         static_cast<int32_t*>(pos));
  return cudaSuccess;
}

// As compact_scan_launch; launches on `stream`, returns the launch's
// cudaError_t.
extern "C" int pfac_compact_scan(int device, const void* counts,
                                 int32_t nblocks, int32_t thresh,
                                 void* offsets, void* counters,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::compact_scan_launch(counts, nblocks, thresh, offsets, counters,
                                  &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}

// As compact_launch; launches on `stream`, returns the launch's
// cudaError_t.
extern "C" int pfac_compact(int device, const void* bits, const void* counts,
                            const void* offsets, int32_t nblocks,
                            int32_t block, int32_t thresh, void* pos,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::compact_launch(bits, counts, offsets, nblocks, block, thresh,
                             pos, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
