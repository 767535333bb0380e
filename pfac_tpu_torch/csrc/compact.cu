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
//   than thresh survivors), so the host never waits for the count;
// * compact_kernel (one CTA per block): a block that is empty or dense
//   returns at once; otherwise each warp takes a run of block / 256
//   consecutive bitmap words and counts them, the CTA adds up the warp
//   totals before it, and the warp lists its positions 32 words at a time,
//   a word a lane, with a warp scan of the words' popcounts: where the 32
//   words hold at most 32 set bits each lane writes its own word's
//   positions; where they hold more, the warp takes the words one by one,
//   lane j writing position 32w + j at the word's slot + __popc of its bits
//   below j (the reduce's instance loads 8 words' IDs at a time). Either
//   way a store instruction of the warp falls on consecutive slots, so
//   dense blocks write whole lines (a thread walking dense words of its
//   own would write 32 lines a store).
// Bound: device memory. The bitmap of the blocks with survivors (npad / 8
// bytes at most, 16 MiB at 128 MiB of input, 5 us at 3.35 TB/s), the
// counts and 4 bytes per survivor; the scan reads nblocks counts. Positions
// come out in ascending order by construction: blocks in order of b, words
// in order inside a block, bits in order inside a word.
//
// The device reduce (backends/reduce.py; it replaces the reference's
// pfac_tpu/backends/xla.py::_reduce_rowgather, the XLA tail of
// pallas_sieve.reduce_from_dense) runs the same two kernels after a third:
// * reduce_flags_kernel (one CTA of 1,024 threads per block of positions):
//   the bitmap of result > 0 and each block's count, so the compaction
//   lists every matching position. Each warp takes a run of block / 1,024
//   words: a lane loads one position of a word (eight words' loads in
//   flight), __ballot_sync makes the word and lane w % 32 keeps word w, so
//   the warp stores 32 words as one 128-byte row; __popc, a shared-memory
//   sum over the warps and one store give the block's count. Every word
//   and count is written, so nothing needs zeroing, and no atomic is used.
//   Positions past npad read as 0 (the last block may be cut). Bound:
//   device memory, 4 bytes in and 1/8 byte out a position;
// * compact_kernel, given the result, also gathers ids[i] = result[pos[i]]
//   as it writes pos[i]: the reduce's one gather, fused.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kBlockGrain = 32 * kThreads;   // block % kBlockGrain == 0
constexpr int kSparseChunk = 32;   // set bits in 32 words listed lane-wise
constexpr int kGatherGroup = 8;    // words whose IDs the reduce loads at once
constexpr int kFlagThreads = 1024;
constexpr int kFlagUnroll = 8;               // words' loads in flight a warp
constexpr int kFlagGrain = 32 * 32 * kFlagThreads / 32;  // 32 words a warp

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

__global__ void __launch_bounds__(kFlagThreads)
reduce_flags_kernel(const int32_t* __restrict__ result, int64_t npad,
                    int32_t block, uint32_t* __restrict__ bits,
                    int32_t* __restrict__ counts) {
  __shared__ int32_t warp_count[kFlagThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = block / (32 * (kFlagThreads / 32));   // words
  const int64_t w0 = static_cast<int64_t>(blockIdx.x) * (block / 32) +
                     static_cast<int64_t>(warp) * per_warp;
  int32_t c = 0;
  uint32_t mine = 0;                         // word w0 + 32r + lane
  for (int k = 0; k < per_warp; k += kFlagUnroll) {
    int32_t v[kFlagUnroll];
#pragma unroll
    for (int u = 0; u < kFlagUnroll; ++u) {
      const int64_t p = (w0 + k + u) * 32 + lane;
      v[u] = p < npad ? __ldg(result + p) : 0;
    }
#pragma unroll
    for (int u = 0; u < kFlagUnroll; ++u) {
      const uint32_t b = __ballot_sync(kFull, v[u] > 0);
      c += __popc(b);
      if (lane == ((k + u) & 31)) mine = b;
    }
    if (((k + kFlagUnroll) & 31) == 0)       // 32 words gathered
      bits[w0 + k + kFlagUnroll - 32 + lane] = mine;
  }
  if (lane == 0) warp_count[warp] = c;
  __syncthreads();
  if (warp == 0) {
    int32_t x = warp_count[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
    if (lane == 0) counts[blockIdx.x] = x;
  }
}

// kGather: the reduce's instance, which also writes ids[i] = values[pos[i]]
// (the main path's instance keeps no registers for it)
template <bool kGather>
__global__ void __launch_bounds__(kThreads)
compact_kernel(const uint32_t* __restrict__ bits,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ offsets, int32_t block,
               int32_t thresh, int32_t* __restrict__ pos,
               const int32_t* __restrict__ values,
               int32_t* __restrict__ ids) {
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
        if constexpr (kGather) ids[slot] = __ldg(values + q);
        ++slot;
        mine &= mine - 1;
      }
    } else if constexpr (!kGather) {
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
    } else {
      // the same, eight words at a time, their IDs all loaded before the
      // first store: a warp issues in order, so a load before each store
      // would wait for device memory once a word (eight words keep the
      // instance at a main-path-like register count and occupancy)
      const int32_t p0 = static_cast<int32_t>((wb + k0) * 32) + lane;
      int32_t woff = off;
      for (int j0 = 0; j0 < 32; j0 += kGatherGroup) {
        uint32_t word[kGatherGroup];
        int32_t val[kGatherGroup];
#pragma unroll
        for (int j = 0; j < kGatherGroup; ++j) {
          word[j] = __shfl_sync(kFull, mine, j0 + j);
          val[j] = ((word[j] >> lane) & 1u)
                       ? __ldg(values + p0 + 32 * (j0 + j)) : 0;
        }
#pragma unroll
        for (int j = 0; j < kGatherGroup; ++j) {
          if ((word[j] >> lane) & 1u) {
            const int32_t slot = woff + __popc(word[j] & below);
            pos[slot] = p0 + 32 * (j0 + j);
            ids[slot] = val[j];
          }
          woff += __popc(word[j]);
        }
      }
    }
    off += total;
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
// scan's; pos: int32[>= offsets[nblocks]]; block % 8192 == 0, else
// cudaErrorInvalidValue. values (int32, indexed by position) and ids
// (int32[>= offsets[nblocks]]) may both be null; if not, ids[i] =
// values[pos[i]]. Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_compact(int device, const void* bits, const void* counts,
                            const void* offsets, int32_t nblocks,
                            int32_t block, int32_t thresh, void* pos,
                            const void* values, void* ids, void* stream) {
  if (block <= 0 || block % kBlockGrain != 0 || nblocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks == 0) return 0;
  if ((values == nullptr) != (ids == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* bw = static_cast<const uint32_t*>(bits);
  const auto* cn = static_cast<const int32_t*>(counts);
  const auto* of = static_cast<const int32_t*>(offsets);
  auto* ps = static_cast<int32_t*>(pos);
  const auto* vs = static_cast<const int32_t*>(values);
  auto* is = static_cast<int32_t*>(ids);
  if (values != nullptr)
    compact_kernel<true><<<static_cast<unsigned>(nblocks), kThreads, 0, st>>>(
        bw, cn, of, block, thresh, ps, vs, is);
  else
    compact_kernel<false><<<static_cast<unsigned>(nblocks), kThreads, 0,
                            st>>>(bw, cn, of, block, thresh, ps, vs, is);
  return static_cast<int>(cudaGetLastError());
}

// result: int32[npad]; bits: int32[nblocks * block / 32]; counts:
// int32[nblocks], nblocks = ceil(npad / block); block % 32768 == 0, else
// cudaErrorInvalidValue. Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_reduce_flags(int device, const void* result, int64_t npad,
                                 int32_t block, int32_t nblocks, void* bits,
                                 void* counts, void* stream) {
  if (block <= 0 || block % kFlagGrain != 0 || nblocks < 0 ||
      static_cast<int64_t>(nblocks) * block < npad)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks == 0) return 0;
  reduce_flags_kernel<<<static_cast<unsigned>(nblocks), kFlagThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(result), npad, block,
      static_cast<uint32_t*>(bits), static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
