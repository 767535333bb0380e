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
//   returns at once. Otherwise each warp takes a run of block / 256
//   consecutive bitmap words in rounds of up to 8 words a lane (a 64K
//   block's run is one round), lane l owning g consecutive words of the
//   round (8l to 8l + 7 at 64K). It reads the run once: at 64K two
//   16-byte loads a lane, the words kept in shared memory, one column a
//   lane, and counted; the CTA adds up the warp totals before each warp
//   (a run of more than one round reads its later rounds again to list
//   them). A warp scan of the lanes' bit counts gives each lane its first
//   slot, and each lane writes the positions of its own words' bits, in
//   order, into the warp's stage in shared memory: one scan a round, and
//   a loop that runs for the lane with the most bits (~12-25 at 4.7%
//   survivors, where the words one at a time took ~200 serial steps).
//   The stage gathers round after round and is written out when the next
//   one would not fit and at the run's end: its slots up to the first
//   128-byte line a word a lane, then 16 bytes a lane (whole lines a
//   store instruction), then the last 0-3 words. A round of more than
//   kRoundMax set bits (the stage's room: such rounds come with the
//   escape disarmed, as on the CSR tier) is listed word by word, 32 words a chunk, word k0 + lane in
//   lane `lane`: the warp takes a chunk's nonzero words one at a time,
//   lane j writing position 32w + j at the word's slot + __popc of its
//   bits below j, straight to consecutive slots. Given a program's
//   counter words, the CTA adds the nonempty chunks it listed so to
//   counters[0] (compact_wordwise_chunks), one atomic if any.
//   pos must start on a 128-byte line and bits on 16 bytes, as every
//   allocation and every part of a program's scratch does.
// Bound: device memory. The bitmap of the blocks with survivors (npad / 8
// bytes at most: 8 MiB at 64 MiB of input), the counts and 4 bytes per
// survivor; the scan reads nblocks counts. At the virus-dense cell's
// 3.17 M survivors in 64 MiB that is ~21 MB, 6.3 us at 3.35 TB/s; in a
// program on an H100 (700 W) compact_kernel takes 13.3 us there (47% of
// that bound; 83.4-84.0 us listing every chunk of more than 32 bits word
// by word), 16.7 us on 192 MiB of text with ~48 survivors a block (19.3
// us) and 159 us with every position of 100 MiB listed word by word (179
// us; staging those full words lane by lane took 476 us).
// Positions come out in ascending order by construction: blocks in order
// of b, words in order inside a block, bits in order inside a word.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kScanThreads = 1024;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockGrain = 32 * kThreads;   // block % kBlockGrain == 0
constexpr int kHeld = 8;       // words a lane keeps: a 64K block's run
constexpr int kStage = 512;    // slots a warp stages
constexpr int kRoundMax = kStage - 3;   // the most a round lists lane-wise
// shared memory: 8 warps x (256 words kept + 512 slots) x 4 B, 24 KB a
// CTA, so that 8 CTAs of 256 threads fit an SM

// Inclusive scan of x across the warp.
__device__ __forceinline__ int32_t warp_scan(int32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Writes the staged slots [lo, hi) to pos: the slots up to the first
// 128-byte line a word a lane, then 16 bytes a lane, then the last 0-3
// words. pos is 128-byte aligned, and slot g is staged at
// stage[g - (lo & ~3)].
__device__ __forceinline__ void flush(const int32_t* stage, int32_t lo,
                                      int32_t hi, int32_t* __restrict__ pos,
                                      int lane) {
  __syncwarp();
  const int32_t sbase = lo & ~3;
  const int32_t line = (lo + 31) & ~31;
  const int32_t a = line < hi ? line : hi;
  const int32_t e = (hi & ~3) > a ? hi & ~3 : a;
  if (lane < a - lo) pos[lo + lane] = stage[lo + lane - sbase];
#pragma unroll 1
  for (int32_t g = a / 4 + lane; g < e / 4; g += 32)
    reinterpret_cast<int4*>(pos)[g] =
        reinterpret_cast<const int4*>(stage)[g - sbase / 4];
  if (lane < hi - e) pos[e + lane] = stage[e + lane - sbase];
  __syncwarp();                              // before the stage is refilled
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

// Loads the lane's g consecutive words of a round (lane l: words first +
// l * g onward), keeps word j in col[j][lane] and returns their set bits.
// bits is 16-byte aligned, and so is a full round's run of 8 words a lane.
__device__ __forceinline__ int32_t load_round(
    const uint32_t* __restrict__ bits, int32_t first, int g,
    uint32_t (*col)[32], int lane) {
  const uint32_t* src = bits + first + lane * g;
  if (g == kHeld) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(src) + 1);
    col[0][lane] = x.x; col[1][lane] = x.y; col[2][lane] = x.z;
    col[3][lane] = x.w; col[4][lane] = y.x; col[5][lane] = y.y;
    col[6][lane] = y.z; col[7][lane] = y.w;
    return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w) +
           __popc(y.x) + __popc(y.y) + __popc(y.z) + __popc(y.w);
  }
  int32_t t = 0;
  for (int j = 0; j < g; ++j) {
    const uint32_t v = __ldg(src + j);
    col[j][lane] = v;
    t += __popc(v);
  }
  return t;
}

// 8 CTAs an SM, so 32 registers a thread: the loops below are kept rolled
// (#pragma unroll 1), since the compiler's unrolled copies spill past 32,
// and spills, which go to L2 behind ~197 KB of shared memory an SM, more
// than doubled the time on text.
__global__ void __launch_bounds__(kThreads, 8)
compact_kernel(const uint32_t* __restrict__ bits,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ offsets, int32_t block,
               int32_t thresh, int32_t* __restrict__ pos,
               unsigned long long* __restrict__ counters) {
  const int32_t b = blockIdx.x;
  const int32_t cnt = counts[b];
  if (cnt == 0 || cnt >= thresh) return;     // uniform across the CTA
  __shared__ int32_t warp_sum[kWarps];
  __shared__ int32_t wordwise;
  __shared__ uint32_t kept[kWarps][kHeld][32];
  __shared__ __align__(16) int32_t stages[kWarps][kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chunks = block / (32 * kThreads);   // 32-word chunks a warp
  const int32_t run = b * (block / 32) + warp * 32 * chunks;   // 1st word
  const int32_t base = offsets[b];
  uint32_t (*const col)[32] = kept[warp];       // a lane's own words
  int32_t t = load_round(bits, run, chunks < kHeld ? chunks : kHeld, col,
                         lane);
  int32_t c = t;
  for (int r = kHeld; r < chunks; r += kHeld) {   // listed from a 2nd read
    const int g = chunks - r < kHeld ? chunks - r : kHeld;
    const uint32_t* src = bits + run + 32 * r + lane * g;
    for (int j = 0; j < g; ++j) c += __popc(__ldg(src + j));
  }
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) warp_sum[warp] = c;
  if (threadIdx.x == 0) wordwise = 0;
  __syncthreads();
  if (c != 0) {
    int32_t off = base;                      // the same in every lane
    for (int k = 0; k < warp; ++k) off += warp_sum[k];
    int32_t* const stage = stages[warp];
    int32_t lo = off;                        // staged: slots [lo, off)
#pragma unroll 1
    for (int r = 0; r < chunks; r += kHeld) {
      const int g = chunks - r < kHeld ? chunks - r : kHeld;
      const int32_t first = run + 32 * r;    // the round's first word
      if (r != 0) {                          // lanes read each other's
        __syncwarp();                        // words chunk by chunk
        t = load_round(bits, first, g, col, lane);
        __syncwarp();
      }
      const int32_t incl = warp_scan(t, lane);
      const int32_t total = __shfl_sync(kFull, incl, 31);
      if (total <= kRoundMax) {
        // lane by lane: each lane its own words' bits, in order
        if (off + total - (lo & ~3) > kStage) {
          flush(stage, lo, off, pos, lane);
          lo = off;
        }
        int32_t s = off + incl - t - (lo & ~3);
        const int32_t p = (first + lane * g) * 32;
        int j = 0;
        uint32_t w = col[0][lane];
#pragma unroll 1
        for (int k = 0; k < t; ++k) {
          while (w == 0) w = col[++j][lane];
          stage[s++] = p + 32 * j + __ffs(w) - 1;
          w &= w - 1;
        }
        off += total;
        continue;
      }
      // word by word, chunk by chunk: word 32i + lane of the round in
      // lane `lane`, straight to consecutive slots
      flush(stage, lo, off, pos, lane);
#pragma unroll 1
      for (int i = 0; i < g; ++i) {
        const int k = 32 * i + lane;
        const uint32_t mine = col[k % g][k / g];
        uint32_t live = __ballot_sync(kFull, mine != 0);
        if (live == 0) continue;
        const int32_t p = (first + 32 * i) * 32 + lane;
#pragma unroll 1
        while (live) {
          const int j = __ffs(live) - 1;
          live &= live - 1;
          const uint32_t w = __shfl_sync(kFull, mine, j);
          if ((w >> lane) & 1u)
            pos[off + __popc(w & ((1u << lane) - 1u))] = p + 32 * j;
          off += __popc(w);
        }
        if (lane == 0) atomicAdd(&wordwise, 1);
      }
      lo = off;
    }
    flush(stage, lo, off, pos, lane);
  }
  __syncthreads();
  if (threadIdx.x == 0 && counters != nullptr && wordwise != 0)
    atomicAdd(counters, static_cast<unsigned long long>(wordwise));
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

// bits: int32[nblocks * block / 32], 16-byte aligned; counts:
// int32[nblocks]; offsets: the scan's; pos: int32[>= offsets[nblocks]],
// 128-byte aligned; block % 8192 == 0; else cudaErrorInvalidValue;
// counters: int64[1] (chunks listed word by word) added to, or null.
cudaError_t pfac::compact_launch(const void* bits, const void* counts,
                                 const void* offsets, int32_t nblocks,
                                 int32_t block, int32_t thresh, void* pos,
                                 void* counters, Launch* l) {
  *l = Launch{};
  if (block <= 0 || block % kBlockGrain != 0 || nblocks < 0 ||
      (reinterpret_cast<uintptr_t>(bits) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(pos) & 127) != 0)
    return cudaErrorInvalidValue;
  if (nblocks == 0) return cudaSuccess;
  l->set(compact_kernel, static_cast<unsigned>(nblocks), kThreads, 0,
         static_cast<const uint32_t*>(bits),
         static_cast<const int32_t*>(counts),
         static_cast<const int32_t*>(offsets), block, thresh,
         static_cast<int32_t*>(pos),
         static_cast<unsigned long long*>(counters));
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
                            void* counters, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::compact_launch(bits, counts, offsets, nblocks, block, thresh,
                             pos, counters, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
