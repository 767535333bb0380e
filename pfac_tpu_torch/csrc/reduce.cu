// Device reduce: a dense result to (ids, positions, count) on the device.
// Replaces pfac_tpu/backends/xla.py::_reduce_rowgather, the XLA function
// behind pfac_tpu/backends/pallas_sieve.py::reduce_from_dense (no Pallas
// kernel there). Contract: ids[i] = result[pos[i]] for the positions with
// result > 0, ascending, in slots [0, count); both outputs npad-long int32,
// zero in slots [count, npad); count a device int32.
//
// Bound: device memory. The result is read once (4 B a position) and both
// outputs are written in full (8 B a position): 12 B x npad, 0.481 ms at
// 128 Mi positions and 3.35 TB/s, whatever the count. Two launches; the
// result is read once and each output word written once:
// * reduce_kernel, one CTA per tile of kTile positions, writes slots
//   [0, count) and the count:
//   - the tile's index comes from an atomic ticket, so tiles start in
//     index order and a CTA never waits on a tile that has not been
//     scheduled; the last ticket resets the counter for the next call;
//   - eight data warps load the tile, a thread 32 positions by eight
//     16-byte loads in flight together, and keep it; the counts of a
//     thread's eight runs of 4 are packed in two 64-bit words (16 bits a
//     run), so one warp scan and one scan of the warp totals give every
//     position's rank in the tile;
//   - the tile's offset comes by decoupled look-back (Merrill and Garland,
//     "Single-pass Parallel Prefix Scan with Decoupled Look-back", 2016),
//     by a ninth warp that starts as soon as the tile is known, while the
//     data warps' loads are in flight: it reads the 32 tiles before at a
//     time, summing counts back to the first tile that has published its
//     inclusive prefix. A tile publishes its count, then its inclusive
//     prefix, in a 64-bit status word (the call's epoch, a flag and the
//     value in one store); a word of another epoch is a tile not yet
//     published, so the status words need no reset between calls;
//   - the matches go through shared memory, half a tile at a time (slot r
//     at r + r / 32: no bank conflict where a warp's runs are dense), and
//     leave as 16-byte stores of consecutive slots; the IDs are the values
//     already loaded. A tile where every position matches, at an offset
//     that is a multiple of 4, stores straight from registers;
// * reduce_tail_kernel, a grid-stride launch behind it, reads the count on
//   the device and writes the zeros of slots [count, npad) of both outputs.
// Stores start on a 128-byte line (word by word up to it), so a warp's 512
// bytes fill 4 whole lines. What the H100 showed (PERF.md): a CTA's tile
// waits on the ticket and on its predecessors, so reduce_kernel reads at
// 1.7-2.1 TB/s, faster with more bytes a CTA (4,096-position tiles read
// slower); the zeros alone write at 3.1-3.2 TB/s (2.3 from an unaligned
// start); writing them inside reduce_kernel (each tile those of its own
// non-matching positions, from the top) was slower than the second pass,
// and so were a persistent grid that loads its next tile during the
// look-back and stores from registers without the stage.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "launch.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kDataWarps = 8;                // warps that load and store
constexpr int kDataThreads = 32 * kDataWarps;
constexpr int kThreads = kDataThreads + 32;  // and one that looks back
constexpr int kRuns = 8;                     // 16-byte loads a thread
constexpr int kParts = kRuns / 4;            // runs 4p..4p+3: part p
constexpr int kPart = kDataThreads * 4 * 4;  // positions of a part
constexpr int kTile = kParts * kPart;        // 8,192 positions a tile
constexpr int kStage = kPart + kPart / 32;   // staged slots, padded
constexpr int kMinCtas = 65536 / (kThreads * 56);
constexpr int kTailThreads = 256;
constexpr uint64_t kInclusive = 1ull << 31;  // status: epoch | flag | value
constexpr unsigned kMaxBackoff = 512;        // ns between polls, at most

__device__ __forceinline__ uint64_t load_status(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Run k's field of the packed counts (part p's runs in word p).
__device__ __forceinline__ int32_t field(const uint64_t (&x)[kParts], int k) {
  return static_cast<int32_t>((x[k >> 2] >> (16 * (k & 3))) & 0xFFFFu);
}

__device__ __forceinline__ int stage_slot(int32_t r) { return r + (r >> 5); }

// The sum of the counts of the tiles before `tile`, by warp 0 (every lane
// gets it). A status word is this call's when its high half is `epoch`.
__device__ int32_t look_back(const uint64_t* status, int32_t tile,
                             uint32_t epoch, int lane) {
  const uint64_t zero = static_cast<uint64_t>(epoch) << 32 | kInclusive;
  int32_t excl = 0;
  for (int32_t end = tile;; end -= 32) {
    const int32_t p = end - 1 - lane;        // lane 0: the nearest tile
    uint64_t s;
    // a tile not yet published: wait, backing off, so that the polls of
    // many CTAs do not crowd the L2 slices that hold the status words
    for (unsigned ns = 32;; ns = ns < kMaxBackoff ? 2 * ns : ns) {
      s = p >= 0 ? load_status(status + p) : zero;
      if (__all_sync(kFull, (s >> 32) == epoch)) break;
      __nanosleep(ns);
    }
    const uint32_t done = __ballot_sync(kFull, (s & kInclusive) != 0);
    const int stop = done ? __ffs(done) - 1 : 31;
    int32_t v = lane <= stop ? static_cast<int32_t>(s & 0x7FFFFFFFu) : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(kFull, v, d);
    excl += v;
    if (done) return excl;
  }
}

// Slots [lo, hi) of ids and pos from get(slot) -> (id, position): word by
// word up to the first 128-byte line and past the last 16-byte group, by
// int4 groups between; thread `tid` of `stride` takes its share.
template <typename Get>
__device__ __forceinline__ void store_slots(int32_t* __restrict__ ids,
                                            int32_t* __restrict__ pos,
                                            int64_t lo, int64_t hi,
                                            int64_t tid, int64_t stride,
                                            Get get) {
  const int64_t line = (lo + 31) & ~31LL;
  const int64_t a = line < hi ? line : hi;
  const int64_t b = (hi & ~3LL) > a ? hi & ~3LL : a;
  if (tid < a - lo) {
    const int2 w = get(lo + tid);
    ids[lo + tid] = w.x;
    pos[lo + tid] = w.y;
  }
  for (int64_t g = a / 4 + tid; g < b / 4; g += stride) {
    const int2 w0 = get(4 * g), w1 = get(4 * g + 1), w2 = get(4 * g + 2),
               w3 = get(4 * g + 3);
    *reinterpret_cast<int4*>(ids + 4 * g) = make_int4(w0.x, w1.x, w2.x, w3.x);
    *reinterpret_cast<int4*>(pos + 4 * g) = make_int4(w0.y, w1.y, w2.y, w3.y);
  }
  if (tid < hi - b) {
    const int2 w = get(b + tid);
    ids[b + tid] = w.x;
    pos[b + tid] = w.y;
  }
}

// The data warps' barrier (the look-back warp does not take part).
__device__ __forceinline__ void data_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(kDataThreads) : "memory");
}

// kVec: the result is 16-byte aligned and read by int4 loads; else by
// words (a view into a larger result).
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinCtas)
reduce_kernel(const int32_t* __restrict__ result, int32_t npad,
              int32_t* __restrict__ ids, int32_t* __restrict__ pos,
              int32_t* __restrict__ count, uint64_t* __restrict__ status,
              int32_t ntiles, uint32_t epoch) {
  __shared__ int32_t s_pos[kStage], s_ids[kStage];
  __shared__ uint64_t s_warp[kParts][kDataWarps];
  __shared__ int32_t s_tile, s_excl;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // status[0] holds the ticket, status[1 + t] tile t's status word
  auto* ticket = reinterpret_cast<unsigned int*>(status);
  if (tid == 0) {
    s_tile = static_cast<int32_t>(atomicAdd(ticket, 1u));
    if (s_tile == ntiles - 1) *ticket = 0;   // the last ticket: reset
  }
  __syncthreads();
  const int32_t tile = s_tile;
  uint64_t* st = status + 1;
  const uint64_t mark = static_cast<uint64_t>(epoch) << 32;
  if (warp == kDataWarps) {
    // the look-back warp: the offset needs only the tiles before, so it
    // is found while the data warps' loads are in flight
    const int32_t excl = tile == 0 ? 0 : look_back(st, tile, epoch, lane);
    if (lane == 0) s_excl = excl;
    __syncthreads();
    return;
  }
  const int64_t base = static_cast<int64_t>(tile) * kTile;
  int32_t v[kRuns * 4];       // run k: positions 4 (k kDataThreads + tid)
#pragma unroll
  for (int k = 0; k < kRuns; ++k) {
    const int64_t e =
        base + 4 * (static_cast<int64_t>(k) * kDataThreads + tid);
    if (kVec && e + 4 <= npad) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(result + e));
      v[4 * k] = q.x; v[4 * k + 1] = q.y; v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * k + j] = e + j < npad ? __ldcs(result + e + j) : 0;
    }
  }
  // each run's count in a 16-bit field: one scan ranks all the runs
  uint64_t mine[kParts] = {}, x[kParts];
#pragma unroll
  for (int k = 0; k < kRuns; ++k)
    mine[k >> 2] |= static_cast<uint64_t>(
                        (v[4 * k] > 0) + (v[4 * k + 1] > 0) +
                        (v[4 * k + 2] > 0) + (v[4 * k + 3] > 0))
                    << (16 * (k & 3));
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
    x[h] = mine[h];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, x[h], d);
      if (lane >= d) x[h] += y;
    }
    if (lane == 31) s_warp[h][warp] = x[h];
  }
  data_sync();
  if (warp < kParts) {                       // warp h scans word h
    uint64_t w = lane < kDataWarps ? s_warp[warp][lane] : 0;
#pragma unroll
    for (int d = 1; d < kDataWarps; d <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kDataWarps) s_warp[warp][lane] = w;
  }
  data_sync();
  uint64_t total[kParts], before[kParts];
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
    total[h] = s_warp[h][kDataWarps - 1];
    before[h] = x[h] - mine[h] + (warp ? s_warp[h][warp - 1] : 0);
  }
  int32_t c = 0;
#pragma unroll
  for (int k = 0; k < kRuns; ++k) c += field(total, k);
  if (tid == 0 && tile > 0)
    store_status(st + tile, mark | static_cast<uint64_t>(c));
  __syncthreads();                           // the offset is in
  const int32_t excl = s_excl;
  if (tid == 0) {
    store_status(st + tile,
                 mark | kInclusive | static_cast<uint64_t>(excl + c));
    if (tile == ntiles - 1) *count = excl + c;
  }
  if (c == kTile && (excl & 3) == 0) {
    // every position matches: slot excl + (position - base), aligned
#pragma unroll
    for (int k = 0; k < kRuns; ++k) {
      const int32_t r = 4 * (k * kDataThreads + tid);
      const int32_t p = static_cast<int32_t>(base) + r;
      *reinterpret_cast<int4*>(ids + excl + r) =
          make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      *reinterpret_cast<int4*>(pos + excl + r) =
          make_int4(p, p + 1, p + 2, p + 3);
    }
    return;
  }
  // the parts of the tile in turn through the stage
  int32_t lo = excl;
#pragma unroll
  for (int h = 0; h < kParts; ++h) {
    int32_t n = 0;                           // matches of this part
#pragma unroll
    for (int k = 4 * h; k < 4 * h + 4; ++k) n += field(total, k);
    if (n == 0) continue;                    // uniform across the CTA
    if (h > 0) data_sync();                  // the stage's last reads done
    int32_t run_base = 0;                    // its matches before run k
#pragma unroll
    for (int k = 4 * h; k < 4 * h + 4; ++k) {
      int32_t r = run_base + field(before, k);
      const int32_t p =
          static_cast<int32_t>(base) + 4 * (k * kDataThreads + tid);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v[4 * k + j] > 0) {
          s_pos[stage_slot(r)] = p + j;
          s_ids[stage_slot(r)] = v[4 * k + j];
          ++r;
        }
      }
      run_base += field(total, k);
    }
    data_sync();
    store_slots(ids, pos, lo, lo + n, tid, kDataThreads, [&](int64_t q) {
      const int slot = stage_slot(static_cast<int32_t>(q - lo));
      return make_int2(s_ids[slot], s_pos[slot]);
    });
    lo += n;
  }
}

__global__ void __launch_bounds__(kTailThreads)
reduce_tail_kernel(const int32_t* __restrict__ count, int32_t npad,
                   int32_t* __restrict__ ids, int32_t* __restrict__ pos) {
  store_slots(ids, pos, *count, npad,
              static_cast<int64_t>(blockIdx.x) * kTailThreads + threadIdx.x,
              static_cast<int64_t>(gridDim.x) * kTailThreads,
              [](int64_t) { return make_int2(0, 0); });
}

int sm_count(int device) {
  constexpr int kDevices = 64;
  static int sms[kDevices];
  static std::mutex mu;
  if (device < 0 || device >= kDevices) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 0;
  return sms[device];
}

}  // namespace

// result: int32[npad], 0 < npad < 2^31; ids, pos: int32[npad], 16-byte
// aligned; count: int32[1]; status: uint64[nstatus], nstatus >=
// ceil(npad / 8192) + 1 (backends/reduce.py::TILE), its first word 0 and
// no word of the epoch `epoch` (> 0): a new epoch for each call on the
// buffer, and zeros before the epochs wrap. reduce_kernel into `body`,
// reduce_tail_kernel (behind it) into `tail`; cudaErrorInvalidValue on bad
// arguments.
cudaError_t pfac::reduce_launch(int device, const void* result, int32_t npad,
                                void* ids, void* pos, void* count,
                                void* status, int64_t nstatus, uint32_t epoch,
                                Launch* body, Launch* tail) {
  *body = Launch{};
  *tail = Launch{};
  const int32_t ntiles = (npad + (kTile - 1)) / kTile;
  if (npad <= 0 || nstatus < ntiles + 1 || epoch == 0 ||
      reinterpret_cast<uintptr_t>(ids) % 16 ||
      reinterpret_cast<uintptr_t>(pos) % 16)
    return cudaErrorInvalidValue;
  const int sms = sm_count(device);
  if (sms == 0) return cudaErrorInvalidDevice;
  const auto* r = static_cast<const int32_t*>(result);
  auto* i = static_cast<int32_t*>(ids);
  auto* p = static_cast<int32_t*>(pos);
  auto* c = static_cast<int32_t*>(count);
  auto* st = static_cast<uint64_t*>(status);
  const auto g = static_cast<unsigned>(ntiles);
  if (reinterpret_cast<uintptr_t>(result) % 16 == 0)
    body->set(reduce_kernel<true>, g, kThreads, 0, r, npad, i, p, c, st,
              ntiles, epoch);
  else
    body->set(reduce_kernel<false>, g, kThreads, 0, r, npad, i, p, c, st,
              ntiles, epoch);
  // a wave of 8 CTAs an SM, fewer for a short result
  const int64_t want = (static_cast<int64_t>(npad) / 4 + kTailThreads - 1) /
                       kTailThreads;
  const int64_t grid = want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms;
  tail->set(reduce_tail_kernel, static_cast<unsigned>(grid), kTailThreads, 0,
            c, npad, i, p);
  return cudaSuccess;
}

// As reduce_launch; launches both kernels on `stream` and returns the
// first launch error.
extern "C" int pfac_reduce(int device, const void* result, int32_t npad,
                           void* ids, void* pos, void* count, void* status,
                           int64_t nstatus, uint32_t epoch, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch body, tail;
  err = pfac::reduce_launch(device, result, npad, ids, pos, count, status,
                            nstatus, epoch, &body, &tail);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = body.launch(s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tail.launch(s));
}
