// Kernel K1, the sieve: replaces pfac_tpu/backends/pallas_sieve.py::_make_kernel.
//
// For every position pos < npad it writes match[pos], the exact ID of the
// longest pattern of length 1..3 starting at pos (0 at and past n), and bit
// pos % 32 of bits[pos / 32] where a pattern of >= 4 bytes may start: the
// resid16 alive filter passes the little-endian key k4 = c3<<24|c2<<16|c1<<8|c0
// and n - pos > 3. Probes, all on k4:
//   m1: arena[c0]                         (a 256-entry table at offset 0)
//   m2: exact on k4 & 0xFFFF,   hit needs n - pos > 1   (descriptor row 0)
//   m3: exact on k4 & 0xFFFFFF, hit needs n - pos > 2   (descriptor row 1)
//   alive: resid16(slot(k4)) == (k4 * 0xC2B2AE35) >> 16 (descriptor row 2);
//          the residuals are packed two per word, slot s in the low (s even)
//          or high (s odd) half of word s / 2 (the reference's layout)
// Bytes at or past n read as 0 and never decide a hit (the masks above). It
// also adds the survivors of each `block`-position block into counts[pos /
// block] (zeroed by the caller), the input of the dense-block escape (K3)
// and of the compaction (compact.cu).
//
// Bound: device memory. Per position it reads 1 byte and writes 4 bytes of
// match and 1 bit: 656 MiB at 128 MiB of input, 0.205 ms at 3.35 TB/s. The
// other cost is table loads, 3-7 per position (7 for a Snort-scale set):
// random words, which L1 serves at a few per clock per SM. Design:
// * a persistent grid, as many CTAs as the SMs hold, each taking tiles of
//   kThreads * 16 positions from an atomic counter until none is left, so
//   the tables are staged once per CTA and the tail balances;
// * tables placed by size, one kernel each (the wrapper picks; a launch
//   that does not fit fails, nothing falls back):
//   - sieve_smem_kernel: the whole arena in the CTA's shared memory (the
//     TPU kernel keeps its tables in VMEM the same way);
//   - sieve_cluster_kernel: a 2-CTA cluster; each CTA holds every table but
//     the residuals, and half of the residuals, and reads the other half
//     from its partner's shared memory (distributed shared memory);
//   - sieve_global_kernel: tables read through L1/L2 (__ldg);
// * each thread takes 16 consecutive positions from one 16-byte load; the 3
//   lookahead bytes come from lane + 1 (__shfl_down_sync), lane 31 loads
//   them itself, so each input byte is read once;
// * probes go 8 positions at a time, stage by stage (m1, m2, m3, alive),
//   every load of a stage issued before its results are used, so each
//   thread keeps 8 independent table loads in flight (a load from the
//   partner CTA or from L2 takes hundreds of cycles; 16 in flight gained
//   nothing on the cluster kernel, PERF.md §6);
// * matches are staged per warp in shared memory (an XOR swizzle keeps both
//   the row writes and the column reads free of bank conflicts) and leave
//   as fully coalesced 128-byte warp stores;
// * lane pairs join their 16 flag bits into one bitmap word: npad / 8 bytes
//   of bitmap in place of npad bytes of flags; counts take one warp
//   reduction and at most one atomicAdd per warp;
// * the grid size (an occupancy query) is cached per placement on the
//   host, so a launch costs no more host time than a plain one.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kMixResid = 0xC2B2AE35u;   // chd.MIX_RESID
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kPer = 16;                      // positions per thread
constexpr int kBatch = 8;                     // positions probed together
constexpr int kWarpPos = 32 * kPer;           // positions per warp and tile
constexpr int kThreads = 256;                 // smem and global placements
constexpr int kClusterThreads = 512;          // one 2-CTA cluster per 2 SMs

enum Placement : int32_t { kSmem = 0, kCluster = 1, kGlobal = 2 };

// Tables staged whole in this CTA's shared memory.
struct SmemTab {
  const uint32_t* w;
  const uint32_t* res;
  __device__ __forceinline__ uint32_t operator[](int64_t i) const {
    return w[i];
  }
  __device__ __forceinline__ uint32_t resid_word(uint32_t j) const {
    return res[j];
  }
};

// Every table but the residuals in this CTA's shared memory; residual
// words [0, half) in rank 0's, [half, 2 * half) in rank 1's.
struct ClusterTab {
  const uint32_t* w;
  const uint32_t* h0;
  const uint32_t* h1;
  uint32_t half;
  __device__ __forceinline__ uint32_t operator[](int64_t i) const {
    return w[i];
  }
  __device__ __forceinline__ uint32_t resid_word(uint32_t j) const {
    return *(j < half ? h0 + j : h1 + (j - half));
  }
};

// Tables read through L1 and L2.
struct GlobalTab {
  const int32_t* __restrict__ a;
  const int32_t* __restrict__ res;
  __device__ __forceinline__ uint32_t operator[](int64_t i) const {
    return static_cast<uint32_t>(__ldg(a + i));
  }
  __device__ __forceinline__ uint32_t resid_word(uint32_t j) const {
    return static_cast<uint32_t>(__ldg(res + j));
  }
};

struct Probes {
  pfac::Probe m2, m3, al;
};

// Little-endian word of bytes b..b+3 (b % 4 == 0); bytes >= n read as 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ data,
                                              int64_t n, int64_t b) {
  if (b + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(data + b));
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k)
    if (b + k < n) w |= static_cast<uint32_t>(data[b + k]) << (8 * k);
  return w;
}

// Copy words [src, src + count) of the arena into shared memory at dst.
__device__ __forceinline__ void stage(uint32_t* dst,
                                      const int32_t* __restrict__ src,
                                      int32_t count) {
  for (int32_t i = threadIdx.x; i < count; i += blockDim.x)
    dst[i] = static_cast<uint32_t>(__ldg(src + i));
}

// Slots of kBatch keys (masked) in one probe table. Each stage issues all
// kBatch independent loads before it uses one, so a thread keeps kBatch
// probes in flight: the latency of shared memory, of the partner CTA's
// shared memory or of L2 overlaps. The branch on the table's kind is
// uniform and taken once per stage; inside it probe_slot's own test folds.
template <class Tab>
__device__ __forceinline__ void slot_stage(const Tab& t, const pfac::Probe& p,
                                           const uint32_t (&key)[kBatch],
                                           uint32_t mask,
                                           uint32_t (&sl)[kBatch]) {
  if (p.disp_off < 0) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      sl[j] = pfac::probe_slot(t, p, key[j] & mask);
  } else {
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      sl[j] = pfac::probe_slot(t, p, key[j] & mask);
  }
}

// An exact probe of kBatch keys: m[j] takes the value where the key hits
// and rd0 - j > 0 (the pattern fits before n).
template <class Tab>
__device__ __forceinline__ void exact_stage(const Tab& t, const pfac::Probe& p,
                                            const uint32_t (&key)[kBatch],
                                            uint32_t mask, int32_t rd0,
                                            uint32_t (&m)[kBatch]) {
  if (!p.present) return;
  uint32_t sl[kBatch];
  slot_stage(t, p, key, mask, sl);
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const uint32_t v = t[p.val_off + sl[j]];
    if (t[p.key_off + sl[j]] == (key[j] & mask) && rd0 - j > 0) m[j] = v;
  }
}

// One warp's 512 positions starting at wpos (wpos < npad, wpos % 512 == 0):
// match words through the warp's staging buffer, bitmap words and count.
template <class Tab>
__device__ __forceinline__ void sieve_warp(
    const Tab& t, const Probes& pr, const uint8_t* __restrict__ data,
    int32_t n, int64_t wpos, uint32_t* stage_buf, int32_t* __restrict__ match,
    uint32_t* __restrict__ bits, int32_t* __restrict__ counts, int32_t block) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 = wpos + kPer * lane;
  uint32_t w[5];
  if (p0 + kPer <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(data + p0));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = load_word(data, n, p0 + 4 * k);
  }
  w[4] = __shfl_down_sync(kFull, w[0], 1);
  if (lane == 31) w[4] = load_word(data, n, p0 + kPer);

  const int32_t rd0 = static_cast<int32_t>(n - p0);   // may be <= 0
  const int swz = (lane >> 1) & 15;
  uint32_t fl = 0;
#pragma unroll
  for (int j0 = 0; j0 < kPer; j0 += kBatch) {
    uint32_t key[kBatch], m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = (j0 + j) >> 2, r = (j0 + j) & 3;
      key[j] = r == 0 ? w[q] : __funnelshift_r(w[q], w[q + 1], 8 * r);
      m[j] = t[key[j] & 0xFFu];
    }
    exact_stage(t, pr.m2, key, 0xFFFFu, rd0 - j0 - 1, m);
    exact_stage(t, pr.m3, key, 0xFFFFFFu, rd0 - j0 - 2, m);
    if (pr.al.present) {
      uint32_t sl[kBatch];
      slot_stage(t, pr.al, key, 0xFFFFFFFFu, sl);
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const uint32_t r16 =
            (t.resid_word(sl[j] >> 1) >> (16 * (sl[j] & 1))) & 0xFFFFu;
        if (r16 == (key[j] * kMixResid) >> 16 && rd0 - j0 - j > 3)
          fl |= 1u << (j0 + j);
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)   // row `lane`, column (j0 + j) ^ swz:
      stage_buf[lane * kPer + ((j0 + j) ^ swz)] =   // the 32 lanes, 32 banks
          rd0 - j0 - j > 0 ? m[j] : 0u;
  }

  // bitmap word (wpos + 32 i) / 32: lane 2i's bits low, lane 2i+1's high
  const uint32_t hi = __shfl_down_sync(kFull, fl, 1);
  if ((lane & 1) == 0)
    bits[wpos / 32 + lane / 2] = fl | (hi << 16);
  const uint32_t c = __reduce_add_sync(kFull, __popc(fl));
  if (lane == 0 && c != 0)                  // a warp lies in one block
    atomicAdd(counts + wpos / block, static_cast<int32_t>(c));

  __syncwarp();
  // word k * 32 + lane of the warp's 512 is row 2k + lane / 16, column
  // lane % 16, stored at column (lane % 16) ^ k: again 32 distinct banks
  int32_t* dst = match + wpos;
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    dst[k * 32 + lane] = static_cast<int32_t>(
        stage_buf[(2 * k + (lane >> 4)) * kPer + ((lane & 15) ^ k)]);
}

// The persistent loop: tiles of blockDim.x * 16 positions from *tile_ctr.
template <class Tab>
__device__ __forceinline__ void sieve_tiles(
    const Tab& t, const Probes& pr, const uint8_t* __restrict__ data,
    int32_t n, int32_t npad, uint32_t* stage_bufs, int32_t* __restrict__ match,
    uint32_t* __restrict__ bits, int32_t* __restrict__ counts, int32_t block,
    int32_t* __restrict__ tile_ctr) {
  __shared__ int32_t s_tile[2];
  const int warp = threadIdx.x >> 5;
  const int64_t tile_pos = static_cast<int64_t>(blockDim.x) * kPer;
  const int64_t ntiles = (npad + tile_pos - 1) / tile_pos;
  uint32_t* buf = stage_bufs + warp * kWarpPos;
  for (int it = 0;; ++it) {
    // double-buffered: the barrier below also orders the previous tile's
    // reads of s_tile and of every staging buffer before their reuse
    if (threadIdx.x == 0) s_tile[it & 1] = atomicAdd(tile_ctr, 1);
    __syncthreads();
    const int64_t tile = s_tile[it & 1];
    if (tile >= ntiles) break;
    const int64_t wpos = tile * tile_pos + static_cast<int64_t>(warp) * kWarpPos;
    if (wpos < npad)                         // npad % 512 == 0: warp-uniform
      sieve_warp(t, pr, data, n, wpos, buf, match, bits, counts, block);
  }
}

__device__ __forceinline__ Probes load_probes(const int32_t* __restrict__ desc) {
  return Probes{pfac::load_probe(desc, 0), pfac::load_probe(desc, 1),
                pfac::load_probe(desc, 2)};
}

// Shared memory: [warps * 512 staging words][tables].
__global__ void __launch_bounds__(kThreads)
sieve_smem_kernel(const uint8_t* __restrict__ data, int32_t n, int32_t npad,
                  const int32_t* __restrict__ arena, int32_t words,
                  int32_t res_off, const int32_t* __restrict__ desc,
                  int32_t* __restrict__ match,
                  uint32_t* __restrict__ bits, int32_t* __restrict__ counts,
                  int32_t block, int32_t* __restrict__ tile_ctr) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem + (kThreads / 32) * kWarpPos;
  stage(tab, arena, words);
  const Probes pr = load_probes(desc);
  const SmemTab t{tab, tab + res_off};
  __syncthreads();
  sieve_tiles(t, pr, data, n, npad, smem, match, bits, counts, block,
              tile_ctr);
}

// Shared memory: [warps * 512 staging words][arena words [0, res_off)]
// [residual words [rank * half, rank * half + half)]. The residual array
// is the arena's last (res_off + res_words == words).
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kClusterThreads)
sieve_cluster_kernel(const uint8_t* __restrict__ data, int32_t n, int32_t npad,
                     const int32_t* __restrict__ arena, int32_t words,
                     int32_t res_off, const int32_t* __restrict__ desc,
                     int32_t* __restrict__ match, uint32_t* __restrict__ bits,
                     int32_t* __restrict__ counts, int32_t block,
                     int32_t* __restrict__ tile_ctr) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t* tab = smem + (kClusterThreads / 32) * kWarpPos;
  const Probes pr = load_probes(desc);
  const int32_t half = (words - res_off + 1) / 2;
  const int32_t rank = static_cast<int32_t>(cluster.block_rank());
  const int32_t lo = res_off + rank * half;
  const int32_t hi = lo + half < words ? lo + half : words;
  stage(tab, arena, res_off);
  stage(tab + res_off, arena + lo, hi - lo);
  cluster.sync();              // both halves staged before any remote read
  const ClusterTab t{tab, cluster.map_shared_rank(tab + res_off, 0),
                     cluster.map_shared_rank(tab + res_off, 1),
                     static_cast<uint32_t>(half)};
  sieve_tiles(t, pr, data, n, npad, smem, match, bits, counts, block,
              tile_ctr);
  cluster.sync();              // the partner may still read this CTA's half
}

__global__ void __launch_bounds__(kThreads)
sieve_global_kernel(const uint8_t* __restrict__ data, int32_t n, int32_t npad,
                    const int32_t* __restrict__ arena, int32_t words,
                    int32_t res_off, const int32_t* __restrict__ desc,
                    int32_t* __restrict__ match, uint32_t* __restrict__ bits,
                    int32_t* __restrict__ counts, int32_t block,
                    int32_t* __restrict__ tile_ctr) {
  extern __shared__ __align__(16) uint32_t smem[];
  const Probes pr = load_probes(desc);
  const GlobalTab t{arena, arena + res_off};
  sieve_tiles(t, pr, data, n, npad, smem, match, bits, counts, block,
              tile_ctr);
}

// Dynamic shared memory the placement needs for this arena, in bytes
// (words: the arena's; res_off: the alive residuals' offset, the last
// array); backends/sieve.py::smem_bytes repeats it to pick the placement.
int64_t smem_bytes(int32_t placement, int32_t words, int32_t res_off) {
  switch (placement) {
    case kSmem:
      return 4LL * ((kThreads / 32) * kWarpPos + words);
    case kCluster:
      return 4LL * ((kClusterThreads / 32) * kWarpPos + res_off +
                    (words - res_off + 1) / 2);
    case kGlobal:
      return 4LL * (kThreads / 32) * kWarpPos;
    default:
      return -1;
  }
}

const void* kernel_of(int32_t placement) {
  return placement == kSmem      ? (const void*)sieve_smem_kernel
         : placement == kCluster ? (const void*)sieve_cluster_kernel
                                 : (const void*)sieve_global_kernel;
}

// The persistent grid of a placement at `smem` bytes of shared memory: as
// many CTAs as the SMs hold (one per SM for the cluster kernel, whose
// shared memory fills the SM). The attribute and occupancy queries cost
// tens of microseconds of host time, so the last few results are kept per
// placement, keyed by device and shared memory (one per ruleset in use).
cudaError_t persistent_grid(int device, int32_t placement, int64_t smem,
                            int64_t* grid) {
  struct Entry { int device = -1; int64_t smem = -1, grid = 0; };
  constexpr int kEntries = 8;
  static Entry cache[3][kEntries];
  constexpr int kDevices = 64;
  static int64_t allowed[3][kDevices];   // largest shared memory allowed
  static int next[3];
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache[placement]) {
    if (e.device == device && e.smem == smem) {
      *grid = e.grid;
      return cudaSuccess;
    }
  }
  const void* fn = kernel_of(placement);
  cudaError_t err;
  if (device < 0 || device >= kDevices)
    return cudaErrorInvalidDevice;
  int64_t& a = allowed[placement][device];
  if (a < smem) {   // never lowered: every cached grid's launch still fits
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    a = smem;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  int per_sm = 1;
  if (placement == kCluster) {
    sms = sms / 2 * 2;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fn, kThreads, static_cast<size_t>(smem));
    if (err != cudaSuccess) return err;
    if (per_sm == 0) return cudaErrorInvalidConfiguration;
  }
  Entry& e = cache[placement][next[placement]];
  next[placement] = (next[placement] + 1) % kEntries;
  e = Entry{device, smem, static_cast<int64_t>(per_sm) * sms};
  *grid = e.grid;
  return cudaSuccess;
}

}  // namespace

// data: uint8[>= n], 16-byte aligned; arena: int32[words], the alive
// residuals last, from word res_off (res_off = words without them); desc:
// 3 rows;
// match: int32[npad]; bits: int32[npad / 32]; counts: int32[npad / block
// + 1], zeroed (the last word is the tile counter). npad % block == 0 and
// block % 512 == 0, else cudaErrorInvalidValue; a placement whose tables
// do not fit shared memory fails its launch. Launches on `stream`; returns
// the launch's cudaError_t.
extern "C" int pfac_sieve(int device, const void* data, int32_t n,
                          int32_t npad, const void* arena, int32_t words,
                          int32_t res_off, const void* desc, int32_t placement,
                          void* match,
                          void* bits, void* counts, int32_t block,
                          void* stream) {
  if (block <= 0 || block % kWarpPos != 0 || npad % block != 0 || npad < 0 ||
      placement < kSmem || placement > kGlobal || res_off < 0 ||
      res_off > words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (npad == 0) return 0;
  if (placement == kCluster && res_off == words)   // no residuals to split
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = smem_bytes(placement, words, res_off);
  const int threads = placement == kCluster ? kClusterThreads : kThreads;
  int64_t grid;
  err = persistent_grid(device, placement, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ntiles = (static_cast<int64_t>(npad) + threads * kPer - 1) /
                         (threads * kPer);
  if (grid > ntiles) grid = placement == kCluster ? (ntiles + 1) / 2 * 2 : ntiles;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* a = static_cast<const int32_t*>(arena);
  const auto* ds = static_cast<const int32_t*>(desc);
  auto* mt = static_cast<int32_t*>(match);
  auto* bt = static_cast<uint32_t*>(bits);
  auto* ct = static_cast<int32_t*>(counts);
  int32_t* ctr = ct + npad / block;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 g(static_cast<unsigned>(grid));
  if (placement == kSmem)
    sieve_smem_kernel<<<g, kThreads, smem, s>>>(d, n, npad, a, words, res_off,
                                                ds, mt, bt, ct, block, ctr);
  else if (placement == kCluster)
    sieve_cluster_kernel<<<g, kClusterThreads, smem, s>>>(
        d, n, npad, a, words, res_off, ds, mt, bt, ct, block, ctr);
  else
    sieve_global_kernel<<<g, kThreads, smem, s>>>(d, n, npad, a, words,
                                                  res_off, ds, mt, bt, ct,
                                                  block, ctr);
  return static_cast<int>(cudaGetLastError());
}
