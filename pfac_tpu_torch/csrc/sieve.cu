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
// Bytes at or past n read as 0 and never decide a hit (the masks above).
// A position probes m2 only where some 2-byte pattern starts with its byte
// c0 and n - pos > 1, m3 only where some 3-byte one does and n - pos > 2
// (the gates below), and reads a value only where the key hit. It
// also adds the survivors of each `block`-position block into counts[pos /
// block] (zeroed by the caller), the input of the dense-block escape (K3)
// and of the compaction (compact.cu).
//
// Bound: device memory. Per position it reads 1 byte and writes 4 bytes of
// match and 1 bit: 656 MiB at 128 MiB of input, 0.205 ms at 3.35 TB/s. The
// other cost is table loads, 3-7 per position (7 for a Snort-scale set):
// random words from shared memory. On the H100 the Snort kernel is bound
// by neither: one repeated byte, whose 32 lanes all load the same words,
// ran within 5% of text and random bytes (PERF.md §5), so the instructions
// a position issues set its time, and then the banks. Design:
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
// * probes go 4 positions at a time, stage by stage (m1, m2, m3, alive),
//   the loads of a stage issued together, so each thread keeps up to 4
//   independent table loads in flight; 8 take more registers than the
//   gates leave for 4 CTAs an SM (PERF.md §6);
// * the gates: a position probes m2 or m3 only where it can hit. When a
//   CTA stages its tables it sets bit 30 of the m1 word of byte c where
//   some m2 key starts with c, and bit 31 where some m3 key does (every
//   slot holds a member key, so an empty slot opens no gate a member would
//   not); IDs are below 2^30 (SieveTables.build), and the m1 ID is masked.
//   The key load is predicated on the gate and the value load on the
//   key's hit, so a shut lane sends nothing to the banks (~23% of the
//   text's positions open the m2 gate, ~29% the m3 one); the predicated
//   instructions still issue, and issue is what bounds the kernel, so the
//   gates save banks, not time (PERF.md §6). The arena in device
//   memory stays as it is: the global placement keeps its gated m1 copy in
//   its own shared memory;
// * few instructions a position: a displacement-free slot by one funnel
//   shift, a residual by one halfword load, and the warps that lie wholly
//   before n (all but the last) compiled without a test against n;
// * it counts the m2 and m3 key probes it issued (0-2 a position: the
//   open gates) in registers, a warp sum into shared memory, and adds them
//   to the caller's int64 counter with one atomic a CTA as the CTA leaves
//   (none where the counter is null);
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

#include "launch.cuh"
#include "probe.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kMixResid = 0xC2B2AE35u;   // chd.MIX_RESID
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr uint32_t kGate2 = 1u << 30;         // m1 word: an m2 key starts here
constexpr uint32_t kGate3 = 1u << 31;         // m1 word: an m3 key starts here
constexpr uint32_t kIdMask = kGate2 - 1u;     // the m1 word's ID
constexpr int kPer = 16;                      // positions per thread
constexpr int kBatch = 4;                     // positions probed together
constexpr int kWarpPos = 32 * kPer;           // positions per warp and tile
constexpr int kThreads = 256;                 // smem and global placements
constexpr int kClusterThreads = 512;          // one 2-CTA cluster per 2 SMs

enum Placement : int32_t { kSmem = 0, kCluster = 1, kGlobal = 2 };

// Where the tables are read from. A view gives the m1 word of a byte
// (gates set), a pointer to an array at an arena offset, a word of such an
// array, and a residual of the alive filter, read as a halfword: the
// packed array holds slot s in halfword s (two per word, little half
// first), so no shift or mask.

// Tables staged whole in this CTA's shared memory.
struct SmemTab {
  const uint32_t* w;
  const uint16_t* res;
  __device__ __forceinline__ uint32_t m1(uint32_t c) const { return w[c]; }
  __device__ __forceinline__ const uint32_t* at(int32_t off) const {
    return w + off;
  }
  __device__ __forceinline__ uint32_t load(const uint32_t* a,
                                           uint32_t i) const {
    return a[i];
  }
  __device__ __forceinline__ uint32_t resid(uint32_t s) const {
    return res[s];
  }
};

// Every table but the residuals in this CTA's shared memory; residual
// words [0, half) in rank 0's, [half, 2 * half) in rank 1's: halfwords
// [0, half2) and [half2, 2 * half2), half2 = 2 * half.
struct ClusterTab {
  const uint32_t* w;
  const uint16_t* h0;
  const uint16_t* h1;
  uint32_t half2;
  __device__ __forceinline__ uint32_t m1(uint32_t c) const { return w[c]; }
  __device__ __forceinline__ const uint32_t* at(int32_t off) const {
    return w + off;
  }
  __device__ __forceinline__ uint32_t load(const uint32_t* a,
                                           uint32_t i) const {
    return a[i];
  }
  __device__ __forceinline__ uint32_t resid(uint32_t s) const {
    return *(s < half2 ? h0 + s : h1 + (s - half2));
  }
};

// Tables read through L1 and L2, but the gated m1 words from this CTA's
// shared memory.
struct GlobalTab {
  const int32_t* __restrict__ a;
  const uint16_t* __restrict__ res;
  const uint32_t* gated;
  __device__ __forceinline__ uint32_t m1(uint32_t c) const {
    return gated[c];
  }
  __device__ __forceinline__ const uint32_t* at(int32_t off) const {
    return reinterpret_cast<const uint32_t*>(a) + off;
  }
  __device__ __forceinline__ uint32_t load(const uint32_t* t,
                                           uint32_t i) const {
    return __ldg(t + i);
  }
  __device__ __forceinline__ uint32_t resid(uint32_t s) const {
    return __ldg(res + s);
  }
};

// A probe table as K1 reads it, from its descriptor row (probe.cuh), with
// its arrays as pointers and its shifts worked out once per CTA. The
// slot is probe.cuh's: prod = key * mul;
//   displacement-free: slot = prod >> (32 - lg_r)
//   CHD: slot = ((prod >> (32 - lg_b - lg_r)) ^ disp[prod >> (32 - lg_b)])
//               & (2^lg_r - 1)
// (h1's own mask folds into the last; a shift by 32 gives 0, as the
// masks of probe.cuh make it).
struct Table {
  const uint32_t* disp;
  const uint32_t* keys;
  const uint32_t* vals;
  uint32_t mul, rmask;
  uint32_t sh_r, sh_b, sh_h;   // 32 - lg_r, 32 - lg_b, 32 - lg_b - lg_r
  bool present, displaced;
};

template <class Tab>
__device__ __forceinline__ Table table(const Tab& t, const pfac::Probe& p) {
  Table e;
  e.disp = t.at(p.disp_off);
  e.keys = t.at(p.key_off);
  e.vals = t.at(p.val_off);
  e.mul = p.mul;
  e.rmask = (1u << p.lg_r) - 1u;
  e.sh_r = 32 - p.lg_r;
  e.sh_b = 32 - p.lg_b;
  e.sh_h = 32 - p.lg_b - p.lg_r;
  e.present = p.present != 0;
  e.displaced = p.disp_off >= 0;
  return e;
}

struct Tables {
  Table m2, m3, al;
};

template <class Tab>
__device__ __forceinline__ Tables load_tables(
    const Tab& t, const int32_t* __restrict__ desc) {
  return Tables{table(t, pfac::load_probe(desc, 0)),
                table(t, pfac::load_probe(desc, 1)),
                table(t, pfac::load_probe(desc, 2))};
}

__device__ __forceinline__ uint32_t slot_nodisp(const Table& e, uint32_t key) {
  return __funnelshift_rc(key * e.mul, 0u, e.sh_r);
}

template <class Tab>
__device__ __forceinline__ uint32_t slot_disp(const Tab& t, const Table& e,
                                              uint32_t key) {
  const uint32_t prod = key * e.mul;
  const uint32_t d = t.load(e.disp, __funnelshift_rc(prod, 0u, e.sh_b));
  return ((prod >> e.sh_h) ^ d) & e.rmask;
}

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

// Sets the gates in the 256 m1 words at m1 (this CTA's shared memory):
// kGate2 in the word of byte c where some m2 key starts with c, kGate3
// where some m3 key does. Every slot holds a member key, so reading every
// slot finds the members' first bytes and no other. The keys are read
// from `arena`, this CTA's staged copy or the device's. Between two
// barriers: after m1 is staged, before any probe.
__device__ __forceinline__ void set_gates(uint32_t* m1,
                                          const uint32_t* arena,
                                          const int32_t* __restrict__ desc) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const pfac::Probe p = pfac::load_probe(desc, g);
    if (!p.present) continue;
    const uint32_t gate = g == 0 ? kGate2 : kGate3;
    const uint32_t* keys = arena + p.key_off;
    for (int32_t i = threadIdx.x; i < (1 << p.lg_r); i += blockDim.x)
      atomicOr(m1 + (keys[i] & 0xFFu), gate);
  }
}

// An exact probe of kBatch keys (masked by `mask`), issued only where it
// can hit: where the key's m1 word g[j] has the table's `gate` set (near
// n the caller has shut the gates of positions where the pattern would not
// fit). The key load (and a displaced table's displacement load) is
// predicated on the gate, the value load on the key's hit, into m[j]. All
// key loads of the stage are issued before one is compared; the branch on
// the table's kind is uniform.
template <class Tab>
__device__ __forceinline__ void exact_stage(const Tab& t, const Table& e,
                                            const uint32_t (&key)[kBatch],
                                            const uint32_t (&g)[kBatch],
                                            uint32_t gate, uint32_t mask,
                                            uint32_t (&m)[kBatch]) {
  if (!e.present) return;
  uint32_t sl[kBatch], kw[kBatch];
  if (!e.displaced) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      sl[j] = slot_nodisp(e, key[j] & mask);
      if (g[j] & gate) kw[j] = t.load(e.keys, sl[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (g[j] & gate) {
        sl[j] = slot_disp(t, e, key[j] & mask);
        kw[j] = t.load(e.keys, sl[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if ((g[j] & gate) && kw[j] == (key[j] & mask))
      m[j] = t.load(e.vals, sl[j]);
}

// The alive filter on kBatch keys: bit j0 + j of fl where the residual of
// the key's slot equals its own and, near n (kEdge), rd0 - j > 3. Every
// slot (each with its displacement load) before any residual load.
template <bool kEdge, class Tab>
__device__ __forceinline__ void alive_stage(const Tab& t, const Table& e,
                                            const uint32_t (&key)[kBatch],
                                            int32_t rd0, int j0,
                                            uint32_t& fl) {
  if (!e.present) return;
  uint32_t sl[kBatch];
  if (!e.displaced) {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sl[j] = slot_nodisp(e, key[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sl[j] = slot_disp(t, e, key[j]);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j)
    if (t.resid(sl[j]) == (key[j] * kMixResid) >> 16 &&
        (!kEdge || rd0 - j > 3))
      fl |= 1u << (j0 + j);
}

// One warp's 512 positions starting at wpos (wpos < npad, wpos % 512 == 0):
// match words through the warp's staging buffer, bitmap words and count.
// kEdge: the warp's positions or their three bytes of lookahead reach n,
// so each probe tests its position against n; elsewhere none does.
template <bool kEdge, class Tab>
__device__ __forceinline__ void sieve_warp(
    const Tab& t, const Tables& tb, const uint8_t* __restrict__ data,
    int32_t n, int64_t wpos, uint32_t* stage_buf, int32_t* __restrict__ match,
    uint32_t* __restrict__ bits, int32_t* __restrict__ counts, int32_t block,
    uint32_t& probes, uint32_t& probes3) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 = wpos + kPer * lane;
  uint32_t w[5];
  if (!kEdge || p0 + kPer <= n) {
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
    uint32_t key[kBatch], g[kBatch], m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int q = (j0 + j) >> 2, r = (j0 + j) & 3;
      key[j] = r == 0 ? w[q] : __funnelshift_r(w[q], w[q + 1], 8 * r);
      g[j] = t.m1(key[j] & 0xFFu);
      m[j] = g[j] & kIdMask;
      if (kEdge) {          // shut the gates of patterns past n
        const int32_t rd = rd0 - j0 - j;
        g[j] &= (rd > 1 ? kGate2 : 0u) | (rd > 2 ? kGate3 : 0u);
      }
      // the gates open here are the probes issued: (g >> 30) counts the
      // m2 gate once and the m3 gate twice, (g >> 31) the m3 gate once
      probes += g[j] >> 30;
      probes3 += g[j] >> 31;
    }
    exact_stage(t, tb.m2, key, g, kGate2, 0xFFFFu, m);
    exact_stage(t, tb.m3, key, g, kGate3, 0xFFFFFFu, m);
    alive_stage<kEdge>(t, tb.al, key, rd0 - j0, j0, fl);
#pragma unroll
    for (int j = 0; j < kBatch; ++j)   // row `lane`, column (j0 + j) ^ swz:
      stage_buf[lane * kPer + ((j0 + j) ^ swz)] =   // the 32 lanes, 32 banks
          !kEdge || rd0 - j0 - j > 0 ? m[j] : 0u;
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

// The persistent loop: tiles of blockDim.x * 16 positions from *tile_ctr;
// then the CTA's short probes into *short_probes (where not null).
template <class Tab>
__device__ __forceinline__ void sieve_tiles(
    const Tab& t, const Tables& tb, const uint8_t* __restrict__ data,
    int32_t n, int32_t npad, uint32_t* stage_bufs, int32_t* __restrict__ match,
    uint32_t* __restrict__ bits, int32_t* __restrict__ counts, int32_t block,
    int32_t* __restrict__ tile_ctr,
    unsigned long long* __restrict__ short_probes) {
  __shared__ int32_t s_tile[2];
  __shared__ unsigned long long s_probes;
  if (threadIdx.x == 0) s_probes = 0;   // ordered by the loop's barrier
  uint32_t probes = 0, probes3 = 0;   // short probes: probes - probes3
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
    if (wpos + kWarpPos + 3 <= n)            // warp-uniform
      sieve_warp<false>(t, tb, data, n, wpos, buf, match, bits, counts,
                        block, probes, probes3);
    else if (wpos < npad)                    // npad % 512 == 0
      sieve_warp<true>(t, tb, data, n, wpos, buf, match, bits, counts, block,
                       probes, probes3);
  }
  if (short_probes == nullptr) return;       // uniform
  const uint32_t c = __reduce_add_sync(kFull, probes - probes3);
  if ((threadIdx.x & 31) == 0 && c != 0) atomicAdd(&s_probes, c);
  __syncthreads();
  if (threadIdx.x == 0 && s_probes != 0) atomicAdd(short_probes, s_probes);
}

// Shared memory: [warps * 512 staging words][tables].
__global__ void __launch_bounds__(kThreads)
sieve_smem_kernel(const uint8_t* __restrict__ data, int32_t n, int32_t npad,
                  const int32_t* __restrict__ arena, int32_t words,
                  int32_t res_off, const int32_t* __restrict__ desc,
                  int32_t* __restrict__ match,
                  uint32_t* __restrict__ bits, int32_t* __restrict__ counts,
                  int32_t block, int32_t* __restrict__ tile_ctr,
                  unsigned long long* __restrict__ short_probes) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* tab = smem + (kThreads / 32) * kWarpPos;
  stage(tab, arena, words);
  const SmemTab t{tab, reinterpret_cast<const uint16_t*>(tab + res_off)};
  const Tables tb = load_tables(t, desc);
  __syncthreads();
  set_gates(tab, tab, desc);
  __syncthreads();
  sieve_tiles(t, tb, data, n, npad, smem, match, bits, counts, block,
              tile_ctr, short_probes);
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
                     int32_t* __restrict__ tile_ctr,
                     unsigned long long* __restrict__ short_probes) {
  extern __shared__ __align__(16) uint32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  uint32_t* tab = smem + (kClusterThreads / 32) * kWarpPos;
  const int32_t half = (words - res_off + 1) / 2;
  const int32_t rank = static_cast<int32_t>(cluster.block_rank());
  const int32_t lo = res_off + rank * half;
  const int32_t hi = lo + half < words ? lo + half : words;
  stage(tab, arena, res_off);
  stage(tab + res_off, arena + lo, hi - lo);
  cluster.sync();              // both halves staged before any remote read
  const ClusterTab t{
      tab,
      reinterpret_cast<const uint16_t*>(
          cluster.map_shared_rank(tab + res_off, 0)),
      reinterpret_cast<const uint16_t*>(
          cluster.map_shared_rank(tab + res_off, 1)),
      2u * static_cast<uint32_t>(half)};
  const Tables tb = load_tables(t, desc);
  set_gates(tab, tab, desc);   // this CTA's m1 words, read by it alone
  __syncthreads();
  sieve_tiles(t, tb, data, n, npad, smem, match, bits, counts, block,
              tile_ctr, short_probes);
  cluster.sync();              // the partner may still read this CTA's half
}

__global__ void __launch_bounds__(kThreads)
sieve_global_kernel(const uint8_t* __restrict__ data, int32_t n, int32_t npad,
                    const int32_t* __restrict__ arena, int32_t words,
                    int32_t res_off, const int32_t* __restrict__ desc,
                    int32_t* __restrict__ match, uint32_t* __restrict__ bits,
                    int32_t* __restrict__ counts, int32_t block,
                    int32_t* __restrict__ tile_ctr,
                    unsigned long long* __restrict__ short_probes) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t gated[256];
  stage(gated, arena, 256);    // m1 sits at arena offset 0
  const GlobalTab t{arena, reinterpret_cast<const uint16_t*>(arena + res_off),
                    gated};
  const Tables tb = load_tables(t, desc);
  __syncthreads();
  set_gates(gated, reinterpret_cast<const uint32_t*>(arena), desc);
  __syncthreads();
  sieve_tiles(t, tb, data, n, npad, smem, match, bits, counts, block,
              tile_ctr, short_probes);
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
// + 1], zeroed (the last word is the tile counter); short_probes: an int64
// the m2 and m3 key probes are added to, or null. npad % block == 0 and
// block % 512 == 0, else cudaErrorInvalidValue; a placement whose tables
// do not fit shared memory fails its launch.
cudaError_t pfac::sieve_launch(int device, const void* data, int32_t n,
                               int32_t npad, const void* arena, int32_t words,
                               int32_t res_off, const void* desc,
                               int32_t placement, void* match, void* bits,
                               void* counts, int32_t block, void* short_probes,
                               Launch* l) {
  *l = Launch{};
  if (block <= 0 || block % kWarpPos != 0 || npad % block != 0 || npad < 0 ||
      placement < kSmem || placement > kGlobal || res_off < 0 ||
      res_off > words)
    return cudaErrorInvalidValue;
  if (npad == 0) return cudaSuccess;
  if (placement == kCluster && res_off == words)   // no residuals to split
    return cudaErrorInvalidValue;
  const int64_t smem = smem_bytes(placement, words, res_off);
  const int threads = placement == kCluster ? kClusterThreads : kThreads;
  int64_t grid;
  cudaError_t err = persistent_grid(device, placement, smem, &grid);
  if (err != cudaSuccess) return err;
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
  auto* sp = static_cast<unsigned long long*>(short_probes);
  const auto g = static_cast<unsigned>(grid);
  if (placement == kSmem)
    l->set(sieve_smem_kernel, g, kThreads, smem, d, n, npad, a, words,
           res_off, ds, mt, bt, ct, block, ctr, sp);
  else if (placement == kCluster)
    l->set(sieve_cluster_kernel, g, kClusterThreads, smem, d, n, npad, a,
           words, res_off, ds, mt, bt, ct, block, ctr, sp);
  else
    l->set(sieve_global_kernel, g, kThreads, smem, d, n, npad, a, words,
           res_off, ds, mt, bt, ct, block, ctr, sp);
  return cudaSuccess;
}

// As sieve_launch, counting no probes; launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int pfac_sieve(int device, const void* data, int32_t n,
                          int32_t npad, const void* arena, int32_t words,
                          int32_t res_off, const void* desc, int32_t placement,
                          void* match,
                          void* bits, void* counts, int32_t block,
                          void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::sieve_launch(device, data, n, npad, arena, words, res_off, desc,
                           placement, match, bits, counts, block, nullptr,
                           &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
