// The lockstep walker: the longest match starting at every position, by a
// failureless walk over the whole automaton. Replaces the XLA walk of
// pfac_tpu/backends/xla.py (walk_tiles, :167, behind _match_dense_padded
// :216 and _match_hash_padded :236), which the JAX package compiles into
// one device program a call: tiles of start positions stepped in lockstep
// by a while_loop that ends when every lane of the tile has trapped.
//
// What it computes, exactly as walk_tiles does over its sentinel-padded
// input (a byte at or past n is the sentinel, column 256, whose every entry
// traps):
// * position i takes the state s2 after its two bytes (c1, c2) from the
//   pair states and the best match m2 within them;
// * then it steps at depth d = 2, 3, ... while d < max_len and the state is
//   not 0 (the trap); after each step a state in 1..num_final is the match;
// * out[i] is the last match; every position of out is written, the tail
//   past n included (the sentinel's row gives 0 there).
// Two steps: dense, table[state * 257 + ch] indexed in 64 bits (the 100K
// set's table is 6.16 GB); hash, the modulo-free perfect-hash probe of
// hash_step_fn (:149), on int32 with arithmetic shifts.
//
// Bound: device memory. The input is read once and 4 B a position written:
// 5 B a position, 0.200 ms at 128 Mi positions and 3.35 TB/s. The first
// port (one thread a position, two 4-byte gathers a position into the two
// 264 KB pair tables) spent 97% of its time on random bytes in those
// gathers, from L2, and each warp ran as long as its longest walk. Design:
// * the two-byte stage reads one table. pair_match is redundant:
//   m2 = s2 if 1 <= s2 <= num_final, else m1[c1], and m1[c1] is
//   pair_match[c1 * 257 + 256] (column 256 traps). The 257 words of m1 sit
//   in shared memory; pair_match is read nowhere else, so the caller's
//   pair tables must be as xla.pair_tables builds them;
// * the pair states are placed by size (backends/lockstep.py::placement_for
//   picks; a placement that is forced and does not fit raises there):
//   - smem: a compacted form, built once on the host with the automaton
//     (lockstep.pair_form), resident in each CTA's shared memory: for each
//     32-column word of rows c1 < 256 (column 256 is 0) its occupancy bits
//     beside the rank of its first bit, one 8-byte pair, the pairs of a
//     row permuted by c1 % 8 so that rows do not all start on one bank;
//     then the nonzero states in row-major order. 2,000 Snort patterns:
//     1,886 nonzero of 66,049, 24 KB; a lookup is one 8-byte word and, for
//     a live pair only, one state;
//   - global: pair_state through L1/L2, one 4-byte load a position. The
//     100K set (51,205 nonzero pairs) and every call without a form.
//   Building the form on the host once costs no launch: each CTA building
//   it would read 264 KB from L2 at its start and could not tell the host
//   that it did not fit;
// * a persistent grid (as many CTAs as the SMs hold) whose warps work
//   alone: each takes tiles of 256 positions, warp w of CTA c tiles
//   c * 16 + w + k * 16 * gridDim.x, and shares nothing with its CTA but
//   m1 and the form, so no warp waits at a barrier for another's walks
//   (a CTA-wide tile of 4,096 positions with three barriers a tile ran
//   slower on the DEFCON-like, all-match and virus corpora: the CTA waited
//   on its longest walk; PERF.md §6). A tile counter as in
//   K1 would need a word zeroed before each launch, which the call's
//   contract (data, tables, out) does not have;
// * the warp's bytes, and a halo of 256 past them, staged in its shared
//   memory by one 16-byte load a lane (byte loads where the data is not
//   16-byte aligned or ends); lane l takes positions l + 32 j, so each
//   access of the stage and of the tile's matches is to consecutive
//   words. A walk reads its bytes from the stage, past the halo from
//   device memory (a 1,000-byte pattern);
// * walks past depth 2 packed onto busy lanes. Where half the tile or more
//   walks on (all_match, the 100K set), every lane is busy already: each
//   walks its 8 positions in lockstep, their 8 loads a step issued
//   together. Else the walks go into the warp's queue in shared memory
//   (offset, depth, state; one ballot a round) and the warp walks the
//   queue packed, two walks a lane in lockstep, so lanes do not idle
//   behind dead positions;
// * the longest walks do not hold a tile: a walk takes at most 8 steps in
//   a tile's phase, and one still going is carried to the warp's next tile
//   (up to 32; past that it goes on to its end), where it reads its bytes
//   from device memory and writes its match to out when it ends; the
//   warp's last walks go to their end after its last tile;
// * the result written once: the tile's matches collect in shared memory
//   (m2, then each walk's last match) and leave as 16-byte stores,
//   coalesced.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <mutex>
#include <type_traits>

#include "launch.cuh"

namespace {

constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 2;                  // CTAs an SM: 32 warps
constexpr int kPer = 8;                      // positions a lane
constexpr int kTile = 32 * kPer;             // a warp's tile: 256 positions
constexpr int kStaged = 2 * kTile;           // its bytes and a halo of 256
constexpr int32_t kStride = 257;             // device table columns
constexpr int32_t kSentinel = 256;           // a byte at or past n
constexpr int kRowWords = 8;                 // occupancy words a row (256 bits)
constexpr int32_t kFormHead = 2 * 256 * kRowWords;   // (bits, rank) words
constexpr int kM1Words = 260;                // m1: 257 words, padded to 16 B
constexpr int kDense = kTile / 2;            // walks a tile walked in place
constexpr int kStepCap = 8;                  // steps a walk takes a tile
constexpr int kCarryMax = 32;                // walks a warp carries on
constexpr int kHashShift = 16;               // key = k << 16 | (slots - 1)
constexpr int32_t kHashSlotMask = 0xFFFF;

// A warp's shared memory: its staged bytes, its tile's matches, its queue
// (offset | depth << 8, state) and two lists of carried walks.
constexpr int kWarpBytes = kStaged + 4 * kTile + 8 * kTile +
                           2 * kCarryMax * (8 + 3 * 4);
// Below the form: every warp's, then m1; the form (smem placement) after.
constexpr int64_t kFixedBytes =
    static_cast<int64_t>(kWarps) * kWarpBytes + 4LL * kM1Words;
static_assert(kWarpBytes % 16 == 0, "16-byte aligned warp regions");

enum Placement : int32_t { kSmem = 0, kGlobal = 1 };

// The pair states from the compacted form in shared memory.
struct SmemPairs {
  const uint2* head;       // [256 * 8]: (occupancy bits, rank of bit 0)
  const int32_t* states;   // the nonzero states, row-major

  __device__ __forceinline__ int32_t operator()(int32_t c1, int32_t c2) const {
    if ((c1 | c2) & kSentinel) return 0;   // the sentinel's row and column
    // row c1's word c2 / 32 sits at slot c2 / 32 ^ c1 % 8 of the row, so
    // rows that start on the same bank spread over the others
    const int slot = (c2 >> 5) ^ (c1 & (kRowWords - 1));
    const uint2 e = head[c1 * kRowWords + slot];
    const uint32_t bit = 1u << (c2 & 31);
    return (e.x & bit) ? states[e.y + __popc(e.x & (bit - 1))] : 0;
  }
};

// The pair states through L1/L2.
struct GlobalPairs {
  const int32_t* __restrict__ pair_state;   // [257 * 257]

  __device__ __forceinline__ int32_t operator()(int32_t c1, int32_t c2) const {
    return __ldg(pair_state + c1 * kStride + c2);
  }
};

struct DenseStep {
  const int32_t* __restrict__ table;   // [states * 257]

  __device__ __forceinline__ int32_t operator()(int32_t s, int32_t ch) const {
    return __ldg(table + static_cast<int64_t>(s) * kStride + ch);
  }
};

struct HashStep {
  const int32_t* __restrict__ rp_off;
  const int32_t* __restrict__ rp_key;
  const int32_t* __restrict__ val_next;
  const int32_t* __restrict__ val_ch;

  // modulo-free (k * ch) mod 257: x = 256 q + r  ==>  r - q (mod 257)
  __device__ __forceinline__ int32_t operator()(int32_t s, int32_t ch) const {
    const int32_t off = __ldg(rp_off + s);
    const int32_t key = __ldg(rp_key + s);
    const int32_t x = (key >> kHashShift) * ch;
    int32_t beta = (x & 0xFF) - (x >> 8);
    if (beta < 0) beta += 257;
    const int64_t slot =
        static_cast<int64_t>(off + (beta & (key & kHashSlotMask)));
    return __ldg(val_ch + slot) == ch ? __ldg(val_next + slot) : 0;
  }
};

__device__ __forceinline__ bool is_match(int32_t s, int32_t num_final) {
  return static_cast<uint32_t>(s - 1) < static_cast<uint32_t>(num_final);
}

// Walks carried from one of a warp's tiles to its next: a walk's start in
// the data, depth, state and match.
struct Carry {
  int64_t* g;
  int32_t* d;
  int32_t* s;
  int32_t* m;
};

// A warp's part of shared memory.
struct Warp {
  uint8_t* bytes;      // [kStaged] data[base, base + kStaged), 0 past n
  int32_t* res;        // [kTile] the tile's matches
  int32_t* q_pd;       // [kTile] a queued walk's offset | depth << 8
  int32_t* q_s;        // [kTile] its state
  Carry carry[2];

  __device__ explicit Warp(unsigned char* at) {
    bytes = at;
    res = reinterpret_cast<int32_t*>(at + kStaged);
    q_pd = res + kTile;
    q_s = q_pd + kTile;
    auto* g = reinterpret_cast<int64_t*>(q_s + kTile);
    auto* w = reinterpret_cast<int32_t*>(g + 2 * kCarryMax);
    for (int b = 0; b < 2; ++b)
      carry[b] = Carry{g + b * kCarryMax, w + (3 * b) * kCarryMax,
                       w + (3 * b + 1) * kCarryMax,
                       w + (3 * b + 2) * kCarryMax};
  }
};

// Bytes [at, at + 16) of data as one word; those at or past n read as 0
// (no position reads them: the sentinel is decided by n).
__device__ __forceinline__ uint4 load16(const uint8_t* __restrict__ data,
                                        int64_t n, int64_t at, bool aligned) {
  if (aligned && at + 16 <= n)
    return __ldg(reinterpret_cast<const uint4*>(data + at));
  uint32_t x[4] = {0, 0, 0, 0};
  for (int k = 0; k < 16; ++k)
    if (at + k < n) x[k >> 2] |= static_cast<uint32_t>(data[at + k])
                                 << (8 * (k & 3));
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// K walks of a lane in lockstep, walk j where bit j of `have` is set: at
// most `limit` steps each, the K loads of a step issued together. A walk
// that ends writes its match: into the tile's matches for a position of
// the tile (pos >= 0), into out for a walk carried from an earlier tile,
// which has left already.
template <int K, class Step>
__device__ __forceinline__ void walk_k(
    const Warp& wp, const uint8_t* __restrict__ data, int64_t n,
    const Step& step, int32_t num_final, int32_t max_len, int limit,
    uint32_t& have, const int (&pos)[K], const int64_t (&g)[K], int (&d)[K],
    int32_t (&s)[K], int32_t (&m)[K], int32_t* __restrict__ out) {
  for (int t = 0; have != 0 && t < limit; ++t) {
    int32_t next[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if ((have >> j) & 1) {
        const int rel = pos[j] + d[j];               // g + d < n
        const int32_t ch = pos[j] >= 0 && rel < kStaged
                               ? wp.bytes[rel]
                               : __ldg(data + g[j] + d[j]);
        next[j] = step(s[j], ch);
      }
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if ((have >> j) & 1) {
        s[j] = next[j];
        if (is_match(s[j], num_final)) m[j] = s[j];
        ++d[j];
        if (s[j] == 0 || d[j] >= max_len || g[j] + d[j] >= n) {
          if (pos[j] >= 0)
            wp.res[pos[j]] = m[j];
          else
            out[g[j]] = m[j];
          have &= ~(1u << j);
        }
      }
    }
  }
}

// The two-byte stage of the warp's tile at base: every position's m2 into
// wp.res (lane l takes positions l + 32 j) -> the queue's length. The
// positions that walk on (s2 not 0, 2 < max_len, base + p + 2 < n) are
// queued at depth 2; where they are kDense of the tile or more, every
// lane is busy already, and each lane first walks its kPer positions in
// lockstep in place, up to kStepCap steps, and queues those still going.
template <class Pairs, class Step>
__device__ __forceinline__ int pair_stage(
    const Warp& wp, const int32_t* m1, const Pairs& pairs,
    const uint8_t* __restrict__ data, int64_t n, int64_t npad, int64_t base,
    const Step& step, int32_t num_final, int32_t max_len,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1;
  int pos[kPer], d[kPer];
  int64_t g[kPer];
  int32_t s[kPer], m[kPer], c1[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {     // kPer independent lookups in flight
    pos[j] = lane + 32 * j;
    g[j] = base + pos[j];
    d[j] = 2;
    c1[j] = g[j] < n ? wp.bytes[pos[j]] : kSentinel;
    const int32_t c2 = g[j] + 1 < n ? wp.bytes[pos[j] + 1] : kSentinel;
    s[j] = pairs(c1[j], c2);
  }
  uint32_t have = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    m[j] = is_match(s[j], num_final) ? s[j] : m1[c1[j]];
    if (s[j] != 0 && max_len > 2 && g[j] + 2 < n && g[j] < npad)
      have |= 1u << j;
  }
  if (__reduce_add_sync(kFull, __popc(have)) >= kDense)   // warp-uniform
    walk_k<kPer>(wp, data, n, step, num_final, max_len, kStepCap, have, pos,
                 g, d, s, m, out);
  int qn = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    wp.res[pos[j]] = m[j];
    const bool go = (have >> j) & 1;
    const uint32_t mask = __ballot_sync(kFull, go);
    if (go) {
      const int k = qn + __popc(mask & below);
      wp.q_pd[k] = pos[j] | (d[j] << 8);
      wp.q_s[k] = s[j];
    }
    qn += __popc(mask);
  }
  return qn;
}

// The warp's walk phase over its pool: the `cin_n` walks carried in, then
// its queue (qn entries), packed: in a round of 64 entries lane l takes
// entries l and l + 32 and walks the two in lockstep, so every lane has
// walks while the pool lasts. A walk takes at most kStepCap steps here
// (all of them where `last`); one still going is carried out to the
// warp's next tile (into cout) -> their number. Past kCarryMax, a walk
// goes on to its end here.
template <class Step>
__device__ __forceinline__ int walk_pool(
    const Warp& wp, const Carry& cin, int cin_n, int qn, const Carry& cout,
    const uint8_t* __restrict__ data, int64_t n, int64_t base,
    const Step& step, int32_t num_final, int32_t max_len, bool last,
    int32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1;
  const int total = cin_n + qn;
  int cout_n = 0;
  for (int r = 0; r < total; r += 64) {
    int pos[2], d[2];
    int64_t g[2];
    int32_t s[2], m[2];
    uint32_t have = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = r + 32 * j + lane;
      pos[j] = -1;         // -1: carried
      d[j] = 0;
      g[j] = 0;
      s[j] = m[j] = 0;
      if (i < cin_n) {
        g[j] = cin.g[i];
        d[j] = cin.d[i];
        s[j] = cin.s[i];
        m[j] = cin.m[i];
        have |= 1u << j;
      } else if (i < total) {
        const int pd = wp.q_pd[i - cin_n];
        pos[j] = pd & 0xFF;
        d[j] = pd >> 8;
        s[j] = wp.q_s[i - cin_n];
        m[j] = wp.res[pos[j]];
        g[j] = base + pos[j];
        have |= 1u << j;
      }
    }
    walk_k<2>(wp, data, n, step, num_final, max_len,
              last ? INT_MAX : kStepCap, have, pos, g, d, s, m, out);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool go = (have >> j) & 1;
      const uint32_t left = __ballot_sync(kFull, go);
      if (go) {
        const int k = cout_n + __popc(left & below);
        if (k < kCarryMax) {
          cout.g[k] = g[j];
          cout.d[k] = d[j];
          cout.s[k] = s[j];
          cout.m[k] = m[j];
          have &= ~(1u << j);
        }
      }
      cout_n = min(cout_n + __popc(left), kCarryMax);
    }
    walk_k<2>(wp, data, n, step, num_final, max_len, INT_MAX, have, pos, g,
              d, s, m, out);
  }
  return cout_n;
}

template <Placement P, class Step>
__device__ __forceinline__ void lockstep_tiles(
    const uint8_t* __restrict__ data, int64_t n, int64_t npad,
    const int32_t* __restrict__ pair_state,
    const int32_t* __restrict__ pair_match, const int32_t* __restrict__ form,
    int32_t form_words, const Step& step, int32_t num_final, int32_t max_len,
    int32_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t* m1 = reinterpret_cast<int32_t*>(smem + kWarps * kWarpBytes);
  for (int c = threadIdx.x; c < kStride; c += kThreads)
    m1[c] = __ldg(pair_match + c * kStride + kSentinel);
  int32_t* fsm = m1 + kM1Words;
  if constexpr (P == kSmem) {            // the form: 16-byte words, a tail
    const int vec = form_words / 4;
    for (int c = threadIdx.x; c < vec; c += kThreads)
      reinterpret_cast<int4*>(fsm)[c] =
          __ldg(reinterpret_cast<const int4*>(form) + c);
    for (int c = 4 * vec + threadIdx.x; c < form_words; c += kThreads)
      fsm[c] = __ldg(form + c);
  }
  std::conditional_t<P == kSmem, SmemPairs, GlobalPairs> pairs;
  if constexpr (P == kSmem)
    pairs = SmemPairs{reinterpret_cast<const uint2*>(fsm), fsm + kFormHead};
  else
    pairs = GlobalPairs{pair_state};
  __syncthreads();   // m1 and the form, the only state the warps share
  const Warp wp(smem + w * kWarpBytes);
  const bool aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int64_t ntiles = (npad + kTile - 1) / kTile;
  int carried = 0, b = 0;     // walks carried into this tile, in carry[b]
  for (int64_t tile = static_cast<int64_t>(blockIdx.x) * kWarps + w;
       tile < ntiles; tile += static_cast<int64_t>(gridDim.x) * kWarps) {
    const int64_t base = tile * kTile;
    // the tile's bytes and the halo, one 16-byte word a lane
    reinterpret_cast<uint4*>(wp.bytes)[lane] =
        load16(data, n, base + 16 * lane, aligned);
    __syncwarp();
    const int qn = pair_stage(wp, m1, pairs, data, n, npad, base, step,
                              num_final, max_len, out);
    __syncwarp();
    carried = walk_pool(wp, wp.carry[b], carried, qn, wp.carry[b ^ 1], data,
                        n, base, step, num_final, max_len, false, out);
    b ^= 1;
    __syncwarp();
    const int64_t left = npad - base;
    if (out_aligned && left >= kTile) {
      int4* o = reinterpret_cast<int4*>(out + base);
#pragma unroll
      for (int k = 0; k < kTile / 128; ++k)
        o[lane + 32 * k] = reinterpret_cast<const int4*>(wp.res)[lane + 32 * k];
    } else {
      const int cut = left < kTile ? static_cast<int>(left) : kTile;
      for (int i = lane; i < cut; i += 32) out[base + i] = wp.res[i];
    }
    __syncwarp();   // the next tile's bytes and matches after these reads
  }
  // the last walks, each to its end
  walk_pool(wp, wp.carry[b], carried, 0, wp.carry[b ^ 1], data, n, 0, step,
            num_final, max_len, true, out);
}

template <Placement P>
__global__ void __launch_bounds__(kThreads, kMinCtas)
lockstep_dense_kernel(const uint8_t* __restrict__ data, int64_t n,
                      int64_t npad, const int32_t* __restrict__ pair_state,
                      const int32_t* __restrict__ pair_match,
                      const int32_t* __restrict__ form, int32_t form_words,
                      const int32_t* __restrict__ table, int32_t num_final,
                      int32_t max_len, int32_t* __restrict__ out) {
  lockstep_tiles<P>(data, n, npad, pair_state, pair_match, form, form_words,
                    DenseStep{table}, num_final, max_len, out);
}

template <Placement P>
__global__ void __launch_bounds__(kThreads, kMinCtas)
lockstep_hash_kernel(const uint8_t* __restrict__ data, int64_t n,
                     int64_t npad, const int32_t* __restrict__ pair_state,
                     const int32_t* __restrict__ pair_match,
                     const int32_t* __restrict__ form, int32_t form_words,
                     const int32_t* __restrict__ rp_off,
                     const int32_t* __restrict__ rp_key,
                     const int32_t* __restrict__ val_next,
                     const int32_t* __restrict__ val_ch, int32_t num_final,
                     int32_t max_len, int32_t* __restrict__ out) {
  lockstep_tiles<P>(data, n, npad, pair_state, pair_match, form, form_words,
                    HashStep{rp_off, rp_key, val_next, val_ch}, num_final,
                    max_len, out);
}

// Kernel k = 2 * hashed + placement.
const void* kernel_of(int k) {
  switch (k) {
    case 0: return (const void*)lockstep_dense_kernel<kSmem>;
    case 1: return (const void*)lockstep_dense_kernel<kGlobal>;
    case 2: return (const void*)lockstep_hash_kernel<kSmem>;
    default: return (const void*)lockstep_hash_kernel<kGlobal>;
  }
}

// The persistent grid of kernel `k` (kernel_of) at `smem` bytes of dynamic
// shared memory: as many CTAs as the SMs hold; cudaErrorInvalidValue where
// `smem` is more than a CTA may have. The attribute and occupancy queries
// cost tens of microseconds of host time, so the last few results are
// kept, keyed by kernel, device and shared memory (one per ruleset in use).
cudaError_t persistent_grid(int k, int device, int64_t smem, int64_t* grid) {
  struct Entry { int k = -1, device = -1; int64_t smem = -1, grid = 0; };
  constexpr int kEntries = 16;
  constexpr int kDevices = 64;
  static Entry cache[kEntries];
  static int64_t allowed[4][kDevices];   // the largest shared memory set
  static int next;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.k == k && e.device == device && e.smem == smem) {
      *grid = e.grid;
      return cudaSuccess;
    }
  }
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  const void* fn = kernel_of(k);
  int optin = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;   // the counters and carried walks: static
  err = cudaFuncGetAttributes(&fa, fn);
  if (err != cudaSuccess) return err;
  if (smem + static_cast<int64_t>(fa.sharedSizeBytes) > optin)
    return cudaErrorInvalidValue;
  int64_t& a = allowed[k][device];
  if (a < smem) {   // never lowered: every cached grid's launch still fits
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    a = smem;
  }
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, kThreads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  cache[next] = Entry{k, device, smem, static_cast<int64_t>(per_sm) * sms};
  next = (next + 1) % kEntries;
  *grid = static_cast<int64_t>(per_sm) * sms;
  return cudaSuccess;
}

}  // namespace

// data: uint8, bytes [0, n) read; out: int32[npad], every word written;
// pair_state, pair_match: int32[257 * 257] as xla.pair_tables builds them
// (pair_match is read at column 256 only); form: the compacted pair states
// (lockstep.pair_form, form_words >= 4096 words, 16-byte aligned), which
// places them in shared memory, or null, which reads pair_state through
// L1/L2; dense (hashed 0): t0 the table int32[states * 257]; hash (hashed
// 1): t0..t3 rp_off, rp_key, val_next, val_ch. 0 <= n, 0 <= npad;
// num_final >= 0; a form that does not fit the device's shared memory, or
// any other argument out of range: cudaErrorInvalidValue. npad 0 is a
// launch with nothing to do.
cudaError_t pfac::lockstep_launch(int device, const void* data, int64_t n,
                                  int64_t npad, const void* pair_state,
                                  const void* pair_match, const void* form,
                                  int32_t form_words, int32_t hashed,
                                  const void* t0, const void* t1,
                                  const void* t2, const void* t3,
                                  int32_t num_final, int32_t max_len,
                                  void* out, Launch* l) {
  *l = Launch{};
  if (n < 0 || npad < 0 || num_final < 0 || (n > 0 && data == nullptr) ||
      pair_state == nullptr || pair_match == nullptr || t0 == nullptr ||
      (hashed && (t1 == nullptr || t2 == nullptr || t3 == nullptr)) ||
      (npad > 0 && out == nullptr) ||
      (form != nullptr &&
       (form_words < kFormHead ||
        (reinterpret_cast<uintptr_t>(form) & 15) != 0)))
    return cudaErrorInvalidValue;
  if (npad == 0) return cudaSuccess;
  const Placement p = form != nullptr ? kSmem : kGlobal;
  const int64_t smem =
      kFixedBytes + (p == kSmem ? 4LL * ((form_words + 3) / 4 * 4) : 0);
  int64_t grid;
  const cudaError_t err =
      persistent_grid(2 * (hashed != 0) + p, device, smem, &grid);
  if (err != cudaSuccess) return err;
  const int64_t ctas = (npad + kWarps * kTile - 1) / (kWarps * kTile);
  const auto g = static_cast<unsigned>(grid < ctas ? grid : ctas);
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ps = static_cast<const int32_t*>(pair_state);
  const auto* pm = static_cast<const int32_t*>(pair_match);
  const auto* f = static_cast<const int32_t*>(form);
  const auto* a0 = static_cast<const int32_t*>(t0);
  auto* o = static_cast<int32_t*>(out);
  if (hashed) {
    const auto* a1 = static_cast<const int32_t*>(t1);
    const auto* a2 = static_cast<const int32_t*>(t2);
    const auto* a3 = static_cast<const int32_t*>(t3);
    if (p == kSmem)
      l->set(lockstep_hash_kernel<kSmem>, g, kThreads, smem, d, n, npad, ps,
             pm, f, form_words, a0, a1, a2, a3, num_final, max_len, o);
    else
      l->set(lockstep_hash_kernel<kGlobal>, g, kThreads, smem, d, n, npad,
             ps, pm, f, form_words, a0, a1, a2, a3, num_final, max_len, o);
  } else {
    if (p == kSmem)
      l->set(lockstep_dense_kernel<kSmem>, g, kThreads, smem, d, n, npad, ps,
             pm, f, form_words, a0, num_final, max_len, o);
    else
      l->set(lockstep_dense_kernel<kGlobal>, g, kThreads, smem, d, n, npad,
             ps, pm, f, form_words, a0, num_final, max_len, o);
  }
  return cudaSuccess;
}

// As lockstep_launch, launched on `stream`; returns the cudaError_t.
extern "C" int pfac_lockstep(int device, const void* data, int64_t n,
                             int64_t npad, const void* pair_state,
                             const void* pair_match, const void* form,
                             int32_t form_words, int32_t hashed,
                             const void* t0, const void* t1, const void* t2,
                             const void* t3, int32_t num_final,
                             int32_t max_len, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::lockstep_launch(device, data, n, npad, pair_state, pair_match,
                              form, form_words, hashed, t0, t1, t2, t3,
                              num_final, max_len, out, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
