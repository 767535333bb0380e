// Kernel K3, the dense-block walk: replaces
// pfac_tpu/backends/pallas_sieve.py::build_block_walk (walk body
// pallas_walk.py::emit_block_walk).
//
// A block of `block` positions is dense when the sieve counted at least
// `thresh` survivors in it (counts[b], written by K1). Every position of a
// dense block is walked to full depth as K2 walks a survivor (walk.cu has
// the key conventions: BIG-endian entry key, two bytes a step over
// depth-sliced exact tables, a hit at depth d needs n - p > d, the longest
// hit wins) and its match of >= 4 bytes is written into K1's result in
// place; out[p] is written only where there is one and never read. The
// compaction (compact.cu) reads the same counts and threshold and skips the
// block, so no survivor is walked twice.
//
// Bound: device memory, the dense blocks' bytes read once and their deep
// matches written once (all-match: 1 byte in, 4 bytes out per position).
// What stands in the way is the number of loads issued: a walk probes two
// entry tables and up to three tables a step, each probe two or three
// dependent words, and a byte fetched by a load of its own costs as much as
// a word. Design:
// * a persistent grid, as many CTAs as the SMs hold. Every CTA scans the
//   per-block counts (a few KB), numbers the dense blocks' 8,192-position
//   tiles and takes those whose number is its blockIdx modulo the grid: no
//   host round trip, no counter to zero, and a corpus without a dense block
//   costs one pass of the grid over the counts;
// * the corpus tile (8,192 bytes and the walk's lookahead, 4 + 2 * nsteps
//   rounded up to 16) arrives in shared memory by one asynchronous bulk
//   copy (cp.async.bulk on an mbarrier), double-buffered: the next tile's
//   copy runs while this tile is walked. The copy needs 16-byte-aligned
//   addresses and sizes, so the source is aligned down and the tile carries
//   the offset; a tile whose aligned range would leave [data, data + n)
//   (the first of a misaligned view, the last ones before n) is copied by
//   the threads instead, bytes at and past n as 0;
// * a thread takes 16 consecutive positions, kBatch at a time: 4 words of
//   shared memory give a batch's 11 bytes, its entry keys come from funnel
//   shifts and a byte permute, and each step's two bytes per position from
//   4 more words;
// * the descriptor rows are staged once per CTA in shared memory;
// * tables resident by depth: the walk tables K2 reads
//   (backends/walk_tables.py::pack_walk: keys and displacements in words,
//   values in 16-bit half-words, walk_common.cuh::walk_val) are laid out in
//   row order (entry, entry_final, then each step's main, odd, even), and
//   their first `resident` words (the host picks the longest prefix of
//   whole tables that fits, backends/walk.py::resident_words, down to none
//   when not even the entry table fits) are staged in shared memory by bulk
//   copy; a probe reads word i from there when i < resident, else through
//   L1/L2 (__ldg);
// * probes go kBatch positions at a time, stage by stage (all slots, then
//   all keys and values), so a thread keeps kBatch independent loads in
//   flight; a dead position's key carries the DEAD index, which no table
//   holds, so it needs no branch. A dead position still costs its probes,
//   so the batch steps on only while two or more of it are alive: the last
//   one alive (a long pattern among short ones) walks on alone
//   (walk_tail), and a ruleset without steps (every pattern 4 bytes) skips
//   the entry-state probe, whose result nothing reads;
// * one kernel for tables resident whole (no test per table word) and one
//   for split tables;
// * results are staged per warp in shared memory with K1's XOR swizzle and
//   leave as 128-byte warp stores, each word predicated on match != 0;
// * the grid size (an occupancy query) and the shared-memory attribute are
//   cached on the host per device and shared-memory size
//   (walk_common.cuh, shared with K2 and the CSR walk);
// * given a program's counter words, it counts its own work there: the
//   exact-table probes it issued (block_walk_probes: kBatch a batched
//   probe, a dead position's included, and one a probe of walk_tail) and
//   the positions below n of the tiles it walked (block_walk_positions).
//   A thread sums its probes in a register; a CTA that walked a tile adds
//   both with one atomic each, so a corpus without a dense block pays
//   nothing more. The per-kernel entry point passes null and counts
//   nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "probe.cuh"
#include "walk_common.cuh"

namespace {

constexpr uint32_t kDead = 0xFFFFu;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                      // positions per thread
constexpr int kBatch = 8;                     // positions probed together
constexpr int kChunk = kThreads * kPer;       // positions per tile: 8,192
constexpr int kWarpPos = 32 * kPer;
constexpr int kHeader = 32;                   // three mbarriers, the probes
constexpr int kTilePad = 32;                  // alignment offset + over-read

using pfac::bulk_copy;
using pfac::mbar_expect;
using pfac::mbar_init;
using pfac::mbar_wait;
using pfac::smem_probe;
using pfac::SmemTab;
using pfac::SplitTab;

// W little-endian words of the tile's bytes from byte offset `off` on.
template <int W>
__device__ __forceinline__ void window(const uint32_t* tile32, int32_t off,
                                       uint32_t (&v)[W]) {
  const uint32_t* w = tile32 + (off >> 2);
  const uint32_t sh = static_cast<uint32_t>(off & 3) * 8;
  uint32_t lo = w[0];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const uint32_t hi = w[k + 1];
    v[k] = __funnelshift_r(lo, hi, sh);
    lo = hi;
  }
}

// Exact probe of kBatch keys: every slot first, then every key and value.
template <class Tab>
__device__ __forceinline__ void probe_batch(const Tab& t,
                                            const pfac::Probe& p,
                                            const uint32_t (&key)[kBatch],
                                            uint32_t (&val)[kBatch],
                                            bool (&hit)[kBatch]) {
  uint32_t sl[kBatch];
  if (p.disp_off < 0) {           // uniform; probe_slot's own test folds
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sl[j] = pfac::probe_slot(t, p, key[j]);
  } else {
#pragma unroll
    for (int j = 0; j < kBatch; ++j) sl[j] = pfac::probe_slot(t, p, key[j]);
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    val[j] = pfac::walk_val(t, p, sl[j]);
    hit[j] = pfac::walk_key(t, p, sl[j]) == key[j];
  }
}

// One position's walk from step `st` on, as walk.cu's walk_position steps:
// `state` its live state, `match` its longest match so far, `bytes` its
// first byte in the tile, rd = n - position. -> (the longest match, the
// probes issued). A step's three probes are independent, so their slots are
// taken first: a step is two dependent loads deep.
template <class Tab>
__device__ __noinline__ uint2 walk_tail(Tab t, const int32_t* sdesc,
                                        int32_t nsteps, int32_t st,
                                        uint32_t state, uint32_t match,
                                        const uint8_t* bytes, int32_t rd) {
  uint32_t probes = 0;
  for (; st < nsteps && state != kDead; ++st) {
    const int32_t d = 4 + 2 * st;
    const pfac::Probe main = smem_probe(sdesc, 2 + 3 * st);
    const pfac::Probe odd = smem_probe(sdesc, 3 + 3 * st);
    const pfac::Probe even = smem_probe(sdesc, 4 + 3 * st);
    const uint32_t mkey = (state << 16) | (static_cast<uint32_t>(bytes[d]) << 8) |
                          bytes[d + 1];
    const uint32_t okey = mkey >> 8;              // state << 8 | byte d
    uint32_t so = 0, sm = 0, se = 0;
    if (odd.present) so = pfac::probe_slot(t, odd, okey);
    if (main.present) sm = pfac::probe_slot(t, main, mkey);
    if (even.present) se = pfac::probe_slot(t, even, mkey);
    probes += (odd.present != 0) + (main.present != 0) + (even.present != 0);
    if (odd.present && rd > d && pfac::walk_key(t, odd, so) == okey)
      match = pfac::walk_val(t, odd, so);
    if (!main.present) break;
    const bool hit = rd > d + 1 && pfac::walk_key(t, main, sm) == mkey;
    const uint32_t next = pfac::walk_val(t, main, sm);
    if (even.present && rd > d + 1 && pfac::walk_key(t, even, se) == mkey)
      match = pfac::walk_val(t, even, se);
    state = hit ? next : kDead;
  }
  return make_uint2(match, probes);
}

// kBatch consecutive positions whose first byte is the tile's byte `off`;
// rd = n - (first position) (may be <= 0). match[j]: ID of the longest
// match of >= 4 bytes at position j, else 0. The steps go batched while at
// least two of the positions are alive: a dead one still costs its probes
// there. The last one alive (a long pattern among short ones) goes on
// alone in walk_tail(). Adds the probes it issued to `probes`.
template <class Tab>
__device__ __forceinline__ void walk_batch(
    const Tab& t, const pfac::Probe& entry, const pfac::Probe& entry_final,
    const int32_t* sdesc, int32_t nsteps, const uint32_t* tile32, int32_t off,
    int32_t rd, uint32_t (&match)[kBatch], uint32_t& probes) {
  constexpr int kWin = kBatch / 4 + 1;    // words holding kBatch + 3 bytes
  uint32_t v[kWin], key[kBatch], val[kBatch], state[kBatch];
  bool hit[kBatch];
  window<kWin>(tile32, off, v);
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const int q = j >> 2, r = j & 3;
    const uint32_t le = r == 0 ? v[q] : __funnelshift_r(v[q], v[q + 1], 8 * r);
    key[j] = __byte_perm(le, 0, 0x0123);          // big-endian b0 b1 b2 b3
  }
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    state[j] = kDead;
    match[j] = 0;
  }
  if (nsteps > 0) {                 // without steps no one reads the state
    probe_batch(t, entry, key, val, hit);
    probes += kBatch;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (hit[j] && rd - j > 3) state[j] = val[j];
  }
  if (entry_final.present) {
    probe_batch(t, entry_final, key, val, hit);
    probes += kBatch;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (hit[j] && rd - j > 3) match[j] = val[j];
  }
  int32_t st = 0;
  for (; st < nsteps; ++st) {
    int alive_count = 0;
#pragma unroll
    for (int j = 0; j < kBatch; ++j) alive_count += state[j] != kDead;
    if (alive_count < 2) break;
    const int32_t d = 4 + 2 * st;
    const pfac::Probe main = smem_probe(sdesc, 2 + 3 * st);
    const pfac::Probe odd = smem_probe(sdesc, 3 + 3 * st);
    const pfac::Probe even = smem_probe(sdesc, 4 + 3 * st);
    window<kWin>(tile32, off + d, v);             // bytes d .. d + kBatch
    uint32_t c1[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      c1[j] = (v[j >> 2] >> (8 * (j & 3))) & 0xFFu;
    if (odd.present) {
#pragma unroll
      for (int j = 0; j < kBatch; ++j) key[j] = (state[j] << 8) | c1[j];
      probe_batch(t, odd, key, val, hit);
      probes += kBatch;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (hit[j] && state[j] != kDead && rd - j > d) match[j] = val[j];
    }
    if (!main.present) {            // no deeper state exists
      st = nsteps;
      break;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const uint32_t c2 = (v[(j + 1) >> 2] >> (8 * ((j + 1) & 3))) & 0xFFu;
      key[j] = (state[j] << 16) | (c1[j] << 8) | c2;
    }
    uint32_t next[kBatch];
    bool alive[kBatch];
    probe_batch(t, main, key, next, alive);
    probes += kBatch;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      alive[j] = alive[j] && state[j] != kDead && rd - j > d + 1;
    if (even.present) {
      probe_batch(t, even, key, val, hit);
      probes += kBatch;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (hit[j] && state[j] != kDead && rd - j > d + 1) match[j] = val[j];
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) state[j] = alive[j] ? next[j] : kDead;
  }
  if (st >= nsteps) return;         // uniform where the walk has no steps
  int last = -1;                    // the one position still alive, if any
  uint32_t last_state = kDead, last_match = 0;
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    if (state[j] != kDead) {
      last = j;
      last_state = state[j];
      last_match = match[j];
    }
  }
  if (last >= 0) {
    const uint2 tail = walk_tail(
        t, sdesc, nsteps, st, last_state, last_match,
        reinterpret_cast<const uint8_t*>(tile32) + off + last, rd - last);
    last_match = tail.x;
    probes += tail.y;
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (j == last) match[j] = last_match;
  }
}

// Dynamic shared memory, in this order (backends/block_walk.py::
// fixed_smem_bytes repeats it): [kHeader: mbarriers, the CTA's probes][2
// tiles of kChunk + look + kTilePad bytes][kWarps * 512 staging words][desc
// rows][cap tile numbers][resident table words]. kAllResident: `resident` covers the
// whole tables, and every probe reads shared memory without a test.
// counters: int64[2], the probes and the positions walked, or null.
template <bool kAllResident>
__global__ void __launch_bounds__(kThreads)
block_walk_kernel(const uint8_t* __restrict__ data, int32_t n,
                  const int32_t* __restrict__ counts, int32_t nblocks,
                  int32_t block, int32_t thresh,
                  const int32_t* __restrict__ arena, int32_t resident,
                  const int32_t* __restrict__ desc, int32_t nsteps,
                  int32_t look, int32_t cap, int32_t* __restrict__ out,
                  unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int32_t s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int32_t tile_bytes = kChunk + look + kTilePad;
  const int32_t nrows = 2 + 3 * nsteps;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // tile 0, tile 1, tables
  // the CTA's probes, in the header's last word (no static shared memory:
  // the tables' prefix may fill the rest)
  auto* cta_probes = reinterpret_cast<unsigned long long*>(bars + 3);
  uint8_t* tiles = smem + kHeader;
  uint32_t* stage_bufs = reinterpret_cast<uint32_t*>(tiles + 2 * tile_bytes);
  int32_t* sdesc = reinterpret_cast<int32_t*>(stage_bufs + kWarps * kWarpPos);
  int32_t* list = sdesc + nrows * pfac::kDescWords;
  uint32_t* tab = reinterpret_cast<uint32_t*>(list + cap);

  // 1. number the dense blocks' tiles; keep those of this CTA. A dense
  // block's tiles at and past n are numbered too and skipped when met.
  const int32_t cpb = block / kChunk;
  int32_t dense_before = 0;
  for (int32_t b0 = 0; b0 < nblocks; b0 += kThreads) {
    const int32_t b = b0 + tid;
    const bool dense = b < nblocks && __ldg(counts + b) >= thresh;
    const uint32_t bal = __ballot_sync(kFull, dense);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int32_t rank = dense_before + __popc(bal & ((1u << lane) - 1u));
    int32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int32_t c = s_warp[w];
      if (w < warp) rank += c;
      total += c;
    }
    if (dense) {
      for (int32_t c = 0; c < cpb; ++c) {
        const int32_t tnum = rank * cpb + c;
        if (tnum % static_cast<int32_t>(gridDim.x) ==
            static_cast<int32_t>(blockIdx.x))
          list[tnum / static_cast<int32_t>(gridDim.x)] = b * cpb + c;
      }
    }
    dense_before += total;
    __syncthreads();
  }
  const int32_t ntiles = dense_before * cpb;
  const int32_t bid = static_cast<int32_t>(blockIdx.x);
  const int32_t grid = static_cast<int32_t>(gridDim.x);
  const int32_t mine = ntiles > bid ? (ntiles - bid + grid - 1) / grid : 0;
  if (mine == 0) return;                        // uniform across the CTA

  // 2. barriers, tables and descriptors
  if (tid == 0) {
    mbar_init(bars + 0);
    mbar_init(bars + 1);
    mbar_init(bars + 2);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    *cta_probes = 0;
  }
  __syncthreads();
  const int32_t bulk_words = resident & ~3;
  if (tid == 0 && bulk_words > 0) {
    mbar_expect(bars + 2, 4u * bulk_words);
    bulk_copy(tab, arena, 4u * bulk_words, bars + 2);
  }
  for (int32_t i = bulk_words + tid; i < resident; i += kThreads)
    tab[i] = static_cast<uint32_t>(__ldg(arena + i));
  for (int32_t i = tid; i < nrows * pfac::kDescWords; i += kThreads)
    sdesc[i] = __ldg(desc + i);

  // the tile's bytes start at its byte `a`: the source is aligned down
  const int32_t a = static_cast<int32_t>(reinterpret_cast<uintptr_t>(data) & 15);
  const uint32_t bulk_len = static_cast<uint32_t>((a + kChunk + look + 15) & ~15);
  // Bring tile number `tn` into buffer `buf`: by bulk copy where its
  // aligned range lies inside [data, data + n), else by the threads (bytes
  // at and past n as 0); nothing for a tile at or past n. -> whether the
  // bulk copy was taken (uniform).
  auto bulk_ok = [&](int32_t tn) -> bool {
    const int64_t c0 = static_cast<int64_t>(tn) * kChunk;
    return (c0 > 0 || a == 0) && c0 - a + bulk_len <= n;
  };
  auto fetch = [&](int32_t tn, int buf) {
    const int64_t c0 = static_cast<int64_t>(tn) * kChunk;
    if (c0 >= n) return;
    uint8_t* dst = tiles + buf * tile_bytes;
    if (bulk_ok(tn)) {
      if (tid == 0) {
        mbar_expect(bars + buf, bulk_len);
        bulk_copy(dst, data + c0 - a, bulk_len, bars + buf);
      }
    } else {
      for (int32_t i = tid; i < kChunk + look; i += kThreads)
        dst[a + i] = c0 + i < n ? __ldg(data + c0 + i) : uint8_t{0};
      // these writes come before a later bulk copy into this buffer
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
  };

  fetch(list[0], 0);
  __syncthreads();                              // sdesc, tab's last words
  const pfac::Probe entry = smem_probe(sdesc, 0);
  const pfac::Probe entry_final = smem_probe(sdesc, 1);
  using Tab = std::conditional_t<kAllResident, SmemTab, SplitTab>;
  Tab t;
  if constexpr (kAllResident) t = Tab{tab};
  else t = Tab{tab, arena, static_cast<uint32_t>(resident)};
  if (bulk_words > 0) mbar_wait(bars + 2, 0);

  // 3. the tiles
  uint32_t* stage_buf = stage_bufs + warp * kWarpPos;
  const int swz = (lane >> 1) & 15;
  uint32_t parity = 0;                          // bit b: buffer b's phase
  uint32_t probes = 0;                          // the thread's
  int64_t walked = 0;                           // positions < n, the CTA's
  for (int32_t i = 0; i < mine; ++i) {
    const int buf = i & 1;
    // every thread is done with tile i - 1: its buffer may be refilled;
    // the threads' own copy of tile i (made during tile i - 1) is visible
    __syncthreads();
    if (i + 1 < mine) fetch(list[i + 1], buf ^ 1);
    const int32_t tn = list[i];
    const int64_t c0 = static_cast<int64_t>(tn) * kChunk;
    if (c0 >= n) continue;
    if (bulk_ok(tn)) {
      mbar_wait(bars + buf, (parity >> buf) & 1u);
      parity ^= 1u << buf;
    }
    const uint32_t* tile32 =
        reinterpret_cast<const uint32_t*>(tiles + buf * tile_bytes);
    const int32_t lp = tid * kPer;              // first position in the tile
    const int32_t rd = static_cast<int32_t>(n - c0) - lp;
    walked += n - c0 < kChunk ? n - c0 : kChunk;
#pragma unroll
    for (int j0 = 0; j0 < kPer; j0 += kBatch) {
      uint32_t m[kBatch];
      walk_batch(t, entry, entry_final, sdesc, nsteps, tile32, a + lp + j0,
                 rd - j0, m, probes);
#pragma unroll
      for (int j = 0; j < kBatch; ++j)   // row `lane`, column (j0 + j) ^ swz
        stage_buf[lane * kPer + ((j0 + j) ^ swz)] = m[j];
    }
    __syncwarp();
    // word k * 32 + lane of the warp's 512 is row 2k + lane / 16, column
    // lane % 16, stored at column (lane % 16) ^ k: 32 distinct banks
    int32_t* dst = out + c0 + warp * kWarpPos;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t mv =
          stage_buf[(2 * k + (lane >> 4)) * kPer + ((lane & 15) ^ k)];
      if (mv != 0) dst[k * 32 + lane] = static_cast<int32_t>(mv);
    }
  }
  if (counters == nullptr || walked == 0) return;   // uniform
  unsigned long long sum = probes;
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_down_sync(kFull, sum, s);
  if (lane == 0) atomicAdd(cta_probes, sum);
  __syncthreads();
  if (tid == 0) {
    atomicAdd(counters, *cta_probes);
    atomicAdd(counters + 1, static_cast<unsigned long long>(walked));
  }
}

int64_t smem_bytes(int32_t nsteps, int32_t look, int32_t cap,
                   int32_t resident) {
  return kHeader + 2LL * (kChunk + look + kTilePad) + 4LL * kWarps * kWarpPos +
         4LL * pfac::kDescWords * (2 + 3 * nsteps) + 4LL * cap + 4LL * resident;
}

}  // namespace

// data: uint8[>= n], any alignment; counts: int32[nblocks] (K1's survivors
// per block); out: int32[>= nblocks * block]; block % 8192 == 0; arena: the
// walk tables (backends/walk_tables.py::pack_walk), 16-byte aligned, its
// first `resident` words staged in shared memory (any prefix, 0 included:
// the words past it are read through L1/L2); `words` the arena's length
// (resident <= words); desc: 2 + 3 * nsteps rows (values' offsets in
// half-words); look: the walk's lookahead in bytes, a multiple of 16, >= 4
// + 2 * nsteps; cap: room for a CTA's tile numbers, a multiple of 4, cap *
// SMs >= nblocks * block / 8192; counters: int64[2] the probes and the
// positions walked are added to, or null. Else cudaErrorInvalidValue; a
// prefix that does not fit shared memory fails the launch.
cudaError_t pfac::block_walk_launch(int device, const void* data, int32_t n,
                                    const void* counts, int32_t nblocks,
                                    int32_t block, int32_t thresh,
                                    const void* arena, int32_t words,
                                    int32_t resident, const void* desc,
                                    int32_t nsteps, int32_t look, int32_t cap,
                                    void* out, void* counters, Launch* l) {
  *l = Launch{};
  if (resident > words || block <= 0 || block % kChunk != 0 || nblocks < 0 || n < 0 ||
      nsteps < 0 || resident < 0 || cap < 4 || cap % 4 != 0 || look % 16 != 0 ||
      look < 4 + 2 * nsteps || reinterpret_cast<uintptr_t>(arena) % 16 != 0)
    return cudaErrorInvalidValue;
  if (nblocks == 0) return cudaSuccess;
  const int64_t smem = smem_bytes(nsteps, look, cap, resident);
  int64_t grid;
  const bool all = resident == words;
  cudaError_t err = pfac::persistent_grid(
      all ? (const void*)block_walk_kernel<true>
          : (const void*)block_walk_kernel<false>,
      kThreads, device, smem, &grid);
  if (err != cudaSuccess) return err;
  const int64_t tiles = static_cast<int64_t>(nblocks) * (block / kChunk);
  if (grid > tiles) grid = tiles;
  if (cap * grid < tiles) return cudaErrorInvalidValue;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* c = static_cast<const int32_t*>(counts);
  const auto* a = static_cast<const int32_t*>(arena);
  const auto* ds = static_cast<const int32_t*>(desc);
  auto* o = static_cast<int32_t*>(out);
  auto* ct = static_cast<unsigned long long*>(counters);
  const auto g = static_cast<unsigned>(grid);
  if (all)
    l->set(block_walk_kernel<true>, g, kThreads, smem, d, n, c, nblocks,
           block, thresh, a, resident, ds, nsteps, look, cap, o, ct);
  else
    l->set(block_walk_kernel<false>, g, kThreads, smem, d, n, c, nblocks,
           block, thresh, a, resident, ds, nsteps, look, cap, o, ct);
  return cudaSuccess;
}

// As block_walk_launch, counting nothing; launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int pfac_block_walk(int device, const void* data, int32_t n,
                               const void* counts, int32_t nblocks,
                               int32_t block, int32_t thresh,
                               const void* arena, int32_t words,
                               int32_t resident, const void* desc,
                               int32_t nsteps, int32_t look, int32_t cap,
                               void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::block_walk_launch(device, data, n, counts, nblocks, block,
                                thresh, arena, words, resident, desc, nsteps,
                                look, cap, out, nullptr, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
