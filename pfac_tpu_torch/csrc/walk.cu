// Kernel K2, the survivor walk: replaces
// pfac_tpu/backends/pallas_walk.py::_make_walk_kernel. (K3, the dense-block
// walk, has the same walk tile-wise in block_walk.cu.)
//
// The walk of a position p probes the BIG-endian entry key
// b0<<24|b1<<16|b2<<8|b3 (descriptor row 0 -> depth-4 state; row 1 ->
// length-4 pattern ID), then steps two bytes at a time over depth-sliced
// exact tables: step s covers depth d = 4 + 2s with rows 2+3s (main:
// state<<16|b1<<8|b2 -> next state), 3+3s (odd: state<<8|b1 -> ID of a
// length-(d+1) pattern) and 4+3s (even: the main key -> ID of a
// length-(d+2) pattern). A hit at depth d needs n - p > d; the longest hit
// wins. The walk stops when the state is DEAD (no table key carries the
// DEAD index, so nothing could hit again) or the step has no main table.
//
// The kernel writes out[p] only for a match of >= 4 bytes. The sieve
// already wrote the exact depth-1..3 match at every position and a deeper
// match is always longer. (The TPU walkers recompute depths 1..3 only so
// that XLA never reads its 512 MB loop carry; that reason does not exist
// here.) Bytes come straight from the corpus, bounded by n: the TPU's
// 128-byte row-gather windows, 32-way alignment and block halos are not
// needed on this card.
//
// Bound: the bytes are a survivor's position, its few bytes and its deep
// match, well under a microsecond of device memory on any corpus here. Its
// floor is the chain of the deepest walk: a step is two dependent loads (a
// CHD's displacement, then its key and value) and the arithmetic between
// them, and a warp steps as long as its deepest lane. Design:
// * the survivor count stays on the device: the kernel reads it (the
//   compaction's total) and the positions from a buffer that may be
//   longer, so the host never waits for the count;
// * a persistent grid, one CTA an SM at the Snort tables (the grid's size
//   cached on the host, walk_common.cuh). Survivors are dealt round robin,
//   in runs of 32 consecutive ones (a warp's), over as many CTAs as there
//   are runs, at most the grid: a few thousand survivors still reach every
//   SM, and where survivors are dense a warp's position loads and result
//   stores coalesce. A CTA without a survivor returns before it stages
//   anything;
// * lanes that refill: a thread keeps its walk's position, step, state and
//   match and 32 of its bytes; one iteration of its loop does one step (the
//   entry probe counts as one), and a walk that ends writes its match and
//   takes the lane's next survivor (a stride of the CTA's lanes) at once,
//   its position loaded a walk ahead. Up to 1,024 lanes an SM, as many as
//   have a survivor: the deepest walk's chain bounds the kernel, and the
//   more warps an SM has, the more of its steps' latency they cover. (Fewer
//   warps, each lane taking several survivors from a queue, ran slower: a
//   refilled walk's first bytes come from device memory, and the whole
//   warp waits for them.) The entry and a step have one shape, so lanes at
//   different steps run the same instructions: a state probe on the key
//   state<<16|two bytes (at the entry the first two bytes stand for the
//   state, which makes the key b0..b3), a match probe on the same key
//   (entry_final, even), and at a step the odd probe on its first three
//   bytes; the three probes' slots are taken first, so a step is two
//   dependent loads deep;
// * a record a loop iteration in shared memory (backends/walk_tables.py::
//   walk_records, derived from the descriptor rows K3 reads): its three
//   probes as three 16-byte words, with the table sizes as powers of two
//   and flags, so a probe runs no branch (rec_probe). Lanes of a warp sit
//   at different steps and so probe different kinds of table (with and
//   without displacements, absent); the kernel is bound by the
//   instructions its warps issue, and a branch on the kind made a warp
//   issue each kind's path in turn. An absent probe reads a valid slot
//   and its result is ignored; a displacement load is predicated off;
// * the walk tables in the layout K3 reads too
//   (backends/walk_tables.py::pack_walk): in row order, displacements and
//   keys as 32-bit words, values as 16-bit half-words (the encoding keeps
//   every state index and ID below DEAD), each array on 16 bytes. The
//   Snort-scale set's tables are 199,856 B: they fit shared memory whole,
//   so no probe of a deep walk leaves it (32-bit values would take 260,832
//   B and leave the tables of depth >= 32 to L1/L2, where at density most
//   warps' iterations wait on a lane);
// * tables resident by depth: their first `resident` words (all of them
//   where they fit beside the records, else the longest prefix of
//   whole tables that does, backends/walk.py::launch_plan, down to none)
//   arrive in shared memory by one bulk copy while each lane fetches its
//   first survivor; a probe past the prefix reads L1/L2 (__ldg). A CTA
//   with fewer than kStageMin survivors stages nothing of split tables.
//   One kernel for tables resident whole, one for split tables;
// * a survivor's bytes by 16-byte loads from its aligned-down address, two
//   chunks in registers, the next chunk loaded as the walk enters the
//   second (walk_common.cuh::Bytes): no byte load on the dependent chain.
// * given a program's counter words, it counts its own work there: the
//   loop iterations in which a lane had a walk (walk_steps; the entry
//   counts as one, so a walk of t iterations adds t), and each warp's
//   iterations times 32 (walk_slots, the lane slots the grid spent: a warp
//   steps as long as its busiest lane). A lane sums its walks' iterations
//   in a register, its warp reduces them as it leaves the loop, and the
//   CTA adds them with one atomic each; the per-kernel entry point passes
//   null and counts nothing.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "launch.cuh"
#include "walk_common.cuh"

namespace {

constexpr uint32_t kDead = 0xFFFFu;
constexpr int kThreads = 1024;
constexpr uint32_t kFull = 0xFFFFFFFFu;
constexpr int kHeader = 16;                   // the tables' mbarrier
// A CTA with fewer survivors reads split tables through L1/L2: staging them
// (up to 227 KB) would take longer than its few walks.
constexpr int32_t kStageMin = 256;

constexpr int kRecordWords = 12;              // three probes of 4 words
constexpr uint32_t kDispBit = 1u << 16;       // walk_tables.DISP_BIT
constexpr uint32_t kPresentBit = 1u << 24;    // walk_tables.PRESENT_BIT

// A record's probe (walk_tables.walk_records), one 16-byte word: [mul,
// key_off, val_off, meta], meta = lg_b | lg_r << 8 | flags. An absent
// probe is all zeros, so it reads slot 0 of word 0, which a caller's
// present() test then ignores.
__device__ __forceinline__ bool present(const int4 r) {
  return (static_cast<uint32_t>(r.w) & kPresentBit) != 0;
}

// The key word and the value of probe r's slot for `key`, with no branch:
// every lane of a warp runs the same instructions whichever table it
// probes. With B = 2^lg_b and R = 2^lg_r, the product's top lg_b bits are
// the bucket, umulhi(prod, B), and its next lg_r bits h1, umulhi(prod * B,
// R) (probe.cuh's shifts and masks as two multiplies); a table without
// displacements has B = 1, so h1 is the slot. The displacements lie just
// before the keys, padded to 16 bytes (walk_tables.pack_walk), and are
// below R, so h1 ^ disp needs no mask.
template <class Tab>
__device__ __forceinline__ void rec_probe(const Tab& t, const int4 r,
                                          uint32_t key, uint32_t* k,
                                          uint32_t* v) {
  const uint32_t meta = static_cast<uint32_t>(r.w);
  const uint32_t b = __funnelshift_l(0u, 1u, meta);          // 2^lg_b
  const uint32_t rr = __funnelshift_l(0u, 1u, meta >> 8);    // 2^lg_r
  const uint32_t prod = key * static_cast<uint32_t>(r.x);
  uint32_t slot = __umulhi(prod * b, rr);
  uint32_t disp = 0;
  if (meta & kDispBit) disp = t[r.y - max(b, 4u) + __umulhi(prod, b)];
  slot ^= disp;
  *k = t[r.y + slot];
  *v = t.half(r.z + slot);
}

// Bytes o and o + 1 of the window as (byte o) << 8 | byte o + 1.
__device__ __forceinline__ uint32_t pair_be(const pfac::Bytes& w, uint32_t o) {
  return __byte_perm(w.word_le(o), 0, 0x4401);
}

// Dynamic shared memory, in this order (backends/walk.py::fixed_smem_bytes
// repeats its size): [kHeader: mbarrier][resident table words, to 16
// bytes][nsteps + 1 records]. The tables first: at a fixed offset a table
// word's address is its index times 4 from the base, where behind the
// records the compiler rebuilt the records' size into every one of a
// step's nine addresses. kAllResident: `resident` covers the whole tables.
// A value is read as a half-word at its probe's val_off.
template <bool kAllResident>
__global__ void __launch_bounds__(kThreads, 1)
walk_kernel(const uint8_t* __restrict__ data, int32_t n,
            const int32_t* __restrict__ pos, const int32_t* __restrict__ count,
            int32_t cap, const int32_t* __restrict__ arena, int32_t resident,
            const int32_t* __restrict__ records, int32_t nsteps,
            int32_t* __restrict__ out,
            unsigned long long* __restrict__ counters) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ unsigned long long s_count[2];    // the CTA's steps and slots
  const int32_t total = pfac::survivors(count, cap);
  const int32_t runs = (total + 31) / 32;      // of 32 consecutive survivors
  const int32_t ctas = min(static_cast<int32_t>(gridDim.x), runs);
  const int32_t bid = static_cast<int32_t>(blockIdx.x);
  if (bid >= ctas) return;                      // uniform across the CTA
  // this CTA's survivors: runs bid, bid + ctas, ...; its k-th is survivor
  // at(k), and lane tid walks k = tid, tid + kThreads, ..., so a warp walks
  // 32 consecutive survivors (its position loads and result stores
  // coalesce where survivors are dense)
  const int32_t mine = (runs - bid + ctas - 1) / ctas * 32;
  auto at = [&](int32_t k) { return (bid + (k >> 5) * ctas) * 32 + (k & 31); };
  auto has = [&](int32_t k) { return k < mine && at(k) < total; };
  if (!kAllResident && mine < kStageMin) resident = 0;
  const int tid = threadIdx.x;
  const int32_t rec_words = (nsteps + 1) * kRecordWords;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + kHeader);
  int32_t* srec = reinterpret_cast<int32_t*>(tab + ((resident + 3) & ~3));

  // 1. the tables and records on their way
  if (tid == 0) {
    pfac::mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    s_count[0] = s_count[1] = 0;
  }
  __syncthreads();
  const int32_t bulk_words = resident & ~3;
  if (tid == 0 && bulk_words > 0) {
    pfac::mbar_expect(bar, 4u * bulk_words);
    pfac::bulk_copy(tab, arena, 4u * bulk_words, bar);
  }
  for (int32_t q = bulk_words + tid; q < resident; q += kThreads)
    tab[q] = static_cast<uint32_t>(__ldg(arena + q));
  for (int32_t q = tid; q < rec_words; q += kThreads)
    srec[q] = __ldg(records + q);

  // 2. the lane's first survivor, in flight while the tables arrive;
  // p_next is the one after the current, loaded a walk ahead
  const uint8_t* end = data + n;
  pfac::Bytes w;
  int32_t k = tid, p = 0, p_next = 0, rd = 0, t = 0;
  uint32_t state = 0, match = 0;
  auto begin = [&]() {                          // walk survivor at(k) from p
    w.start(data + p, end);
    rd = n - p;
    t = 0;
    match = 0;
    state = pair_be(w, static_cast<uint32_t>((data + p) - w.at));
    if (has(k + kThreads)) p_next = __ldg(pos + at(k + kThreads));
  };
  if (has(k)) {
    p = __ldg(pos + at(k));
    begin();
  }
  __syncthreads();                              // srec, tab's last words
  const unsigned walkers = __ballot_sync(kFull, has(k));   // the warp's
  // without counters this is the CTA's last barrier
  if (!has(k) && counters == nullptr) return;
  if (has(k)) {
    if (bulk_words > 0) pfac::mbar_wait(bar, 0);
    using Tab =
        std::conditional_t<kAllResident, pfac::SmemTab, pfac::SplitTab>;
    Tab tb;
    uint32_t steps = 0;                         // the lane's iterations
    if constexpr (kAllResident) tb = Tab{tab};
    else tb = Tab{tab, arena, static_cast<uint32_t>(resident)};

    // 3. one step of the lane's walk an iteration, its probes record t's.
    // t == 0 is the entry (main: entry, no odd, even: entry_final; bytes
    // 2, 3 after the two standing in for the state); t >= 1 is step t - 1
    // (depth d)
    for (;;) {
      const int32_t d = 2 + 2 * t;
      const int4* rec = reinterpret_cast<const int4*>(srec + t * kRecordWords);
      const int4 rs = rec[0], ro = rec[1], re = rec[2];
      const uint32_t o = w.seek(data + p + d, end);
      const uint32_t mkey = (state << 16) | pair_be(w, o);
      const uint32_t okey = mkey >> 8;            // state << 8 | byte d
      const bool s_on = present(rs);              // the entry always
      const bool o_on = present(ro);              // never at the entry
      const bool e_on = s_on && present(re);      // no main: the walk ends
      uint32_t ks, vs, ko, vo, ke, ve;
      rec_probe(tb, rs, mkey, &ks, &vs);
      rec_probe(tb, ro, okey, &ko, &vo);
      rec_probe(tb, re, mkey, &ke, &ve);
      if (o_on && rd > d && ko == okey) match = vo;
      if (e_on && rd > d + 1 && ke == mkey) match = ve;
      const bool alive = s_on && rd > d + 1 && ks == mkey;
      state = alive ? vs : kDead;
      ++t;
      if (!alive || t > nsteps) {                 // the walk ends
        if (match != 0) out[p] = static_cast<int32_t>(match);
        steps += t;
        k += kThreads;
        if (!has(k)) break;
        p = p_next;
        begin();
      }
    }
    if (counters != nullptr) {
      const uint32_t sum = __reduce_add_sync(walkers, steps);
      const uint32_t most = __reduce_max_sync(walkers, steps);
      if ((tid & 31) == __ffs(walkers) - 1) {
        atomicAdd(&s_count[0], static_cast<unsigned long long>(sum));
        atomicAdd(&s_count[1], 32ull * most);
      }
    }
  }
  if (counters == nullptr) return;              // uniform
  __syncthreads();
  if (tid == 0 && s_count[0] != 0) {
    atomicAdd(counters, s_count[0]);
    atomicAdd(counters + 1, s_count[1]);
  }
}

int64_t smem_bytes(int32_t nsteps, int32_t resident) {
  return kHeader + 4LL * ((resident + 3) & ~3) +
         4LL * kRecordWords * (nsteps + 1);
}

const void* kernel_of(bool all) {
  return all ? (const void*)walk_kernel<true>
             : (const void*)walk_kernel<false>;
}

}  // namespace

// data: uint8[>= n], any alignment; pos: int32[cap], the first
// min(*count, cap) of them walked (count: a device int32, or null for all
// cap), each < n; out: int32[>= n]; arena: the walk tables
// (backends/walk_tables.py::pack_walk), int32[words], 16-byte aligned, its
// first `resident` words (any prefix, 0 included) staged in shared memory;
// records: int32[nsteps + 1][12], their K2 records
// (backends/walk_tables.py::walk_records);
// counters: int64[2] the walk steps and the lane slots are added to, or
// null. Else cudaErrorInvalidValue; a
// prefix that does not fit shared memory fails the launch. One launch,
// whatever the count.
cudaError_t pfac::walk_launch(int device, const void* data, int32_t n,
                              const void* pos, const void* count, int32_t cap,
                              const void* arena, int32_t words,
                              int32_t resident, const void* records,
                              int32_t nsteps, void* out, void* counters,
                              Launch* l) {
  *l = Launch{};
  if (n < 0 || cap < 0 || nsteps < 0 || resident < 0 || resident > words ||
      reinterpret_cast<uintptr_t>(arena) % 16 != 0)
    return cudaErrorInvalidValue;
  const bool all = resident == words;
  const int64_t smem = smem_bytes(nsteps, resident);
  int64_t grid;
  cudaError_t err = pfac::persistent_grid(kernel_of(all), kThreads, device,
                                          smem, &grid);
  if (err != cudaSuccess) return err;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* c = static_cast<const int32_t*>(count);
  const auto* a = static_cast<const int32_t*>(arena);
  const auto* rs = static_cast<const int32_t*>(records);
  auto* o = static_cast<int32_t*>(out);
  auto* ct = static_cast<unsigned long long*>(counters);
  const auto g = static_cast<unsigned>(grid);
  if (all)
    l->set(walk_kernel<true>, g, kThreads, smem, d, n, ps, c, cap, a,
           resident, rs, nsteps, o, ct);
  else
    l->set(walk_kernel<false>, g, kThreads, smem, d, n, ps, c, cap, a,
           resident, rs, nsteps, o, ct);
  return cudaSuccess;
}

// As walk_launch, counting nothing; launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int pfac_walk(int device, const void* data, int32_t n,
                         const void* pos, const void* count, int32_t cap,
                         const void* arena, int32_t words, int32_t resident,
                         const void* records, int32_t nsteps, void* out,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::walk_launch(device, data, n, pos, count, cap, arena, words,
                          resident, records, nsteps, out, nullptr, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}

// The persistent grid pfac_walk launches for these tables into *grid
// (int64). Returns a cudaError_t.
extern "C" int pfac_walk_grid(int device, int32_t nsteps, int32_t resident,
                              int32_t words, void* grid) {
  if (nsteps < 0 || resident < 0 || resident > words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(pfac::persistent_grid(
      kernel_of(resident == words), kThreads, device,
      smem_bytes(nsteps, resident), static_cast<int64_t*>(grid)));
}
