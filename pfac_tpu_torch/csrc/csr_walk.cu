// The CSR walk: replaces pfac_tpu/backends/pallas_walk.py::_make_align_kernel
// (K4) together with the XLA CSR walk around it
// (pfac_tpu/backends/xla_csr.py::_entry_probe, _probe_step; the kernel
// computes what xla_csr.csr_oracle_walk computes, bit for bit).
//
// K4 only word-aligns each survivor's bytes, gathered in 128-byte rows,
// for the XLA walk. Here a thread reads a survivor's bytes straight from
// the corpus (bounded by n), so alignment disappears and the kernel is the
// walk itself:
//
// * Entry: key4 = b0<<24|b1<<16|b2<<8|b3 (big-endian); bucket =
//   (key4 * kEntryMul mod 2^32) >> (32 - lgb); scan the bucket row's
//   `width` triples (key, meta, pid). A hit needs meta>>28 == 1 and an
//   equal key: state = meta & kNextMask, match = pid when pid != 0.
// * Steps at depth d = 4, 8, ... while state != 0: scan row `state` of the
//   step and at most `chain` continuation rows (klen == 0, next != 0 names
//   the row). A triple hits when its key equals the big-endian klen-byte
//   window at p + d, 1 <= klen <= 4 and n - p >= d + klen. Among hits with
//   pid != 0 the largest klen wins, a later triple on a tie; the next
//   state comes from a klen == 4 hit with next != 0.
// * It writes out[p] only for a match (>= 4 bytes): the sieve already
//   wrote the exact depth-1..3 match.
//
// Descriptor rows (4 int32 each): row 0 = [entry offset, lgb, width, 0]
// (width a multiple of 4, so a bucket row is whole 16-byte words:
// backends/csr_tables.py pads it); row 1 + s = [word offset, row count,
// depth, chain] of step s. Keys are compared as uint32.
//
// Bound: the bytes are a survivor's position, its bytes and its match, well
// under a microsecond; what bounds the kernel is the chain of its deepest
// walk, one dependent 96-byte row load a step (a bucket row at the entry)
// from tables of ~170 MB for a 100K-pattern set, which miss the 50 MB L2
// by design: about 50 DRAM latencies for a 200-byte signature. Design:
// * the survivor count stays on the device: the kernel reads it (the
//   compaction's total) and the positions from a buffer that may be
//   longer, so the host never waits for the count;
// * a persistent grid over every SM (the grid's size cached on the host,
//   walk_common.cuh), survivors dealt round robin over all its CTAs in
//   runs of 32 consecutive ones (a warp's): a few thousand survivors keep
//   every SM busy, and where survivors are dense a warp's position loads
//   and result stores coalesce; a CTA without a survivor returns at once;
// * lanes that refill: a thread keeps its walk's position, step, row,
//   state and match and 32 of its bytes; one iteration of its loop loads
//   and scans one row (the entry's bucket row counts as one, a
//   continuation row as another), and a walk that ends writes its match and
//   takes the thread's next survivor at once, so no lane waits for the
//   deepest walk of its warp while survivors are left. Every iteration
//   loads its row the same way, as up to six 16-byte words issued
//   together;
// * the descriptor rows in shared memory, a row one 16-byte word;
// * a survivor's bytes by 16-byte loads from its aligned-down address, two
//   chunks in registers, the next chunk loaded as the walk enters the
//   second (walk_common.cuh::Bytes): no byte load on the dependent chain.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"
#include "walk_common.cuh"

namespace {

constexpr uint32_t kEntryMul = 0x9E3779B1u;    // xla_csr.ENTRY_MUL
constexpr uint32_t kNextMask = 0x0FFFFFFFu;
constexpr int kW = 8;                          // xla_csr.W_ENTRIES
constexpr int kRowWords = 3 * kW;
constexpr int kRowVecs = kRowWords / 4;        // 16-byte words a row
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
csr_walk_kernel(const uint8_t* __restrict__ data, int32_t n,
                const int32_t* __restrict__ pos,
                const int32_t* __restrict__ count, int32_t cap,
                const int32_t* __restrict__ arena,
                const int4* __restrict__ desc, int32_t nsteps,
                int32_t* __restrict__ out) {
  extern __shared__ int4 sdesc[];               // 1 + nsteps rows
  const int32_t total = pfac::survivors(count, cap);
  const int32_t runs = (total + 31) / 32;      // of 32 consecutive survivors
  const int32_t grid = static_cast<int32_t>(gridDim.x);
  const int32_t bid = static_cast<int32_t>(blockIdx.x);
  if (bid >= runs) return;                      // uniform across the CTA
  const int tid = threadIdx.x;
  for (int32_t k = tid; k <= nsteps; k += kThreads) sdesc[k] = __ldg(desc + k);

  // this CTA's survivors: runs bid, bid + grid, ...; its k-th is survivor
  // at(k), and lane tid walks k = tid, tid + kThreads, ..., so a warp walks
  // 32 consecutive survivors; p_next is the lane's next, loaded a walk ahead
  const int32_t mine = (runs - bid + grid - 1) / grid * 32;
  auto at = [&](int32_t k) { return (bid + (k >> 5) * grid) * 32 + (k & 31); };
  auto has = [&](int32_t k) { return k < mine && at(k) < total; };
  int32_t k = tid;
  const uint8_t* end = data + n;
  pfac::Bytes w;
  int32_t p = 0, p_next = 0, rd = 0;
  int32_t s = -1, c = 0;        // step (-1: the entry); chain row or chunk
  uint32_t cur = 0, state = 0, match = 0, best_k = 0, best_pid = 0, nxt = 0;
  auto begin = [&]() {                          // walk survivor at(k) from p
    w.start(data + p, end);
    rd = n - p;
    s = -1;
    c = 0;
    match = 0;
    if (has(k + kThreads)) p_next = __ldg(pos + at(k + kThreads));
  };
  if (has(k)) {
    p = __ldg(pos + at(k));
    begin();
  }
  __syncthreads();                              // sdesc
  if (!has(k)) return;
  const int4 e = sdesc[0];                      // entry offset, lgb, width
  const int32_t width = e.z;

  for (;;) {
    // this iteration's row: `ntrip` triples at word `row`
    uint32_t key;                               // key4, or the step's word
    int64_t row = 0;
    int32_t ntrip = 0;
    int4 sd = make_int4(0, 0, 0, 0);
    if (s < 0) {
      key = __byte_perm(w.word_le(w.seek(data + p, end)), 0, 0x0123);
      const uint32_t bk = (key * kEntryMul) >> (32 - e.y);
      row = e.x + static_cast<int64_t>(bk) * 3 * width + kRowWords * c;
      ntrip = rd < 4 ? 0 : min(kW, width - kW * c);
    } else {
      sd = sdesc[1 + s];                        // offset, rows, depth, chain
      key = __byte_perm(w.word_le(w.seek(data + p + sd.z, end)), 0, 0x0123);
      row = sd.x + static_cast<int64_t>(cur) * kRowWords;
      ntrip = cur != 0 && cur < static_cast<uint32_t>(sd.y) ? kW : 0;
    }
    const int4* r4 = reinterpret_cast<const int4*>(arena + row);
    uint32_t wd[kRowWords];
#pragma unroll
    for (int q = 0; q < kRowVecs; ++q) {
      const int4 v = 4 * q < 3 * ntrip ? __ldg(r4 + q) : make_int4(0, 0, 0, 0);
      wd[4 * q + 0] = static_cast<uint32_t>(v.x);
      wd[4 * q + 1] = static_cast<uint32_t>(v.y);
      wd[4 * q + 2] = static_cast<uint32_t>(v.z);
      wd[4 * q + 3] = static_cast<uint32_t>(v.w);
    }
    bool done = false;
    if (s < 0) {                                // the entry: first hit wins
      bool found = false;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const uint32_t meta = wd[3 * j + 1], pid = wd[3 * j + 2];
        if (!found && j < ntrip && (meta >> 28) == 1u && wd[3 * j] == key) {
          found = true;
          state = meta & kNextMask;
          if (pid != 0) match = pid;
        }
      }
      if (found || ntrip < kW || kW * (c + 1) >= width) {
        if (!found) state = 0;
        s = 0;
        c = 0;
        cur = state;
        best_k = best_pid = nxt = 0;
        done = state == 0 || nsteps == 0;
      } else {
        ++c;                                    // the bucket's next 8 triples
      }
    } else {                                    // row `cur` of step s
      const int32_t d = sd.z;
      uint32_t cont = 0;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const uint32_t tk = wd[3 * j], meta = wd[3 * j + 1];
        const uint32_t pid = wd[3 * j + 2];
        const uint32_t klen = meta >> 28, next = meta & kNextMask;
        if (klen == 0) {
          if (next != 0) cont = next;
          continue;
        }
        if (klen > 4 || rd < d + static_cast<int32_t>(klen)) continue;
        if ((key >> (8 * (4 - klen))) != tk) continue;
        if (pid != 0 && klen >= best_k) {
          best_k = klen;
          best_pid = pid;
        }
        if (klen == 4 && next != 0) nxt = next;
      }
      if (cont != 0 && cont < static_cast<uint32_t>(sd.y) && c < sd.w) {
        cur = cont;                             // a continuation row
        ++c;
      } else {                                  // the step is done
        if (best_pid != 0) match = best_pid;
        state = nxt;
        ++s;
        cur = state;
        c = 0;
        best_k = best_pid = nxt = 0;
        done = state == 0 || s == nsteps;
      }
    }
    if (done) {                                 // the walk ends
      if (match != 0) out[p] = static_cast<int32_t>(match);
      k += kThreads;
      if (!has(k)) break;
      p = p_next;
      begin();
    }
  }
}

}  // namespace

// data: uint8[>= n], any alignment; pos: int32[cap], the first
// min(*count, cap) of them walked (count: a device int32, or null for all
// cap), each < n; out: int32[>= n]; arena: int32, 16-byte aligned, every
// step offset and the entry row's width a multiple of 4 words; desc: 1 +
// nsteps rows of 4 int32, 16-byte aligned. Else cudaErrorInvalidValue. One
// launch, whatever the count.
cudaError_t pfac::csr_walk_launch(int device, const void* data, int32_t n,
                                  const void* pos, const void* count,
                                  int32_t cap, const void* arena,
                                  const void* desc, int32_t nsteps, void* out,
                                  Launch* l) {
  *l = Launch{};
  if (n < 0 || cap < 0 || nsteps < 0 ||
      reinterpret_cast<uintptr_t>(arena) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(desc) % 16 != 0)
    return cudaErrorInvalidValue;
  const int64_t smem = 16LL * (1 + nsteps);
  int64_t grid;
  cudaError_t err = pfac::persistent_grid((const void*)csr_walk_kernel,
                                          kThreads, device, smem, &grid);
  if (err != cudaSuccess) return err;
  l->set(csr_walk_kernel, static_cast<unsigned>(grid), kThreads, smem,
         static_cast<const uint8_t*>(data), n,
         static_cast<const int32_t*>(pos), static_cast<const int32_t*>(count),
         cap, static_cast<const int32_t*>(arena),
         static_cast<const int4*>(desc), nsteps, static_cast<int32_t*>(out));
  return cudaSuccess;
}

// As csr_walk_launch; launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int pfac_csr_walk(int device, const void* data, int32_t n,
                             const void* pos, const void* count, int32_t cap,
                             const void* arena, const void* desc,
                             int32_t nsteps, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::csr_walk_launch(device, data, n, pos, count, cap, arena, desc,
                              nsteps, out, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}

// The persistent grid pfac_csr_walk launches for `nsteps` steps into *grid
// (int64). Returns a cudaError_t.
extern "C" int pfac_csr_walk_grid(int device, int32_t nsteps, void* grid) {
  if (nsteps < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(pfac::persistent_grid(
      (const void*)csr_walk_kernel, kThreads, device,
      16LL * (1 + nsteps), static_cast<int64_t*>(grid)));
}
