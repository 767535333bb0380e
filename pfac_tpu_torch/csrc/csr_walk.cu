// The CSR walk: replaces pfac_tpu/backends/pallas_walk.py::_make_align_kernel
// (K4) together with the XLA CSR walk around it
// (pfac_tpu/backends/xla_csr.py::_entry_probe, _probe_step; the kernel
// computes what xla_csr.csr_oracle_walk computes, bit for bit).
//
// K4 only word-aligns each survivor's bytes, gathered in 128-byte rows,
// for the XLA walk. Here one thread per survivor reads its bytes straight
// from the corpus (bounded by n), so alignment disappears and the kernel
// is the walk itself:
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
// Descriptor rows (4 int32 each): row 0 = [entry offset, lgb, width, 0];
// row 1 + s = [word offset, row count, depth, chain] of step s. Keys are
// compared as uint32.
//
// Bound: latency of dependent device-memory loads. The tables of a
// 100K-pattern set are ~170 MB and do not fit the 50 MB L2, so every step
// costs one dependent 96-byte row load per survivor (six 16-byte vector
// loads, issued together). Survivors are few on real traffic (the sieve's
// filter passes ~2^-16 of non-matching positions), so latency, not
// bandwidth, sets the time; enough survivors in flight hide it.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t kEntryMul = 0x9E3779B1u;    // xla_csr.ENTRY_MUL
constexpr uint32_t kNextMask = 0x0FFFFFFFu;
constexpr int kW = 8;                          // xla_csr.W_ENTRIES
constexpr int kRowWords = 3 * kW;
constexpr int kDescWords = 4;
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
csr_walk_kernel(const uint8_t* __restrict__ data, int32_t n,
                const int32_t* __restrict__ pos, int32_t count,
                const int32_t* __restrict__ arena,
                const int32_t* __restrict__ desc, int32_t nsteps,
                int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int32_t p = __ldg(pos + i);
  const int32_t maxd = n - p;
  if (maxd < 4) return;
  const uint8_t* __restrict__ s = data + p;
  auto byte_at = [&](int32_t j) -> uint32_t {
    return j < maxd ? static_cast<uint32_t>(__ldg(s + j)) : 0u;
  };
  auto word_at = [&](int32_t j) -> uint32_t {
    return (byte_at(j) << 24) | (byte_at(j + 1) << 16) |
           (byte_at(j + 2) << 8) | byte_at(j + 3);
  };

  const uint32_t key4 = word_at(0);
  const int64_t entry_off = __ldg(desc + 0);
  const int32_t lgb = __ldg(desc + 1);
  const int32_t width = __ldg(desc + 2);
  const uint32_t bk = (key4 * kEntryMul) >> (32 - lgb);
  const int32_t* __restrict__ erow =
      arena + entry_off + static_cast<int64_t>(bk) * 3 * width;
  uint32_t state = 0, match = 0;
  for (int j = 0; j < width; ++j) {
    const uint32_t meta = static_cast<uint32_t>(__ldg(erow + 3 * j + 1));
    if ((meta >> 28) == 1u &&
        static_cast<uint32_t>(__ldg(erow + 3 * j)) == key4) {
      state = meta & kNextMask;
      const uint32_t pid = static_cast<uint32_t>(__ldg(erow + 3 * j + 2));
      if (pid != 0) match = pid;
      break;
    }
  }

  for (int32_t st = 0; st < nsteps && state != 0; ++st) {
    const int32_t* sd = desc + (1 + st) * kDescWords;
    const int64_t off = __ldg(sd + 0);
    const uint32_t nrows = static_cast<uint32_t>(__ldg(sd + 1));
    const int32_t d = __ldg(sd + 2);
    const int32_t chain = __ldg(sd + 3);
    const uint32_t w4 = word_at(d);
    uint32_t best_k = 0, best_pid = 0, nxt = 0, cur = state;
    for (int32_t c = 0; c <= chain; ++c) {
      if (cur == 0 || cur >= nrows) break;
      const int4* r4 = reinterpret_cast<const int4*>(
          arena + off + static_cast<int64_t>(cur) * kRowWords);
      uint32_t w[kRowWords];
#pragma unroll
      for (int q = 0; q < kRowWords / 4; ++q) {
        const int4 v = __ldg(r4 + q);
        w[4 * q + 0] = static_cast<uint32_t>(v.x);
        w[4 * q + 1] = static_cast<uint32_t>(v.y);
        w[4 * q + 2] = static_cast<uint32_t>(v.z);
        w[4 * q + 3] = static_cast<uint32_t>(v.w);
      }
      uint32_t cont = 0;
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        const uint32_t key = w[3 * j], meta = w[3 * j + 1], pid = w[3 * j + 2];
        const uint32_t klen = meta >> 28, next = meta & kNextMask;
        if (klen == 0) {
          if (next != 0) cont = next;
          continue;
        }
        if (klen > 4 || maxd < d + static_cast<int32_t>(klen)) continue;
        if ((w4 >> (8 * (4 - klen))) != key) continue;
        if (pid != 0 && klen >= best_k) {
          best_k = klen;
          best_pid = pid;
        }
        if (klen == 4 && next != 0) nxt = next;
      }
      cur = cont;
    }
    if (best_pid != 0) match = best_pid;
    state = nxt;
  }
  if (match != 0) out[p] = static_cast<int32_t>(match);
}

}  // namespace

// data: uint8[>= n]; pos: int32[count], each < n; out: int32[>= n];
// arena: int32, every step offset a multiple of 4 words and 16-byte
// aligned. Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_csr_walk(int device, const void* data, int32_t n,
                             const void* pos, int32_t count, const void* arena,
                             const void* desc, int32_t nsteps, void* out,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count <= 0) return 0;
  const int64_t blocks = (static_cast<int64_t>(count) + kThreads - 1) / kThreads;
  csr_walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const int32_t*>(pos),
      count, static_cast<const int32_t*>(arena),
      static_cast<const int32_t*>(desc), nsteps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
