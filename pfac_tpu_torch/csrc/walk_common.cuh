// What the walk kernels (K2 walk.cu, K3 block_walk.cu, the CSR walk
// csr_walk.cu) share: the arena's word access with a prefix resident in
// shared memory, the bulk copy onto an mbarrier, a walk's corpus bytes in
// registers, descriptor rows read from shared memory, the survivor count
// read on the device, and the persistent grid's size.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

#include "probe.cuh"

namespace pfac {

constexpr uint32_t kBulkMax = 1u << 15;       // bytes per bulk copy

// Arena words: shared memory below `resident`, L1/L2 from there on.
// half(h) reads the 16-bit half-word h (the low half of word h / 2 where h
// is even), as the walk tables keep their values.
struct SplitTab {
  const uint32_t* s;
  const int32_t* __restrict__ g;
  uint32_t resident;
  __device__ __forceinline__ uint32_t operator[](uint32_t i) const {
    return i < resident ? s[i] : static_cast<uint32_t>(__ldg(g + i));
  }
  __device__ __forceinline__ uint32_t half(uint32_t h) const {
    return h < 2 * resident
               ? reinterpret_cast<const uint16_t*>(s)[h]
               : __ldg(reinterpret_cast<const unsigned short*>(g) + h);
  }
};

// The whole arena in shared memory: no test, no global path.
struct SmemTab {
  const uint32_t* s;
  __device__ __forceinline__ uint32_t operator[](uint32_t i) const {
    return s[i];
  }
  __device__ __forceinline__ uint32_t half(uint32_t h) const {
    return reinterpret_cast<const uint16_t*>(s)[h];
  }
};

// The key word and the value of slot s of walk table p, as K2 and K3 read
// them: the walk tables keep keys in words and values in 16-bit half-words
// (backends/walk_tables.py::pack_walk; the row's val_off counts
// half-words).
template <class Tab>
__device__ __forceinline__ uint32_t walk_key(const Tab& t, const Probe& p,
                                             uint32_t s) {
  return t[p.key_off + s];
}
template <class Tab>
__device__ __forceinline__ uint32_t walk_val(const Tab& t, const Probe& p,
                                             uint32_t s) {
  return t.half(p.val_off + s);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from src (16-byte aligned, global) to dst
// (16-byte aligned, shared), completing on `bar`; one thread calls it after
// mbar_expect(bar, bytes).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = smem_addr(bar);
  for (uint32_t off = 0; off < bytes; off += kBulkMax) {
    const uint32_t len = bytes - off < kBulkMax ? bytes - off : kBulkMax;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(len), "r"(b)
        : "memory");
  }
}

// A walk's corpus bytes in registers: the 32 bytes from the 16-byte aligned
// address `at` on, as chunks a and b, each one 16-byte load. A chunk that
// starts at or past `end` (the corpus's end) reads as zeros: the aligned
// chunk that holds a byte of the corpus lies in its allocation, the one
// after it may not. seek() moves on a chunk at a time and loads the chunk
// after the new b at once, so a load is issued 16 bytes of walk before the
// walk reads it.
struct Bytes {
  const uint8_t* at;
  uint4 a, b;

  static __device__ __forceinline__ uint4 chunk(const uint8_t* c,
                                                const uint8_t* end) {
    return c < end ? __ldg(reinterpret_cast<const uint4*>(c))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ void start(const uint8_t* q, const uint8_t* end) {
    at = reinterpret_cast<const uint8_t*>(reinterpret_cast<uintptr_t>(q) &
                                          ~uintptr_t{15});
    a = chunk(at, end);
    b = chunk(at + 16, end);
  }
  // -> the offset of q (>= at) in the window, < 16
  __device__ __forceinline__ uint32_t seek(const uint8_t* q,
                                           const uint8_t* end) {
    while (q - at >= 16) {
      at += 16;
      a = b;
      b = chunk(at + 16, end);
    }
    return static_cast<uint32_t>(q - at);
  }
  // bytes o .. o + 3 of the window (o < 16) as a little-endian word
  __device__ __forceinline__ uint32_t word_le(uint32_t o) const {
    const uint32_t q = o >> 2;
    const uint32_t lo = q == 0 ? a.x : q == 1 ? a.y : q == 2 ? a.z : a.w;
    const uint32_t hi = q == 0 ? a.y : q == 1 ? a.z : q == 2 ? a.w : b.x;
    return __funnelshift_r(lo, hi, 8 * (o & 3));
  }
};

// Survivors a walker walks: min(*count, cap), or cap without a count (the
// count is the compaction's total, left on the device).
__device__ __forceinline__ int32_t survivors(const int32_t* count,
                                             int32_t cap) {
  return count == nullptr ? cap : min(__ldg(count), cap);
}

__device__ __forceinline__ Probe smem_probe(const int32_t* sdesc, int row) {
  const int32_t* d = sdesc + row * kDescWords;
  Probe p;
  p.mul = static_cast<uint32_t>(d[0]);
  p.lg_b = d[1];
  p.lg_r = d[2];
  p.disp_off = d[3];
  p.key_off = d[4];
  p.val_off = d[5];
  p.present = d[6];
  return p;
}

// The persistent grid of kernel `fn` at `threads` threads and `smem` bytes
// of dynamic shared memory: as many CTAs as the SMs hold. The attribute and
// occupancy queries cost tens of microseconds of host time, so the last
// few results are kept, keyed by kernel, device and shared memory (one per
// ruleset and corpus size in use). Each source that includes this header
// keeps its own cache.
static cudaError_t persistent_grid(const void* fn, int threads, int device,
                                   int64_t smem, int64_t* grid) {
  struct Entry { const void* fn = nullptr; int device = -1; int64_t smem = -1, grid = 0; };
  struct Allowed { const void* fn = nullptr; int device = -1; int64_t smem = 0; };
  constexpr int kEntries = 16;
  constexpr int kAllowed = 64;
  static Entry cache[kEntries];
  static Allowed allowed[kAllowed];    // largest shared memory allowed
  static int next = 0, nallowed = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.fn == fn && e.device == device && e.smem == smem) {
      *grid = e.grid;
      return cudaSuccess;
    }
  }
  Allowed* a = nullptr;
  for (int k = 0; k < nallowed; ++k)
    if (allowed[k].fn == fn && allowed[k].device == device) a = &allowed[k];
  if (a == nullptr) {
    if (nallowed == kAllowed) return cudaErrorInvalidDevice;
    a = &allowed[nallowed++];
    *a = Allowed{fn, device, 0};
  }
  cudaError_t err;
  if (a->smem < smem) {   // never lowered: cached grids still fit
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    a->smem = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fn, threads, static_cast<size_t>(smem));
  if (err != cudaSuccess) return err;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  Entry& e = cache[next];
  next = (next + 1) % kEntries;
  e = Entry{fn, device, smem, static_cast<int64_t>(per_sm) * sms};
  *grid = e.grid;
  return cudaSuccess;
}

}  // namespace pfac
