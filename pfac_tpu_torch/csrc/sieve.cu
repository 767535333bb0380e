// Kernel K1, the sieve: replaces pfac_tpu/backends/pallas_sieve.py::_make_kernel.
//
// For every position pos < npad it writes match[pos], the exact ID of the
// longest pattern of length 1..3 starting at pos (0 at and past n), and
// flags[pos] = 1 where a pattern of >= 4 bytes may start: the resid16 alive
// filter passes the little-endian key k4 = c3<<24|c2<<16|c1<<8|c0 and
// n - pos > 3. Probes, all on k4:
//   m1: arena[c0]                         (a 256-entry table at offset 0)
//   m2: exact on k4 & 0xFFFF,   hit needs n - pos > 1   (descriptor row 0)
//   m3: exact on k4 & 0xFFFFFF, hit needs n - pos > 2   (descriptor row 1)
//   alive: residual[slot(k4)] == (k4 * 0xC2B2AE35) >> 16 (descriptor row 2)
// Bytes at or past n read as 0; they never decide a hit (masks above).
// It also adds the survivors of each `block`-position block into
// counts[pos / block] (zeroed by the caller), the input of the dense-block
// escape (block_walk_kernel in walk.cu): one warp reduction and at most one
// atomicAdd per warp, so no second pass over the flags is needed. A CTA's
// 1024 positions lie in one block (block % 1024 == 0). The launch covers
// exactly npad / 4 threads (npad % 1024 == 0, checked at the launch), so
// every lane is in range and takes part in the full-warp reduction. The
// kernel therefore has no bounds branch, which also saves registers: a
// branch around the body took it from 38 to 47, one CTA fewer per SM.
//
// Bound: device-memory traffic. At 128 MB of input it reads 128 MB and
// writes 512 MB of int32 matches and 128 MB of flags; the probe tables are
// small and stay in L1/L2. Design: each thread takes 4 consecutive
// positions from two aligned 4-byte loads (the bytes c0..c3 of all four),
// so the loads are coalesced words instead of 7 byte loads, and stores its
// 4 matches as one 16-byte int4 and its 4 flags as one 4-byte word. Tables
// are read through the read-only cache (__ldg); staging them in shared
// memory is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr uint32_t kMixResid = 0xC2B2AE35u;   // chd.MIX_RESID
constexpr int kThreads = 256;

// Little-endian word of bytes b..b+3 (b % 4 == 0); bytes >= n read as 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ data,
                                              int64_t n, int64_t b) {
  if (b + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(data + b));
  uint32_t w = 0;
  for (int k = 0; k < 4; ++k)
    if (b + k < n) w |= static_cast<uint32_t>(data[b + k]) << (8 * k);
  return w;
}

__global__ void __launch_bounds__(kThreads)
sieve_kernel(const uint8_t* __restrict__ data, int32_t n,
             const int32_t* __restrict__ arena,
             const int32_t* __restrict__ desc, int32_t* __restrict__ match,
             uint8_t* __restrict__ flags, int32_t* __restrict__ counts,
             uint32_t ctas_per_count) {
  const int64_t p0 = 4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                          threadIdx.x);
  const pfac::Probe m2 = pfac::load_probe(desc, 0);
  const pfac::Probe m3 = pfac::load_probe(desc, 1);
  const pfac::Probe al = pfac::load_probe(desc, 2);
  const uint64_t x = static_cast<uint64_t>(load_word(data, n, p0)) |
                     (static_cast<uint64_t>(load_word(data, n, p0 + 4)) << 32);
  int32_t out[4];
  uint32_t fl = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int64_t rd = static_cast<int64_t>(n) - (p0 + j);
    const uint32_t k4 = static_cast<uint32_t>(x >> (8 * j));
    uint32_t m = 0, v;
    if (rd > 0) {
      m = pfac::word(arena, k4 & 0xFFu);
      if (m2.present && rd > 1 &&
          pfac::probe_exact(arena, m2, k4 & 0xFFFFu, &v))
        m = v;
      if (m3.present && rd > 2 &&
          pfac::probe_exact(arena, m3, k4 & 0xFFFFFFu, &v))
        m = v;
      if (al.present && rd > 3) {
        const uint32_t s = pfac::probe_slot(arena, al, k4);
        if (pfac::word(arena, al.val_off + s) == ((k4 * kMixResid) >> 16))
          fl |= 1u << (8 * j);
      }
    }
    out[j] = static_cast<int32_t>(m);
  }
  *reinterpret_cast<int4*>(match + p0) =
      make_int4(out[0], out[1], out[2], out[3]);
  *reinterpret_cast<uint32_t*>(flags + p0) = fl;
  const uint32_t c = __reduce_add_sync(0xFFFFFFFFu, __popc(fl));
  if ((threadIdx.x & 31) == 0 && c != 0)     // a CTA lies in one block
    atomicAdd(counts + blockIdx.x / ctas_per_count, static_cast<int32_t>(c));
}

}  // namespace

// data: uint8[>= n], 4-byte aligned; match: int32[npad]; flags: uint8[npad];
// counts: int32[npad / block], zeroed; npad % block == 0 (the caller's
// check); npad % 1024 == 0 and block % 1024 == 0, else cudaErrorInvalidValue.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_sieve(int device, const void* data, int32_t n, int32_t npad,
                          const void* arena, const void* desc, void* match,
                          void* flags, void* counts, int32_t block,
                          void* stream) {
  if (npad % (4 * kThreads) != 0 || block % (4 * kThreads) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t threads = npad / 4;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks == 0) return 0;
  sieve_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n,
      static_cast<const int32_t*>(arena), static_cast<const int32_t*>(desc),
      static_cast<int32_t*>(match), static_cast<uint8_t*>(flags),
      static_cast<int32_t*>(counts),
      static_cast<uint32_t>(block / (4 * kThreads)));
  return static_cast<int>(cudaGetLastError());
}
