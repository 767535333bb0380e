// CHD probe math on flat tables: the device side of backends/probe.py.
//
// Counterpart of pfac_tpu/backends/pallas_sieve.py::_lookup/_probe_slot and
// pallas_walk.py::_probe. A probe hashes a 32-bit key with one wrapping
// multiply, prod = key * mul:
//   displacement-free: slot = prod >> (32 - lg_r)
//   CHD:               bucket = prod >> (32 - lg_b)
//                      h1 = (prod >> (32 - lg_b - lg_r)) & (2^lg_r - 1)
//                      slot = (h1 ^ disp[bucket]) & (2^lg_r - 1)
// All arithmetic is uint32, so wraparound and logical shifts match the
// reference's masked int32 arithmetic bit for bit.
//
// Tables live in one int32 arena; a probe is one descriptor row of
// kDescWords int32: [mul, lg_b, lg_r, disp_off, key_off, val_off, present, 0]
// (offsets -1 where absent). Exact tables hold a member key in empty slots,
// so key equality alone decides a hit.
#pragma once

#include <cstdint>

namespace pfac {

constexpr int kDescWords = 8;

struct Probe {
  uint32_t mul;
  int32_t lg_b, lg_r, disp_off, key_off, val_off, present;
};

__device__ __forceinline__ Probe load_probe(const int32_t* __restrict__ desc,
                                            int row) {
  const int32_t* d = desc + row * kDescWords;
  Probe p;
  p.mul = static_cast<uint32_t>(__ldg(d + 0));
  p.lg_b = __ldg(d + 1);
  p.lg_r = __ldg(d + 2);
  p.disp_off = __ldg(d + 3);
  p.key_off = __ldg(d + 4);
  p.val_off = __ldg(d + 5);
  p.present = __ldg(d + 6);
  return p;
}

// Table words read through the read-only cache (L1, then L2). The probes
// below take any type whose operator[] returns the uint32 word at an arena
// offset, so the sieve can also probe tables staged in shared memory.
struct Ldg {
  const int32_t* __restrict__ arena;
  __device__ __forceinline__ uint32_t operator[](int64_t i) const {
    return static_cast<uint32_t>(__ldg(arena + i));
  }
};

__device__ __forceinline__ uint32_t word(const int32_t* __restrict__ arena,
                                         int64_t i) {
  return Ldg{arena}[i];
}

template <class Words>
__device__ __forceinline__ uint32_t probe_slot(const Words& t, const Probe& p,
                                               uint32_t key) {
  const uint32_t prod = key * p.mul;
  const uint32_t rmask = (1u << p.lg_r) - 1u;
  if (p.disp_off < 0) return (prod >> (32 - p.lg_r)) & rmask;
  const uint32_t bk = (prod >> (32 - p.lg_b)) & ((1u << p.lg_b) - 1u);
  const uint32_t h1 = (prod >> (32 - p.lg_b - p.lg_r)) & rmask;
  return (h1 ^ t[p.disp_off + bk]) & rmask;
}

// Exact probe: true on a hit, with the slot's value in *val.
template <class Words>
__device__ __forceinline__ bool probe_exact(const Words& t, const Probe& p,
                                            uint32_t key, uint32_t* val) {
  const uint32_t s = probe_slot(t, p, key);
  *val = t[p.val_off + s];
  return t[p.key_off + s] == key;
}

__device__ __forceinline__ uint32_t probe_slot(
    const int32_t* __restrict__ arena, const Probe& p, uint32_t key) {
  return probe_slot(Ldg{arena}, p, key);
}

__device__ __forceinline__ bool probe_exact(const int32_t* __restrict__ arena,
                                            const Probe& p, uint32_t key,
                                            uint32_t* val) {
  return probe_exact(Ldg{arena}, p, key, val);
}

}  // namespace pfac
