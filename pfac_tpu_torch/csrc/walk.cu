// Kernel K2, the survivor walk: replaces
// pfac_tpu/backends/pallas_walk.py::_make_walk_kernel. It walks positions
// with the device function walk_position(). (K3, the dense-block walk, has
// the same walk tile-wise in block_walk.cu.)
//
// walk_position(p) probes the BIG-endian entry key b0<<24|b1<<16|b2<<8|b3
// (descriptor row 0 -> depth-4 state; row 1 -> length-4 pattern ID), then
// steps two bytes at a time over depth-sliced exact tables: step s covers
// depth d = 4 + 2s with rows 2+3s (main: state<<16|b1<<8|b2 -> next state),
// 3+3s (odd: state<<8|b1 -> ID of a length-(d+1) pattern) and 4+3s (even:
// the main key -> ID of a length-(d+2) pattern). A hit at depth d needs
// n - p > d; the longest hit wins. The walk stops when the state is DEAD
// (no table key carries the DEAD index, so nothing could hit again) or the
// step has no main table.
//
// The kernel writes out[p] only for a match of >= 4 bytes. The sieve
// already wrote the exact depth-1..3 match at every position and a deeper
// match is always longer. (The TPU walkers recompute depths 1..3 only so
// that XLA never reads its 512 MB loop carry; that reason does not exist
// here.) Bytes come straight from the corpus, bounded by n: the TPU's
// 128-byte row-gather windows, 32-way alignment and block halos are not
// needed on this card.
//
// walk_kernel: one thread per survivor position (from the compaction, any
// count, one launch). Bound: latency of dependent table loads (disp ->
// key/value per probe, up to three probes per step), not bandwidth:
// survivors are under 1e-3 of the positions on the traffic in PERF.md. The
// tables (<= 6 MB by the tier gate) stay resident in the 50 MB L2; each
// thread exits as soon as its state dies, so shallow survivors cost only
// the entry probe.
#include <cuda_runtime.h>

#include <cstdint>

#include "probe.cuh"

namespace {

constexpr uint32_t kDead = 0xFFFFu;
constexpr int kThreads = 128;

// ID of the longest match of >= 4 bytes starting at p < n, else 0.
__device__ __forceinline__ uint32_t walk_position(
    const uint8_t* __restrict__ data, int32_t n, int32_t p,
    const int32_t* __restrict__ arena, const int32_t* __restrict__ desc,
    int32_t nsteps) {
  const int32_t maxd = n - p;
  if (maxd <= 3) return 0;
  const uint8_t* __restrict__ s = data + p;
  auto byte_at = [&](int32_t j) -> uint32_t {
    return j < maxd ? static_cast<uint32_t>(__ldg(s + j)) : 0u;
  };
  const uint32_t key4 = (byte_at(0) << 24) | (byte_at(1) << 16) |
                        (byte_at(2) << 8) | byte_at(3);
  uint32_t v, match = 0, state = kDead;
  const pfac::Probe entry = pfac::load_probe(desc, 0);
  const pfac::Probe entry_final = pfac::load_probe(desc, 1);
  if (pfac::probe_exact(arena, entry, key4, &v)) state = v;
  if (entry_final.present && pfac::probe_exact(arena, entry_final, key4, &v))
    match = v;
  for (int32_t st = 0; st < nsteps && state != kDead; ++st) {
    const int32_t d = 4 + 2 * st;
    const pfac::Probe main = pfac::load_probe(desc, 2 + 3 * st);
    const pfac::Probe odd = pfac::load_probe(desc, 3 + 3 * st);
    const pfac::Probe even = pfac::load_probe(desc, 4 + 3 * st);
    const uint32_t c1 = byte_at(d);
    if (odd.present && maxd > d &&
        pfac::probe_exact(arena, odd, (state << 8) | c1, &v))
      match = v;
    if (!main.present) break;
    const uint32_t mkey = (state << 16) | (c1 << 8) | byte_at(d + 1);
    uint32_t next;
    const bool hit = maxd > d + 1 && pfac::probe_exact(arena, main, mkey, &next);
    if (even.present && maxd > d + 1 &&
        pfac::probe_exact(arena, even, mkey, &v))
      match = v;
    state = hit ? next : kDead;
  }
  return match;
}

__global__ void __launch_bounds__(kThreads)
walk_kernel(const uint8_t* __restrict__ data, int32_t n,
            const int32_t* __restrict__ pos, int32_t count,
            const int32_t* __restrict__ arena,
            const int32_t* __restrict__ desc, int32_t nsteps,
            int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const int32_t p = __ldg(pos + i);
  const uint32_t match = walk_position(data, n, p, arena, desc, nsteps);
  if (match != 0) out[p] = static_cast<int32_t>(match);
}

}  // namespace

// data: uint8[>= n]; pos: int32[count], each < n; out: int32[>= n].
// Launches on `stream`; returns cudaGetLastError().
extern "C" int pfac_walk(int device, const void* data, int32_t n,
                         const void* pos, int32_t count, const void* arena,
                         const void* desc, int32_t nsteps, void* out,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (count <= 0) return 0;
  const int64_t blocks = (static_cast<int64_t>(count) + kThreads - 1) / kThreads;
  walk_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n, static_cast<const int32_t*>(pos),
      count, static_cast<const int32_t*>(arena),
      static_cast<const int32_t*>(desc), nsteps, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
