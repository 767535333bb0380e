// The lockstep walker: the longest match starting at every position, by a
// failureless walk over the whole automaton. Replaces the XLA walk of
// pfac_tpu/backends/xla.py (walk_tiles, :167, behind _match_dense_padded
// :215 and _match_hash_padded :235), which the JAX package compiles into
// one device program a call: tiles of start positions stepped in lockstep
// by a while_loop that ends when every lane of the tile has trapped.
//
// What it computes, exactly as walk_tiles does over its sentinel-padded
// input (a byte at or past n is the sentinel, column 256, whose every entry
// traps):
// * position i looks up the fused pair tables at c1 * 257 + c2: the state
//   and the best match after two bytes;
// * then it steps at depth d = 2, 3, ... while d < max_len and the state is
//   not 0 (the trap); after each step a state in 1..num_final is the match;
// * out[i] is the last match; every position of out is written, the tail
//   past n included (the pair tables' sentinel row gives 0 there).
// Two steps: dense, table[state * 257 + ch] indexed in 64 bits (the 100K
// set's table is 6.16 GB); hash, the modulo-free perfect-hash probe of
// hash_step_fn (:149), on int32 with arithmetic shifts.
//
// Bound: device memory. The input is read once and 4 B a position written:
// 5 B a position, 0.200 ms at 128 Mi positions and 3.35 TB/s. What holds it
// back is the walk itself: a warp runs as long as its longest walk, and on
// the 100K set each step is a dependent gather from a table far larger than
// L2. Design (the reference library's own, PFAC_kernel.cu:377-458: one
// thread a start position that breaks out of its walk):
// * one thread a position, 256 a CTA, one CTA a 256-position tile: a tile
//   retires as soon as its longest walk ends, and the next takes its SM;
// * the state is a register; a trap, or a byte at or past n, ends the walk
//   (the sentinel's column is all-trap), so the input is read as uint8 with
//   no padded copy;
// * a step's bytes are neighbours across the warp's live lanes, so a step's
//   loads of the input share sectors; the pair tables (2 x 264 KB) and a
//   Snort-sized dense table (40.6 MB) stay in L2, read through L1;
// * the result is written once, coalesced.
#include <cuda_runtime.h>

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int32_t kStride = 257;       // device table columns
constexpr int32_t kSentinel = 256;     // a byte at or past n
constexpr int kHashShift = 16;         // key = k << 16 | (slots - 1)
constexpr int32_t kHashSlotMask = 0xFFFF;

struct DenseStep {
  const int32_t* table;   // [states * 257]

  __device__ __forceinline__ int32_t operator()(int32_t s, int32_t ch) const {
    return __ldg(table + static_cast<int64_t>(s) * kStride + ch);
  }
};

struct HashStep {
  const int32_t* rp_off;
  const int32_t* rp_key;
  const int32_t* val_next;
  const int32_t* val_ch;

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

template <class Step>
__device__ __forceinline__ void walk_position(
    const uint8_t* __restrict__ data, int64_t n, int64_t npad,
    const int32_t* __restrict__ pair_state,
    const int32_t* __restrict__ pair_match, const Step& step,
    int32_t num_final, int32_t max_len, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= npad) return;
  const int32_t c1 = i < n ? __ldg(data + i) : kSentinel;
  const int32_t c2 = i + 1 < n ? __ldg(data + i + 1) : kSentinel;
  const int32_t pair = c1 * kStride + c2;
  int32_t s = __ldg(pair_state + pair);
  int32_t m = __ldg(pair_match + pair);
  for (int32_t d = 2; d < max_len && s > 0; ++d) {
    if (i + d >= n) break;             // the sentinel: a trap, m stays
    s = step(s, __ldg(data + i + d));
    if (s > 0 && s <= num_final) m = s;
  }
  out[i] = m;
}

__global__ void __launch_bounds__(kThreads)
lockstep_dense_kernel(const uint8_t* __restrict__ data, int64_t n,
                      int64_t npad, const int32_t* __restrict__ pair_state,
                      const int32_t* __restrict__ pair_match,
                      const int32_t* __restrict__ table, int32_t num_final,
                      int32_t max_len, int32_t* __restrict__ out) {
  walk_position(data, n, npad, pair_state, pair_match, DenseStep{table},
                num_final, max_len, out);
}

__global__ void __launch_bounds__(kThreads)
lockstep_hash_kernel(const uint8_t* __restrict__ data, int64_t n,
                     int64_t npad, const int32_t* __restrict__ pair_state,
                     const int32_t* __restrict__ pair_match,
                     const int32_t* __restrict__ rp_off,
                     const int32_t* __restrict__ rp_key,
                     const int32_t* __restrict__ val_next,
                     const int32_t* __restrict__ val_ch, int32_t num_final,
                     int32_t max_len, int32_t* __restrict__ out) {
  walk_position(data, n, npad, pair_state, pair_match,
                HashStep{rp_off, rp_key, val_next, val_ch}, num_final,
                max_len, out);
}

}  // namespace

// data: uint8, bytes [0, n) read; out: int32[npad], every word written;
// pair_state, pair_match: int32[257 * 257]; dense (hashed 0): t0 the table
// int32[states * 257]; hash (hashed 1): t0..t3 rp_off, rp_key, val_next,
// val_ch. 0 <= n, 0 <= npad < 2^31 * 256; num_final >= 0. Else
// cudaErrorInvalidValue. npad 0 is a launch with nothing to do.
cudaError_t pfac::lockstep_launch(const void* data, int64_t n, int64_t npad,
                                  const void* pair_state,
                                  const void* pair_match, int32_t hashed,
                                  const void* t0, const void* t1,
                                  const void* t2, const void* t3,
                                  int32_t num_final, int32_t max_len,
                                  void* out, Launch* l) {
  *l = Launch{};
  const int64_t blocks = (npad + kThreads - 1) / kThreads;
  if (n < 0 || npad < 0 || blocks >= (1LL << 31) || num_final < 0 ||
      (n > 0 && data == nullptr) || pair_state == nullptr ||
      pair_match == nullptr || t0 == nullptr ||
      (hashed && (t1 == nullptr || t2 == nullptr || t3 == nullptr)) ||
      (npad > 0 && out == nullptr))
    return cudaErrorInvalidValue;
  if (npad == 0) return cudaSuccess;
  const auto* d = static_cast<const uint8_t*>(data);
  const auto* ps = static_cast<const int32_t*>(pair_state);
  const auto* pm = static_cast<const int32_t*>(pair_match);
  auto* o = static_cast<int32_t*>(out);
  if (hashed)
    l->set(lockstep_hash_kernel, static_cast<unsigned>(blocks), kThreads, 0,
           d, n, npad, ps, pm, static_cast<const int32_t*>(t0),
           static_cast<const int32_t*>(t1), static_cast<const int32_t*>(t2),
           static_cast<const int32_t*>(t3), num_final, max_len, o);
  else
    l->set(lockstep_dense_kernel, static_cast<unsigned>(blocks), kThreads, 0,
           d, n, npad, ps, pm, static_cast<const int32_t*>(t0), num_final,
           max_len, o);
  return cudaSuccess;
}

// As lockstep_launch, launched on `stream`; returns the cudaError_t.
extern "C" int pfac_lockstep(int device, const void* data, int64_t n,
                             int64_t npad, const void* pair_state,
                             const void* pair_match, int32_t hashed,
                             const void* t0, const void* t1, const void* t2,
                             const void* t3, int32_t num_final,
                             int32_t max_len, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  pfac::Launch l;
  err = pfac::lockstep_launch(data, n, npad, pair_state, pair_match, hashed,
                              t0, t1, t2, t3, num_final, max_len, out, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(l.launch(static_cast<cudaStream_t>(stream)));
}
