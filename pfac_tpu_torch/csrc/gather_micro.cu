// Table-probe micro-benchmark kernels G1-G4: the Hopper counterparts of the
// TPU gather micro-benchmarks E1-E6 (experiments/lanegather_micro.py,
// gather_micro.py, dyngather_micro.py, align_micro.py, axis0_gather_probe.py,
// lanegather2_micro.py). On the TPU each of those tried a layout that makes
// a dynamic gather lowerable and fast: lane gathers within one vreg, vreg
// scans, lane- or sublane-replicated planes, a 32-way row select. On this
// card every one of them is the same indexed load, so four kernels serve all
// nine sites, and what they measure is where the table lives:
//
//   G1 word_gather_kernel   out[i] = T[idx[i]]                 (E1-C/D, E2, E6)
//      word_gather_cluster_kernel   the same, T split over a cluster
//   G2 tile_gather_kernel   take_along_axis on an int32 tile   (E1-A, E5, E6)
//      tile_gather_direct_kernel   the same for small index sets
//   G3 chain_gather_kernel  v = T[v], `chain` dependent loads  (E3)
//   G4 align_kernel         the walker's window align           (E4)
//
// Placement (G1, G3): kSmem stages the whole table in dynamic shared memory
// in every CTA (at most 232,448 B = 58,112 words, the opt-in limit of a
// block; a larger table is refused, never demoted); kPrefix (G1) stages
// the table's first 58,112 words and reads the rest through L1, as the
// walks place their tables (walk_common.cuh's SplitTab); kCluster (G1)
// splits it in contiguous parts over the shared memory of a 2-CTA cluster
// (4 CTAs where 2 do not hold it: up to 232,448 words), each CTA staging
// its part and reading the others' through distributed shared memory
// (cg::this_cluster().map_shared_rank); kLdg reads it through L1 (__ldg);
// kCg from L2 only (__ldcg). The launch is one wave of persistent CTAs
// (occupancy x SMs, or the clusters that fit), so a CTA stages its table
// once and then strides over the indices; G1's staging placements take CTAs of 1,024 threads,
// so that one CTA with a 227 KB table still keeps 32 warps of lookups in
// flight on its SM.
// Measured on the H100 (PERF.md): a random word costs L1 a tag lookup of
// its own, about one a clock per SM, and a remote word of a cluster
// partner about a third of that, so past one CTA's table the prefix
// (most lookups from shared memory) beats both, and the cluster loses to
// L1 at every size.
//
// Bound: 16M lookups stream 64 MB of indices in and 64 MB of results out,
// ~0.04 ms at 3.35 TB/s; past that, the table's placement: a random word
// from shared memory costs a bank access (32 a clock, less the conflicts),
// from L1 a tag lookup. G1
// moves indices and results as int4, four lookups a load and kVecRuns
// loads a thread in flight (16 lookups), the ragged tail word by word; G3
// keeps kIlp scalar lookups in flight (a chain step waits for the previous
// one: the walks' pattern). Indices and results are streamed with __ldcs /
// __stcs (evict first), so they do not push the table out of L1 and L2.
//
// G2 has two paths, picked by the caller (experiments/gathers.py::
// tile_path): `staged` as above, and `direct` for index sets smaller than
// the words a CTA would stage (E5 a and c, E6's check): one thread per
// lookup reads the tile through L1 (__ldg), with no shared memory and no
// attribute to set, in a few small CTAs.
//
// A small case is bound by its launch, so the host side of one is kept
// short: the wave's size (an occupancy query, and the shared-memory
// attribute above 48 KB) is computed once per kernel, device and
// shared-memory size and kept (wave()).
//
// Indices must lie in [0, words) (the caller's contract, as for the walks'
// positions): no kernel checks them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;                  // G2, G3: lookups per thread
constexpr int kVecRuns = 4;              // G1: int4 index loads per thread
constexpr int kMaxRanks = 4;             // G1: CTAs a table is split over
constexpr int kWordThreads = 1024;       // G1 staging: 32 warps, 227 KB
constexpr int kStrip = 32;               // G2: output columns per CTA
constexpr int kStripRows = kThreads / kStrip;
constexpr int32_t kSmemWords = 232448 / 4;
constexpr int kAlignSpan = 32;           // G4: window offsets 0..31
constexpr uint32_t kChainMul = 0x9E3779B1u;

enum Placement { kSmem = 0, kCluster = 1, kLdg = 2, kCg = 3, kPrefix = 4 };

template <int P>
__device__ __forceinline__ int32_t fetch(const int32_t* __restrict__ table,
                                         const int32_t* s, uint32_t i) {
  if constexpr (P == kSmem) return s[i];
  else if constexpr (P == kPrefix)
    return i < static_cast<uint32_t>(kSmemWords) ? s[i] : __ldg(table + i);
  else if constexpr (P == kLdg) return __ldg(table + i);
  else return __ldcg(table + i);
}

// Words [0, n) of g into s, by all `nthreads` threads of the CTA.
__device__ __forceinline__ void stage(int32_t* s, const int32_t* __restrict__ g,
                                      int32_t n, int tid, int nthreads) {
  for (int32_t k = tid; k < n; k += nthreads) s[k] = __ldg(g + k);
  __syncthreads();
}

// out[e] = fetch(idx[e]) for e < n by CTAs of kT threads: the int4 groups
// [0, nvec) of idx and out (both 16-byte aligned), kVecRuns a thread in
// flight, then the words [4 * nvec, n) one by one.
template <int kT, typename Fetch>
__device__ __forceinline__ void gather_words(Fetch fetch,
                                             const int32_t* __restrict__ idx,
                                             int32_t n, int32_t nvec,
                                             int32_t* __restrict__ out) {
  const int4* idx4 = reinterpret_cast<const int4*>(idx);
  int4* out4 = reinterpret_cast<int4*>(out);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kT * kVecRuns;
  for (int64_t g0 = static_cast<int64_t>(blockIdx.x) * kT * kVecRuns +
                    threadIdx.x;
       g0 < nvec; g0 += stride) {
    int4 v[kVecRuns];
#pragma unroll
    for (int u = 0; u < kVecRuns; ++u) {
      const int64_t g = g0 + u * kT;
      v[u] = g < nvec ? __ldcs(idx4 + g) : make_int4(0, 0, 0, 0);
    }
    int4 r[kVecRuns];
#pragma unroll
    for (int u = 0; u < kVecRuns; ++u)
      r[u] = make_int4(fetch(static_cast<uint32_t>(v[u].x)),
                       fetch(static_cast<uint32_t>(v[u].y)),
                       fetch(static_cast<uint32_t>(v[u].z)),
                       fetch(static_cast<uint32_t>(v[u].w)));
#pragma unroll
    for (int u = 0; u < kVecRuns; ++u) {
      const int64_t g = g0 + u * kT;
      if (g < nvec) __stcs(out4 + g, r[u]);
    }
  }
  for (int64_t e = 4 * static_cast<int64_t>(nvec) +
                   static_cast<int64_t>(blockIdx.x) * kT + threadIdx.x;
       e < n; e += static_cast<int64_t>(gridDim.x) * kT)
    __stcs(out + e, fetch(static_cast<uint32_t>(__ldcs(idx + e))));
}

// CTA size of G1's instance P: the staging placements keep one CTA of a
// large table busy with 32 warps; L1 and L2 take many small CTAs, so that
// a few lookups spread over the SMs.
template <int P>
constexpr int kWordCta =
    P == kSmem || P == kPrefix ? kWordThreads : kThreads;

template <int P>
__global__ void __launch_bounds__(kWordCta<P>)
word_gather_kernel(const int32_t* __restrict__ table, int32_t words,
                   const int32_t* __restrict__ idx, int32_t n, int32_t nvec,
                   int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  if constexpr (P == kSmem || P == kPrefix)
    stage(smem, table, words < kSmemWords ? words : kSmemWords, threadIdx.x,
          kWordThreads);
  gather_words<kWordCta<P>>(
      [=](uint32_t i) { return fetch<P>(table, smem, i); }, idx, n, nvec, out);
}

// The table in C contiguous parts of `part` words, part r in the shared
// memory of the cluster's CTA r; word i lives in part i / part at offset
// i % part (experiments/gathers.py::cluster_home).
template <int C>
__global__ void __launch_bounds__(kWordThreads)
word_gather_cluster_kernel(const int32_t* __restrict__ table, int32_t words,
                           int32_t part, const int32_t* __restrict__ idx,
                           int32_t n, int32_t nvec,
                           int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int32_t rank = static_cast<int32_t>(cluster.block_rank());
  const int32_t lo = rank * part;
  stage(smem, table + lo, words - lo < part ? words - lo : part, threadIdx.x,
        kWordThreads);
  cluster.sync();              // every part staged before any remote read
  const int32_t* parts[C];
#pragma unroll
  for (int r = 0; r < C; ++r)
    parts[r] = r == rank ? smem
                         : cluster.map_shared_rank(static_cast<int32_t*>(smem),
                                                   r);
  gather_words<kWordThreads>(
      [=](uint32_t i) {
        const int32_t* p = parts[0];
        uint32_t off = i;
#pragma unroll
        for (int r = 1; r < C; ++r) {
          if (i >= static_cast<uint32_t>(r * part)) {
            p = parts[r];
            off = i - static_cast<uint32_t>(r * part);
          }
        }
        return p[off];
      },
      idx, n, nvec, out);
  cluster.sync();              // the others may still read this CTA's part
}

// Hashed: the next index is a multiply-shift hash of the word and the index,
// reduced to [0, words) (__umulhi), as a walk hashes its state into the
// next probe slot; for tables whose words are not indices. Else v = T[v].
template <int P, bool Hashed>
__global__ void __launch_bounds__(kThreads)
chain_gather_kernel(const int32_t* __restrict__ table, int32_t words,
                    const int32_t* __restrict__ idx, int32_t n, int32_t chain,
                    int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  if constexpr (P == kSmem) stage(smem, table, words, threadIdx.x, kThreads);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kIlp;
  for (int64_t e0 = static_cast<int64_t>(blockIdx.x) * kThreads * kIlp +
                    threadIdx.x;
       e0 < n; e0 += stride) {
    uint32_t v[kIlp];
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t e = e0 + k * kThreads;
      v[k] = e < n ? static_cast<uint32_t>(__ldcs(idx + e)) : 0u;
    }
    for (int32_t c = 0; c < chain; ++c) {
#pragma unroll
      for (int k = 0; k < kIlp; ++k) {
        const uint32_t x = static_cast<uint32_t>(fetch<P>(table, smem, v[k]));
        v[k] = Hashed ? __umulhi((x ^ v[k]) * kChainMul,
                                 static_cast<uint32_t>(words))
                      : x;
      }
    }
#pragma unroll
    for (int k = 0; k < kIlp; ++k) {
      const int64_t e = e0 + k * kThreads;
      if (e < n) __stcs(out + e, static_cast<int32_t>(v[k]));
    }
  }
}

// Block (kStrip, kStripRows); blockIdx.y picks kStrip output columns.
// Axis 1: out[i, j] = tile[i % rows, idx[i, j]], the whole tile staged.
// Axis 0: out[i, j] = tile[idx[i, j], j] (k == cols), only the strip's
// columns staged, as s[r * kStrip + c]: each lane reads its own bank.
__global__ void __launch_bounds__(kThreads)
tile_gather_kernel(const int32_t* __restrict__ tile, int32_t rows,
                   int32_t cols, const int32_t* __restrict__ idx, int32_t m,
                   int32_t k, int32_t axis, int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int tid = threadIdx.y * kStrip + threadIdx.x;
  const int32_t j0 = static_cast<int32_t>(blockIdx.y) * kStrip;
  if (axis == 0) {
    for (int32_t q = tid; q < rows * kStrip; q += kThreads) {
      const int32_t c = j0 + q % kStrip;
      smem[q] = c < cols ? __ldg(tile + static_cast<int64_t>(q / kStrip) * cols + c)
                         : 0;
    }
    __syncthreads();
  } else {
    stage(smem, tile, rows * cols, tid, kThreads);
  }
  const int32_t j = j0 + threadIdx.x;
  if (j >= k) return;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kStripRows * kIlp;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kStripRows * kIlp +
                    threadIdx.y;
       i0 < m; i0 += stride) {
    int32_t v[kIlp];
#pragma unroll
    for (int r = 0; r < kIlp; ++r) {
      const int64_t i = i0 + r * kStripRows;
      v[r] = i < m ? __ldcs(idx + i * k + j) : 0;
    }
#pragma unroll
    for (int r = 0; r < kIlp; ++r) {
      const int64_t i = i0 + r * kStripRows;
      if (i < m)
        __stcs(out + i * k + j,
               axis == 0 ? smem[v[r] * kStrip + threadIdx.x]
                         : smem[static_cast<int32_t>(static_cast<uint32_t>(i) %
                                                     static_cast<uint32_t>(rows)) *
                                    cols + v[r]]);
    }
  }
}

// G2 without staging: one thread per lookup e = i * k + j.
__global__ void __launch_bounds__(kThreads)
tile_gather_direct_kernel(const int32_t* __restrict__ tile, int32_t rows,
                          int32_t cols, const int32_t* __restrict__ idx,
                          int32_t total, int32_t k, int32_t axis,
                          int32_t* __restrict__ out) {
  const int32_t e = static_cast<int32_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= total) return;
  const uint32_t i = static_cast<uint32_t>(e) / static_cast<uint32_t>(k);
  const uint32_t j = static_cast<uint32_t>(e) - i * static_cast<uint32_t>(k);
  const int32_t v = __ldg(idx + e);
  out[e] = axis == 0
               ? __ldg(tile + static_cast<int64_t>(v) * cols + j)
               : __ldg(tile + static_cast<int64_t>(i % static_cast<uint32_t>(rows)) *
                                  cols + v);
}

// One thread per survivor s = (g, r, l) of the reference's (8, 128) groups:
// out[((g*w_out + w)*8 + r)*128 + l] = raw[((g*w_raw + w + wv)*8 + r)*128 + l]
// for w < w_out, wv = (pos[s] & 127) >> 2. A direct indexed load replaces
// the TPU's 32-way row select; neighbouring lanes write neighbouring words.
__global__ void __launch_bounds__(kThreads)
align_kernel(const int32_t* __restrict__ pos, const int32_t* __restrict__ raw,
             int32_t survivors, int32_t w_out, int32_t w_raw,
             int32_t* __restrict__ out) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (s >= survivors) return;
  const int64_t g = s >> 10;
  const int64_t rl = s & 1023;
  const int64_t wv = (__ldg(pos + s) & 127) >> 2;
  const int32_t* src = raw + ((g * w_raw + wv) << 10) + rl;
  int32_t* dst = out + ((g * w_out) << 10) + rl;
#pragma unroll 4
  for (int32_t w = 0; w < w_out; ++w)
    __stcs(dst + (static_cast<int64_t>(w) << 10),
           __ldg(src + (static_cast<int64_t>(w) << 10)));
}

// One wave of CTAs of `kernel` with `smem` dynamic bytes, at most `want`
// (for a cluster kernel, clusters of `ranks` CTAs: a multiple of it).
// The occupancy query and the attribute calls cost tens of microseconds of
// host time, more than a small case's kernel, so the wave's full size is
// kept per kernel, device and shared-memory size (the last kEntries).
// The shared-memory attribute is raised once per kernel and device, to the
// block's opt-in limit: it only permits, a launch still asks for what it
// needs.
template <typename Kernel>
cudaError_t wave(Kernel kernel, int device, size_t smem, int64_t want,
                 unsigned* grid, int ranks = 1, int threads = kThreads) {
  struct Entry {
    const void* fn = nullptr;
    int device = -1;
    size_t smem = 0;
    int64_t full = 0;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int next;
  static std::mutex mu;
  const void* fn = (const void*)kernel;
  int64_t full = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (const Entry& e : cache)
      if (e.fn == fn && e.device == device && e.smem == smem) full = e.full;
    if (full == 0) {
      int sms = 0, per_sm = 0;
      cudaError_t err =
          cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      if (err != cudaSuccess) return err;
      if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(sizeof(int32_t) * kSmemWords));
        if (err != cudaSuccess) return err;
      }
      if (ranks > 1) {
        cudaLaunchConfig_t cfg = {};
        cudaLaunchAttribute attr;
        attr.id = cudaLaunchAttributeClusterDimension;
        attr.val.clusterDim.x = ranks;
        attr.val.clusterDim.y = 1;
        attr.val.clusterDim.z = 1;
        cfg.gridDim = dim3(ranks);
        cfg.blockDim = dim3(threads);
        cfg.dynamicSmemBytes = smem;
        cfg.attrs = &attr;
        cfg.numAttrs = 1;
        int clusters = 0;
        err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
        if (err != cudaSuccess) return err;
        full = static_cast<int64_t>(clusters) * ranks;
      } else {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                            threads, smem);
        if (err != cudaSuccess) return err;
        full = static_cast<int64_t>(per_sm) * sms;
      }
      if (full == 0) return cudaErrorInvalidConfiguration;
      cache[next] = Entry{fn, device, smem, full};
      next = (next + 1) % kEntries;
    }
  }
  want = (want < 1 ? 1 : want) + ranks - 1;
  want -= want % ranks;
  *grid = static_cast<unsigned>(want < full ? want : full);
  return cudaSuccess;
}

// CTAs of `threads` for n lookups at `per_thread` a thread.
int64_t lookup_ctas(int32_t n, int per_thread, int threads = kThreads) {
  return (static_cast<int64_t>(n) + threads * per_thread - 1) /
         (threads * per_thread);
}

// Words a part of the table has in a cluster of `ranks` CTAs.
int32_t part_words(int32_t words, int ranks) {
  return (words + ranks - 1) / ranks;
}

template <int P>
cudaError_t launch_word(int device, const int32_t* table, int32_t words,
                        const int32_t* idx, int32_t n, int32_t nvec,
                        int32_t* out, cudaStream_t stream) {
  const size_t smem =
      P == kSmem ? sizeof(int32_t) * words
                 : P == kPrefix ? sizeof(int32_t) * kSmemWords : 0;
  unsigned grid = 0;
  constexpr int threads = kWordCta<P>;
  cudaError_t err = wave(word_gather_kernel<P>, device, smem,
                         lookup_ctas(n, 4, threads), &grid, 1, threads);
  if (err != cudaSuccess) return err;
  word_gather_kernel<P><<<grid, threads, smem, stream>>>(table, words, idx, n,
                                                        nvec, out);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_word_cluster(int device, const int32_t* table,
                                int32_t words, const int32_t* idx, int32_t n,
                                int32_t nvec, int32_t* out,
                                cudaStream_t stream) {
  const int32_t part = part_words(words, C);
  const size_t smem = sizeof(int32_t) * part;
  unsigned grid = 0;
  cudaError_t err = wave(word_gather_cluster_kernel<C>, device, smem,
                         lookup_ctas(n, 4, kWordThreads), &grid, C,
                         kWordThreads);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = C;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWordThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, word_gather_cluster_kernel<C>, table, words,
                            part, idx, n, nvec, out);
}

template <int P, bool Hashed>
cudaError_t launch_chain(int device, const int32_t* table, int32_t words,
                         const int32_t* idx, int32_t n, int32_t chain,
                         int32_t* out, cudaStream_t stream) {
  const size_t smem = P == kSmem ? sizeof(int32_t) * words : 0;
  unsigned grid = 0;
  cudaError_t err = wave(chain_gather_kernel<P, Hashed>, device, smem,
                         lookup_ctas(n, kIlp), &grid);
  if (err != cudaSuccess) return err;
  chain_gather_kernel<P, Hashed><<<grid, kThreads, smem, stream>>>(
      table, words, idx, n, chain, out);
  return cudaGetLastError();
}

template <int P>
cudaError_t dispatch_chain(int device, const int32_t* table, int32_t words,
                           const int32_t* idx, int32_t n, int32_t chain,
                           int32_t hashed, int32_t* out, cudaStream_t stream) {
  return hashed ? launch_chain<P, true>(device, table, words, idx, n, chain,
                                        out, stream)
                : launch_chain<P, false>(device, table, words, idx, n, chain,
                                         out, stream);
}

}  // namespace

// G1. table: int32[words]; idx, out: int32[n], each idx in [0, words);
// placement 0 smem (words <= 58,112), 1 cluster (words <= 4 x 58,112; 2
// CTAs where half the table fits one, else 4), 2 ldg, 3 cg, 4 prefix, else
// cudaErrorInvalidValue. Launches on `stream`; returns the launch's error
// (a cluster launch the card refuses included).
extern "C" int pfac_word_gather(int device, const void* table, int32_t words,
                                const void* idx, int32_t n, int32_t placement,
                                void* out, void* stream) {
  if (words <= 0 || n < 0 || placement < kSmem || placement > kPrefix ||
      (placement == kSmem && words > kSmemWords) ||
      (placement == kCluster && part_words(words, kMaxRanks) > kSmemWords))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const auto* t = static_cast<const int32_t*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  // int4 groups where both streams are 16-byte aligned, else word by word
  const int32_t nvec = (reinterpret_cast<uintptr_t>(idx) |
                        reinterpret_cast<uintptr_t>(out)) % 16
                           ? 0 : n / 4;
  switch (placement) {
    case kSmem:
      err = launch_word<kSmem>(device, t, words, i, n, nvec, o, st);
      break;
    case kCluster:
      err = part_words(words, 2) <= kSmemWords
                ? launch_word_cluster<2>(device, t, words, i, n, nvec, o, st)
                : launch_word_cluster<kMaxRanks>(device, t, words, i, n, nvec,
                                                 o, st);
      break;
    case kLdg:
      err = launch_word<kLdg>(device, t, words, i, n, nvec, o, st);
      break;
    case kPrefix:
      err = launch_word<kPrefix>(device, t, words, i, n, nvec, o, st);
      break;
    default:
      err = launch_word<kCg>(device, t, words, i, n, nvec, o, st);
  }
  return static_cast<int>(err);
}

// G2. tile: int32[rows, cols]; idx, out: int32[m, k], m * k < 2^31. Axis 1:
// each idx in [0, cols). Axis 0: k == cols, each idx in [0, rows). direct
// != 0 reads the tile through L1, one thread per lookup; else the tile
// (axis 1; rows * cols <= 58,112) or a 32-column strip of it (axis 0;
// rows * 32 <= 58,112) is staged in shared memory. Else
// cudaErrorInvalidValue.
extern "C" int pfac_tile_gather(int device, const void* tile, int32_t rows,
                                int32_t cols, const void* idx, int32_t m,
                                int32_t k, int32_t axis, int32_t direct,
                                void* out, void* stream) {
  const int64_t words = axis == 0 ? static_cast<int64_t>(rows) * kStrip
                                  : static_cast<int64_t>(rows) * cols;
  const int64_t total = static_cast<int64_t>(m) * k;
  if (rows <= 0 || cols <= 0 || m < 0 || k <= 0 || (axis != 0 && axis != 1) ||
      (axis == 0 && k != cols) || (!direct && words > kSmemWords) ||
      total > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0) return 0;
  const auto* t = static_cast<const int32_t*>(tile);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (direct) {
    const unsigned ctas = static_cast<unsigned>((total + kThreads - 1) / kThreads);
    tile_gather_direct_kernel<<<ctas, kThreads, 0, st>>>(
        t, rows, cols, i, static_cast<int32_t>(total), k, axis, o);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = sizeof(int32_t) * words;
  const unsigned strips = static_cast<unsigned>((k + kStrip - 1) / kStrip);
  unsigned grid = 0;
  const int64_t row_ctas =
      (static_cast<int64_t>(m) + kStripRows * kIlp - 1) / (kStripRows * kIlp);
  err = wave(tile_gather_kernel, device, smem, row_ctas * strips, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned gx = grid / strips > 0 ? grid / strips : 1;
  tile_gather_kernel<<<dim3(gx, strips), dim3(kStrip, kStripRows), smem, st>>>(
      t, rows, cols, i, m, k, axis, o);
  return static_cast<int>(cudaGetLastError());
}

// G3. table: int32[words]; idx, out: int32[n], each idx in [0, words);
// unless hashed, every table word too. placement 0 smem (words <= 58,112),
// 2 ldg, 3 cg (G1's numbers; no cluster, no prefix); chain >= 1. Else
// cudaErrorInvalidValue.
extern "C" int pfac_chain_gather(int device, const void* table, int32_t words,
                                 const void* idx, int32_t n, int32_t chain,
                                 int32_t placement, int32_t hashed, void* out,
                                 void* stream) {
  if (words <= 0 || n < 0 || chain < 1 || placement < kSmem ||
      placement > kCg || placement == kCluster ||
      (placement == kSmem && words > kSmemWords))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const auto* t = static_cast<const int32_t*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  auto* o = static_cast<int32_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (placement) {
    case kSmem:
      return static_cast<int>(dispatch_chain<kSmem>(device, t, words, i, n, chain, hashed, o, st));
    case kLdg:
      return static_cast<int>(dispatch_chain<kLdg>(device, t, words, i, n, chain, hashed, o, st));
    default:
      return static_cast<int>(dispatch_chain<kCg>(device, t, words, i, n, chain, hashed, o, st));
  }
}

// G4. pos: int32[groups * 1024]; raw: int32[groups * w_raw * 1024];
// out: int32[groups * w_out * 1024]; w_out + 31 <= w_raw, else
// cudaErrorInvalidValue.
extern "C" int pfac_align(int device, const void* pos, const void* raw,
                          int32_t groups, int32_t w_out, int32_t w_raw,
                          void* out, void* stream) {
  if (groups < 0 || w_out <= 0 || w_out + kAlignSpan - 1 > w_raw)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t survivors = static_cast<int64_t>(groups) * 1024;
  if (survivors == 0) return 0;
  align_kernel<<<static_cast<unsigned>(survivors / kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pos), static_cast<const int32_t*>(raw),
      static_cast<int32_t>(survivors), w_out, w_raw,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
