// One kernel launch as a value: what each source's host code computes for
// its kernels (function, grid, shared memory, arguments), so that a launch
// can go straight to a stream (the per-kernel entry points, pfac_sieve and
// the others) or become a node of a CUDA graph (program.cu).
//
// Each source defines its *_launch function below. It checks the arguments
// as its entry point documents them, computes the geometry (the persistent
// grids and the shared-memory attributes are cached per device, so this
// costs no more host time than a plain launch) and fills the Launch. A
// Launch with no function is a launch that has nothing to do (an empty
// input). The device must be current.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace pfac {

template <class T>
struct Same {
  using type = T;
};

struct Launch {
  static constexpr int kMaxArgs = 16;
  const void* func = nullptr;
  dim3 grid, block;
  unsigned smem = 0;
  int nargs = 0;
  uint64_t vals[kMaxArgs];   // each argument's bytes, in its own slot
  void* ptrs[kMaxArgs];

  // The kernel `fn` with its arguments, each converted to the type of its
  // parameter (the kernel's signature decides, so a slot always holds the
  // bytes the kernel reads).
  template <class... P>
  void set(void (*fn)(P...), unsigned blocks, unsigned threads,
           int64_t shared, typename Same<P>::type... args) {
    static_assert(sizeof...(P) <= kMaxArgs, "too many kernel arguments");
    func = reinterpret_cast<const void*>(fn);
    grid = dim3(blocks);
    block = dim3(threads);
    smem = static_cast<unsigned>(shared);
    nargs = 0;
    (put(args), ...);
  }

  template <class T>
  void put(T v) {
    static_assert(sizeof(T) <= sizeof(uint64_t), "argument wider than a slot");
    vals[nargs] = 0;
    std::memcpy(&vals[nargs], &v, sizeof(T));
    ++nargs;
  }

  void** args() {
    for (int i = 0; i < nargs; ++i) ptrs[i] = &vals[i];
    return ptrs;
  }

  cudaKernelNodeParams node() {
    cudaKernelNodeParams p{};
    p.func = const_cast<void*>(func);
    p.gridDim = grid;
    p.blockDim = block;
    p.sharedMemBytes = smem;
    p.kernelParams = args();
    p.extra = nullptr;
    return p;
  }

  // Whether `o` launches the same function the same way with the same
  // arguments.
  bool same(const Launch& o) const {
    return func == o.func && grid.x == o.grid.x && grid.y == o.grid.y &&
           grid.z == o.grid.z && block.x == o.block.x && smem == o.smem &&
           nargs == o.nargs &&
           std::memcmp(vals, o.vals, sizeof(uint64_t) * nargs) == 0;
  }

  // Launches on `s`; the launch's error (cleared from the runtime's last
  // error, so that a later call does not report it again).
  cudaError_t launch(cudaStream_t s) {
    if (func == nullptr) return cudaSuccess;
    const cudaError_t err = cudaLaunchKernel(func, grid, block, args(), smem, s);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
  }
};

// sieve.cu: K1 in `placement` (0 smem, 1 cluster, 2 global); its m2 and
// m3 key probes added to the int64 *short_probes, or null
cudaError_t sieve_launch(int device, const void* data, int32_t n, int32_t npad,
                         const void* arena, int32_t words, int32_t res_off,
                         const void* desc, int32_t placement, void* match,
                         void* bits, void* counts, int32_t block,
                         void* short_probes, Launch* l);
// compact.cu: the scan's survivors and dense blocks added to the int64
// counters[0] and counters[1], the chunks compact_kernel listed word by
// word to its counters[0], or null
cudaError_t compact_scan_launch(const void* counts, int32_t nblocks,
                                int32_t thresh, void* offsets, void* counters,
                                Launch* l);
cudaError_t compact_launch(const void* bits, const void* counts,
                           const void* offsets, int32_t nblocks, int32_t block,
                           int32_t thresh, void* pos, void* counters,
                           Launch* l);
// block_walk.cu: K3 over the walk tables (arena, desc: values in 16 bits,
// backends/walk_tables.py::pack_walk); its probes and the positions it
// walked added to the int64 counters[0] and counters[1], or null
cudaError_t block_walk_launch(int device, const void* data, int32_t n,
                              const void* counts, int32_t nblocks,
                              int32_t block, int32_t thresh, const void* arena,
                              int32_t words, int32_t resident,
                              const void* desc, int32_t nsteps, int32_t look,
                              int32_t cap, void* out, void* counters,
                              Launch* l);
// walk.cu: K2 over the same walk tables, found by their records
// (backends/walk_tables.py::walk_records); its walk steps and lane slots
// added to the int64 counters[0] and counters[1], or null
cudaError_t walk_launch(int device, const void* data, int32_t n,
                        const void* pos, const void* count, int32_t cap,
                        const void* arena, int32_t words, int32_t resident,
                        const void* records, int32_t nsteps, void* out,
                        void* counters, Launch* l);
// csr_walk.cu
cudaError_t csr_walk_launch(int device, const void* data, int32_t n,
                            const void* pos, const void* count, int32_t cap,
                            const void* arena, const void* desc,
                            int32_t nsteps, void* out, Launch* l);
// reduce.cu: reduce_kernel into `body`, reduce_tail_kernel into `tail`
cudaError_t reduce_launch(int device, const void* result, int32_t npad,
                          void* ids, void* pos, void* count, void* status,
                          int64_t nstatus, uint32_t epoch, Launch* body,
                          Launch* tail);
// count.cu: the nonzero words of `nseg` segments of `len` words, `stride`
// words apart, added into the int64 *out (zeroed by the caller)
cudaError_t count_launch(int device, const void* r, int64_t len,
                         int64_t stride, int32_t nseg, void* out, Launch* l);
// lockstep.cu: lockstep_dense_kernel, or lockstep_hash_kernel if `hashed`;
// the pair states from `form` in shared memory, or from pair_state through
// L1/L2 where `form` is null
cudaError_t lockstep_launch(int device, const void* data, int64_t n,
                            int64_t npad, const void* pair_state,
                            const void* pair_match, const void* form,
                            int32_t form_words, int32_t hashed, const void* t0,
                            const void* t1, const void* t2, const void* t3,
                            int32_t num_final, int32_t max_len, void* out,
                            Launch* l);

}  // namespace pfac
