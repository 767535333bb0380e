// One host call a match: the sieve engine's chain of kernels as a CUDA
// graph, built once for each (device, npad) and replayed with each call's
// pointers. The counterpart of the JAX package's compiled programs:
// pfac_tpu/backends/pallas_sieve.py::SieveMatcher._pipeline_fn (build_pipeline
// jitted once for each (npad, cap, aligned), one dispatch a call), the
// jitted reduce_from_dense, and the sharded call's one jitted shard_map
// with its count (pfac_tpu/dist/sharding.py).
//
// A program holds, for each shard on its device, the chain that
// backends/pipeline.py::run launches one wrapper at a time:
//   K1 -> [walk tables: K3 -> compact_scan -> compact -> K2]
//         [CSR tables: compact_scan -> compact -> csr_walk]
//         [match_reduce_device: reduce_kernel -> reduce_tail_kernel]
// and, for a sharded call that asks for it, the count kernel (count.cu)
// after every shard's chain. The shards' chains are independent branches
// of the graph, so the card may run them side by side. The words that must
// be zero at each launch (K1's per-block counts and tile counter, the
// count) are zeroed by cudaMemsetAsync on the same stream just before the
// graph's launch, not by memset nodes: a launch right after a memset
// node's destination was updated crashed the process on the H100 in half
// the runs while torch.profiler traced the card (PERF.md §6). Each node
// is what the kernel's own entry point would launch (launch.cuh: the same
// *_launch functions compute the grids, the shared memory and the
// arguments), so the program and the wrappers cannot drift apart.
//
// What this saves is host time: one call into this library a match in
// place of five to seven wrapper calls, each with its Python checks, its
// allocations and its ctypes marshalling (PERF.md). The geometry (the
// placements, the persistent grids, the compaction's threshold and
// capacity, K2's and K3's plans) is computed once, by the caller, and comes
// in a Spec; the scratch is one buffer, carved by the Spec's offsets.
//
// A launch recomputes every node's parameters for the call's pointers
// (cheap: the grids are cached) and updates, in the executable graph, only
// the nodes whose parameters changed (a caching allocator hands back the
// same buffers call after call), zeroes the words above, then launches the
// graph on the caller's stream. Nothing here waits for the device. A
// failed build, update or launch returns its cudaError_t; the caller
// raises.
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>
#include <new>
#include <vector>

#include "launch.cuh"

namespace {

enum Tier : int32_t { kSieveOnly = 0, kWalkTables = 1, kCsr = 2 };

// Mirrored by backends/program.py::Spec (ctypes, the same field order).
// Offsets are in bytes; a shard's part of the scratch starts at
// shard * shard_bytes.
struct Spec {
  int32_t device, shards, npad, block, nblocks;
  int32_t placement, sieve_words, res_off;     // K1
  int32_t tier;
  int32_t thresh, capacity;                    // the compaction
  int32_t walk_words, walk_nsteps, look, tile_cap, k3_resident, k2_resident;
  int32_t csr_nsteps;
  int32_t reduce, count;                       // 0 or 1
  // each kernel's first word in `counters` (backends/program.py::
  // counter_words, from the order of trace.DEVICE_KEYS)
  int32_t scan_word, short_probes_word, walk_word, block_walk_word,
      compact_word;
  int64_t shard_bytes, bits_at, counts_at, offsets_at, pos_at;
  int64_t match_at;   // -1: the match is the result (shard s at s * npad)
  int64_t count_at;   // the count word's offset in the result (count = 1)
  const void* sieve_arena;
  const void* sieve_desc;
  const void* walk_arena;   // K2's and K3's (backends/walk_tables.py)
  const void* walk_desc;    // K3's
  const void* walk_records; // K2's
  const void* csr_arena;
  const void* csr_desc;
  void* counters;     // int64 words: survivors and dense blocks
                      // (compact_scan), short probes (K1), walk steps and
                      // lane slots (K2), probes and positions (K3), chunks
                      // listed word by word (compact); or null
};

// What changes from call to call.
struct Inputs {
  const uint64_t* data;   // a shard's bytes each
  const int32_t* n;       // a shard's valid bytes each
  char* result;
  char* scratch;
  void* status;           // the reduce's look-back words
  int64_t nstatus;
  uint32_t epoch;
  int64_t count_len;      // the words of each shard the count reads
};

constexpr int kRoot = -1;   // a step of no shard's chain
constexpr int kJoin = -2;   // a node after every shard's chain

// A kernel launch (a node of the graph) or words to zero before it.
struct Step {
  int chain = kRoot;        // the shard whose chain it extends
  bool is_memset = false;
  pfac::Launch k;
  void* dst = nullptr;      // a memset's words
  size_t bytes = 0;
};

Step memset_step(int chain, void* dst, int64_t words) {
  Step s;
  s.chain = chain;
  s.is_memset = true;
  s.dst = dst;
  s.bytes = 4 * static_cast<size_t>(words);
  return s;
}

// The steps of a program for `in`, in the order the graph's nodes are
// added: each shard's chain, then the count.
cudaError_t plan(const Spec& sp, const Inputs& in, std::vector<Step>& out) {
  out.clear();
  out.reserve(8 * sp.shards + 2);   // no reallocation: kernel() keeps pointers
  const int64_t npad4 = 4LL * sp.npad;
  for (int s = 0; s < sp.shards; ++s) {
    char* part = in.scratch + s * sp.shard_bytes;
    char* bits = part + sp.bits_at;
    char* counts = part + sp.counts_at;
    char* offsets = part + sp.offsets_at;
    char* pos = part + sp.pos_at;
    char* match = sp.match_at >= 0 ? part + sp.match_at
                                   : in.result + s * npad4;
    const void* data = reinterpret_cast<const void*>(in.data[s]);
    const int32_t n = in.n[s];
    int64_t* const words = static_cast<int64_t*>(sp.counters);
    auto word = [&](int32_t at) -> void* {
      return words == nullptr ? nullptr : words + at;
    };
    cudaError_t err;
    out.push_back(memset_step(s, counts, sp.nblocks + 1));
    auto kernel = [&]() -> pfac::Launch* {
      out.emplace_back();
      out.back().chain = s;
      return &out.back().k;
    };
    err = pfac::sieve_launch(sp.device, data, n, sp.npad, sp.sieve_arena,
                             sp.sieve_words, sp.res_off, sp.sieve_desc,
                             sp.placement, match, bits, counts, sp.block,
                             word(sp.short_probes_word), kernel());
    if (err != cudaSuccess) return err;
    if (sp.tier == kWalkTables) {
      err = pfac::block_walk_launch(
          sp.device, data, n, counts, sp.nblocks, sp.block, sp.thresh,
          sp.walk_arena, sp.walk_words, sp.k3_resident, sp.walk_desc,
          sp.walk_nsteps, sp.look, sp.tile_cap, match,
          word(sp.block_walk_word), kernel());
      if (err != cudaSuccess) return err;
    }
    if (sp.tier != kSieveOnly) {
      err = pfac::compact_scan_launch(counts, sp.nblocks, sp.thresh, offsets,
                                      word(sp.scan_word), kernel());
      if (err != cudaSuccess) return err;
      err = pfac::compact_launch(bits, counts, offsets, sp.nblocks, sp.block,
                                 sp.thresh, pos, word(sp.compact_word),
                                 kernel());
      if (err != cudaSuccess) return err;
      const void* total = offsets + 4LL * sp.nblocks;   // on the device
      if (sp.tier == kWalkTables)
        err = pfac::walk_launch(sp.device, data, n, pos, total, sp.capacity,
                                sp.walk_arena, sp.walk_words, sp.k2_resident,
                                sp.walk_records, sp.walk_nsteps, match,
                                word(sp.walk_word), kernel());
      else
        err = pfac::csr_walk_launch(sp.device, data, n, pos, total,
                                    sp.capacity, sp.csr_arena, sp.csr_desc,
                                    sp.csr_nsteps, match, kernel());
      if (err != cudaSuccess) return err;
    }
    if (sp.reduce) {
      pfac::Launch* body = kernel();
      pfac::Launch* tail = kernel();
      err = pfac::reduce_launch(sp.device, match, sp.npad, in.result,
                                in.result + npad4, in.result + 2 * npad4,
                                in.status, in.nstatus, in.epoch, body, tail);
      if (err != cudaSuccess) return err;
    }
  }
  if (sp.count) {
    char* word = in.result + sp.count_at;
    out.push_back(memset_step(kRoot, word, 2));
    out.emplace_back();
    out.back().chain = kJoin;
    const cudaError_t err = pfac::count_launch(
        sp.device, in.result, in.count_len, sp.npad, sp.shards, word,
        &out.back().k);
    if (err != cudaSuccess) return err;
  }
  for (const Step& st : out)
    if (!st.is_memset && st.k.func == nullptr)   // a launch with nothing to do
      return cudaErrorInvalidValue;
  return cudaSuccess;
}

struct Program {
  Spec spec;
  std::mutex mu;                 // an update and its launch go together
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
  std::vector<cudaGraphNode_t> nodes;   // a step's node (null: a memset)
  std::vector<Step> applied;     // what each node of `exec` holds
  std::vector<Step> next;        // the call's plan

  ~Program() {
    if (exec != nullptr) cudaGraphExecDestroy(exec);
    if (graph != nullptr) cudaGraphDestroy(graph);
  }
};

cudaError_t build(Program* p) {
  cudaError_t err = cudaGraphCreate(&p->graph, 0);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> last(p->spec.shards, nullptr);
  for (Step& st : p->applied) {
    cudaGraphNode_t node = nullptr;
    if (!st.is_memset) {
      std::vector<cudaGraphNode_t> deps;
      if (st.chain >= 0 && last[st.chain] != nullptr)
        deps.push_back(last[st.chain]);
      else if (st.chain == kJoin)
        deps = last;
      const cudaKernelNodeParams kp = st.k.node();
      err = cudaGraphAddKernelNode(&node, p->graph, deps.data(), deps.size(),
                                   &kp);
      if (err != cudaSuccess) return err;
      if (st.chain >= 0) last[st.chain] = node;
    }
    p->nodes.push_back(node);
  }
  return cudaGraphInstantiateWithFlags(&p->exec, p->graph, 0);
}

cudaError_t run(Program* p, const Inputs& in, cudaStream_t stream) {
  std::lock_guard<std::mutex> lock(p->mu);
  cudaError_t err = cudaSetDevice(p->spec.device);
  if (err != cudaSuccess) return err;
  err = plan(p->spec, in, p->next);
  if (err != cudaSuccess) return err;
  if (p->next.size() != p->applied.size()) return cudaErrorInvalidValue;
  for (size_t i = 0; i < p->next.size(); ++i) {
    Step& st = p->next[i];
    if (st.is_memset) {
      err = cudaMemsetAsync(st.dst, 0, st.bytes, stream);
    } else if (!st.k.same(p->applied[i].k)) {
      const cudaKernelNodeParams kp = st.k.node();
      err = cudaGraphExecKernelNodeSetParams(p->exec, p->nodes[i], &kp);
      if (err == cudaSuccess) p->applied[i] = st;
    }
    if (err != cudaSuccess) return err;
  }
  return cudaGraphLaunch(p->exec, stream);
}

bool valid(const Spec& sp) {
  return sp.shards >= 1 && sp.npad > 0 && sp.block > 0 &&
         sp.nblocks == sp.npad / sp.block && sp.tier >= kSieveOnly &&
         sp.tier <= kCsr && (sp.reduce == 0 || sp.shards == 1) &&
         (sp.count == 0 || sp.count_at >= 0) &&
         (sp.reduce == 0 || sp.match_at >= 0) &&
         (sp.counters == nullptr ||
          (sp.scan_word >= 0 && sp.short_probes_word >= 0 &&
           sp.walk_word >= 0 && sp.block_walk_word >= 0));
}

}  // namespace

// Builds and instantiates the program of `spec` (a backends/program.py::Spec)
// with the first call's inputs as its nodes' parameters, into *out. data,
// n: a pointer and a length a shard; result, scratch: laid out as the Spec
// says; status, nstatus, epoch: the reduce's look-back words (with reduce);
// count_len: the words of each shard the count reads (with count). The
// kernels' shared-memory attributes are set before the graph is built.
// Returns a cudaError_t; on an error *out is null.
extern "C" int pfac_program_create(const void* spec, const uint64_t* data,
                                   const int32_t* n, void* result,
                                   void* scratch, void* status,
                                   int64_t nstatus, uint32_t epoch,
                                   int64_t count_len, void** out) {
  *out = nullptr;
  const Spec& sp = *static_cast<const Spec*>(spec);
  if (!valid(sp)) return static_cast<int>(cudaErrorInvalidValue);
  Program* p = new (std::nothrow) Program;
  if (p == nullptr) return static_cast<int>(cudaErrorMemoryAllocation);
  p->spec = sp;
  const Inputs in{data, n, static_cast<char*>(result),
                  static_cast<char*>(scratch), status, nstatus, epoch,
                  count_len};
  cudaError_t err = cudaSetDevice(sp.device);
  if (err == cudaSuccess) err = plan(sp, in, p->applied);
  if (err == cudaSuccess) err = build(p);
  if (err != cudaSuccess) {
    delete p;
    return static_cast<int>(err);
  }
  *out = p;
  return 0;
}

// One shard's call: updates the program's nodes for these pointers and
// launches it on `stream`. Returns the first cudaError_t.
extern "C" int pfac_program_launch(void* prog, const void* data, int32_t n,
                                   void* result, void* scratch, void* status,
                                   int64_t nstatus, uint32_t epoch,
                                   void* stream) {
  const uint64_t ptr = reinterpret_cast<uint64_t>(data);
  const Inputs in{&ptr, &n, static_cast<char*>(result),
                  static_cast<char*>(scratch), status, nstatus, epoch, 0};
  return static_cast<int>(run(static_cast<Program*>(prog), in,
                              static_cast<cudaStream_t>(stream)));
}

// A sharded call: a pointer and a length a shard of the device, in order.
extern "C" int pfac_program_launch_shards(void* prog, const uint64_t* data,
                                          const int32_t* n, void* result,
                                          void* scratch, int64_t count_len,
                                          void* stream) {
  const Inputs in{data, n, static_cast<char*>(result),
                  static_cast<char*>(scratch), nullptr, 0, 0, count_len};
  return static_cast<int>(run(static_cast<Program*>(prog), in,
                              static_cast<cudaStream_t>(stream)));
}

// Destroys the program (its graph and executable graph); returns 0.
extern "C" int pfac_program_destroy(void* prog) {
  delete static_cast<Program*>(prog);
  return 0;
}
