// Native host-side pattern compiler for pfac_tpu_torch: a copy of
// pfac_tpu/native/pfac_host.cpp, built by core/native.py into _build/.
//
// Equivalent of the reference's C++ host compiler
// (reference: PFAC/src/PFAC_reorder_Table.cpp:121-329 — parser, sort,
// trie builder; PFAC/src/PFAC.cpp:422-648 — hash codegen host loops),
// re-designed for this framework's table formats:
//   * pfac_compile: pattern buffer -> sorted order, IDs, trie edge list
//   * chd_assign:   CHD displacement search for the probe tables
//     (the build-time hot loop; the reference's analog is the per-state
//      k-search, PFAC/src/PFAC.cpp:519-542)
//
// Exposed as a plain C ABI consumed via ctypes (core/native.py). The
// Python implementations remain as the behavioral oracle; differential
// tests enforce bit-identical outputs.
//
// Build: g++ -O2 -shared -fPIC -o libpfac_host.so pfac_host.cpp

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// pattern parsing + reordering + trie construction
// ---------------------------------------------------------------------------

struct PfacCompileResult {
  // trie edges in insertion order: (state, ch, next) triplets
  int32_t* edges;
  int64_t num_edges;
  // per sorted-index pattern info
  int32_t* pat_offset;  // byte offset of pattern start in the input buffer
  int32_t* pat_id;      // original 1-based pattern ID
  int32_t* pat_len_by_id;  // [k+1], entry 0 unused
  int32_t num_patterns;
  int32_t num_states;
  int32_t initial_state;
  int32_t num_leaves;
  int32_t status;  // 0 ok
};

static int32_t* copy_vec(const std::vector<int32_t>& v) {
  int32_t* p = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * std::max<size_t>(1, v.size())));
  if (p) std::memcpy(p, v.data(), sizeof(int32_t) * v.size());
  return p;
}

// Parse newline-delimited patterns from `data`, assign IDs by file order of
// non-empty lines, ignore a trailing unterminated line, sort prefix-first
// lexicographic (stable), and build the failureless-AC trie with the
// reference's state numbering: finals 1..k, initial k+1, interior k+2...
PfacCompileResult* pfac_compile(const uint8_t* data, int64_t size) {
  auto* res = static_cast<PfacCompileResult*>(std::calloc(1, sizeof(PfacCompileResult)));
  if (!res) return nullptr;

  // ---- parse
  struct Pat { int64_t off; int32_t len; int32_t id; };
  std::vector<Pat> pats;
  int64_t start = 0;
  for (int64_t i = 0; i < size; ++i) {
    if (data[i] == '\n') {
      if (i > start) {
        pats.push_back({start, static_cast<int32_t>(i - start),
                        static_cast<int32_t>(pats.size() + 1)});
      }
      start = i + 1;
    }
  }
  const int32_t k = static_cast<int32_t>(pats.size());
  if (k == 0) { res->status = 1; return res; }

  // ---- stable sort, prefix-first lexicographic (== bytewise less)
  std::stable_sort(pats.begin(), pats.end(), [&](const Pat& a, const Pat& b) {
    const int32_t n = std::min(a.len, b.len);
    const int c = std::memcmp(data + a.off, data + b.off, static_cast<size_t>(n));
    if (c != 0) return c < 0;
    return a.len < b.len;
  });

  // ---- trie build (reference semantics; duplicate final edges replaced)
  const int32_t initial_state = k + 1;
  int32_t state_num = initial_state + 1;
  // per-state adjacency: insertion-ordered edge list + map for O(1) lookup
  std::vector<std::vector<std::pair<int32_t, int32_t>>> rows(2 * (k + 2));
  std::vector<std::unordered_map<int32_t, int32_t>> maps(rows.size());
  auto ensure = [&](int32_t s) {
    if (static_cast<size_t>(s) >= rows.size()) {
      rows.resize(s + 64);
      maps.resize(rows.size());
    }
  };
  ensure(initial_state);

  for (const Pat& p : pats) {
    int32_t state = initial_state;
    for (int32_t o = 0; o < p.len; ++o) {
      const int32_t ch = data[p.off + o];
      ensure(state);
      if (o == p.len - 1) {
        auto it = maps[state].find(ch);
        if (it != maps[state].end()) {
          // duplicate pattern: replace edge target in place (last ID wins,
          // matching the reference's dense-table overwrite order)
          for (auto& e : rows[state])
            if (e.first == ch) e.second = p.id;
          it->second = p.id;
        } else {
          rows[state].push_back({ch, p.id});
          maps[state][ch] = p.id;
        }
      } else {
        auto it = maps[state].find(ch);
        if (it == maps[state].end()) {
          rows[state].push_back({ch, state_num});
          maps[state][ch] = state_num;
          state = state_num++;
        } else {
          state = it->second;
        }
      }
    }
  }

  // ---- emit
  std::vector<int32_t> edges;
  for (int32_t s = 0; s < state_num; ++s) {
    for (auto& e : rows[s]) {
      edges.push_back(s);
      edges.push_back(e.first);
      edges.push_back(e.second);
    }
  }
  std::vector<int32_t> off(k), ids(k), lens(k + 1, 0);
  int32_t leaves = 0;
  for (int32_t i = 0; i < k; ++i) {
    off[i] = static_cast<int32_t>(pats[i].off);
    ids[i] = pats[i].id;
    lens[pats[i].id] = pats[i].len;
  }
  for (int32_t s = 1; s <= k; ++s)
    if (static_cast<size_t>(s) >= rows.size() || rows[s].empty()) ++leaves;

  res->edges = copy_vec(edges);
  res->num_edges = static_cast<int64_t>(edges.size() / 3);
  res->pat_offset = copy_vec(off);
  res->pat_id = copy_vec(ids);
  res->pat_len_by_id = copy_vec(lens);
  res->num_patterns = k;
  res->num_states = state_num;
  res->initial_state = initial_state;
  res->num_leaves = leaves;
  res->status = 0;
  return res;
}

void pfac_compile_free(PfacCompileResult* r) {
  if (!r) return;
  std::free(r->edges);
  std::free(r->pat_offset);
  std::free(r->pat_id);
  std::free(r->pat_len_by_id);
  std::free(r);
}

// ---------------------------------------------------------------------------
// CHD displacement search (bit-identical to core/chd.py::_assign_slots)
// ---------------------------------------------------------------------------

static inline uint32_t h_bucket(uint32_t key, int lg_b) {
  return (key * 0x9E3779B1u) >> (32 - lg_b);
}

static inline uint32_t h_slot(uint32_t key, int lg_r, uint32_t mul) {
  return (key * mul) >> (32 - lg_r);
}

// Returns 0 on success. disp: uint16[b]; slot_of: int32[n].
// fused != 0: bucket and h1 both derive from keys[i]*slot_mul (the sieve
// kernel's one-multiply probe); fused == 0: classic split hashing.
static int chd_assign_impl(const uint32_t* keys, int64_t n, int32_t r,
                           int32_t b, uint32_t slot_mul, int fused,
                           uint16_t* disp, int32_t* slot_of) {
  int lg_r = 0, lg_b = 0;
  while ((1 << lg_r) < r) ++lg_r;
  while ((1 << lg_b) < b) ++lg_b;

  std::vector<std::vector<int64_t>> buckets(b);
  std::vector<uint32_t> h1(n);
  for (int64_t i = 0; i < n; ++i) {
    if (fused) {
      const uint32_t prod = keys[i] * slot_mul;
      buckets[(prod >> (32 - lg_b)) & static_cast<uint32_t>(b - 1)].push_back(i);
      h1[i] = (prod >> (32 - lg_b - lg_r)) & static_cast<uint32_t>(r - 1);
    } else {
      buckets[h_bucket(keys[i], lg_b)].push_back(i);
      h1[i] = h_slot(keys[i], lg_r, slot_mul) & static_cast<uint32_t>(r - 1);
    }
  }
  std::vector<int32_t> order(b);
  for (int32_t i = 0; i < b; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(), [&](int32_t x, int32_t y) {
    return buckets[x].size() > buckets[y].size();
  });

  std::vector<uint8_t> occupied(r, 0);
  std::memset(disp, 0, sizeof(uint16_t) * b);
  const int32_t d_max = std::min(65536, 4 * r);
  for (int32_t bi : order) {
    auto& members = buckets[bi];
    if (members.empty()) continue;
    // intra-bucket h1 collision => unsolvable with displacement
    for (size_t x = 0; x < members.size(); ++x)
      for (size_t y = x + 1; y < members.size(); ++y)
        if (h1[members[x]] == h1[members[y]]) return 2;
    bool found = false;
    for (int32_t d = 0; d < d_max; ++d) {
      bool free_ok = true;
      for (int64_t m : members) {
        if (occupied[(h1[m] ^ d) & (r - 1)]) { free_ok = false; break; }
      }
      if (free_ok) {
        for (int64_t m : members) {
          const int32_t s = (h1[m] ^ d) & (r - 1);
          occupied[s] = 1;
          slot_of[m] = s;
        }
        disp[bi] = static_cast<uint16_t>(d);
        found = true;
        break;
      }
    }
    if (!found) return 3;
  }
  return 0;
}

int chd_assign(const uint32_t* keys, int64_t n, int32_t r, int32_t b,
               uint32_t slot_mul, uint16_t* disp, int32_t* slot_of) {
  return chd_assign_impl(keys, n, r, b, slot_mul, /*fused=*/0, disp, slot_of);
}

int chd_assign_fused(const uint32_t* keys, int64_t n, int32_t r, int32_t b,
                     uint32_t slot_mul, uint16_t* disp, int32_t* slot_of) {
  return chd_assign_impl(keys, n, r, b, slot_mul, /*fused=*/1, disp, slot_of);
}

int pfac_host_abi_version() { return 2; }

}  // extern "C"
