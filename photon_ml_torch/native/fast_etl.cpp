// Native host-side ETL: the rebuild's C++ runtime for data preparation.
//
// Reference counterpart: the JVM executors' deserialization + shuffle
// machinery (Spark's netty/torrent substrate, SURVEY.md §5.8) and the
// Avro decode path of AvroDataReader [expected reference structure;
// mount unavailable].  The reference leans on the JVM for its data
// plane; the TPU rebuild's data plane is this library + numpy, feeding
// statically-shaped HBM arrays.
//
// Everything here is single-pass, cache-friendly C++ with no
// dependencies beyond the C++17 standard library.  The Python side
// (photon_ml_tpu.native) binds via ctypes and falls back to numpy
// implementations when the shared object is unavailable, so the
// framework never hard-depends on a compiler at runtime.
//
// Exposed surface (extern "C", handle-based two-phase protocol so the
// caller allocates numpy arrays of exactly the right size):
//
//   LIBSVM text  -> CSR-ish (row_ptr, cols, vals, labels)
//   row-ELL      -> transposed-ELL (the colmajor build: counting sort
//                   by column + virtual-row splitting; O(nnz + dim))

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

struct LibsvmResult {
  std::vector<float> labels;
  std::vector<int64_t> row_ptr;  // [n+1]
  std::vector<int32_t> cols;
  std::vector<float> vals;
  int32_t max_col = -1;
};

// Minimal fast float parse: LIBSVM files carry plain decimal floats.
// strtof handles all forms; the win over Python is avoiding per-token
// object allocation, not exotic float parsing.
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// LIBSVM parsing
// ---------------------------------------------------------------------------

void* pml_libsvm_parse(const char* buf, int64_t len) {
  auto* r = new (std::nothrow) LibsvmResult();
  if (!r) return nullptr;
  r->row_ptr.push_back(0);
  const char* p = buf;
  const char* end = buf + len;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    p = skip_ws(p, line_end);
    if (p < line_end && *p != '#') {
      char* q = nullptr;
      float label = strtof(p, &q);
      if (q == p || q > line_end) {
        delete r;
        return nullptr;
      }
      p = q;
      while (p < line_end) {
        p = skip_ws(p, line_end);
        if (p >= line_end || *p == '#') break;
        long idx = strtol(p, &q, 10);
        if (q == p || q >= line_end || *q != ':') {
          delete r;
          return nullptr;
        }
        p = q + 1;
        float v = strtof(p, &q);
        // strtof may legally run past line_end (the buffer is contiguous
        // across lines), which would silently consume the next line's
        // tokens; a value must both exist and end within its own line.
        if (q == p || q > line_end) {
          delete r;
          return nullptr;
        }
        p = q;
        // Raw file index; 0/1-based conversion happens in Python
        // (vectorized), which also validates the resulting range.
        if (idx < 0 || idx > INT32_MAX) {
          delete r;
          return nullptr;
        }
        int32_t c = static_cast<int32_t>(idx);
        r->cols.push_back(c);
        r->vals.push_back(v);
        if (c > r->max_col) r->max_col = c;
      }
      r->labels.push_back(label);
      r->row_ptr.push_back(static_cast<int64_t>(r->cols.size()));
    }
    p = line_end + 1;
  }
  return r;
}

void pml_libsvm_sizes(void* handle, int64_t* n_rows, int64_t* nnz,
                      int32_t* max_col) {
  auto* r = static_cast<LibsvmResult*>(handle);
  *n_rows = static_cast<int64_t>(r->labels.size());
  *nnz = static_cast<int64_t>(r->cols.size());
  *max_col = r->max_col;
}

void pml_libsvm_fill(void* handle, float* labels, int64_t* row_ptr,
                     int32_t* cols, float* vals) {
  auto* r = static_cast<LibsvmResult*>(handle);
  memcpy(labels, r->labels.data(), r->labels.size() * sizeof(float));
  memcpy(row_ptr, r->row_ptr.data(), r->row_ptr.size() * sizeof(int64_t));
  memcpy(cols, r->cols.data(), r->cols.size() * sizeof(int32_t));
  memcpy(vals, r->vals.data(), r->vals.size() * sizeof(float));
}

void pml_libsvm_free(void* handle) {
  delete static_cast<LibsvmResult*>(handle);
}

// ---------------------------------------------------------------------------
// Transposed-ELL (colmajor) build — see data/colmajor.py for the design.
// Counting sort by column: O(nnz + dim), one read pass + one write pass.
// ---------------------------------------------------------------------------

// Phase 1: count virtual rows for (cols, vals, capacity).  Returns V, or
// -1 on invalid input.  col_counts must be a caller-zeroed [dim] int64
// scratch; it is left holding the per-column nonzero counts for phase 2.
int64_t pml_colmajor_vrows(const int32_t* cols, const float* vals,
                           int64_t n, int64_t k, int64_t dim,
                           int64_t capacity, int64_t* col_counts) {
  const int64_t total = n * k;
  for (int64_t e = 0; e < total; ++e) {
    if (vals[e] != 0.0f) {
      const int32_t c = cols[e];
      if (c < 0 || c >= dim) return -1;
      ++col_counts[c];
    }
  }
  int64_t v = 0;
  for (int64_t j = 0; j < dim; ++j) {
    v += (col_counts[j] + capacity - 1) / capacity;
  }
  return v;
}

// Phase 2: fill caller-allocated tvals [v_pad*capacity] (zeroed),
// trows [v_pad*capacity] (zeroed), vcol [v_pad] (zeroed).  col_counts is
// the phase-1 output.  Entries keep row order within each column
// (counting sort is stable in row-scan order).
void pml_colmajor_fill(const int32_t* cols, const float* vals,
                       int64_t n, int64_t k, int64_t dim,
                       int64_t capacity, const int64_t* col_counts,
                       int64_t v_pad, float* tvals, int32_t* trows,
                       int32_t* vcol) {
  // Per-column virtual-row base and running cursor.
  std::vector<int64_t> vrow_base(static_cast<size_t>(dim) + 1, 0);
  for (int64_t j = 0; j < dim; ++j) {
    vrow_base[static_cast<size_t>(j) + 1] =
        vrow_base[static_cast<size_t>(j)] +
        (col_counts[j] + capacity - 1) / capacity;
  }
  for (int64_t j = 0; j < dim; ++j) {
    const int64_t first = vrow_base[static_cast<size_t>(j)];
    const int64_t nv = vrow_base[static_cast<size_t>(j) + 1] - first;
    for (int64_t t = 0; t < nv; ++t) {
      vcol[first + t] = static_cast<int32_t>(j);
    }
  }
  std::vector<int64_t> cursor(static_cast<size_t>(dim), 0);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row_off = i * k;
    for (int64_t s = 0; s < k; ++s) {
      const float v = vals[row_off + s];
      if (v == 0.0f) continue;
      const int32_t c = cols[row_off + s];
      const int64_t pos = cursor[c]++;
      const int64_t vr = vrow_base[static_cast<size_t>(c)] + pos / capacity;
      const int64_t slot = pos % capacity;
      tvals[vr * capacity + slot] = v;
      trows[vr * capacity + slot] = static_cast<int32_t>(i);
    }
  }
  (void)v_pad;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Bipartite Euler-split edge coloring — the router for in-tile crossbars.
//
// A static permutation of a [R,128] VMEM tile is executed on TPU as
// lane-perm ∘ transpose ∘ lane-perm ∘ transpose ∘ lane-perm (see
// ops/crossbar.py).  The middle lane-perm is legal iff the edges
// (src_row → dst_row) are properly colored with 128 colors such that no
// two edges at the same vertex share a color.  With every vertex of
// degree exactly n_colors (a power of two; padding slots make this true
// by construction), repeated Euler splitting yields an exact coloring in
// O(m log n_colors): each split walks Euler circuits and alternates
// edges between halves, preserving even degrees.
// ---------------------------------------------------------------------------

namespace {

// One Euler-split level: partition edges[lo:hi) (indices into src/dst)
// into first half = color bit 0, second half = bit 1, by walking Euler
// circuits and alternating.  src[e] in [0,L), dst[e] in [0,R_n).
// Every vertex degree within the subset must be even.
void euler_split_level(const int32_t* src, const int32_t* dst,
                       int64_t* edge_ids, int64_t lo, int64_t hi,
                       int32_t n_left, int32_t n_right,
                       std::vector<int64_t>& head,
                       std::vector<int64_t>& nxt,
                       std::vector<int64_t>& prv,
                       std::vector<uint8_t>& used,
                       std::vector<uint8_t>& side_out) {
  // Build doubly-linked adjacency over vertices 0..n_left-1 (left) and
  // n_left..n_left+n_right-1 (right); each edge appears once per side
  // via two arc slots (2e, 2e+1).
  const int32_t nv = n_left + n_right;
  for (int32_t v = 0; v < nv; ++v) head[v] = -1;
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t e = edge_ids[i];
    used[e] = 0;
    const int64_t a0 = 2 * e, a1 = 2 * e + 1;
    const int32_t u = src[e], w = n_left + dst[e];
    nxt[a0] = head[u]; prv[a0] = -1;
    if (head[u] >= 0) prv[head[u]] = a0;
    head[u] = a0;
    nxt[a1] = head[w]; prv[a1] = -1;
    if (head[w] >= 0) prv[head[w]] = a1;
    head[w] = a1;
  }
  auto detach = [&](int64_t arc, int32_t v) {
    if (prv[arc] >= 0) nxt[prv[arc]] = nxt[arc];
    else head[v] = nxt[arc];
    if (nxt[arc] >= 0) prv[nxt[arc]] = prv[arc];
  };
  // Walk circuits: from any vertex with remaining edges, follow unused
  // edges until returning; alternate sides along the walk.  On a graph
  // with all even degrees the walk can only get stuck at its start
  // vertex, at which point we continue from any still-incident vertex.
  for (int64_t i = lo; i < hi; ++i) {
    const int64_t e0 = edge_ids[i];
    if (used[e0]) continue;
    int32_t v = src[e0];
    uint8_t side = 0;
    while (head[v] >= 0) {
      const int64_t arc = head[v];
      const int64_t e = arc >> 1;
      const int32_t u = src[e], w = n_left + dst[e];
      detach(2 * e, u);
      detach(2 * e + 1, w);
      used[e] = 1;
      side_out[e] = side;
      side ^= 1;
      v = (v == u) ? w : u;
    }
  }
}

}  // namespace

extern "C" {

// Color m edges (src[e] in [0,n_left), dst[e] in [0,n_right)) with
// n_colors colors (power of two).  Every left/right vertex must have
// degree divisible by n_colors... in the crossbar use-case degree ==
// n_colors exactly.  Writes color[e] in [0, n_colors).  Returns 0, or
// -1 on invalid arguments.
int32_t pml_edge_color(const int32_t* src, const int32_t* dst, int64_t m,
                       int32_t n_left, int32_t n_right, int32_t n_colors,
                       int32_t* color) {
  if (n_colors <= 0 || (n_colors & (n_colors - 1)) != 0) return -1;
  if (m < 0 || n_left <= 0 || n_right <= 0) return -1;
  // Vertex-range validation before touching the adjacency arrays: an
  // out-of-range id would index head/nxt/prv out of bounds (heap
  // corruption reachable from Python via edge_color_native).
  for (int64_t e = 0; e < m; ++e) {
    if (src[e] < 0 || src[e] >= n_left || dst[e] < 0 || dst[e] >= n_right)
      return -1;
  }
  std::vector<int64_t> edge_ids(static_cast<size_t>(m));
  for (int64_t e = 0; e < m; ++e) { edge_ids[e] = e; color[e] = 0; }
  std::vector<int64_t> head(static_cast<size_t>(n_left + n_right));
  std::vector<int64_t> nxt(static_cast<size_t>(2 * m));
  std::vector<int64_t> prv(static_cast<size_t>(2 * m));
  std::vector<uint8_t> used(static_cast<size_t>(m));
  std::vector<uint8_t> side(static_cast<size_t>(m));
  std::vector<int64_t> scratch(static_cast<size_t>(m));

  // Iterative halving: ranges of edge_ids sharing a color prefix are
  // split; bit b of the color is assigned at level b (MSB first).
  int32_t levels = 0;
  for (int32_t c = n_colors; c > 1; c >>= 1) ++levels;
  std::vector<std::pair<int64_t, int64_t>> ranges{{0, m}};
  for (int32_t level = 0; level < levels; ++level) {
    std::vector<std::pair<int64_t, int64_t>> next_ranges;
    for (auto [lo, hi] : ranges) {
      if (hi - lo == 0) continue;
      euler_split_level(src, dst, edge_ids.data(), lo, hi, n_left,
                        n_right, head, nxt, prv, used, side);
      // Stable partition: side 0 first.
      int64_t w0 = lo;
      for (int64_t i = lo; i < hi; ++i)
        if (!side[edge_ids[i]]) scratch[w0++] = edge_ids[i];
      int64_t mid = w0;
      for (int64_t i = lo; i < hi; ++i)
        if (side[edge_ids[i]]) scratch[w0++] = edge_ids[i];
      for (int64_t i = lo; i < hi; ++i) edge_ids[i] = scratch[i];
      const int32_t bit = 1 << (levels - 1 - level);
      for (int64_t i = mid; i < hi; ++i) color[edge_ids[i]] |= bit;
      next_ranges.emplace_back(lo, mid);
      next_ranges.emplace_back(mid, hi);
    }
    ranges = std::move(next_ranges);
  }
  return 0;
}

// Batched GRR route builder: for each [128,128] supertile, color the
// start→final slot permutation (dst[t][r*128+l] = final slot of the
// element starting at (r, l)) and emit the three lane-gather stages the
// kernel executes (ops/grr_kernel.py), with route stage 1 pre-composed
// with the gather index plane hi.  This is the hot part of compiling a
// sparse matrix into the GRR plan (data/grr.py) — one Euler-split
// coloring per supertile, O(slots · log 128) each.
// Returns 0, or -1 if any tile's dst is not a bijection / coloring
// arguments are invalid.
int32_t pml_grr_routes(const int32_t* dst, const int8_t* hi, int64_t n_st,
                       int8_t* g1, int8_t* g2, int8_t* g3) {
  constexpr int32_t T = 128;
  constexpr int64_t S = static_cast<int64_t>(T) * T;
  std::vector<int32_t> src_row(S), dst_row(S), color(S);
  std::vector<uint8_t> seen(S);
  for (int64_t e = 0; e < S; ++e) src_row[e] = static_cast<int32_t>(e >> 7);

  for (int64_t t = 0; t < n_st; ++t) {
    const int32_t* d = dst + t * S;
    const int8_t* h = hi + t * S;
    std::memset(seen.data(), 0, static_cast<size_t>(S));
    for (int64_t e = 0; e < S; ++e) {
      const int32_t v = d[e];
      if (v < 0 || v >= S || seen[v]) return -1;
      seen[v] = 1;
      dst_row[e] = v >> 7;
    }
    if (pml_edge_color(src_row.data(), dst_row.data(), S, T, T, T,
                       color.data()) != 0)
      return -1;
    int8_t* G1 = g1 + t * S;
    int8_t* G2 = g2 + t * S;
    int8_t* G3 = g3 + t * S;
    for (int64_t e = 0; e < S; ++e) {
      const int32_t r = src_row[e];
      const int32_t l = static_cast<int32_t>(e & (T - 1));
      const int32_t c = color[e];
      const int32_t dr = dst_row[e];
      const int32_t dl = d[e] & (T - 1);
      G1[r * T + c] = h[r * T + l];
      G2[c * T + dr] = static_cast<int8_t>(r);
      G3[dr * T + dl] = static_cast<int8_t>(c);
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// GRR plan construction (the layout half of the sparse engine)
// ---------------------------------------------------------------------------
//
// Builds one direction's gather-route-reduce plan straight from the
// row-ELL arrays: the same pipeline as photon_ml_tpu.data.grr
// .build_grr_direction (group-capacity ranks, supertile blocking,
// start/final slot placement, padding bijection, spill COO), but as a
// handful of streaming passes over the entries with small cache-local
// counter tables — no 10^8-element comparison sorts, no full-size
// temporaries.  Rank assignment within a group follows entry scan
// order; the Python path's sort-based ranks may differ, but rank choice
// is explicitly arbitrary (both produce valid plans whose contractions
// agree — tested in tests/test_grr.py).
//
// Protocol: pml_grr_plan(...) -> handle; pml_grr_plan_sizes(handle,..);
// pml_grr_plan_fill(handle, ...); pml_grr_plan_free(handle).
// Route coloring stays in pml_grr_routes (shared with the Python path).

namespace {

constexpr int64_t GRR_WIN = 16384;
constexpr int32_t GRR_TILE = 128;
constexpr int64_t GRR_SLOTS = GRR_WIN;  // 128*128 slots per supertile

struct GrrPlan {
  int32_t error = 0;  // 1 = idx/seg out of range, 2 = size overflow
  int32_t cap = 0, n_gw = 0, n_ow = 0;
  int64_t n_st = 0, n_spill = 0;  // n_spill already padded to 8
  std::vector<int8_t> hi;
  std::vector<float> vals;
  std::vector<int32_t> dst;
  std::vector<int32_t> gw_of_st, ow_of_st, first_of_ow;
  std::vector<int32_t> spill_idx, spill_seg;
  std::vector<float> spill_val;
};

inline int32_t grr_next_pow2(int64_t x) {
  // Callers clamp the result to <= 64; clamp the input too so an
  // extreme occupancy mean can't overflow the int32 shift (UB).
  if (x > 128) x = 128;
  int32_t p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Body behind an exception firewall: std::bad_alloc must not unwind
// through the extern "C"/ctypes boundary (that would terminate the
// process instead of letting the caller fall back to numpy).
//
// [idx_lo, idx_hi) restricts the plan to a contiguous sub-range of the
// table axis (the column-range split of data/grr.py): entries outside
// the range are SKIPPED (they belong to a sibling sub-plan — not spill,
// not an error), in-range indices are rebased to idx - idx_lo, and the
// emitted plan's table axis is [0, idx_hi - idx_lo).  Indices outside
// [0, table_len) are still a hard error — every entry belongs to
// exactly one range of a full partition, so a genuinely out-of-range
// id must not be silently dropped by all parts.
void grr_plan_body(GrrPlan* plan, const int32_t* cols, const float* vals,
                   int64_t n, int64_t k, int32_t direction,
                   int64_t table_len, int64_t n_segments, int32_t cap_in,
                   int64_t idx_lo, int64_t idx_hi) {
  // Same cap validation as the numpy path (data/grr.py): a non-power-
  // of-two cap makes distinct (q, b) pairs collide on one final slot.
  if (cap_in != 0 && cap_in != 1 && cap_in != 2 && cap_in != 4 &&
      cap_in != 8 && cap_in != 16 && cap_in != 32 && cap_in != 64 &&
      cap_in != 128) {
    plan->error = 3;
    return;
  }
  constexpr int64_t kMaxCounterBytes = int64_t{1} << 33;  // 8 GB
  if (idx_hi <= 0) idx_hi = table_len;
  if (idx_lo < 0 || idx_hi > table_len || idx_lo >= idx_hi ||
      (idx_lo % GRR_WIN) != 0) {
    plan->error = 3;
    return;
  }
  const int64_t range_len = idx_hi - idx_lo;
  const int64_t n_gw = (range_len + GRR_WIN - 1) / GRR_WIN;
  plan->n_gw = static_cast<int32_t>(n_gw);
  const int64_t m_ell = n * k;

  // Pass A: count nonzeros, validate ranges, check (seg, gw) sortedness.
  int64_t m_nz = 0;
  bool sorted = true;
  int64_t prev_key = -1;
  for (int64_t e = 0; e < m_ell; ++e) {
    const float v = vals[e];
    if (v == 0.0f) continue;
    const int64_t r = e / k;
    const int64_t c = cols[e];
    int64_t idx = direction ? r : c;
    const int64_t seg = direction ? c : r;
    if (idx < 0 || idx >= table_len || seg < 0 || seg >= n_segments) {
      plan->error = 1;
      return;
    }
    if (idx < idx_lo || idx >= idx_hi) continue;
    idx -= idx_lo;
    const int64_t key = seg * n_gw + idx / GRR_WIN;
    if (key < prev_key) sorted = false;
    prev_key = key;
    ++m_nz;
  }

  // Capacity: 1.5x the exact mean nonempty (seg, window) occupancy
  // (the Python path estimates this mean by sampling segments; exact
  // is strictly better and free here).
  int32_t cap = cap_in;
  if (cap <= 0) {
    int64_t n_groups = 0;
    if (sorted) {
      prev_key = -1;
      for (int64_t e = 0; e < m_ell; ++e) {
        if (vals[e] == 0.0f) continue;
        const int64_t r = e / k;
        const int64_t c = cols[e];
        const int64_t idx = direction ? r : c;
        if (idx < idx_lo || idx >= idx_hi) continue;
        const int64_t key = (direction ? c : r) * n_gw +
                            (idx - idx_lo) / GRR_WIN;
        if (key != prev_key) ++n_groups;
        prev_key = key;
      }
    } else {
      const int64_t n_keys = n_segments * n_gw;
      if (n_keys > kMaxCounterBytes) {
        plan->error = 2;
        return;
      }
      std::vector<uint8_t> visited(static_cast<size_t>(n_keys), 0);
      for (int64_t e = 0; e < m_ell; ++e) {
        if (vals[e] == 0.0f) continue;
        const int64_t r = e / k;
        const int64_t c = cols[e];
        const int64_t idx = direction ? r : c;
        if (idx < idx_lo || idx >= idx_hi) continue;
        const int64_t key = (direction ? c : r) * n_gw +
                            (idx - idx_lo) / GRR_WIN;
        if (!visited[key]) { visited[key] = 1; ++n_groups; }
      }
    }
    const double mean = n_groups ? double(m_nz) / double(n_groups) : 1.0;
    cap = grr_next_pow2(static_cast<int64_t>(mean * 1.5 + 0.999999));
    if (cap < 4) cap = 4;
    if (cap > 64) cap = 64;
  }
  plan->cap = cap;
  const int64_t segwin = GRR_WIN / cap;
  const int32_t group = GRR_TILE / cap;
  const int64_t n_ow = n_segments > 0 ? (n_segments + segwin - 1) / segwin : 1;
  plan->n_ow = static_cast<int32_t>(n_ow);
  const int64_t n_bk = n_ow * n_gw;
  if (n_bk * GRR_TILE * 2 > kMaxCounterBytes) {  // r2cnt bytes
    plan->error = 2;
    return;
  }

  // Rank counters.  q: per (seg, window) among all entries (uint8,
  // cap <= 64 < 255 so saturate at 255 = spilled anyway).  rank2: per
  // (block, lane residue) among cap-kept entries.
  std::vector<uint8_t> qcnt;
  if (!sorted) {
    if (n_segments * n_gw > kMaxCounterBytes) {
      plan->error = 2;
      return;
    }
    qcnt.assign(static_cast<size_t>(n_segments * n_gw), 0);
  }
  std::vector<uint16_t> r2cnt(static_cast<size_t>(n_bk) * GRR_TILE, 0);
  std::vector<int64_t> cnt_bk(static_cast<size_t>(n_bk), 0);

  // Pass B: count kept entries per block (q + rank2 logic, no fills).
  {
    int64_t run_key = -1, run_q = 0;
    for (int64_t e = 0; e < m_ell; ++e) {
      const float v = vals[e];
      if (v == 0.0f) continue;
      const int64_t r = e / k;
      const int64_t c = cols[e];
      int64_t idx = direction ? r : c;
      const int64_t seg = direction ? c : r;
      if (idx < idx_lo || idx >= idx_hi) continue;
      idx -= idx_lo;
      const int64_t gw = idx / GRR_WIN;
      int64_t q;
      if (sorted) {
        const int64_t key = seg * n_gw + gw;
        if (key != run_key) { run_key = key; run_q = 0; }
        q = run_q++;
      } else {
        uint8_t& qc = qcnt[seg * n_gw + gw];
        q = qc;
        if (qc < 255) ++qc;
      }
      if (q >= cap) continue;  // spill1
      const int64_t bk = (seg / segwin) * n_gw + gw;
      uint16_t& r2 = r2cnt[bk * GRR_TILE + (idx % GRR_TILE)];
      if (r2 >= GRR_TILE) { ++r2; continue; }  // spill2 (sat. anyway)
      ++r2;
      ++cnt_bk[bk];
    }
  }

  // Block list: non-empty blocks ascending + a dummy per empty ow.
  std::vector<int32_t> st_of_bk(static_cast<size_t>(n_bk), -1);
  {
    std::vector<uint8_t> ow_present(static_cast<size_t>(n_ow), 0);
    for (int64_t b = 0; b < n_bk; ++b)
      if (cnt_bk[b] > 0) ow_present[b / n_gw] = 1;
    int64_t n_st = 0;
    for (int64_t ow = 0; ow < n_ow; ++ow) {
      if (ow_present[ow]) {
        for (int64_t g = 0; g < n_gw; ++g)
          if (cnt_bk[ow * n_gw + g] > 0) ++n_st;
      } else {
        ++n_st;  // dummy at (ow, gw=0)
      }
    }
    plan->n_st = n_st;
    plan->hi.assign(static_cast<size_t>(n_st) * GRR_SLOTS, 0);
    plan->vals.assign(static_cast<size_t>(n_st) * GRR_SLOTS, 0.0f);
    plan->dst.assign(static_cast<size_t>(n_st) * GRR_SLOTS, 0);
    plan->gw_of_st.resize(static_cast<size_t>(n_st));
    plan->ow_of_st.resize(static_cast<size_t>(n_st));
    plan->first_of_ow.resize(static_cast<size_t>(n_st));
    int32_t st = 0;
    int64_t prev_ow = -1;
    for (int64_t ow = 0; ow < n_ow; ++ow) {
      if (ow_present[ow]) {
        for (int64_t g = 0; g < n_gw; ++g) {
          const int64_t b = ow * n_gw + g;
          if (cnt_bk[b] <= 0) continue;
          st_of_bk[b] = st;
          plan->gw_of_st[st] = static_cast<int32_t>(g);
          plan->ow_of_st[st] = static_cast<int32_t>(ow);
          plan->first_of_ow[st] = (ow != prev_ow) ? 1 : 0;
          prev_ow = ow;
          ++st;
        }
      } else {
        plan->gw_of_st[st] = 0;
        plan->ow_of_st[st] = static_cast<int32_t>(ow);
        plan->first_of_ow[st] = 1;
        prev_ow = ow;
        ++st;
      }
    }
  }

  // Pass C: fill HI/VALS/DST + occupancy bitmaps + spill COO.
  const int64_t n_st = plan->n_st;
  std::vector<uint64_t> occ_s(static_cast<size_t>(n_st) * (GRR_SLOTS / 64), 0);
  std::vector<uint64_t> occ_f(static_cast<size_t>(n_st) * (GRR_SLOTS / 64), 0);
  {
    std::fill(r2cnt.begin(), r2cnt.end(), 0);
    if (!sorted) std::fill(qcnt.begin(), qcnt.end(), 0);
    int64_t run_key = -1, run_q = 0;
    for (int64_t e = 0; e < m_ell; ++e) {
      const float v = vals[e];
      if (v == 0.0f) continue;
      const int64_t r = e / k;
      const int64_t c = cols[e];
      int64_t idx = direction ? r : c;
      const int64_t seg = direction ? c : r;
      if (idx < idx_lo || idx >= idx_hi) continue;
      idx -= idx_lo;
      const int64_t gw = idx / GRR_WIN;
      int64_t q;
      if (sorted) {
        const int64_t key = seg * n_gw + gw;
        if (key != run_key) { run_key = key; run_q = 0; }
        q = run_q++;
      } else {
        uint8_t& qc = qcnt[seg * n_gw + gw];
        q = qc;
        if (qc < 255) ++qc;
      }
      bool spilled = q >= cap;
      int64_t l_s = 0;
      const int64_t bk = (seg / segwin) * n_gw + gw;
      // Start ROW = the entry's window sub-tile (idx%WIN)/128, so the
      // kernel gathers from the UNtransposed table window: row s of the
      // window holds table[gw*WIN + s*128 .. +127] and the gather plane
      // carries the lane residue idx%128.  (Previously rows were keyed
      // by residue, which required transposing every window per step —
      // two ~100 us XLA transpose fusions per objective pass at bench
      // shape.)
      const int64_t hrow = (idx % GRR_WIN) / GRR_TILE;
      if (!spilled) {
        uint16_t& r2 = r2cnt[bk * GRR_TILE + hrow];
        l_s = r2;
        ++r2;
        spilled = l_s >= GRR_TILE;
      }
      if (spilled) {
        plan->spill_idx.push_back(static_cast<int32_t>(idx));
        plan->spill_seg.push_back(static_cast<int32_t>(seg));
        plan->spill_val.push_back(v);
        continue;
      }
      const int64_t st = st_of_bk[bk];
      const int64_t b = seg % segwin;
      const int64_t s_start = hrow * GRR_TILE + l_s;
      const int64_t s_final =
          (q * group + b / GRR_TILE) * GRR_TILE + (b % GRR_TILE);
      const int64_t base = st * GRR_SLOTS;
      plan->hi[base + s_start] = static_cast<int8_t>(idx % GRR_TILE);
      plan->vals[base + s_final] = v;
      plan->dst[base + s_start] = static_cast<int32_t>(s_final);
      occ_s[(base + s_start) >> 6] |= (uint64_t{1} << (s_start & 63));
      occ_f[(base + s_final) >> 6] |= (uint64_t{1} << (s_final & 63));
    }
  }

  // Pass D: padding bijection — pair free starts with free finals in
  // order (same construction as the Python path).
  for (int64_t st = 0; st < n_st; ++st) {
    const int64_t base = st * GRR_SLOTS;
    int64_t f = 0;  // next candidate free final
    for (int64_t s = 0; s < GRR_SLOTS; ++s) {
      if (occ_s[(base + s) >> 6] & (uint64_t{1} << (s & 63))) continue;
      while (f < GRR_SLOTS &&
             (occ_f[(base + f) >> 6] & (uint64_t{1} << (f & 63))))
        ++f;
      plan->dst[base + s] = static_cast<int32_t>(f);
      ++f;
    }
  }

  // Spill padding to a multiple of 8.
  {
    const int64_t m = static_cast<int64_t>(plan->spill_idx.size());
    const int64_t m_pad = m ? ((m + 7) / 8) * 8 : 0;
    plan->spill_idx.resize(static_cast<size_t>(m_pad), 0);
    plan->spill_seg.resize(static_cast<size_t>(m_pad), 0);
    plan->spill_val.resize(static_cast<size_t>(m_pad), 0.0f);
    plan->n_spill = m_pad;
  }
}

}  // namespace

extern "C" {

void* pml_grr_plan(const int32_t* cols, const float* vals, int64_t n,
                   int64_t k, int32_t direction, int64_t table_len,
                   int64_t n_segments, int32_t cap_in, int64_t idx_lo,
                   int64_t idx_hi) {
  auto* plan = new (std::nothrow) GrrPlan();
  if (!plan) return nullptr;
  try {
    grr_plan_body(plan, cols, vals, n, k, direction, table_len,
                  n_segments, cap_in, idx_lo, idx_hi);
  } catch (const std::bad_alloc&) {
    plan->error = 2;  // caller falls back to the numpy path
  }
  return plan;
}

void pml_grr_plan_sizes(void* handle, int64_t* n_st, int64_t* n_spill,
                        int32_t* cap, int32_t* n_gw, int32_t* n_ow,
                        int32_t* error) {
  auto* p = static_cast<GrrPlan*>(handle);
  *n_st = p->n_st;
  *n_spill = p->n_spill;
  *cap = p->cap;
  *n_gw = p->n_gw;
  *n_ow = p->n_ow;
  *error = p->error;
}

void pml_grr_plan_fill(void* handle, int8_t* hi, float* vals, int32_t* dst,
                       int32_t* gw_of_st, int32_t* ow_of_st,
                       int32_t* first_of_ow, int32_t* spill_idx,
                       int32_t* spill_seg, float* spill_val) {
  auto* p = static_cast<GrrPlan*>(handle);
  std::memcpy(hi, p->hi.data(), p->hi.size());
  std::memcpy(vals, p->vals.data(), p->vals.size() * sizeof(float));
  std::memcpy(dst, p->dst.data(), p->dst.size() * sizeof(int32_t));
  std::memcpy(gw_of_st, p->gw_of_st.data(),
              p->gw_of_st.size() * sizeof(int32_t));
  std::memcpy(ow_of_st, p->ow_of_st.data(),
              p->ow_of_st.size() * sizeof(int32_t));
  std::memcpy(first_of_ow, p->first_of_ow.data(),
              p->first_of_ow.size() * sizeof(int32_t));
  if (p->n_spill) {
    std::memcpy(spill_idx, p->spill_idx.data(),
                p->spill_idx.size() * sizeof(int32_t));
    std::memcpy(spill_seg, p->spill_seg.data(),
                p->spill_seg.size() * sizeof(int32_t));
    std::memcpy(spill_val, p->spill_val.data(),
                p->spill_val.size() * sizeof(float));
  }
}

void pml_grr_plan_free(void* handle) { delete static_cast<GrrPlan*>(handle); }

}  // extern "C"
