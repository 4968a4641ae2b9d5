// Host-side sparse core for empanada_torch.
//
// The port's own copy of the JAX package's C++ core
// (empanada_tpu/core/_native/core.cpp; same entry points, same
// signatures, same prefix, so a counterpart is easy to find). Replaces the
// reference's numba kernels (empanada/array_utils.py:144-688,
// empanada/zarr_utils.py:11-58) and external cc3d connected components
// (empanada/inference/rle.py:18-24) with single-pass C algorithms over
// run-length encoded data. Exposed via a plain C ABI and loaded with ctypes
// (empanada_torch/core/native.py), which releases the interpreter lock for
// the length of each call: nothing here keeps state between calls, so
// several host threads may call any entry point at once.
//
// Build: at first use, by empanada_torch/native_build.py
// (g++ -O3 -fPIC -std=c++17 -shared).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Coverage sweep: given n [start,end) ranges sorted by start, emit the
// disjoint ranges where coverage depth >= thr. Returns the number of output
// ranges written (or required, if it exceeds out_cap: caller re-allocates).
// ---------------------------------------------------------------------------
int64_t etpu_coverage_ranges(const int64_t* ranges, int64_t n, int64_t thr,
                             int64_t* out, int64_t out_cap) {
  if (n <= 0) return 0;
  std::vector<int64_t> ends(n);
  for (int64_t i = 0; i < n; ++i) ends[i] = ranges[2 * i + 1];
  std::sort(ends.begin(), ends.end());

  int64_t depth = 0, si = 0, ei = 0, count = 0;
  int64_t open_start = 0;
  bool open = false;
  while (ei < n) {
    int64_t next_start = (si < n) ? ranges[2 * si] : INT64_MAX;
    int64_t next_end = ends[ei];
    if (next_start < next_end) {
      depth++;
      if (!open && depth >= thr) {
        open = true;
        open_start = next_start;
      }
      si++;
    } else {
      // process end events first at ties (half-open ranges)
      depth--;
      if (open && depth < thr) {
        open = false;
        if (next_end > open_start) {
          if (count < out_cap) {
            out[2 * count] = open_start;
            out[2 * count + 1] = next_end;
          }
          count++;
        }
      }
      ei++;
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Two-pointer intersection size of two disjoint sorted range sets.
// ---------------------------------------------------------------------------
int64_t etpu_ranges_intersection(const int64_t* a, int64_t na,
                                 const int64_t* b, int64_t nb) {
  int64_t i = 0, j = 0, total = 0;
  while (i < na && j < nb) {
    int64_t lo = std::max(a[2 * i], b[2 * j]);
    int64_t hi = std::min(a[2 * i + 1], b[2 * j + 1]);
    if (hi > lo) total += hi - lo;
    if (a[2 * i + 1] < b[2 * j + 1]) i++; else j++;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Batched pairwise intersection sizes between two instance sets.
//
// Each side is a concatenation of per-instance disjoint sorted [start,end)
// range lists: ranges_x is flat (2*total) int64, offs_x is (n_x+1) range
// offsets (instance i owns ranges [offs[i], offs[i+1])). pairs is
// (2*n_pairs) of (ia, ib) indices; out receives the intersection size per
// pair. One call replaces thousands of per-pair ctypes crossings in the
// slice matcher's IoU matrix construction (inference/matcher.py).
// ---------------------------------------------------------------------------
// binary search: first range index in r[0..n) whose END is > x
static inline int64_t first_end_after(const int64_t* r, int64_t n,
                                      int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (r[2 * mid + 1] > x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// binary search: first range index in r[0..n) whose START is >= x
static inline int64_t first_start_at(const int64_t* r, int64_t n,
                                     int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (r[2 * mid] >= x) hi = mid; else lo = mid + 1;
  }
  return lo;
}

void etpu_pair_intersections(const int64_t* ranges_a, const int64_t* offs_a,
                             const int64_t* ranges_b, const int64_t* offs_b,
                             const int64_t* pairs, int64_t n_pairs,
                             int64_t* out) {
  for (int64_t p = 0; p < n_pairs; ++p) {
    int64_t ia = pairs[2 * p], ib = pairs[2 * p + 1];
    const int64_t* a = ranges_a + 2 * offs_a[ia];
    const int64_t* b = ranges_b + 2 * offs_b[ib];
    int64_t na = offs_a[ia + 1] - offs_a[ia];
    int64_t nb = offs_b[ib + 1] - offs_b[ib];
    if (na == 0 || nb == 0) { out[p] = 0; continue; }
    // clip both walks to the mutual span: consensus instances span
    // thousands of ranges each, but cross-axis pairs often overlap in a
    // small window, so the full two-pointer walk is mostly wasted
    int64_t span_lo = std::max(a[0], b[0]);
    int64_t span_hi = std::min(a[2 * (na - 1) + 1], b[2 * (nb - 1) + 1]);
    if (span_hi <= span_lo) { out[p] = 0; continue; }
    int64_t i = first_end_after(a, na, span_lo);
    int64_t j = first_end_after(b, nb, span_lo);
    int64_t i_end = first_start_at(a, na, span_hi);
    int64_t j_end = first_start_at(b, nb, span_hi);
    int64_t total = 0;
    while (i < i_end && j < j_end) {
      int64_t lo = std::max(a[2 * i], b[2 * j]);
      int64_t hi = std::min(a[2 * i + 1], b[2 * j + 1]);
      if (hi > lo) total += hi - lo;
      if (a[2 * i + 1] < b[2 * j + 1]) i++; else j++;
    }
    out[p] = total;
  }
}

// ---------------------------------------------------------------------------
// K-way merge of k individually sorted-by-start range lists (concatenated in
// cat with offs) into one start-sorted list. Used by the consensus vote:
// numpy's argsort of the concatenation was the second-largest consensus
// cost; merging k already-sorted instance RLEs is linear in total ranges.
// ---------------------------------------------------------------------------
int64_t etpu_kway_merge_ranges(const int64_t* cat, const int64_t* offs,
                               int64_t k, int64_t* out) {
  // simple binary-heap of (current start, list index)
  std::vector<std::pair<int64_t, int64_t>> heap;
  std::vector<int64_t> pos(k);
  heap.reserve(k);
  for (int64_t l = 0; l < k; ++l) {
    pos[l] = offs[l];
    if (offs[l] < offs[l + 1])
      heap.emplace_back(cat[2 * offs[l]], l);
  }
  auto cmp = [](const std::pair<int64_t, int64_t>& x,
                const std::pair<int64_t, int64_t>& y) {
    return x.first > y.first ||
           (x.first == y.first && x.second > y.second);
  };
  std::make_heap(heap.begin(), heap.end(), cmp);
  int64_t n_out = 0;
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    auto [start, l] = heap.back();
    heap.pop_back();
    out[2 * n_out] = start;
    out[2 * n_out + 1] = cat[2 * pos[l] + 1];
    ++n_out;
    if (++pos[l] < offs[l + 1]) {
      heap.emplace_back(cat[2 * pos[l]], l);
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Union of two CANONICAL (sorted, disjoint) range lists into one canonical
// list, coalescing overlapping AND touching ranges (same output as the
// coverage sweep at thr=1). out must hold na+nb ranges. Returns the output
// count. The matcher's false-split healing merges instance RLEs dozens of
// times per slice (inference/matcher.py merge_attrs); a direct two-pointer
// merge replaces the generic sort+sweep chain there.
// ---------------------------------------------------------------------------
int64_t etpu_rle_union(const int64_t* a, int64_t na,
                       const int64_t* b, int64_t nb, int64_t* out) {
  int64_t i = 0, j = 0, n_out = 0;
  int64_t cur_s = 0, cur_e = -1;  // empty current range
  while (i < na || j < nb) {
    int64_t s, e;
    if (j >= nb || (i < na && a[2 * i] <= b[2 * j])) {
      s = a[2 * i]; e = a[2 * i + 1]; ++i;
    } else {
      s = b[2 * j]; e = b[2 * j + 1]; ++j;
    }
    if (cur_e < cur_s) {  // first range
      cur_s = s; cur_e = e;
    } else if (s <= cur_e) {  // overlap or touch: extend
      if (e > cur_e) cur_e = e;
    } else {
      out[2 * n_out] = cur_s; out[2 * n_out + 1] = cur_e; ++n_out;
      cur_s = s; cur_e = e;
    }
  }
  if (cur_e >= cur_s) {
    out[2 * n_out] = cur_s; out[2 * n_out + 1] = cur_e; ++n_out;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// K-way coverage vote over k individually canonical (start-sorted,
// disjoint) range lists: emit the maximal ranges where >= thr lists
// overlap. Equivalent to the concat-sort + end-sort coverage sweep
// (etpu_coverage_ranges after a k-way merge) but in ONE O(n log k) heap
// pass with no sort — the consensus pixel vote runs this over every
// cluster's member RLEs (inference/consensus.py). All events sharing a
// coordinate apply together (half-open ranges: touch at thr boundaries
// merges, exactly the numpy event-sweep semantics). out must hold n
// ranges. Returns the output count.
// ---------------------------------------------------------------------------
int64_t etpu_kway_vote(const int64_t* cat, const int64_t* offs, int64_t k,
                       int64_t thr, int64_t* out) {
  // event streams: 2 per list (starts ascending, ends ascending —
  // both hold for disjoint sorted runs). stream id 2l = starts of
  // list l (+1), 2l+1 = ends (-1).
  struct Ev { int64_t coord; int64_t stream; };
  std::vector<Ev> heap;
  std::vector<int64_t> pos(2 * k);
  heap.reserve(2 * k);
  for (int64_t l = 0; l < k; ++l) {
    pos[2 * l] = offs[l];
    pos[2 * l + 1] = offs[l];
    if (offs[l] < offs[l + 1]) {
      heap.push_back({cat[2 * offs[l]], 2 * l});
      heap.push_back({cat[2 * offs[l] + 1], 2 * l + 1});
    }
  }
  auto cmp = [](const Ev& x, const Ev& y) { return x.coord > y.coord; };
  std::make_heap(heap.begin(), heap.end(), cmp);
  int64_t n_out = 0, depth = 0, cur_start = 0;
  bool above = false;
  while (!heap.empty()) {
    int64_t coord = heap.front().coord;
    int64_t delta = 0;
    while (!heap.empty() && heap.front().coord == coord) {
      std::pop_heap(heap.begin(), heap.end(), cmp);
      int64_t stream = heap.back().stream;
      heap.pop_back();
      int64_t l = stream / 2;
      bool is_end = stream & 1;
      delta += is_end ? -1 : 1;
      int64_t& p = pos[stream];
      if (++p < offs[l + 1]) {
        heap.push_back({cat[2 * p + (is_end ? 1 : 0)], stream});
        std::push_heap(heap.begin(), heap.end(), cmp);
      }
    }
    depth += delta;
    if (!above && depth >= thr) {
      above = true;
      cur_start = coord;
    } else if (above && depth < thr) {
      above = false;
      out[2 * n_out] = cur_start;
      out[2 * n_out + 1] = coord;
      ++n_out;
    }
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// K-way union DIRECTLY on starts/runs arrays: k individually canonical
// (start-sorted, disjoint) RLEs concatenated in starts_cat/runs_cat with
// offs (k+1 list offsets) -> one canonical RLE, coalescing overlap and
// touch. Identical output to join_ranges(lists) but skips the (n, 2)
// range packing, the generic sort, and the coverage sweep — the matcher
// unions instance RLEs ~100x per slice at product density
// (inference/matcher.py merge_attrs_many). out_* must hold sum(n_i)
// entries. Returns the output run count.
// ---------------------------------------------------------------------------
int64_t etpu_kway_union_sr(const int64_t* starts_cat, const int64_t* runs_cat,
                           const int64_t* offs, int64_t k,
                           int64_t* out_starts, int64_t* out_runs) {
  // heap of (current start, list index), min-first
  std::vector<std::pair<int64_t, int64_t>> heap;
  std::vector<int64_t> pos(k);
  heap.reserve(k);
  for (int64_t l = 0; l < k; ++l) {
    pos[l] = offs[l];
    if (offs[l] < offs[l + 1]) heap.emplace_back(starts_cat[offs[l]], l);
  }
  auto cmp = [](const std::pair<int64_t, int64_t>& x,
                const std::pair<int64_t, int64_t>& y) {
    return x.first > y.first;
  };
  std::make_heap(heap.begin(), heap.end(), cmp);
  int64_t n_out = 0;
  int64_t cur_s = 0, cur_e = -1;  // empty current range
  while (!heap.empty()) {
    std::pop_heap(heap.begin(), heap.end(), cmp);
    auto [s, l] = heap.back();
    heap.pop_back();
    int64_t e = s + runs_cat[pos[l]];
    if (cur_e < cur_s) {
      cur_s = s; cur_e = e;
    } else if (s <= cur_e) {  // overlap or touch: extend
      if (e > cur_e) cur_e = e;
    } else {
      out_starts[n_out] = cur_s; out_runs[n_out] = cur_e - cur_s; ++n_out;
      cur_s = s; cur_e = e;
    }
    if (++pos[l] < offs[l + 1]) {
      heap.emplace_back(starts_cat[pos[l]], l);
      std::push_heap(heap.begin(), heap.end(), cmp);
    }
  }
  if (cur_e >= cur_s) {
    out_starts[n_out] = cur_s; out_runs[n_out] = cur_e - cur_s; ++n_out;
  }
  return n_out;
}

// ---------------------------------------------------------------------------
// Batched k-way unions: group_offs (g+1) partitions the offs entries
// into g groups of lists; each group is unioned independently
// (etpu_kway_union_sr) and written consecutively into out_starts/
// out_runs with out_offs (g+1) marking the per-group extents. One
// native crossing replaces the matcher's per-target-label union calls
// (~10^2 per slice at product density). Returns total output runs.
// ---------------------------------------------------------------------------
int64_t etpu_kway_union_batch(const int64_t* starts_cat,
                              const int64_t* runs_cat, const int64_t* offs,
                              const int64_t* group_offs, int64_t g,
                              int64_t* out_starts, int64_t* out_runs,
                              int64_t* out_offs) {
  int64_t total = 0;
  out_offs[0] = 0;
  for (int64_t i = 0; i < g; ++i) {
    int64_t k = group_offs[i + 1] - group_offs[i];
    total += etpu_kway_union_sr(starts_cat, runs_cat,
                                offs + group_offs[i], k,
                                out_starts + total, out_runs + total);
    out_offs[i + 1] = total;
  }
  return total;
}

// ---------------------------------------------------------------------------
// Sparse pairwise box overlap: emit all (ia, ib) pairs of half-open
// N-d boxes with positive intersection volume, plus that volume.
//
// boxes_x: (n, 2*ndim) int64 rows [lo..., hi...]. Bucketed sweep on dim 0:
// each B box registers in the dim-0 buckets its [lo0, hi0) covers; each A
// box tests the candidates of its buckets (stamp array dedupes). Expected
// near-linear for boxes spread through a volume (consensus runs this over
// 10k+ 3D instances where the dense O(n*m) numpy block sweep dominated).
// Returns the number of pairs (written if <= out_cap; caller re-calls with
// a larger buffer otherwise). Self mode (boxes_a == boxes_b) still emits
// (i, i) and both orders, matching the dense path.
// ---------------------------------------------------------------------------
int64_t etpu_box_overlap_pairs(const int64_t* boxes_a, int64_t na,
                               const int64_t* boxes_b, int64_t nb,
                               int64_t ndim, int64_t* out_pairs,
                               int64_t* out_inter, int64_t out_cap) {
  if (na <= 0 || nb <= 0) return 0;
  const int64_t stride = 2 * ndim;

  int64_t min_lo = INT64_MAX, max_hi = INT64_MIN;
  for (int64_t j = 0; j < nb; ++j) {
    min_lo = std::min(min_lo, boxes_b[j * stride]);
    max_hi = std::max(max_hi, boxes_b[j * stride + ndim]);
  }
  if (max_hi <= min_lo) max_hi = min_lo + 1;
  int64_t n_buckets = std::max<int64_t>(
      1, std::min<int64_t>(nb, 1 << 14));
  int64_t cell = std::max<int64_t>(1, (max_hi - min_lo + n_buckets - 1)
                                   / n_buckets);
  n_buckets = (max_hi - min_lo + cell - 1) / cell;

  auto bucket_of = [&](int64_t x) {
    int64_t b = (x - min_lo) / cell;
    if (b < 0) b = 0;
    if (b >= n_buckets) b = n_buckets - 1;
    return b;
  };

  // CSR bucket index of B
  std::vector<int64_t> counts(n_buckets + 1, 0);
  for (int64_t j = 0; j < nb; ++j) {
    int64_t lo = boxes_b[j * stride], hi = boxes_b[j * stride + ndim];
    if (hi <= lo) continue;
    counts[bucket_of(lo) + 1]++;
    // spread over covered buckets
    for (int64_t k = bucket_of(lo) + 1; k <= bucket_of(hi - 1); ++k)
      counts[k + 1]++;
  }
  for (int64_t k = 0; k < n_buckets; ++k) counts[k + 1] += counts[k];
  std::vector<int64_t> entries(counts[n_buckets]);
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t j = 0; j < nb; ++j) {
    int64_t lo = boxes_b[j * stride], hi = boxes_b[j * stride + ndim];
    if (hi <= lo) continue;
    for (int64_t k = bucket_of(lo); k <= bucket_of(hi - 1); ++k)
      entries[cursor[k]++] = j;
  }

  std::vector<int64_t> stamp(nb, -1);
  int64_t count = 0;
  for (int64_t i = 0; i < na; ++i) {
    const int64_t* a = boxes_a + i * stride;
    if (a[ndim] <= a[0]) continue;
    int64_t k0 = bucket_of(a[0]), k1 = bucket_of(a[ndim] - 1);
    for (int64_t k = k0; k <= k1; ++k) {
      for (int64_t e = counts[k]; e < counts[k + 1]; ++e) {
        int64_t j = entries[e];
        if (stamp[j] == i) continue;
        stamp[j] = i;
        const int64_t* b = boxes_b + j * stride;
        int64_t vol = 1;
        for (int64_t d = 0; d < ndim; ++d) {
          int64_t lo = std::max(a[d], b[d]);
          int64_t hi = std::min(a[ndim + d], b[ndim + d]);
          if (hi <= lo) { vol = 0; break; }
          vol *= hi - lo;
        }
        if (vol > 0) {
          if (count < out_cap) {
            out_pairs[2 * count] = i;
            out_pairs[2 * count + 1] = j;
            out_inter[count] = vol;
          }
          count++;
        }
      }
    }
  }
  return count;
}

// ---------------------------------------------------------------------------
// Run-based connected components over a raveled 2D image.
//
// Input: n row-split runs (start, end in raveled coords; runs never cross a
// row boundary) each carrying an integer value; runs sorted raster order.
// Two runs merge iff they carry the same value, sit on adjacent rows, and
// their column spans touch (8- or 4-connectivity). Output: per-run component
// label, 1-based, numbered by first raster appearance. Returns #components.
// ---------------------------------------------------------------------------
static int64_t uf_find(std::vector<int64_t>& parent, int64_t x) {
  int64_t root = x;
  while (parent[root] != root) root = parent[root];
  while (parent[x] != root) {
    int64_t up = parent[x];
    parent[x] = root;
    x = up;
  }
  return root;
}

int64_t etpu_runs_ccl(const int64_t* starts, const int64_t* ends,
                      const int64_t* values, int64_t n, int64_t width,
                      int32_t connectivity, int32_t* labels_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;

  const int64_t pad = (connectivity == 8) ? 1 : 0;

  // rows are contiguous blocks; find row boundaries on the fly
  int64_t prev_begin = -1, prev_end_idx = -1;  // run index span of previous row
  int64_t cur_row = starts[0] / width;

  for (int64_t i = 0; i < n;) {
    // advance to collect all runs of row `cur_row`
    int64_t j = i;
    while (j < n && starts[j] / width == cur_row) j++;
    // merge against previous row if adjacent
    if (prev_begin >= 0) {
      int64_t p = prev_begin;
      for (int64_t q = i; q < j; ++q) {
        int64_t qs = starts[q] % width;
        int64_t qe = (ends[q] - 1) % width + 1;  // end col (exclusive)
        // advance persistent pointer past runs that end left of q
        while (p < prev_end_idx &&
               ((ends[p] - 1) % width + 1) + pad <= qs) {
          p++;
        }
        // scan all runs overlapping q with a secondary pointer
        for (int64_t pp = p; pp < prev_end_idx; ++pp) {
          int64_t ps = starts[pp] % width;
          if (ps >= qe + pad) break;  // pp (and later) entirely right of q
          if (values[pp] == values[q]) {
            int64_t rp = uf_find(parent, pp), rq = uf_find(parent, q);
            if (rp != rq) parent[std::max(rp, rq)] = std::min(rp, rq);
          }
        }
      }
    }
    // next row
    if (j < n) {
      int64_t next_row = starts[j] / width;
      if (next_row == cur_row + 1) {
        prev_begin = i; prev_end_idx = j;
      } else {
        prev_begin = -1; prev_end_idx = -1;
      }
      cur_row = next_row;
    }
    i = j;
  }

  // assign labels by first raster appearance of each root
  std::vector<int32_t> root_label(n, 0);
  int32_t next_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf_find(parent, i);
    if (root_label[r] == 0) root_label[r] = ++next_label;
    labels_out[i] = root_label[r];
  }
  return next_label;
}

// ---------------------------------------------------------------------------
// 3D connected components over row-split runs of a (d, h, w) volume viewed
// as (d*h, w). Row r = z*h + y. Neighbor rows: (z, y+1), (z+1, y) and, for
// 26-connectivity, (z+1, y±1), with ±1 column tolerance on 26.
// ---------------------------------------------------------------------------
static void uf_union_rows(std::vector<int64_t>& parent, const int64_t* starts,
                          const int64_t* ends, const int64_t* values,
                          int64_t width, int64_t i0, int64_t i1, int64_t j0,
                          int64_t j1, int64_t tol) {
  int64_t p = i0;
  for (int64_t q = j0; q < j1; ++q) {
    int64_t qs = starts[q] % width;
    int64_t qe = (ends[q] - 1) % width + 1;
    while (p < i1 && ((ends[p] - 1) % width + 1) + tol <= qs) p++;
    for (int64_t pp = p; pp < i1; ++pp) {
      int64_t ps = starts[pp] % width;
      if (ps >= qe + tol) break;
      if (values[pp] == values[q]) {
        int64_t rp = uf_find(parent, pp), rq = uf_find(parent, q);
        if (rp != rq) parent[std::max(rp, rq)] = std::min(rp, rq);
      }
    }
  }
}

int64_t etpu_runs_ccl3d(const int64_t* starts, const int64_t* ends,
                        const int64_t* values, int64_t n, int64_t d,
                        int64_t h, int64_t w, int32_t connectivity,
                        int32_t* labels_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> parent(n);
  for (int64_t i = 0; i < n; ++i) parent[i] = i;

  const int64_t n_rows = d * h;
  // row span index (rows are sorted because starts are raster-sorted)
  std::vector<int64_t> row_lo(n_rows + 1, -1);
  std::vector<int64_t> row_hi(n_rows, -1);
  for (int64_t i = 0; i < n;) {
    int64_t r = starts[i] / w;
    int64_t j = i;
    while (j < n && starts[j] / w == r) j++;
    row_lo[r] = i;
    row_hi[r] = j;
    i = j;
  }

  // neighbor row offsets (dz, dy, tol)
  int64_t neigh[4][3];
  int n_neigh;
  if (connectivity == 26) {
    int64_t tmp[4][3] = {{0, 1, 1}, {1, 0, 1}, {1, -1, 1}, {1, 1, 1}};
    n_neigh = 4;
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c) neigh[k][c] = tmp[k][c];
  } else {
    int64_t tmp[4][3] = {{0, 1, 0}, {1, 0, 0}, {0, 0, 0}, {0, 0, 0}};
    n_neigh = 2;
    for (int k = 0; k < 4; ++k)
      for (int c = 0; c < 3; ++c) neigh[k][c] = tmp[k][c];
  }

  for (int64_t r = 0; r < n_rows; ++r) {
    if (row_lo[r] < 0) continue;
    int64_t z = r / h, y = r % h;
    for (int k = 0; k < n_neigh; ++k) {
      int64_t z2 = z + neigh[k][0];
      int64_t y2 = y + neigh[k][1];
      if (z2 < 0 || z2 >= d || y2 < 0 || y2 >= h) continue;
      int64_t r2 = z2 * h + y2;
      if (row_lo[r2] < 0) continue;
      uf_union_rows(parent, starts, ends, values, w, row_lo[r], row_hi[r],
                    row_lo[r2], row_hi[r2], neigh[k][2]);
    }
  }

  std::vector<int32_t> root_label(n, 0);
  int32_t next_label = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t r = uf_find(parent, i);
    if (root_label[r] == 0) root_label[r] = ++next_label;
    labels_out[i] = root_label[r];
  }
  return next_label;
}

// ---------------------------------------------------------------------------
// Fill a raveled int32 buffer with `value` over the given runs.
// ---------------------------------------------------------------------------
void etpu_fill_runs_i32(int32_t* buf, int64_t buf_len, const int64_t* starts,
                        const int64_t* runs, int64_t n, int32_t value) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = starts[i];
    int64_t e = s + runs[i];
    if (s < 0) s = 0;
    if (e > buf_len) e = buf_len;
    for (int64_t k = s; k < e; ++k) buf[k] = value;
  }
}

void etpu_fill_runs_i64(int64_t* buf, int64_t buf_len, const int64_t* starts,
                        const int64_t* runs, int64_t n, int64_t value) {
  for (int64_t i = 0; i < n; ++i) {
    int64_t s = starts[i];
    int64_t e = s + runs[i];
    if (s < 0) s = 0;
    if (e > buf_len) e = buf_len;
    for (int64_t k = s; k < e; ++k) buf[k] = value;
  }
}

// ---------------------------------------------------------------------------
// Encode a raveled int32 image into runs of constant value, splitting at row
// boundaries. Returns number of runs (caller provides capacity = len).
// ---------------------------------------------------------------------------
int64_t etpu_encode_runs_i32(const int32_t* img, int64_t len, int64_t width,
                             int64_t* starts, int64_t* ends, int64_t* values) {
  if (len <= 0) return 0;
  int64_t count = 0;
  int64_t run_start = 0;
  int32_t run_val = img[0];
  for (int64_t i = 1; i <= len; ++i) {
    bool boundary = (i == len) || (img[i] != run_val) || (i % width == 0);
    if (boundary) {
      starts[count] = run_start;
      ends[count] = i;
      values[count] = run_val;
      count++;
      if (i < len) { run_start = i; run_val = img[i]; }
    }
  }
  return count;
}

}  // extern "C"
