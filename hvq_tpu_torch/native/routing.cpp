// hvq_routing — the partitioned engine's host router, in C++.
//
// Two passes that models/partitioned.py and index/partition.py run once a
// search, over every query of the call:
//   * hvq_query_ranges: each predicate → its row range of a sorted view,
//     what np.searchsorted gives on the host sort keys, bit for bit;
//   * hvq_pack_groups: the greedy packer of the routed queries into shared
//     windows (the JAX engine's _pack_groups, step for step).
//
// The ranges come from small or cache-friendly searches instead of
// 10⁷-key binary searches one after another in file order. Types 1 and 3
// look their category up in a table of the cat view's distinct C keys and
// their row bounds (about 1000 entries). Type 3 then searches T within its
// category's segment, the queries taken category by category, so a segment
// is read from memory once. Every search runs branch-free, 16 at a time in
// lockstep (search_lanes), so their loads overlap: the 10⁷-key searches of
// type 2 in T_sorted pay their cache misses together instead of one after
// another.
//
// Comparisons are NumPy's: keys are float32 and needles float64, which
// holds every value a float32 or a float64 needle has, so a comparison
// gives what NumPy's (in float32 or float64) gives; NaN sorts above +inf
// (npy_half/float/double "LT": a < b or (b is NaN and a is not)).
//
// Built into the same library as hvq_native.cpp (native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// One np.searchsorted: the needle v in the sorted keys a[0, n); the answer
// plus add goes to *out.
struct Search {
  const float* a;
  int64_t n;
  double v;
  int64_t add;
  long long* out;
};

// The searches of one side: on the left the first i with !(a[i] < v), on
// the right the first i with v < a[i], in NumPy's order (NaN last). A
// needle that is not NaN has its answer among the keys that are not, where
// NumPy's order is the IEEE one: it joins the lanes (search_lanes). A NaN
// needle's answer is known: every key that is not NaN on the left, n on
// the right.
struct Side {
  bool right;
  std::vector<Search> jobs;

  void add(const float* a, int64_t n, double v, int64_t add, long long* out) {
    if (v == v) {
      jobs.push_back({a, n, v, add, out});
      return;
    }
    int64_t lo = 0, hi = n;     // the first NaN key
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo) / 2;
      if (a[mid] == a[mid]) lo = mid + 1; else hi = mid;
    }
    *out = add + (right ? n : lo);
  }
};

constexpr int kLanes = 16;

// Every search of s[0, count), kLanes at a time in lockstep: each lane
// halves its own range by adding half times a 0/1 comparison, so no lane
// branches and the lanes' loads are in flight together. A lane of an
// empty range reads a dummy key.
template <bool kRight>
void search_lanes(const Search* s, int64_t count) {
  static const float dummy = 0.0f;
  for (int64_t c = 0; c < count; c += kLanes) {
    const int w = (int)std::min<int64_t>(kLanes, count - c);
    const float* a[kLanes];
    int64_t pos[kLanes], len[kLanes];
    double v[kLanes];
    int64_t widest = 1;
    for (int j = 0; j < w; ++j) {
      const Search& q = s[c + j];
      a[j] = q.n > 0 ? q.a : &dummy;
      pos[j] = 0;
      len[j] = q.n > 0 ? q.n : 1;
      v[j] = q.v;
      widest = std::max(widest, len[j]);
    }
    bool same = true;
    for (int j = 1; j < w; ++j) same &= len[j] == len[0];
    // one length for every lane (one category's segment, the table,
    // T_sorted): the halving is shared, the loop shorter
    for (int64_t n = widest; same && n > 1; n -= n / 2) {
      const int64_t half = n / 2;
      for (int j = 0; j < w; ++j) {
        const double x = a[j][pos[j] + half];
        pos[j] += half & -(int64_t)(kRight ? x <= v[j] : x < v[j]);
      }
    }
    while (!same && widest > 1) {
      for (int j = 0; j < w; ++j) {
        const int64_t half = len[j] / 2;
        const double x = a[j][pos[j] + half];
        pos[j] += half & -(int64_t)(kRight ? x <= v[j] : x < v[j]);
        len[j] -= half;
      }
      widest -= widest / 2;
    }
    for (int j = 0; j < w; ++j) {
      const Search& q = s[c + j];
      const double x = a[j][pos[j]];
      *q.out = q.add + (q.n > 0 ? pos[j] + (kRight ? x <= v[j] : x < v[j]) : 0);
    }
  }
}

void run(Side& left, Side& right) {
  search_lanes<false>(left.jobs.data(), (int64_t)left.jobs.size());
  search_lanes<true>(right.jobs.data(), (int64_t)right.jobs.size());
  left.jobs.clear();
  right.jobs.clear();
}

// The positions 0 … n-1 sorted by key[pos], ties in position order: an
// LSD radix sort of the keys less their least, 11 bits a pass.
std::vector<int64_t> stable_order(const long long* key, int64_t n) {
  std::vector<int64_t> pos(n), tmp(n);
  std::vector<uint64_t> k(n), ktmp(n);
  long long lo = key[0];
  for (int64_t i = 1; i < n; ++i) lo = std::min(lo, key[i]);
  uint64_t top = 0;
  for (int64_t i = 0; i < n; ++i) {
    k[i] = (uint64_t)key[i] - (uint64_t)lo;
    top |= k[i];
    pos[i] = i;
  }
  for (int shift = 0; shift < 64 && (top >> shift); shift += 11) {
    int64_t count[2049] = {0};
    for (int64_t i = 0; i < n; ++i) ++count[((k[i] >> shift) & 2047) + 1];
    for (int d = 0; d < 2048; ++d) count[d + 1] += count[d];
    for (int64_t i = 0; i < n; ++i) {
      const int64_t at = count[(k[i] >> shift) & 2047]++;
      ktmp[at] = k[i];
      tmp[at] = pos[i];
    }
    k.swap(ktmp);
    pos.swap(tmp);
  }
  return pos;
}

}  // namespace

extern "C" {

// Per query: (view, start, end), the row range its predicate selects:
// view 1 (the T-sorted view) for type 2, else 0 (the (C, T)-sorted view);
// [0, n) for a query of no predicate. qtype int32[m]; v, l, r float64[m];
// cats float32[K], the cat view's distinct C keys in order, and
// bounds int64[K + 1], their first rows and n; T_key float32[n], the cat
// view's T keys; T_sorted float32[n]. counts[3] receives the queries
// resolved by the category table (types 1 and 3), by the segment search
// (type 3) and by the T_sorted search (type 2).
void hvq_query_ranges(long long m, const int32_t* qtype, const double* v, const double* l,
                      const double* r, long long K, const float* cats,
                      const long long* bounds, long long n, const float* T_key,
                      const float* T_sorted, int32_t* view, long long* start,
                      long long* end, long long* counts) {
  Side left{false, {}}, right{true, {}};
  std::vector<int64_t> type3;
  long long n_table = 0, n_time = 0;
  // types 1 and 3: the category's table positions into start and end
  for (long long i = 0; i < m; ++i) {
    const int32_t t = qtype[i];
    view[i] = t == 2 ? 1 : 0;
    start[i] = 0;
    end[i] = n;
    if (t == 1 || t == 3) {
      left.add(cats, K, v[i], 0, &start[i]);
      right.add(cats, K, v[i], 0, &end[i]);
      ++n_table;
      if (t == 3) type3.push_back(i);
    }
  }
  run(left, right);

  // type 3 in category order (a counting sort on the table position), so a
  // segment's keys stay in cache for all of its queries; type 2 after them
  const int64_t n3 = (int64_t)type3.size();
  std::vector<int64_t> first(K + 2, 0);
  for (int64_t i : type3) ++first[start[i] + 1];
  for (long long c = 0; c <= K; ++c) first[c + 1] += first[c];
  std::vector<int64_t> order(n3);
  for (int64_t i : type3) order[first[start[i]]++] = i;
  for (long long i = 0; i < m; ++i) {
    if (qtype[i] == 1 || qtype[i] == 3) {
      start[i] = bounds[start[i]];
      end[i] = bounds[end[i]];
    }
  }
  for (int64_t i : order) {
    const int64_t s = start[i], e = end[i];
    left.add(T_key + s, e - s, l[i], s, &start[i]);
    right.add(T_key + s, e - s, r[i], s, &end[i]);
  }
  for (long long i = 0; i < m; ++i) {
    if (qtype[i] == 2) {
      left.add(T_sorted, n, l[i], 0, &start[i]);
      right.add(T_sorted, n, r[i], 0, &end[i]);
      ++n_time;
    }
  }
  run(left, right);
  counts[0] = n_table;
  counts[1] = n3;
  counts[2] = n_time;
}

// The greedy shared-window packer over the routed queries q_idx[nq]
// (indices into start/end), walked in range-start order (ties in q_idx's
// order). A group extends while its window stays within its cap and it has
// fewer than G members; it escalates to the next cap only while it is under
// half full. A window start is aligned down to 128 rows where that keeps
// the first member within the widest cap. caps[ncaps] ascending.
//
// Writes each group in the order the walk closes it: g_cap (index into
// caps), g_start and its members (row g of members[nq][G], -1 past the
// last). Returns the number of groups, or -1 if some q_idx is outside
// [0, m).
long long hvq_pack_groups(long long nq, const long long* q_idx, long long m,
                          const long long* start, const long long* end, long long ncaps,
                          const long long* caps, long long G, int32_t* g_cap,
                          long long* g_start, long long* members) {
  if (nq == 0) return 0;
  std::vector<long long> first(nq);   // each query's range start
  for (long long j = 0; j < nq; ++j) {
    const long long q = q_idx[j];
    if (q < 0 || q >= m) return -1;
    first[j] = start[q];
  }
  const std::vector<int64_t> order = stable_order(first.data(), nq);
  const long long widest = caps[ncaps - 1];
  auto cover = [&](long long width) {
    for (long long i = 0; i < ncaps; ++i)
      if (caps[i] >= width) return i;
    return ncaps - 1;
  };
  long long groups = 0, size = 0, gs = 0, ge = 0, ti = 0;
  long long* row = members;
  auto close = [&]() {
    g_cap[groups] = (int32_t)cover(ge - gs);
    g_start[groups] = gs;
    for (long long k = size; k < G; ++k) row[k] = -1;
    ++groups;
    row += G;
    size = 0;
  };
  auto open = [&](long long q) {
    const long long s = start[q], e = end[q];
    gs = s - (((s % 128) + 128) % 128);
    if (e - gs > widest) gs = s;   // the alignment is best-effort
    ge = std::max(e, gs);
    ti = cover(ge - gs);
    row[0] = q;
    size = 1;
  };
  for (long long j = 0; j < nq; ++j) {
    const long long q = q_idx[order[j]];
    if (size == 0) {
      open(q);
      continue;
    }
    const long long new_end = std::max(ge, (long long)end[q]);
    const long long width = new_end - gs;
    if (size < G && width <= caps[ti]) {
      row[size++] = q;
      ge = new_end;
    } else if (size < G / 2 && ti + 1 < ncaps && width <= caps[ti + 1]) {
      ++ti;
      row[size++] = q;
      ge = new_end;
    } else {
      close();
      open(q);
    }
  }
  close();
  return groups;
}

}  // extern "C"
