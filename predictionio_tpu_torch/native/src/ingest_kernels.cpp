// Native ingest kernels — the host-side pad/bucketize hot path.
//
// Role: the vectorized core of the streaming ingest pipeline
// (data/columnar.py + ops/als.py). Two kernels:
//
// - pio_merge_runs_i64: stable k-way merge of per-block sorted key runs
//   into one global permutation — replaces the O(N log N) full argsort
//   of the monolithic dedup pass with an O(N log k) merge whose inputs
//   were sorted block-by-block WHILE decode of later blocks was still
//   running. The permutation is bit-identical to
//   np.argsort(keys, kind="stable") over the concatenated runs.
//
// - pio_bucket_fill: one pass over the deduped (row-sorted) triples
//   scattering every entry straight into its bucket's padded
//   cols/weights/mask tables — replaces the per-bucket boolean mask +
//   fancy-index scatter (one full pass over all N entries PER bucket).
//   Pure data movement, so the filled tables are byte-identical to the
//   numpy path.
//
// Both release the GIL for their whole run (plain ctypes calls), so the
// consumer thread can merge/fill while producer threads decode.
//
// The port's copy of predictionio_tpu/native/src/ingest_kernels.cpp,
// unchanged. C ABI only; loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Merge two sorted index runs [a_begin, a_end) and [b_begin, b_end)
// (indices into `keys`) into `out`, stable: ties prefer the run whose
// indices are smaller (runs are handed over in ascending index order).
void merge2(const int64_t* keys, const int64_t* a, int64_t na,
            const int64_t* b, int64_t nb, int64_t* out) {
  int64_t i = 0, j = 0, k = 0;
  while (i < na && j < nb) {
    // a's indices all precede b's, so <= keeps stability
    if (keys[a[i]] <= keys[b[j]]) out[k++] = a[i++];
    else out[k++] = b[j++];
  }
  if (i < na) std::memcpy(out + k, a + i, sizeof(int64_t) * (na - i));
  if (j < nb) std::memcpy(out + k, b + j, sizeof(int64_t) * (nb - j));
}

}  // namespace

extern "C" {

// Stable merge of n_runs sorted runs laid out contiguously in `keys`
// (run r spans [offsets[r], offsets[r+1]) and is already sorted
// ascending). Writes the global permutation into `perm` (int64 [n]):
// keys[perm] is ascending and ties keep ascending index order — exactly
// np.argsort(keys, kind="stable"). Balanced pairwise merge: log2(k)
// passes over N.
void pio_merge_runs_i64(const int64_t* keys, const int64_t* offsets,
                        int32_t n_runs, int64_t n, int64_t* perm) {
  if (n <= 0) return;
  if (n_runs <= 1) {
    for (int64_t i = 0; i < n; ++i) perm[i] = i;
    return;
  }
  // seed: each run's identity indices
  std::vector<int64_t> buf_a(n), buf_b(n);
  for (int64_t i = 0; i < n; ++i) buf_a[i] = i;
  // current run boundaries (ascending, runs contiguous in buf)
  std::vector<int64_t> bounds(offsets, offsets + n_runs + 1);
  int64_t* src = buf_a.data();
  int64_t* dst = buf_b.data();
  while (bounds.size() > 2) {
    std::vector<int64_t> next_bounds;
    next_bounds.push_back(0);
    size_t r = 0;
    while (r + 2 < bounds.size()) {
      const int64_t lo = bounds[r], mid = bounds[r + 1], hi = bounds[r + 2];
      merge2(keys, src + lo, mid - lo, src + mid, hi - mid, dst + lo);
      next_bounds.push_back(hi);
      r += 2;
    }
    if (r + 2 == bounds.size()) {  // odd run out: copy through
      const int64_t lo = bounds[r], hi = bounds[r + 1];
      std::memcpy(dst + lo, src + lo, sizeof(int64_t) * (hi - lo));
      next_bounds.push_back(hi);
    }
    std::swap(src, dst);
    bounds.swap(next_bounds);
  }
  std::memcpy(perm, src, sizeof(int64_t) * n);
}

// One-pass scatter of deduped triples into per-bucket padded tables.
// Inputs (all length n, sorted by row — the dedup contract):
//   rows/cols int64, vals float32, pos int64 (position within row).
// Per-row assignment (length n_rows): b_of_row int32 (bucket index),
// rank int64 (row's table row within its bucket; only valid where the
// row has entries). Per-bucket (length n_buckets): L int64 (padded row
// length), and table base pointers cols_out (int32), w_out/m_out
// (float32) — each bucket's table is its own C-contiguous [Bp, L[b]]
// array, zero-initialized by the caller.
void pio_bucket_fill(int64_t n, const int64_t* rows, const int64_t* cols,
                     const float* vals, const int64_t* pos,
                     const int32_t* b_of_row, const int64_t* rank,
                     int32_t n_buckets, const int64_t* L,
                     int32_t** cols_out, float** w_out, float** m_out) {
  (void)n_buckets;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t r = rows[i];
    const int32_t b = b_of_row[r];
    const int64_t at = rank[r] * L[b] + pos[i];
    cols_out[b][at] = static_cast<int32_t>(cols[i]);
    w_out[b][at] = vals[i];
    m_out[b][at] = 1.0f;
  }
}

// Sequential per-key segment boundaries over SORTED keys: writes the
// index of each segment start into `starts` and returns the unique
// count. Identical grouping to
// np.flatnonzero(np.r_[True, k[1:] != k[:-1]]).
int64_t pio_segment_starts_i64(const int64_t* keys, int64_t n,
                               int64_t* starts) {
  if (n <= 0) return 0;
  int64_t m = 0;
  starts[m++] = 0;
  for (int64_t i = 1; i < n; ++i) {
    if (keys[i] != keys[i - 1]) starts[m++] = i;
  }
  return m;
}

}  // extern "C"
