// Per-gene sums of one scaffold's per-mm coverage and clonality, in one
// pass over its positions per mm level (profile/genes.py:gene_range_sums).
//
// For each level m (ascending) and each boundary b of `bounds` (sorted,
// unique, in [0, L], the last one L) the pass stores four running sums
// over the positions [0, b) of level m:
//   cov    sum of total[m, p] (int64)
//   brd    count of total[m, p] > 0 (int64)
//   n_clon count of positions with a clonality at a level <= m (int64)
//   s_clon sum of that clonality, forward-filled along mm (double)
// A gene's value at level m is then the difference of two boundary columns.
// `total` accumulates non-negative counts over the levels, so total > 0 is
// the position's coverage at some level <= m.
//
// The clonality carries across levels in two L-sized buffers: the value of
// the highest level <= m that has one (0 where none has), and whether
// there is one. s_clon adds, position by position from the scaffold's
// start, that value as a double: a sequential sum, the same additions in
// the same order as numpy's float64 cumsum of the filled values, so the
// differences round alike. No reassociation: this file is built without
// -ffast-math, and the compiler does not vectorise a floating-point sum
// without it.
//
// total is int32 or int64 and clon float32, each addressed by element
// strides (a row of stride Lp is read in place); n_mm rows of L positions
// are read. Outputs are [n_mm, n_bounds], row-major.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

template <typename T>
void range_sums(const T* total, int64_t t_row, int64_t t_col,
                const float* clon, int64_t c_row, int64_t c_col,
                int32_t n_mm, int64_t L, const int64_t* bounds,
                int64_t n_bounds, int64_t* cov, int64_t* brd,
                int64_t* n_clon, double* s_clon) {
  std::vector<float> filled(L, 0.0f);
  std::vector<uint8_t> has(L, 0);
  for (int32_t m = 0; m < n_mm; ++m) {
    const T* t = total + m * t_row;
    const float* c = clon + m * c_row;
    const int64_t o = static_cast<int64_t>(m) * n_bounds;
    int64_t cs = 0, bs = 0, hs = 0;
    double vs = 0.0;
    int64_t p = 0;
    for (int64_t k = 0; k < n_bounds; ++k) {
      const int64_t end = bounds[k];
      for (; p < end; ++p) {
        const int64_t v = t[p * t_col];
        cs += v;
        bs += v > 0;
        // branch-free: where a level has no value is data, not a pattern
        const float x = c[p * c_col];
        const bool set = !std::isnan(x);
        const float f = set ? x : filled[p];
        const uint8_t h = has[p] | set;
        filled[p] = f;
        has[p] = h;
        hs += h;
        vs += static_cast<double>(f);
      }
      cov[o + k] = cs;
      brd[o + k] = bs;
      n_clon[o + k] = hs;
      s_clon[o + k] = vs;
    }
  }
}

}  // namespace

extern "C" {

// Returns 0, or -1 where the bounds are not sorted, unique, in [0, L] and
// ending at L (the last boundary walks every position, which the next
// level's filled clonality needs).
int gr_range_sums(const void* total, int total_is_i64, int64_t t_row,
                  int64_t t_col, const float* clon, int64_t c_row,
                  int64_t c_col, int32_t n_mm, int64_t L,
                  const int64_t* bounds, int64_t n_bounds, int64_t* cov,
                  int64_t* brd, int64_t* n_clon, double* s_clon) {
  if (n_bounds < 1 || bounds[n_bounds - 1] != L) return -1;
  for (int64_t k = 0; k < n_bounds; ++k) {
    if (bounds[k] < 0 || (k > 0 && bounds[k] <= bounds[k - 1])) return -1;
  }
  if (total_is_i64)
    range_sums(static_cast<const int64_t*>(total), t_row, t_col, clon, c_row,
               c_col, n_mm, L, bounds, n_bounds, cov, brd, n_clon, s_clon);
  else
    range_sums(static_cast<const int32_t*>(total), t_row, t_col, clon, c_row,
               c_col, n_mm, L, bounds, n_bounds, cov, brd, n_clon, s_clon);
  return 0;
}

}  // extern "C"
