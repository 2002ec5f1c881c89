// Linear sum assignment (Hungarian / Jonker-Volgenant style) host kernel.
//
// TPU-native replacement for the reference's scipy.optimize.linear_sum_assignment
// call sites:
//   * query<->GT-mask matching in the training criterion
//     (reference pasco/loss/matcher_sparse.py:151)
//   * cross-subnet query matching in the ensembler
//     (reference pasco/models/ensembler.py:440, models/utils.py:191)
//   * segment matching in uncertainty evaluation
//     (reference pasco/loss/panoptic_quality.py:166)
//
// Cost matrices are tiny (<= 100 x ~64), so an O(n^2 m) shortest-augmenting-
// path implementation is ample; this runs on host, outside the XLA hot path,
// invoked via jax.pure_callback / numpy.
//
// Build: pasco_torch/native/__init__.py, at first use, into
// build/pasco_torch/native/libpasco_native.so

#include <cfloat>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Solve min-cost assignment of each of n "small-side" items to a distinct
// one of m "large-side" items (n <= m).  cost is row-major [n, m].
// Writes match[i] = assigned column for row i.
void solve_rect(const double* cost, int n, int m, int* match) {
  // Potentials; 1-based internal indexing (classic shortest augmenting path).
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<int> p(m + 1, 0), way(m + 1, 0);
  for (int i = 1; i <= n; ++i) {
    p[0] = i;
    int j0 = 0;
    std::vector<double> minv(m + 1, DBL_MAX);
    std::vector<char> used(m + 1, 0);
    do {
      used[j0] = 1;
      int i0 = p[j0], j1 = -1;
      double delta = DBL_MAX;
      for (int j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) {
          minv[j] = cur;
          way[j] = j0;
        }
        if (minv[j] < delta) {
          delta = minv[j];
          j1 = j;
        }
      }
      for (int j = 0; j <= m; ++j) {
        if (used[j]) {
          u[p[j]] += delta;
          v[j] -= delta;
        } else {
          minv[j] -= delta;
        }
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      int j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  for (int i = 0; i < n; ++i) match[i] = -1;
  for (int j = 1; j <= m; ++j) {
    if (p[j] > 0) match[p[j] - 1] = j - 1;
  }
}

}  // namespace

extern "C" {

// Rectangular LSA equivalent to scipy.optimize.linear_sum_assignment.
// cost: row-major [n_rows, n_cols]. Writes col_for_row[i] = matched column
// of row i, or -1 when n_rows > n_cols and row i is unmatched.
// Returns 0 on success.
int pasco_linear_sum_assignment(const double* cost, int n_rows, int n_cols,
                                int* col_for_row) {
  if (n_rows <= 0 || n_cols <= 0) return 1;
  if (n_rows <= n_cols) {
    solve_rect(cost, n_rows, n_cols, col_for_row);
    return 0;
  }
  // Transpose so the small side drives the augmenting paths.
  std::vector<double> t(static_cast<size_t>(n_rows) * n_cols);
  for (int i = 0; i < n_rows; ++i)
    for (int j = 0; j < n_cols; ++j)
      t[static_cast<size_t>(j) * n_rows + i] = cost[static_cast<size_t>(i) * n_cols + j];
  std::vector<int> row_for_col(n_cols, -1);
  solve_rect(t.data(), n_cols, n_rows, row_for_col.data());
  for (int i = 0; i < n_rows; ++i) col_for_row[i] = -1;
  for (int j = 0; j < n_cols; ++j) {
    if (row_for_col[j] >= 0) col_for_row[row_for_col[j]] = j;
  }
  return 0;
}

// Batched variant: costs [batch, n_rows, n_cols] -> out [batch, n_rows].
int pasco_linear_sum_assignment_batch(const double* costs, int batch,
                                      int n_rows, int n_cols, int* out) {
  for (int b = 0; b < batch; ++b) {
    int rc = pasco_linear_sum_assignment(
        costs + static_cast<size_t>(b) * n_rows * n_cols, n_rows, n_cols,
        out + static_cast<size_t>(b) * n_rows);
    if (rc) return rc;
  }
  return 0;
}

}  // extern "C"
