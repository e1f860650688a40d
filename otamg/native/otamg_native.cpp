// otamg native host layer.
//
// The reference's heavy lifting under the MATLAB surface is SuiteSparse
// (dmperm for components.m:36, sparse \ for Hybrid_AMG.m:91 and
// transfer.m:21, ichol for PCG.m:46, CSC SpGEMM for transfer.m:66).
// This module provides from-scratch C++ equivalents for the host side of
// the framework: problem-setup oracles, host-mode solves, and the
// data-loading pipeline.  Device-side equivalents live in otamg/amg and
// otamg/sparse; this file is the L0 "implicit native layer" made explicit
// (SURVEY.md section 2.4).
//
// Build: g++ -O3 -march=native -shared -fPIC -o libotamg_native.so
//        otamg_native.cpp   (driven by otamg/native/__init__.py)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// Connected components of a bipartite graph via union-find with path
// halving (replaces dmperm-based components.m).  Nodes: columns 0..n-1,
// rows n..n+m-1; edges (rows[k], cols[k]).  Output labels[i] = smallest
// node index in i's component (matching the device implementation in
// otamg/amg/graph.py).
// ---------------------------------------------------------------------------

static int32_t uf_find(std::vector<int32_t>& parent, int32_t x) {
  while (parent[x] != x) {
    parent[x] = parent[parent[x]];
    x = parent[x];
  }
  return x;
}

void otamg_cc_bipartite(const int32_t* edge_rows, const int32_t* edge_cols,
                        int64_t nnz, int32_t m, int32_t n,
                        int32_t* labels_out) {
  const int32_t N = m + n;
  std::vector<int32_t> parent(N);
  for (int32_t i = 0; i < N; ++i) parent[i] = i;
  for (int64_t k = 0; k < nnz; ++k) {
    int32_t a = uf_find(parent, edge_cols[k]);          // column node
    int32_t b = uf_find(parent, n + edge_rows[k]);      // row node
    if (a != b) parent[std::max(a, b)] = std::min(a, b);
  }
  for (int32_t i = 0; i < N; ++i) labels_out[i] = uf_find(parent, i);
}

// ---------------------------------------------------------------------------
// CSR SpMV: y = A x.
// ---------------------------------------------------------------------------

void otamg_csr_spmv(const int64_t* indptr, const int32_t* indices,
                    const double* vals, const double* x, int32_t nrows,
                    double* y) {
  for (int32_t i = 0; i < nrows; ++i) {
    double acc = 0.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k)
      acc += vals[k] * x[indices[k]];
    y[i] = acc;
  }
}

// ---------------------------------------------------------------------------
// CSR SpGEMM (Gustavson), two-pass: symbolic row counts then numeric fill.
// Replaces MATLAB's CSC * inside the Galerkin triple product
// (transfer.m:66) for host-side setup paths.
// ---------------------------------------------------------------------------

void otamg_spgemm_symbolic(const int64_t* a_indptr, const int32_t* a_indices,
                           int32_t a_rows, const int64_t* b_indptr,
                           const int32_t* b_indices, int32_t b_cols,
                           int64_t* c_row_nnz) {
  std::vector<int32_t> marker(b_cols, -1);
  for (int32_t i = 0; i < a_rows; ++i) {
    int64_t count = 0;
    for (int64_t ka = a_indptr[i]; ka < a_indptr[i + 1]; ++ka) {
      int32_t k = a_indices[ka];
      for (int64_t kb = b_indptr[k]; kb < b_indptr[k + 1]; ++kb) {
        int32_t j = b_indices[kb];
        if (marker[j] != i) {
          marker[j] = i;
          ++count;
        }
      }
    }
    c_row_nnz[i] = count;
  }
}

void otamg_spgemm_numeric(const int64_t* a_indptr, const int32_t* a_indices,
                          const double* a_vals, int32_t a_rows,
                          const int64_t* b_indptr, const int32_t* b_indices,
                          const double* b_vals, int32_t b_cols,
                          const int64_t* c_indptr, int32_t* c_indices,
                          double* c_vals) {
  std::vector<int64_t> slot(b_cols, -1);
  std::vector<double> acc(b_cols, 0.0);
  for (int32_t i = 0; i < a_rows; ++i) {
    int64_t next = c_indptr[i];
    for (int64_t ka = a_indptr[i]; ka < a_indptr[i + 1]; ++ka) {
      int32_t k = a_indices[ka];
      double va = a_vals[ka];
      for (int64_t kb = b_indptr[k]; kb < b_indptr[k + 1]; ++kb) {
        int32_t j = b_indices[kb];
        if (slot[j] < c_indptr[i]) {  // not yet emitted for this row
          slot[j] = next;
          c_indices[next] = j;
          c_vals[next] = va * b_vals[kb];
          ++next;
        } else {
          c_vals[slot[j]] += va * b_vals[kb];
        }
      }
    }
    // canonical ordering within the row
    int64_t lo = c_indptr[i], hi = c_indptr[i + 1];
    std::vector<std::pair<int32_t, double>> row(hi - lo);
    for (int64_t t = lo; t < hi; ++t)
      row[t - lo] = {c_indices[t], c_vals[t]};
    std::sort(row.begin(), row.end());
    for (int64_t t = lo; t < hi; ++t) {
      c_indices[t] = row[t - lo].first;
      c_vals[t] = row[t - lo].second;
    }
    for (auto& p : row) slot[p.first] = -1;
  }
}

// ---------------------------------------------------------------------------
// Zero-fill incomplete Cholesky IC(0) on a CSR *lower-triangular pattern*
// (including diagonal), in place over vals.  Equivalent role to MATLAB's
// ichol(H) for the precd=4 PCG branch (PCG.m:46).  Returns 0 on success,
// row+1 of the first nonpositive pivot otherwise.
// ---------------------------------------------------------------------------

int32_t otamg_ichol0(const int64_t* indptr, const int32_t* indices,
                     double* vals, int32_t n) {
  for (int32_t i = 0; i < n; ++i) {
    double diag = 0.0;
    int64_t dpos = -1;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j > i) return -(i + 1);  // not lower-triangular
      double sum = vals[k];
      // subtract dot of rows i and j over columns < j
      int64_t pi = indptr[i], pj = indptr[j];
      while (pi < indptr[i + 1] && pj < indptr[j + 1]) {
        int32_t ci = indices[pi], cj = indices[pj];
        if (ci >= j || cj >= j) break;
        if (ci == cj) {
          sum -= vals[pi] * vals[pj];
          ++pi;
          ++pj;
        } else if (ci < cj) {
          ++pi;
        } else {
          ++pj;
        }
      }
      if (j == i) {
        if (sum <= 0.0) return i + 1;
        diag = std::sqrt(sum);
        vals[k] = diag;
        dpos = k;
      } else {
        // L[j,j] is the last entry of row j (canonical order)
        double ljj = vals[indptr[j + 1] - 1];
        vals[k] = sum / ljj;
      }
    }
    (void)dpos;
  }
  return 0;
}

// Triangular solves with the IC(0) factor: L y = b, then L^T x = y.
void otamg_ichol_solve(const int64_t* indptr, const int32_t* indices,
                       const double* vals, int32_t n, const double* b,
                       double* x) {
  std::vector<double> y(n);
  for (int32_t i = 0; i < n; ++i) {
    double acc = b[i];
    double diag = 1.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j == i)
        diag = vals[k];
      else
        acc -= vals[k] * y[j];
    }
    y[i] = acc / diag;
  }
  for (int32_t i = n - 1; i >= 0; --i) x[i] = y[i];
  for (int32_t i = n - 1; i >= 0; --i) {
    double diag = 1.0;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j == i) diag = vals[k];
    }
    x[i] /= diag;
    for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
      int32_t j = indices[k];
      if (j != i) x[j] -= vals[k] * x[i];
    }
  }
}

// ---------------------------------------------------------------------------
// Dense Cholesky solve (column-major lower), for small direct solves
// (the Hybrid_AMG.m:91 small-component role on host paths).
// ---------------------------------------------------------------------------

int32_t otamg_chol_solve_dense(double* A, double* b, int32_t n) {
  for (int32_t j = 0; j < n; ++j) {
    double d = A[j * n + j];
    for (int32_t k = 0; k < j; ++k) d -= A[k * n + j] * A[k * n + j];
    if (d <= 0.0) return j + 1;
    d = std::sqrt(d);
    A[j * n + j] = d;
    for (int32_t i = j + 1; i < n; ++i) {
      double s = A[j * n + i];
      for (int32_t k = 0; k < j; ++k)
        s -= A[k * n + i] * A[k * n + j];
      A[j * n + i] = s / d;
    }
  }
  for (int32_t i = 0; i < n; ++i) {  // L y = b
    double s = b[i];
    for (int32_t k = 0; k < i; ++k) s -= A[k * n + i] * b[k];
    b[i] = s / A[i * n + i];
  }
  for (int32_t i = n - 1; i >= 0; --i) {  // L^T x = y
    double s = b[i];
    for (int32_t k = i + 1; k < n; ++k) s -= A[i * n + k] * b[k];
    b[i] = s / A[i * n + i];
  }
  return 0;
}

}  // extern "C"
