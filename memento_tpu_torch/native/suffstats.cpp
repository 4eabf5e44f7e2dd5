// Native whole-matrix sufficient-statistic passes (setup-phase hot path).
//
// setup_memento makes several full passes over the count matrix: naive and
// masked size factors, then per-gene moment sufficient statistics with each
// size factor.  The scipy formulation costs a CSR->CSC conversion plus
// full-matrix temporaries (X.power(2), X.multiply(mask)) per pass — multi-GB
// allocations at atlas scale (ref computes the same quantities as row-weight
// sparse dot products, estimator.py:177-180).  These kernels do the same
// math in single fused passes over the CSR arrays, f64 accumulation,
// OpenMP over row blocks with per-thread gene accumulators.
//
// Copied from the JAX package's native/suffstats.cpp.  Built with the other
// two sources into one library at first use (memento_tpu_torch/native/
// _build.py) and loaded by ctypes; the scipy versions in
// memento_tpu_torch/ops/{estimators,size_factor,corr}.py are the oracle.

#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Per-gene sufficient statistics in one CSR pass:
//   s1[g]   = sum_cells x / sf
//   s2[g]   = sum_cells x^2 / sf^2
//   s1sq[g] = sum_cells x / sf^2
void suffstats_csr(int64_t n_cells, int64_t n_genes, const int64_t* indptr,
                   const int32_t* indices, const float* data,
                   const double* inv_sf, double* s1, double* s2,
                   double* s1sq) {
  for (int64_t g = 0; g < n_genes; ++g) s1[g] = s2[g] = s1sq[g] = 0.0;
#ifdef _OPENMP
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  std::vector<std::vector<double>> acc(
      n_threads, std::vector<double>(3 * n_genes, 0.0));
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    double* a = acc[tid].data();
#pragma omp for schedule(static)
    for (int64_t c = 0; c < n_cells; ++c) {
      const double w = inv_sf[c];
      const double w2 = w * w;
      for (int64_t k = indptr[c]; k < indptr[c + 1]; ++k) {
        const int64_t g = indices[k];
        const double x = data[k];
        a[3 * g] += x * w;
        a[3 * g + 1] += x * x * w2;
        a[3 * g + 2] += x * w2;
      }
    }
  }
  for (int t = 0; t < n_threads; ++t) {
    const double* a = acc[t].data();
    for (int64_t g = 0; g < n_genes; ++g) {
      s1[g] += a[3 * g];
      s2[g] += a[3 * g + 1];
      s1sq[g] += a[3 * g + 2];
    }
  }
}

// CSC variant: each gene's nonzeros are contiguous, so the parallelism is
// simply one gene per iteration (no thread-local accumulators needed).
void suffstats_csc(int64_t n_genes, const int64_t* indptr,
                   const int32_t* indices, const float* data,
                   const double* inv_sf, double* s1, double* s2,
                   double* s1sq) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t g = 0; g < n_genes; ++g) {
    double a = 0.0, b = 0.0, c = 0.0;
    for (int64_t k = indptr[g]; k < indptr[g + 1]; ++k) {
      const double w = inv_sf[indices[k]];
      const double x = data[k];
      a += x * w;
      b += x * x * w * w;
      c += x * w * w;
    }
    s1[g] = a;
    s2[g] = b;
    s1sq[g] = c;
  }
}

// Row totals and (optionally) gene-masked row totals in one CSR pass —
// replaces X.sum(axis=1) + X.multiply(mask).sum(axis=1).
// masked_tot may be null (skipped); mask may be null when masked_tot is.
void row_sums_csr(int64_t n_cells, const int64_t* indptr,
                  const int32_t* indices, const float* data,
                  const uint8_t* mask, double* row_tot, double* masked_tot) {
#pragma omp parallel for schedule(static)
  for (int64_t c = 0; c < n_cells; ++c) {
    double tot = 0.0, mtot = 0.0;
    for (int64_t k = indptr[c]; k < indptr[c + 1]; ++k) {
      const double x = data[k];
      tot += x;
      if (masked_tot && mask[indices[k]]) mtot += x;
    }
    row_tot[c] = tot;
    if (masked_tot) masked_tot[c] = mtot;
  }
}

// Per-gene nonzero-count and sum in one CSR pass (column means / detection
// rates without a CSC conversion).
void col_sums_csr(int64_t n_cells, int64_t n_genes, const int64_t* indptr,
                  const int32_t* indices, const float* data, double* col_sum,
                  int64_t* col_nnz) {
  for (int64_t g = 0; g < n_genes; ++g) {
    col_sum[g] = 0.0;
    col_nnz[g] = 0;
  }
#ifdef _OPENMP
  int n_threads = omp_get_max_threads();
#else
  int n_threads = 1;
#endif
  std::vector<std::vector<double>> acc(n_threads,
                                       std::vector<double>(n_genes, 0.0));
  std::vector<std::vector<int64_t>> cnt(n_threads,
                                        std::vector<int64_t>(n_genes, 0));
#pragma omp parallel
  {
#ifdef _OPENMP
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    double* a = acc[tid].data();
    int64_t* n = cnt[tid].data();
#pragma omp for schedule(static)
    for (int64_t c = 0; c < n_cells; ++c) {
      for (int64_t k = indptr[c]; k < indptr[c + 1]; ++k) {
        a[indices[k]] += data[k];
        n[indices[k]] += 1;
      }
    }
  }
  for (int t = 0; t < n_threads; ++t) {
    for (int64_t g = 0; g < n_genes; ++g) {
      col_sum[g] += acc[t][g];
      col_nnz[g] += cnt[t][g];
    }
  }
}

// Pairwise product sums from CSC columns: for each pair (a, b),
//   prod[p] = sum_cells x_a * x_b / sf^2
// via sorted-index intersection of the two columns (cell indices within a
// CSC column are sorted).  Replaces the scipy X[:, idx1].multiply(...)
// formulation, whose fancy-indexed column gathers allocate matrices with
// up to nnz * pairs/genes entries at production pair counts.
void pair_prods_csc(int64_t n_pairs, const int64_t* indptr,
                    const int32_t* indices, const float* data,
                    const double* inv_sf_sq, const int64_t* idx1,
                    const int64_t* idx2, double* prod) {
#pragma omp parallel for schedule(dynamic, 16)
  for (int64_t p = 0; p < n_pairs; ++p) {
    const int64_t a = idx1[p], b = idx2[p];
    int64_t ka = indptr[a], ea = indptr[a + 1];
    int64_t kb = indptr[b], eb = indptr[b + 1];
    double acc = 0.0;
    if (a == b) {
      for (; ka < ea; ++ka) {
        const double x = data[ka];
        acc += x * x * inv_sf_sq[indices[ka]];
      }
    } else {
      while (ka < ea && kb < eb) {
        const int32_t ra = indices[ka], rb = indices[kb];
        if (ra < rb) {
          ++ka;
        } else if (rb < ra) {
          ++kb;
        } else {
          acc += static_cast<double>(data[ka]) * data[kb] * inv_sf_sq[ra];
          ++ka;
          ++kb;
        }
      }
    }
    prod[p] = acc;
  }
}

}  // extern "C"
