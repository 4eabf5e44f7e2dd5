// Native unique-value compression of one group's count matrix.
//
// Packs each gene's (expression value, size-factor bin) combinations into
// padded tiles for the device bootstrap: the host-side hot op of the 1D
// test.  Copied from the JAX package's native/compress.cpp; the semantics
// are those of the numpy packer in memento_tpu_torch/ops/compress.py, the
// oracle of its tests.  The reference memento compresses each gene with a
// random-hash np.unique (its bootstrap.py:40-71).
//
// Layout contract (mirrors CompressedGroup):
//   slots [0, n_z)           : zero-expression combos, one per populated bin
//   slots [n_z, n_z + n_nz)  : nonzero (value, bin) combos in the order their
//                              first cell was met (the `touched` list), so a
//                              gene's combos equal the numpy packer's as a
//                              set, not slot for slot
//   slots beyond             : padding (counts 0, inv_sf 1)
//
// Parallelized over genes with OpenMP; each gene's work is one counting
// pass over its nonzeros: codes (value*nbins + bin) are small dense
// integers, so a lazily-reset histogram beats sorting — O(nnz_g + U_g).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Per-thread lazily-grown histogram over code space; `touched` records the
// codes hit for O(U) reset and for iteration in first-seen order.
struct CodeHist {
  std::vector<int64_t> hist;
  std::vector<int64_t> touched;

  void ensure(size_t n) {
    if (hist.size() < n) hist.resize(n, 0);
  }
  inline void add(int64_t code) {
    if (hist[code]++ == 0) touched.push_back(code);
  }
  void reset() {
    for (int64_t c : touched) hist[c] = 0;
    touched.clear();
  }
};

}  // namespace

extern "C" {

// First pass: number of unique combos per gene (zeros-bins + nonzero codes).
void count_unique(int64_t n_cells, int64_t n_genes, int32_t nbins,
                  const int64_t* indptr, const int64_t* indices,
                  const int64_t* data, const int32_t* bins,
                  int32_t* n_unique) {
  // global bin occupancy
  std::vector<int64_t> bin_total(nbins, 0);
  for (int64_t c = 0; c < n_cells; ++c) bin_total[bins[c]]++;

#pragma omp parallel
  {
    CodeHist h;
    std::vector<int64_t> nz_bin(nbins);
#pragma omp for schedule(dynamic, 64)
    for (int64_t g = 0; g < n_genes; ++g) {
      const int64_t lo = indptr[g], hi = indptr[g + 1];
      std::fill(nz_bin.begin(), nz_bin.end(), 0);
      int64_t vmax = 0;
      for (int64_t k = lo; k < hi; ++k)
        if (data[k] > vmax) vmax = data[k];
      h.ensure(static_cast<size_t>((vmax + 1)) * nbins);
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t b = bins[indices[k]];
        nz_bin[b]++;
        h.add(data[k] * nbins + b);
      }
      int64_t zbins = 0;
      for (int32_t b = 0; b < nbins; ++b)
        if (bin_total[b] - nz_bin[b] > 0) zbins++;
      n_unique[g] = static_cast<int32_t>(h.touched.size() + zbins);
      h.reset();
    }
  }
}

// Second pass: pack values/counts/inv_sf into padded [n_genes, u_max] tiles.
// sf_bin (optional, may be null): uint8 compact-transport ids, 0 = padding,
// 1+b = size-factor bin b (bin_inv_sf[id] reconstructs inv_sf on device).
void pack_unique_bins(int64_t n_cells, int64_t n_genes, int32_t nbins,
                      int64_t u_max, const int64_t* indptr,
                      const int64_t* indices, const int64_t* data,
                      const int32_t* bins, const double* bin_values,
                      float* values, float* counts, float* inv_sf,
                      uint8_t* sf_bin) {
  std::vector<int64_t> bin_total(nbins, 0);
  for (int64_t c = 0; c < n_cells; ++c) bin_total[bins[c]]++;

#pragma omp parallel
  {
    CodeHist h;
    std::vector<int64_t> nz_bin(nbins);
#pragma omp for schedule(dynamic, 64)
    for (int64_t g = 0; g < n_genes; ++g) {
      const int64_t lo = indptr[g], hi = indptr[g + 1];
      std::fill(nz_bin.begin(), nz_bin.end(), 0);
      int64_t vmax = 0;
      for (int64_t k = lo; k < hi; ++k)
        if (data[k] > vmax) vmax = data[k];
      h.ensure(static_cast<size_t>((vmax + 1)) * nbins);
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t b = bins[indices[k]];
        nz_bin[b]++;
        h.add(data[k] * nbins + b);
      }

      float* vrow = values + g * u_max;
      float* crow = counts + g * u_max;
      float* srow = inv_sf + g * u_max;
      uint8_t* brow = sf_bin ? sf_bin + g * u_max : nullptr;
      int64_t slot = 0;
      // zero-expression combos
      for (int32_t b = 0; b < nbins; ++b) {
        const int64_t z = bin_total[b] - nz_bin[b];
        if (z > 0) {
          vrow[slot] = 0.0f;
          crow[slot] = static_cast<float>(z);
          srow[slot] = static_cast<float>(1.0 / bin_values[b]);
          if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
          slot++;
        }
      }
      // nonzero combos in first-seen order
      for (int64_t code : h.touched) {
        const int32_t b = static_cast<int32_t>(code % nbins);
        vrow[slot] = static_cast<float>(code / nbins);
        crow[slot] = static_cast<float>(h.hist[code]);
        srow[slot] = static_cast<float>(1.0 / bin_values[b]);
        if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
        slot++;
      }
      h.reset();
      // padding slots already initialized by the caller (counts 0, inv_sf 1)
    }
  }
}

// Back-compat entry point without the sf_bin output.
void pack_unique(int64_t n_cells, int64_t n_genes, int32_t nbins,
                 int64_t u_max, const int64_t* indptr, const int64_t* indices,
                 const int64_t* data, const int32_t* bins,
                 const double* bin_values, float* values, float* counts,
                 float* inv_sf) {
  pack_unique_bins(n_cells, n_genes, nbins, u_max, indptr, indices, data,
                   bins, bin_values, values, counts, inv_sf, nullptr);
}

// Single pass: count AND pack in one histogram sweep per gene, writing
// compact runs at caller-provided worst-case offsets (nbins + nnz(g) slots
// per gene); the caller scatters them into padded tiles.  Replaces the
// count_unique + pack_unique_bins two-call flow, which walked every gene's
// nonzeros twice.
void compress_group_compact(int64_t n_cells, int64_t n_genes, int32_t nbins,
                            const int64_t* indptr, const int64_t* indices,
                            const int64_t* data, const int32_t* bins,
                            const double* bin_values, const int64_t* cap_off,
                            float* values, float* counts, float* inv_sf,
                            uint8_t* sf_bin, int32_t* n_unique) {
  std::vector<int64_t> bin_total(nbins, 0);
  for (int64_t c = 0; c < n_cells; ++c) bin_total[bins[c]]++;

  std::vector<float> inv_bin(nbins);
  for (int32_t b = 0; b < nbins; ++b)
    inv_bin[b] = static_cast<float>(1.0 / bin_values[b]);

#pragma omp parallel
  {
    CodeHist h;
    std::vector<int64_t> nz_bin(nbins);
#pragma omp for schedule(dynamic, 64)
    for (int64_t g = 0; g < n_genes; ++g) {
      const int64_t lo = indptr[g], hi = indptr[g + 1];
      std::fill(nz_bin.begin(), nz_bin.end(), 0);
      int64_t vmax = 0;
      for (int64_t k = lo; k < hi; ++k)
        if (data[k] > vmax) vmax = data[k];
      h.ensure(static_cast<size_t>((vmax + 1)) * nbins);
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t b = bins[indices[k]];
        nz_bin[b]++;
        h.add(data[k] * nbins + b);
      }

      float* vrow = values + cap_off[g];
      float* crow = counts + cap_off[g];
      float* srow = inv_sf + cap_off[g];
      uint8_t* brow = sf_bin ? sf_bin + cap_off[g] : nullptr;
      int64_t slot = 0;
      for (int32_t b = 0; b < nbins; ++b) {
        const int64_t z = bin_total[b] - nz_bin[b];
        if (z > 0) {
          vrow[slot] = 0.0f;
          crow[slot] = static_cast<float>(z);
          srow[slot] = inv_bin[b];
          if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
          slot++;
        }
      }
      for (int64_t code : h.touched) {
        const int32_t b = static_cast<int32_t>(code % nbins);
        vrow[slot] = static_cast<float>(code / nbins);
        crow[slot] = static_cast<float>(h.hist[code]);
        srow[slot] = inv_bin[b];
        if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
        slot++;
      }
      h.reset();
      n_unique[g] = static_cast<int32_t>(slot);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Column-range packer over scipy's NATIVE buffers.
//
// Reads the int32/int64 index buffer and float32/float64 data buffer exactly
// as scipy stores them and packs an arbitrary column range
// [col_start, col_stop), so packing one tile of genes makes no host-side copy
// or dtype conversion of the group's matrix (slicing the CSC matrix and
// converting indices/data to int64 per tile would cost more than the packing
// itself at atlas scale).
//
// The caller checked the whole matrix once (integral, non-negative, largest
// value vmax_cap) and caches that verdict; the data may have been edited in
// place since.  So every nonzero is checked again as it is read: a value
// that is not integral, is negative or exceeds vmax_cap makes the call
// return 1 (its gene is left empty) and the caller re-checks the matrix.
// ---------------------------------------------------------------------------

namespace {

// A count the caller's cached verdict covers: integral, in [0, vmax_cap]
// (false for NaN and infinities).
template <typename DataT>
inline bool valid_count(DataT x, int64_t vmax_cap) {
  const double d = static_cast<double>(x);
  return d >= 0.0 && d <= static_cast<double>(vmax_cap) && d == std::floor(d);
}

template <typename IdxT, typename DataT>
int32_t compact_range_impl(int64_t col_start, int64_t col_stop, int32_t nbins,
                           const int64_t* indptr, const IdxT* indices,
                           const DataT* data, const int32_t* bins,
                           const int64_t* bin_total, const float* inv_bin,
                           int64_t vmax_cap, const int64_t* cap_off,
                           float* values, float* counts, float* inv_sf,
                           uint8_t* sf_bin, int32_t* n_unique) {
  int32_t refused = 0;
#pragma omp parallel
  {
    CodeHist h;
    std::vector<int64_t> nz_bin(nbins);
#pragma omp for schedule(dynamic, 64)
    for (int64_t g = col_start; g < col_stop; ++g) {
      const int64_t gi = g - col_start;
      const int64_t lo = indptr[g], hi = indptr[g + 1];
      std::fill(nz_bin.begin(), nz_bin.end(), 0);
      int64_t vmax = 0;
      bool ok = true;
      for (int64_t k = lo; k < hi; ++k) {
        if (!valid_count(data[k], vmax_cap)) {
          ok = false;
          break;
        }
        const int64_t v = static_cast<int64_t>(data[k] + DataT(0.5));
        if (v > vmax) vmax = v;
      }
      if (!ok) {
#pragma omp atomic write
        refused = 1;
        n_unique[gi] = 0;
        continue;
      }
      h.ensure(static_cast<size_t>((vmax + 1)) * nbins);
      for (int64_t k = lo; k < hi; ++k) {
        const int32_t b = bins[indices[k]];
        nz_bin[b]++;
        const int64_t v = static_cast<int64_t>(data[k] + DataT(0.5));
        h.add(v * nbins + b);
      }

      float* vrow = values + cap_off[gi];
      float* crow = counts + cap_off[gi];
      float* srow = inv_sf + cap_off[gi];
      uint8_t* brow = sf_bin ? sf_bin + cap_off[gi] : nullptr;
      int64_t slot = 0;
      for (int32_t b = 0; b < nbins; ++b) {
        const int64_t z = bin_total[b] - nz_bin[b];
        if (z > 0) {
          vrow[slot] = 0.0f;
          crow[slot] = static_cast<float>(z);
          srow[slot] = inv_bin[b];
          if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
          slot++;
        }
      }
      for (int64_t code : h.touched) {
        const int32_t b = static_cast<int32_t>(code % nbins);
        vrow[slot] = static_cast<float>(code / nbins);
        crow[slot] = static_cast<float>(h.hist[code]);
        srow[slot] = inv_bin[b];
        if (brow) brow[slot] = static_cast<uint8_t>(b + 1);
        slot++;
      }
      h.reset();
      n_unique[gi] = static_cast<int32_t>(slot);
    }
  }
  return refused;
}

}  // namespace

extern "C" {

// idx64: 1 = indices are int64, 0 = int32.  data_f32: 1 = data is float32,
// 0 = float64.  bin_total ([nbins] int64) is the caller-precomputed global
// bin occupancy so repeated tile calls skip the O(n_cells) count.  Returns 0,
// or 1 when a nonzero is not an integral count in [0, vmax_cap].
int32_t compress_group_compact_range(
    int64_t col_start, int64_t col_stop, int32_t nbins, const int64_t* indptr,
    const void* indices, int32_t idx64, const void* data, int32_t data_f32,
    const int32_t* bins, const int64_t* bin_total, const double* bin_values,
    int64_t vmax_cap, const int64_t* cap_off, float* values, float* counts,
    float* inv_sf, uint8_t* sf_bin, int32_t* n_unique) {
  std::vector<float> inv_bin(nbins);
  for (int32_t b = 0; b < nbins; ++b)
    inv_bin[b] = static_cast<float>(1.0 / bin_values[b]);

#define MEMENTO_RANGE(IdxT, DataT)                                          \
  compact_range_impl(col_start, col_stop, nbins, indptr,                    \
                     static_cast<const IdxT*>(indices),                     \
                     static_cast<const DataT*>(data), bins, bin_total,      \
                     inv_bin.data(), vmax_cap, cap_off, values, counts,     \
                     inv_sf, sf_bin, n_unique)
  if (idx64)
    return data_f32 ? MEMENTO_RANGE(int64_t, float)
                    : MEMENTO_RANGE(int64_t, double);
  return data_f32 ? MEMENTO_RANGE(int32_t, float)
                  : MEMENTO_RANGE(int32_t, double);
#undef MEMENTO_RANGE
}

}  // extern "C"
