// Native joint unique-value compression for gene pairs (the 2D bootstrap).
//
// The differential-correlation test compresses each pair's joint
// (x1, x2, size-factor bin) combinations over the union of the two genes'
// nonzero cells (the reference memento applies _unique_expr to two-column
// slices, its bootstrap.py:119-157).  Copied from the JAX package's
// native/pairs.cpp; the numpy packer in memento_tpu_torch/ops/compress.py
// (the oracle of its tests) concatenates and lexsorts every pair's nonzeros
// at once — O(total_nnz log) with several full-size temporaries.
//
// Here each pair is ONE merge of its two sorted CSC columns feeding a
// lazily-reset dense histogram over the (x1, x2, bin) code space — the same
// counting trick as the 1D kernel in compress.cpp — so the per-pair cost is
// O(union + U log U) with U = #unique combos (typically a few hundred),
// instead of a sort of the whole ~|union| code list.  A single
// pass emits compact per-pair runs at caller-provided offsets; the caller
// scatters them into padded tiles (a ~U-sized gather, negligible).
//
// The kernel is templated over scipy's NATIVE index/data dtypes (int32/int64
// indices; float32/float64/int32/int64 data) and reads the buffers as
// stored: no per-matrix conversion to int64 indices and rounded int64 data
// (seconds and gigabytes at 20k-gene atlas scale).  A float value is rounded
// as it is read, half to even as numpy's round does, so data that is not
// integral needs no rounded copy either.
//
// The caller's verdict on the matrix (rounded values non-negative, largest
// rounded value vmax_cap) may be cached from before an in-place edit of the
// data, so the pass that sizes each column's code space checks every nonzero
// it reads; a value outside that verdict makes the call return 1 before
// anything is packed.
//
// Layout contract (mirrors CompressedPairGroup):
//   slots [0, n_z)           : zero-zero combos, one per populated sf bin
//   slots [n_z, n_z + n_nz)  : nonzero (x1, x2, bin) combos, code-sorted
//                              (code = (x1 * v2cap + x2) * nbins + bin, i.e.
//                              lexicographic by (x1, x2, bin))

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Beyond this many histogram slots per pair, fall back to sorting the merged
// code list (values large enough to blow up the dense table are rare in UMI
// count data; the fallback keeps the kernel exact for arbitrary inputs).
constexpr int64_t kTableCap = int64_t(1) << 23;  // 8M slots = 64 MB int64

// Per-thread lazily-grown histogram over code space; `touched` records the
// codes hit for O(U) reset (same structure as compress.cpp's CodeHist).
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

// A nonzero as a count: float data rounded half to even (nearbyint under
// the default rounding mode, as numpy's round), integer data as is.
template <typename DataT>
inline int64_t as_count(DataT x) {
  if constexpr (std::is_integral_v<DataT>) {
    return static_cast<int64_t>(x);
  } else {
    return static_cast<int64_t>(std::nearbyint(x));
  }
}

// A nonzero the caller's verdict covers: its count lies in [0, vmax_cap]
// (false for NaN and infinities).
template <typename DataT>
inline bool valid_count(DataT x, int64_t vmax_cap) {
  if constexpr (std::is_integral_v<DataT>) {
    return x >= 0 && static_cast<int64_t>(x) <= vmax_cap;
  } else {
    const double d = std::nearbyint(static_cast<double>(x));
    return d >= 0.0 && d <= static_cast<double>(vmax_cap);
  }
}

// Merge the two sorted CSC columns of pair (a, b), calling visit(v1, v2, row)
// for every union row.
template <typename IdxT, typename DataT, typename Visit>
void merge_columns(const int64_t* indptr, const IdxT* indices,
                   const DataT* data, int64_t a, int64_t b, Visit&& visit) {
  int64_t ka = indptr[a], ea = indptr[a + 1];
  int64_t kb = indptr[b], eb = indptr[b + 1];
  if (a == b) {
    for (; ka < ea; ++ka) {
      const int32_t v = static_cast<int32_t>(as_count(data[ka]));
      visit(v, v, static_cast<int64_t>(indices[ka]));
    }
    return;
  }
  while (ka < ea || kb < eb) {
    int64_t ra = ka < ea ? static_cast<int64_t>(indices[ka]) : INT64_MAX;
    int64_t rb = kb < eb ? static_cast<int64_t>(indices[kb]) : INT64_MAX;
    int32_t v1 = 0, v2 = 0;
    int64_t row;
    if (ra < rb) {
      v1 = static_cast<int32_t>(as_count(data[ka]));
      row = ra;
      ++ka;
    } else if (rb < ra) {
      v2 = static_cast<int32_t>(as_count(data[kb]));
      row = rb;
      ++kb;
    } else {
      v1 = static_cast<int32_t>(as_count(data[ka]));
      v2 = static_cast<int32_t>(as_count(data[kb]));
      row = ra;
      ++ka;
      ++kb;
    }
    visit(v1, v2, row);
  }
}

template <typename IdxT, typename DataT>
int32_t compress_pairs_impl(int64_t n_cells, int64_t n_genes, int64_t n_pairs,
                            int32_t nbins, const int64_t* indptr,
                            const IdxT* indices, const DataT* data,
                            const int32_t* bins, const double* bin_values,
                            int64_t vmax_cap, const int64_t* idx1,
                            const int64_t* idx2, const int64_t* cap_off,
                            float* values_1, float* values_2, float* counts,
                            float* inv_sf, uint8_t* sf_bin,
                            int32_t* n_unique) {
  std::vector<int64_t> bin_total(nbins, 0);
  for (int64_t c = 0; c < n_cells; ++c) bin_total[bins[c]]++;

  // max value per gene column actually used by some pair (-1 = unused):
  // fixes each pair's code stride before its merge starts.
  std::vector<int64_t> col_vmax(n_genes, -1);
  for (int64_t p = 0; p < n_pairs; ++p) {
    col_vmax[idx1[p]] = 0;
    col_vmax[idx2[p]] = 0;
  }
  int32_t refused = 0;
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t g = 0; g < n_genes; ++g) {
    if (col_vmax[g] < 0) continue;
    int64_t vmax = 0;
    for (int64_t k = indptr[g]; k < indptr[g + 1]; ++k) {
      if (!valid_count(data[k], vmax_cap)) {
#pragma omp atomic write
        refused = 1;
        break;
      }
      const int64_t v = as_count(data[k]);
      if (v > vmax) vmax = v;
    }
    col_vmax[g] = vmax;
  }
  if (refused) return 1;

  // per-thread inverse bin values (tiny, avoids a divide per slot)
  std::vector<float> inv_bin(nbins);
  for (int32_t b = 0; b < nbins; ++b)
    inv_bin[b] = static_cast<float>(1.0 / bin_values[b]);

#pragma omp parallel
  {
    CodeHist h;
    std::vector<int64_t> nz_bin(nbins);
    std::vector<int64_t> sort_codes;  // fallback scratch
#pragma omp for schedule(dynamic, 16)
    for (int64_t p = 0; p < n_pairs; ++p) {
      const int64_t a = idx1[p], b = idx2[p];
      const int64_t v2cap = col_vmax[b] + 1;
      const int64_t table = (col_vmax[a] + 1) * v2cap * nbins;
      std::fill(nz_bin.begin(), nz_bin.end(), 0);

      const bool use_hist = table <= kTableCap;
      if (use_hist) {
        h.ensure(static_cast<size_t>(table));
        merge_columns(indptr, indices, data, a, b,
                      [&](int32_t v1, int32_t v2, int64_t row) {
                        const int32_t bin = bins[row];
                        nz_bin[bin]++;
                        h.add((static_cast<int64_t>(v1) * v2cap + v2) * nbins +
                              bin);
                      });
        std::sort(h.touched.begin(), h.touched.end());
      } else {
        sort_codes.clear();
        merge_columns(indptr, indices, data, a, b,
                      [&](int32_t v1, int32_t v2, int64_t row) {
                        const int32_t bin = bins[row];
                        nz_bin[bin]++;
                        sort_codes.push_back(
                            (static_cast<int64_t>(v1) * v2cap + v2) * nbins +
                            bin);
                      });
        std::sort(sort_codes.begin(), sort_codes.end());
      }

      float* v1row = values_1 + cap_off[p];
      float* v2row = values_2 + cap_off[p];
      float* crow = counts + cap_off[p];
      float* srow = inv_sf + cap_off[p];
      uint8_t* brow = sf_bin ? sf_bin + cap_off[p] : nullptr;
      int64_t slot = 0;
      for (int32_t bb = 0; bb < nbins; ++bb) {
        const int64_t z = bin_total[bb] - nz_bin[bb];
        if (z > 0) {
          v1row[slot] = 0.0f;
          v2row[slot] = 0.0f;
          crow[slot] = static_cast<float>(z);
          srow[slot] = inv_bin[bb];
          if (brow) brow[slot] = static_cast<uint8_t>(bb + 1);
          slot++;
        }
      }
      auto emit = [&](int64_t code, int64_t count) {
        const int32_t bb = static_cast<int32_t>(code % nbins);
        const int64_t xy = code / nbins;
        v1row[slot] = static_cast<float>(xy / v2cap);
        v2row[slot] = static_cast<float>(xy % v2cap);
        crow[slot] = static_cast<float>(count);
        srow[slot] = inv_bin[bb];
        if (brow) brow[slot] = static_cast<uint8_t>(bb + 1);
        slot++;
      };
      if (use_hist) {
        for (int64_t code : h.touched) emit(code, h.hist[code]);
        h.reset();
      } else {
        for (size_t i = 0; i < sort_codes.size();) {
          size_t j = i;
          while (j < sort_codes.size() && sort_codes[j] == sort_codes[i]) ++j;
          emit(sort_codes[i], static_cast<int64_t>(j - i));
          i = j;
        }
      }
      n_unique[p] = static_cast<int32_t>(slot);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// Packs every pair over scipy's buffers as stored.  idx64: 1 = int64
// indices, 0 = int32.  data_kind: 0 = float64, 1 = float32, 2 = int64,
// 3 = int32 data.  Returns 0, or 1 when a nonzero's count is not in
// [0, vmax_cap].
int32_t compress_pairs_compact_v2(
    int64_t n_cells, int64_t n_genes, int64_t n_pairs, int32_t nbins,
    const int64_t* indptr, const void* indices, int32_t idx64,
    const void* data, int32_t data_kind, const int32_t* bins,
    const double* bin_values, int64_t vmax_cap, const int64_t* idx1,
    const int64_t* idx2, const int64_t* cap_off, float* values_1,
    float* values_2, float* counts, float* inv_sf, uint8_t* sf_bin,
    int32_t* n_unique) {
#define MEMENTO_PAIRS(IdxT, DataT)                                          \
  compress_pairs_impl(n_cells, n_genes, n_pairs, nbins, indptr,             \
                      static_cast<const IdxT*>(indices),                    \
                      static_cast<const DataT*>(data), bins, bin_values,    \
                      vmax_cap, idx1, idx2, cap_off, values_1, values_2,    \
                      counts, inv_sf, sf_bin, n_unique)
#define MEMENTO_PAIRS_DATA(IdxT)                                            \
  switch (data_kind) {                                                      \
    case 0: return MEMENTO_PAIRS(IdxT, double);                             \
    case 1: return MEMENTO_PAIRS(IdxT, float);                              \
    case 2: return MEMENTO_PAIRS(IdxT, int64_t);                            \
    default: return MEMENTO_PAIRS(IdxT, int32_t);                           \
  }
  if (idx64) MEMENTO_PAIRS_DATA(int64_t)
  MEMENTO_PAIRS_DATA(int32_t)
#undef MEMENTO_PAIRS_DATA
#undef MEMENTO_PAIRS
}

}  // extern "C"
