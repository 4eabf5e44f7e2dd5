// GEV tail refinement for Hopper (sm_90a), in float64.
//
// Replaces no TPU kernel: the JAX package refits its GEV tails in numpy on
// the host (memento_tpu/inference/gev.py::gev_refine_batch), and the port
// did the same on a worker thread while the card sat idle.  That numpy path
// (memento_tpu_torch/inference/gev.py::gev_refine_batch) stays the path of
// rows on the CPU and this kernel's reference.  This kernel refines all the
// flagged rows of one tile in one launch, both sides and every stage of the
// tail schedule, with no host round trip.
//
//   For every row (one flagged test: the sorted tails of its float64 null,
//   and |stat|), run the tail schedule on the left tail: for each stage,
//   with L = min(n_exec, B) values, a probability-weighted-moment start, a
//   Nelder-Mead fit of the GEV negative log-likelihood (scipy's constants,
//   initial simplex, convergence test and iteration cap; a row whose four
//   vertices are all infinite stops), and the KS gate on the fit; the first
//   stage that passes gives (n_exec / B) * CDF(-|stat|).  Where the left
//   side resolved, the same on the right tail gives (n_exec / B) *
//   SF(|stat|), and the p-value is their sum.  Otherwise the row keeps its
//   counting p-value (status kFallback).
//
// What bounds it on this card: the latency of one row's chain of float64
// work, not bytes and not the card's float64 rate.  A fit is up to 150
// Nelder-Mead steps, each waiting for one or two likelihoods over <= 300
// values (a division, a log, a division and an exp per value), and a row
// takes up to nine fits a side; a tile has hundreds to a few thousand such
// rows, far fewer than the card holds at once, so a launch lasts about as
// long as its slowest row.
//
// What the design does about it:
//  - One warp per row, kWarps rows a block.  The row's tail of one side (at
//    most 300 values) sits in shared memory; each lane sums its values, a
//    butterfly of shuffles adds the lanes.  Addition commutes, so every
//    lane ends with the same bits and takes the same decisions: the warp
//    never diverges on the fit's control flow.
//  - Nelder-Mead evaluates only the points its step needs: the reflection,
//    then the expansion, a contraction or the shrink.  The host's lockstep
//    code evaluates all four every step only to vectorize across rows; the
//    decisions and the points are the same.
//  - The KS gate compares D with two bounds per stage, computed once on the
//    host from scipy's kstwo (ops in inference/gev.py::ks_gate_table): D at
//    or below the first passes, D at or above the second fails, and a row
//    whose D falls between (a guard band around the critical value a few
//    parts in 1e8 wide) is marked kHost and left to the host, which decides
//    the whole row with kstwo.sf.  Rows with a non-finite entry are marked
//    kHost too (the host's serial path takes them).
//
// Agreement with the host: built with -fmad=false (ops/kernel_build.py), so
// every product and sum is rounded on its own as numpy rounds it, and
// divisions and square roots are IEEE-rounded.  The lanes' sums are added
// in another order than numpy's pairwise sums, and log, exp, exp2 and
// tgamma (libdevice) may differ from the host's in the last bits; the fits
// then agree to about 1e-12 relative, unless a comparison of two nearly
// equal likelihoods goes the other way.
//
// This file includes no header of its own: ops/kernel_build.py hashes the
// .cu alone (with its flags) to decide when to rebuild.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows a block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTail = 300;  // the schedule's longest tail
constexpr int kMaxStages = 16;
constexpr unsigned kFull = 0xffffffffu;

// gev.py's constants
constexpr double kGumbelEps = 1e-7;
constexpr double kEuler = 0.5772156649015329;
constexpr double kXatol = 1e-5;
constexpr double kFatol = 1e-6;

// a row's status (out[row, 1])
constexpr double kFallback = 0.0, kRefined = 1.0, kHost = 2.0;
constexpr int kOutCols = 5;  // p, status, left stage, right stage, values

struct Schedule {
  int n_stages;
  int n_exec[kMaxStages];
  int len[kMaxStages];          // min(n_exec, B)
  double accept_d[kMaxStages];  // D <= this: the KS gate passes
  double reject_d[kMaxStages];  // D >= this: it fails; between: the host
  double inv_scale[kMaxStages];  // n_exec / B
  double log2_over_log3;          // np.log(2) / np.log(3)
  double ln2;                     // np.log(2)
};

struct Point {
  double c, loc, scale;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// np.maximum(w, 1e-300): NaN stays NaN
__device__ __forceinline__ double floor_w(double w) {
  return isnan(w) ? w : fmax(w, 1e-300);
}

// np.clip(z, -700, 700): NaN stays NaN
__device__ __forceinline__ double clip700(double z) {
  return z < -700.0 ? -700.0 : (z > 700.0 ? 700.0 : z);
}

// gev.py::gev_cdf at one point
__device__ __forceinline__ double gev_cdf(double x, const Point& p) {
  const double z = (x - p.loc) / p.scale;
  const double w = 1.0 - p.c * z;
  const bool gumbel = fabs(p.c) < kGumbelEps;
  const double t = exp(log(floor_w(w)) / (gumbel ? 1.0 : p.c));
  double cdf = gumbel ? exp(-exp(-clip700(z))) : exp(-t);
  if (w <= 0.0) cdf = p.c > 0.0 ? 1.0 : 0.0;
  return cdf;
}

// gev.py::gev_nll of one row: +inf outside the support.  xs: the stage's
// sorted tail in shared memory, len values.
__device__ __forceinline__ double gev_nll(const double* xs, int len,
                                          int lane, const Point& p,
                                          double* evaluated) {
  const bool valid_scale = p.scale > 0.0;
  const double safe = valid_scale ? p.scale : 1.0;
  const bool gumbel = fabs(p.c) < kGumbelEps;
  const double cdiv = gumbel ? 1.0 : p.c;
  const double a = 1.0 / p.c - 1.0;
  double sum = 0.0;
  bool support = true;
#pragma unroll 2
  for (int j = lane; j < len; j += 32) {
    const double z = (xs[j] - p.loc) / safe;
    double term;
    if (gumbel) {
      term = exp(-clip700(z)) + z;
    } else {
      const double w = 1.0 - p.c * z;
      support = support && (w > 0.0);
      const double logw = log(floor_w(w));
      term = exp(logw / cdiv) - a * logw;
    }
    sum += term;
  }
  sum = warp_sum(sum);
  support = __all_sync(kFull, support);
  *evaluated += len;
  const double nll = sum + static_cast<double>(len) * log(safe);
  const bool ok = valid_scale && (support || gumbel) && isfinite(nll);
  return ok ? nll : __longlong_as_double(0x7ff0000000000000LL);
}

// gev.py::pwm_start of one row
__device__ Point pwm_start(const double* xs, int len, int lane,
                           const Schedule& s) {
  const double n = static_cast<double>(len);
  const double d1 = static_cast<double>(len - 1 > 1 ? len - 1 : 1);
  const long long pairs = static_cast<long long>(len - 1) * (len - 2);
  const double d2 = static_cast<double>(pairs > 1 ? pairs : 1);
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int j = lane; j < len; j += 32) {
    const double x = xs[j];
    const double jd = static_cast<double>(j);
    s0 += x;
    s1 += x * (jd / d1);
    s2 += x * ((jd * (jd - 1.0)) / d2);
  }
  const double b0 = warp_sum(s0) / n;
  const double b1 = warp_sum(s1) / n;
  const double b2 = warp_sum(s2) / n;
  const double den = 3.0 * b2 - b0;
  const double zc = (2.0 * b1 - b0) /
                        (den == 0.0 ? __longlong_as_double(0x7ff8000000000000LL)
                                    : den) -
                    s.log2_over_log3;
  double k = 7.8590 * zc + 2.9554 * zc * zc;
  const double g1k = tgamma(1.0 + k);
  double scale = (2.0 * b1 - b0) * k / (g1k * (1.0 - exp2(-k)));
  double loc = b0 + scale * (g1k - 1.0) / k;
  const double scale_g = (2.0 * b1 - b0) / s.ln2;
  const double loc_g = b0 - kEuler * scale_g;
  if (fabs(k) < 1e-4) {
    k = 0.0;
    scale = scale_g;
    loc = loc_g;
  }
  double q = 0.0;
  for (int j = lane; j < len; j += 32) {
    const double d = xs[j] - b0;
    q += d * d;
  }
  const double std = sqrt(warp_sum(q) / n);
  const bool bad =
      !(isfinite(k) && isfinite(loc) && isfinite(scale) && scale > 0.0);
  Point p;
  p.c = bad ? 0.0 : k;
  p.loc = bad ? b0 : loc;
  p.scale = bad ? fmax(std, 1e-8) : fmax(scale, 1e-12);
  return p;
}

__device__ __forceinline__ void swap_if_greater(double& fa, double& fb,
                                                Point& pa, Point& pb) {
  if (fa > fb) {  // strict: ties keep their order (a stable sort)
    const double f = fa;
    fa = fb;
    fb = f;
    const Point p = pa;
    pa = pb;
    pb = p;
  }
}

// numpy's stable argsort of the four vertices by value
__device__ __forceinline__ void sort4(double (&f)[4], Point (&v)[4]) {
  swap_if_greater(f[0], f[1], v[0], v[1]);
  swap_if_greater(f[1], f[2], v[1], v[2]);
  swap_if_greater(f[2], f[3], v[2], v[3]);
  swap_if_greater(f[0], f[1], v[0], v[1]);
  swap_if_greater(f[1], f[2], v[1], v[2]);
  swap_if_greater(f[0], f[1], v[0], v[1]);
}

__device__ __forceinline__ double& coord(Point& p, int d) {
  return d == 0 ? p.c : (d == 1 ? p.loc : p.scale);
}

__device__ __forceinline__ Point affine(const Point& a, const Point& b,
                                        double t) {
  // a + t * b, component by component (t a power of two: exact products)
  Point r;
  r.c = a.c + t * b.c;
  r.loc = a.loc + t * b.loc;
  r.scale = a.scale + t * b.scale;
  return r;
}

// gev.py::nelder_mead_batch for one row; returns the best vertex and its
// value in *fbest
__device__ Point nelder_mead(const double* xs, int len, int lane,
                             const Point& x0, int iters, double* fbest,
                             double* evaluated) {
  Point v[4] = {x0, x0, x0, x0};
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    double& pt = coord(v[d + 1], d);
    pt = pt != 0.0 ? pt * 1.05 : 0.00025;
  }
  double f[4];
#pragma unroll 1
  for (int i = 0; i < 4; ++i) f[i] = gev_nll(xs, len, lane, v[i], evaluated);

  bool done = false;
#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    sort4(f, v);
    bool xconv = true, fconv = true, any_finite = isfinite(f[0]);
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      xconv = xconv && fabs(v[i].c - v[0].c) <= kXatol &&
              fabs(v[i].loc - v[0].loc) <= kXatol &&
              fabs(v[i].scale - v[0].scale) <= kXatol;
      fconv = fconv && fabs(f[i] - f[0]) <= kFatol;
      any_finite = any_finite || isfinite(f[i]);
    }
    if ((xconv && fconv) || !any_finite) {
      done = true;
      break;
    }
    Point cen;
    cen.c = ((v[0].c + v[1].c) + v[2].c) / 3.0;
    cen.loc = ((v[0].loc + v[1].loc) + v[2].loc) / 3.0;
    cen.scale = ((v[0].scale + v[1].scale) + v[2].scale) / 3.0;
    Point diff;
    diff.c = cen.c - v[3].c;
    diff.loc = cen.loc - v[3].loc;
    diff.scale = cen.scale - v[3].scale;

    const Point xr = affine(cen, diff, 1.0);
    const double fr = gev_nll(xs, len, lane, xr, evaluated);
    bool shrink = false;
    if (fr < f[0]) {
      const Point xe = affine(cen, diff, 2.0);
      const double fe = gev_nll(xs, len, lane, xe, evaluated);
      if (fe < fr) {
        v[3] = xe;
        f[3] = fe;
      } else {
        v[3] = xr;
        f[3] = fr;
      }
    } else if (fr < f[2]) {
      v[3] = xr;
      f[3] = fr;
    } else if (fr < f[3]) {
      const Point xco = affine(cen, diff, 0.5);
      const double fco = gev_nll(xs, len, lane, xco, evaluated);
      if (fco <= fr) {
        v[3] = xco;
        f[3] = fco;
      } else {
        shrink = true;
      }
    } else {
      const Point xci = affine(cen, diff, -0.5);
      const double fci = gev_nll(xs, len, lane, xci, evaluated);
      if (fci < f[3]) {
        v[3] = xci;
        f[3] = fci;
      } else {
        shrink = true;
      }
    }
    if (shrink) {
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        Point step;
        step.c = v[i].c - v[0].c;
        step.loc = v[i].loc - v[0].loc;
        step.scale = v[i].scale - v[0].scale;
        v[i] = affine(v[0], step, 0.5);
      }
#pragma unroll 1
      for (int i = 1; i < 4; ++i)
        f[i] = gev_nll(xs, len, lane, v[i], evaluated);
    }
  }
  if (!done) sort4(f, v);
  *fbest = f[0];
  return v[0];
}

// gev.py::ks_pvalue_batch's D of one row's fit; NaN if any CDF is NaN
__device__ double ks_d(const double* xs, int len, int lane, const Point& p) {
  const double n = static_cast<double>(len);
  double dmax = 0.0;
  bool nan = false;
  for (int j = lane; j < len; j += 32) {
    const double cdf = gev_cdf(xs[j], p);
    const double jd = static_cast<double>(j);
    const double d_plus = (jd + 1.0) / n - cdf;
    const double d_minus = cdf - jd / n;
    nan = nan || isnan(cdf);
    dmax = fmax(dmax, fmax(d_plus, d_minus));
  }
  dmax = warp_max(dmax);
  if (__any_sync(kFull, nan)) return __longlong_as_double(0x7ff8000000000000LL);
  return dmax;
}

// gev.py::_one_side for one row: the accepted stage (1-based, 0 if none),
// -1 if a KS decision fell in the guard band; *value the scaled tail
// probability of the accepted stage.
__device__ int one_side(const double* tail, int tail_len, bool right,
                        double point, int lane, const Schedule& s,
                        int nm_iters, double* value, double* evaluated) {
  for (int st = 0; st < s.n_stages; ++st) {
    const int len = s.len[st];
    const double* xs = right ? tail + (tail_len - len) : tail;
    const Point x0 = pwm_start(xs, len, lane, s);
    double fbest;
    const Point p = nelder_mead(xs, len, lane, x0, nm_iters, &fbest,
                                evaluated);
    if (!isfinite(fbest)) continue;
    const double d = ks_d(xs, len, lane, p);
    if (isnan(d) || d >= s.reject_d[st]) continue;
    if (d > s.accept_d[st]) return -1;
    const double cdf = gev_cdf(point, p);
    *value = s.inv_scale[st] * (right ? 1.0 - cdf : cdf);
    return st + 1;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
    gev_refine_kernel(const double* __restrict__ tails,
                      const double* __restrict__ abs_stat,
                      const uint8_t* __restrict__ finite,
                      double* __restrict__ out, int n_rows, int tail_len,
                      int nm_iters, Schedule s) {
  __shared__ double tail_smem[kWarps][kMaxTail];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;
  double* o = out + static_cast<size_t>(row) * kOutCols;
  double* tail = tail_smem[warp];

  double status = kFallback, p = __longlong_as_double(0x7ff8000000000000LL);
  int stage[2] = {0, 0};
  double evaluated = 0.0;
  if (!finite[row]) {
    status = kHost;
  } else {
    double value[2] = {0.0, 0.0};
    for (int side = 0; side < 2; ++side) {
      const double* src =
          tails + (static_cast<size_t>(row) * 2 + side) * tail_len;
      __syncwarp();
      for (int j = lane; j < tail_len; j += 32) tail[j] = src[j];
      __syncwarp();
      const double point = side == 0 ? -abs_stat[row] : abs_stat[row];
      const int got = one_side(tail, tail_len, side == 1, point, lane, s,
                               nm_iters, &value[side], &evaluated);
      if (got < 0) {
        status = kHost;
        stage[0] = stage[1] = 0;
        break;
      }
      stage[side] = got;
      if (got == 0) break;  // the right side only after the left resolved
    }
    if (status != kHost && stage[0] > 0 && stage[1] > 0) {
      status = kRefined;
      p = value[0] + value[1];
    }
  }
  if (lane == 0) {
    o[0] = p;
    o[1] = status;
    o[2] = stage[0];
    o[3] = stage[1];
    o[4] = evaluated;
  }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  tails [n_rows, 2, tail_len]
// float64: each row's tail_len smallest null values ascending, then its
// tail_len largest ascending; abs_stat [n_rows] float64; finite [n_rows]
// uint8 (0: a non-finite entry, the host takes the row); out [n_rows, 5]
// float64: p-value (NaN unless refined), status (0 fallback, 1 refined, 2
// host), the accepted stage of each side (1-based, 0 if none) and the
// values the likelihoods went over.  schedule [5 * n_stages + 2] float64
// on the host: n_exec, len, accept_d, reject_d and n_exec / B per stage,
// then np.log(2) / np.log(3) and np.log(2).  Returns a cudaError_t.
extern "C" int gev_refine_launch(const void* tails, const void* abs_stat,
                                 const void* finite, void* out, int n_rows,
                                 int tail_len, int nm_iters,
                                 const double* schedule, int n_stages,
                                 void* stream) {
  if (n_stages < 1 || n_stages > kMaxStages || tail_len < 1 ||
      tail_len > kMaxTail || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  Schedule s;
  s.n_stages = n_stages;
  for (int i = 0; i < n_stages; ++i) {
    s.n_exec[i] = static_cast<int>(schedule[i]);
    s.len[i] = static_cast<int>(schedule[n_stages + i]);
    s.accept_d[i] = schedule[2 * n_stages + i];
    s.reject_d[i] = schedule[3 * n_stages + i];
    s.inv_scale[i] = schedule[4 * n_stages + i];
    if (s.len[i] < 1 || s.len[i] > tail_len)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  s.log2_over_log3 = schedule[5 * n_stages];
  s.ln2 = schedule[5 * n_stages + 1];
  const unsigned blocks = static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
  gev_refine_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(tails), static_cast<const double*>(abs_stat),
      static_cast<const uint8_t*>(finite), static_cast<double*>(out), n_rows,
      tail_len, nm_iters, s);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread, shared memory per block and resident blocks per SM.
extern "C" int gev_refine_resources(int* regs, int* shared_bytes,
                                    int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, gev_refine_kernel);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  *regs = attr.numRegs;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, gev_refine_kernel, kThreads, 0));
}
