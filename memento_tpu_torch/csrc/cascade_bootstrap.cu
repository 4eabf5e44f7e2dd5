// Fused cascade bootstrap for Hopper (sm_90a).
//
// Replaces the TPU kernel memento_tpu/ops/pallas_kernels.py::
// _cascade_chunk_kernel (launched by fused_bootstrap_sums_pallas).  It
// computes the same function, the plain version of which is
// memento_tpu_torch/ops/sampling.py::fused_bootstrap_sums:
//
//   For every row t (one gene in one cell group) and replicate b, draw a
//   multinomial resample of the row's bin multiplicities counts[t, :] with
//   n_obs[t] trials, as a chain of conditional binomials over the bins, and
//   contract it on the fly:  sums[t, w, b] = sum_u weights[t, u, w] * n_tub.
//   Each conditional binomial is a rounded Gaussian with a Cornish-Fisher
//   skew term (lambda >= tau = 8) or a truncated-Poisson inverse CDF with a
//   conditional-mean shift and variance rescale (lambda < tau); the bin whose
//   ratio is >= 1-1e-6 absorbs every remaining trial, bins with ratio <= 0
//   draw 0.  The draws are never stored.
//
// What bounds it on this card: integer and special-function work per draw.
// Each (row, occupied bin, replicate) costs one Philox4x32-10 call (10
// rounds of two 32-bit mul.hi/mul.lo pairs plus xors), then either a log, a
// sqrt and a cos (Gaussian branch) or up to 32 table steps of a multiply, a
// divide and a compare (table branch).  The bytes are small: the inputs are
// [T, U] and [T, U, W] floats read once per block and the output [T, W, B]
// is written once.
//
// What the design does about it: one thread per (row, replicate), so the
// sequential walk over the bins runs in registers (remaining trials and the
// W sums) with no shared memory and no synchronisation.  Every thread of a
// block serves the same row, so the per-bin parameters are broadcast loads
// and the Gaussian/table branch and the table trip count are uniform across
// the warp: no divergence and no predicates.  The walk stops at the row's
// last occupied bin (passed in by the wrapper); padded bins cost one load.
// The Philox counter is (replicate, bin, row), the key the caller's 64-bit
// seed, so a draw depends only on its coordinates.  The output is written
// once at the end, coalesced over replicates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kTau = 8.0f;
constexpr int kTableMax = 32;
constexpr float kTwoPi = 6.283185307179586f;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
  const uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
  const uint32_t kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t hi0 = __umulhi(kM0, ctr.x), lo0 = kM0 * ctr.x;
    const uint32_t hi1 = __umulhi(kM1, ctr.z), lo1 = kM1 * ctr.z;
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += kW0;
    key.y += kW1;
  }
  return ctr;
}

// Top 24 bits (logical shift of an unsigned word) -> uniform in (0, 1),
// clamped away from 0 for Box-Muller's log.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return fmaxf(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f), 1e-7f);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
cascade_bootstrap_kernel(const float* __restrict__ counts,
                         const float* __restrict__ ratio,
                         const float* __restrict__ ctail,
                         const float* __restrict__ weights,
                         const float* __restrict__ n_obs,
                         const int* __restrict__ u_end,
                         float* __restrict__ sums,
                         int n_rows, int n_bins, int num_boot,
                         uint32_t key_lo, uint32_t key_hi) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= num_boot) return;
  const uint2 key = make_uint2(key_lo, key_hi);

  for (int t = blockIdx.y; t < n_rows; t += gridDim.y) {
    const size_t row = static_cast<size_t>(t) * n_bins;
    const int last = u_end[t];
    float remaining = n_obs[t];
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.0f;

    for (int u = 0; u < last; ++u) {
      const float r = __ldg(ratio + row + u);
      if (r <= 0.0f) continue;  // empty bin: draws 0
      float draw;
      if (r >= 1.0f - 1e-6f) {
        draw = remaining;  // absorbing bin: every remaining trial
      } else {
        const float lam = __ldg(counts + row + u);
        const uint4 bits = philox4x32_10(
            make_uint4(static_cast<uint32_t>(b), static_cast<uint32_t>(u),
                       static_cast<uint32_t>(t), 0u),
            key);
        if (lam < kTau) {
          // truncated-Poisson inverse CDF: count the CDF entries below u3
          const float u3 = uniform24(bits.z);
          const int n_iter = min(kTableMax,
                                 static_cast<int>(ceilf(lam + 5.0f * sqrtf(lam) + 4.0f)));
          float p = expf(-lam);
          float c = p;
          float k_draw = 0.0f;
          for (int k = 0; k < n_iter; ++k) {
            k_draw += (u3 > c) ? 1.0f : 0.0f;
            p = p * lam / static_cast<float>(k + 1);
            c += p;
          }
          const float ct = __ldg(ctail + row + u);
          const float p_cond = lam / fmaxf(ct, 1.0f);
          float x = lam + (k_draw - lam) * sqrtf(fmaxf(1.0f - p_cond, 0.0f));
          x += r * (remaining - ct);
          draw = fminf(fmaxf(x, 0.0f), remaining);
        } else {
          // rounded Gaussian with the Cornish-Fisher skew term; the base
          // sigma is shrunk by the CF term's variance and the rounding's
          const float u1 = uniform24(bits.x);
          const float u2 = uniform24(bits.y);
          const float z = sqrtf(-2.0f * logf(u1)) * cosf(kTwoPi * u2);
          const float m = remaining * r;
          const float gam = 1.0f - 2.0f * r;
          const float sdev = sqrtf(fmaxf(
              m * (1.0f - r) - gam * gam * (1.0f / 18.0f) - 1.0f / 12.0f, 0.0f));
          const float g = rintf(m + sdev * z + gam * (z * z - 1.0f) * (1.0f / 6.0f));
          draw = fminf(fmaxf(g, 0.0f), remaining);
        }
      }
      const float* wu = weights + (row + u) * W;
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] += __ldg(wu + w) * draw;
      remaining -= draw;
    }

    float* out = sums + static_cast<size_t>(t) * W * num_boot + b;
#pragma unroll
    for (int w = 0; w < W; ++w) out[static_cast<size_t>(w) * num_boot] = acc[w];
  }
}

template <int W>
cudaError_t launch(const float* counts, const float* ratio, const float* ctail,
                   const float* weights, const float* n_obs, const int* u_end,
                   float* sums, int n_rows, int n_bins, int num_boot,
                   uint64_t seed, cudaStream_t stream) {
  const dim3 grid((num_boot + kThreads - 1) / kThreads,
                  n_rows < 65535 ? n_rows : 65535);
  cascade_bootstrap_kernel<W><<<grid, kThreads, 0, stream>>>(
      counts, ratio, ctail, weights, n_obs, u_end, sums, n_rows, n_bins,
      num_boot, static_cast<uint32_t>(seed), static_cast<uint32_t>(seed >> 32));
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes).  All arrays are contiguous
// float32 / int32 device buffers: counts, ratio, ctail [T, U]; weights
// [T, U, W]; n_obs [T]; u_end [T] (1 + last occupied bin); sums [T, W, B].
// Returns the cudaError_t of the launch (0 on success).
extern "C" int cascade_bootstrap_launch(const void* counts, const void* ratio,
                                        const void* ctail, const void* weights,
                                        const void* n_obs, const void* u_end,
                                        void* sums, int n_rows, int n_bins,
                                        int n_weights, int num_boot,
                                        unsigned long long seed, void* stream) {
  const auto* c = static_cast<const float*>(counts);
  const auto* r = static_cast<const float*>(ratio);
  const auto* ct = static_cast<const float*>(ctail);
  const auto* w = static_cast<const float*>(weights);
  const auto* n = static_cast<const float*>(n_obs);
  const auto* ue = static_cast<const int*>(u_end);
  auto* s = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n_weights) {
    case 1:
      return launch<1>(c, r, ct, w, n, ue, s, n_rows, n_bins, num_boot, seed, st);
    case 2:
      return launch<2>(c, r, ct, w, n, ue, s, n_rows, n_bins, num_boot, seed, st);
    case 5:
      return launch<5>(c, r, ct, w, n, ue, s, n_rows, n_bins, num_boot, seed, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
