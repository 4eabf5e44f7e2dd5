// Fused cascade bootstrap for Hopper (sm_90a).
//
// Replaces the TPU kernel memento_tpu/ops/pallas_kernels.py::
// _cascade_chunk_kernel (launched by fused_bootstrap_sums_pallas).  It
// computes the same function, the plain version of which is
// memento_tpu_torch/ops/sampling.py::fused_bootstrap_sums:
//
//   For every row t (one gene or gene pair in one cell group) and replicate
//   b, draw a multinomial resample of the row's bin multiplicities
//   counts[t, :] with n_obs[t] trials, as a chain of conditional binomials
//   over the bins, and contract it on the fly:
//   sums[t, w, b] = sum_u weights[t, u, w] * n_tub.
//   Each conditional binomial is a rounded Gaussian with a Cornish-Fisher
//   skew term (count >= tau = 8) or a truncated-Poisson inverse CDF with a
//   conditional-mean shift and variance rescale (count < tau); the bin whose
//   ratio is >= 1-1e-6 absorbs every remaining trial, bins with ratio <= 0
//   draw 0.  The draws are never stored.
//
// What bounds it on this card: instruction issue, not bytes (a tile is tens
// of MB read once, microseconds at HBM rate, against 1e9 draws per launch,
// and an SM issues at most one instruction per scheduler and cycle, four in
// all).  By pipe: the integer side carries Philox (20 IMAD.WIDE and 20 LOP3
// a call) and the table search's compares and adds; the shared-memory pipe
// the search's five loads and the record reads; the special-function unit
// (an eighth of the FP32 rate) log, sqrt, sin and cos of Box-Muller and the
// Gaussian branch's sqrt; the FP32 pipe the rest.  So the way to go faster
// is a lower instruction count per draw.
//
// What the design does about it:
//  - One thread per (row, replicate); a block is one row and a slab of 256
//    replicates, so every thread of a block is on the same bin, every branch
//    is warp-uniform and every record read is a shared-memory broadcast.
//  - Whatever depends on (row, bin) alone is computed once per block, not
//    once per thread: the block walks its row in chunks of 64 bins, and for
//    each chunk 64 threads write a record per bin to shared memory (the
//    branch, the ratio and the branch's constants, folded as far as they
//    go; the W weights) and, for a table bin, the 32-entry truncated-Poisson
//    CDF itself, with the recurrence and the float32 arithmetic of
//    sampling.poisson_cdf_table, stored as 24-bit integer thresholds.  The
//    inverse CDF is then a 5-step binary search on shared memory (free of
//    bank conflicts: a bin's table spans 32 banks), each step a load, an
//    integer compare and an add, with no exp, multiply, divide or
//    conversion per draw.  Chunk k+1 is staged while chunk k is walked: two
//    buffers, one __syncthreads per chunk.
//  - Empty and absorbing bins need no branch of their own: with r = 0 or 1
//    the table bin's last step, clamp(r * remaining + const), gives 0 or
//    every remaining trial.
//  - Every Philox word is used.  Bins go in groups of four; Philox4x32-10
//    with counter (replicate, group, row, 0) gives the group's four table
//    uniforms and, only if the group holds a Gaussian bin, counter
//    (replicate, group, row, 1) gives two Box-Muller pairs, hence four
//    normals (cosine for even bins, sine for odd).  The key is the tile's
//    64-bit seed; its ten round keys are kernel parameters, so they cost no
//    instruction.  A draw is a pure function of (row, bin, replicate, seed):
//    no state is carried between bins, so it does not depend on grid or
//    chunking.  The allocation is mirrored in ops/philox.py.  A group's raw
//    samples (normals, table counts) are generated first, since they do not
//    depend on the remaining trials (a group of four table bins runs its four
//    searches in step); then come the four short dependent steps.
//  - Rows go to the SMs longest first (the wrapper passes the order), so the
//    last wave does not wait for one long row.
//  - The contraction stays acc[w] += weight * draw in registers: it is 2W of
//    a draw's instruction count of ~50 and is fed by a sequential chain, so
//    it is no job for the tensor cores (wgmma).
//
// Fast approximations, each with its error (there is no -use_fast_math):
//  lg2.approx.ftz (times ln 2): absolute error 2^-22 of the base-2 log on
//  [0.5, 2], else relative 2^-22; the argument is >= 1e-7, never denormal,
//  and the radius is clamped at 0.  __sincosf on [-pi, pi): absolute error
//  2^-21.41.  sqrt.approx.ftz: relative error 2^-23, a denormal argument
//  gives 0.  Each moves a normal by ~1e-6 at most, far below the draws'
//  rounding to integers.
//
// Where the function differs from the plain version's: the search counts the
// table's entries 0..30 below the uniform, torch.searchsorted all 32.  Entry
// 31 is the float32 sum of the whole truncated pmf, 1 to a few ulp; where it
// falls short of 1 (about 5% of rates in [0, 8)), the at most 4 largest of
// the 2^24 uniforms lie above it and the plain version gives 32 where this
// kernel gives 31: 4e-9 of table draws on average, 2.4e-7 at the worst rate.
//
// A lower bound written with a moving pointer (if (p[1] < n) p += 2;
// if (p[0] < n) p += 1;) was compiled by nvcc 12.8 into one 64-bit load of
// p[0] and p[1] before the first update, which reads the wrong entry after a
// move; the search therefore loads through explicit shared addresses
// (load_shared), each load a volatile statement that clobbers memory, so the
// compiler neither merges, reuses nor moves one across a barrier.  The
// same-seed comparison with ops/philox.py is the backstop.

#include <cstdint>
#include <cuda_runtime.h>

// a block's records (Smem<W> below), sized at the launch
extern __shared__ __align__(16) unsigned char smem_raw[];

namespace {

constexpr float kTau = 8.0f;
constexpr int kTableLen = 32;   // CDF entries per table bin
constexpr int kCdfStride = 33;  // + 1 pad: 32 threads store 32 tables at once
                                // without bank conflicts
constexpr int kThreads = 256;
constexpr int kChunk = 64;  // bins staged at a time
constexpr int kGroup = 4;   // bins that share one Philox call
constexpr int kGroups = kChunk / kGroup;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kPi = 3.141592653589793f;

// branch of a bin, two bits each in a group's header word.  A linear bin
// draws clamp(r * remaining): 0 for an empty bin (r = 0), every remaining
// trial for the absorbing bin (r = 1); neither draws a random number.
constexpr uint32_t kLinear = 0, kTable = 2, kGauss = 3;
constexpr uint32_t kHasTable = 1u << 8, kHasGauss = 1u << 9;

struct RoundKeys {
  uint32_t k[20];  // (key.x, key.y) of Philox's ten rounds
};

// One chunk's records, twice (two buffers).  params of a bin:
//   linear   (-, -, r, -)
//   table    (sqrt(1 - lam / ctail) / 4, lam - lam sqrt(..) - r ctail, r, -)
//   Gaussian (1 - r, gam / 6, r, gam^2 / 18 + 1 / 12),  gam = 1 - 2 r
// cdf of a table bin: entry k is floor(2^24 CDF(k)), so that "CDF(k) below
// the uniform" is an integer compare with the word's top 24 bits n: the
// uniform is n 2^-24 exactly, and for an integer n, n 2^-24 > c iff
// n > floor(2^24 c).  (The uniform's clamp at 1e-7 cannot matter here:
// CDF(0) = exp(-lam) > exp(-8).)
template <int W>
struct Smem {
  // weights of a bin: W floats, padded so that one or two vector loads do
  static constexpr int kWeightStride = W <= 2 ? W : ((W + 3) / 4) * 4;
  float4 params[2][kChunk];
  float weights[2][kChunk * kWeightStride];
  uint32_t cdf[2][kChunk * kCdfStride];
  uint32_t head[2][kGroups];
};

template <int W>
__device__ __forceinline__ Smem<W>& smem() {
  return *reinterpret_cast<Smem<W>*>(smem_raw);
}

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t c2, uint32_t c3,
                                               const RoundKeys& rk) {
  constexpr uint32_t kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint64_t p0 = static_cast<uint64_t>(kM0) * c0;
    const uint64_t p1 = static_cast<uint64_t>(kM1) * c2;
    const uint32_t n0 = static_cast<uint32_t>(p1 >> 32) ^ c1 ^ rk.k[2 * i];
    const uint32_t n2 = static_cast<uint32_t>(p0 >> 32) ^ c3 ^ rk.k[2 * i + 1];
    c1 = static_cast<uint32_t>(p1);
    c3 = static_cast<uint32_t>(p0);
    c0 = n0;
    c2 = n2;
  }
  return make_uint4(c0, c1, c2, c3);
}

// Top 24 bits (logical shift of an unsigned word) -> uniform in (0, 1),
// clamped away from 0 for Box-Muller's log.
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return fmaxf(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f), 1e-7f);
}

// x >= 0; a denormal x gives 0
__device__ __forceinline__ float sqrt_approx(float x) {
  float y;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// natural log of a normal (not denormal) x > 0
__device__ __forceinline__ float log_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y * 0.6931471805599453f;
}

// One word of shared memory at a 32-bit shared address.  Volatile, with a
// memory clobber: the load stays where it is written, after the barrier that
// published the buffer and before the one that lets it be overwritten.
__device__ __forceinline__ uint32_t load_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(addr) : "memory");
  return v;
}

// The truncated-Poisson inverse CDF is the count of the table's entries
// below n (entries 0..30; see the note above for entry 31): a branchless
// lower bound that moves a byte address `a` from the table's
// shared address `cdf`, so a step is a load, a compare and an add.
__device__ __forceinline__ void search_step(uint32_t& a, int step,
                                            uint32_t n) {
  if (load_shared(a + 4 * (step - 1)) < n) a += 4 * step;
}

// Four times the count, as a float: exact for a - cdf < 2^23, and no
// conversion instruction.
__device__ __forceinline__ float count_x4(uint32_t a, uint32_t cdf) {
  return __uint_as_float(0x4B000000u | (a - cdf)) - 8388608.0f;
}

// Two independent standard normals from two words (Box-Muller).
__device__ __forceinline__ void normal_pair(uint32_t w1, uint32_t w2,
                                            float& z_cos, float& z_sin) {
  const float rad =
      sqrt_approx(fmaxf(-2.0f * log_approx(uniform24(w1)), 0.0f));
  float s, c;
  __sincosf(fmaf(uniform24(w2), kTwoPi, -kPi), &s, &c);
  z_cos = rad * c;
  z_sin = rad * s;
}

// Threads 0..63 (two whole warps) write the records of bins u0..u0+63 of the
// row into buffer `buf`; every thread copies a share of the weights.  The
// walk takes whole groups of four, so the weights of the bins between the
// row's end and the end of its last group are written as 0: their draws are
// 0, but 0 times whatever an earlier kernel left in shared memory need not
// be.
template <int W>
__device__ __forceinline__ void stage_chunk(
    int buf, int u0, int last, const float* __restrict__ counts,
    const float* __restrict__ ratio, const float* __restrict__ ctail,
    const float* __restrict__ weights) {
  Smem<W>& sm = smem<W>();
  const int tid = threadIdx.x;
  if (tid < kChunk) {
    const int u = u0 + tid;
    uint32_t kind = kLinear;
    const float r = u < last ? ratio[u] : 0.0f;
    float4 p = make_float4(0.0f, 0.0f, fmaxf(r, 0.0f), 0.0f);
    if (r >= 1.0f - 1e-6f) {
      p.z = 1.0f;  // absorbing: clamp(remaining) is every remaining trial
    } else if (r > 0.0f) {
      const float lam = counts[u];
      if (lam < kTau) {
        kind = kTable;
        // draw = lam + (k - lam) sq + r (remaining - ctail) for the table
        // count k: rescaled to the conditional binomial's variance, plus
        // the conditional-mean shift.  Kept as k sq + r remaining + const.
        const float ct = ctail[u];
        const float sq = sqrtf(fmaxf(1.0f - lam / fmaxf(ct, 1.0f), 0.0f));
        p.x = 0.25f * sq;
        p.y = fmaf(-r, ct, lam) - lam * sq;
        // the truncated-Poisson CDF, as sampling.poisson_cdf_table builds
        // it: pmf by the recurrence, summed in order
        uint32_t* cdf = sm.cdf[buf] + tid * kCdfStride;
        float pmf = expf(-lam);
        float c = pmf;
        cdf[0] = __float2uint_rz(c * 16777216.0f);
#pragma unroll 1
        for (int k = 1; k < kTableLen; ++k) {
          pmf = pmf * lam / static_cast<float>(k);
          c += pmf;
          cdf[k] = __float2uint_rz(c * 16777216.0f);
        }
      } else {
        kind = kGauss;
        const float gam = 1.0f - 2.0f * r;
        p = make_float4(1.0f - r, gam * (1.0f / 6.0f), r,
                        gam * gam * (1.0f / 18.0f) + 1.0f / 12.0f);
      }
    }
    sm.params[buf][tid] = p;
    const uint32_t k1 = __shfl_down_sync(0xffffffffu, kind, 1);
    const uint32_t k2 = __shfl_down_sync(0xffffffffu, kind, 2);
    const uint32_t k3 = __shfl_down_sync(0xffffffffu, kind, 3);
    if ((tid & (kGroup - 1)) == 0) {
      uint32_t head = kind | (k1 << 2) | (k2 << 4) | (k3 << 6);
      if (kind == kTable || k1 == kTable || k2 == kTable || k3 == kTable)
        head |= kHasTable;
      if (kind == kGauss || k1 == kGauss || k2 == kGauss || k3 == kGauss)
        head |= kHasGauss;
      sm.head[buf][tid / kGroup] = head;
    }
  }
  constexpr int kStride = Smem<W>::kWeightStride;
  const int bins = min(kChunk, last - u0);
  const int n = bins * W;
  const int n_walked = (bins + kGroup - 1) / kGroup * kGroup * W;
  const float* src = weights + static_cast<size_t>(u0) * W;
  for (int i = tid; i < n_walked; i += kThreads)
    sm.weights[buf][(i / W) * kStride + (i % W)] = i < n ? src[i] : 0.0f;
}

template <int W>
__device__ __forceinline__ void contract(const float* w, float draw,
                                         float (&acc)[W]) {
  if constexpr (W == 1) {
    acc[0] = fmaf(w[0], draw, acc[0]);
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(w);
    acc[0] = fmaf(v.x, draw, acc[0]);
    acc[1] = fmaf(v.y, draw, acc[1]);
  } else {
    static_assert(W == 5, "W in {1, 2, 5}");
    const float4 v = *reinterpret_cast<const float4*>(w);
    const float v4 = w[4];
    acc[0] = fmaf(v.x, draw, acc[0]);
    acc[1] = fmaf(v.y, draw, acc[1]);
    acc[2] = fmaf(v.z, draw, acc[2]);
    acc[3] = fmaf(v.w, draw, acc[3]);
    acc[4] = fmaf(v4, draw, acc[4]);
  }
}

// The four dependent steps of a group: each bin's draw from its raw sample
// and the trials that remain, contracted into the W sums.  A group without a
// Gaussian bin takes the instance without that branch.
template <int W, bool kMayGauss>
__device__ __forceinline__ void group_steps(const float4* params,
                                            const float* weights,
                                            uint32_t head,
                                            const float (&raw)[kGroup],
                                            float& rem, float (&acc)[W]) {
  constexpr int kStride = Smem<W>::kWeightStride;
#pragma unroll
  for (int j = 0; j < kGroup; ++j) {
    float x;
    if (kMayGauss && ((head >> (2 * j)) & 3u) == kGauss) {
      // rounded Gaussian with the Cornish-Fisher skew term; the base sigma
      // is shrunk by the CF term's variance and the rounding's
      const float4 p = params[j];
      const float z = raw[j];
      const float m = rem * p.z;
      const float sdev = sqrt_approx(fmaxf(fmaf(m, p.x, -p.w), 0.0f));
      x = rintf(fmaf(p.y, fmaf(z, z, -1.0f), fmaf(sdev, z, m)));
    } else {
      x = fmaf(params[j].z, rem, raw[j]);
    }
    const float draw = fminf(fmaxf(x, 0.0f), rem);
    contract<W>(weights + j * kStride, draw, acc);
    rem -= draw;
  }
}

// One replicate's walk over the staged groups of a chunk.  Every read of
// shared memory except the table search is a broadcast.
template <int W>
__device__ __forceinline__ void walk_chunk(int buf, int n_groups, uint32_t rep,
                                           uint32_t group0, uint32_t row,
                                           const RoundKeys& rk, float& rem,
                                           float (&acc)[W]) {
  const Smem<W>& sm = smem<W>();
  constexpr int kStride = Smem<W>::kWeightStride;
  constexpr uint32_t kTableBytes = kCdfStride * 4;
  const uint32_t* heads = sm.head[buf];
  const float4* params = sm.params[buf];
  const float* weights = sm.weights[buf];
  uint32_t cdf = static_cast<uint32_t>(__cvta_generic_to_shared(sm.cdf[buf]));
  for (int g = 0; g < n_groups; ++g, params += kGroup,
           weights += kGroup * kStride, cdf += kGroup * kTableBytes) {
    const uint32_t head = heads[g];
    // raw samples first: they do not depend on the remaining trials
    float raw[kGroup] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (head & kHasTable) {
      const uint4 bits = philox4x32_10(rep, group0 + g, row, 0u, rk);
      const uint32_t word[kGroup] = {bits.x, bits.y, bits.z, bits.w};
      // the draw's part that does not depend on the remaining trials
      auto finish = [&](int j, uint32_t a) {
        const float2 p = *reinterpret_cast<const float2*>(params + j);
        raw[j] = fmaf(count_x4(a, cdf + j * kTableBytes), p.x, p.y);
      };
      if ((head & 0xffu) == (kTable * 0x55u)) {
        // four table bins: the four searches in step, so that their loads
        // overlap
        uint32_t a[kGroup];
#pragma unroll
        for (int j = 0; j < kGroup; ++j) a[j] = cdf + j * kTableBytes;
#pragma unroll
        for (int step = kTableLen / 2; step >= 1; step /= 2) {
#pragma unroll
          for (int j = 0; j < kGroup; ++j)
            search_step(a[j], step, word[j] >> 8);
        }
#pragma unroll
        for (int j = 0; j < kGroup; ++j) finish(j, a[j]);
      } else {
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          if (((head >> (2 * j)) & 3u) != kTable) continue;
          uint32_t a = cdf + j * kTableBytes;
#pragma unroll
          for (int step = kTableLen / 2; step >= 1; step /= 2)
            search_step(a, step, word[j] >> 8);
          finish(j, a);
        }
      }
    }
    if (head & kHasGauss) {
      const uint4 bits = philox4x32_10(rep, group0 + g, row, 1u, rk);
      float z[kGroup];
      normal_pair(bits.x, bits.y, z[0], z[1]);
      normal_pair(bits.z, bits.w, z[2], z[3]);
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (((head >> (2 * j)) & 3u) == kGauss) raw[j] = z[j];
      }
      group_steps<W, true>(params, weights, head, raw, rem, acc);
    } else {
      group_steps<W, false>(params, weights, head, raw, rem, acc);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads, 6)
cascade_bootstrap_kernel(const float* __restrict__ counts,
                         const float* __restrict__ ratio,
                         const float* __restrict__ ctail,
                         const float* __restrict__ weights,
                         const float* __restrict__ n_obs,
                         const int* __restrict__ u_end,
                         const int* __restrict__ order,
                         float* __restrict__ sums, int n_bins, int num_boot,
                         int n_slabs, const __grid_constant__ RoundKeys rk) {
  // block -> (row in the given order, slab of replicates)
  const int rank = blockIdx.x / n_slabs;
  const int slab = blockIdx.x - rank * n_slabs;
  const int t = order[rank];
  const int b = slab * kThreads + threadIdx.x;
  const bool active = b < num_boot;

  const size_t row = static_cast<size_t>(t) * n_bins;
  counts += row;
  ratio += row;
  ctail += row;
  weights += row * W;
  const int last = u_end[t];  // 1 + last occupied bin; 0 for an empty row
  const int n_chunks = (last + kChunk - 1) / kChunk;

  float rem = n_obs[t];
  float acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.0f;

  if (n_chunks > 0) stage_chunk<W>(0, 0, last, counts, ratio, ctail, weights);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    // chunk c + 1 goes into the buffer that chunk c - 1 was read from; the
    // barrier that ended iteration c - 1 made that safe
    if (c + 1 < n_chunks)
      stage_chunk<W>((c + 1) & 1, (c + 1) * kChunk, last, counts, ratio,
                     ctail, weights);
    if (active) {
      const int bins = min(kChunk, last - c * kChunk);
      walk_chunk<W>(c & 1, (bins + kGroup - 1) / kGroup,
                    static_cast<uint32_t>(b),
                    static_cast<uint32_t>(c * kGroups),
                    static_cast<uint32_t>(t), rk, rem, acc);
    }
    __syncthreads();
  }

  if (active) {
    float* out = sums + static_cast<size_t>(t) * W * num_boot + b;
#pragma unroll
    for (int w = 0; w < W; ++w) out[static_cast<size_t>(w) * num_boot] = acc[w];
  }
}

RoundKeys round_keys(uint64_t seed) {
  RoundKeys rk;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
  for (int i = 0; i < 10; ++i) {
    rk.k[2 * i] = k0;
    rk.k[2 * i + 1] = k1;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return rk;
}

// The records of six resident blocks take ~139 KB of the SM's shared
// memory: ask for the largest carve-out.  The attribute belongs to the
// current device, so it is set at every launch (microseconds on the host).
template <int W>
cudaError_t prefer_shared() {
  return cudaFuncSetAttribute(cascade_bootstrap_kernel<W>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int W>
cudaError_t launch(const float* counts, const float* ratio, const float* ctail,
                   const float* weights, const float* n_obs, const int* u_end,
                   const int* order, float* sums, int n_rows, int n_bins,
                   int num_boot, uint64_t seed, cudaStream_t stream) {
  const int n_slabs = (num_boot + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(n_rows) * n_slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const cudaError_t rc = prefer_shared<W>();
  if (rc != cudaSuccess) return rc;
  cascade_bootstrap_kernel<W>
      <<<static_cast<unsigned>(blocks), kThreads, sizeof(Smem<W>), stream>>>(
          counts, ratio, ctail, weights, n_obs, u_end, order, sums, n_bins,
          num_boot, n_slabs, round_keys(seed));
  return cudaGetLastError();
}

template <int W>
cudaError_t resources(int* regs, int* shared_bytes, int* blocks_per_sm) {
  cudaError_t rc = prefer_shared<W>();
  if (rc != cudaSuccess) return rc;
  cudaFuncAttributes attr;
  rc = cudaFuncGetAttributes(&attr, cascade_bootstrap_kernel<W>);
  if (rc != cudaSuccess) return rc;
  *regs = attr.numRegs;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes + sizeof(Smem<W>));
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, cascade_bootstrap_kernel<W>, kThreads, sizeof(Smem<W>));
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All arrays are contiguous
// float32 / int32 device buffers: counts, ratio, ctail [T, U]; weights
// [T, U, W]; n_obs [T]; u_end [T] (1 + last occupied bin); order [T] (the
// rows in the order the blocks take them, a permutation); sums [T, W, B].
// Each returns a cudaError_t (0 on success).
extern "C" int cascade_bootstrap_launch(const void* counts, const void* ratio,
                                        const void* ctail, const void* weights,
                                        const void* n_obs, const void* u_end,
                                        const void* order, void* sums,
                                        int n_rows, int n_bins, int n_weights,
                                        int num_boot, unsigned long long seed,
                                        void* stream) {
  const auto* c = static_cast<const float*>(counts);
  const auto* r = static_cast<const float*>(ratio);
  const auto* ct = static_cast<const float*>(ctail);
  const auto* w = static_cast<const float*>(weights);
  const auto* n = static_cast<const float*>(n_obs);
  const auto* ue = static_cast<const int*>(u_end);
  const auto* o = static_cast<const int*>(order);
  auto* s = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n_weights) {
    case 1:
      return launch<1>(c, r, ct, w, n, ue, o, s, n_rows, n_bins, num_boot,
                       seed, st);
    case 2:
      return launch<2>(c, r, ct, w, n, ue, o, s, n_rows, n_bins, num_boot,
                       seed, st);
    case 5:
      return launch<5>(c, r, ct, w, n, ue, o, s, n_rows, n_bins, num_boot,
                       seed, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, shared memory per block and resident blocks per SM
// of the instance for `n_weights`.
extern "C" int cascade_bootstrap_resources(int n_weights, int* regs,
                                           int* shared_bytes,
                                           int* blocks_per_sm) {
  switch (n_weights) {
    case 1:
      return resources<1>(regs, shared_bytes, blocks_per_sm);
    case 2:
      return resources<2>(regs, shared_bytes, blocks_per_sm);
    case 5:
      return resources<5>(regs, shared_bytes, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
