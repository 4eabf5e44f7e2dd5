// Exact multinomial bootstrap for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws its exact sampler
// ('multinomial') as a chain of jax.random.binomial calls outside any Pallas
// kernel.  The port drew it the same way, as a chain of torch.binomial
// launches (memento_tpu_torch/ops/sampling.py::_binomial_chain), about eight
// launches per occupied bin, per cell group and per chunk of replicates, and
// a host sync to find the chain's length; that chain set the pace of every
// call of the exact sampler on the card.  This kernel draws the same law in
// one launch per call.  Its plain version, on the same random stream, is
// ops/sampling.py::fused_multinomial_sums_philox.
//
//   For every row t (one gene or gene pair in one cell group) and replicate
//   b, draw an exact multinomial resample of the row's bin multiplicities
//   counts[t, :] with n_obs[t] trials, as a chain of conditional binomials
//   over the bins, and contract it on the fly:
//   sums[t, w, b] = sum_u weights[t, u, w] * n_tub.
//   Bin u draws Binomial(remaining, p) with p = ratio[t, u] (the bin's share
//   of the tail, ops/sampling.py::conditional_ratios) clipped to
//   [1e-7, 1 - 1e-7]; a bin with ratio >= 1 - 1e-6 takes every remaining
//   trial, and a bin with ratio <= 0 draws 0, as does every bin once no
//   trial remains.  The draws are never stored.
//
// Each binomial uses the algorithms of torch.binomial's CUDA kernel
// (ATen/native/Distributions.h: sample_binomial, binomial_inversion, btrs),
// in float32: with q = min(p, 1 - p), inversion by geometric waiting times
// where remaining * q < 10, else BTRS (Hoermann 1993, "The generation of
// binomial random variates"), and remaining minus the draw at q where
// p > 0.5.  Those are exact samplers, not approximations.  torch evaluates
// a few of BTRS's constants in double before it rounds them to float32;
// here every constant is float32.
//
// What bounds it on this card: instruction throughput, not bytes (a call
// reads a tile of a few MB once; it makes one Philox call and a logarithm
// or two per draw).  So the design spends as few instructions per draw as
// it can and walks no bin that cannot draw anything.
//
// What the design does about it:
//  - One thread per (row, replicate); a block is one row and a slab of 256
//    replicates, so every thread of a block is on the same bin and every
//    record read is a shared-memory broadcast.
//  - Whatever depends on (row, bin) alone is computed once per block: the
//    block walks its row in chunks of 64 bins, and for each chunk 64 threads
//    write a record per bin (q, log(1 - q), q / (1 - q), the bin's kind)
//    and the threads together copy the W weights.  `remaining` and the W
//    sums stay in registers.
//  - Each block stops at its row's own last occupied bin (u_end, computed
//    on the device by the wrapper), and a thread draws nothing once its
//    replicate has no trial left; a block whose replicates have all run out
//    stops staging.  No host sync anywhere.
//  - Rows go to the SMs longest first (the wrapper passes the order).
//  - Random numbers come from Philox4x32-10 keyed by the call's 64-bit
//    seed, counter (replicate, bin, row, k) for the k-th call of the draw:
//    inversion takes one uniform per waiting time and BTRS two per trial,
//    four words a call, so a rejection loop takes further calls.  A draw is
//    thus a pure function of (seed, row, bin, replicate): it does not
//    depend on the grid, the chunking or num_boot.
//  - The contraction stays acc[w] += weight * draw in registers (W in
//    {1, 2, 5}, templates).
//
// Float32 agreement with the plain version: every operation that decides a
// draw is a single IEEE operation (division and square root correctly
// rounded; no -use_fast_math), and the products that nvcc would contract
// into a fused multiply-add are written with __fmul_rn / __fadd_rn, as
// torch rounds them.  Only logf and log1pf (1 ulp) may differ from the
// host's, which flips a rejection or waiting-time decision now and then.
//
// The uniforms are the words' top 24 bits times 2^-24, clamped at 1e-7 away
// from 0, as in csrc/cascade_bootstrap.cu (and ops/philox.py::uniform24).
//
// This file includes no header of its own: ops/kernel_build.py hashes the
// .cu alone to decide when to rebuild.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                // bins staged at a time
constexpr float kAbsorb = 0.999999f;      // 1 - 1e-6 in float32
constexpr float kPMin = 1e-7f;            // the draw's clip of p
constexpr float kPMax = 0.99999988f;      // 1 - 1e-7 in float32
constexpr float kBtrsMin = 10.0f;         // BTRS where remaining * q >= this

// kind of a bin (a record's .w, as bits)
constexpr uint32_t kEmpty = 0, kTake = 1, kDraw = 2, kDrawFlip = 3;

struct RoundKeys {
  uint32_t k[20];  // (key.x, key.y) of Philox's ten rounds
};

// torch's stirling_approx_tail for k < 10, rounded to float32 as torch's
// float table is
__constant__ float kTail[10] = {
    0.0810614667953272f,  0.0413406959554092f,  0.0276779256849983f,
    0.02079067210376509f, 0.0166446911898211f,  0.0138761288230707f,
    0.0118967099458917f,  0.0104112652619720f,  0.00925546218271273f,
    0.00833056343336287f};

template <int W>
struct Smem {
  float4 bins[kChunk];         // (q, log1p(-q), q / (1 - q), kind)
  float weights[kChunk * W];
};

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

// Top 24 bits -> uniform in [1e-7, 1)
__device__ __forceinline__ float uniform24(uint32_t bits) {
  return fmaxf(static_cast<float>(bits >> 8) * (1.0f / 16777216.0f), 1e-7f);
}

// The uniforms of one draw, in order: word j of call k is uniform 4 k + j.
struct Stream {
  uint32_t rep, bin, row, call;
  uint4 words;
  int left;  // words of the current call not yet taken

  __device__ __forceinline__ float next(const RoundKeys& rk) {
    if (left == 0) {
      words = philox4x32_10(rep, bin, row, call++, rk);
      left = 4;
    }
    const uint32_t w = words.x;
    words = make_uint4(words.y, words.z, words.w, 0u);
    --left;
    return uniform24(w);
  }
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float stirling_tail(float k) {
  if (k < 10.0f) return kTail[static_cast<int>(k)];
  const float kp1 = add(k, 1.0f);
  const float kp1sq = mul(kp1, kp1);
  return (1.0f / 12.0f - (1.0f / 360.0f - 1.0f / 1260.0f / kp1sq) / kp1sq) /
         kp1;
}

// torch's binomial_inversion: the count of geometric waiting times that fit
// into `count` trials.  logq1 = log1p(-q).
__device__ float inversion(float count, float logq1, Stream& s,
                           const RoundKeys& rk) {
  float geom_sum = 0.0f;
  float num = 0.0f;
  for (;;) {
    const float geom = ceilf(logf(s.next(rk)) / logq1);
    geom_sum = add(geom_sum, geom);
    if (geom_sum > count) return num;
    num = add(num, 1.0f);
  }
}

// torch's btrs at q <= 0.5 (odds r = q / (1 - q))
__device__ float btrs(float count, float q, float r, Stream& s,
                      const RoundKeys& rk) {
  const float stddev = sqrtf(mul(mul(count, q), 1.0f - q));
  const float b = add(1.15f, mul(2.53f, stddev));
  const float a = add(add(-0.0873f, mul(0.0248f, b)), mul(0.01f, q));
  const float c = add(mul(count, q), 0.5f);
  const float v_r = 0.92f - 4.2f / b;
  const float alpha = mul(add(2.83f, 5.1f / b), stddev);
  const float m = floorf(mul(add(count, 1.0f), q));
  for (;;) {
    const float u = s.next(rk) - 0.5f;
    float v = s.next(rk);
    const float us = 0.5f - fabsf(u);
    const float k = floorf(add(mul(add(mul(2.0f, a) / us, b), u), c));
    if (k < 0.0f || k > count) continue;
    if (us >= 0.07f && v <= v_r) return k;
    v = logf(mul(v, alpha) / add(a / mul(us, us), b));
    const float nm1 = add(count - m, 1.0f);  // count - m + 1
    const float nk1 = add(count - k, 1.0f);  // count - k + 1
    float upper = mul(add(m, 0.5f), logf(add(m, 1.0f) / mul(r, nm1)));
    upper = add(upper, mul(add(count, 1.0f), logf(nm1 / nk1)));
    upper = add(upper, mul(add(k, 0.5f), logf(mul(r, nk1) / add(k, 1.0f))));
    upper = add(upper, stirling_tail(m));
    upper = add(upper, stirling_tail(count - m));
    upper = upper - stirling_tail(k);
    upper = upper - stirling_tail(count - k);
    if (v <= upper) return k;
  }
}

template <int W>
__device__ __forceinline__ void contract(const float* w, float draw,
                                         float (&acc)[W]) {
#pragma unroll
  for (int i = 0; i < W; ++i) acc[i] = fmaf(w[i], draw, acc[i]);
}

// Threads 0..63 write the records of bins u0..u0+63 of the row; every
// thread copies a share of the weights.
template <int W>
__device__ __forceinline__ void stage_chunk(Smem<W>& sm, int u0, int bins,
                                            const float* __restrict__ ratio,
                                            const float* __restrict__ weights) {
  const int tid = threadIdx.x;
  if (tid < bins) {
    const float rt = ratio[u0 + tid];
    float4 rec = make_float4(0.0f, 0.0f, 0.0f, __uint_as_float(kEmpty));
    if (rt >= kAbsorb) {
      rec.w = __uint_as_float(kTake);
    } else if (rt > 0.0f) {
      const float p = fminf(fmaxf(rt, kPMin), kPMax);
      const bool flip = p > 0.5f;
      const float q = flip ? 1.0f - p : p;  // exact for p in (0.5, 1)
      rec = make_float4(q, log1pf(-q), q / (1.0f - q),
                        __uint_as_float(flip ? kDrawFlip : kDraw));
    }
    sm.bins[tid] = rec;
  }
  const float* src = weights + static_cast<size_t>(u0) * W;
  for (int i = tid; i < bins * W; i += kThreads) sm.weights[i] = src[i];
}

template <int W>
__global__ void __launch_bounds__(kThreads)
multinomial_bootstrap_kernel(const float* __restrict__ ratio,
                             const float* __restrict__ weights,
                             const float* __restrict__ n_obs,
                             const int* __restrict__ u_end,
                             const int* __restrict__ order,
                             float* __restrict__ sums, int n_bins,
                             int num_boot, int n_slabs,
                             const __grid_constant__ RoundKeys rk) {
  __shared__ Smem<W> sm;
  // block -> (row in the given order, slab of replicates)
  const int rank = blockIdx.x / n_slabs;
  const int slab = blockIdx.x - rank * n_slabs;
  const int t = order[rank];
  const int b = slab * kThreads + threadIdx.x;
  const bool active = b < num_boot;

  const size_t row = static_cast<size_t>(t) * n_bins;
  ratio += row;
  weights += row * W;
  const int last = u_end[t];  // 1 + last occupied bin; 0 for an empty row

  float rem = active ? n_obs[t] : 0.0f;
  float acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0.0f;

  Stream s;
  s.rep = static_cast<uint32_t>(b);
  s.row = static_cast<uint32_t>(t);
  for (int u0 = 0; u0 < last; u0 += kChunk) {
    // the barrier also ends the previous chunk's reads; a block whose
    // replicates have no trial left is done
    if (!__syncthreads_or(rem > 0.0f)) break;
    const int bins = min(kChunk, last - u0);
    stage_chunk<W>(sm, u0, bins, ratio, weights);
    __syncthreads();
    for (int j = 0; j < bins && rem > 0.0f; ++j) {
      const float4 rec = sm.bins[j];
      const uint32_t kind = __float_as_uint(rec.w);
      float draw;
      if (kind == kEmpty) {
        continue;
      } else if (kind == kTake) {
        draw = rem;
      } else {
        s.bin = static_cast<uint32_t>(u0 + j);
        s.call = 0u;
        s.left = 0;
        const float k = mul(rem, rec.x) >= kBtrsMin
                            ? btrs(rem, rec.x, rec.z, s, rk)
                            : inversion(rem, rec.y, s, rk);
        draw = kind == kDrawFlip ? rem - k : k;
      }
      contract<W>(sm.weights + j * W, draw, acc);
      rem -= draw;
    }
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

template <int W>
cudaError_t launch(const float* ratio, const float* weights,
                   const float* n_obs, const int* u_end, const int* order,
                   float* sums, int n_rows, int n_bins, int num_boot,
                   uint64_t seed, cudaStream_t stream) {
  const int n_slabs = (num_boot + kThreads - 1) / kThreads;
  const long long blocks = static_cast<long long>(n_rows) * n_slabs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  multinomial_bootstrap_kernel<W>
      <<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
          ratio, weights, n_obs, u_end, order, sums, n_bins, num_boot,
          n_slabs, round_keys(seed));
  return cudaGetLastError();
}

template <int W>
cudaError_t resources(int* regs, int* shared_bytes, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t rc =
      cudaFuncGetAttributes(&attr, multinomial_bootstrap_kernel<W>);
  if (rc != cudaSuccess) return rc;
  *regs = attr.numRegs;
  *shared_bytes = static_cast<int>(attr.sharedSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, multinomial_bootstrap_kernel<W>, kThreads, 0);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  All arrays are contiguous
// float32 / int32 device buffers: ratio [T, U] (conditional_ratios);
// weights [T, U, W]; n_obs [T]; u_end [T] (1 + last occupied bin); order
// [T] (the rows in the order the blocks take them, a permutation); sums
// [T, W, B].  Each returns a cudaError_t (0 on success).
extern "C" int multinomial_bootstrap_launch(const void* ratio,
                                            const void* weights,
                                            const void* n_obs,
                                            const void* u_end,
                                            const void* order, void* sums,
                                            int n_rows, int n_bins,
                                            int n_weights, int num_boot,
                                            unsigned long long seed,
                                            void* stream) {
  const auto* r = static_cast<const float*>(ratio);
  const auto* w = static_cast<const float*>(weights);
  const auto* n = static_cast<const float*>(n_obs);
  const auto* ue = static_cast<const int*>(u_end);
  const auto* o = static_cast<const int*>(order);
  auto* s = static_cast<float*>(sums);
  auto st = static_cast<cudaStream_t>(stream);
  switch (n_weights) {
    case 1:
      return launch<1>(r, w, n, ue, o, s, n_rows, n_bins, num_boot, seed, st);
    case 2:
      return launch<2>(r, w, n, ue, o, s, n_rows, n_bins, num_boot, seed, st);
    case 5:
      return launch<5>(r, w, n, ue, o, s, n_rows, n_bins, num_boot, seed, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Registers per thread, shared memory per block and resident blocks per SM
// of the instance for `n_weights`.
extern "C" int multinomial_bootstrap_resources(int n_weights, int* regs,
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
