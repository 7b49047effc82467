// The router's backward for one token row, shared by the router's own
// backward kernel (moe_router.cu, router_bwd_kernel) and the MoE combine's
// backward (moe_combine.cu, combine_bwd_kernel): the arithmetic exists
// once, so both give the same gradient on the same inputs.
//
// With p a row's probabilities, wsum = sum_j p[idx_j] and
// c = sum_j dw_j w_j:
//   g_j       = (dw_j - c) / wsum  (dw_j / 1e-9 where wsum <= 1e-9)
//   dp[e]     = dprob_sum[e] + sum_{j: idx_j = e} g_j
//   dlogit[e] = p[e] (dp[e] - sum_e' p[e'] dp[e']) + 2 dz_sum lse p[e]
// with lse recomputed from the masked logits (experts at or past n_real
// at -1e30); 0 for a padded expert.  One warp takes the row, its lanes
// the experts lane, lane+32, ...: every sum is a butterfly over the
// warp's lanes, in a fixed order, and no atomics are used.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace repro_moe {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;
constexpr int kMaxExperts = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(kFull, v, s);
  return v;
}

// The logits' gradient of token row ``row`` (T, E layouts), written to
// dlogits.  Every lane of the warp calls it; lane j < k passes dw_j, the
// upstream gradient of the row's weight j (0 for the others).  dprob_sum
// and dz_sum may be null (zero).  PER_LANE * 32 >= E.
template <int PER_LANE>
__device__ __forceinline__ void router_bwd_row(
    const float* __restrict__ logits, const float* __restrict__ probs,
    const int* __restrict__ idx, const float* __restrict__ w, float dwj,
    const float* __restrict__ dprob_sum, const float* __restrict__ dz_sum,
    float* __restrict__ dlogits, int row, int lane, int E, int k,
    int n_real) {
  const float* x = logits + (size_t)row * E;
  const float* pr = probs + (size_t)row * E;
  float p[PER_LANE], dp[PER_LANE];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    dp[j] = e < E ? (e < n_real ? x[e] : kMasked) : -INFINITY;
    p[j] = e < E ? pr[e] : 0.f;
    m = fmaxf(m, dp[j]);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j)
    sum += lane + 32 * j < E ? expf(dp[j] - m) : 0.f;
  const float lse = m + logf(warp_sum(sum));

  // lane j < k holds pick j: its expert, weight, upstream gradient and p
  int ej = 0;
  float wj = 0.f, pj = 0.f;
  if (lane < k) {
    const size_t at = (size_t)row * k + lane;
    ej = idx[at];
    wj = w[at];
    pj = pr[ej];
  } else {
    dwj = 0.f;
  }
  const float wsum = warp_sum(pj);
  const float c = warp_sum(dwj * wj);
  const float g = wsum > 1e-9f ? (dwj - c) / wsum : dwj / 1e-9f;

#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    dp[j] = dprob_sum && e < E ? dprob_sum[e] : 0.f;
  }
  for (int r = 0; r < k; ++r) {
    const int er = __shfl_sync(kFull, ej, r);
    const float gr = __shfl_sync(kFull, g, r);
    if ((er & 31) == lane) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane + 32 * j == er) dp[j] += gr;
    }
  }
  float dot = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) dot += p[j] * dp[j];
  dot = warp_sum(dot);
  const float zl = dz_sum ? 2.f * dz_sum[0] * lse : 0.f;
  float* out = dlogits + (size_t)row * E;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    if (e < E) out[e] = e < n_real ? p[j] * (dp[j] - dot) + zl * p[j] : 0.f;
  }
}

}  // namespace repro_moe

// The experts each lane of a row's warp keeps (PER_LANE, E <= 32 *
// PER_LANE), as a compile-time constant for a launch: ``REPRO_PER_LANE(
// per_lane, F)`` runs ``F(P)`` for the least P in {1, 2, 4, 8, 16} that
// holds per_lane (E <= 512).
#define REPRO_PER_LANE(per_lane, F) \
  do {                              \
    if ((per_lane) <= 1) { F(1); }  \
    if ((per_lane) <= 2) { F(2); }  \
    if ((per_lane) <= 4) { F(4); }  \
    if ((per_lane) <= 8) { F(8); }  \
    F(16);                          \
  } while (0)
