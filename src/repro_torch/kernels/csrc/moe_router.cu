// MoE routing and dispatch for Hopper (sm_90a), written by hand for the
// PyTorch port: one launch a MoE layer call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_router.py
// (router_topk_pallas, body _kernel) and takes over the bookkeeping that
// src/repro/models/moe.py (_moe_local) leaves to XLA around it: per token
// row a softmax over the E router logits (experts at or past n_real
// masked to -1e30 first), k rounds of (max, lowest index holding it,
// mask), the k weights renormalised by max(sum, 1e-9); then each
// assignment's position in its expert's capacity buffer, the slot map in
// both directions, and the load-balance and z-loss sums.
//
// Layouts (all contiguous): logits (T, E) f32 in.  Out: w (T, k) f32,
// idx (T, k) int32, probs (T, E) f32, slot (T, k) int32, src (e_local*C)
// int32, load (E) f32, prob_sum (E) f32, z_sum (1) f32.  1 <= k <=
// min(E, 32), E <= 512, 1 <= n_real <= E, C >= 1, 0 <= e_start,
// 1 <= e_local, e_start + e_local <= E.
// Numerics, as the Pallas kernel: m = max, e = exp(x - m),
// probs = e / sum(e); round j takes the largest remaining probability and,
// among equal ones, the lowest expert index; the taken slot is set below
// every probability (-1e30); w = taken / max(sum of taken, 1e-9).
// Dispatch, as the reference's sort and cumsum forms: the position of
// assignment (t, j) is the number of assignments (t', j') before it in
// (t, j) order that picked the same expert; position >= C is dropped.
// slot[t, j] = e*C + position, or E*C when dropped; src[e*C + p] is the
// token in that capacity slot, or T when the slot stays empty.
// load[e] counts every assignment to e (dropped ones too), prob_sum[e] =
// sum_t probs[t, e], z_sum = sum_t logsumexp(logits[t])^2.
// Expert parallelism: a shard that holds experts [e_start, e_start +
// e_local) routes and counts over all E, as above, but keeps only the
// assignments to its own experts (the reference's keep = (pos < C) &
// in_shard): slot[t, j] = (e - e_start)*C + position for those, and
// e_local*C for every other; src has e_local*C entries.  At e_start 0 and
// e_local E this is the unsharded dispatch, bit for bit.
//
// What bounds it on an H100.  At serving shapes (T = 4 to 64 tokens,
// E = 40, k = 8) a call moves a few KB: some nanoseconds at 3.35 TB/s,
// against a few microseconds of launch.  Launch latency is its floor; what
// the kernel can save is the launches around it, which is why it takes
// the whole dispatch bookkeeping into the one launch and writes only
// fixed-shape outputs (no host sync, no data-dependent shape).
//
// Design.  One block walks the tokens in tiles of R rows, with R times G
// threads (up to 1024: a call of 4 tokens takes 4 warps).
// A row belongs to a group of G lanes: a warp (R = 32) for up to 32
// tokens, where fewer columns a lane is quicker; a half-warp (R = 64) for
// more, so a serving chunk of 64 tokens is one tile, where E <= 128 and
// k <= 16 let it hold a row and its picks.
// lane l of the group keeps experts l, l+G, ... in registers, max and sum
// are butterfly shuffles within the group, each top-k round a lane-local
// argmax and a shuffle argmax that breaks ties by index.  A warp whose
// rows all lie past T skips the tile; in a warp that works, every lane
// runs the same instructions (a group past T works on row T-1 and writes
// nothing), so the shuffles never diverge.  A row's k picks are distinct
// experts, so a row adds at most one to each expert's count: each pick ORs
// its row's bit into a per-expert 64-bit mask (two 32-bit words, for
// native shared-memory atomics) in shared memory, and the
// position of (t, j) is the expert's running count plus the number of
// earlier rows of the tile in its mask.  The running counts then advance
// by the masks' popcounts; counts and masks are double-buffered, so a tile
// takes two block barriers.  prob_sum and z_sum are summed in f64 in a
// fixed order: each lane sums its columns (and the group's lane 0 the
// logsumexps) over its group's rows, ascending, in registers; at the end
// the R groups' sums are added in group order.  The same inputs give the
// same sums on every run, and no float atomics are used.  src is filled
// with T at the start of the same launch.  One block costs one SM; the
// tile loop takes ceil(T/R) iterations.
//
// The backward (router_bwd_kernel, training): the gradient of the logits
// from those of w (T, k), prob_sum (E) and z_sum (1); the dispatch outputs
// and probs carry none.  No Pallas kernel has a backward: the reference
// differentiates ref.router_topk_ref and the aux sums with XLA.  With p a
// row's probabilities, wsum = sum_j p[idx_j] and c = sum_j dw_j w_j:
//   g_j       = (dw_j - c) / wsum  (dw_j / 1e-9 where wsum <= 1e-9)
//   dp[e]     = dprob_sum[e] + sum_{j: idx_j = e} g_j
//   dlogit[e] = p[e] (dp[e] - sum_e' p[e'] dp[e']) + 2 dz_sum lse p[e]
// with lse recomputed from the masked logits; 0 for a padded expert.  A
// warp takes a row, its lanes the experts lane, lane+32, ...: every sum is
// a butterfly over the warp's lanes, in a fixed order, and no atomics are
// used, so the same inputs give the same gradient on every run.  The row's
// arithmetic is repro_moe::router_bwd_row (moe_router_common.cuh), which
// the MoE combine's backward (moe_combine.cu) runs too: the MoE layer's
// training takes the logits' gradient there, in the launch that also
// takes the combine's, and this kernel serves other callers of
// router_dispatch with a gradient.  At training's T 1024, E 40 a call
// moves ~0.5 MB: launch latency is its floor, as the forward's.
#include <cuda_runtime.h>
#include <math.h>

#include "moe_router_common.cuh"

namespace {

using repro_moe::kFull;
using repro_moe::kMasked;
using repro_moe::kMaxExperts;
constexpr int kMaxThreads = 1024;

// One row's softmax and top-k, by the G lanes of its group: writes the
// row's probabilities and adds them to psum, and lane 0 its
// logsumexp^2 to zsum, when ``valid``; lane r < k gets round r's expert
// and its renormalised weight.
template <int G, int PER_LANE>
__device__ __forceinline__ void route_row(const float* __restrict__ x,
                                          float* __restrict__ prow,
                                          bool valid, int lane, int E, int k,
                                          int n_real,
                                          double (&psum)[PER_LANE],
                                          double& zsum, float& mine_w,
                                          int& mine_e) {
  float v[PER_LANE];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + G * j;
    v[j] = e < E ? (e < n_real ? x[e] : kMasked) : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, s));
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    v[j] = lane + G * j < E ? expf(v[j] - m) : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int s = G / 2; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);
  if (valid && lane == 0) {
    const float lse = m + logf(sum);
    zsum += (double)(lse * lse);
  }
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + G * j;
    if (e < E) {
      v[j] = v[j] / sum;
      if (valid) {
        prow[e] = v[j];
        psum[j] += (double)v[j];
      }
    } else {
      v[j] = -INFINITY;  // below every masked slot: never taken
    }
  }

  float wsum = 0.f;
  for (int r = 0; r < k; ++r) {
    // lane-local: the largest value, the lowest index on ties (j ascends,
    // so a later slot wins only if strictly larger)
    float best = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j) {
      if (v[j] > best) {
        best = v[j];
        bi = lane + G * j;
      }
    }
#pragma unroll
    for (int s = G / 2; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, s);
      const int oi = __shfl_xor_sync(kFull, bi, s);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    // every lane of the group now holds the same (best, bi)
    if (bi % G == lane) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane + G * j == bi) v[j] = kMasked;
    }
    if (lane == r) {
      mine_w = best;
      mine_e = bi;
    }
    wsum += best;
  }
  mine_w /= fmaxf(wsum, 1e-9f);
}

template <int G, int PER_LANE>
__global__ void __launch_bounds__(kMaxThreads)
router_dispatch_kernel(const float* __restrict__ logits,
                       float* __restrict__ w, int* __restrict__ idx,
                       float* __restrict__ probs, int* __restrict__ slot,
                       int* __restrict__ src, float* __restrict__ load,
                       float* __restrict__ prob_sum,
                       float* __restrict__ z_sum, int T, int E, int k,
                       int n_real, int C, int e_start, int e_local) {
  constexpr int kMaxRows = kMaxThreads / G;
  static_assert(kMaxRows <= 64, "a tile's rows must fit a 64-bit mask");
  __shared__ int count[2][kMaxExperts];           // assignments so far
  __shared__ unsigned rows[2][kMaxExperts][2];    // the tile's rows, by bit
  __shared__ double part[kMaxRows][G + 1];        // groups' sums

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int R = nthreads / G;  // rows a tile
  const int lane = tid % G;    // lane within the row's group
  const int group = tid / G;   // row within the tile
  const int word = group >> 5;
  const unsigned bit = 1u << (group & 31);
  const int n_slots = e_local * C;  // this shard's slots
  for (int i = tid; i < n_slots; i += nthreads) src[i] = T;
  for (int e = tid; e < E; e += nthreads) {
    count[0][e] = 0;
    rows[0][e][0] = rows[0][e][1] = 0u;
  }
  double psum[PER_LANE];  // this lane's columns over this group's rows
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) psum[j] = 0.0;
  double zsum = 0.0;      // lane 0: logsumexp^2 over this group's rows
  int cur = 0;
  __syncthreads();  // src filled, counts zeroed

  for (int base = 0; base < T; base += R) {
    const int row = base + group;
    const bool valid = row < T;
    float mine_w = 0.f;
    int mine_e = -1;  // lane r < k: round r's expert
    // the warp's first row decides for all of its groups: no divergence
    if (base + (tid / 32) * (32 / G) < T)
      route_row<G, PER_LANE>(logits + (size_t)(valid ? row : T - 1) * E,
                             probs + (size_t)row * E, valid, lane, E, k,
                             n_real, psum, zsum, mine_w, mine_e);
    const bool picks = valid && lane < k;
    if (picks) {
      w[(size_t)row * k + lane] = mine_w;
      idx[(size_t)row * k + lane] = mine_e;
      atomicOr(&rows[cur][mine_e][word], bit);  // integer OR: order-free
    }
    __syncthreads();  // the tile's picks are in

    if (picks) {
      const unsigned* mask = rows[cur][mine_e];
      const int pos = count[cur][mine_e] + (word ? __popc(mask[0]) : 0) +
                      __popc(mask[word] & (bit - 1u));
      const int local = mine_e - e_start;  // the expert in this shard
      const int at = local * C + pos;
      const bool kept = pos < C && local >= 0 && local < e_local;
      slot[(size_t)row * k + lane] = kept ? at : n_slots;
      if (kept) src[at] = row;
    }
    // the other buffers: the counts after this tile, and the next tile's
    // masks cleared (the tile before read them before the barrier above)
    for (int e = tid; e < E; e += nthreads) {
      count[cur ^ 1][e] =
          count[cur][e] + __popc(rows[cur][e][0]) + __popc(rows[cur][e][1]);
      rows[cur ^ 1][e][0] = rows[cur ^ 1][e][1] = 0u;
    }
    cur ^= 1;
    __syncthreads();
  }

  // the groups' sums, added in group order: one round a register column
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    part[group][lane] = psum[j];
    if (j == 0 && lane == 0) part[group][G] = zsum;
    __syncthreads();
    // only the first min(R, T) groups ever held a row
    const int n_groups = T < R ? T : R;
    if (tid < G && tid + G * j < E) {
      double acc = 0.0;
      for (int g = 0; g < n_groups; ++g) acc += part[g][tid];
      prob_sum[tid + G * j] = (float)acc;
    }
    if (j == 0 && tid == 0) {  // a block may be one warp
      double acc = 0.0;
      for (int g = 0; g < n_groups; ++g) acc += part[g][G];
      z_sum[0] = (float)acc;
    }
    __syncthreads();
  }
  for (int e = tid; e < E; e += nthreads) load[e] = (float)count[cur][e];
}

template <int G, int PER_LANE>
cudaError_t launch(const float* logits, float* w, int* idx, float* probs,
                   int* slot, int* src, float* load, float* prob_sum,
                   float* z_sum, int T, int E, int k, int n_real, int C,
                   int e_start, int e_local, cudaStream_t st) {
  // rows a tile: as many as there are tokens, up to 1024 / G, rounded up
  // to whole warps
  constexpr int per_warp = 32 / G;
  const int max_rows = kMaxThreads / G;
  const int rows = T < max_rows ? (T + per_warp - 1) / per_warp * per_warp
                                : max_rows;
  router_dispatch_kernel<G, PER_LANE><<<1, rows * G, 0, st>>>(
      logits, w, idx, probs, slot, src, load, prob_sum, z_sum, T, E, k,
      n_real, C, e_start, e_local);
  return cudaGetLastError();
}

// The experts each lane keeps, for a row of G lanes.
template <int G>
cudaError_t launch_for(int per_lane, const float* logits, float* w, int* idx,
                       float* probs, int* slot, int* src, float* load,
                       float* prob_sum, float* z_sum, int T, int E, int k,
                       int n_real, int C, int e_start, int e_local,
                       cudaStream_t st) {
#define REPRO_ROUTER_LAUNCH(P)                                          \
  return launch<G, P>(logits, w, idx, probs, slot, src, load, prob_sum, \
                      z_sum, T, E, k, n_real, C, e_start, e_local, st)
  if (per_lane <= 1) REPRO_ROUTER_LAUNCH(1);
  if (per_lane <= 2) REPRO_ROUTER_LAUNCH(2);
  if (per_lane <= 4) REPRO_ROUTER_LAUNCH(4);
  if (per_lane <= 8) REPRO_ROUTER_LAUNCH(8);
  REPRO_ROUTER_LAUNCH(16);
#undef REPRO_ROUTER_LAUNCH
}

constexpr int kBwdRows = 8;  // rows (warps) a block of the backward

template <int PER_LANE>
__global__ void __launch_bounds__(32 * kBwdRows)
router_bwd_kernel(const float* __restrict__ logits,
                  const float* __restrict__ probs, const int* __restrict__ idx,
                  const float* __restrict__ w, const float* __restrict__ dw,
                  const float* __restrict__ dprob_sum,
                  const float* __restrict__ dz_sum,
                  float* __restrict__ dlogits, int T, int E, int k,
                  int n_real) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBwdRows + (threadIdx.x >> 5);
  if (row >= T) return;  // the whole warp leaves together
  const float dwj = dw && lane < k ? dw[(size_t)row * k + lane] : 0.f;
  repro_moe::router_bwd_row<PER_LANE>(logits, probs, idx, w, dwj, dprob_sum,
                                      dz_sum, dlogits, row, lane, E, k,
                                      n_real);
}

}  // namespace

// The router's backward: dlogits (T, E) f32 from logits, probs (T, E) f32,
// idx (T, k) int32, w (T, k) f32 and the upstream dw (T, k), dprob_sum (E)
// and dz_sum (1), f32, each null for zero.  Returns cudaGetLastError().
extern "C" int repro_router_bwd(const float* logits, const float* probs,
                                const int* idx, const float* w,
                                const float* dw, const float* dprob_sum,
                                const float* dz_sum, float* dlogits, int T,
                                int E, int k, int n_real, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || E <= 0 || k < 1 || k > E || k > 32 || E > kMaxExperts ||
      n_real < 1 || n_real > E)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((T + kBwdRows - 1) / kBwdRows);
  const int per_lane = (E + 31) / 32;
#define REPRO_ROUTER_BWD(P)                                             \
  router_bwd_kernel<P><<<blocks, 32 * kBwdRows, 0, st>>>(               \
      logits, probs, idx, w, dw, dprob_sum, dz_sum, dlogits, T, E, k,   \
      n_real);                                                          \
  return (int)cudaGetLastError()
  REPRO_PER_LANE(per_lane, REPRO_ROUTER_BWD);
#undef REPRO_ROUTER_BWD
}

extern "C" int repro_router_dispatch(const float* logits, float* w, int* idx,
                                     float* probs, int* slot, int* src,
                                     float* load, float* prob_sum,
                                     float* z_sum, int T, int E, int k,
                                     int n_real, int C, int e_start,
                                     int e_local, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || E <= 0 || k < 1 || k > E || k > 32 || E > kMaxExperts ||
      n_real < 1 || n_real > E || C < 1 || (long long)E * C >= (1LL << 31) ||
      e_start < 0 || e_local < 1 || e_start + e_local > E)
    return (int)cudaErrorInvalidValue;
  if (T > 32 && E <= 16 * 8 && k <= 16)
    return (int)launch_for<16>((E + 15) / 16, logits, w, idx, probs, slot,
                               src, load, prob_sum, z_sum, T, E, k, n_real,
                               C, e_start, e_local, st);
  return (int)launch_for<32>((E + 31) / 32, logits, w, idx, probs, slot, src,
                             load, prob_sum, z_sum, T, E, k, n_real, C,
                             e_start, e_local, st);
}
