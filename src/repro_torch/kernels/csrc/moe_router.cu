// MoE router top-k for Hopper (sm_90a), written by hand for the PyTorch port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_router.py
// (router_topk_pallas, body _kernel): per token row, a softmax over the E
// router logits, then k rounds of (max, lowest index holding it, mask),
// then the k weights renormalized by max(sum, 1e-9).
//
// Layouts (all contiguous): logits (T, E) f32 in; w (T, k) f32,
// idx (T, k) int32 and probs (T, E) f32 out.  1 <= k <= min(E, 32),
// E <= 32 * kMaxPerLane.
// Numerics, as the Pallas kernel: m = max, e = exp(x - m),
// probs = e / sum(e); round j takes the largest remaining probability and,
// among equal ones, the lowest expert index; the taken slot is set below
// every probability (-1e30); w = taken / max(sum of taken, 1e-9).
//
// What bounds it on an H100.  At serving shapes (T = 4 to 64 tokens,
// E = 40, k = 8) one call reads T*E*4 bytes and writes about as many: a
// few KB, some nanoseconds at 3.35 TB/s, against a few microseconds of
// launch.  Launch latency is its floor, not bytes or operations.
//
// Design.  The TPU kernel's 256-row VMEM block with a lane iota does not
// carry over.  Here one warp owns one token row: each lane keeps
// ceil(E/32) logits in registers (lane l holds experts l, l+32, ...), so
// the row is read once, coalesced, and never staged in shared memory.
// Max and sum are butterfly shuffles; each top-k round is a lane-local
// argmax followed by a shuffle argmax that breaks ties by index, and the
// lane that owns the winner masks it.  Lane j keeps round j's winner, so
// the k outputs are written by k lanes at once.  Four warps (rows) per
// block; one launch per call.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMasked = -1e30f;
constexpr int kMaxPerLane = 16;  // E <= 512

template <int PER_LANE>
__global__ void __launch_bounds__(32 * kWarps)
router_topk_kernel(const float* __restrict__ logits, float* __restrict__ w,
                   int* __restrict__ idx, float* __restrict__ probs, int T,
                   int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= T) return;  // whole warps leave together
  const float* x = logits + (size_t)row * E;

  float v[PER_LANE];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    v[j] = e < E ? x[e] : -INFINITY;
    m = fmaxf(m, v[j]);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, s));

  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    v[j] = lane + 32 * j < E ? expf(v[j] - m) : 0.f;
    sum += v[j];
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) sum += __shfl_xor_sync(kFull, sum, s);

  float* prow = probs + (size_t)row * E;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    if (e < E) {
      v[j] = v[j] / sum;
      prow[e] = v[j];
    } else {
      v[j] = -INFINITY;  // below every masked slot: never taken
    }
  }

  float mine_w = 0.f, wsum = 0.f;
  int mine_i = 0;
  for (int r = 0; r < k; ++r) {
    // lane-local: the largest value, the lowest index on ties (j ascends,
    // so a later slot wins only if strictly larger)
    float best = v[0];
    int bi = lane;
#pragma unroll
    for (int j = 1; j < PER_LANE; ++j) {
      if (v[j] > best) {
        best = v[j];
        bi = lane + 32 * j;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(kFull, best, s);
      const int oi = __shfl_xor_sync(kFull, bi, s);
      if (ob > best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    // every lane now holds the same (best, bi)
    if ((bi & 31) == lane) {
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j)
        if (lane + 32 * j == bi) v[j] = kMasked;
    }
    if (lane == r) {
      mine_w = best;
      mine_i = bi;
    }
    wsum += best;
  }
  if (lane < k) {
    w[(size_t)row * k + lane] = mine_w / fmaxf(wsum, 1e-9f);
    idx[(size_t)row * k + lane] = mine_i;
  }
}

template <int PER_LANE>
cudaError_t launch(const float* logits, float* w, int* idx, float* probs,
                   int T, int E, int k, cudaStream_t st) {
  const dim3 grid((T + kWarps - 1) / kWarps);
  router_topk_kernel<PER_LANE>
      <<<grid, 32 * kWarps, 0, st>>>(logits, w, idx, probs, T, E, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int repro_router_topk(const float* logits, float* w, int* idx,
                                 float* probs, int T, int E, int k,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 0 || E <= 0 || k < 1 || k > E || k > 32 ||
      E > 32 * kMaxPerLane)
    return (int)cudaErrorInvalidValue;
  const int per_lane = (E + 31) / 32;
  if (per_lane <= 1) return (int)launch<1>(logits, w, idx, probs, T, E, k, st);
  if (per_lane <= 2) return (int)launch<2>(logits, w, idx, probs, T, E, k, st);
  if (per_lane <= 4) return (int)launch<4>(logits, w, idx, probs, T, E, k, st);
  if (per_lane <= 8) return (int)launch<8>(logits, w, idx, probs, T, E, k, st);
  return (int)launch<16>(logits, w, idx, probs, T, E, k, st);
}
