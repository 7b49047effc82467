// The RG-LRU recurrence's backward for Hopper (sm_90a), written by hand for
// the PyTorch port.
//
// The reference has no Pallas backward: it trains through XLA's autodiff
// of ops.rglru (src/repro/kernels/ops.py:326).  This is the backward of
// the forward kernels in rglru_scan.cu.  Per batch row b and channel w,
// with the gates given before their sigmoid:
//   sr, si = sigmoid(r_gate), sigmoid(i_gate)
//   log a  = coef sr, coef = -8 softplus(lambda_w)
//   beta   = sqrt(max(1 - a^2, 1e-12)),   h_t = a_t h_{t-1} + si x beta
// With g_t the gradient of h_t, run in reverse from the end
// (g_{S-1} = dh_{S-1} + dh_final, g_t = dh_t + a_{t+1} g_{t+1}):
//   dx     = g si beta,   di = g x beta si (1 - si)
//   dlog a = g h_{t-1} a - g si x a^2 / beta   (second term 0 where the
//            clamp binds, 1 - a^2 <= 1e-12)
//   dr     = dlog a coef sr (1 - sr)
//   dlam   = -8 sigmoid(lambda) sum_{b,t} dlog a sr
//
// Layouts (all contiguous, f32): x, r_gate, i_gate, dh and dx, dr_gate,
// di_gate (B, S, W); lambda, dlambda (W,); h0, dh_final (B, W), either
// null for zero; states (B, nc, W), the state entering each chunk that
// the forward kept (null when nc == 1: h0 enters); the wrapper's
// scratch: the chunk pairs (2, B, nc, W) (null when nc == 1) and the
// dlambda partials (B, nc, W).
//
// What bounds it on an H100.  Four reads and three writes an element
// against a few dozen operations: bound by bytes.
//
// Design.  The forward's split, run backwards.  Time is cut into chunks
// of kL steps (the forward's CHUNK) and each (row, chunk, channel) is a
// thread, so 8 x 128 at W 4096 puts 8 x 4 x 4096 threads in flight:
//   1. rglru_bwd_chunk_summary runs its chunk's reverse recurrence from
//      g = 0 and writes its pair: A_c = prod a_t over the chunk and
//      e_c = a g at the chunk's first step (what the chunk hands the
//      step before it: g_t reads a_{t+1}, which belongs to the next
//      chunk's first step, so a chunk carries its own first a);
//   2. rglru_bwd_chunk_apply folds the later chunks' pairs into the g
//      leaving its chunk, C = A_c' C + e_c' from dh_final, recomputes
//      h_{t-1} over the chunk from the kept entering state (kL values a
//      thread, in registers), runs the chunk in reverse and writes dx,
//      dr, di and its dlambda partial sum_t dlog a sr;
//   3. rglru_bwd_reduce sums each channel's partials over rows, then
//      chunks, in that fixed order.
// No atomics: two runs give equal bits.  x and r_gate are read three
// times, i_gate twice and dh twice (the later reads mostly from L2): 11
// element reads where the bound counts 4.  A sequence of one chunk skips
// the first launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;  // threads a block
constexpr int kL = 32;        // chunk length: kernels/rglru.py's CHUNK
constexpr float kC = 8.f;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

struct Args {
  const float* x;
  const float* rg;
  const float* ig;
  const float* lam;
  const float* h0;      // null: zero state
  const float* dh;      // null: zero
  const float* dhf;     // null: zero
  const float* states;  // null when nc == 1
  float* dx;
  float* drg;
  float* dig;
  float* dlam;
  float* sum_a;  // (B, nc, W): prod a over each chunk
  float* sum_e;  // (B, nc, W): a g at each chunk's first step, from g = 0
  float* part;   // (B, nc, W): the dlambda partials
  int B, S, W, nc;
};

// The thread's row, chunk and channel and the channel's -8
// softplus(lambda); false past the last channel.
__device__ __forceinline__ bool locate(const Args& p, int& b, int& c,
                                       int& w, float& coef) {
  w = blockIdx.x * kThreads + threadIdx.x;
  c = blockIdx.y;
  b = blockIdx.z;
  if (w >= p.W) return false;
  const float l = p.lam[w];
  coef = -kC * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  return true;
}

// 1. each chunk's (prod a, a g at its first step) from g = 0
__global__ void __launch_bounds__(kThreads) rglru_bwd_chunk_summary(Args p) {
  int b, c, w;
  float coef;
  if (!locate(p, b, c, w, coef)) return;
  const size_t W = (size_t)p.W;
  const size_t base = (size_t)b * p.S * W + w;
  const int t0 = c * kL, t1 = min(p.S, t0 + kL);
  float carry = 0.f, prod = 1.f;
  for (int t = t1 - 1; t >= t0; --t) {
    const size_t g = base + (size_t)t * W;
    const float a = expf(coef * sigmoid(p.rg[g]));
    const float gt = (p.dh ? p.dh[g] : 0.f) + carry;
    carry = a * gt;
    prod *= a;
  }
  const size_t o = ((size_t)b * p.nc + c) * W + w;
  p.sum_a[o] = prod;
  p.sum_e[o] = carry;
}

// 2. fold the later chunks' pairs into the g leaving this chunk,
// recompute h_{t-1} from the kept entering state, run the chunk in
// reverse
__global__ void __launch_bounds__(kThreads) rglru_bwd_chunk_apply(Args p) {
  int b, c, w;
  float coef;
  if (!locate(p, b, c, w, coef)) return;
  const size_t W = (size_t)p.W;
  const size_t base = (size_t)b * p.S * W + w;
  float carry = p.dhf ? p.dhf[(size_t)b * W + w] : 0.f;
  for (int cc = p.nc - 1; cc > c; --cc) {
    const size_t o = ((size_t)b * p.nc + cc) * W + w;
    carry = fmaf(p.sum_a[o], carry, p.sum_e[o]);
  }
  float h = p.states ? p.states[((size_t)b * p.nc + c) * W + w]
                     : (p.h0 ? p.h0[(size_t)b * W + w] : 0.f);
  const int t0 = c * kL, n = min(p.S - t0, kL);
  float hp[kL];  // h_{t-1} at each of the chunk's steps
#pragma unroll
  for (int k = 0; k < kL; ++k) {
    hp[k] = h;
    if (k < n) {
      const size_t g = base + (size_t)(t0 + k) * W;
      const float log_a = coef * sigmoid(p.rg[g]);
      const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
      h = expf(log_a) * h + sigmoid(p.ig[g]) * p.x[g] * beta;
    }
  }
  float part = 0.f;
#pragma unroll
  for (int k = kL - 1; k >= 0; --k) {
    if (k < n) {
      const size_t g = base + (size_t)(t0 + k) * W;
      const float sr = sigmoid(p.rg[g]), si = sigmoid(p.ig[g]);
      const float xv = p.x[g];
      const float log_a = coef * sr;
      const float a = expf(log_a);
      const float om = 1.f - expf(2.f * log_a);
      const float beta = sqrtf(fmaxf(om, 1e-12f));
      const float gt = (p.dh ? p.dh[g] : 0.f) + carry;
      float dla = gt * hp[k] * a;
      if (om > 1e-12f) dla -= gt * si * xv * a * a / beta;
      p.dx[g] = gt * si * beta;
      p.dig[g] = gt * xv * beta * si * (1.f - si);
      p.drg[g] = dla * coef * sr * (1.f - sr);
      part += dla * sr;
      carry = a * gt;
    }
  }
  p.part[((size_t)b * p.nc + c) * W + w] = part;
}

// 3. dlambda from the partials, summed over rows, then chunks
__global__ void __launch_bounds__(kThreads) rglru_bwd_reduce(Args p) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= p.W) return;
  float s = 0.f;
  for (int b = 0; b < p.B; ++b)
    for (int c = 0; c < p.nc; ++c)
      s += p.part[((size_t)b * p.nc + c) * p.W + w];
  p.dlam[w] = -kC * sigmoid(p.lam[w]) * s;
}

}  // namespace

// The backward of one RG-LRU call over chunks of kL steps: three launches,
// two when the sequence is one chunk.  pairs is the caller's f32 scratch
// of (2, B, nc, W), nc = ceil(S / kL), unused (may be null) when nc == 1;
// part (B, nc, W).  Returns the first non-zero cudaGetLastError()
// (0 = launched).
extern "C" int repro_rglru_bwd(const float* x, const float* rg,
                               const float* ig, const float* lam,
                               const float* h0, const float* dh,
                               const float* dhf, const float* states,
                               float* dx, float* drg, float* dig,
                               float* dlam, float* pairs, float* part, int B,
                               int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Args p;
  p.x = x;
  p.rg = rg;
  p.ig = ig;
  p.lam = lam;
  p.h0 = h0;
  p.dh = dh;
  p.dhf = dhf;
  p.states = states;
  p.dx = dx;
  p.drg = drg;
  p.dig = dig;
  p.dlam = dlam;
  p.part = part;
  p.B = B;
  p.S = S;
  p.W = W;
  p.nc = (S + kL - 1) / kL;
  p.sum_a = pairs;
  p.sum_e = pairs ? pairs + (size_t)B * p.nc * W : nullptr;
  if (p.nc > 65535 || B > 65535 || part == nullptr ||
      (p.nc > 1 && (pairs == nullptr || states == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((W + kThreads - 1) / kThreads, p.nc, B);
  if (p.nc > 1) {
    rglru_bwd_chunk_summary<<<grid, kThreads, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  rglru_bwd_chunk_apply<<<grid, kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rglru_bwd_reduce<<<dim3((W + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      p);
  return (int)cudaGetLastError();
}
