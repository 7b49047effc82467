// RG-LRU recurrence for Hopper (sm_90a), written by hand for the PyTorch
// port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py
// (rglru_pallas, body _kernel).  Per batch row b and channel w, over time:
//   r, i   = sigmoid(r_gate), sigmoid(i_gate)
//   log a  = -8 softplus(lambda_w) r,  softplus(v) = max(v, 0) + log1p(exp(-|v|))
//   beta   = sqrt(max(1 - exp(2 log a), 1e-12))
//   h_t    = a h_{t-1} + (i x_t) beta
//
// Layouts (all contiguous): x, r_gate, i_gate, h (B, S, W) f32 or bf16;
// lambda (W,) f32; h0, h_final (B, W) f32; the wrapper's scratch: the
// chunk summaries (2, B, nc, W) f32; for training, the state entering
// each chunk (B, nc, W) f32, which the backward (rglru_bwd.cu) reads.
// All arithmetic in f32.
//
// What bounds it on an H100.  Three reads and one write an element against
// about a dozen operations: bound by bytes.  Channels are independent;
// time is a chain of (a, b) pairs under the associative
// (a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2).
//
// Design.  The TPU kernel's grid runs (b, channel block, time chunk) with
// the time axis sequential and the state in VMEM.  One thread per (b, w)
// carrying h through all S steps left 128 warps on 132 SMs at W 4096,
// B 1: too few loads in flight to cover the memory's latency.  Here time
// is cut into nc chunks of L steps, and each (row, chunk, channel) is a
// thread, in two launches:
//   1. rglru_chunk_summary runs its chunk from h = 0 and writes the
//      chunk's pair: A_c = prod a_t and its end state e_c;
//   2. rglru_chunk_apply folds the pairs of the chunks before its own
//      into the entering state, h_in = A_c' h_in + e_c' from h0 (at most
//      nc - 1 FMAs on values in L2), runs its chunk again from h_in,
//      writes h_t, and (last chunk) h_final; asked to keep them, it
//      also writes each chunk's entering state h_in.
// x and the gates are read twice, h written once: 7/4 of the bytes bound.
// A sequence of one chunk launches the second pass alone.  Threads of a
// warp take neighbouring channels, so every step's loads are coalesced;
// bf16 takes two channels a thread (__nv_bfloat162), so that a warp still
// reads 128 bytes a step; each thread keeps the next 8 elements of each
// input in flight while it computes the current ones.
//
// Rounding of the reassociation.  The sequential form multiplies h by
// each a_t in turn; here the entering state is multiplied by the chunk's
// product A_c (one rounding a step folded into the product), and the
// chunk's own contribution e_c is summed from zero.
#include <stddef.h>

#include "rglru_common.cuh"

namespace {

constexpr int kThreads = 64;  // threads a block
constexpr int kAhead = 8;     // elements of each input in flight a thread

struct Args {
  const void* x;
  const void* rg;
  const void* ig;
  const float* lam;
  const float* h0;  // null: zero state
  void* out;
  float* hf;
  float* sum_a;  // (B, nc, W): prod a over each chunk
  float* sum_e;  // (B, nc, W): each chunk's end state from h = 0
  float* states; // (B, nc, W): each chunk's entering state; null: not kept
  int B, S, W, L, nc;
};

// Runs steps [t0, t1) of V channels at element offset base (row b's
// first step, channel w) from h, multiplying each a into prod when
// kProd and storing each h_t when kStore.
template <typename T, int V, bool kProd, bool kStore>
__device__ __forceinline__ void run_steps(const Args& p, size_t base, int t0,
                                          int t1, const float (&coef)[V],
                                          float (&h)[V], float (&prod)[V]) {
  constexpr int U = kAhead / V;  // steps in flight
  const T* x = static_cast<const T*>(p.x);
  const T* rg = static_cast<const T*>(p.rg);
  const T* ig = static_cast<const T*>(p.ig);
  T* out = static_cast<T*>(p.out);
  const size_t W = (size_t)p.W;
  float xc[U][V], rc[U][V], ic[U][V];  // the steps being computed
  float xn[U][V], rn[U][V], in[U][V];  // the next steps, in flight
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int k = 0; k < V; ++k) xn[u][k] = rn[u][k] = in[u][k] = 0.f;
    if (t0 + u < t1) {
      const size_t g = base + (size_t)(t0 + u) * W;
      load_v<V>(x + g, xn[u]);
      load_v<V>(rg + g, rn[u]);
      load_v<V>(ig + g, in[u]);
    }
  }
  for (int s = t0; s < t1; s += U) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        xc[u][k] = xn[u][k];
        rc[u][k] = rn[u][k];
        ic[u][k] = in[u][k];
      }
      const int t = s + U + u;
      if (t < t1) {
        const size_t g = base + (size_t)t * W;
        load_v<V>(x + g, xn[u]);
        load_v<V>(rg + g, rn[u]);
        load_v<V>(ig + g, in[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = s + u;
      if (t < t1) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float log_a = coef[k] * sigmoid(rc[u][k]);
          const float a = expf(log_a);
          const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
          h[k] = a * h[k] + sigmoid(ic[u][k]) * xc[u][k] * beta;
          if (kProd) prod[k] *= a;
        }
        if (kStore) store_v<V>(out + base + (size_t)t * W, h);
      }
    }
  }
}

// The thread's row, chunk and first channel, and the channels' -8
// softplus(lambda); false past the last channel.
template <int V>
__device__ __forceinline__ bool locate(const Args& p, int& b, int& c,
                                       int& w, float (&coef)[V]) {
  w = (blockIdx.x * kThreads + threadIdx.x) * V;
  c = blockIdx.y;
  b = blockIdx.z;
  if (w >= p.W) return false;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    coef[k] = decay_coef(p.lam[w + k]);
  }
  return true;
}

// 1. each chunk's (prod a, end state from 0)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) rglru_chunk_summary(Args p) {
  int b, c, w;
  float coef[V];
  if (!locate<V>(p, b, c, w, coef)) return;
  float h[V], prod[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    h[k] = 0.f;
    prod[k] = 1.f;
  }
  const int t0 = c * p.L;
  run_steps<T, V, true, false>(p, (size_t)b * p.S * p.W + w, t0,
                               min(p.S, t0 + p.L), coef, h, prod);
  const size_t o = ((size_t)b * p.nc + c) * p.W + w;
  store_v<V>(p.sum_a + o, prod);
  store_v<V>(p.sum_e + o, h);
}

// 2. fold the earlier chunks' pairs into the entering state, then run the
// chunk from it, writing h_t (and h_final from the last chunk)
template <typename T, int V>
__global__ void __launch_bounds__(kThreads) rglru_chunk_apply(Args p) {
  int b, c, w;
  float coef[V];
  if (!locate<V>(p, b, c, w, coef)) return;
  float h[V], unused[V];
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = p.h0 ? p.h0[(size_t)b * p.W + w + k] : 0.f;
  for (int cc = 0; cc < c; ++cc) {
    const size_t o = ((size_t)b * p.nc + cc) * p.W + w;
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = fmaf(p.sum_a[o + k], h[k], p.sum_e[o + k]);
  }
  if (p.states) store_v<V>(p.states + ((size_t)b * p.nc + c) * p.W + w, h);
  const int t0 = c * p.L;
  run_steps<T, V, false, true>(p, (size_t)b * p.S * p.W + w, t0,
                               min(p.S, t0 + p.L), coef, h, unused);
  if (c == p.nc - 1) store_v<V>(p.hf + (size_t)b * p.W + w, h);
}

template <typename T, int V>
cudaError_t launch(const Args& p, cudaStream_t st) {
  const dim3 grid((p.W / V + kThreads - 1) / kThreads, p.nc, p.B);
  if (p.nc > 1) {
    rglru_chunk_summary<T, V><<<grid, kThreads, 0, st>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  rglru_chunk_apply<T, V><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One call of the RG-LRU over chunks of L steps: one launch when the
// sequence is one chunk, else two.  summ is the caller's f32 scratch of
// (2, B, nc, W), nc = ceil(S / L); unused (may be null) when nc == 1.
// states, when not null, takes each chunk's entering state (B, nc, W) f32.
// Returns the first non-zero cudaGetLastError() (0 = launched).
extern "C" int repro_rglru_fwd(const void* x, const void* rg, const void* ig,
                               const float* lam, const float* h0, void* out,
                               float* hf, float* summ, float* states,
                               int B, int S, int W,
                               int L, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || L <= 0) return (int)cudaErrorInvalidValue;
  Args p;
  p.x = x;
  p.rg = rg;
  p.ig = ig;
  p.lam = lam;
  p.h0 = h0;
  p.out = out;
  p.hf = hf;
  p.B = B;
  p.S = S;
  p.W = W;
  p.L = L;
  p.nc = (S + L - 1) / L;
  p.sum_a = summ;
  p.sum_e = summ ? summ + (size_t)B * p.nc * W : nullptr;
  p.states = states;
  if (p.nc > 65535 || B > 65535 || (p.nc > 1 && summ == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)(W % 2 == 0 ? launch<__nv_bfloat16, 2>(p, st)
                            : launch<__nv_bfloat16, 1>(p, st));
  return (int)launch<float, 1>(p, st);
}
