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
// lambda (W,) f32; h0, h_final (B, W) f32.  All arithmetic in f32.
//
// What bounds it on an H100.  Three reads and one write an element against
// about a dozen operations: bound by bytes.  Time is sequential and the
// channels are independent.
//
// Design.  The TPU kernel's grid runs (b, channel block, time chunk) with
// the time axis sequential and the state in VMEM.  Here one thread per
// (b, w) carries h in a register through the whole sequence, so no state
// crosses blocks; threads of a warp take neighbouring channels, so each
// time step's loads are coalesced.  With W = 4096 and B <= 4 there are
// only 64-256 blocks of kThreads = 64, 128-512 warps (about 1-4 for each
// of the 132 SMs), on the card and nothing else to hide the memory
// latency, so each thread loads the next kU steps' x and gates into
// registers before it computes the current kU steps: a load per trip
// would leave the recurrence waiting on memory at every step.  Splitting
// time into chunks with a two-pass scan is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 64;  // channels a block
constexpr int kU = 8;         // time steps a thread has in flight
constexpr float kC = 8.f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_fwd(const T* __restrict__ x, const T* __restrict__ rg,
          const T* __restrict__ ig, const float* __restrict__ lam,
          const float* __restrict__ h0, T* __restrict__ out,
          float* __restrict__ hf, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= W) return;
  const float l = lam[w];
  const float c = -kC * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
  float h = h0 ? h0[(size_t)b * W + w] : 0.f;
  const size_t base = (size_t)b * S * W + w;

  float xc[kU], rc[kU], ic[kU];  // the steps being computed
  float xn[kU], rn[kU], in[kU];  // the next steps, in flight
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    xn[u] = rn[u] = in[u] = 0.f;
    if (u < S) {
      const size_t g = base + (size_t)u * W;
      xn[u] = load_f32(x + g);
      rn[u] = load_f32(rg + g);
      in[u] = load_f32(ig + g);
    }
  }
  for (int t0 = 0; t0 < S; t0 += kU) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      xc[u] = xn[u];
      rc[u] = rn[u];
      ic[u] = in[u];
      const int t = t0 + kU + u;
      if (t < S) {
        const size_t g = base + (size_t)t * W;
        xn[u] = load_f32(x + g);
        rn[u] = load_f32(rg + g);
        in[u] = load_f32(ig + g);
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t < S) {
        const float log_a = c * sigmoid(rc[u]);
        const float a = expf(log_a);
        const float beta = sqrtf(fmaxf(1.f - expf(2.f * log_a), 1e-12f));
        h = a * h + sigmoid(ic[u]) * xc[u] * beta;
        store_f32(out + base + (size_t)t * W, h);
      }
    }
  }
  hf[(size_t)b * W + w] = h;
}

template <typename T>
cudaError_t launch(const void* x, const void* rg, const void* ig,
                   const float* lam, const float* h0, void* out, float* hf,
                   int B, int S, int W, cudaStream_t st) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_fwd<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(rg),
      static_cast<const T*>(ig), lam, h0, static_cast<T*>(out), hf, S, W);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int repro_rglru_fwd(const void* x, const void* rg, const void* ig,
                               const float* lam, const float* h0, void* out,
                               float* hf, int B, int S, int W, int is_bf16,
                               void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return (int)launch<__nv_bfloat16>(x, rg, ig, lam, h0, out, hf, B, S, W,
                                      st);
  return (int)launch<float>(x, rg, ig, lam, h0, out, hf, B, S, W, st);
}
