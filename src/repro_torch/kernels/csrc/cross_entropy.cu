// The LM head's cross entropy for Hopper (sm_90a), written by hand for the
// PyTorch port: one launch a chunk of rows turns the chunk's logits into
// each row's lse, loss terms and, in place, the logits' gradient.
//
// Replaces no Pallas kernel: the reference's chunked_ce_loss
// (src/repro/models/common.py:203) is jnp that XLA fuses.  The port's eager
// chain for it formed each chunk's (B, c, V) logits in f32, ran
// logsumexp (amax, subtract, exp, sum) and a gather, formed all of it again
// under checkpoint in the backward, and added softmax·g and a scattered
// one-hot before casting back: about ten passes over f32 rows.  Per row r
// of the chunk (x its V logits, t its target, n the tokens counted):
//   c      = cap · tanh(x / cap)   (cap > 0; else c = x)        f32
//   lse    = log Σ_v exp(c_v)                                    f32
//   nll[r] = lse − c_t,  zsq[r] = lse²   (both 0 where t == ignore_id)
//   x_v   <- (exp(c_v − lse) · (1 + 2·z·lse) − [v == t]) / n
//            · (1 − tanh²(x_v / cap))  (under a softcap)
//            rounded once to x's dtype; 0 on a row whose t is ignore_id.
// A target below 0 (other than ignore_id) reads column 0, as the chain's
// clamp did; one at or past V traps, as the chain's gather asserted.
//
// Layouts: x (rows, V) contiguous, f32 or bf16, read and (with the
// gradient) overwritten; targets (rows) int64; n_tok one int64 on the
// device (no host sync); lse, nll, zsq (rows) f32.
//
// What bounds it on an H100: bytes.  At qwen1.5-0.5b's training chunk (R
// 4096 rows of V 151,936, bf16) the logits are 1.245 GB: read once and the
// gradient written once is 2.49 GB, 0.74 ms at 3.35 TB/s; the exps are
// 1.2e9 a chunk, well under the special-function units' rate.
//
// Design.  A block of 1024 threads a row, its threads 16-byte pieces of it
// (8 bf16 or 4 f32 values; the elements before the row's first 16-byte
// boundary and after its last are taken one by one, so any V works).  Pass
// 1 keeps each thread's running max and sum of exponentials (one rescale a
// piece, kUnroll pieces' loads in flight), merges them by butterflies
// within each warp and then over the warps in warp order, and thread 0
// reads the target's logit and writes the row's outputs.  Pass 2 reads the
// row again and stores the gradient over it.  A row is 304 KB at V 151,936,
// more than a block's shared memory, so pass 2 reads from memory again: it
// walks the row backwards, so that what pass 1 read last is read first, and
// its loads and stores are streaming (evict-first), which keeps the L2 for
// the rows still in pass 1.  At 1024 threads (54 registers) one block runs
// on an SM, so 132 rows (40 MB) are in flight and pass 2 finds much of its
// row in L2: 0.96 ms a chunk against 1.16 ms at 512 threads and 1.23 at
// 256 (H100 SXM, 700 W).  No atomics: every sum runs in a fixed order, and
// the same inputs give the same outputs on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // threads a block (a row): one block an SM
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;      // 16-byte loads in flight a thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The logit as the loss sees it: capped under a softcap (th is tanh(x /
// cap), kept for the gradient's factor).
template <bool kCap>
__device__ __forceinline__ float capped(float x, float cap, float& th) {
  if constexpr (kCap) {
    th = tanhf(x / cap);
    return cap * th;
  } else {
    return x;
  }
}

// (m, s) <- the merge of two running (max, sum of exp(v - max)) pairs; two
// empty ones (m = -inf) stay empty.
__device__ __forceinline__ void merge(float& m, float& s, float m2,
                                      float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * __expf(m - mn) + s2 * __expf(m2 - mn);
  m = mn;
}

// k values of one row absorbed into the running pair, one rescale for all.
template <int K>
__device__ __forceinline__ void absorb(const float (&v)[K], float& m,
                                       float& s) {
  float pm = v[0];
#pragma unroll
  for (int i = 1; i < K; ++i) pm = fmaxf(pm, v[i]);
  const float mn = fmaxf(m, pm);
  if (mn == -INFINITY) return;
  float acc = s * __expf(m - mn);
#pragma unroll
  for (int i = 0; i < K; ++i) acc += __expf(v[i] - mn);
  s = acc;
  m = mn;
}

// The gradient of one logit (see the head comment); a = (1 + 2 z lse) / n
// and b = 1 / n on a counted row, both 0 on an ignored one.
template <bool kCap>
__device__ __forceinline__ float grad_of(float x, bool is_t, float cap,
                                         float lse, float a, float b) {
  float th;
  const float c = capped<kCap>(x, cap, th);
  float g = __expf(c - lse) * a - (is_t ? b : 0.f);
  if constexpr (kCap) g *= 1.f - th * th;
  return g;
}

template <typename T, bool kCap, bool kGrad>
__global__ void __launch_bounds__(kThreads)
ce_kernel(T* __restrict__ x, const long long* __restrict__ targets,
          const long long* __restrict__ n_tok, float* __restrict__ lse_out,
          float* __restrict__ nll_out, float* __restrict__ zsq_out, int V,
          float cap, float z_coef, long long ignore_id) {
  constexpr int N = 16 / sizeof(T);
  constexpr int kStep = kUnroll * kThreads;
  __shared__ float s_m[kWarps], s_s[kWarps];
  __shared__ float s_lse, s_a, s_b;
  __shared__ int s_t;
  const int tid = threadIdx.x;
  T* row = x + (size_t)blockIdx.x * V;
  // the row's 16-byte-aligned body [head, tail) of nvec pieces
  const int mis = (int)((reinterpret_cast<uintptr_t>(row) & 15) / sizeof(T));
  const int head = min(mis ? N - mis : 0, V);
  const int nvec = (V - head) / N;
  const int tail = head + nvec * N;
  uint4* body = reinterpret_cast<uint4*>(row + head);

  // pass 1: the running (max, sum) of the thread's elements
  float m = -INFINITY, s = 0.f, th;
  if (tid < head) {
    const float v[1] = {capped<kCap>(to_f32(row[tid]), cap, th)};
    absorb(v, m, s);
  }
  if (tail + tid < V) {
    const float v[1] = {capped<kCap>(to_f32(row[tail + tid]), cap, th)};
    absorb(v, m, s);
  }
  for (int base = tid; base < nvec; base += kStep) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * kThreads < nvec) buf[u] = body[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * kThreads >= nvec) break;
      const T* e = reinterpret_cast<const T*>(&buf[u]);
      float v[N];
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] = capped<kCap>(to_f32(e[i]), cap, th);
      absorb(v, m, s);
    }
  }
  // the block's pair: within each warp, then over the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
          __shfl_xor_sync(0xffffffffu, s, o));
  if ((tid & 31) == 0) {
    s_m[tid >> 5] = m;
    s_s[tid >> 5] = s;
  }
  __syncthreads();
  if (tid < 32) {
    m = tid < kWarps ? s_m[tid] : -INFINITY;
    s = tid < kWarps ? s_s[tid] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      merge(m, s, __shfl_xor_sync(0xffffffffu, m, o),
            __shfl_xor_sync(0xffffffffu, s, o));
    if (tid == 0) {
      const float lse = m + logf(s);
      const long long t = targets[blockIdx.x];
      const bool valid = t != ignore_id;
      const long long ti = t < 0 ? 0 : t;
      if (valid && ti >= V) __trap();
      // every read of pass 1 is done (the barrier above): the target's
      // logit is still the logit
      const float ct = valid ? capped<kCap>(to_f32(row[ti]), cap, th) : 0.f;
      lse_out[blockIdx.x] = lse;
      nll_out[blockIdx.x] = valid ? lse - ct : 0.f;
      zsq_out[blockIdx.x] = valid ? lse * lse : 0.f;
      if constexpr (kGrad) {
        const float inv_n = 1.f / (float)(*n_tok);
        s_lse = lse;
        s_a = valid ? (1.f + 2.f * z_coef * lse) * inv_n : 0.f;
        s_b = valid ? inv_n : 0.f;
        s_t = valid ? (int)ti : -1;
      }
    }
  }
  if constexpr (!kGrad) return;
  __syncthreads();

  // pass 2: the gradient over the row, walked backwards
  const float lse = s_lse, a = s_a, b = s_b;
  const int t = s_t;
  if (tid < head)
    row[tid] = from_f32<T>(grad_of<kCap>(to_f32(row[tid]), tid == t, cap,
                                         lse, a, b));
  if (tail + tid < V)
    row[tail + tid] = from_f32<T>(grad_of<kCap>(
        to_f32(row[tail + tid]), tail + tid == t, cap, lse, a, b));
  if (tid >= nvec) return;
  for (int base = tid + (nvec - 1 - tid) / kStep * kStep; base >= 0;
       base -= kStep) {
    uint4 buf[kUnroll];
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u)
      if (base + u * kThreads < nvec)
        buf[u] = __ldcs(body + base + u * kThreads);
#pragma unroll
    for (int u = kUnroll - 1; u >= 0; --u) {
      const int i = base + u * kThreads;
      if (i >= nvec) continue;
      const T* e = reinterpret_cast<const T*>(&buf[u]);
      alignas(16) T out[N];
      const int col = head + i * N;
#pragma unroll
      for (int j = 0; j < N; ++j)
        out[j] = from_f32<T>(
            grad_of<kCap>(to_f32(e[j]), col + j == t, cap, lse, a, b));
      __stcs(body + i, *reinterpret_cast<const uint4*>(out));
    }
  }
}

template <typename T, bool kCap>
int launch(void* x, const long long* targets, const long long* n_tok,
           float* lse, float* nll, float* zsq, int rows, int V, float cap,
           float z_coef, long long ignore_id, int grad, cudaStream_t st) {
  T* xt = static_cast<T*>(x);
  if (grad)
    ce_kernel<T, kCap, true><<<rows, kThreads, 0, st>>>(
        xt, targets, n_tok, lse, nll, zsq, V, cap, z_coef, ignore_id);
  else
    ce_kernel<T, kCap, false><<<rows, kThreads, 0, st>>>(
        xt, targets, n_tok, lse, nll, zsq, V, cap, z_coef, ignore_id);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* x, const long long* targets, const long long* n_tok,
             float* lse, float* nll, float* zsq, int rows, int V, float cap,
             float z_coef, long long ignore_id, int grad, cudaStream_t st) {
  return cap > 0.f
             ? launch<T, true>(x, targets, n_tok, lse, nll, zsq, rows, V, cap,
                               z_coef, ignore_id, grad, st)
             : launch<T, false>(x, targets, n_tok, lse, nll, zsq, rows, V,
                                cap, z_coef, ignore_id, grad, st);
}

}  // namespace

// The cross entropy of rows (rows, V) of logits x, f32 or (bf16 != 0)
// bf16: lse, nll and zsq (rows) f32; with grad != 0 the logits' gradient
// over x.  softcap 0 is none; n_tok points at the int64 token count.
// Returns cudaGetLastError().
extern "C" int repro_cross_entropy(void* x, const long long* targets,
                                   const long long* n_tok, float* lse,
                                   float* nll, float* zsq, int rows, int V,
                                   float softcap, float z_coef,
                                   long long ignore_id, int grad, int bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || V <= 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  return bf16 ? dispatch<__nv_bfloat16>(x, targets, n_tok, lse, nll, zsq,
                                        rows, V, softcap, z_coef, ignore_id,
                                        grad, st)
              : dispatch<float>(x, targets, n_tok, lse, nll, zsq, rows, V,
                                softcap, z_coef, ignore_id, grad, st);
}
