// The MoE combine and its backward for Hopper (sm_90a), written by hand
// for the PyTorch port: each one launch a MoE layer call.
//
// Replaces, forward (combine_kernel): the gather, weighting and
// scatter-add of the experts' outputs back to the tokens,
// src/repro/models/moe.py:161-164 (_moe_local), which the reference
// leaves to XLA, and the port's eager chain for it (a zero row
// concatenated to the (E*C, d) outputs, an index_select of the T*k rows,
// a cast of w, a multiply and a sum):
//   y[t] = sum_j w[t, j] out[slot[t, j]]   over the kept choices
//          (slot < E*C), in choice order, summed in f32 and rounded once
//          to the outputs' dtype; a dropped choice contributes nothing.
// Backward (combine_bwd_kernel): autograd's chain over that combine and
// the router's backward (src/repro/kernels/ops.py:376, router_topk, which
// the reference differentiates with XLA; the port's moe_router.cu
// router_bwd_kernel), in one launch:
//   d_out[slot[t, j]] = w[t, j] dy[t]          (rounded to the dtype)
//   d_out[s]          = 0 where src[s] == T    (empty, or a padded expert)
//   dw[t, j]          = sum_d dy[t] out[slot[t, j]] (f32; 0 if dropped)
//   dlogits[t]        = repro_moe::router_bwd_row(..., dw[t], dprob_sum,
//                       dz_sum)                 (moe_router_common.cuh)
// dw never leaves the block that sums it.
//
// Layouts (all contiguous): out (E*C, d) and dy, y, d_out (T or E*C, d)
// in one dtype, f32 or bf16; w (T, k) f32, slot (T, k) int32 (E*C when
// dropped), src (E*C) int32 (T when empty); logits and probs (T, E) f32,
// idx (T, k) int32, dprob_sum (E) f32 and dz_sum (1) f32, each null for
// zero; dlogits (T, E) f32.  1 <= k <= min(E, 32), E <= 512.
//
// What bounds them on an H100: bytes.  At granite-moe-3b-a800m's training
// shape (T 1024, k 8, d 1536, E*C 40*256, bf16) the forward reads the
// kept rows of out (25.2 MB) and writes y (3.1 MB): 28.4 MB, 0.0085 ms at
// 3.35 TB/s; the backward reads dy and the kept rows of out and writes
// every row of d_out (31.5 MB) and dlogits: 60.4 MB, 0.018 ms.  A serving
// call (T 4 to 64, dropless) moves well under 1 MB: launch latency is its
// floor, so what the design saves first is launches (4 eager ones forward,
// about 8 backward with the router's).
//
// Design.  A block takes a token row, its threads 16-byte pieces of the
// row (8 bf16 or 4 f32 values; a row of d that is no multiple of 16
// bytes, or a pointer off 16 bytes, takes element loads instead).  A
// thread issues its loads of up to kBatch choices' rows before it adds
// any, so kBatch loads are in flight a thread, and adds them in choice
// order: the sum's order is fixed, and the same inputs give the same y
// on every run.  The backward's thread multiplies its dy piece by each
// w and stores d_out's row, and keeps each choice's partial dot product
// (kBatch choices at a time, which keeps its registers few enough for
// two or more blocks an SM); the k dots are summed by butterflies within
// each warp and then over the warps in warp order (shared memory), and
// warp 0 runs the router's row function on them, whose inputs it asked
// into L2 before the rows streamed (a decode-sized call is a chain of
// dependent loads, so its latency is the launch's).  No atomics: a kept slot belongs to exactly one (t,
// j), so every row of d_out is stored once.  Blocks past the T token rows
// each zero kZeroRows slot rows whose src is T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moe_router_common.cuh"

namespace {

constexpr int kMaxThreads = 256;  // threads a block, at most
constexpr int kBatch = 8;         // choices' loads in flight a thread
constexpr int kMaxK = 32;
constexpr int kZeroRows = 8;      // slot rows a zeroing block checks

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

// V values of T from one row, kept as loaded (a 16-byte piece is four
// registers) and read as f32: one 16-byte load where V * sizeof(T) is 16,
// else V element loads.
template <typename T, int V>
struct Piece {
  static constexpr bool kVec = V * sizeof(T) == 16;
  alignas(kVec ? 16 : alignof(T)) T e[V];
  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(p);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) e[i] = p[i];
    }
  }
  __device__ __forceinline__ float at(int i) const { return to_f32(e[i]); }
};

// f32 values v rounded to T and stored at p, as Piece loads them.
template <typename T, int V>
__device__ __forceinline__ void store_f32(T* __restrict__ p,
                                          const float (&v)[V]) {
  Piece<T, V> out;
#pragma unroll
  for (int i = 0; i < V; ++i) out.e[i] = from_f32<T>(v[i]);
  if constexpr (Piece<T, V>::kVec) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(out.e);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = out.e[i];
  }
}

// The 128-byte lines of [p, p + bytes) asked into L2, a line a lane.
__device__ __forceinline__ void prefetch_l2(const void* p, int bytes,
                                            int lane) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(p) & ~uintptr_t(127);
  const int lines =
      (int)((reinterpret_cast<uintptr_t>(p) + bytes - 1 - first) / 128) + 1;
  for (int i = lane; i < lines; i += 32)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(first + 128 * i));
}

// y[t] = sum over kept j of w[t, j] out[slot[t, j]]; block t, thread c
// the pieces c, c + blockDim, ... of the row (n_pieces = d / V).
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
combine_kernel(const T* __restrict__ out, const float* __restrict__ w,
               const int* __restrict__ slot, T* __restrict__ y, int d, int k,
               int n_slots) {
  __shared__ int s_slot[kMaxK];
  __shared__ float s_w[kMaxK];
  const int t = blockIdx.x;
  if (threadIdx.x < k) {
    s_slot[threadIdx.x] = slot[(size_t)t * k + threadIdx.x];
    s_w[threadIdx.x] = w[(size_t)t * k + threadIdx.x];
  }
  __syncthreads();
  const int n_pieces = d / V;
  for (int c = threadIdx.x; c < n_pieces; c += blockDim.x) {
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.f;
    for (int j0 = 0; j0 < k; j0 += kBatch) {
      Piece<T, V> row[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        if (j < k && s_slot[j] < n_slots)
          row[b].load(out + (size_t)s_slot[j] * d + (size_t)c * V);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        if (j < k && s_slot[j] < n_slots) {
#pragma unroll
          for (int i = 0; i < V; ++i)
            acc[i] = fmaf(s_w[j], row[b].at(i), acc[i]);
        }
      }
    }
    store_f32<T, V>(y + (size_t)t * d + (size_t)c * V, acc);
  }
}

// Blocks 0..T-1: token row t's d_out rows, dw and dlogits.  Blocks
// T..: kZeroRows slot rows each, zeroed where src is T.
template <typename T, int V, int PER_LANE>
__global__ void __launch_bounds__(kMaxThreads)
combine_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ out,
                   const float* __restrict__ logits,
                   const float* __restrict__ probs,
                   const int* __restrict__ idx, const float* __restrict__ w,
                   const int* __restrict__ slot, const int* __restrict__ src,
                   const float* __restrict__ dprob_sum,
                   const float* __restrict__ dz_sum, T* __restrict__ d_out,
                   float* __restrict__ dlogits, int n_tok, int d, int E,
                   int k, int n_real, int n_slots) {
  __shared__ int s_slot[kMaxK];
  __shared__ float s_w[kMaxK];
  __shared__ float s_dot[kMaxThreads / 32][kMaxK];
  const int n_pieces = d / V;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (blockIdx.x >= n_tok) {  // zero the empty slot rows
    const int s0 = (blockIdx.x - n_tok) * kZeroRows;
    float zero[V];
#pragma unroll
    for (int i = 0; i < V; ++i) zero[i] = 0.f;
    for (int s = s0; s < s0 + kZeroRows && s < n_slots; ++s) {
      if (src[s] != n_tok) continue;  // a kept slot: its token stores it
      for (int c = threadIdx.x; c < n_pieces; c += blockDim.x)
        store_f32<T, V>(d_out + (size_t)s * d + (size_t)c * V, zero);
    }
    return;
  }

  const int t = blockIdx.x;
  if (threadIdx.x < k) {
    s_slot[threadIdx.x] = slot[(size_t)t * k + threadIdx.x];
    s_w[threadIdx.x] = w[(size_t)t * k + threadIdx.x];
  }
  if (warp == 0) {  // the router row's inputs, into L2 while rows stream
    prefetch_l2(logits + (size_t)t * E, E * 4, lane);
    prefetch_l2(probs + (size_t)t * E, E * 4, lane);
    prefetch_l2(idx + (size_t)t * k, k * 4, lane);
    prefetch_l2(w + (size_t)t * k, k * 4, lane);
    if (dprob_sum) prefetch_l2(dprob_sum, E * 4, lane);
    if (dz_sum) prefetch_l2(dz_sum, 4, lane);
  }
  __syncthreads();
  // kBatch choices at a time: their rows' loads in flight together, then
  // each choice's dot summed over the thread's pieces, by a butterfly
  // within the warp, and over the warps in order (below)
  for (int j0 = 0; j0 < k; j0 += kBatch) {
    float dot[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) dot[b] = 0.f;
    for (int c = threadIdx.x; c < n_pieces; c += blockDim.x) {
      Piece<T, V> raw;
      raw.load(dy + (size_t)t * d + (size_t)c * V);
      Piece<T, V> row[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        if (j < k && s_slot[j] < n_slots)
          row[b].load(out + (size_t)s_slot[j] * d + (size_t)c * V);
      }
      float g[V];
#pragma unroll
      for (int i = 0; i < V; ++i) g[i] = raw.at(i);
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int j = j0 + b;
        if (j < k && s_slot[j] < n_slots) {
          float dst[V];
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < V; ++i) {
            dst[i] = s_w[j] * g[i];
            part = fmaf(g[i], row[b].at(i), part);
          }
          dot[b] += part;
          store_f32<T, V>(d_out + (size_t)s_slot[j] * d + (size_t)c * V,
                          dst);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (j0 + b < k) {
        const float v = repro_moe::warp_sum(dot[b]);
        if (lane == 0) s_dot[warp][j0 + b] = v;
      }
    }
  }
  __syncthreads();
  if (warp == 0) {
    float dwj = 0.f;
    if (lane < k) {
      const int n_warps = blockDim.x >> 5;
      for (int i = 0; i < n_warps; ++i) dwj += s_dot[i][lane];
    }
    repro_moe::router_bwd_row<PER_LANE>(logits, probs, idx, w, dwj,
                                        dprob_sum, dz_sum, dlogits, t, lane,
                                        E, k, n_real);
  }
}

// Threads a block for n_pieces pieces a row: whole warps, at most
// kMaxThreads, each thread about the same number of pieces.
int threads_for(int n_pieces) {
  const int rounds = (n_pieces + kMaxThreads - 1) / kMaxThreads;
  const int per_round = (n_pieces + rounds - 1) / rounds;
  const int t = (per_round + 31) / 32 * 32;
  return t < 32 ? 32 : t;
}

// 16-byte pieces where the row's bytes and every row pointer allow them.
bool vector_rows(int d, size_t elem, const void* const* ptrs, int n) {
  if ((d * elem) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return false;
  return true;
}

template <typename T>
int combine(const void* out, const float* w, const int* slot, void* y,
            int n_tok, int d, int k, int n_slots, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const void* rows[] = {out, y};
  const T* o = static_cast<const T*>(out);
  T* yy = static_cast<T*>(y);
  if (vector_rows(d, sizeof(T), rows, 2))
    combine_kernel<T, V><<<n_tok, threads_for(d / V), 0, st>>>(
        o, w, slot, yy, d, k, n_slots);
  else
    combine_kernel<T, 1><<<n_tok, threads_for(d), 0, st>>>(o, w, slot, yy,
                                                           d, k, n_slots);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int combine_bwd_v(const T* dy, const T* out, const float* logits,
                  const float* probs, const int* idx, const float* w,
                  const int* slot, const int* src, const float* dprob_sum,
                  const float* dz_sum, T* d_out, float* dlogits, int n_tok,
                  int d, int E, int k, int n_real, int n_slots,
                  cudaStream_t st) {
  const unsigned blocks =
      (unsigned)(n_tok + (n_slots + kZeroRows - 1) / kZeroRows);
  const int threads = threads_for(d / V);
  const int per_lane = (E + 31) / 32;
#define REPRO_COMBINE_BWD(P)                                               \
  combine_bwd_kernel<T, V, P><<<blocks, threads, 0, st>>>(                 \
      dy, out, logits, probs, idx, w, slot, src, dprob_sum, dz_sum, d_out, \
      dlogits, n_tok, d, E, k, n_real, n_slots);                           \
  return (int)cudaGetLastError()
  REPRO_PER_LANE(per_lane, REPRO_COMBINE_BWD);
#undef REPRO_COMBINE_BWD
}

template <typename T>
int combine_bwd(const void* dy, const void* out, const float* logits,
                const float* probs, const int* idx, const float* w,
                const int* slot, const int* src, const float* dprob_sum,
                const float* dz_sum, void* d_out, float* dlogits, int n_tok,
                int d, int E, int k, int n_real, int n_slots,
                cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const void* rows[] = {dy, out, d_out};
  const T* g = static_cast<const T*>(dy);
  const T* o = static_cast<const T*>(out);
  T* dst = static_cast<T*>(d_out);
  if (vector_rows(d, sizeof(T), rows, 3))
    return combine_bwd_v<T, V>(g, o, logits, probs, idx, w, slot, src,
                               dprob_sum, dz_sum, dst, dlogits, n_tok, d, E,
                               k, n_real, n_slots, st);
  return combine_bwd_v<T, 1>(g, o, logits, probs, idx, w, slot, src,
                             dprob_sum, dz_sum, dst, dlogits, n_tok, d, E, k,
                             n_real, n_slots, st);
}

bool bad_shape(int n_tok, int d, int k, int n_slots) {
  return n_tok <= 0 || d <= 0 || k < 1 || k > kMaxK || n_slots < 1;
}

}  // namespace

// The combine: y (n_tok, d) from out (n_slots, d), w and slot (n_tok, k);
// bf16 != 0 for __nv_bfloat16 rows, else float.  Returns
// cudaGetLastError().
extern "C" int repro_moe_combine(const void* out, const float* w,
                                 const int* slot, void* y, int n_tok, int d,
                                 int k, int n_slots, int bf16,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(n_tok, d, k, n_slots)) return (int)cudaErrorInvalidValue;
  return bf16 ? combine<__nv_bfloat16>(out, w, slot, y, n_tok, d, k,
                                       n_slots, st)
              : combine<float>(out, w, slot, y, n_tok, d, k, n_slots, st);
}

// The combine's backward with the router's: d_out (n_slots, d) in the
// rows' dtype and dlogits (n_tok, E) f32, from dy (n_tok, d), the
// forward's out, its routing (logits, probs, idx, w, slot, src) and the
// aux sums' upstream gradients (dprob_sum (E), dz_sum (1), each null for
// zero).  Returns cudaGetLastError().
extern "C" int repro_moe_combine_bwd(
    const void* dy, const void* out, const float* logits, const float* probs,
    const int* idx, const float* w, const int* slot, const int* src,
    const float* dprob_sum, const float* dz_sum, void* d_out, float* dlogits,
    int n_tok, int d, int E, int k, int n_real, int n_slots, int bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(n_tok, d, k, n_slots) || E <= 0 || k > E ||
      E > repro_moe::kMaxExperts || n_real < 1 || n_real > E)
    return (int)cudaErrorInvalidValue;
  return bf16 ? combine_bwd<__nv_bfloat16>(dy, out, logits, probs, idx, w,
                                           slot, src, dprob_sum, dz_sum,
                                           d_out, dlogits, n_tok, d, E, k,
                                           n_real, n_slots, st)
              : combine_bwd<float>(dy, out, logits, probs, idx, w, slot, src,
                                   dprob_sum, dz_sum, d_out, dlogits, n_tok,
                                   d, E, k, n_real, n_slots, st);
}
