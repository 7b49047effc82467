// What the RG-LRU's forward (rglru_scan.cu) and backward (rglru_bwd.cu)
// share: the gate arithmetic and the loads and stores of V neighbouring
// channels in f32 or bf16 (two bf16 channels move as one __nv_bfloat162).
// kernels/build.py hashes this header into both libraries' names, so an
// edit here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kC = 8.f;  // log a = -kC softplus(lambda) sigmoid(r_gate)

__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// -kC softplus(l), softplus(v) = max(v, 0) + log1p(exp(-|v|))
__device__ __forceinline__ float decay_coef(float l) {
  return -kC * (fmaxf(l, 0.f) + log1pf(expf(-fabsf(l))));
}

// V consecutive channels at p as f32
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = p[k];
}
template <int V>
__device__ __forceinline__ void load_v(const __nv_bfloat16* p,
                                       float (&v)[V]) {
  if constexpr (V == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = __bfloat162float(p[k]);
  }
}
template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) p[k] = v[k];
}
template <int V>
__device__ __forceinline__ void store_v(__nv_bfloat16* p,
                                        const float (&v)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) =
        __floats2bfloat162_rn(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = __float2bfloat16(v[k]);
  }
}

}  // namespace
