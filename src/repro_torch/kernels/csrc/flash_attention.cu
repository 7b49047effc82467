// Attention forward for Hopper (sm_90a), written by hand for the PyTorch port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel) and covers the two call sites the
// reference leaves to XLA: a prefill chunk at a scalar offset
// (ops._attention_chunked) and decode with one position per batch row
// (ops._attention_decode).  The offset arrives as an int32 (B,) device
// array; the Python wrapper broadcasts a scalar.
//
// Layouts (all contiguous): q, o (B, S, Hq, D); k, v (B, T, Hkv, D), k and
// v 16-byte aligned.
// GQA: q head h reads kv head h / (Hq / Hkv).
// Masks, as the reference oracle ref.attention_ref: key t is visible to a
// query at absolute position p = q_offset[b] + s when t < T and
//   causal:  t <= p, or t < prefix_len when a prefix is given;
//   window:  t > p - window.
// Numerics: f32 m, l and acc; scale 1/sqrt(D) before the tanh softcap;
// out = acc / max(l, 1e-30).
//
// Design.  One block of four warps per (query tile, q head, batch row);
// the block walks the key tiles itself, which on Hopper replaces the TPU
// grid's sequential key axis.  Each key tile of K and V is staged in shared
// memory as f32, read from device memory 16 bytes at a time with several
// loads in flight per thread (K rows padded by one word so lanes reading
// different keys hit different banks).  In a tile each lane owns one key for Q.K^T and
// then D/32 output columns for P.V, with the probabilities broadcast by
// warp shuffles; m, l and acc stay in registers.  Key tiles that are wholly
// masked for every row of the block (past the causal edge, before the
// window, past T) are never loaded.
//   * S > 16 (prefill, chunks): 16 query rows per block, 4 per warp, so
//     every staged key tile serves 16 rows; 32 keys per tile.
//   * S <= 16 (decode): one query row per block and the four warps split
//     a 128-key tile, merging their partial softmax states at the end, so
//     a decode row is not spread over a mostly empty 16-row tile.
// Simple first: no tensor cores, TMA or split-K across blocks yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_offset;
  int B, S, T, Hq, Hkv;
  int causal, window, prefix_len;  // prefix_len < 0: no prefix
  float softcap, scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 loaded bytes of T (4 f32 or 8 bf16) as f32 into shared memory; the
// third argument only selects T
__device__ __forceinline__ void unpack(const uint4& r, float* dst,
                                       const float*) {
  const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];
}
__device__ __forceinline__ void unpack(const uint4& r, float* dst,
                                       const __nv_bfloat16*) {
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
  for (int e = 0; e < 8; ++e) dst[e] = __bfloat162float(h[e]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// R query rows per warp; KSPLIT warps share one row group and split each
// key tile between them.
template <typename T, int D, int R, int KSPLIT>
__global__ void __launch_bounds__(kThreads) attn_fwd(Params p) {
  constexpr int RG = kWarps / KSPLIT;  // row groups per block
  constexpr int BQ = R * RG;           // query rows per block
  constexpr int BK = 32 * KSPLIT;      // keys per staged tile
  constexpr int U = (D + 31) / 32;     // output columns per lane
  constexpr int KS = D + 1;            // padded K row stride
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int kVecs = BK * D / kVec;  // 16-byte loads per K (V) tile
  constexpr int kBatch = 4;

  extern __shared__ float smem[];
  float* qs = smem;          // [BQ][D]
  float* ks = qs + BQ * D;   // [BK][KS]
  float* vs = ks + BK * KS;  // [BK][D]

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rg = warp / KSPLIT;
  const int kg = warp % KSPLIT;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int off = p.q_offset[b];

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int s = q0 + i / D;
    qs[i] = s < p.S
        ? load_f32(q + (((size_t)b * p.S + s) * p.Hq + h) * D + i % D)
        : 0.f;
  }

  // keys any row of this block can see
  const int pos_lo = off + q0;
  const int pos_hi = off + min(q0 + BQ, p.S) - 1;
  int k_begin = 0;
  int k_end = p.T;
  if (p.causal) {
    k_end = min(p.T, pos_hi + 1);
    if (p.prefix_len > 0) k_end = max(k_end, min(p.prefix_len, p.T));
  }
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);

  int qpos[R];
  float m[R], l[R], acc[R][U];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    qpos[i] = off + q0 + rg * R + i;
    m[i] = kNegInf;
    l[i] = 0.f;  // this lane's share of the row sum
#pragma unroll
    for (int u = 0; u < U; ++u) acc[i][u] = 0.f;
  }
  const float* qrow = qs + rg * R * D;
  __syncthreads();

  for (int kt = k_begin; kt < k_end; kt += BK) {
    // stage the K/V tile: 16-byte loads, kBatch of K and of V in flight
    // per thread before any is stored
    for (int base = 0; base < kVecs; base += kBatch * kThreads) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        const int t = kt + i * kVec / D;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < kVecs && t < p.T) {
          const size_t g =
              (((size_t)b * p.T + t) * p.Hkv + hk) * D + i * kVec % D;
          kr[u] = *reinterpret_cast<const uint4*>(k + g);
          vr[u] = *reinterpret_cast<const uint4*>(v + g);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + u * kThreads + tid;
        if (i < kVecs) {
          const int j = i * kVec / D;
          const int d = i * kVec % D;
          unpack(kr[u], ks + j * KS + d, k);
          unpack(vr[u], vs + j * D + d, v);
        }
      }
    }
    __syncthreads();

    // Q.K^T: this lane's key against the warp's R rows
    const int j = kg * 32 + lane;
    const int t = kt + j;
    const float* krow = ks + j * KS;
    float sc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sc[i] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int i = 0; i < R; ++i) sc[i] = fmaf(qrow[i * D + d], kd, sc[i]);
    }

    // online softmax update
    float pr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float x = sc[i] * p.scale;
      if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
      bool ok = t < p.T;
      if (p.causal) ok = ok && (t <= qpos[i] || t < p.prefix_len);
      if (p.window > 0) ok = ok && t > qpos[i] - p.window;
      const float m_new = fmaxf(m[i], warp_max(ok ? x : kNegInf));
      const float corr = expf(m[i] - m_new);
      pr[i] = ok ? expf(x - m_new) : 0.f;
      l[i] = l[i] * corr + pr[i];
#pragma unroll
      for (int u = 0; u < U; ++u) acc[i][u] *= corr;
      m[i] = m_new;
    }

    // P.V over this warp's 32 keys; lane owns columns lane + 32u
    const float* vtile = vs + kg * 32 * D;
#pragma unroll 4
    for (int jj = 0; jj < 32; ++jj) {
      float pj[R];
#pragma unroll
      for (int i = 0; i < R; ++i) pj[i] = __shfl_sync(kFull, pr[i], jj);
      const float* vrow = vtile + jj * D;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = lane + 32 * u;
        if (D % 32 == 0 || d < D) {
          const float vd = vrow[d];
#pragma unroll
          for (int i = 0; i < R; ++i) acc[i][u] = fmaf(pj[i], vd, acc[i][u]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < R; ++i) l[i] = warp_sum(l[i]);

  if (KSPLIT > 1) {
    // merge the key-split warps' partial states (the K/V tiles are free)
    float* ms = ks;                 // [KSPLIT][BQ]
    float* ls = ms + KSPLIT * BQ;   // [KSPLIT][BQ]
    float* as = ls + KSPLIT * BQ;   // [KSPLIT][BQ][D]
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = rg * R + i;
      if (lane == 0) {
        ms[kg * BQ + row] = m[i];
        ls[kg * BQ + row] = l[i];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = lane + 32 * u;
        if (D % 32 == 0 || d < D) as[(kg * BQ + row) * D + d] = acc[i][u];
      }
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = rg * R + i;
        float mt = kNegInf;
        for (int g = 0; g < KSPLIT; ++g) mt = fmaxf(mt, ms[g * BQ + row]);
        float lt = 0.f;
        float at[U];
#pragma unroll
        for (int u = 0; u < U; ++u) at[u] = 0.f;
        for (int g = 0; g < KSPLIT; ++g) {
          const float c = expf(ms[g * BQ + row] - mt);
          lt += ls[g * BQ + row] * c;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int d = lane + 32 * u;
            if (D % 32 == 0 || d < D) at[u] += as[(g * BQ + row) * D + d] * c;
          }
        }
        l[i] = lt;
#pragma unroll
        for (int u = 0; u < U; ++u) acc[i][u] = at[u];
      }
    }
  }

  if (kg != 0) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = q0 + rg * R + i;
    if (s >= p.S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (((size_t)b * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int d = lane + 32 * u;
      if (D % 32 == 0 || d < D) store_f32(orow + d, acc[i][u] / denom);
    }
  }
}

template <typename T, int D, int R, int KSPLIT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BQ = R * (kWarps / KSPLIT);
  constexpr int BK = 32 * KSPLIT;
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D);
  auto kernel = attn_fwd<T, D, R, KSPLIT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S + BQ - 1) / BQ, p.Hq, p.B);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.S <= 16) return launch<T, D, 1, kWarps>(p, stream);
  return launch<T, D, 4, 1>(p, stream);
}

template <typename T>
cudaError_t launch_dim(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(p, stream);
    case 32: return launch_rows<T, 32>(p, stream);
    case 64: return launch_rows<T, 64>(p, stream);
    case 128: return launch_rows<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_offset, int B, int S, int T, int Hq, int Hkv, int D,
    int is_bf16, int causal, int window, float softcap, int prefix_len,
    float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_offset = q_offset;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.causal = causal;
  p.window = window;
  p.prefix_len = prefix_len;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)launch_dim<__nv_bfloat16>(D, p, st);
  return (int)launch_dim<float>(D, p, st);
}
