// Attention backward for Hopper (sm_90a), written by hand for the PyTorch port.
//
// The reference has no backward kernel: src/repro/kernels/ has no
// custom_vjp, and the reference trains through XLA's autodiff of
// ops.attention (src/repro/kernels/ops.py:44).  The port's forward is a
// hand-written kernel (flash_attention.cu, the port of the Pallas
// flash_attention), so its gradient is one too: FlashAttention-2's
// backward, in three launches.
//
// Layouts (all contiguous): q, o, dO, dq (B, S, Hq, D); k, v, dk, dv
// (B, T, Hkv, D); lse and delta (B, Hq, S) f32.  q head h reads kv head
// h / G, G = Hq / Hkv.  Masks as the forward's with q_offset 0: key t is
// visible to query s when t < T and
//   causal:  t <= s, or t < prefix_len when a prefix is given;
//   window:  t > s - window.
// The forward wrote lse = m + log l over the scaled and soft-capped logits
// x = c tanh(scale q.k / c) (x = scale q.k without a softcap); so
//   P  = exp(x - lse)                 (0 where masked, and on a row whose
//                                      lse is -1e30: it saw no key)
//   dV = P^T dO,  dP = dO V^T,  Delta = rowsum(dO o O)
//   dX = P (dP - Delta),  dZ = dX (1 - tanh^2(scale q.k / c)) (dX without
//                                      a softcap)
//   dQ = scale dZ K,  dK = scale dZ^T Q.
//
//   attn_bwd_pre:  Delta, one warp a (b, s, h) row, f32.
//   attn_bwd_dkdv: one block a (key tile, kv head, batch row).  K and V of
//     the tile stay in shared memory; the block walks the tiles of packed
//     (query, q head) rows of the GQA group (row r: query r / G, q head
//     hk * G + r % G, as the forward packs them) that can see the tile,
//     recomputes P and dX for each and accumulates dK and dV in registers.
//     The group's q heads are summed inside the block, so no atomics: the
//     result does not depend on the order blocks run in.
//   attn_bwd_dq: one block a (query tile, q head, batch row); walks the key
//     tiles its queries can see and accumulates dQ in registers.  No atomics.
//
// What bounds it on the H100: 14 D multiply-adds a visible (query, key)
// pair across the two kernels (Q.K^T and dO.V^T in each, then P^T dO and
// dZ^T Q, or dZ K), against bytes of q, k, v, o, dO, lse and dq, dk, dv
// read or written once: at the training shapes (a few hundred keys and
// more) operations, 989 TFLOP/s at bf16 on the tensor cores.  This first
// version runs on the CUDA cores in f32 (shared-memory tiles, a thread a
// few (row, key) scores, then a few (key or row, column) sums, columns
// across the lanes); putting the products on mma.sync / wgmma is later work.
// Inputs f32 or bf16; sums in f32; outputs in the inputs' dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kDeadLse = -1e29f;  // the forward writes -1e30 for a row
                                    // that saw no key

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Hq, S)
  float* delta;      // (B, Hq, S), written by attn_bwd_pre
  void* dq;
  void* dk;
  void* dv;
  int B, S, T, Hq, Hkv, G;
  int causal, window, prefix_len;  // prefix_len < 0: no prefix
  float softcap, scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const BwdParams& p, int s, int t) {
  if (s < 0 || s >= p.S || t >= p.T) return false;
  bool ok = true;
  if (p.causal) ok = t <= s || t < p.prefix_len;
  if (p.window > 0) ok = ok && t > s - p.window;
  return ok;
}

// Delta = rowsum(dO o O), one warp a row of O, in O's (b, s, h) order.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) attn_bwd_pre(BwdParams p) {
  const size_t row = ((size_t)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= (size_t)p.B * p.S * p.Hq) return;
  const T* o = static_cast<const T*>(p.o) + row * D;
  const T* dO = static_cast<const T*>(p.dout) + row * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc += to_f32(o[d]) * to_f32(dO[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) {
    const size_t h = row % p.Hq;
    const size_t bs = row / p.Hq;  // b * S + s
    p.delta[(bs / p.S * p.Hq + h) * p.S + bs % p.S] = acc;
  }
}

// One (BQ rows x BK keys) tile of scores from the staged tiles: qs, dos
// [BQ][D]; ks, vs [BK][D + 1] (padded: lanes reading different keys hit
// different banks); per row its query (-1: a padding row), lse and Delta.
// Warp w takes rows w * RW .. w * RW + RW - 1, lane l keys l + 32 c.
// Writes P (when ps is not null) and dZ, [BQ][BK].
template <int D, int BQ, int BK>
__device__ __forceinline__ void score_tile(
    const BwdParams& p, const float* qs, const float* dos, const float* ks,
    const float* vs, const int* qrow, const float* lse_s,
    const float* delta_s, int kt, float* ps, float* dzs) {
  constexpr int RW = BQ / kWarps;  // rows a warp
  constexpr int KL = BK / 32;      // keys a lane
  constexpr int KS = D + 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float x[RW][KL], dp[RW][KL];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int c = 0; c < KL; ++c) x[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float kd[KL], vd[KL];
#pragma unroll
    for (int c = 0; c < KL; ++c) {
      kd[c] = ks[(lane + 32 * c) * KS + d];
      vd[c] = vs[(lane + 32 * c) * KS + d];
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float qd = qs[(warp * RW + i) * D + d];
      const float od = dos[(warp * RW + i) * D + d];
#pragma unroll
      for (int c = 0; c < KL; ++c) {
        x[i][c] = fmaf(qd, kd[c], x[i][c]);
        dp[i][c] = fmaf(od, vd[c], dp[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp * RW + i;
    const float lse = lse_s[r];
    const bool live = lse > kDeadLse;
#pragma unroll
    for (int c = 0; c < KL; ++c) {
      const int j = lane + 32 * c;
      float z = x[i][c] * p.scale;
      float dfac = 1.f;
      if (p.softcap > 0.f) {
        const float th = tanhf(z / p.softcap);
        z = th * p.softcap;
        dfac = 1.f - th * th;
      }
      const float pr =
          live && visible(p, qrow[r], kt + j) ? expf(z - lse) : 0.f;
      if (ps != nullptr) ps[r * BK + j] = pr;
      dzs[r * BK + j] = pr * (dp[i][c] - delta_s[r]) * dfac;
    }
  }
}

// Shared memory of both kernels, in floats: K, V [BK][D + 1]; Q, dO
// [BQ][D]; P, dZ [BQ][BK]; lse, Delta and the query of each row [BQ].
template <int D, int BQ, int BK>
constexpr size_t smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * D + 2 * BQ * BK + 3 * BQ;
}

template <typename T, int D, int BK>
__device__ __forceinline__ void load_kv(const BwdParams& p, int b, int hk,
                                        int kt, float* ks, float* vs) {
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int i = threadIdx.x; i < BK * D; i += kThreads) {
    const int j = i / D;
    const int d = i % D;
    const int t = kt + j;
    const bool ok = t < p.T;
    const size_t g = (((size_t)b * p.T + (ok ? t : 0)) * p.Hkv + hk) * D + d;
    ks[j * (D + 1) + d] = ok ? to_f32(k[g]) : 0.f;
    vs[j * (D + 1) + d] = ok ? to_f32(v[g]) : 0.f;
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dkdv(BwdParams p) {
  constexpr int KW = BK / kWarps;  // keys a warp accumulates
  constexpr int U = D / 32;        // columns a lane
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * (D + 1);
  float* qs = vs + BK * (D + 1);
  float* dos = qs + BQ * D;
  float* ps = dos + BQ * D;
  float* dzs = ps + BQ * BK;
  float* lse_s = dzs + BQ * BK;
  float* delta_s = lse_s + BQ;
  int* qrow = reinterpret_cast<int*>(delta_s + BQ);

  const T* q = static_cast<const T*>(p.q);
  const T* dO = static_cast<const T*>(p.dout);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kt = blockIdx.x * BK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.G;

  load_kv<T, D, BK>(p, b, hk, kt, ks, vs);

  // the queries that can see a key of this tile: causal, from the tile's
  // first key on (from 0 when a key of the tile is in the prefix); with a
  // window, up to the tile's last key + window - 1
  int s_lo = 0;
  int s_hi = p.S - 1;
  if (p.causal && kt >= p.prefix_len) s_lo = kt;
  if (p.window > 0) s_hi = min(s_hi, min(kt + BK, p.T) - 1 + p.window - 1);
  const int r_lo = s_lo * G;
  const int r_hi = s_hi >= s_lo ? (s_hi + 1) * G : r_lo;

  float dk[KW][U], dv[KW][U];
#pragma unroll
  for (int c = 0; c < KW; ++c)
#pragma unroll
    for (int u = 0; u < U; ++u) dk[c][u] = dv[c][u] = 0.f;

  for (int r0 = r_lo; r0 < r_hi; r0 += BQ) {
    __syncthreads();  // K/V staged; the last tile's reads are done
    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = r0 + i / D;
      const bool ok = r < r_hi;
      const size_t g =
          (((size_t)b * p.S + (ok ? r / G : 0)) * p.Hq + hk * G + r % G) * D +
          i % D;
      qs[i] = ok ? to_f32(q[g]) : 0.f;
      dos[i] = ok ? to_f32(dO[g]) : 0.f;
    }
    for (int i = threadIdx.x; i < BQ; i += kThreads) {
      const int r = r0 + i;
      const bool ok = r < r_hi;
      const size_t li = ((size_t)b * p.Hq + hk * G + r % G) * p.S +
                        (ok ? r / G : 0);
      qrow[i] = ok ? r / G : -1;
      lse_s[i] = ok ? p.lse[li] : 0.f;
      delta_s[i] = ok ? p.delta[li] : 0.f;
    }
    __syncthreads();
    score_tile<D, BQ, BK>(p, qs, dos, ks, vs, qrow, lse_s, delta_s, kt, ps,
                          dzs);
    __syncthreads();
    // dV += P^T dO, dK += dZ^T Q: warp w owns keys w + 8 c, lane l the
    // columns l + 32 u
#pragma unroll 2
    for (int rr = 0; rr < BQ; ++rr) {
      float od[U], qd[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        od[u] = dos[rr * D + lane + 32 * u];
        qd[u] = qs[rr * D + lane + 32 * u];
      }
#pragma unroll
      for (int c = 0; c < KW; ++c) {
        const float pj = ps[rr * BK + warp + kWarps * c];
        const float zj = dzs[rr * BK + warp + kWarps * c];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          dv[c][u] = fmaf(pj, od[u], dv[c][u]);
          dk[c][u] = fmaf(zj, qd[u], dk[c][u]);
        }
      }
    }
  }

  T* dk_out = static_cast<T*>(p.dk);
  T* dv_out = static_cast<T*>(p.dv);
#pragma unroll
  for (int c = 0; c < KW; ++c) {
    const int t = kt + warp + kWarps * c;
    if (t >= p.T) continue;
    const size_t g = (((size_t)b * p.T + t) * p.Hkv + hk) * D;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      store(dk_out + g + lane + 32 * u, dk[c][u] * p.scale);
      store(dv_out + g + lane + 32 * u, dv[c][u]);
    }
  }
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) attn_bwd_dq(BwdParams p) {
  constexpr int RW = BQ / kWarps;  // rows a warp accumulates
  constexpr int U = D / 32;
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + BK * (D + 1);
  float* qs = vs + BK * (D + 1);
  float* dos = qs + BQ * D;
  float* dzs = dos + BQ * D + BQ * BK;  // (P's room is unused here)
  float* lse_s = dzs + BQ * BK;
  float* delta_s = lse_s + BQ;
  int* qrow = reinterpret_cast<int*>(delta_s + BQ);

  const T* q = static_cast<const T*>(p.q);
  const T* dO = static_cast<const T*>(p.dout);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.G;

  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int s = s0 + i / D;
    const bool ok = s < p.S;
    const size_t g =
        (((size_t)b * p.S + (ok ? s : 0)) * p.Hq + h) * D + i % D;
    qs[i] = ok ? to_f32(q[g]) : 0.f;
    dos[i] = ok ? to_f32(dO[g]) : 0.f;
  }
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const int s = s0 + i;
    const bool ok = s < p.S;
    const size_t li = ((size_t)b * p.Hq + h) * p.S + (ok ? s : 0);
    qrow[i] = ok ? s : -1;
    lse_s[i] = ok ? p.lse[li] : 0.f;
    delta_s[i] = ok ? p.delta[li] : 0.f;
  }

  // the keys any query of the tile can see, as the forward's
  const int s_hi = min(s0 + BQ, p.S) - 1;
  int k_begin = 0;
  int k_end = p.T;
  if (p.causal) {
    k_end = min(p.T, s_hi + 1);
    if (p.prefix_len > 0) k_end = max(k_end, min(p.prefix_len, p.T));
  }
  if (p.window > 0) k_begin = max(0, s0 - p.window + 1);

  float dq[RW][U];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int u = 0; u < U; ++u) dq[i][u] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // Q staged; the last tile's reads are done
    load_kv<T, D, BK>(p, b, hk, kt, ks, vs);
    __syncthreads();
    score_tile<D, BQ, BK>(p, qs, dos, ks, vs, qrow, lse_s, delta_s, kt,
                          nullptr, dzs);
    __syncthreads();
    // dQ += dZ K: warp w owns rows w * RW + i, lane l the columns l + 32 u
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float kd[U];
#pragma unroll
      for (int u = 0; u < U; ++u) kd[u] = ks[j * (D + 1) + lane + 32 * u];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float zj = dzs[(warp * RW + i) * BK + j];
#pragma unroll
        for (int u = 0; u < U; ++u) dq[i][u] = fmaf(zj, kd[u], dq[i][u]);
      }
    }
  }

  T* dq_out = static_cast<T*>(p.dq);
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int s = s0 + warp * RW + i;
    if (s >= p.S) continue;
    const size_t g = (((size_t)b * p.S + s) * p.Hq + h) * D;
#pragma unroll
    for (int u = 0; u < U; ++u)
      store(dq_out + g + lane + 32 * u, dq[i][u] * p.scale);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Tiles: 64 rows x 64 keys at head_dim 64 (100 KB of shared memory, two
// blocks an SM), 32 x 32 above (74 KB at 128, 140 KB at 256).
template <typename T, int D>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int BQ = D <= 64 ? 64 : 32;
  constexpr int BK = BQ;
  static_assert(D % 32 == 0 && BQ % kWarps == 0 && BK % 32 == 0 &&
                    BK % kWarps == 0,
                "tile shape");
  const size_t rows = (size_t)p.B * p.S * p.Hq;
  attn_bwd_pre<T, D><<<(unsigned)((rows * 32 + kThreads - 1) / kThreads),
                       kThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const size_t smem = sizeof(float) * smem_floats<D, BQ, BK>();
  auto dkdv = attn_bwd_dkdv<T, D, BQ, BK>;
  auto dq = attn_bwd_dq<T, D, BQ, BK>;
  if ((e = allow_smem(dkdv, smem)) != cudaSuccess) return e;
  if ((e = allow_smem(dq, smem)) != cudaSuccess) return e;
  dkdv<<<dim3((p.T + BK - 1) / BK, p.Hkv, p.B), kThreads, smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dq<<<dim3((p.S + BQ - 1) / BQ, p.Hq, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const BwdParams& p, cudaStream_t stream) {
  switch (D) {
    case 64: return launch_bwd<T, 64>(p, stream);
    case 128: return launch_bwd<T, 128>(p, stream);
    case 256: return launch_bwd<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launches' cudaGetLastError() (0 = launched): attn_bwd_pre,
// attn_bwd_dkdv and attn_bwd_dq, in order, on ``stream``.  delta is the
// wrapper's (B, Hq, S) f32 scratch.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int S, int T, int Hq, int Hkv, int D, int is_bf16,
    int causal, int window, float softcap, int prefix_len, float scale,
    void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.causal = causal;
  p.window = window;
  p.prefix_len = prefix_len;
  p.softcap = softcap;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? (int)launch_dim<bf16>(D, p, st)
                 : (int)launch_dim<float>(D, p, st);
}
