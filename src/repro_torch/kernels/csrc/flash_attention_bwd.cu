// Attention backward for Hopper (sm_90a), written by hand for the PyTorch port.
//
// Serves the backward of B1, the attention forward (flash_attention.cu, the
// port of the Pallas flash_attention).  The reference has no backward
// kernel: src/repro/kernels/ has no custom_vjp, and the reference trains
// through XLA's autodiff of ops.attention (src/repro/kernels/ops.py:44).
// The port's forward is a hand-written kernel, so its gradient is one too:
// FlashAttention-2's backward.
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
// Sums in f32; outputs in the inputs' dtype.  No atomics on either route:
// every output element is summed by one thread in a fixed order, so two
// calls give the same bits.
//
// What bounds it on the H100 (attn_bwd_bound in chip_smoke.py): 7 D
// multiply-adds a visible (query, key) pair and q head over both kernels
// (Q.K^T and dO.V^T in each, then P^T dO and dZ^T Q, or dZ K), against the
// bytes of
// q, k, v, o, dO, lse and dq, dk, dv read or written once: at the training
// shapes (a few hundred keys and more) operations, 989 TFLOP/s of bf16 on
// the tensor cores; under MQA also how few (key tile, kv head, batch row)
// blocks the dK/dV grid has for 132 SMs.
//
// Two routes, chosen by dtype (the wrapper's bwd_plan()), never by failure:
//
// bf16, every training path: the tensor cores, two launches (three when
// split), in this order:
//   attn_bwd_dq_tc: one block of 4 warps a (64 packed rows, kv head, batch
//     row), rows packed as the forward packs them (row r: query r / G of q
//     head hk * G + r % G).  It first writes Delta of its own rows (from
//     the dO tile it holds and O), for itself and for attn_bwd_dkdv_tc,
//     which is why it runs first.  K/V tiles stream through a two-stage
//     cp.async ring in swizzled bf16 shared memory; S = Q.K^T and
//     dP = dO.V^T run as mma.sync m16n8k16 bf16 -> f32 tiles, P and dZ stay
//     in registers, and dZ, rounded to bf16, is the A operand of
//     dQ += dZ.K without leaving them (each warp owns 16 rows).
//   attn_bwd_dkdv_tc: one block of 8 warps a (64-key tile, kv head, batch
//     row, split).  K and V of the tile stay in shared memory; the block
//     walks the packed rows of the GQA group that can see the tile, Q, dO,
//     lse and Delta streaming through the ring, 64 rows a tile.  For each:
//     S^T = K.Q^T and dP^T = V.dO^T (warp: 16 keys x 32 rows), P^T and dZ^T
//     in f32 registers, then rounded to bf16 into shared memory, and
//     dV += P^T.dO, dK += dZ^T.Q (warp: 16 keys x D/2 columns, f32
//     accumulators in registers: 128 a thread at D 256, which is why the
//     8 warps split the columns in two rather than each owning all of D).
//     The group's q heads are summed inside the block.
//   attn_bwd_dkdv_reduce: under MQA the dK/dV grid is short of the card
//     (recurrentgemma's 8 x 128: 16 blocks); then the wrapper gives
//     n_split > 1 and each block takes one contiguous range of the row
//     tiles that can see its key tile and writes f32 partial dK (scaled)
//     and dV to scratch (n_split, 2, B, T, Hkv, D); this pass sums them in
//     the order z = 0 .. n_split - 1 and writes dk and dv in bf16.
//   Every block computes the rows or keys it can see from the mask alone
//   (causal, window, prefix, non-causal, S != T); tiles every row has
//   masked away are never loaded, and masks are applied element by
//   element only on tiles that cross a mask edge or the end of the keys.
//   Tile shapes, as an H100 timed them (tools/attention_bwd_tuning.py): dQ
//   key tiles of 32 keys at head_dim 64 (64 were slower), 64 at 128 and 16
//   at 256 (32 keys hold 128 KB of shared memory and one block an SM);
//   two dK/dV blocks an SM at head_dim 64 (registers capped at 128; one
//   was ~20% slower).  P^T and dZ^T kept in registers at head_dim <= 128
//   (the warps then splitting rows, not columns, in phase 2) and dQ's Q
//   and dO fragments kept in registers were no faster, and were dropped.
//
// f32, the parity dtype: the CUDA cores, three launches (the tensor cores'
// f32 route is TF32, whose 10 mantissa bits break the f32 gradients' 1e-4):
//   attn_bwd_pre:  Delta, one warp a (b, s, h) row.
//   attn_bwd_dkdv: one block a (key tile, kv head, batch row).  K and V of
//     the tile stay in shared memory; the block walks the tiles of packed
//     rows of the GQA group that can see the tile, recomputes P and dX for
//     each and accumulates dK and dV in registers.
//   attn_bwd_dq: one block a (query tile, q head, batch row); walks the key
//     tiles its queries can see and accumulates dQ in registers.
//   Shared-memory tiles in f32, a thread a few (row, key) scores, then a
//   few (key or row, column) sums, columns across the lanes.
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


// ---------------------------------------------------------------------------
// bf16: tensor cores (attn_bwd_dq_tc, attn_bwd_dkdv_tc, attn_bwd_dkdv_reduce)
// ---------------------------------------------------------------------------
constexpr int kTcRows = 64;        // packed rows: a dQ block, a dK/dV row tile
constexpr int kTcKeys = 64;        // keys a dK/dV block (the wrapper's
                                   // DKDV_KEYS)
constexpr int kDqThreads = 128;    // 4 warps x 16 rows
constexpr int kDkdvThreads = 256;  // 8 warps: 4 x 16 keys, each in 2 halves
constexpr float kLog2e = 1.4426950408889634f;

struct TcBwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* o;
  const bf16* dout;
  const float* lse;  // (B, Hq, S)
  float* delta;      // (B, Hq, S): written by attn_bwd_dq_tc
  bf16* dq;
  bf16* dk;
  bf16* dv;
  float* dkv_part;   // n_split > 1: (n_split, 2, B, T, Hkv, D) f32
  int B, S, T, Hq, Hkv, G, n_split;
  int causal, window, prefix_len;  // prefix_len < 0: no prefix
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) . b (16x8, col); bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Element offset of (row, 16-byte chunk) in a [rows][W] bf16 tile whose
// chunks are XOR-swizzled, as the forward's: the 8 rows one ldmatrix
// phase reads at one logical chunk land in 8 different 16-byte slots of
// the 128-byte bank window (rows of W < 64 share a window, hence the
// shift).
template <int W>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = W / 8;
  constexpr int kMask = C < 8 ? C - 1 : 7;
  constexpr int kShift = C >= 8 ? 0 : (C == 4 ? 1 : 2);
  return row * W + ((chunk ^ ((row >> kShift) & kMask)) << 3);
}

__device__ __forceinline__ bool key_visible(const TcBwdParams& p, int s,
                                            int t) {
  bool ok = t < p.T;
  if (p.causal) ok = ok && (t <= s || t < p.prefix_len);
  if (p.window > 0) ok = ok && t > s - p.window;
  return ok;
}

// Every (query in [s_lo, s_hi], key in [k0, k1)) pair visible: the tile
// needs no mask element by element.
__device__ __forceinline__ bool all_visible(const TcBwdParams& p, int s_lo,
                                            int s_hi, int k0, int k1) {
  if (k1 > p.T) return false;
  if (p.causal && k1 - 1 > s_lo && k1 - 1 >= p.prefix_len) return false;
  if (p.window > 0 && k0 <= s_hi - p.window) return false;
  return true;
}

// the row's lse in base 2, +inf for a row past the range or one that saw no
// key: exp2(x log2 e - lse2) is then 0 for every key, and so is its dZ
__device__ __forceinline__ float lse_base2(float lse, bool ok) {
  return ok && lse > kDeadLse ? lse * kLog2e : __int_as_float(0x7f800000);
}

// P and dZ of one score from S (q.k) and dP, in place: P = exp(x - lse),
// dZ = P (dP - Delta) (1 - tanh^2); masked (when mask) to 0.
__device__ __forceinline__ void p_and_dz(const TcBwdParams& p, float& s_p,
                                         float& dp_dz, float lse2,
                                         float delta, bool masked) {
  float x = s_p * p.scale;
  float dfac = 1.f;
  if (p.softcap > 0.f) {
    const float th = tanhf(x / p.softcap);
    x = th * p.softcap;
    dfac = 1.f - th * th;
  }
  const float pe = masked ? 0.f : exp2f(x * kLog2e - lse2);
  s_p = pe;
  dp_dz = pe * (dp_dz - delta) * dfac;
}

template <int D, int BK>
__global__ void __launch_bounds__(kDqThreads) attn_bwd_dq_tc(TcBwdParams p) {
  constexpr int C = D / 8;   // 16-byte chunks a row
  constexpr int NT = BK / 8; // 8-key column tiles of S
  constexpr int DT = D / 8;  // 8-wide column tiles of dQ
  static_assert(BK % 16 == 0 && DT % 2 == 0 && C <= 32, "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][D]
  bf16* dos = qs + kTcRows * D;                  // [64][D]
  bf16* kvs = dos + kTcRows * D;  // stage s: K [BK][D] at 2*s*BK*D, then V
  float* delta_s = reinterpret_cast<float*>(kvs + 2 * 2 * BK * D);  // [64]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment row within 8
  const int tq = lane & 3;  // the fragment column pair
  const int mi = lane >> 3; // the 8x8 matrix this lane addresses
  const int hk = blockIdx.y % p.Hkv;
  const int b = blockIdx.y / p.Hkv;
  const int G = p.G;
  const int rows = p.S * G;
  // row tiles in reverse: under a causal mask the last rows see the most
  // keys, and the blocks the card starts first should be the longest
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int rb = warp * 16;  // the warp's first row of the tile

  auto row_src = [&](int r) {  // (b, s, h) element offset of packed row r
    return (((size_t)b * p.S + r / G) * p.Hq + hk * G + r % G) * D;
  };
  for (int i = tid; i < kTcRows * C; i += kDqThreads) {
    const int rr = i / C;
    const int c = i % C;
    const int r = r0 + rr;
    const bool ok = r < rows;
    const size_t src = (ok ? row_src(r) : 0) + c * 8;
    cp_async16(smem_u32(qs + swz<D>(rr, c)), p.q + src, ok);
    cp_async16(smem_u32(dos + swz<D>(rr, c)), p.dout + src, ok);
  }
  cp_async_commit();

  // the keys any row of this block can see, as the forward's
  const int s_lo = r0 / G;
  const int s_hi = (min(r0 + kTcRows, rows) - 1) / G;
  int k_begin = 0;
  int k_end = p.T;
  if (p.causal) {
    k_end = min(p.T, s_hi + 1);
    if (p.prefix_len > 0) k_end = max(k_end, min(p.prefix_len, p.T));
  }
  if (p.window > 0) k_begin = max(0, s_lo - p.window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_kv = [&](int kt, int stage) {
    bf16* ks = kvs + 2 * stage * BK * D;
    bf16* vs = ks + BK * D;
    for (int i = tid; i < BK * C; i += kDqThreads) {
      const int j = i / C;
      const int c = i % C;
      const int t = kt + j;
      const bool ok = t < p.T;
      const size_t src =
          (((size_t)b * p.T + (ok ? t : 0)) * p.Hkv + hk) * D + c * 8;
      cp_async16(smem_u32(ks + swz<D>(j, c)), p.k + src, ok);
      cp_async16(smem_u32(vs + swz<D>(j, c)), p.v + src, ok);
    }
  };
  if (n_tiles > 0) load_kv(k_begin, 0);
  cp_async_commit();

  // Delta = rowsum(dO o O) of the block's rows, C lanes a row
  cp_async_wait<1>();  // the Q and dO tiles
  __syncthreads();
  for (int i = tid; i < kTcRows * C; i += kDqThreads) {
    const int rr = i / C;
    const int c = i % C;
    const int r = r0 + rr;
    float acc = 0.f;
    if (r < rows) {
      const uint4 ov = *reinterpret_cast<const uint4*>(p.o + row_src(r) +
                                                       c * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(dos + swz<D>(rr, c));
      const __nv_bfloat162* oa = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* da = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(oa[e]);
        const float2 df = __bfloat1622float2(da[e]);
        acc = fmaf(of.x, df.x, acc);
        acc = fmaf(of.y, df.y, acc);
      }
    }
#pragma unroll
    for (int off = C / 2; off > 0; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (c == 0) {
      delta_s[rr] = acc;
      if (r < rows)
        p.delta[((size_t)b * p.Hq + hk * G + r % G) * p.S + r / G] = acc;
    }
  }
  __syncthreads();

  // this thread's two fragment rows: rb + g and rb + g + 8
  int spos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rb + g + 8 * i;
    const bool ok = r < rows;
    spos[i] = ok ? r / G : 0;
    lse2[i] = lse_base2(
        ok ? p.lse[((size_t)b * p.Hq + hk * G + r % G) * p.S + r / G] : 0.f,
        ok);
    dlt[i] = delta_s[rb + g + 8 * i];
  }
  const bool warp_live = r0 + rb < rows;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      load_kv(kt + BK, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (warp_live) {
      const bf16* ks = kvs + 2 * (it & 1) * BK * D;
      const bf16* vs = ks + BK * D;
      // S = Q.K^T and dP = dO.V^T, 16 rows x BK keys a warp
      float sc[NT][4], dp[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4], ad[4];
        const int arow = rb + (lane & 15);
        const int achunk = 2 * kk + (lane >> 4);
        ldsm_x4(smem_u32(qs + swz<D>(arow, achunk)), a);
        ldsm_x4(smem_u32(dos + swz<D>(arow, achunk)), ad);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          const int brow = nt * 8 + (mi >> 1) * 8 + (lane & 7);
          const int bchunk = 2 * kk + (mi & 1);
          uint32_t bk[4], bv[4];
          ldsm_x4(smem_u32(ks + swz<D>(brow, bchunk)), bk);
          ldsm_x4(smem_u32(vs + swz<D>(brow, bchunk)), bv);
          mma_bf16(sc[nt], a, bk[0], bk[1]);
          mma_bf16(sc[nt + 1], a, bk[2], bk[3]);
          mma_bf16(dp[nt], ad, bv[0], bv[1]);
          mma_bf16(dp[nt + 1], ad, bv[2], bv[3]);
        }
      }
      const bool edge = !all_visible(p, s_lo, s_hi, kt, kt + BK);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int t = kt + nt * 8 + 2 * tq + (e & 1);
          p_and_dz(p, sc[nt][e], dp[nt][e], lse2[i], dlt[i],
                   edge && !key_visible(p, spos[i], t));
        }
      // dQ += dZ.K: dZ's accumulators, as bf16, are the A fragments
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const float(&z0)[4] = dp[2 * kk];
        const float(&z1)[4] = dp[2 * kk + 1];
        const uint32_t a[4] = {
            pack_bf16(z0[0], z0[1]), pack_bf16(z0[2], z0[3]),
            pack_bf16(z1[0], z1[1]), pack_bf16(z1[2], z1[3])};
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t bk[4];
          ldsm_x4_t(smem_u32(ks + swz<D>(kk * 16 + (mi & 1) * 8 + (lane & 7),
                                         dt + (mi >> 1))),
                    bk);
          mma_bf16(acc[dt], a, bk[0], bk[1]);
          mma_bf16(acc[dt + 1], a, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // the next copy overwrites this stage
  }
  cp_async_wait<0>();  // when this block had no tile

  if (!warp_live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rb + g + 8 * i;
    if (r >= rows) continue;
    bf16* out = p.dq + row_src(r) + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) =
          __floats2bfloat162_rn(acc[dt][2 * i] * p.scale,
                                acc[dt][2 * i + 1] * p.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kDkdvThreads, D <= 64 ? 2 : 1)
    attn_bwd_dkdv_tc(TcBwdParams p) {
  constexpr int BR = kTcRows;   // packed rows a tile
  constexpr int C = D / 8;      // 16-byte chunks a row
  constexpr int RT = BR / 16;   // 8-row column tiles of a warp's S^T (its
                                // half of the tile's rows)
  constexpr int DT = D / 16;    // 8-wide tiles of a warp's half of dK, dV
  static_assert(RT % 2 == 0 && DT % 2 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][D]
  bf16* vs = ks + kTcKeys * D;                   // [64][D]
  bf16* rowbuf = vs + kTcKeys * D;  // stage s: Q [BR][D] at 2*s*BR*D, then dO
  bf16* pts = rowbuf + 2 * 2 * BR * D;  // P^T [64 keys][BR rows]
  bf16* dzts = pts + kTcKeys * BR;      // dZ^T [64 keys][BR rows]
  float* lds = reinterpret_cast<float*>(dzts + kTcKeys * BR);
  // lds, stage s: lse [BR] at 2*s*BR, then Delta [BR]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int mi = lane >> 3;
  const int kg = warp & 3;   // the warp's 16 keys of the tile
  const int hf = warp >> 2;  // its half: of the rows in S^T, of D in dK/dV
  const int kt = blockIdx.x * kTcKeys;
  const int hk = blockIdx.y % p.Hkv;
  const int b = blockIdx.y / p.Hkv;
  const int z = blockIdx.z;
  const int G = p.G;

  // the packed rows that can see a key of this tile: causal, from the
  // tile's first key on (from 0 when a key of the tile is in the prefix);
  // with a window, up to the tile's last key + window - 1.  Split into
  // n_split ranges of whole row tiles; this block takes range z.
  int s_lo = 0;
  int s_hi = p.S - 1;
  if (p.causal && kt >= p.prefix_len) s_lo = kt;
  if (p.window > 0) s_hi = min(s_hi, min(kt + kTcKeys, p.T) - 1 + p.window - 1);
  const int r_lo = s_lo * G;
  const int r_hi = s_hi >= s_lo ? (s_hi + 1) * G : r_lo;
  const int n_tiles = r_hi > r_lo ? (r_hi - r_lo + BR - 1) / BR : 0;
  const int t_lo = n_tiles * z / p.n_split;
  const int t_hi = n_tiles * (z + 1) / p.n_split;
  const int row_begin = r_lo + t_lo * BR;
  const int row_end = min(r_lo + t_hi * BR, r_hi);
  const int n_mine = t_hi - t_lo;

  auto load_rows = [&](int r0, int stage) {
    bf16* qd = rowbuf + 2 * stage * BR * D;
    bf16* dd = qd + BR * D;
    for (int i = tid; i < BR * C; i += kDkdvThreads) {
      const int rr = i / C;
      const int c = i % C;
      const int r = r0 + rr;
      const bool ok = r < row_end;
      const size_t src =
          (ok ? (((size_t)b * p.S + r / G) * p.Hq + hk * G + r % G) * D : 0) +
          c * 8;
      cp_async16(smem_u32(qd + swz<D>(rr, c)), p.q + src, ok);
      cp_async16(smem_u32(dd + swz<D>(rr, c)), p.dout + src, ok);
    }
    float* ls = lds + 2 * stage * BR;
    for (int i = tid; i < 2 * BR; i += kDkdvThreads) {
      const int r = r0 + i % BR;
      const bool ok = r < row_end;
      const size_t li =
          ok ? ((size_t)b * p.Hq + hk * G + r % G) * p.S + r / G : 0;
      cp_async4(smem_u32(ls + i), (i < BR ? p.lse : p.delta) + li, ok);
    }
  };

  if (n_mine > 0) {
    for (int i = tid; i < kTcKeys * C; i += kDkdvThreads) {
      const int j = i / C;
      const int c = i % C;
      const int t = kt + j;
      const bool ok = t < p.T;
      const size_t src =
          (((size_t)b * p.T + (ok ? t : 0)) * p.Hkv + hk) * D + c * 8;
      cp_async16(smem_u32(ks + swz<D>(j, c)), p.k + src, ok);
      cp_async16(smem_u32(vs + swz<D>(j, c)), p.v + src, ok);
    }
    load_rows(row_begin, 0);
  }
  cp_async_commit();

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  for (int it = 0; it < n_mine; ++it) {
    const int r0 = row_begin + it * BR;
    if (it + 1 < n_mine) {
      load_rows(r0 + BR, (it + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qd = rowbuf + 2 * (it & 1) * BR * D;
    const bf16* dd = qd + BR * D;
    const float* ls = lds + 2 * (it & 1) * BR;

    // S^T = K.Q^T and dP^T = V.dO^T: keys kg*16 .. +15, rows hf*BR/2 ..
    float st[RT][4], dpt[RT][4];
#pragma unroll
    for (int nt = 0; nt < RT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], av[4];
      const int arow = kg * 16 + (lane & 15);
      const int achunk = 2 * kk + (lane >> 4);
      ldsm_x4(smem_u32(ks + swz<D>(arow, achunk)), a);
      ldsm_x4(smem_u32(vs + swz<D>(arow, achunk)), av);
#pragma unroll
      for (int nt = 0; nt < RT; nt += 2) {
        const int brow = hf * (BR / 2) + nt * 8 + (mi >> 1) * 8 + (lane & 7);
        const int bchunk = 2 * kk + (mi & 1);
        uint32_t bq[4], bd[4];
        ldsm_x4(smem_u32(qd + swz<D>(brow, bchunk)), bq);
        ldsm_x4(smem_u32(dd + swz<D>(brow, bchunk)), bd);
        mma_bf16(st[nt], a, bq[0], bq[1]);
        mma_bf16(st[nt + 1], a, bq[2], bq[3]);
        mma_bf16(dpt[nt], av, bd[0], bd[1]);
        mma_bf16(dpt[nt + 1], av, bd[2], bd[3]);
      }
    }

    // P^T and dZ^T in f32, then as bf16 into shared memory
    const bool edge = !all_visible(p, r0 / G,
                                   (min(r0 + BR, row_end) - 1) / G, kt,
                                   kt + kTcKeys);
#pragma unroll
    for (int nt = 0; nt < RT; ++nt) {
      const int col = hf * (BR / 2) + nt * 8 + 2 * tq;  // rows col, col + 1
      float lse2[2], dlt[2];
      int s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = r0 + col + j;
        lse2[j] = lse_base2(ls[col + j], r < row_end);
        dlt[j] = ls[BR + col + j];
        s[j] = r / G;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = kt + kg * 16 + g + 8 * (e >> 1);
        const int j = e & 1;
        p_and_dz(p, st[nt][e], dpt[nt][e], lse2[j], dlt[j],
                 edge && !key_visible(p, s[j], t));
      }
      const int chunk = hf * (BR / 16) + nt;
      const int krow = kg * 16 + g;
      *reinterpret_cast<uint32_t*>(pts + swz<BR>(krow, chunk) + 2 * tq) =
          pack_bf16(st[nt][0], st[nt][1]);
      *reinterpret_cast<uint32_t*>(pts + swz<BR>(krow + 8, chunk) + 2 * tq) =
          pack_bf16(st[nt][2], st[nt][3]);
      *reinterpret_cast<uint32_t*>(dzts + swz<BR>(krow, chunk) + 2 * tq) =
          pack_bf16(dpt[nt][0], dpt[nt][1]);
      *reinterpret_cast<uint32_t*>(dzts + swz<BR>(krow + 8, chunk) + 2 * tq) =
          pack_bf16(dpt[nt][2], dpt[nt][3]);
    }

    __syncthreads();

    // dV += P^T.dO and dK += dZ^T.Q: keys kg*16 .., columns hf*D/2 ..
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      uint32_t ap[4], az[4];
      const int arow = kg * 16 + (lane & 15);
      const int achunk = 2 * kk + (lane >> 4);
      ldsm_x4(smem_u32(pts + swz<BR>(arow, achunk)), ap);
      ldsm_x4(smem_u32(dzts + swz<BR>(arow, achunk)), az);
#pragma unroll
      for (int dt = 0; dt < DT; dt += 2) {
        const int brow = kk * 16 + (mi & 1) * 8 + (lane & 7);
        const int bchunk = hf * DT + dt + (mi >> 1);
        uint32_t bd[4], bq[4];
        ldsm_x4_t(smem_u32(dd + swz<D>(brow, bchunk)), bd);
        ldsm_x4_t(smem_u32(qd + swz<D>(brow, bchunk)), bq);
        mma_bf16(dv[dt], ap, bd[0], bd[1]);
        mma_bf16(dv[dt + 1], ap, bd[2], bd[3]);
        mma_bf16(dk[dt], az, bq[0], bq[1]);
        mma_bf16(dk[dt + 1], az, bq[2], bq[3]);
      }
    }
    __syncthreads();  // the next copy overwrites this stage, P^T and dZ^T
  }
  cp_async_wait<0>();

  const size_t plane = (size_t)p.B * p.T * p.Hkv * D;  // one split's dK
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = kt + kg * 16 + g + 8 * i;
    if (t >= p.T) continue;
    const size_t row = (((size_t)b * p.T + t) * p.Hkv + hk) * D +
                       hf * (D / 2) + 2 * tq;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const float k0 = dk[dt][2 * i] * p.scale;
      const float k1 = dk[dt][2 * i + 1] * p.scale;
      const float v0 = dv[dt][2 * i];
      const float v1 = dv[dt][2 * i + 1];
      if (p.n_split == 1) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + row + dt * 8) =
            __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + row + dt * 8) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        float* part = p.dkv_part + 2 * z * plane + row + dt * 8;
        *reinterpret_cast<float2*>(part) = make_float2(k0, k1);
        *reinterpret_cast<float2*>(part + plane) = make_float2(v0, v1);
      }
    }
  }
}

// dk, dv = the sums of the n_split partials, z = 0 .. n_split - 1 in
// order; one thread 4 elements of each
__global__ void attn_bwd_dkdv_reduce(const float4* part, bf16* dk, bf16* dv,
                                     int n_split, size_t n4) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c = a;
  for (int z = 0; z < n_split; ++z) {
    const float4 x = part[2 * z * n4 + i];
    const float4 y = part[(2 * z + 1) * n4 + i];
    a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    c.x += y.x; c.y += y.y; c.z += y.z; c.w += y.w;
  }
  __nv_bfloat162* k2 = reinterpret_cast<__nv_bfloat162*>(dk) + 2 * i;
  __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(dv) + 2 * i;
  k2[0] = __floats2bfloat162_rn(a.x, a.y);
  k2[1] = __floats2bfloat162_rn(a.z, a.w);
  v2[0] = __floats2bfloat162_rn(c.x, c.y);
  v2[1] = __floats2bfloat162_rn(c.z, c.w);
}

// BK: keys a dQ tile.  At head_dim 256 the dQ accumulator alone is 128
// registers a thread and the block holds 128 KB of shared memory at 32
// keys: 16-key tiles let two blocks share an SM.
template <int D, int BK>
cudaError_t launch_tc_bwd(const TcBwdParams& p, cudaStream_t stream) {
  const size_t smem_dq = sizeof(bf16) * (2 * kTcRows * D + 2 * 2 * BK * D) +
                         sizeof(float) * kTcRows;
  const size_t smem_kv =
      sizeof(bf16) * (2 * kTcKeys * D + 2 * 2 * kTcRows * D +
                      2 * kTcKeys * kTcRows) +
      sizeof(float) * 2 * 2 * kTcRows;
  auto dq = attn_bwd_dq_tc<D, BK>;
  auto dkdv = attn_bwd_dkdv_tc<D>;
  cudaError_t e;
  if ((e = allow_smem(dq, smem_dq)) != cudaSuccess) return e;
  if ((e = allow_smem(dkdv, smem_kv)) != cudaSuccess) return e;
  const unsigned heads = (unsigned)(p.Hkv * p.B);
  dq<<<dim3((p.S * p.G + kTcRows - 1) / kTcRows, heads), kDqThreads, smem_dq,
       stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  dkdv<<<dim3((p.T + kTcKeys - 1) / kTcKeys, heads, p.n_split), kDkdvThreads,
         smem_kv, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess || p.n_split == 1) return e;
  const size_t n4 = (size_t)p.B * p.T * p.Hkv * D / 4;
  attn_bwd_dkdv_reduce<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(p.dkv_part), p.dk, p.dv, p.n_split,
      n4);
  return cudaGetLastError();
}

cudaError_t launch_tc_bwd_dim(int D, const TcBwdParams& p,
                              cudaStream_t stream) {
  switch (D) {
    case 64: return launch_tc_bwd<64, 32>(p, stream);
    case 128: return launch_tc_bwd<128, 64>(p, stream);
    case 256: return launch_tc_bwd<256, 16>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns the launches' cudaGetLastError() (0 = launched), on ``stream``.
// bf16 takes the tensor cores: attn_bwd_dq_tc (which writes delta),
// attn_bwd_dkdv_tc and, when n_split > 1, attn_bwd_dkdv_reduce over
// dkv_part, the wrapper's (n_split, 2, B, T, Hkv, D) f32 scratch.  f32 takes
// the CUDA cores (n_split must be 1): attn_bwd_pre, attn_bwd_dkdv and
// attn_bwd_dq.  delta is the wrapper's (B, Hq, S) f32 scratch.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, void* dkv_part, int B, int S, int T, int Hq, int Hkv, int D,
    int is_bf16, int causal, int window, float softcap, int prefix_len,
    float scale, int n_split, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      n_split < 1 || (!is_bf16 && n_split != 1) ||
      (n_split > 1 && dkv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    TcBwdParams p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.o = static_cast<const bf16*>(o);
    p.dout = static_cast<const bf16*>(dout);
    p.lse = static_cast<const float*>(lse);
    p.delta = static_cast<float*>(delta);
    p.dq = static_cast<bf16*>(dq);
    p.dk = static_cast<bf16*>(dk);
    p.dv = static_cast<bf16*>(dv);
    p.dkv_part = static_cast<float*>(dkv_part);
    p.B = B;
    p.S = S;
    p.T = T;
    p.Hq = Hq;
    p.Hkv = Hkv;
    p.G = Hq / Hkv;
    p.n_split = n_split;
    p.causal = causal;
    p.window = window;
    p.prefix_len = prefix_len;
    p.softcap = softcap;
    p.scale = scale;
    return (int)launch_tc_bwd_dim(D, p, st);
  }
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
  return (int)launch_dim<float>(D, p, st);
}
