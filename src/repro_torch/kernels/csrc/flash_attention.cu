// Attention forward for Hopper (sm_90a), written by hand for the PyTorch port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, body _kernel) and covers the two call sites the
// reference leaves to XLA: a prefill chunk at a scalar offset
// (ops._attention_chunked) and decode with one position per batch row
// (ops._attention_decode).  The offset arrives as an int32 (B,) device
// array; the Python wrapper broadcasts a scalar.
//
// Layouts (all contiguous): q, o (B, S, Hq, D); k, v (B, T, Hkv, D), q, k
// and v 16-byte aligned.
// GQA: q head h reads kv head h / G, G = Hq / Hkv.
// Masks, as the reference oracle ref.attention_ref: key t is visible to a
// query at absolute position p = q_offset[b] + s when t < T and
//   causal:  t <= p, or t < prefix_len when a prefix is given;
//   window:  t > p - window.
// Numerics: f32 m, l and acc; scale 1/sqrt(D) before the tanh softcap;
// out = acc / max(l, 1e-30).
// Row log-sum-exp (training): given a non-null lse, (B, Hq, S) f32, every
// path also writes lse = m + log l of each (b, h, s) row, in the domain of
// the scaled and soft-capped logits that the backward
// (flash_attention_bwd.cu) recomputes; a row that saw no key gets -1e30.
// Serving passes null and nothing more is written.
//
// Two routes, chosen by dtype (the wrapper's plan()), never by failure:
//
// bf16, every serving path: attn_fwd_tc, on the tensor cores.  What bounds
// it on the H100: prefill at a few hundred tokens and more is bound by
// operations (989 TFLOP/s of bf16 tensor cores); decode and short chunks
// by the bytes of the live K/V (3.35 TB/s), and at serving batch also by
// how few blocks the grid has for 132 SMs.  The design:
//   * GQA rows packed into the tile.  A block owns one (kv head hk, batch
//     row b) and 64 packed rows; row r is query s = r / G of q head
//     hk * G + r % G.  Every K/V tile it loads serves all G heads that read
//     it: recurrentgemma's 16 MQA heads of one decode slot fill one 16-row
//     MMA fragment and read the slot's K/V once, not 16 times.
//   * Both products on the tensor cores: mma.sync m16n8k16 bf16 -> f32,
//     operands by ldmatrix (.trans for V) from shared memory; each of the
//     4 warps owns 16 rows.  S = Q.K^T stays in registers; the softmax runs
//     there (row max and sum across the quad by shuffles), and P, rounded
//     to bf16, is the A operand of P.V without leaving the registers.
//     Q fragments are read from shared memory each tile: at D 256 the O
//     accumulator alone is 128 registers a thread, and key tiles are 32
//     wide (64-key tiles take 160 KB of shared memory, one block an SM,
//     and ran long prefills 1.4x slower on an H100).  Masks are applied
//     element by element only on tiles that cross a mask edge.
//   * At most 16 packed rows (decode, short prompts at small G) fill one
//     warp's fragment: then a block holds 16 rows and its four warps each
//     take a quarter of every 64-key tile, merging their softmax states
//     through shared memory at the end, instead of three warps idling.
//   * Row tiles run last first: under a causal mask they see the most keys,
//     and the card should start the longest blocks first.
//   * cp.async: K/V tiles, bf16 in shared memory, in a two-stage ring, so
//     tile j+1 loads while tile j computes; rows are XOR-swizzled in
//     16-byte chunks so ldmatrix and the copies are free of bank
//     conflicts.  Rows past T are zero-filled.
//   * Split-K across blocks (flash-decoding) when the grid is short of the
//     card: grid.z = n_split, chosen by the wrapper from shapes alone (it
//     never reads q_offset, which lives on the device).  Each block splits
//     the key tiles its rows can see into n_split contiguous ranges and
//     takes one; with n_split > 1 it writes unnormalized O, m and l in f32
//     to scratch and attn_combine merges them: m* = max m_i,
//     l = sum l_i e^(m_i - m*), out = sum O_i e^(m_i - m*) / max(l, 1e-30).
//     A block whose range is empty writes an empty partial (l = 0).
//   * Key tiles that every row of the block has masked away (past the
//     causal edge, before the window, past T) are never loaded.
//
// f32, the parity dtype: attn_fwd, on the CUDA cores (the tensor cores'
// f32 route is TF32, 10 mantissa bits, too coarse for f32 parity).  One
// block of four warps per (query tile, q head, batch row) walks the key
// tiles itself; each key tile of K and V is staged in shared memory as
// f32, read 16 bytes at a time with several loads in flight per thread
// (K rows padded by one word so lanes reading different keys hit
// different banks).  In a tile each lane owns one key for Q.K^T and then
// D/32 output columns for P.V, with the probabilities broadcast by warp
// shuffles; m, l and acc stay in registers.
//   * S > 16 (prefill, chunks): 16 query rows per block, 4 per warp, so
//     every staged key tile serves 16 rows; 32 keys per tile.
//   * S <= 16 (decode): one query row per block and the four warps split
//     a 128-key tile, merging their partial softmax states at the end.  At
//     head_dim 256 that tile does not fit in shared memory: there two
//     warps split a 64-key tile for each of two rows of a block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores (attn_fwd)
// ---------------------------------------------------------------------------
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // null, or (B, Hq, S) row log-sum-exp
  const int* q_offset;
  int B, S, T, Hq, Hkv;
  int causal, window, prefix_len;  // prefix_len < 0: no prefix
  float softcap, scale;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }

// 16 loaded bytes (4 f32) into shared memory; the third argument only
// selects the overload
__device__ __forceinline__ void unpack(const uint4& r, float* dst,
                                       const float*) {
  const float* f = reinterpret_cast<const float*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = f[e];
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
        m[i] = mt;
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
    if (p.lse != nullptr && lane == 0)
      p.lse[((size_t)b * p.Hq + h) * p.S + s] =
          l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
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
  // D = 256: four warps splitting a 128-key tile would stage
  // 4 * (256 + 128 * 257 + 128 * 256) = 263,680 bytes, over the 232,448 a
  // block may have; two warps a row on 64-key tiles stage 133,376.
  constexpr int kSplit = D > 128 ? 2 : kWarps;
  if (p.S <= 16) return launch<T, D, 1, kSplit>(p, stream);
  return launch<T, D, 4, 1>(p, stream);
}

template <typename T>
cudaError_t launch_simt(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_rows<T, 16>(p, stream);
    case 32: return launch_rows<T, 32>(p, stream);
    case 64: return launch_rows<T, 64>(p, stream);
    case 128: return launch_rows<T, 128>(p, stream);
    case 256: return launch_rows<T, 256>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (attn_fwd_tc, attn_combine)
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kRows = 64;  // packed rows a block: 4 warps x 16
constexpr float kLog2e = 1.4426950408889634f;

struct TcParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;           // n_split == 1: the normalized output
  float* o_part;     // n_split > 1: (n_split, B, S, Hq, D) unnormalized O
  float2* ml_part;   //              (n_split, B, S, Hq) of (m, l)
  float* lse;        // null, or (B, Hq, S) row log-sum-exp
  const int* q_offset;
  int B, S, T, Hq, Hkv, G, n_split;
  int causal, window, prefix_len;  // prefix_len < 0: no prefix
  float softcap, scale;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

// Element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled: the 8 rows one ldmatrix phase reads at one
// logical chunk land in 8 different 16-byte slots of the 128-byte bank
// window (rows of D < 64 share a window, hence the shift).
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  constexpr int C = D / 8;
  constexpr int kMask = C < 8 ? C - 1 : 7;
  constexpr int kShift = C >= 8 ? 0 : (C == 4 ? 1 : 2);
  return row * D + ((chunk ^ ((row >> kShift) & kMask)) << 3);
}

// WS (warps split keys): a block of at most 16 packed rows (decode, short
// prompts at small G), which one warp's fragment holds; the four warps
// then take a quarter of every key tile each for the same 16 rows and
// merge their softmax states at the end, instead of three warps idling.
template <int D, int BK, bool WS>
__global__ void __launch_bounds__(kThreads) attn_fwd_tc(TcParams p) {
  constexpr int C = D / 8;                   // 16-byte chunks a row
  constexpr int MR = WS ? 16 : kRows;        // packed rows a block
  constexpr int KW = WS ? BK / kWarps : BK;  // keys a warp takes of a tile
  constexpr int NT = KW / 8;                 // 8-key column tiles of S
  constexpr int DT = D / 8;                  // 8-wide column tiles of O
  static_assert(KW % 16 == 0 && DT % 2 == 0 && D % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [MR][D]
  bf16* kvs = qs + MR * D;  // stage s: K [BK][D] at 2*s*BK*D, then V

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the fragment row within 8
  const int tq = lane & 3;  // the fragment column pair
  const int hk = blockIdx.y % p.Hkv;
  const int b = blockIdx.y / p.Hkv;
  const int z = blockIdx.z;
  const int G = p.G;
  const int rows = p.S * G;
  // row tiles in reverse: under a causal mask the last rows see the most
  // keys, and the blocks the card starts first should be the longest
  const int r0 = (gridDim.x - 1 - blockIdx.x) * MR;
  const int off = p.q_offset[b];
  const int rb = WS ? 0 : warp * 16;  // the warp's first row of the tile
  const int kb = WS ? warp * KW : 0;  // the warp's first key of a key tile

  // Q tile: packed row r is query r / G of q head hk * G + r % G
  for (int i = tid; i < MR * C; i += kThreads) {
    const int rr = i / C;
    const int c = i % C;
    const int r = r0 + rr;
    const bool ok = r < rows;
    const int s = ok ? r / G : 0;
    const int h = hk * G + (ok ? r % G : 0);
    cp_async16(smem_u32(qs + swz<D>(rr, c)),
               p.q + (((size_t)b * p.S + s) * p.Hq + h) * D + c * 8, ok);
  }

  // keys any row of this block can see, split into n_split ranges of tiles
  const int s_lo = r0 / G;
  const int s_hi = (min(r0 + MR, rows) - 1) / G;
  const int pos_lo = off + s_lo;
  const int pos_hi = off + s_hi;
  int k_begin = 0;
  int k_end = p.T;
  if (p.causal) {
    k_end = min(p.T, pos_hi + 1);
    if (p.prefix_len > 0) k_end = max(k_end, min(p.prefix_len, p.T));
  }
  if (p.window > 0) k_begin = max(0, pos_lo - p.window + 1);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  const int t_lo = n_tiles * z / p.n_split;
  const int t_hi = n_tiles * (z + 1) / p.n_split;
  const int key_lo = k_begin + t_lo * BK;
  const int key_hi = min(k_begin + t_hi * BK, k_end);

  // this thread's two fragment rows: rb + g and rb + g + 8
  int qpos[2];
  bool row_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + rb + g + 8 * i;
    row_ok[i] = r < rows;
    qpos[i] = off + (row_ok[i] ? r / G : 0);
  }
  const bool warp_live = r0 + rb < rows;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums

  auto load_kv = [&](int kt, int stage) {
    bf16* ks = kvs + 2 * stage * BK * D;
    bf16* vs = ks + BK * D;
    for (int i = tid; i < BK * C; i += kThreads) {
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

  const int n_mine = t_hi - t_lo;
  if (n_mine > 0) load_kv(key_lo, 0);
  cp_async_commit();  // Q and the first tile
  for (int it = 0; it < n_mine; ++it) {
    const int kt = key_lo + it * BK;
    if (it + 1 < n_mine) {
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
      const int mi = lane >> 3;  // the 8x8 matrix this lane addresses

      // S = Q.K^T, 16 rows x KW keys a warp
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(smem_u32(qs + swz<D>(rb + (lane & 15),
                                     2 * kk + (lane >> 4))),
                a[0], a[1], a[2], a[3]);
#pragma unroll
        for (int nt = 0; nt < NT; nt += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4(smem_u32(ks + swz<D>(kb + nt * 8 + (mi >> 1) * 8 +
                                           (lane & 7),
                                       2 * kk + (mi & 1))),
                  b0, b1, b2, b3);
          mma_bf16(sc[nt], a, b0, b1);
          mma_bf16(sc[nt + 1], a, b2, b3);
        }
      }

      // scale, softcap, masks (only on a tile that crosses a mask edge)
      const bool edge =
          kt + BK > key_hi ||
          (p.causal && kt + BK - 1 > pos_lo && kt + BK > p.prefix_len) ||
          (p.window > 0 && kt <= pos_hi - p.window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float x = sc[nt][e] * p.scale;
          if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
          if (edge) {
            const int t = kt + kb + nt * 8 + 2 * tq + (e & 1);
            bool ok = t < key_hi;
            if (p.causal) ok = ok && (t <= qpos[i] || t < p.prefix_len);
            if (p.window > 0) ok = ok && t > qpos[i] - p.window;
            if (!ok) x = -CUDART_INF_F;
          }
          sc[nt][e] = x;
          mx[i] = fmaxf(mx[i], x);
        }
      }
      // online softmax: m stays finite (>= kNegInf), so masked -inf
      // logits give p = 0 and a first real tile gives corr = 0
      float corr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        corr[i] = exp2f((m[i] - mx[i]) * kLog2e);
        m[i] = mx[i];
        l[i] *= corr[i];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][0] *= corr[0];
        acc[dt][1] *= corr[0];
        acc[dt][2] *= corr[1];
        acc[dt][3] *= corr[1];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float pe = exp2f((sc[nt][e] - m[i]) * kLog2e);
          l[i] += pe;
          sc[nt][e] = pe;
        }
      }

      // O += P.V: P's accumulators, as bf16, are P.V's A fragments
#pragma unroll
      for (int kk = 0; kk < KW / 16; ++kk) {
        const float(&p0)[4] = sc[2 * kk];
        const float(&p1)[4] = sc[2 * kk + 1];
        const uint32_t a[4] = {
            pack_bf16(p0[0], p0[1]), pack_bf16(p0[2], p0[3]),
            pack_bf16(p1[0], p1[1]), pack_bf16(p1[2], p1[3])};
#pragma unroll
        for (int dt = 0; dt < DT; dt += 2) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_t(smem_u32(vs + swz<D>(kb + kk * 16 + (mi & 1) * 8 +
                                             (lane & 7),
                                         dt + (mi >> 1))),
                    b0, b1, b2, b3);
          mma_bf16(acc[dt], a, b0, b1);
          mma_bf16(acc[dt + 1], a, b2, b3);
        }
      }
    }
    __syncthreads();  // the next copy overwrites this stage
  }
  cp_async_wait<0>();  // Q's copy, when this block had no tile

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
  }
  if (WS) {
    // merge the four warps' states of the same 16 rows into warp 0's
    // registers; the K/V ring is free once every warp is past its loop
    float* ms = reinterpret_cast<float*>(kvs);  // [warp][row] m, then l
    float* ls = ms + kWarps * 16;
    float* as = ls + kWarps * 16;  // [warp][row][D] acc
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = warp * 16 + g + 8 * i;
      if (tq == 0) {
        ms[row] = m[i];
        ls[row] = l[i];
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(as + row * D + dt * 8 + 2 * tq) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
    }
    __syncthreads();
    if (warp != 0) return;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = g + 8 * i;
      float mt = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, ms[w * 16 + row]);
      float c[kWarps];
      l[i] = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        c[w] = expf(ms[w * 16 + row] - mt);
        l[i] += ls[w * 16 + row] * c[w];
      }
      m[i] = mt;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float2 sum = make_float2(0.f, 0.f);
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 x = *reinterpret_cast<const float2*>(
              as + (w * 16 + row) * D + dt * 8 + 2 * tq);
          sum.x += x.x * c[w];
          sum.y += x.y * c[w];
        }
        acc[dt][2 * i] = sum.x;
        acc[dt][2 * i + 1] = sum.y;
      }
    }
  }
  if (!warp_live) return;
  const size_t plane = (size_t)p.B * p.S * p.Hq;  // rows of one split
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    const int r = r0 + rb + g + 8 * i;
    const size_t row =
        ((size_t)b * p.S + r / G) * p.Hq + hk * G + r % G;
    if (p.n_split == 1) {
      if (p.lse != nullptr && tq == 0)
        p.lse[((size_t)b * p.Hq + hk * G + r % G) * p.S + r / G] =
            l[i] > 0.f ? m[i] + logf(l[i]) : kNegInf;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      bf16* orow = p.o + row * D + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
            __floats2bfloat162_rn(acc[dt][2 * i] * inv,
                                  acc[dt][2 * i + 1] * inv);
    } else {
      float* orow = p.o_part + (z * plane + row) * D + 2 * tq;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(orow + dt * 8) =
            make_float2(acc[dt][2 * i], acc[dt][2 * i + 1]);
      if (tq == 0) p.ml_part[z * plane + row] = make_float2(m[i], l[i]);
    }
  }
}

// Merges the n_split partials of every (b, s, h) row: one thread an
// output element.  A partial with l = 0 saw no key and is skipped.  With a
// non-null lse the row's first thread writes the merged m + log l.
__global__ void attn_combine(const float* o_part, const float2* ml_part,
                             bf16* o, float* lse, int n_split, size_t rows,
                             int D, int S, int Hq) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * D) return;
  const size_t row = idx / D;
  float mt = kNegInf;
  for (int z = 0; z < n_split; ++z) {
    const float2 ml = ml_part[z * rows + row];
    if (ml.y > 0.f) mt = fmaxf(mt, ml.x);
  }
  float lt = 0.f;
  float a = 0.f;
  for (int z = 0; z < n_split; ++z) {
    const float2 ml = ml_part[z * rows + row];
    if (ml.y > 0.f) {
      const float c = expf(ml.x - mt);
      lt += ml.y * c;
      a += o_part[z * rows * D + idx] * c;
    }
  }
  o[idx] = __float2bfloat16(a / fmaxf(lt, 1e-30f));
  if (lse != nullptr && idx % D == 0) {
    const size_t h = row % Hq;
    const size_t bs = row / Hq;  // b * S + s
    lse[(bs / S * Hq + h) * S + bs % S] = lt > 0.f ? mt + logf(lt) : kNegInf;
  }
}

template <int D, int BK, bool WS>
cudaError_t launch_tc_tiles(const TcParams& p, cudaStream_t stream) {
  constexpr int MR = WS ? 16 : kRows;
  // the WS merge (4 x 16 rows of f32 acc, m and l) fits in the K/V ring
  static_assert(!WS || 4 * 16 * (D + 2) * 4 <= 2 * 2 * BK * D * 2, "merge");
  const size_t smem = sizeof(bf16) * (MR * D + 2 * 2 * BK * D);
  auto kernel = attn_fwd_tc<D, BK, WS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.S * p.G + MR - 1) / MR, p.Hkv * p.B, p.n_split);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.n_split == 1) return e;
  const size_t rows = (size_t)p.B * p.S * p.Hq;
  const size_t n = rows * D;
  attn_combine<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p.o_part, p.ml_part, p.o, p.lse, p.n_split, rows, D, p.S, p.Hq);
  return cudaGetLastError();
}

template <bool WS>
cudaError_t launch_tc_dim(int D, const TcParams& p, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_tc_tiles<16, 64, WS>(p, stream);
    case 32: return launch_tc_tiles<32, 64, WS>(p, stream);
    case 64: return launch_tc_tiles<64, 64, WS>(p, stream);
    case 128: return launch_tc_tiles<128, 64, WS>(p, stream);
    // a warp's S of 64 keys beside its 128 O registers would spill
    case 256: return launch_tc_tiles<256, WS ? 64 : 32, WS>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// the key tile: 64 keys, 32 at D 256 with 64-row blocks (the O
// accumulator alone is 128 registers a thread there); the wrapper's
// key_tile() mirrors this
cudaError_t launch_tc(int D, const TcParams& p, cudaStream_t stream) {
  if (p.S * p.G <= 16) return launch_tc_dim<true>(D, p, stream);
  return launch_tc_dim<false>(D, p, stream);
}

}  // namespace

// Returns the launches' cudaGetLastError() (0 = launched).  bf16 takes the
// tensor-core kernel (with attn_combine when n_split > 1; o_part and
// ml_part are then the wrapper's f32 scratch), f32 the CUDA-core one
// (n_split must be 1).  lse is null (serving) or (B, Hq, S) f32.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_offset, void* o_part, void* ml_part, void* lse, int B,
    int S, int T,
    int Hq, int Hkv, int D, int is_bf16, int causal, int window,
    float softcap, int prefix_len, float scale, int n_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || T <= 0 || Hkv <= 0 || Hq % Hkv != 0 ||
      n_split < 1 || (!is_bf16 && n_split != 1))
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    TcParams p;
    p.q = static_cast<const bf16*>(q);
    p.k = static_cast<const bf16*>(k);
    p.v = static_cast<const bf16*>(v);
    p.o = static_cast<bf16*>(o);
    p.o_part = static_cast<float*>(o_part);
    p.ml_part = static_cast<float2*>(ml_part);
    p.lse = static_cast<float*>(lse);
    p.q_offset = q_offset;
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
    return (int)launch_tc(D, p, st);
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
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
  return (int)launch_simt<float>(D, p, st);
}
