// Mamba2 chunked SSD for Hopper (sm_90a), written by hand for the PyTorch
// port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd_pallas,
// body _kernel).  Per (batch row b, head h) and chunk c of Q = 64 tokens,
// with cum_i = sum_{k<=i} dt_k A inclusive within the chunk:
//   S_c    = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j    chunk state
//   h_c    = exp(cum_last) h_{c-1} + S_c                      state passing
//   y_i    = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j
//          + exp(cum_i) C_i . h_{c-1}^T + D x_i               chunk scan
// Head h reads B and C of group h / (H / G).
//
// Layouts (all contiguous): x, y (B, S, H, P) f32 or bf16; dt (B, S, H)
// f32; A, D (H,) f32; B, C (B, S, G, N) in x's type; h0, h_final
// (B, H, P, N) f32; the wrapper's scratch: states (B, nc, H, P, N),
// decay (B, nc, H) and C.B^T (B, nc, G, 64, 64), f32, nc = ceil(S / 64).
// P <= 64, N <= 128.
//
// What bounds it on an H100.  The function needs 2 P N + P multiply-adds
// a token and head (the recurrent form) on (P + 2 N / rep) values read.
// The chunked form does more: Q/2 (N + P) in-chunk multiply-adds a token
// on the causal half, plus 2 P N for the state.  Its four products (the
// chunk state x^T (w B), C B^T, scores x, C h^T) run on the tensor cores
// in 3xTF32 (below), whose peak is 495 TFLOP/s: at mamba2's P 64, N 128
// the bound is then the bytes.  Plain TF32 (~3 decimal digits) misses the
// port's 2e-4 against the f32 plain version; 3xTF32 keeps ~f32 accuracy
// (tests/test_torch_ssd_chunks.py emulates both).
//
// Design.  The TPU kernel runs its chunk axis in order with the state in
// VMEM.  One block per (head, row) walking the chunks in order left most
// of the card idle at prefill's batch of 1 (64 heads, 132 SMs) and ran
// the chunks in series.  Here the chunk axis is parallel, in four
// launches, each block one (head or group, chunk, row):
//   0. ssd_chunk_cb: the chunk's C.B^T, which does not depend on the head,
//      once per group, so that the group's heads (all 64 of mamba2's,
//      G = 1) share one product;
//   1. ssd_chunk_state: S_c from a zero state, and exp(cum_last), into
//      the scratch;
//   2. ssd_state_passing: one thread per (row, head, four state elements)
//      walks the chunks in order, four chunks' loads in flight,
//      overwriting S_c with the state entering chunk c, and writes
//      h_final;
//   3. ssd_chunk_scan: y from the chunk's own tokens and its entering
//      state.
// The state's round trip through device memory (86 MB at S 2600, H 64)
// is the price of the parallel chunks.  A sequence of one chunk (the
// demo's short prompts) takes one launch of the scan, which starts from
// h0 and also writes h_final.  Each warp takes a 16-row strip of a
// product in mma.sync m16n8k8 fragments read from shared memory whose row
// strides keep a fragment's reads on 32 banks, whichever way the operand
// runs; so C, B, h and x stay in their own layouts, untransposed.  The
// C.B^T fragments above the diagonal or past the chunk's rows are not
// computed, nor the score.x terms past the strip's last row.  A block's
// tiles are fetched into registers all at once and put into shared
// memory after (one memory latency, not one a tile), and the entering
// state is fetched while the scores are formed.  Q = 64: Q = 128 halves
// the state traffic but doubles the in-chunk work, and was slower at
// every S on the CUDA cores; with the padded tiles its scan no longer
// fits a block's shared memory.
//
// Rounding of the reassociation.  The state is summed per chunk from
// zero, then passed: h_c = decay_c h_{c-1} + S_c in f32, where the
// sequential form adds each token into the running state.  The per-chunk
// sums keep every exponent at or below 0.  cum is summed and differenced
// in f64 (64 values a chunk): in f32 the difference of two cumulative
// sums of ~800 (mamba2's A reaches -16) would lose ~5e-5 of every
// exponent.  Only the j <= i differences are exponentiated (cum decreases,
// so they are <= 0); the others are set to 0 without an exp.  The ragged
// last chunk is read by bounds: its missing rows get x = B = C = 0 and
// dt = 0, an identity step for the state, and their y is never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;   // tokens a chunk
constexpr int kThreads = 256;
constexpr int kP = 64;   // head-dim tile: P <= kP, zero-padded
constexpr int kN = 128;  // state-dim tile: N <= kN, zero-padded
// Row strides of the tiles in shared memory, chosen so that an mma
// fragment's 8 x 4 (or 4 x 8) reads hit 32 distinct banks: 4 banks apart
// where the product runs along a row (k contiguous), 8 where it runs down
// a column.
constexpr int kLN = kN + 4;   // C, B, h: rows of N, read along the row
constexpr int kLS = kQ + 4;   // scores: rows of j, read along the row
constexpr int kLX = kP + 8;   // x: rows of P, read down the column
constexpr int kLB = kN + 8;   // B for the chunk state: read down
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;   // null: no skip
  const float* h0;  // null: zero state
  void* y;
  float* hf;
  float* states;  // (B, nc, H, P, N): chunk states, then entering states
  float* decay;   // (B, nc, H): exp(cum_last) of each chunk
  float* cb;      // (B, nc, G, kQ, kQ): C_i . B_j of each chunk and group
  int B, S, H, P, G, N, nc;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive elements as f32, one 16- (f32) or 8-byte (bf16) load
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + 2));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// An R x CM tile, row r of src at src + r * stride, as this thread's
// share: Tile<R, CM>::n float4s, fetched into registers all at once (so
// that their latencies overlap) and put into shared memory later.  Rows
// from nr on and columns from ncol on read as zero.  Neighbouring threads
// take neighbouring 16 bytes of a row.
template <int R, int CM>
struct Tile {
  static constexpr int n = R * (CM / 4) / kThreads;
  static_assert(R * (CM / 4) % kThreads == 0, "whole float4s a thread");
  float4 v[n];

  template <typename T>
  __device__ __forceinline__ void fetch(const T* src, size_t stride, int nr,
                                        int ncol) {
    if ((ncol & 3) == 0) {
      // rows of whole float4s: every load issued, out-of-bounds ones from
      // the tile's first element, then masked, with no branch between
#pragma unroll
      for (int u = 0; u < n; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int r = e / (CM / 4);
        const int c = (e % (CM / 4)) * 4;
        const bool in = r < nr && c < ncol;
        const float4 w = load4(src + (in ? (size_t)r * stride + c : 0));
        v[u] = in ? w : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < n; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int r = e / (CM / 4);
      const int c = (e % (CM / 4)) * 4;
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = r < nr && c + k < ncol
                   ? load_f32(src + (size_t)r * stride + c + k)
                   : 0.f;
      v[u] = make_float4(w[0], w[1], w[2], w[3]);
    }
  }
  __device__ __forceinline__ void put(float* dst, int ld) const {
#pragma unroll
    for (int u = 0; u < n; ++u) {
      const int e = threadIdx.x + u * kThreads;
      *reinterpret_cast<float4*>(dst + (e / (CM / 4)) * ld +
                                 (e % (CM / 4)) * 4) = v[u];
    }
  }
};

// 3xTF32 on the tensor cores.  An f32 operand a is split into hi, a with
// its 13 low mantissa bits cleared (a TF32 value), and lo, a - hi (exact)
// with the same bits cleared; a.b is taken as hi.hi + hi.lo + lo.hi, each
// product by mma.sync m16n8k8 with f32 accumulation.  What is dropped
// (lo.lo, and the bits cut from lo) is under 2^-20 of a.b.  The split is
// two logic operations and a subtraction: cvt.rna.tf32.f32, twice an
// element, made the products bound by the conversions.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  constexpr uint32_t kTf32 = 0xffffe000u;
  hi = __float_as_uint(a) & kTf32;
  lo = __float_as_uint(a - __uint_as_float(hi)) & kTf32;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int ceil8(int n) { return n > 0 ? (n + 7) & ~7 : 0; }

// One warp: acc[j] += sum_{k < K} A(m0 + r, k) Bm(k, n0 + 8 j + c) for the
// 16 x 8 fragments j < live (of NT side by side), in 3xTF32.  Operands in
// shared memory: A(m, k) at A[m * am + k * ak], Bm(k, n) at
// Bm[k * bk + n * bn]; K % 8 == 0.  Fragment element e of lane (g =
// lane / 4, t = lane % 4) is row m0 + g + 8 (e / 2), column n0 + 8 j +
// 2 t + e % 2.
template <int NT>
__device__ __forceinline__ void warp_mma3(float (&acc)[NT][4],
                                          const float* __restrict__ A,
                                          int am, int ak, int m0,
                                          const float* __restrict__ Bm,
                                          int bk, int bn, int n0, int K,
                                          int live) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#ifdef REPRO_SSD_F32_PRODUCTS
  // A diagnostic build only (tools/train_parity_depth.py asks for it):
  // each fragment element as a plain f32 sum of products on the CUDA
  // cores, in k order, instead of 3xTF32.
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= live) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float* ar = A + (m0 + g + 8 * (e >> 1)) * am;
      const float* bc = Bm + (n0 + 8 * j + 2 * t + (e & 1)) * bn;
      float s = 0.f;
      for (int k = 0; k < K; ++k) s = fmaf(ar[k * ak], bc[k * bk], s);
      acc[j][e] += s;
    }
  }
  return;
#endif
  const float* a0 = A + (m0 + g) * am + t * ak;
  const float* b0 = Bm + t * bk + (n0 + g) * bn;
  for (int k = 0; k < K; k += 8) {
    uint32_t ah[4], al[4];
    split_tf32(a0[k * ak], ah[0], al[0]);
    split_tf32(a0[k * ak + 8 * am], ah[1], al[1]);
    split_tf32(a0[(k + 4) * ak], ah[2], al[2]);
    split_tf32(a0[(k + 4) * ak + 8 * am], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= live) break;
      uint32_t bh[2], bl[2];
      split_tf32(b0[k * bk + 8 * j * bn], bh[0], bl[0]);
      split_tf32(b0[(k + 4) * bk + 8 * j * bn], bh[1], bl[1]);
      mma_tf32(acc[j], al, bh);
      mma_tf32(acc[j], ah, bl);
      mma_tf32(acc[j], ah, bh);
    }
  }
}

__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// dt of the chunk's rows (0 past `rows`): one per thread of the first kQ
__device__ __forceinline__ float chunk_dt(const Params& p, int b, int h,
                                          int s0, int rows) {
  const int tid = threadIdx.x;
  return tid < rows ? p.dt[((size_t)b * p.S + s0 + tid) * p.H + h] : 0.f;
}

// cum, the inclusive prefix sum of dt A over the chunk in f64, by warp 0
// from dts in shared memory (written before the barrier that precedes
// this); ends with every thread past a barrier.
__device__ void chunk_cum(float A, const float* dts, double* cum) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    double carry = 0.0;
#pragma unroll
    for (int s = 0; s < kQ / 32; ++s) {
      double v = (double)(dts[s * 32 + tid] * A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, v, o);
        if (tid >= o) v += u;
      }
      v += carry;
      cum[s * 32 + tid] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
  }
  __syncthreads();
}

// C.B^T for this warp's strip of the chunk's 64 x 64: rows i from
// m0 = 16 (warp / 2), columns j from n0 = 32 (warp % 2), accumulated over
// n < K with C(i, n) at Cs[i * lc + n] and B(j, n) at Bs[j * lb + n].
// The 16 x 8 fragments wholly above the diagonal or past the chunk's rows
// are left as they are (zero).
__device__ __forceinline__ void cb_strip(float (&acc)[4][4], const float* Cs,
                                         int lc, const float* Bs, int lb,
                                         int K, int rows) {
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
  const int live =
      m0 < rows ? min(min(ceil8(m0 + 16 - n0), ceil8(rows - n0)) / 8, 4) : 0;
  if (live > 0) warp_mma3<4>(acc, Cs, lc, 1, m0, Bs, 1, lb, n0, K, live);
}

// this warp's strip of acc (as cb_strip lays it out) into dst[i * ld + j]
__device__ __forceinline__ void store_strip(const float (&acc)[4][4],
                                            float* dst, int ld) {
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp >> 1), n0 = 32 * (warp & 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(dst + (m0 + frag_row(e)) * ld + n0 + frag_col(j, e),
             acc[j][e], acc[j][e + 1]);
}

// The chunk state's 64 x 128 tile over the 8 warps, each 16 rows (p) by
// 64 columns (n): acc = sum_{j < rows} xw[j][p] Bs[j][n], xw (kQ, kLX)
// and Bs (kQ, ldb) row-major in shared memory.
__device__ __forceinline__ void state_product(float (&acc)[8][4],
                                              const float* xw,
                                              const float* Bs, int ldb,
                                              int rows) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  warp_mma3<8>(acc, xw, 1, kLX, 16 * (warp >> 1), Bs, ldb, 1,
               64 * (warp & 1), ceil8(rows), 8);
}
__device__ __forceinline__ int state_p(int e) {
  return 16 * (threadIdx.x >> 6) + frag_row(e);
}
__device__ __forceinline__ int state_n(int j, int e) {
  return 64 * ((threadIdx.x >> 5) & 1) + frag_col(j, e);
}

// 0. C.B^T of chunk blockIdx.y and group blockIdx.x, which every head of
// the group shares: raw products, the fragments above the diagonal or past
// the chunk's rows left zero
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_cb(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Cs = reinterpret_cast<float*>(smem);  // [kQ][kLN]
  float* Bs = Cs + kQ * kLN;                   // [kQ][kLN]
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int s0 = c * kQ;
  const int rows = min(kQ, p.S - s0);
  const size_t off = ((size_t)b * p.S + s0) * p.G * p.N + (size_t)g * p.N;
  {
    Tile<kQ, kN> ct, bt;
    ct.fetch(static_cast<const T*>(p.Cm) + off, (size_t)p.G * p.N, rows, p.N);
    bt.fetch(static_cast<const T*>(p.Bm) + off, (size_t)p.G * p.N, rows, p.N);
    ct.put(Cs, kLN);
    bt.put(Bs, kLN);
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  cb_strip(acc, Cs, kLN, Bs, kLN, ceil8(p.N), rows);
  store_strip(acc, p.cb + (((size_t)b * p.nc + c) * p.G + g) * kQ * kQ, kQ);
}

// 1. the state of chunk blockIdx.y from a zero state, and its decay
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);    // [kQ]
  float* dts = reinterpret_cast<float*>(cum + kQ);  // [kQ]
  float* wts = dts + kQ;                            // [kQ]
  float* xw = wts + kQ;                             // [kQ][kLX]
  float* Bs = xw + kQ * kLX;                        // [kQ][kLB]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N;
  const int s0 = c * kQ;
  const int rows = min(kQ, S - s0);
  const int g = h / (H / p.G);
  const int tid = threadIdx.x;

  Tile<kQ, kP> xt;
  Tile<kQ, kN> bt;
  xt.fetch(static_cast<const T*>(p.x) + ((size_t)b * S + s0) * H * P +
               (size_t)h * P,
           (size_t)H * P, rows, P);
  bt.fetch(static_cast<const T*>(p.Bm) + ((size_t)b * S + s0) * p.G * N +
               (size_t)g * N,
           (size_t)p.G * N, rows, N);
  if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
  xt.put(xw, kLX);
  bt.put(Bs, kLB);
  __syncthreads();
  chunk_cum(p.A[h], dts, cum);
  const double last = cum[kQ - 1];
  if (tid < kQ) wts[tid] = expf((float)(last - cum[tid])) * dts[tid];
  __syncthreads();
  for (int e = tid; e < kQ * kP; e += kThreads)
    xw[(e / kP) * kLX + e % kP] *= wts[e / kP];
  __syncthreads();

  float acc[8][4];
  state_product(acc, xw, Bs, kLB, rows);
  float* out = p.states + (((size_t)b * p.nc + c) * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int pp = state_p(e), nn = state_n(j, e);
      float* o = out + (size_t)pp * N + nn;
      if (pp >= P || nn >= N) continue;
      if ((N & 1) == 0) {      // the pair is whole and 8-byte aligned
        store2(o, acc[j][e], acc[j][e + 1]);
      } else {
        o[0] = acc[j][e];
        if (nn + 1 < N) o[1] = acc[j][e + 1];
      }
    }
  if (tid == 0)
    p.decay[((size_t)b * p.nc + c) * H + h] = expf((float)last);
}

// V consecutive f32 (V = 1 or 4)
template <int V>
struct Vf {
  float v[V];
  __device__ __forceinline__ void load(const float* p) {
    if constexpr (V == 4) {
      const float4 w = *reinterpret_cast<const float4*>(p);
      v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
    } else {
      v[0] = *p;
    }
  }
  __device__ __forceinline__ void store(float* p) const {
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
      *p = v[0];
  }
};

// 2. the state entering each chunk, in place over the chunk states, and
// h_final: one thread per (row, head, V state elements), chunks in order,
// the next kAhead chunks' states in flight.  V = 4 needs P N % 4 == 0.
template <int V>
__global__ void __launch_bounds__(kThreads) ssd_state_passing(Params p) {
  constexpr int kAhead = 4;
  const size_t PN = (size_t)p.P * p.N;
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * V;
  if (e >= (size_t)p.B * p.H * PN) return;
  const size_t bh = e / PN;  // b * H + h
  const int b = (int)(bh / p.H);
  const int h = (int)(bh - (size_t)b * p.H);
  const int nc = p.nc;
  const size_t cs = (size_t)p.H * PN;  // one chunk's states
  float* st = p.states + (size_t)b * nc * cs + (size_t)h * PN + (e % PN);
  const float* dec = p.decay + (size_t)b * nc * p.H + h;
  Vf<V> hv, ahead[kAhead];
  if (p.h0) {
    hv.load(p.h0 + e);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) hv.v[k] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    if (u < nc) ahead[u].load(st + (size_t)u * cs);
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u;
      if (c >= nc) break;
      const Vf<V> s = ahead[u];
      if (c + kAhead < nc) ahead[u].load(st + (size_t)(c + kAhead) * cs);
      hv.store(st + (size_t)c * cs);
      const float d = dec[(size_t)c * p.H];
#pragma unroll
      for (int k = 0; k < V; ++k) hv.v[k] = fmaf(d, hv.v[k], s.v[k]);
    }
  }
  hv.store(p.hf + e);
}

// 3. y of chunk blockIdx.y from its tokens and the state entering it
// (from the scratch, or h0 when kFinal).  kFinal: the sequence is this one
// chunk, and the block also writes h_final = exp(cum_last) h0 + S_0.
// The 64 x 64 products split over the 8 warps as 16 rows (i) by 32
// columns (j or p) each.
template <typename T, bool kFinal>
__global__ void __launch_bounds__(kThreads) ssd_chunk_scan(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);    // [kQ]
  float* dts = reinterpret_cast<float*>(cum + kQ);  // [kQ]
  float* wts = dts + kQ;                            // [kQ]
  float* Cs = wts + kQ;                             // [kQ][kLN]
  float* Bs = Cs + kQ * kLN;  // [kQ][kLN]: (kFinal) B; h [kP][kLN];
                              // (kFinal) B again
  float* xs = Bs + kQ * kLN;  // [kQ][kLX]; (kFinal) then x w
  float* st = xs + kQ * kLX;  // [kQ][kLS]: scores, st[i][j]

  const T* Bm = static_cast<const T*>(p.Bm);
  T* y = static_cast<T*>(p.y);
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N, G = p.G;
  const int s0 = c * kQ;
  const int rows = min(kQ, S - s0);
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const size_t bc_off = ((size_t)b * S + s0) * G * N + (size_t)g * N;
  const size_t x_off = ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const int m0 = 16 * (warp >> 1);  // this warp's rows i
  const int n0 = 32 * (warp & 1);   // and columns j or p
  const bool has_h = kFinal ? p.h0 != nullptr : (c > 0 || p.h0 != nullptr);
  const float* hin =
      !has_h ? nullptr
      : kFinal ? p.h0 + ((size_t)b * H + h) * P * N
               : p.states + (((size_t)b * p.nc + c) * H + h) * P * N;

  // C, x and C.B^T (from the scratch; kFinal: B, to compute it) fetched
  // at once
  {
    Tile<kQ, kN> ct;
    Tile<kQ, kP> xt;
    ct.fetch(static_cast<const T*>(p.Cm) + bc_off, (size_t)G * N, rows, N);
    xt.fetch(static_cast<const T*>(p.x) + x_off, (size_t)H * P, rows, P);
    if constexpr (kFinal) {
      Tile<kQ, kN> bt;
      bt.fetch(Bm + bc_off, (size_t)G * N, rows, N);
      bt.put(Bs, kLN);
    } else {
      Tile<kQ, kQ> cbt;
      cbt.fetch(p.cb + (((size_t)b * p.nc + c) * G + g) * kQ * kQ,
                (size_t)kQ, kQ, kQ);
      cbt.put(st, kLS);
    }
    if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
    ct.put(Cs, kLN);
    xt.put(xs, kLX);
  }
  __syncthreads();
  chunk_cum(p.A[h], dts, cum);

  // the entering state is fetched now and put over B once B is dead
  Tile<kP, kN> ht;
  if (has_h) ht.fetch(hin, (size_t)N, P, N);
  if constexpr (kFinal) {
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    cb_strip(acc, Cs, kLN, Bs, kLN, ceil8(N), rows);
    store_strip(acc, st, kLS);
    __syncthreads();  // C.B^T is in; B is dead
  }

  // scores: st[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i
  for (int e = tid; e < kQ * kQ; e += kThreads) {
    const int i = e / kQ, j = e % kQ;
    float* v = st + i * kLS + j;
    *v = j <= i ? *v * expf((float)(cum[i] - cum[j])) * dts[j] : 0.f;
  }
  __syncthreads();  // scores done
  if (has_h) ht.put(Bs, kLN);
  const float* hs = Bs;

  // y = scores . x (over j <= i < rows) + exp(cum_i) C . h^T + D x
  float yi[4][4], yh[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) yi[j][e] = yh[j][e] = 0.f;
  if (m0 < rows)
    warp_mma3<4>(yi, st, kLS, 1, m0, xs, kLX, 1, n0,
                 min(m0 + 16, ceil8(rows)), 4);
  __syncthreads();  // h is in
  if (has_h && m0 < rows)
    warp_mma3<4>(yh, Cs, kLN, 1, m0, hs, 1, kLN, n0, ceil8(N), 4);
  const float Dh = p.D ? p.D[h] : 0.f;
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = m0 + frag_row(e);
    if (i >= rows) continue;
    const float ei = expf((float)cum[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pp = n0 + frag_col(j, e);
      if (pp >= P) continue;
      const float* xi = xs + i * kLX + pp;
      const float v0 = yi[j][e] + ei * yh[j][e] + Dh * xi[0];
      const float v1 = yi[j][e + 1] + ei * yh[j][e + 1] + Dh * xi[1];
      T* o = y + x_off + (size_t)i * H * P + pp;
      if ((P & 1) == 0) {      // the pair is whole and aligned
        store2(o, v0, v1);
      } else {
        store_f32(o, v0);
        if (pp + 1 < P) store_f32(o + 1, v1);
      }
    }
  }
  if (!kFinal) return;

  // h_final = exp(cum_last) h0 + sum_j w_j x_j (x) B_j
  __syncthreads();  // every read of h and x is done
  const double last = cum[kQ - 1];
  if (tid < kQ) wts[tid] = expf((float)(last - cum[tid])) * dts[tid];
  {
    Tile<kQ, kN> bt;
    bt.fetch(Bm + bc_off, (size_t)G * N, rows, N);
    bt.put(Bs, kLN);
  }
  __syncthreads();
  for (int e = tid; e < kQ * kP; e += kThreads)
    xs[(e / kP) * kLX + e % kP] *= wts[e / kP];
  __syncthreads();
  float acc[8][4];
  state_product(acc, xs, Bs, kLN, rows);
  const float dec = expf((float)last);
  float* hf = p.hf + ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = state_p(e), nn = state_n(j, e);
      if (pp < P && nn < N) {
        const size_t k = (size_t)pp * N + nn;
        hf[k] = has_h ? fmaf(dec, hin[k], acc[j][e]) : acc[j][e];
      }
    }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t scan_smem =
      sizeof(double) * kQ +
      sizeof(float) * (2 * kQ + 2 * kQ * kLN + kQ * kLX + kQ * kLS);
  cudaError_t e;
  if (p.nc == 1) {
    auto scan = ssd_chunk_scan<T, true>;
    if ((e = allow_smem(scan, scan_smem)) != cudaSuccess) return e;
    scan<<<dim3(p.H, 1, p.B), kThreads, scan_smem, stream>>>(p);
    return cudaGetLastError();
  }
  const size_t cb_smem = sizeof(float) * 2 * kQ * kLN;
  auto cbk = ssd_chunk_cb<T>;
  if ((e = allow_smem(cbk, cb_smem)) != cudaSuccess) return e;
  cbk<<<dim3(p.G, p.nc, p.B), kThreads, cb_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t state_smem =
      sizeof(double) * kQ + sizeof(float) * (2 * kQ + kQ * kLX + kQ * kLB);
  auto state = ssd_chunk_state<T>;
  if ((e = allow_smem(state, state_smem)) != cudaSuccess) return e;
  state<<<dim3(p.H, p.nc, p.B), kThreads, state_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const size_t elems = (size_t)p.B * p.H * p.P * p.N;
  if (p.P * p.N % 4 == 0)
    ssd_state_passing<4><<<(unsigned)((elems / 4 + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(p);
  else
    ssd_state_passing<1><<<(unsigned)((elems + kThreads - 1) / kThreads),
                           kThreads, 0, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  auto scan = ssd_chunk_scan<T, false>;
  if ((e = allow_smem(scan, scan_smem)) != cudaSuccess) return e;
  scan<<<dim3(p.H, p.nc, p.B), kThreads, scan_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// One call of the SSD: one launch when the sequence is one chunk of 64
// tokens, else four.  states (B, nc, H, P, N), decay (B, nc, H) and cb
// (B, nc, G, 64, 64) are the caller's f32 scratch, nc = ceil(S / 64);
// unused (may be null) when nc == 1.  Returns the first non-zero cudaGetLastError() (0 = launched).
extern "C" int repro_ssd_fwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* D,
                             const float* h0, void* y, float* hf,
                             float* states, float* decay, float* cb, int B,
                             int S,
                             int H, int P, int G, int N, int is_bf16,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kP || N <= 0 || N > kN)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.dt = dt;
  p.A = A;
  p.Bm = Bm;
  p.Cm = Cm;
  p.D = D;
  p.h0 = h0;
  p.y = y;
  p.hf = hf;
  p.states = states;
  p.decay = decay;
  p.cb = cb;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (S + kQ - 1) / kQ;
  if (p.nc > 65535 || B > 65535 ||
      (p.nc > 1 && (states == nullptr || decay == nullptr || cb == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, st);
  return (int)launch<float>(p, st);
}
