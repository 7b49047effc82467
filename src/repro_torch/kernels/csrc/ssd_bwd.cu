// The backward of the Mamba2 chunked SSD for Hopper (sm_90a), written by
// hand for the PyTorch port.
//
// No Pallas kernel has a backward: the reference trains through XLA's
// autodiff of ops.ssd (src/repro/kernels/ops.py:223).  This is the
// gradient of csrc/ssd.cu's function.  Per (batch row b, head h) and
// chunk c of Q = 64 tokens, with cum_i = sum_{k<=i} dt_k A inclusive
// within the chunk, L_ij = exp(cum_i - cum_j) for j <= i, h_in the state
// entering the chunk (kept by the forward) and G the gradient of the
// state leaving it:
//   G_{c-1} = exp(cum_Q) G_c + R_c,  R_c = sum_i exp(cum_i) dy_i (x) C_i,
//             G_last = dh_final (or 0)
//   dx_j = sum_{i>=j} L_ij dt_j (C_i.B_j) dy_i
//          + dt_j exp(cum_Q - cum_j) G B_j + D dy_j
//   dB_j = sum_{i>=j} L_ij dt_j (dy_i.x_j) C_i + dt_j exp(cum_Q - cum_j) G^T x_j
//   dC_i = sum_{j<=i} L_ij dt_j (dy_i.x_j) B_j + exp(cum_i) h_in^T dy_i
// and through the exponents, with K_ij = L_ij (C_i.B_j)(dy_i.x_j) and
// T_ij = K_ij dt_j, which pulls cum_i up and cum_j down:
//   d(dt A)_k = sum_{i>=k>j} T_ij + sum_{i>=k} r_i,
//   r_i = exp(cum_i) C_i.(h_in^T dy_i) - dt_i V_i,
//   V_j = exp(cum_Q - cum_j) x_j.(G B_j),
//   r_last += sum_j dt_j V_j + exp(cum_Q) sum(G * h_in);
//   ddt_k = A d(dt A)_k + sum_i K_ik + V_k;
//   dA = sum dt_k d(dt A)_k,  dD = sum dy.x.
// The T_ij are summed where they straddle k, not as a row sum less a
// column sum per row: those two cancel to ~1e-5 of dA in f32.
// B's and C's gradients sum over the heads of a group; A's and D's over
// (row, chunk).
//
// Layouts (all contiguous): x, dy, dx (B, S, H, P) and B, C, dB, dC
// (B, S, G, N) in one type, f32 or bf16; dt, ddt (B, S, H), A, D, dA, dD
// (H), f32.  The forward's scratch, f32: states (B, nc, H, P, N), the
// state entering each chunk, and decay (B, nc, H), exp(cum_Q) of each
// chunk (for one chunk: states is h0 or null, decay unused).  The
// wrapper's scratch, f32: dS (B, nc, H, P, N), dBh and dCh (B, S, H, N),
// dA_part and dD_part (B, nc, H).  P <= 64, N <= 128.
//
// What bounds it on an H100.  The backward of the recurrent form needs
// about 5 P N multiply-adds a token and head (dh += dy (x) C, dC = h^T dy,
// dx = dh B, dB = dh^T x and the decay's sum of dh * h) on about twice the
// forward's bytes.  At mamba2's P 64, N 128 and training's 8 x 128 that
// is 5.4 GFLOP against ~60 MB: operations bound it on the CUDA cores' f32
// rate (67 TFLOP/s).  This first version keeps every sum in f32 on the
// CUDA cores (4 x 4 register tiles from shared memory); the chunked form
// does ~2.6 M multiply-adds a (head, chunk) block, ~2x the recurrent
// form's, and the tensor cores are later work.
//
// Design.  The forward's split, run backwards, four launches (two for one
// chunk):
//   1. ssd_bwd_chunk_r: R_c of chunks 1.. into dS, a block a (head, chunk,
//      row);
//   2. ssd_bwd_state_passing: a thread a (row, head, state element) walks
//      the chunks from the last, overwriting R_c with G_c (= dh_final for
//      the last);
//   3. ssd_bwd_chunk: a block a (head, chunk, row) holds the chunk's x, dy,
//      B, C, G and h_in in shared memory (~219 KB) and writes dx, ddt and
//      the head's dB, dC and the block's dA, dD partials;
//   4. ssd_bwd_reduce: dB and dC summed over the group's heads in head
//      order, dA and dD over (row, chunk) in order.
// No atomics: every sum is taken in a fixed order, so two runs from one
// seed give equal gradients.  The padded rows of a ragged last chunk read
// x = dy = B = C = 0 and dt = 0 (an identity step): they add nothing, and
// their gradients are not written.  cum is summed in f64 as the forward
// sums it, and the sums into d(dt A) too.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // tokens a chunk
constexpr int kThreads = 256;
constexpr int kP = 64;        // P <= kP
constexpr int kN = 128;       // N <= kN
// shared-memory row strides, odd so that a 4 x 4 tile's column reads of
// neighbouring rows fall on distinct banks
constexpr int kLP = kP + 1;
constexpr int kLN = kN + 1;
constexpr int kLQ = kQ + 1;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;       // null: no skip
  const void* dy;
  const float* states;  // entering states (B, nc, H, P, N); null: zero
  const float* decay;   // (B, nc, H)
  const float* dhf;     // (B, H, P, N); null: zero
  float* dS;            // (B, nc, H, P, N): R_c, then G_c
  void* dx;
  float* ddt;
  float* dBh;           // (B, S, H, N)
  float* dCh;
  float* dA_part;       // (B, nc, H)
  float* dD_part;
  void* dB;
  void* dC;
  float* dA;
  float* dD;
  int B, S, H, P, G, N, nc;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x cols of src (row r at src + r * stride) into dst[r * ldd + c],
// zero past (nr, ncol) up to (R, CM)
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ldd, const T* src,
                                          size_t stride, int R, int CM,
                                          int nr, int ncol) {
  for (int e = threadIdx.x; e < R * CM; e += kThreads) {
    const int r = e / CM, c = e % CM;
    dst[r * ldd + c] =
        r < nr && c < ncol ? ld(src + (size_t)r * stride + c) : 0.f;
  }
}

// cum (f64, inclusive prefix of dt A over the chunk) by warp 0, from dts
// in shared memory; ends with every thread past a barrier
__device__ void chunk_cum(float A, const float* dts, double* cum) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    double carry = 0.0;
    for (int s = 0; s < kQ / 32; ++s) {
      double v = (double)(dts[s * 32 + tid] * A);
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += u;
      }
      v += carry;
      cum[s * 32 + tid] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float chunk_dt(const Params& p, int b, int h,
                                          int s0, int rows) {
  const int tid = threadIdx.x;
  return tid < rows ? p.dt[((size_t)b * p.S + s0 + tid) * p.H + h] : 0.f;
}

// 1. R_c = sum_i exp(cum_i) dy_i (x) C_i of chunk c = blockIdx.y + 1
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_r(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);    // [kQ]
  float* dts = reinterpret_cast<float*>(cum + kQ);  // [kQ]
  float* dys = dts + kQ;                            // [kQ][kLP]
  float* Cs = dys + kQ * kLP;                       // [kQ][kLN]
  const int h = blockIdx.x, c = blockIdx.y + 1, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N, G = p.G;
  const int s0 = c * kQ;
  const int rows = min(kQ, S - s0);
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
  load_tile(dys, kLP,
            static_cast<const T*>(p.dy) + ((size_t)b * S + s0) * H * P +
                (size_t)h * P,
            (size_t)H * P, kQ, P, rows, P);
  load_tile(Cs, kLN,
            static_cast<const T*>(p.Cm) + ((size_t)b * S + s0) * G * N +
                (size_t)g * N,
            (size_t)G * N, kQ, N, rows, N);
  __syncthreads();
  chunk_cum(p.A[h], dts, cum);
  for (int e = tid; e < kQ * P; e += kThreads)
    dys[(e / P) * kLP + e % P] *= expf((float)cum[e / P]);
  __syncthreads();
  float* out = p.dS + (((size_t)b * p.nc + c) * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads) {
    const int pp = e / N, n = e % N;
    float acc = 0.f;
    for (int i = 0; i < rows; ++i)
      acc = fmaf(dys[i * kLP + pp], Cs[i * kLN + n], acc);
    out[e] = acc;
  }
}

// 2. G_c into dS, from the last chunk back: G_last = dh_final,
// G_{c-1} = decay_c G_c + R_c (R_c read before G_c is written over it)
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_passing(Params p) {
  const size_t PN = (size_t)p.P * p.N;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)p.B * p.H * PN) return;
  const size_t bh = e / PN;
  const int b = (int)(bh / p.H);
  const int h = (int)(bh - (size_t)b * p.H);
  const size_t cs = (size_t)p.H * PN;
  float* ds = p.dS + (size_t)b * p.nc * cs + (size_t)h * PN + (e % PN);
  const float* dec = p.decay + (size_t)b * p.nc * p.H + h;
  float gv = p.dhf ? p.dhf[e] : 0.f;
  for (int c = p.nc - 1; c >= 0; --c) {
    const float r = c > 0 ? ds[(size_t)c * cs] : 0.f;
    ds[(size_t)c * cs] = gv;
    gv = fmaf(dec[(size_t)c * p.H], gv, r);
  }
}

// 3. the chunk's gradients, a block a (head, chunk, row)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* cum = reinterpret_cast<double*>(smem);      // [kQ]
  double* rest = cum + kQ;                            // [kQ]: r_i
  double* daT = rest + kQ;  // [kQ]: sum_{i>=k>j} T_ij
  float* dts = reinterpret_cast<float*>(daT + kQ);    // [kQ]
  float* colK = dts + kQ;   // sum_i K_ij
  float* dxd = colK + kQ;   // dy_i . x_i
  float* Vd = dxd + kQ;     // exp(cum_Q - cum_j) x_j . (G B_j)
  float* Ud = Vd + kQ;      // exp(cum_i) C_i . (h_in^T dy_i)
  float* red = Ud + kQ;     // [kThreads]: sum(G * h_in) partials
  float* xs = red + kThreads;       // [kQ][kLP]
  float* dys = xs + kQ * kLP;       // [kQ][kLP]
  float* Bs = dys + kQ * kLP;       // [kQ][kLN]
  float* Cs = Bs + kQ * kLN;        // [kQ][kLN]
  float* hs = Cs + kQ * kLN;        // [kP][kLN]
  float* gs = hs + kP * kLN;        // [kP][kLN]
  float* M1 = gs + kP * kLN;        // [kQ][kLQ]: L dt_j (C_i.B_j)
  float* M2 = M1 + kQ * kLQ;        // [kQ][kLQ]: L dt_j (dy_i.x_j)
  float* Ks = M2 + kQ * kLQ;        // [kQ][kLQ]: K; later the partials
  float* Vp = Ks;                   // [kQ][kP / 4]
  float* Up = Ks + kQ * (kP / 4);   // [kQ][kN / 4]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int S = p.S, H = p.H, P = p.P, N = p.N, G = p.G;
  const int s0 = c * kQ;
  const int rows = min(kQ, S - s0);
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const size_t x_off = ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const size_t bc_off = ((size_t)b * S + s0) * G * N + (size_t)g * N;
  const size_t st_off = (((size_t)b * p.nc + c) * H + h) * P * N;
  const float* hin = p.nc > 1 ? p.states + st_off
                     : p.states ? p.states + ((size_t)b * H + h) * P * N
                                : nullptr;
  const float* gin = p.nc > 1 ? p.dS + st_off
                     : p.dhf ? p.dhf + ((size_t)b * H + h) * P * N
                             : nullptr;

  if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
  load_tile(xs, kLP, static_cast<const T*>(p.x) + x_off, (size_t)H * P, kQ,
            kP, rows, P);
  load_tile(dys, kLP, static_cast<const T*>(p.dy) + x_off, (size_t)H * P,
            kQ, kP, rows, P);
  load_tile(Bs, kLN, static_cast<const T*>(p.Bm) + bc_off, (size_t)G * N,
            kQ, kN, rows, N);
  load_tile(Cs, kLN, static_cast<const T*>(p.Cm) + bc_off, (size_t)G * N,
            kQ, kN, rows, N);
  load_tile(hs, kLN, hin, (size_t)N, kP, kN, hin ? P : 0, N);
  load_tile(gs, kLN, gin, (size_t)N, kP, kN, gin ? P : 0, N);
  __syncthreads();
  chunk_cum(p.A[h], dts, cum);
  const double last = cum[kQ - 1];

  // C.B^T and dy.x^T in 4 x 4 tiles of (i, j), j <= i only; then M1, M2
  // and K, zero above the diagonal
  {
    const int i0 = 4 * (tid / 16), j0 = 4 * (tid % 16);
    float cb[4][4], dx4[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cb[r][q] = dx4[r][q] = 0.f;
    if (j0 <= i0 + 3) {
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = Cs[(i0 + r) * kLN + n];
          bv[r] = Bs[(j0 + r) * kLN + n];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) cb[r][q] = fmaf(cv[r], bv[q], cb[r][q]);
      }
      for (int pp = 0; pp < P; ++pp) {
        float dv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dv[r] = dys[(i0 + r) * kLP + pp];
          xv[r] = xs[(j0 + r) * kLP + pp];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dx4[r][q] = fmaf(dv[r], xv[q], dx4[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + r, j = j0 + q;
        float m1 = 0.f, m2 = 0.f, k = 0.f;
        if (j <= i) {
          const float l = expf((float)(cum[i] - cum[j]));
          m1 = l * dts[j] * cb[r][q];
          m2 = l * dts[j] * dx4[r][q];
          k = l * cb[r][q] * dx4[r][q];
        }
        if (i == j) dxd[i] = dx4[r][q];
        M1[i * kLQ + j] = m1;
        M2[i * kLQ + j] = m2;
        Ks[i * kLQ + j] = k;
      }
  }
  // sum(G * h_in), this thread's share in a fixed order
  {
    float acc = 0.f;
    for (int e = tid; e < P * N; e += kThreads)
      acc = fmaf(gs[(e / N) * kLN + e % N], hs[(e / N) * kLN + e % N], acc);
    red[tid] = acc;
  }
  __syncthreads();
  if (tid < kQ) {  // column sums of K; the T_ij that straddle k = tid
    const int k = tid;
    float cs = 0.f;
    for (int i = 0; i < kQ; ++i) cs += Ks[i * kLQ + k];
    colK[k] = cs;
    double st = 0.0;
    for (int i = k; i < kQ; ++i)
      for (int j = 0; j < k; ++j)
        st += (double)(Ks[i * kLQ + j] * dts[j]);
    daT[k] = st;
  }
  __syncthreads();  // Ks is free for the partials

  // dx: tiles of (j, p)
  const float Dh = p.D ? p.D[h] : 0.f;
  T* dx = static_cast<T*>(p.dx) + x_off;
  const int pt = (P + 3) / 4, nt = (N + 3) / 4;
  for (int t = tid; t < 16 * pt; t += kThreads) {
    const int j0 = 4 * (t / pt), p0 = 4 * (t % pt);
    float a[4][4], gb[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][q] = gb[r][q] = 0.f;
    for (int i = j0; i < kQ; ++i) {
      float mv[4], dv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mv[r] = M1[i * kLQ + j0 + r];
        dv[r] = dys[i * kLP + p0 + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[r][q] = fmaf(mv[r], dv[q], a[r][q]);
    }
    for (int n = 0; n < N; ++n) {
      float bv[4], gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        bv[r] = Bs[(j0 + r) * kLN + n];
        gv[r] = gs[(p0 + r) * kLN + n];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gb[r][q] = fmaf(bv[r], gv[q], gb[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      const float te = expf((float)(last - cum[j]));
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = p0 + q;
        v = fmaf(xs[j * kLP + pp], gb[r][q], v);
        if (j < rows && pp < P)
          st(dx + (size_t)j * H * P + pp,
             a[r][q] + dts[j] * te * gb[r][q] + Dh * dys[j * kLP + pp]);
      }
      Vp[j * (kP / 4) + p0 / 4] = v;
    }
  }

  // dB (per head): tiles of (j, n)
  float* dBh = p.dBh + ((size_t)b * S + s0) * H * N + (size_t)h * N;
  float* dCh = p.dCh + ((size_t)b * S + s0) * H * N + (size_t)h * N;
  for (int t = tid; t < 16 * nt; t += kThreads) {
    const int j0 = 4 * (t / nt), n0 = 4 * (t % nt);
    float a[4][4], gx[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][q] = gx[r][q] = 0.f;
    for (int i = j0; i < kQ; ++i) {
      float mv[4], cv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mv[r] = M2[i * kLQ + j0 + r];
        cv[r] = Cs[i * kLN + n0 + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[r][q] = fmaf(mv[r], cv[q], a[r][q]);
    }
    for (int pp = 0; pp < P; ++pp) {
      float xv[4], gv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xv[r] = xs[(j0 + r) * kLP + pp];
        gv[r] = gs[pp * kLN + n0 + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) gx[r][q] = fmaf(xv[r], gv[q], gx[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int j = j0 + r;
      if (j >= rows) continue;
      const float w = dts[j] * expf((float)(last - cum[j]));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n0 + q < N)
          dBh[(size_t)j * H * N + n0 + q] = fmaf(w, gx[r][q], a[r][q]);
    }
  }

  // dC (per head): tiles of (i, n)
  for (int t = tid; t < 16 * nt; t += kThreads) {
    const int i0 = 4 * (t / nt), n0 = 4 * (t % nt);
    float a[4][4], hd[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) a[r][q] = hd[r][q] = 0.f;
    for (int j = 0; j <= i0 + 3; ++j) {
      float mv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mv[r] = M2[(i0 + r) * kLQ + j];
        bv[r] = Bs[j * kLN + n0 + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[r][q] = fmaf(mv[r], bv[q], a[r][q]);
    }
    for (int pp = 0; pp < P; ++pp) {
      float dv[4], hv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        dv[r] = dys[(i0 + r) * kLP + pp];
        hv[r] = hs[pp * kLN + n0 + r];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) hd[r][q] = fmaf(dv[r], hv[q], hd[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + r;
      const float ei = expf((float)cum[i]);
      float u = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        u = fmaf(Cs[i * kLN + n0 + q], hd[r][q], u);
        if (i < rows && n0 + q < N)
          dCh[(size_t)i * H * N + n0 + q] = fmaf(ei, hd[r][q], a[r][q]);
      }
      Up[i * (kN / 4) + n0 / 4] = u;
    }
  }
  __syncthreads();

  // the exponents' gradient, then ddt and the block's dA, dD partials
  if (tid < kQ) {
    const int i = tid;
    float v = 0.f, u = 0.f;
    for (int t = 0; t < pt; ++t) v += Vp[i * (kP / 4) + t];
    for (int t = 0; t < nt; ++t) u += Up[i * (kN / 4) + t];
    Vd[i] = expf((float)(last - cum[i])) * v;
    Ud[i] = expf((float)cum[i]) * u;
  }
  __syncthreads();
  if (tid < kQ) rest[tid] = (double)(Ud[tid] - dts[tid] * Vd[tid]);
  __syncthreads();
  if (tid == 0) {
    float gh = 0.f, sv = 0.f, dd = 0.f;
    for (int e = 0; e < kThreads; ++e) gh += red[e];
    for (int j = 0; j < kQ; ++j) sv = fmaf(dts[j], Vd[j], sv);
    for (int i = 0; i < rows; ++i) dd += dxd[i];
    rest[kQ - 1] += (double)(sv + expf((float)last) * gh);
    // d(dt A)_k = daT_k + sum_{i >= k} r_i, from the end
    const float A = p.A[h];
    double run = 0.0, da_sum = 0.0;
    float* ddt = p.ddt + ((size_t)b * S + s0) * H + h;
    for (int k = kQ - 1; k >= 0; --k) {
      run += rest[k];
      const float da = (float)(run + daT[k]);
      if (k < rows) {
        ddt[(size_t)k * H] = A * da + colK[k] + Vd[k];
        da_sum += (double)(dts[k] * da);
      }
    }
    const size_t part = ((size_t)b * p.nc + c) * H + h;
    p.dA_part[part] = (float)da_sum;
    p.dD_part[part] = dd;
  }
}

// 4. dB, dC over the group's heads in head order; dA, dD over (row, chunk)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(Params p) {
  const size_t M = (size_t)p.B * p.S * p.G * p.N;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const int rep = p.H / p.G;
  if (e < 2 * M) {
    const bool is_c = e >= M;
    const size_t k = is_c ? e - M : e;
    const int n = (int)(k % p.N);
    const size_t bsg = k / p.N;  // (b * S + s) * G + g
    const int g = (int)(bsg % p.G);
    const size_t bs = bsg / p.G;
    const float* src =
        (is_c ? p.dCh : p.dBh) + (bs * p.H + (size_t)g * rep) * p.N + n;
    float acc = 0.f;
    for (int r = 0; r < rep; ++r) acc += src[(size_t)r * p.N];
    st(static_cast<T*>(is_c ? p.dC : p.dB) + k, acc);
  } else if (e < 2 * M + 2 * (size_t)p.H) {
    const bool is_d = e >= 2 * M + p.H;
    const int h = (int)(e - 2 * M - (is_d ? p.H : 0));
    if (is_d && !p.D) return;
    const float* src = is_d ? p.dD_part : p.dA_part;
    float acc = 0.f;
    for (int bc = 0; bc < p.B * p.nc; ++bc) acc += src[(size_t)bc * p.H + h];
    (is_d ? p.dD : p.dA)[h] = acc;
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
  cudaError_t e;
  if (p.nc > 1) {
    const size_t r_smem = sizeof(double) * kQ +
                          sizeof(float) * (kQ + kQ * kLP + kQ * kLN);
    auto rk = ssd_bwd_chunk_r<T>;
    if ((e = allow_smem(rk, r_smem)) != cudaSuccess) return e;
    rk<<<dim3(p.H, p.nc - 1, p.B), kThreads, r_smem, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    const size_t elems = (size_t)p.B * p.H * p.P * p.N;
    ssd_bwd_state_passing<<<(unsigned)((elems + kThreads - 1) / kThreads),
                            kThreads, 0, stream>>>(p);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  const size_t c_smem =
      sizeof(double) * 3 * kQ +
      sizeof(float) * (5 * kQ + kThreads + 2 * kQ * kLP + 2 * kQ * kLN +
                       2 * kP * kLN + 3 * kQ * kLQ);
  auto ck = ssd_bwd_chunk<T>;
  if ((e = allow_smem(ck, c_smem)) != cudaSuccess) return e;
  ck<<<dim3(p.H, p.nc, p.B), kThreads, c_smem, stream>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t red = 2 * (size_t)p.B * p.S * p.G * p.N + 2 * (size_t)p.H;
  ssd_bwd_reduce<T><<<(unsigned)((red + kThreads - 1) / kThreads), kThreads,
                      0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The SSD's backward: four launches, two when the sequence is one chunk.
// states: the forward's entering states (B, nc, H, P, N) when nc > 1,
// else h0 (B, H, P, N) or null; decay (B, nc, H) when nc > 1.  dS
// (B, nc, H, P, N) scratch when nc > 1.  Returns the first non-zero
// cudaGetLastError() (0 = launched).
extern "C" int repro_ssd_bwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* D,
                             const void* dy, const float* states,
                             const float* decay, const float* dhf, float* dS,
                             void* dx, float* ddt, float* dBh, float* dCh,
                             float* dA_part, float* dD_part, void* dB,
                             void* dC, float* dA, float* dD, int B, int S,
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
  p.dy = dy;
  p.states = states;
  p.decay = decay;
  p.dhf = dhf;
  p.dS = dS;
  p.dx = dx;
  p.ddt = ddt;
  p.dBh = dBh;
  p.dCh = dCh;
  p.dA_part = dA_part;
  p.dD_part = dD_part;
  p.dB = dB;
  p.dC = dC;
  p.dA = dA;
  p.dD = dD;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (S + kQ - 1) / kQ;
  if (p.nc > 65535 || B > 65535 ||
      (p.nc > 1 && (states == nullptr || decay == nullptr || dS == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, st);
  return (int)launch<float>(p, st);
}
