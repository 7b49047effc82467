// Mamba2 chunked SSD for Hopper (sm_90a), written by hand for the PyTorch
// port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd.py (ssd_pallas,
// body _kernel).  Per (batch row b, head h), with the state h (P, N)
// carried through the chunks of the sequence in order:
//   cum_i  = sum_{k<=i} dt_k A          (inclusive, within the chunk)
//   y_i    = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i . B_j) x_j   intra-chunk
//          + exp(cum_i) C_i . h^T                                 inter-chunk
//          + D x_i                                                (optional)
//   h     <- exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// Head h reads B and C of group h / (H / G).
//
// Layouts (all contiguous): x, y (B, S, H, P) f32 or bf16; dt (B, S, H)
// f32; A, D (H,) f32; B, C (B, S, G, N) in x's type; h0, h_final
// (B, H, P, N) f32.  P <= 64, N <= 128.  All arithmetic in f32 but the
// in-chunk cumulative decay (f64, see Masks).
//
// What bounds it on an H100.  A chunk of Q tokens costs Q*Q*N (C.B^T) +
// Q*Q*P (scores.x) + 2*Q*P*N (C.h^T, state update) multiply-adds on
// Q*(P + 2N) values read and Q*P written: ~Q/2 operations a byte, so at
// mamba2's P 64, N 128 it is bound by operations.  The products run in
// f32 on the CUDA cores, not in TF32 on the tensor cores, because the
// port holds f32 logits to the plain version within 2e-4.
//
// Design.  The TPU kernel's grid runs (b, h, chunk) with the chunk axis
// sequential and keeps a Q x Q score tile in VMEM at Q = 256.  Here one
// block of 256 threads per (h, b) loops over the chunks itself (that loop
// replaces the sequential grid axis), and the state never leaves the
// chip: each thread keeps an 8 x 4 tile of h in registers for the update
// and mirrors it into shared memory for the C.h^T reads.
//
// Chunk length.  The kernel uses Q = 64 whatever chunk length the caller
// asked for.  At Q = 256 the f32 score tile alone is 256 KB, over the
// 227 KB a block may have; at Q = 64 the block holds B and C (2 x 33 KB),
// h (33 KB), x (16 KB) and the scores (16.6 KB): ~130 KB.  The SSD is
// chunk-invariant (tests/test_kernels.py::test_ssd_chunk_invariance), so
// y and h_final agree with any chunking to rounding.  Q = 64 also fixes
// the thread tiles below (16 x 16 threads of 4 x 4 outputs).
//
// Masks.  Only the i >= j differences are exponentiated (cum decreases,
// so they are <= 0); the others are set to 0 without an exp.  cum is
// summed and differenced in f64 (64 values a chunk): in f32 the
// difference of two cumulative sums of ~800 (mamba2's A reaches -16)
// would lose ~5e-5 of every exponent.  The ragged
// last chunk is read by bounds: its missing rows get x = B = C = 0 and
// dt = 0, an identity step for the state, and their y is never written.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kQ = 64;          // tokens a chunk
constexpr int kThreads = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kQ == 64 && kThreads == 256,
              "the thread tiles below assume Q = 64 and 256 threads");

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
  int B, S, H, P, G, N;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd(Params p) {
  const int P = p.P, N = p.N, S = p.S, H = p.H;
  const int NS = N + 1;      // padded row stride of B, C and h
  constexpr int QS = kQ + 1;  // padded row stride of the scores

  extern __shared__ double smem_d[];
  double* cum = smem_d;                                // [kQ]
  float* Bs = reinterpret_cast<float*>(cum + kQ);      // [kQ][NS]
  float* Cs = Bs + kQ * NS;                            // [kQ][NS]
  float* hs = Cs + kQ * NS;                            // [P][NS]
  float* xs = hs + P * NS;                             // [kQ][P]
  float* ss = xs + kQ * P;                             // [kQ][QS]
  float* dts = ss + kQ * QS;                           // [kQ]
  float* wts = dts + kQ;                               // [kQ]

  const T* x = static_cast<const T*>(p.x);
  const T* Bm = static_cast<const T*>(p.Bm);
  const T* Cm = static_cast<const T*>(p.Cm);
  T* y = static_cast<T*>(p.y);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int g = h / (H / p.G);
  const float A = p.A[h];
  const float Dh = p.D ? p.D[h] : 0.f;
  const int tid = threadIdx.x;

  // this thread's state tile: rows tp + 8a (a < 8), columns tn + 32c (c < 4)
  const int tp = tid >> 5;
  const int tn = tid & 31;
  float hreg[8][4];
  const size_t hbase = ((size_t)b * H + h) * P * N;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pp = tp + 8 * a;
      const int nn = tn + 32 * c;
      float v = 0.f;
      if (pp < P && nn < N) {
        if (p.h0) v = p.h0[hbase + (size_t)pp * N + nn];
        hs[pp * NS + nn] = v;
      }
      hreg[a][c] = v;
    }
  }

  // this thread's score and output tiles: rows ti + 16a (a < 4), columns
  // tj + 16c (c < 4): keys j for the scores, head columns for y
  const int ti = tid >> 4;
  const int tj = tid & 15;

  const int nchunks = (S + kQ - 1) / kQ;
  for (int ch = 0; ch < nchunks; ++ch) {
    const int s0 = ch * kQ;
    const int rows = min(kQ, S - s0);
    __syncthreads();  // the last chunk's reads of B, C, x and h are done

    for (int e = tid; e < kQ * N; e += kThreads) {
      const int i = e / N;
      const int n = e - i * N;
      float bv = 0.f, cv = 0.f;
      if (i < rows) {
        const size_t gi = (((size_t)b * S + s0 + i) * p.G + g) * N + n;
        bv = load_f32(Bm + gi);
        cv = load_f32(Cm + gi);
      }
      Bs[i * NS + n] = bv;
      Cs[i * NS + n] = cv;
    }
    for (int e = tid; e < kQ * P; e += kThreads) {
      const int i = e / P;
      const int pp = e - i * P;
      xs[e] = i < rows
          ? load_f32(x + (((size_t)b * S + s0 + i) * H + h) * P + pp)
          : 0.f;
    }
    if (tid < kQ)
      dts[tid] = tid < rows ? p.dt[((size_t)b * S + s0 + tid) * H + h] : 0.f;
    __syncthreads();

    // inclusive prefix sum of dt*A over the chunk, in f64: one warp, two
    // per lane
    if (tid < 32) {
      double v0 = (double)(dts[tid] * A);
      double v1 = (double)(dts[tid + 32] * A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u0 = __shfl_up_sync(kFull, v0, o);
        const double u1 = __shfl_up_sync(kFull, v1, o);
        if (tid >= o) {
          v0 += u0;
          v1 += u1;
        }
      }
      v1 += __shfl_sync(kFull, v0, 31);
      cum[tid] = v0;
      cum[tid + 32] = v1;
    }
    __syncthreads();
    const double total = cum[kQ - 1];
    if (tid < kQ) wts[tid] = expf((float)(total - cum[tid])) * dts[tid];

    // scores[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i
    {
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ti + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = Bs[(tj + 16 * c) * NS + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cv[a], bv[c], acc[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * a;
          const int j = tj + 16 * c;
          ss[i * QS + j] =
              i >= j ? acc[a][c] * expf((float)(cum[i] - cum[j])) * dts[j]
                     : 0.f;
        }
      }
    }
    __syncthreads();

    // y = scores . x + exp(cum_i) C_i . h^T + D x, with h entering the chunk
    {
      float yi[4][4], yh[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) yi[a][c] = yh[a][c] = 0.f;
      for (int j = 0; j < rows; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) sv[a] = ss[(ti + 16 * a) * QS + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tj + 16 * c;
          xv[c] = pp < P ? xs[j * P + pp] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[a][c] = fmaf(sv[a], xv[c], yi[a][c]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[4], hv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) cv[a] = Cs[(ti + 16 * a) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tj + 16 * c;
          hv[c] = pp < P ? hs[pp * NS + n] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) yh[a][c] = fmaf(cv[a], hv[c], yh[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ti + 16 * a;
        if (i >= rows) continue;
        const float ei = expf((float)cum[i]);
        T* yrow = y + (((size_t)b * S + s0 + i) * H + h) * P;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int pp = tj + 16 * c;
          if (pp < P)
            store_f32(yrow + pp,
                      yi[a][c] + ei * yh[a][c] + Dh * xs[i * P + pp]);
        }
      }
    }
    __syncthreads();  // every read of h entering the chunk is done

    // h <- exp(total) h + sum_j w_j x_j (x) B_j
    const float dec = expf((float)total);
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) hreg[a][c] *= dec;
    for (int j = 0; j < rows; ++j) {
      const float w = wts[j];
      float xv[8], bv[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int pp = tp + 8 * a;
        xv[a] = pp < P ? xs[j * P + pp] * w : 0.f;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int nn = tn + 32 * c;
        bv[c] = nn < N ? Bs[j * NS + nn] : 0.f;
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) hreg[a][c] = fmaf(xv[a], bv[c], hreg[a][c]);
    }
#pragma unroll
    for (int a = 0; a < 8; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int pp = tp + 8 * a;
        const int nn = tn + 32 * c;
        if (pp < P && nn < N) hs[pp * NS + nn] = hreg[a][c];
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int pp = tp + 8 * a;
      const int nn = tn + 32 * c;
      if (pp < P && nn < N) p.hf[hbase + (size_t)pp * N + nn] = hreg[a][c];
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int NS = p.N + 1;
  const size_t smem = sizeof(double) * kQ +
                      sizeof(float) * ((size_t)2 * kQ * NS + p.P * NS +
                                       kQ * p.P + kQ * (kQ + 1) + 2 * kQ);
  auto kernel = ssd_fwd<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(p.H, p.B), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 = launched).
extern "C" int repro_ssd_fwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* D,
                             const float* h0, void* y, float* hf, int B,
                             int S, int H, int P, int G, int N, int is_bf16,
                             void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kMaxP || N <= 0 || N > kMaxN)
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
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, st);
  return (int)launch<float>(p, st);
}
