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
//             G_last = dh_final (or 0), dh0 = G_{-1} (when asked)
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
// wrapper's scratch, f32: dS (B, nc - 1, H, P, N), the gradient G_c of
// the state leaving each chunk but the last; cb (B, nc, G, 64, 64), each
// chunk's C.B^T; dBp and dCp (B, S, H / hs, N), the head slices' dB and
// dC; dA_part and dD_part (B, nc, H).  P <= 64, N <= 128, G | H, hs |
// H / G.
//
// What bounds it on an H100.  The backward of the recurrent form needs
// about 5 P N multiply-adds a token and head (dh += dy (x) C, dC = h^T dy,
// dx = dh B, dB = dh^T x and the decay's sum of dh * h) on about twice the
// forward's bytes: at mamba2's P 64, N 128 and training's 8 x 128, 5.4
// GFLOP against ~86 MB.  The chunked form here does ~12 (64^3)
// multiply-adds a (head, chunk) in its products, each product three TF32
// products on the tensor cores (3xTF32, below): ~19 GFLOP of TF32 work at
// 8 x 128, 0.04 ms at the 495 TFLOP/s peak, beside 0.026 ms of bytes.
// The same algebra on the CUDA cores in 4 x 4 register tiles, with 218 KB
// of shared memory a block (one block an SM) and one thread summing the
// straddling T_ij, ran at 41x that bound.
//
// Design.  Three launches:
//   1. ssd_bwd_state: two kinds of block in one grid.  A walk block, one
//      a (row, head, half of N), walks the chunks from the last: it forms
//      R_c = (exp(cum) dy)^T C on the tensor cores, updates G in registers
//      (G_{c-1} = decay_c G_c + R_c) and writes G_{c-1} into dS; asked for
//      h0's gradient, it takes one more step, through chunk 0, and writes
//      G_{-1} = dh0 (for one chunk the walk is then that step alone).  R never
//      goes to device memory; G_c cannot be formed inside the chunk
//      blocks, since it needs every later chunk's R.  A cb block, one a
//      (group, chunk, row), forms the chunk's C.B^T once for the heads of
//      the group (all 64 of mamba2's), as the forward's ssd_chunk_cb does.
//   2. ssd_bwd_chunk: two kinds of block in one grid, each within 113 KB
//      of shared memory so that two blocks (16 warps) share an SM:
//      - a dBC block, one a (slice of hs heads of a group, half of N,
//        chunk, row), keeps the chunk's C and B halves and walks its
//        heads in order, adding each head's M2^T C + diag(w) x G into dB
//        and M2 B + diag(e) dy h_in into dC in registers (M2 = L dt_j
//        (dy.x^T), w_j = dt_j exp(cum_Q - cum_j), e_i = exp(cum_i)),
//        then writes the slice's sums into dBp, dCp: a per-head
//        (B, S, H, N) scratch (134 MB at 8 x 128) shrinks hs times (hs
//        from the wrapper's plan: 8 at 8 x 128, 17 MB);
//      - a dx block, one a (head, chunk, row), forms dy.x^T, M1 = L dt_j
//        CB and K, then dx = M1^T dy + w B G^T + D dy, C h_in^T for r_i,
//        and the straddling sums, ddt and the block's dA, dD partials.
//   3. ssd_bwd_reduce: dB and dC over a group's slices in slice order; dA
//      and dD over (row, chunk), a warp each.
// Scratch moved at 8 x 128 f32: dS 17 MB written and read twice, cb 0.3
// MB, dBp/dCp 8 MB written and read, where forming R_c apart, passing the
// states over it and a per-head dB/dC scratch moved ~218 MB.
//
// Every product runs on the tensor cores in 3xTF32 by mma.sync m16n8k8,
// a warp a 16-row strip of a 64 x 64 output: the eight products of the
// chunk (C.B^T, dy.x^T twice, M1^T dy, B G^T, C h^T, M2^T C, x G, M2 B,
// dy h) and R_c.  Operands stay in their own layouts in shared
// memory and are read transposed through warp_mma3's strides; a buffer's
// row stride puts a fragment's reads on 32 banks (4 banks apart where the
// contraction runs along a row, 8 where it runs down a column).  dy in
// the dx block and M2 in the dBC block are read both ways, and take 2-way
// conflicts one way.  Fragments above the causal diagonal or past a
// ragged chunk's rows are not computed.
//
// No thread walks a chunk's rows alone: the straddling sums take
// each row's exclusive prefix over j (a warp-shuffle scan in f64, eight
// rows a warp) and add it where k <= i, then the eight warps' column
// partials are summed by a fixed butterfly; the column sums of K the same
// way; r's suffix sum, ddt and the dA, dD, V, sum(G * h_in) sums by one
// warp's shuffles, two rows a lane.  No atomics: every sum is taken in a
// fixed order, so two runs from one seed give equal gradients.  The
// padded rows of a ragged last chunk read x = dy = B = C = 0 and dt = 0
// (an identity step): they add nothing, and their gradients are not
// written.  cum is summed and differenced in f64, and the sums into
// d(dt A) too.
//
// Resources (nvcc -Xptxas -v and cudaOccupancyMaxActiveBlocksPerMultiprocessor
// on an H100, sm_90a; chip_smoke.py prints both; 256 threads a block):
//   ssd_bwd_chunk  114,304 bytes of dynamic shared memory (the dx block;
//                  the dBC block 109,824), 128 registers (capped for two
//                  blocks an SM; 12 bytes spilled, bf16 28), 2 blocks an SM;
//   ssd_bwd_state  75,008 bytes (the walk block's two buffers; the cb
//                  block 67,584), 106 registers (bf16 117), 2 blocks an SM;
//   ssd_bwd_reduce no shared memory, 32 registers, 8 blocks an SM.
// f32 tiles go from device to shared memory by cp.async (no staging
// registers: with them the dBC block spilled 208 bytes), bf16 tiles
// through registers, widened; rows whose width, stride or start is not
// on four elements (a half of N at N % 4 != 0) one element at a time.  The dBC block sits at its register cap:
// staging h_in early there, as the dx block does, spilled 108 bytes and
// was slower.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kQ = 64;        // tokens a chunk
constexpr int kThreads = 256;
constexpr int kP = 64;        // P <= kP
constexpr int kN = 128;       // N <= kN
constexpr int kH = 64;        // the half of N a walk or dBC block takes
// Row strides in shared memory (floats): 4 banks apart between rows where
// a fragment reads along the row, 8 where it reads down a column.
constexpr int kR64 = 64 + 4;    // rows of 64, read along the row
constexpr int kC64 = 64 + 8;    // rows of 64, read down the column
constexpr int kR128 = 128 + 4;  // rows of 128, read along the row
constexpr int kLK = kQ + 1;     // K, read by rows as scalars
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;       // null: no skip
  const void* dy;
  const float* states;  // nc > 1: entering states (B, nc, H, P, N);
                        // nc == 1: h0 (B, H, P, N) or null
  const float* decay;   // (B, nc, H)
  const float* dhf;     // (B, H, P, N); null: zero
  float* dS;            // (B, nc - 1, H, P, N): G_c for c < nc - 1
  float* dh0;           // (B, H, P, N): G_{-1}, h0's gradient; null: none
  float* cb;            // (B, nc, G, kQ, kQ): C_i . B_j
  void* dx;
  float* ddt;
  float* dBp;           // (B, S, H / hs, N)
  float* dCp;
  float* dA_part;       // (B, nc, H)
  float* dD_part;
  void* dB;
  void* dC;
  float* dA;
  float* dD;
  int B, S, H, P, G, N, nc, hs;
  int has_h0;           // nc > 1: whether chunk 0 enters with a state
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

// Whether rows of ncol elements at src, stride apart, may be read four
// elements at a time: ncol and the stride whole fours and src on four
// elements' bytes.  A half of N at N % 4 != 0 (ncol 64, stride N) may not.
template <typename T>
__device__ __forceinline__ bool by4(const T* src, size_t stride, int ncol) {
  return (((size_t)ncol | stride) & 3) == 0 &&
         (reinterpret_cast<uintptr_t>(src) & (4 * sizeof(T) - 1)) == 0;
}

// An R x CM tile, row r of src at src + r * stride, as this thread's
// share: Tile<R, CM>::n float4s, fetched into registers all at once (so
// that their latencies overlap) and put into shared memory later.  Rows
// from nr on and columns from ncol on read as zero.  Neighbouring threads
// take neighbouring 16 bytes of a row.  (As csrc/ssd.cu's.)
template <int R, int CM>
struct Tile {
  static constexpr int n = R * (CM / 4) / kThreads;
  static_assert(R * (CM / 4) % kThreads == 0, "whole float4s a thread");
  float4 v[n];

  template <typename T>
  __device__ __forceinline__ void fetch(const T* src, size_t stride, int nr,
                                        int ncol) {
    if (by4(src, stride, ncol)) {
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
  // sum over this thread's share of v * (the same elements of src, an
  // R x CM tile at stride ld in shared memory), in a fixed order
  __device__ __forceinline__ float dot(const float* src, int ld) const {
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < n; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const float4 s = *reinterpret_cast<const float4*>(
          src + (e / (CM / 4)) * ld + (e % (CM / 4)) * 4);
      acc = fmaf(v[u].x, s.x, acc);
      acc = fmaf(v[u].y, s.y, acc);
      acc = fmaf(v[u].z, s.z, acc);
      acc = fmaf(v[u].w, s.w, acc);
    }
    return acc;
  }
};

// 16 bytes from device to shared memory without passing through
// registers; in flight until cp_async_wait
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// the copies issued since the last commit form a group; wait until at
// most one group (the last) is still in flight
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// An R x CM tile into shared memory at dst (row stride ld), zero past
// (nr, ncol), as Tile's fetch and put: f32 rows of whole, aligned
// float4s by cp.async (the caller waits with cp_async_wait before its
// barrier), others (bf16, ragged widths and strides) through registers.
template <int R, int CM, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t stride, int nr, int ncol) {
  if constexpr (std::is_same<T, float>::value) {
    if (by4(src, stride, ncol)) {
      constexpr int n = R * (CM / 4) / kThreads;
#pragma unroll
      for (int u = 0; u < n; ++u) {
        const int e = threadIdx.x + u * kThreads;
        const int r = e / (CM / 4), c = (e % (CM / 4)) * 4;
        float* d = dst + r * ld + c;
        if (r < nr && c < ncol)
          cp_async16(d, src + (size_t)r * stride + c);
        else
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      return;
    }
  }
  Tile<R, CM> t;
  t.fetch(src, stride, nr, ncol);
  t.put(dst, ld);
}

// 3xTF32 on the tensor cores, as csrc/ssd.cu.  An f32 operand a is split
// into hi, a with its 13 low mantissa bits cleared (a TF32 value), and
// lo, a - hi (exact) with the same bits cleared; a.b is taken as hi.hi +
// hi.lo + lo.hi, each product by mma.sync m16n8k8 with f32 accumulation.
// What is dropped (lo.lo, and the bits cut from lo) is under 2^-20 of a.b.
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

// One warp: acc[j] += sum_{k0 <= k < k1} A(m0 + r, k) Bm(k, n0 + 8 j + c)
// for the 16 x 8 fragments j < live (of NT side by side), in 3xTF32.
// Operands in shared memory: A(m, k) at A[m * am + k * ak], Bm(k, n) at
// Bm[k * bk + n * bn]; k0 and k1 multiples of 8.  Fragment element e of
// lane (g = lane / 4, t = lane % 4) is row m0 + g + 8 (e / 2), column
// n0 + 8 j + 2 t + e % 2.  (csrc/ssd.cu's, with a first k, and the
// fragments taken in pairs: a warp issues in order, and each fragment's
// three products accumulate into one register set, so the pair's are
// interleaved, two products apart; 5% faster at 8 x 128 than back to
// back, where four at once spilled.)  With ks, A(m, k) is taken times
// ks[k].
template <int NT>
__device__ __forceinline__ void warp_mma3(float (&acc)[NT][4],
                                          const float* __restrict__ A,
                                          int am, int ak, int m0,
                                          const float* __restrict__ Bm,
                                          int bk, int bn, int n0, int k0,
                                          int k1, int live,
                                          const float* __restrict__ ks =
                                              nullptr) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float* a0 = A + (m0 + g) * am + t * ak;
  const float* b0 = Bm + t * bk + (n0 + g) * bn;
  for (int k = k0; k < k1; k += 8) {
    const float s0 = ks ? ks[k + t] : 1.f, s4 = ks ? ks[k + t + 4] : 1.f;
    uint32_t ah[4], al[4];
    split_tf32(a0[k * ak] * s0, ah[0], al[0]);
    split_tf32(a0[k * ak + 8 * am] * s0, ah[1], al[1]);
    split_tf32(a0[(k + 4) * ak] * s4, ah[2], al[2]);
    split_tf32(a0[(k + 4) * ak + 8 * am] * s4, ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      if (j >= live) break;
      const bool two = j + 1 < live;
      uint32_t bh[2][2], bl[2][2];
      split_tf32(b0[k * bk + 8 * j * bn], bh[0][0], bl[0][0]);
      split_tf32(b0[(k + 4) * bk + 8 * j * bn], bh[0][1], bl[0][1]);
      if (two) {
        split_tf32(b0[k * bk + 8 * (j + 1) * bn], bh[1][0], bl[1][0]);
        split_tf32(b0[(k + 4) * bk + 8 * (j + 1) * bn], bh[1][1], bl[1][1]);
      }
      mma_tf32(acc[j], al, bh[0]);
      if (two) mma_tf32(acc[j + 1], al, bh[1]);
      mma_tf32(acc[j], ah, bl[0]);
      if (two) mma_tf32(acc[j + 1], ah, bl[1]);
      mma_tf32(acc[j], ah, bh[0]);
      if (two) mma_tf32(acc[j + 1], ah, bh[1]);
    }
  }
}

__device__ __forceinline__ int frag_row(int e) {
  return ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int j, int e) {
  return 8 * j + 2 * (threadIdx.x & 3) + (e & 1);
}

// The warp's strip of a 64 x 64 output: rows from 16 (warp / 2), columns
// from 32 (warp % 2), four 16 x 8 fragments.
__device__ __forceinline__ int strip_m0() { return 16 * (threadIdx.x >> 6); }
__device__ __forceinline__ int strip_n0() {
  return 32 * ((threadIdx.x >> 5) & 1);
}
// the strip's fragments that hold columns below ncol
__device__ __forceinline__ int live_cols(int ncol) {
  return max(0, min(4, (ceil8(ncol) - strip_n0()) / 8));
}
// the strip's fragments of a causal (i, j) product over the chunk's rows:
// those wholly above the diagonal or past the rows are left out
__device__ __forceinline__ int live_causal(int rows) {
  const int m0 = strip_m0(), n0 = strip_n0();
  return m0 < rows ? min(min(ceil8(m0 + 16 - n0), ceil8(rows - n0)) / 8, 4)
                   : 0;
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dt of the chunk's rows (0 past `rows`): one per thread of the first kQ
__device__ __forceinline__ float chunk_dt(const Params& p, int b, int h,
                                          int s0, int rows) {
  const int tid = threadIdx.x;
  return tid < rows ? p.dt[((size_t)b * p.S + s0 + tid) * p.H + h] : 0.f;
}

// cum, the inclusive prefix sum of dt A over the chunk in f64, by warp 0
// from dts in shared memory (written before the barrier that precedes
// this), and with it (where not null) es_i = exp(cum_i) and ws_j = dt_j
// exp(cum_Q - cum_j); ends with every thread past a barrier.
__device__ void chunk_cum(float A, const float* dts, double* cum,
                          float* es = nullptr, float* ws = nullptr) {
  const int tid = threadIdx.x;
  if (tid < 32) {
    double carry = 0.0, mine[kQ / 32];
#pragma unroll
    for (int s = 0; s < kQ / 32; ++s) {
      double v = (double)(dts[s * 32 + tid] * A);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, v, o);
        if (tid >= o) v += u;
      }
      v += carry;
      cum[s * 32 + tid] = mine[s] = v;
      carry = __shfl_sync(kFull, v, 31);
    }
#pragma unroll
    for (int s = 0; s < kQ / 32; ++s) {
      const int i = s * 32 + tid;
      if (es) es[i] = expf((float)mine[s]);
      if (ws) ws[i] = dts[i] * expf((float)(carry - mine[s]));
    }
  }
  __syncthreads();
}

// where head h's chunk c reads the state entering it (null: zero) and the
// gradient of the state leaving it (null: zero)
__device__ __forceinline__ const float* entering(const Params& p, int b,
                                                 int c, int h) {
  const size_t PN = (size_t)p.P * p.N;
  if (p.nc == 1)
    return p.states ? p.states + ((size_t)b * p.H + h) * PN : nullptr;
  if (c == 0 && !p.has_h0) return nullptr;
  return p.states + (((size_t)b * p.nc + c) * p.H + h) * PN;
}
__device__ __forceinline__ const float* leaving(const Params& p, int b,
                                                int c, int h) {
  const size_t PN = (size_t)p.P * p.N;
  if (c == p.nc - 1)
    return p.dhf ? p.dhf + ((size_t)b * p.H + h) * PN : nullptr;
  return p.dS + (((size_t)b * (p.nc - 1) + c) * p.H + h) * PN;
}

// ---------------------------------------------------------------------------
// 1. ssd_bwd_state
// ---------------------------------------------------------------------------
// A walk block: row b, head h, columns [64 half, +64) of N.  G in the
// strip layout (rows p, columns n) in registers, from dh_final; for c from
// the last chunk down to 1 (to 0 when dh0 is asked for): R_c = sum_i
// (exp(cum_i) dy_i) (x) C_i, then G_{c-1} = decay_c G_c + R_c into dS
// (G_{-1} into dh0).  dy and C go into two buffers in
// turn: the next chunk's are in flight while this one's product runs.
template <typename T>
__device__ void state_walk(const Params& p, int blk, unsigned char* smem) {
  double* cum = reinterpret_cast<double*>(smem);    // [kQ]
  float* dts = reinterpret_cast<float*>(cum + kQ);  // [kQ]
  float* es = dts + kQ;                             // [kQ]: exp(cum_i)
  float* bufs = es + 2 * kQ;  // two of dy [kQ][kC64], C [kQ][kC64]
  const int S = p.S, H = p.H, P = p.P, N = p.N, nc = p.nc;
  const int nh = (N + kH - 1) / kH;
  const int half = blk % nh;
  const int h = (blk / nh) % H, b = blk / nh / H;
  const int g = h / (H / p.G);
  const int nb = kH * half, ncol = min(kH, N - nb);
  const int tid = threadIdx.x;
  const int m0 = strip_m0(), n0 = strip_n0();
  const int live = live_cols(ncol);
  const size_t PN = (size_t)P * N;
  const float A = p.A[h];
  const int last = p.dh0 ? 0 : 1;  // the last chunk walked through

  float gv[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = m0 + frag_row(e), nn = n0 + frag_col(j, e);
      gv[j][e] = p.dhf && pp < P && nn < ncol
                     ? p.dhf[((size_t)b * H + h) * PN + (size_t)pp * N + nb +
                             nn]
                     : 0.f;
    }

  auto stage_chunk = [&](int c) {
    const int s0 = c * kQ, rows = min(kQ, S - s0);
    float* dys = bufs + ((nc - 1 - c) & 1) * 2 * kQ * kC64;
    stage<kQ, kP>(dys, kC64,
                  static_cast<const T*>(p.dy) + ((size_t)b * S + s0) * H * P +
                      (size_t)h * P,
                  (size_t)H * P, rows, P);
    stage<kQ, kH>(dys + kQ * kC64, kC64,
                  static_cast<const T*>(p.Cm) +
                      ((size_t)b * S + s0) * p.G * N + (size_t)g * N + nb,
                  (size_t)p.G * N, rows, ncol);
    cp_async_commit();
  };
  stage_chunk(nc - 1);
  float dtv = chunk_dt(p, b, h, (nc - 1) * kQ, min(kQ, S - (nc - 1) * kQ));
  for (int c = nc - 1; c >= last; --c) {
    const int rows = min(kQ, S - c * kQ);
    float* dys = bufs + ((nc - 1 - c) & 1) * 2 * kQ * kC64;
    float* Cs = dys + kQ * kC64;
    __syncthreads();  // the last step's reads of the other buffer are done
    if (tid < kQ) dts[tid] = dtv;
    if (c > last) {
      stage_chunk(c - 1);
      dtv = chunk_dt(p, b, h, (c - 1) * kQ, kQ);
      cp_async_wait_but_last();
    } else {
      cp_async_wait();
    }
    __syncthreads();
    chunk_cum(A, dts, cum, es);
    // the forward's exp(cum_Q); for one chunk, formed here as it forms it
    const float dec = p.decay ? p.decay[((size_t)b * nc + c) * H + h]
                              : expf((float)cum[kQ - 1]);
    float acc[4][4];
    zero_acc(acc);
    if (live > 0)  // (exp(cum) dy)^T C
      warp_mma3<4>(acc, dys, 1, kC64, m0, Cs, kC64, 1, n0, 0, ceil8(rows),
                   live, es);
    float* out =
        (c > 0 ? p.dS + (((size_t)b * (nc - 1) + c - 1) * H + h) * PN
               : p.dh0 + ((size_t)b * H + h) * PN) + nb;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        gv[j][e] = fmaf(dec, gv[j][e], acc[j][e]);
        gv[j][e + 1] = fmaf(dec, gv[j][e + 1], acc[j][e + 1]);
        const int pp = m0 + frag_row(e), nn = n0 + frag_col(j, e);
        if (pp >= P || nn >= ncol) continue;
        float* o = out + (size_t)pp * N + nn;
        if ((N & 1) == 0) {  // the pair is whole and 8-byte aligned
          store2(o, gv[j][e], gv[j][e + 1]);
        } else {
          o[0] = gv[j][e];
          if (nn + 1 < ncol) o[1] = gv[j][e + 1];
        }
      }
  }
}

// A cb block: C.B^T of chunk c and group g, raw products; the fragments
// above the diagonal or past the chunk's rows are written as zero.
template <typename T>
__device__ void chunk_cb(const Params& p, int blk, unsigned char* smem) {
  float* Cs = reinterpret_cast<float*>(smem);  // [kQ][kR128]
  float* Bs = Cs + kQ * kR128;                 // [kQ][kR128]
  const int g = blk % p.G;
  const int c = (blk / p.G) % p.nc, b = blk / p.G / p.nc;
  const int s0 = c * kQ, rows = min(kQ, p.S - s0);
  const size_t off = ((size_t)b * p.S + s0) * p.G * p.N + (size_t)g * p.N;
  {
    Tile<kQ, kN> ct, bt;
    ct.fetch(static_cast<const T*>(p.Cm) + off, (size_t)p.G * p.N, rows,
             p.N);
    bt.fetch(static_cast<const T*>(p.Bm) + off, (size_t)p.G * p.N, rows,
             p.N);
    ct.put(Cs, kR128);
    bt.put(Bs, kR128);
  }
  __syncthreads();
  float acc[4][4];
  zero_acc(acc);
  const int m0 = strip_m0(), n0 = strip_n0();
  const int live = live_causal(rows);
  if (live > 0)
    warp_mma3<4>(acc, Cs, kR128, 1, m0, Bs, 1, kR128, n0, 0, ceil8(p.N),
                 live);
  float* out = p.cb + (((size_t)b * p.nc + c) * p.G + g) * kQ * kQ;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2)
      store2(out + (m0 + frag_row(e)) * kQ + n0 + frag_col(j, e),
             acc[j][e], acc[j][e + 1]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_state(Params p,
                                                          int n_walk) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < n_walk)
    state_walk<T>(p, blockIdx.x, smem);
  else
    chunk_cb<T>(p, blockIdx.x - n_walk, smem);
}

// ---------------------------------------------------------------------------
// 2. ssd_bwd_chunk
// ---------------------------------------------------------------------------
// The dx block's shared memory (floats unless said)
struct DxSmem {
  static constexpr int kCum = 0;                       // f64 [kQ]
  static constexpr int kDaT = kCum + 2 * kQ;           // f64 [kQ]
  static constexpr int kPart = kDaT + 2 * kQ;          // f64 [8][kQ]
  static constexpr int kDts = kPart + 2 * 8 * kQ;      // [kQ]
  static constexpr int kColK = kDts + kQ;              // [kQ]
  static constexpr int kColP = kColK + kQ;             // [8][kQ]
  static constexpr int kVp = kColP + 8 * kQ;           // [2][kQ]
  static constexpr int kUp = kVp + 2 * kQ;             // [2][kQ]
  static constexpr int kDxd = kUp + 2 * kQ;            // [kQ]
  static constexpr int kWred = kDxd + kQ;              // [8]
  static constexpr int kEs = kWred + 8;                // [kQ]: exp(cum_i)
  static constexpr int kWs = kEs + kQ;                 // [kQ]: dt_j exp(..)
  static constexpr int kX = kWs + kQ + 24;             // [kQ][kR64]
  static constexpr int kDy = kX + kQ * kR64;           // [kQ][kC64]
  static constexpr int kR1 = kDy + kQ * kC64;          // M1 [kQ][kC64],
                                                       // K [kQ][kLK]; B, C
  static constexpr int kR1Size =
      kQ * kC64 + kQ * kLK > kQ * kR128 ? kQ * kC64 + kQ * kLK : kQ * kR128;
  static constexpr int kR2 = kR1 + kR1Size;            // G, h [kP][kR128]
  static constexpr int kEnd = kR2 + kP * kR128;
  static constexpr size_t bytes = sizeof(float) * kEnd;
};
static_assert(DxSmem::kX % 4 == 0 && DxSmem::kDy % 4 == 0 &&
                  DxSmem::kR1 % 4 == 0 && DxSmem::kR2 % 4 == 0,
              "16-byte aligned tiles");

// The dBC block's shared memory (floats unless said)
struct DbcSmem {
  static constexpr int kCum = 0;               // f64 [kQ]
  static constexpr int kDts = kCum + 2 * kQ;   // [kQ]
  static constexpr int kW = kDts + kQ;         // [kQ]: dt_j exp(cum_Q - cum_j)
  static constexpr int kE = kW + kQ;           // [kQ]: exp(cum_i)
  static constexpr int kX = kE + kQ;           // [kQ][kR64]: x, then w x
  static constexpr int kDy = kX + kQ * kR64;   // [kQ][kR64]: dy, then e dy
  static constexpr int kM2 = kDy + kQ * kR64;  // [kQ][kC64]
  static constexpr int kC = kM2 + kQ * kC64;   // [kQ][kC64]: C's half
  static constexpr int kB = kC + kQ * kC64;    // [kQ][kC64]: B's half
  static constexpr int kGh = kB + kQ * kC64;   // [kP][kC64]: G's, then h's
  static constexpr int kEnd = kGh + kP * kC64;
  static constexpr size_t bytes = sizeof(float) * kEnd;
};
static_assert(DbcSmem::kX % 4 == 0 && DbcSmem::kM2 % 4 == 0 &&
                  DbcSmem::kGh % 4 == 0,
              "16-byte aligned tiles");

// A dx block: head h, chunk c, row b.
template <typename T>
__device__ void chunk_dx(const Params& p, int blk, unsigned char* smem) {
  using L = DxSmem;
  float* f = reinterpret_cast<float*>(smem);
  double* cum = reinterpret_cast<double*>(f + L::kCum);
  double* daT = reinterpret_cast<double*>(f + L::kDaT);
  double* part = reinterpret_cast<double*>(f + L::kPart);
  float* dts = f + L::kDts;
  float* colK = f + L::kColK;
  float* colP = f + L::kColP;
  float* vpart = f + L::kVp;
  float* upart = f + L::kUp;
  float* dxd = f + L::kDxd;
  float* wred = f + L::kWred;
  float* es = f + L::kEs;
  float* ws = f + L::kWs;
  float* xs = f + L::kX;
  float* dys = f + L::kDy;
  float* M1 = f + L::kR1;
  float* Ks = f + L::kR1 + kQ * kC64;
  float* R1 = f + L::kR1;  // later B, then C [kQ][kR128]
  float* R2 = f + L::kR2;  // G, then h [kP][kR128]

  const int S = p.S, H = p.H, P = p.P, N = p.N, G = p.G, nc = p.nc;
  const int h = blk % H;
  const int c = (blk / H) % nc, b = blk / H / nc;
  const int s0 = c * kQ, rows = min(kQ, S - s0);
  const int g = h / (H / G);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = strip_m0(), n0 = strip_n0();
  const int live_p = live_cols(P);
  const size_t x_off = ((size_t)b * S + s0) * H * P + (size_t)h * P;
  const size_t bc_off = ((size_t)b * S + s0) * G * N + (size_t)g * N;
  const float* hin = entering(p, b, c, h);
  const float* gin = leaving(p, b, c, h);

  // x, dy, the chunk's C.B^T and G
  stage<kQ, kP>(xs, kR64, static_cast<const T*>(p.x) + x_off, (size_t)H * P,
                rows, P);
  stage<kQ, kP>(dys, kC64, static_cast<const T*>(p.dy) + x_off,
                (size_t)H * P, rows, P);
  stage<kQ, kQ>(M1, kC64, p.cb + (((size_t)b * nc + c) * G + g) * kQ * kQ,
                (size_t)kQ, kQ, kQ);
  // R2 holds G, or h_in when there is no G (then it is read from here)
  if (gin)
    stage<kP, kN>(R2, kR128, gin, (size_t)N, P, N);
  else if (hin)
    stage<kP, kN>(R2, kR128, hin, (size_t)N, P, N);
  if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
  cp_async_wait();
  __syncthreads();
  chunk_cum(p.A[h], dts, cum, es, ws);
  const double last = cum[kQ - 1];

  // DX = dy.x^T (j <= i), then in place M1 = L dt_j CB, and K = L CB DX
  {
    float acc[4][4];
    zero_acc(acc);
    const int live = live_causal(rows);
    if (live > 0)
      warp_mma3<4>(acc, dys, kC64, 1, m0, xs, 1, kR64, n0, 0, ceil8(P), live);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = m0 + frag_row(e), jj = n0 + frag_col(j, e);
        float m1 = 0.f, k = 0.f;
        if (jj <= i) {
          const float l = expf((float)(cum[i] - cum[jj]));
          const float cbv = M1[i * kC64 + jj];
          m1 = l * dts[jj] * cbv;
          k = l * cbv * acc[j][e];
        }
        M1[i * kC64 + jj] = m1;
        Ks[i * kLK + jj] = k;
        if (i == jj) dxd[i] = acc[j][e];
      }
  }
  __syncthreads();

  // the T_ij = K_ij dt_j that straddle k, and K's column sums: warp w takes
  // rows [8 w, 8 w + 8), lane l columns 2 l and 2 l + 1; each row's
  // exclusive prefix over j by a shuffle scan in f64, added where k <= i
  {
    const int k0 = 2 * lane;
    double st0 = 0.0, st1 = 0.0;
    float ck0 = 0.f, ck1 = 0.f;
    for (int r = 0; r < 8; ++r) {
      const int i = 8 * warp + r;
      const float ka = Ks[i * kLK + k0], kb = Ks[i * kLK + k0 + 1];
      ck0 += ka;
      ck1 += kb;
      const double ta = (double)(ka * dts[k0]), tb = (double)(kb * dts[k0 + 1]);
      double incl = ta + tb;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += u;
      }
      double ex = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) ex = 0.0;
      if (k0 <= i) st0 += ex;
      if (k0 + 1 <= i) st1 += ex + ta;
    }
    part[warp * kQ + k0] = st0;
    part[warp * kQ + k0 + 1] = st1;
    colP[warp * kQ + k0] = ck0;
    colP[warp * kQ + k0 + 1] = ck1;
  }

  // dx's first term: M1^T dy over i >= j
  float dxa[4][4];
  zero_acc(dxa);
  if (m0 < rows && live_p > 0)
    warp_mma3<4>(dxa, M1, 1, kC64, m0, dys, kC64, 1, n0, m0, ceil8(rows),
                 live_p);
  __syncthreads();  // part, colP in; M1 and K dead

  // the eight warps' column partials, a butterfly over lanes 8 apart
#pragma unroll
  for (int rnd = 0; rnd < 2; ++rnd) {
    const int col = 8 * warp + 4 * rnd + (lane >> 3), w = lane & 7;
    double v = part[w * kQ + col];
    float ck = colP[w * kQ + col];
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) {
      v += __shfl_xor_sync(kFull, v, o);
      ck += __shfl_xor_sync(kFull, ck, o);
    }
    if (w == 0) {
      daT[col] = v;
      colK[col] = ck;
    }
  }

  // dx = M1^T dy + dt_j exp(cum_Q - cum_j) B G^T + D dy, and V_j's sums
  float gb[4][4];
  zero_acc(gb);
  if (gin) {
    stage<kQ, kN>(R1, kR128, static_cast<const T*>(p.Bm) + bc_off,
                  (size_t)G * N, rows, N);
    cp_async_wait();
    __syncthreads();
    if (m0 < rows && live_p > 0)
      warp_mma3<4>(gb, R1, kR128, 1, m0, R2, 1, kR128, n0, 0, ceil8(N),
                   live_p);
  }
  {
    const float Dh = p.D ? p.D[h] : 0.f;
    T* dx = static_cast<T*>(p.dx) + x_off;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int j = m0 + frag_row(e);
      const float w = ws[j];
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int pp = n0 + frag_col(q, e);
        if (pp >= P) continue;
        const float v0 = dxa[q][e] + w * gb[q][e] + Dh * dys[j * kC64 + pp];
        const float v1 =
            dxa[q][e + 1] + w * gb[q][e + 1] + Dh * dys[j * kC64 + pp + 1];
        v = fmaf(xs[j * kR64 + pp], gb[q][e], v);
        v = fmaf(xs[j * kR64 + pp + 1], gb[q][e + 1], v);
        if (j >= rows) continue;
        T* o = dx + (size_t)j * H * P + pp;
        if ((P & 1) == 0) {  // the pair is whole and aligned
          store2(o, v0, v1);
        } else {
          store_f32(o, v0);
          if (pp + 1 < P) store_f32(o + 1, v1);
        }
      }
      v += __shfl_xor_sync(kFull, v, 1);
      v += __shfl_xor_sync(kFull, v, 2);
      if ((lane & 3) == 0) vpart[(warp & 1) * kQ + j] = v;
    }
  }

  // C h_in^T for r_i, and sum(G * h_in) while both are at hand
  float wsum = 0.f;
  float ch[4][4];
  zero_acc(ch);
  if (hin) {
    if (gin) {
      Tile<kP, kN> ht;
      ht.fetch(hin, (size_t)N, P, N);
      wsum = ht.dot(R2, kR128);
      __syncthreads();  // B and G are dead
      ht.put(R2, kR128);
    }
    stage<kQ, kN>(R1, kR128, static_cast<const T*>(p.Cm) + bc_off,
                  (size_t)G * N, rows, N);
    cp_async_wait();
    __syncthreads();
    if (m0 < rows && live_p > 0)
      warp_mma3<4>(ch, R1, kR128, 1, m0, R2, 1, kR128, n0, 0, ceil8(N),
                   live_p);
  }
#pragma unroll
  for (int e = 0; e < 4; e += 2) {
    const int i = m0 + frag_row(e);
    float u = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int pp = n0 + frag_col(q, e);
      if (pp >= P) continue;
      u = fmaf(dys[i * kC64 + pp], ch[q][e], u);
      u = fmaf(dys[i * kC64 + pp + 1], ch[q][e + 1], u);
    }
    u += __shfl_xor_sync(kFull, u, 1);
    u += __shfl_xor_sync(kFull, u, 2);
    if ((lane & 3) == 0) upart[(warp & 1) * kQ + i] = u;
  }
  wsum = warp_sum(wsum);
  if (lane == 0) wred[warp] = wsum;
  __syncthreads();

  // r, its suffix sum, ddt and the block's dA, dD partials: warp 0, rows
  // 2 l and 2 l + 1 on lane l
  if (warp == 0) {
    const int k0 = 2 * lane;
    float vd[2];
    double rs[2];
    float sv = 0.f, dd = 0.f;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = k0 + q;
      vd[q] = expf((float)(last - cum[k])) * (vpart[k] + vpart[kQ + k]);
      const float ud = es[k] * (upart[k] + upart[kQ + k]);
      rs[q] = (double)(ud - dts[k] * vd[q]);
      sv = fmaf(dts[k], vd[q], sv);
      if (k < rows) dd += dxd[k];
    }
    sv = warp_sum(sv);
    dd = warp_sum(dd);
    const float W = warp_sum(lane < 8 ? wred[lane] : 0.f);
    if (lane == 31) rs[1] += (double)(sv + expf((float)last) * W);
    // sum_{i >= k} r_i: a suffix scan of the lanes' pairs, in f64
    double suf = rs[0] + rs[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_down_sync(kFull, suf, o);
      if (lane + o < 32) suf += u;
    }
    double after = __shfl_down_sync(kFull, suf, 1);
    if (lane == 31) after = 0.0;
    const double run[2] = {after + rs[1] + rs[0], after + rs[1]};
    const float A = p.A[h];
    float* ddt = p.ddt + ((size_t)b * S + s0) * H + h;
    double da_sum = 0.0;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int k = k0 + q;
      const float da = (float)(run[q] + daT[k]);
      if (k < rows) {
        ddt[(size_t)k * H] = A * da + colK[k] + vd[q];
        da_sum += (double)(dts[k] * da);
      }
    }
    da_sum = warp_sum(da_sum);
    if (lane == 0) {
      const size_t pi = ((size_t)b * nc + c) * H + h;
      p.dA_part[pi] = (float)da_sum;
      p.dD_part[pi] = dd;
    }
  }
}

// A dBC block: the heads [hs sl, hs sl + hs) (of one group), columns
// [64 half, +64) of N, chunk c, row b.
template <typename T>
__device__ void chunk_dbc(const Params& p, int blk, unsigned char* smem) {
  using L = DbcSmem;
  float* f = reinterpret_cast<float*>(smem);
  double* cum = reinterpret_cast<double*>(f + L::kCum);
  float* dts = f + L::kDts;
  float* ws = f + L::kW;
  float* es = f + L::kE;
  float* xs = f + L::kX;
  float* dys = f + L::kDy;
  float* M2 = f + L::kM2;
  float* Chs = f + L::kC;
  float* Bhs = f + L::kB;
  float* GHs = f + L::kGh;

  const int S = p.S, H = p.H, P = p.P, N = p.N, G = p.G, nc = p.nc;
  const int nh = (N + kH - 1) / kH, nsl = H / p.hs;
  const int half = blk % nh;
  const int sl = (blk / nh) % nsl;
  const int c = (blk / nh / nsl) % nc, b = blk / nh / nsl / nc;
  const int s0 = c * kQ, rows = min(kQ, S - s0);
  const int g = sl * p.hs / (H / G);
  const int nb = kH * half, ncol = min(kH, N - nb);
  const int tid = threadIdx.x;
  const int m0 = strip_m0(), n0 = strip_n0();
  const int live_n = live_cols(ncol);
  const size_t bc_off = ((size_t)b * S + s0) * G * N + (size_t)g * N + nb;
  stage<kQ, kH>(Chs, kC64, static_cast<const T*>(p.Cm) + bc_off,
                (size_t)G * N, rows, ncol);
  stage<kQ, kH>(Bhs, kC64, static_cast<const T*>(p.Bm) + bc_off,
                (size_t)G * N, rows, ncol);
  float dBa[4][4], dCa[4][4], tmp[4][4];
  zero_acc(dBa);
  zero_acc(dCa);
  // acc += scale[row] * tmp, row by row of the strip
  auto add_rows = [&](float (&acc)[4][4], const float* scale) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(scale[m0 + frag_row(e)], tmp[j][e], acc[j][e]);
  };

  for (int hh = 0; hh < p.hs; ++hh) {
    const int h = sl * p.hs + hh;
    const size_t x_off = ((size_t)b * S + s0) * H * P + (size_t)h * P;
    const float* hin = entering(p, b, c, h);
    const float* gin = leaving(p, b, c, h);
    __syncthreads();  // the last head's reads are done
    stage<kQ, kP>(xs, kR64, static_cast<const T*>(p.x) + x_off,
                  (size_t)H * P, rows, P);
    stage<kQ, kP>(dys, kR64, static_cast<const T*>(p.dy) + x_off,
                  (size_t)H * P, rows, P);
    if (gin) stage<kP, kH>(GHs, kC64, gin + nb, (size_t)N, P, ncol);
    if (tid < kQ) dts[tid] = chunk_dt(p, b, h, s0, rows);
    cp_async_wait();
    __syncthreads();
    chunk_cum(p.A[h], dts, cum, es, ws);
    // M2 = L dt_j (dy.x^T), j <= i
    {
      zero_acc(tmp);
      const int live = live_causal(rows);
      if (live > 0)
        warp_mma3<4>(tmp, dys, kR64, 1, m0, xs, 1, kR64, n0, 0, ceil8(P),
                     live);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = m0 + frag_row(e), jj = n0 + frag_col(j, e);
          M2[i * kC64 + jj] =
              jj <= i ? expf((float)(cum[i] - cum[jj])) * dts[jj] * tmp[j][e]
                      : 0.f;
        }
    }
    __syncthreads();  // M2 is in
    const bool strip = m0 < rows && live_n > 0;
    if (gin) {  // dB += diag(w) (x G)
      zero_acc(tmp);
      if (strip)
        warp_mma3<4>(tmp, xs, kR64, 1, m0, GHs, kC64, 1, n0, 0, ceil8(P),
                     live_n);
      add_rows(dBa, ws);
    }
    if (hin) {  // h_in over G, in flight through the M2 products
      __syncthreads();
      stage<kP, kH>(GHs, kC64, hin + nb, (size_t)N, P, ncol);
    }
    if (strip) {
      // dB += M2^T C (i >= j);  dC += M2 B (j <= i)
      warp_mma3<4>(dBa, M2, 1, kC64, m0, Chs, kC64, 1, n0, m0, ceil8(rows),
                   live_n);
      warp_mma3<4>(dCa, M2, kC64, 1, m0, Bhs, kC64, 1, n0, 0,
                   min(m0 + 16, ceil8(rows)), live_n);
    }
    if (hin) {  // dC += diag(e) (dy h_in)
      cp_async_wait();
      __syncthreads();
      zero_acc(tmp);
      if (strip)
        warp_mma3<4>(tmp, dys, kR64, 1, m0, GHs, kC64, 1, n0, 0, ceil8(P),
                     live_n);
      add_rows(dCa, es);
    }
  }

  const size_t out = ((size_t)b * S + s0) * nsl * N + (size_t)sl * N + nb;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = m0 + frag_row(e), nn = n0 + frag_col(j, e);
      if (i >= rows || nn >= ncol) continue;
      const size_t o = out + (size_t)i * nsl * N + nn;
      if ((N & 1) == 0) {
        store2(p.dBp + o, dBa[j][e], dBa[j][e + 1]);
        store2(p.dCp + o, dCa[j][e], dCa[j][e + 1]);
      } else {
        p.dBp[o] = dBa[j][e];
        p.dCp[o] = dCa[j][e];
        if (nn + 1 < ncol) {
          p.dBp[o + 1] = dBa[j][e + 1];
          p.dCp[o + 1] = dCa[j][e + 1];
        }
      }
    }
}

// the dBC blocks first (they walk hs heads each), then the dx blocks
template <typename T>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_chunk(Params p,
                                                             int n_dbc) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x < n_dbc)
    chunk_dbc<T>(p, blockIdx.x, smem);
  else
    chunk_dx<T>(p, blockIdx.x - n_dbc, smem);
}

// ---------------------------------------------------------------------------
// 3. ssd_bwd_reduce
// ---------------------------------------------------------------------------
// A thread an element of dB or dC, summing the group's slices in order;
// then a warp each for dA[h] and dD[h], over (row, chunk).
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce(Params p) {
  const size_t M = (size_t)p.B * p.S * p.G * p.N;
  const size_t n_elem_blocks = (2 * M + kThreads - 1) / kThreads;
  if (blockIdx.x < n_elem_blocks) {
    const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
    if (e >= 2 * M) return;
    const int nsl = p.H / p.hs, per = nsl / p.G;
    const bool is_c = e >= M;
    const size_t k = is_c ? e - M : e;
    const int n = (int)(k % p.N);
    const size_t bsg = k / p.N;  // (b * S + s) * G + g
    const int g = (int)(bsg % p.G);
    const size_t bs = bsg / p.G;
    const float* src =
        (is_c ? p.dCp : p.dBp) + (bs * nsl + (size_t)g * per) * p.N + n;
    float acc = 0.f;
    for (int r = 0; r < per; ++r) acc += src[(size_t)r * p.N];
    store_f32(static_cast<T*>(is_c ? p.dC : p.dB) + k, acc);
    return;
  }
  const int wi = (int)(blockIdx.x - n_elem_blocks) * (kThreads / 32) +
                 (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wi >= 2 * p.H) return;
  const bool is_d = wi >= p.H;
  const int h = wi - (is_d ? p.H : 0);
  if (is_d && !p.D) return;
  const float* src = is_d ? p.dD_part : p.dA_part;
  float acc = 0.f;
  for (int bc = lane; bc < p.B * p.nc; bc += 32) acc += src[(size_t)bc * p.H + h];
  acc = warp_sum(acc);
  if (lane == 0) (is_d ? p.dD : p.dA)[h] = acc;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
constexpr size_t kWalkSmem =
    sizeof(double) * kQ + sizeof(float) * (3 * kQ + 4 * kQ * kC64);
constexpr size_t kCbSmem = sizeof(float) * 2 * kQ * kR128;
constexpr size_t kStateSmem = kWalkSmem > kCbSmem ? kWalkSmem : kCbSmem;
constexpr size_t kChunkSmem =
    DxSmem::bytes > DbcSmem::bytes ? DxSmem::bytes : DbcSmem::bytes;

template <typename T>
cudaError_t configure() {
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(ssd_bwd_state<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kStateSmem)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)kChunkSmem)) != cudaSuccess)
    return e;
  return cudaFuncSetAttribute(ssd_bwd_chunk<T>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// Each launch's blocks: ssd_bwd_state's walk blocks (none for one chunk
// unless dh0 is asked for)
// then cb blocks, ssd_bwd_chunk's dBC blocks then dx blocks, and
// ssd_bwd_reduce's element blocks then its 2 H warps.
struct Grids {
  int n_walk, n_cb, n_dbc, n_dx;
  size_t n_reduce;
};

Grids grids(const Params& p) {
  const int nh = (p.N + kH - 1) / kH;
  const size_t M = (size_t)p.B * p.S * p.G * p.N;
  return {p.nc > 1 || p.dh0 ? p.B * p.H * nh : 0, p.G * p.nc * p.B,
          (p.H / p.hs) * nh * p.nc * p.B, p.H * p.nc * p.B,
          (2 * M + kThreads - 1) / kThreads +
              (2 * (size_t)p.H + kThreads / 32 - 1) / (kThreads / 32)};
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  cudaError_t e;
  if ((e = configure<T>()) != cudaSuccess) return e;
  const Grids g = grids(p);
  ssd_bwd_state<T><<<g.n_walk + g.n_cb, kThreads, kStateSmem, stream>>>(
      p, g.n_walk);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_chunk<T><<<g.n_dbc + g.n_dx, kThreads, kChunkSmem, stream>>>(
      p, g.n_dbc);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  ssd_bwd_reduce<T><<<(unsigned)g.n_reduce, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// out[3 k], out[3 k + 1], out[3 k + 2]: the blocks, dynamic shared memory
// bytes and blocks an SM of ssd_bwd_state, ssd_bwd_chunk, ssd_bwd_reduce
template <typename T>
cudaError_t occupancy(const Params& p, int* out) {
  cudaError_t e;
  if ((e = configure<T>()) != cudaSuccess) return e;
  const Grids g = grids(p);
  out[0] = g.n_walk + g.n_cb;
  out[1] = (int)kStateSmem;
  out[3] = g.n_dbc + g.n_dx;
  out[4] = (int)kChunkSmem;
  out[6] = (int)g.n_reduce;
  out[7] = 0;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[2], ssd_bwd_state<T>, kThreads, kStateSmem)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &out[5], ssd_bwd_chunk<T>, kThreads, kChunkSmem)) != cudaSuccess)
    return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[8], ssd_bwd_reduce<T>, kThreads, 0);
}

// the shapes' checks and fields of Params; false: not a shape it takes
bool shape(Params& p, int B, int S, int H, int P, int G, int N, int hs) {
  if (B <= 0 || S <= 0 || H <= 0 || G <= 0 || H % G != 0 || P <= 0 ||
      P > kP || N <= 0 || N > kN || hs <= 0 || (H / G) % hs != 0)
    return false;
  p.B = B;
  p.S = S;
  p.H = H;
  p.P = P;
  p.G = G;
  p.N = N;
  p.nc = (S + kQ - 1) / kQ;
  p.hs = hs;
  return true;
}

}  // namespace

// The SSD's backward: three launches.  states: the forward's entering
// states (B, nc, H, P, N) when nc > 1 (chunk 0's read only if has_h0),
// else h0 (B, H, P, N) or null; decay (B, nc, H) when nc > 1.  Scratch:
// dS (B, nc - 1, H, P, N) when nc > 1, cb (B, nc, G, 64, 64), dBp and dCp
// (B, S, H / hs, N), dA_part and dD_part (B, nc, H); hs, the heads a dBC
// block walks, divides H / G.  dh0 (B, H, P, N) f32, h0's gradient, or
// null for none.  Returns the first non-zero cudaGetLastError() (0 =
// launched).
extern "C" int repro_ssd_bwd(const void* x, const float* dt, const float* A,
                             const void* Bm, const void* Cm, const float* D,
                             const void* dy, const float* states,
                             const float* decay, const float* dhf, float* dS,
                             float* cb, void* dx, float* ddt, float* dBp,
                             float* dCp, float* dA_part, float* dD_part,
                             void* dB, void* dC, float* dA, float* dD,
                             float* dh0, int B, int S, int H, int P, int G,
                             int N, int hs, int has_h0, int is_bf16,
                             void* stream) {
  Params p{};
  if (!shape(p, B, S, H, P, G, N, hs)) return (int)cudaErrorInvalidValue;
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
  p.cb = cb;
  p.dx = dx;
  p.ddt = ddt;
  p.dBp = dBp;
  p.dCp = dCp;
  p.dA_part = dA_part;
  p.dD_part = dD_part;
  p.dB = dB;
  p.dC = dC;
  p.dA = dA;
  p.dD = dD;
  p.dh0 = dh0;
  p.has_h0 = has_h0;
  if ((p.nc > 1 &&
       (states == nullptr || decay == nullptr || dS == nullptr)) ||
      cb == nullptr || dBp == nullptr || dCp == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return (int)launch<__nv_bfloat16>(p, st);
  return (int)launch<float>(p, st);
}

// The launch plan at these shapes (P changes none of it): out[3 k] the
// blocks, out[3 k + 1] the dynamic shared memory bytes and out[3 k + 2]
// the blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// ssd_bwd_state, ssd_bwd_chunk and ssd_bwd_reduce (k = 0, 1, 2), from the
// grids that repro_ssd_bwd launches.
extern "C" int repro_ssd_bwd_occupancy(int B, int S, int H, int G, int N,
                                       int hs, int is_bf16, int* out) {
  Params p{};
  if (!shape(p, B, S, H, kP, G, N, hs)) return (int)cudaErrorInvalidValue;
  if (is_bf16) return (int)occupancy<__nv_bfloat16>(p, out);
  return (int)occupancy<float>(p, out);
}
