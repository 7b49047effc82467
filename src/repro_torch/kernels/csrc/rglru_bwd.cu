// The RG-LRU recurrence's backward for Hopper (sm_90a), written by hand for
// the PyTorch port.
//
// The reference has no Pallas backward: it trains through XLA's autodiff
// of ops.rglru (src/repro/kernels/ops.py:326).  This is the backward of
// the forward kernels in rglru_scan.cu.  Per batch row b and channel w,
// with the gates given before their sigmoid:
//   sr, si = sigmoid(r_gate), sigmoid(i_gate)
//   log a  = coef sr, coef = -8 softplus(lambda_w)
//   beta   = sqrt(max(1 - a^2, 1e-12)),   h_t = a_t h_{t-1} + si x beta
// With g_t the gradient of h_t, run in reverse from the end
// (g_{S-1} = dh_{S-1} + dh_final, g_t = dh_t + a_{t+1} g_{t+1}):
//   dx     = g si beta,   di = g x beta si (1 - si)
//   dlog a = g h_{t-1} a - g si x a^2 / beta   (second term 0 where the
//            clamp binds, 1 - a^2 <= 1e-12)
//   dr     = dlog a coef sr (1 - sr)
//   dlam   = -8 sigmoid(lambda) sum_{b,t} dlog a sr
//   dh0    = a_0 g_0, the carry that leaves step 0
//
// Layouts (all contiguous): x, r_gate, i_gate, dh and dx, dr_gate,
// di_gate (B, S, W) in one type, f32 or bf16; lambda, dlambda (W,) f32;
// h0, dh_final, dh0 (B, W) f32, the first two null for zero; states
// (B, nc, W) f32, the state entering each chunk that the forward kept
// (null when nc == 1: h0 enters); the wrapper's scratch: the chunk pairs
// (2, B, nc, W) f32 (null when nc == 1), the dlambda partials (B, nc, W)
// f32 and `sync`, int32 counters and flags that are zero before a launch
// and that the launch leaves zero (rglru_bwd_sync_ints).
//
// What bounds it on an H100.  Four reads and three writes an element
// against a few dozen operations: bound by bytes.  The kernel it replaces
// (three launches: a summary pass, an apply pass, a reduction) ran at 4x
// that bound: every thread walked its chunk's 32 steps one load at a time
// three times, each step's loads waiting behind the last step's stores,
// 11 element reads where the bound counts 4.
//
// Design: one launch; a block is (row b, chunk c of kL = 32 steps, kCh
// channels), kCh = 64 threads x V channels.
//   1. Stage.  The block issues every 16-byte cp.async of its chunk's
//      tiles (4 x 32 x 256 bytes) before it uses any: r_gate and dh in a
//      first group, x and i_gate in a second that lands while the first
//      is used.  Each input is read once.  Rows whose width or start is
//      not on 16 bytes are loaded element by element instead.
//   2. sigma(r) and a once an element (a into a tile of its own, sigma(r)
//      over r_gate's) and the chunk's pair, with g0 the reverse run from 0
//      at the chunk's end: A_c = prod a and e_c = a_0 g0_0 =
//      sum_t (a_0 .. a_t) dh_t, both summed forward.
//   3. The pair is published with a release flag, before the rest of the
//      chunk's arithmetic, for the chunks before it (chunk 0's is read by
//      no one).
//   4. Forward over the chunk from shared memory, from the kept entering
//      state: sigma(i) and beta once an element, h_{t-1} rebuilt, and the
//      factors the reverse step needs, u = si beta, v = x beta si (1 - si)
//      and w1 = m coef sr (1 - sr) (m = dlog a / g), written over the
//      tiles they came from (f32; bf16 into f32 tiles of their own); and
//      the dlambda sums Q_t = a_t Q_{t-1} + m_t sr_t and s0 =
//      sum_t dh_t Q_t, which equal sum_t g0_t m_t sr_t.  8 / V steps at a
//      time: their loads, their work that does not depend on h side by
//      side, the chain through h, their stores.
//   5. The carry across chunks.  Blocks take (row, chunk, channels) by an
//      atomic ticket, last chunk first, and wait only on the flags of
//      later chunks of their row and channels, which hold smaller tickets:
//      those blocks are running or done, so no block waits on one that
//      has not started.  The g leaving chunk c is folded from dh_final
//      over the later chunks' pairs, C = A_c' C + e_c', from the last
//      down, in the same fixed order as the old apply pass, 8 pairs'
//      loads in flight at a time.  A one-launch fold was chosen over
//      keeping a summary pass: that pass would read r_gate and dh a
//      second time (a third of the bound's reads) and cost a launch,
//      where the fold reads nc - 1 - c pairs from L2 a thread.  (The
//      forward cannot form the pairs: e_c needs dh.)
//   6. The chunk's dlambda partial s0 + C Q_last (g_t = g0_t + P_t C, P_t
//      the product of the a after t) and, from chunk 0,
//      dh0 = e_c + A_c C; then the last of a channel block's B nc blocks,
//      found by a counter that it resets, sums the block's partials over
//      rows, then chunks, in the old reduction's order.  All before the
//      gradients' stores, so that the fence that publishes the partials
//      waits on these few writes alone.
//   7. Reverse over the chunk from shared memory and registers: dx, dr,
//      di to device memory, coalesced a step.
// No atomics in any sum: the atomics only hand out tickets and count
// blocks, so two runs give equal bits.  `sync` is left zero by the blocks
// that finish each count (the last ticket, the last of a row's chunks,
// the last of a channel block), so the next launch on the stream, a CUDA
// graph's replay included, finds it zero.  Launches that share `sync`
// must run one after another (one stream).  A wait that polls past
// kSpinLimit times traps: a fault, never a hang.
// Shared memory a block: f32 40 KB (the four staged 8 KB tiles and a's),
// 5 blocks an SM; bf16 (V = 2, 128 channels) 96 KB (its staged tiles and
// four f32 ones), 2 blocks an SM.  The loops run 8 / V steps at a time,
// not unrolled over the chunk: an unrolled variant that kept a in
// registers (32 KB, 6 blocks an SM, 128 registers) was no faster.  The
// sigmoids use the fast exponential and reciprocal and 1 / beta is
// rsqrtf: with the IEEE forms the kernel took 20% longer (PERF.md, B5-bwd).
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "rglru_common.cuh"

namespace {

constexpr int kThreads = 64;  // threads a block
constexpr int kL = 32;        // chunk length: kernels/rglru.py's CHUNK
constexpr int kILP = 8;       // steps x channels a thread computes at once
constexpr int kBatch = 8;     // loads in flight in the fold and the sum
constexpr long long kSpinLimit = 1LL << 24;  // polls before a wait traps

// The block's shared memory at V channels a thread: the staged tiles of
// x, r_gate, i_gate and dh (kL x kCh of T each), then the f32 tiles of a
// and (bf16) of sr (then w1), u = si beta and v = x beta si (1 - si); for
// T = float these three take the tiles of r_gate, x and i_gate as they
// are read.
template <typename T, int V>
struct Smem {
  static constexpr int kCh = kThreads * V;  // channels a block
  static constexpr int kTile = kL * kCh;    // elements a tile
  static constexpr bool kAlias = std::is_same<T, float>::value;
  static constexpr size_t kStaged = 4 * (size_t)kTile * sizeof(T);
  static constexpr size_t bytes =
      kStaged + (kAlias ? 1 : 4) * (size_t)kTile * sizeof(float);
  static constexpr int kPieces = kCh * (int)sizeof(T) / 16;  // a tile row
};

// sigma(v) by the fast exponential and reciprocal, a few ulp from
// sigmoid(); a and 1 - a^2 keep expf (near a = 1, 1 - a^2 is the
// difference of nearby numbers: an error of a few ulp in exp(2 log a)
// would be a large one in 1 - a^2)
__device__ __forceinline__ float fast_sigmoid(float v) {
  return __fdividef(1.f, 1.f + __expf(-v));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}
__device__ __forceinline__ void wait_flag(const int* f) {
  long long spins = 0;
  while (load_acquire(f) == 0) {
    __nanosleep(64);
    if (++spins > kSpinLimit) __trap();
  }
}

// the staged tiles of one input: rows [0, n) of the chunk starting at
// element offset `row0` (row b, first step, first channel w0)
template <typename T, int V, bool kVec>
__device__ __forceinline__ void stage(T* tile, const T* __restrict__ src,
                                      size_t row0, int n, int W, int w0) {
  using L = Smem<T, V>;
  if constexpr (kVec) {
    constexpr int kE = 16 / sizeof(T);  // elements a piece
    for (int e = threadIdx.x; e < n * L::kPieces; e += kThreads) {
      const int r = e / L::kPieces, col = (e % L::kPieces) * kE;
      if (w0 + col < W)  // W is whole pieces: the piece is whole
        cp_async16(tile + r * L::kCh + col,
                   src + row0 + (size_t)r * W + col);
    }
  } else {
    const int col = threadIdx.x * V;
    if (w0 + col < W)
      for (int r = 0; r < n; ++r)
#pragma unroll
        for (int k = 0; k < V; ++k)
          tile[r * L::kCh + col + k] = src[row0 + (size_t)r * W + col + k];
  }
}

template <typename T, int V, bool kVec>
__global__ void __launch_bounds__(kThreads) rglru_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ rg,
    const T* __restrict__ ig, const float* __restrict__ lam,
    const float* __restrict__ h0, const T* __restrict__ dh,
    const float* __restrict__ dhf, const float* __restrict__ states,
    T* __restrict__ dx, T* __restrict__ drg, T* __restrict__ dig,
    float* __restrict__ dlam, float* __restrict__ dh0,
    float* __restrict__ pairs, float* __restrict__ part,
    int* __restrict__ sync, int B, int S, int W) {
  using L = Smem<T, V>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_ticket, s_last;
  const int tid = threadIdx.x;
  const int nc = (S + kL - 1) / kL;
  const int nwb = (W + L::kCh - 1) / L::kCh;
  const int per_c = B * nwb;  // blocks a chunk index
  int* const ticket = sync;
  int* const done = sync + 1;         // (B, nwb): blocks past their fold
  int* const red = done + per_c;      // (nwb): blocks with partials out
  int* const flag = red + nwb;        // (B, nc, nwb): pair published

  if (tid == 0) {
    const int t = atomicAdd(ticket, 1);
    if (t == per_c * nc - 1) atomicExch(ticket, 0);  // every ticket taken
    s_ticket = t;
  }
  __syncthreads();
  const int c = nc - 1 - s_ticket / per_c;
  const int b = (s_ticket % per_c) / nwb, j = s_ticket % nwb;
  const int t0 = c * kL, n = min(kL, S - t0);
  const int w0 = j * L::kCh, w = w0 + tid * V;
  const bool live = w < W;
  const size_t row0 = ((size_t)b * S + t0) * W + w0;

  T* const xs = reinterpret_cast<T*>(smem);
  T* const rs = xs + L::kTile;
  T* const is = rs + L::kTile;
  T* const ds = is + L::kTile;
  float* const ext = reinterpret_cast<float*>(smem + L::kStaged);
  float* const fa = ext;  // a
  float *fs, *fu, *fv;    // sr then w1, u, v
  if constexpr (L::kAlias) {
    fs = reinterpret_cast<float*>(rs);
    fu = reinterpret_cast<float*>(xs);
    fv = reinterpret_cast<float*>(is);
  } else {
    fs = ext + L::kTile;
    fu = ext + 2 * L::kTile;
    fv = ext + 3 * L::kTile;
  }
  constexpr int G = kILP / V;  // steps a thread computes at once

  // 1. the chunk's tiles, all in flight before the first use: r_gate and
  // dh (what the pair needs) in a first group, x and i_gate in a second
  stage<T, V, kVec>(rs, rg, row0, n, W, w0);
  if (dh) stage<T, V, kVec>(ds, dh, row0, n, W, w0);
  if constexpr (kVec) cp_async_commit();
  stage<T, V, kVec>(xs, x, row0, n, W, w0);
  stage<T, V, kVec>(is, ig, row0, n, W, w0);
  if constexpr (kVec) cp_async_commit();
  float coef[V], h[V], carry[V];
  if (live) {
    const size_t bw = (size_t)b * W + w;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      coef[k] = decay_coef(lam[w + k]);
      h[k] = states ? states[((size_t)b * nc + c) * W + w + k]
                    : (h0 ? h0[bw + k] : 0.f);
      carry[k] = dhf ? dhf[bw + k] : 0.f;
    }
  }
  if constexpr (kVec) cp_async_wait<1>();
  __syncthreads();

  // 2. sr and a once an element, and the chunk's pair with g0 the
  // reverse run from 0 at the chunk's end: A = prod a,
  // e = a_0 g0_0 = sum_t (a_0 .. a_t) dh_t.  a goes to its tile, sr
  // over r_gate's
  float prod[V], e[V];
#pragma unroll
  for (int k = 0; k < V; ++k) prod[k] = 1.f, e[k] = 0.f;
  if (live) {
#pragma unroll 1
    for (int t0 = 0; t0 < n; t0 += G) {
      float rv[G][V] = {}, dv[G][V] = {};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g < n) {
          const int o = (t0 + g) * L::kCh + tid * V;
          load_v<V>(rs + o, rv[g]);
          if (dh) load_v<V>(ds + o, dv[g]);
        }
      }
      float av[G][V];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          rv[g][k] = fast_sigmoid(rv[g][k]);
          av[g][k] = expf(coef[k] * rv[g][k]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g < n) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            prod[k] *= av[g][k];
            e[k] = fmaf(prod[k], dv[g][k], e[k]);
          }
          const int o = (t0 + g) * L::kCh + tid * V;
          store_v<V>(fs + o, rv[g]);
          store_v<V>(fa + o, av[g]);
        }
      }
    }
  }

  float* const sum_a = pairs;
  float* const sum_e = pairs ? pairs + (size_t)B * nc * W : nullptr;
  // 3. the pair, published for the chunks before this one
  if (c > 0) {
    if (live) {
      const size_t o = ((size_t)b * nc + c) * W + w;
      store_v<V>(sum_a + o, prod);
      store_v<V>(sum_e + o, e);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) store_release(flag + ((size_t)b * nc + c) * nwb + j, 1);
  }
  if constexpr (kVec) cp_async_wait<0>();
  __syncthreads();

  // 4. forward over the chunk: h_{t-1} rebuilt, the reverse's factors u,
  // v and w1 = m coef sr (1 - sr) (m = dlog a / g) over the tiles they
  // were read from, and the dlambda sums: Q_t = a_t Q_{t-1} + m_t sr_t,
  // s0 = sum_t dh_t Q_t (= sum_t g0_t m_t sr_t).  G steps at a time:
  // their loads, their work that does not depend on h side by side, then
  // the chain through h, then their stores
  float qs[V], s0[V];
#pragma unroll
  for (int k = 0; k < V; ++k) qs[k] = s0[k] = 0.f;
  if (live) {
#pragma unroll 1
    for (int t0 = 0; t0 < n; t0 += G) {
      float xv[G][V] = {}, sv[G][V] = {}, iv[G][V] = {}, dv[G][V] = {},
            av[G][V] = {};
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g < n) {
          const int o = (t0 + g) * L::kCh + tid * V;
          load_v<V>(xs + o, xv[g]);
          load_v<V>(fs + o, sv[g]);
          load_v<V>(fa + o, av[g]);
          load_v<V>(is + o, iv[g]);
          if (dh) load_v<V>(ds + o, dv[g]);
        }
      }
      float uv[G][V], vv[G][V], inp[G][V], q[G][V], c1[G][V];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float r = sv[g][k], si = fast_sigmoid(iv[g][k]);
          const float a = av[g][k];
          const float om = 1.f - expf(2.f * (coef[k] * r));
          const float omc = fmaxf(om, 1e-12f), rb = rsqrtf(omc);
          const float beta = omc * rb;
          inp[g][k] = si * xv[g][k] * beta;
          q[g][k] = om > 1e-12f ? si * xv[g][k] * a * a * rb : 0.f;
          uv[g][k] = si * beta;
          vv[g][k] = xv[g][k] * beta * si * (1.f - si);
          c1[g][k] = coef[k] * r * (1.f - r);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t0 + g < n) {
          float w1[V];
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float a = av[g][k], hp = h[k];
            h[k] = a * h[k] + inp[g][k];
            const float m = hp * a - q[g][k];
            w1[k] = m * c1[g][k];
            qs[k] = fmaf(a, qs[k], m * sv[g][k]);
            s0[k] = fmaf(dv[g][k], qs[k], s0[k]);
          }
          const int o = (t0 + g) * L::kCh + tid * V;
          store_v<V>(fu + o, uv[g]);
          store_v<V>(fv + o, vv[g]);
          store_v<V>(fs + o, w1);
        }
      }
    }
  }

  // 5. the g leaving the chunk: the later chunks' pairs folded from
  // dh_final, last first
  if (c < nc - 1) {
    for (int cc = c + 1 + tid; cc < nc; cc += kThreads)
      wait_flag(flag + ((size_t)b * nc + cc) * nwb + j);
    __syncthreads();
    __threadfence();
    if (live) {
      for (int top = nc - 1; top > c; top -= kBatch) {
        float ab[kBatch][V], eb[kBatch][V];  // a batch's loads first
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const size_t o = ((size_t)b * nc + top - u) * W + w;
#pragma unroll
          for (int k = 0; k < V; ++k) {
            ab[u][k] = top - u > c ? __ldcg(sum_a + o + k) : 1.f;
            eb[u][k] = top - u > c ? __ldcg(sum_e + o + k) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
#pragma unroll
          for (int k = 0; k < V; ++k)
            if (top - u > c) carry[k] = fmaf(ab[u][k], carry[k], eb[u][k]);
      }
    }
  }
  if (nc > 1) {
    __syncthreads();  // every read of the flags and pairs is done
    if (tid == 0) {
      int* const d = done + b * nwb + j;
      if (atomicAdd(d, 1) == nc - 1) {  // the row's last: reset its flags
        for (int cc = 1; cc < nc; ++cc)
          flag[((size_t)b * nc + cc) * nwb + j] = 0;
        atomicExch(d, 0);
      }
    }
  }

  // 6. the chunk's dlambda partial and (chunk 0) dh0 = a_0 g_0, then
  // dlambda by the channel block's last block, all before the gradients'
  // stores, so that the fence waits on these writes alone
  if (live) {
    float pv[V], d0[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      pv[k] = fmaf(carry[k], qs[k], s0[k]);
      d0[k] = fmaf(prod[k], carry[k], e[k]);
    }
    store_v<V>(part + ((size_t)b * nc + c) * W + w, pv);
    if (c == 0 && dh0) store_v<V>(dh0 + (size_t)b * W + w, d0);
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(red + j, 1) == B * nc - 1;
    if (s_last) atomicExch(red + j, 0);
  }
  __syncthreads();
  if (s_last && live) {
    __threadfence();
    const int np = B * nc;  // partials (row, chunk), row-major
    float sum[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sum[k] = 0.f;
    for (int i0 = 0; i0 < np; i0 += kBatch) {
      float pb[kBatch][V];  // a batch's loads first, then its sums in order
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k)
          pb[u][k] = i0 + u < np
                         ? __ldcg(part + (size_t)(i0 + u) * W + w + k)
                         : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
#pragma unroll
        for (int k = 0; k < V; ++k)
          if (i0 + u < np) sum[k] += pb[u][k];
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      dlam[w + k] = -kC * sigmoid(lam[w + k]) * sum[k];
  }

  // 7. reverse over the chunk: the gradients, coalesced a step
  if (live) {
#pragma unroll 8
    for (int t = n - 1; t >= 0; --t) {
      {
        const int o = t * L::kCh + tid * V;
        const size_t go = row0 + (size_t)t * W + tid * V;
        float av[V], uv[V], vv[V], w1[V], dv[V] = {};
        float ox[V], orr[V], oi[V];
        load_v<V>(fa + o, av);
        load_v<V>(fu + o, uv);
        load_v<V>(fv + o, vv);
        load_v<V>(fs + o, w1);
        if (dh) load_v<V>(ds + o, dv);
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float g = dv[k] + carry[k];
          ox[k] = g * uv[k];
          oi[k] = g * vv[k];
          orr[k] = g * w1[k];
          carry[k] = av[k] * g;
        }
        store_v<V>(dx + go, ox);
        store_v<V>(drg + go, orr);
        store_v<V>(dig + go, oi);
      }
    }
  }
}

template <typename T, int V, bool kVec>
cudaError_t launch(const void* x, const void* rg, const void* ig,
                   const float* lam, const float* h0, const void* dh,
                   const float* dhf, const float* states, void* dx,
                   void* drg, void* dig, float* dlam, float* dh0,
                   float* pairs, float* part, int* sync, int B, int S,
                   int W, cudaStream_t st) {
  using L = Smem<T, V>;
  auto* kernel = rglru_bwd_kernel<T, V, kVec>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return e;
  const int nc = (S + kL - 1) / kL, nwb = (W + L::kCh - 1) / L::kCh;
  kernel<<<B * nc * nwb, kThreads, L::bytes, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(rg),
      static_cast<const T*>(ig), lam, h0, static_cast<const T*>(dh), dhf,
      states, static_cast<T*>(dx), static_cast<T*>(drg),
      static_cast<T*>(dig), dlam, dh0, pairs, part, sync, B, S, W);
  return cudaGetLastError();
}

// every pointer 16-byte aligned and every row whole 16-byte pieces
bool whole_pieces(int W, size_t elt, const void* const* ptrs, int n) {
  if ((W * elt) % 16 != 0) return false;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0)
      return false;
  return true;
}

template <typename T, int V>
cudaError_t dispatch(bool vec, const void* x, const void* rg,
                     const void* ig, const float* lam, const float* h0,
                     const void* dh, const float* dhf, const float* states,
                     void* dx, void* drg, void* dig, float* dlam,
                     float* dh0, float* pairs, float* part, int* sync,
                     int B, int S, int W, cudaStream_t st) {
  if (vec)
    return launch<T, V, true>(x, rg, ig, lam, h0, dh, dhf, states, dx, drg,
                              dig, dlam, dh0, pairs, part, sync, B, S, W,
                              st);
  return launch<T, V, false>(x, rg, ig, lam, h0, dh, dhf, states, dx, drg,
                             dig, dlam, dh0, pairs, part, sync, B, S, W, st);
}

}  // namespace

// The int32 words of `sync` a call at (B, S, W) needs, zeroed once by the
// caller: a ticket, a count a (row, channel block), a count a channel
// block and a flag a (row, chunk, channel block).
extern "C" long long rglru_bwd_sync_ints(int B, int S, int W, int is_bf16) {
  const int ch = kThreads * (is_bf16 && W % 2 == 0 ? 2 : 1);
  const long long nwb = (W + ch - 1) / ch, nc = (S + kL - 1) / kL;
  return 1 + B * nwb + nwb + B * nc * nwb;
}

// The backward of one RG-LRU call: one launch.  pairs is the caller's
// f32 scratch of (2, B, nc, W), nc = ceil(S / kL), unused (may be null)
// when nc == 1; part (B, nc, W) f32; sync rglru_bwd_sync_ints words, zero;
// dh0 (B, W) f32 or null.  Returns the first non-zero cudaGetLastError()
// (0 = launched).
extern "C" int repro_rglru_bwd(const void* x, const void* rg, const void* ig,
                               const float* lam, const float* h0,
                               const void* dh, const float* dhf,
                               const float* states, void* dx, void* drg,
                               void* dig, float* dlam, float* dh0,
                               float* pairs, float* part, int* sync, int B,
                               int S, int W, int is_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  const long long nc = (S + kL - 1) / kL;
  if (part == nullptr || sync == nullptr ||
      (nc > 1 && (pairs == nullptr || states == nullptr)) ||
      rglru_bwd_sync_ints(B, S, W, is_bf16) > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* const inputs[] = {x, rg, ig, dh, dx, drg, dig};
  if (is_bf16) {
    const bool vec = whole_pieces(W, 2, inputs, 7);
    if (W % 2 == 0)
      return (int)dispatch<__nv_bfloat16, 2>(vec, x, rg, ig, lam, h0, dh,
                                             dhf, states, dx, drg, dig, dlam,
                                             dh0, pairs, part, sync, B, S, W,
                                             st);
    return (int)dispatch<__nv_bfloat16, 1>(vec, x, rg, ig, lam, h0, dh, dhf,
                                           states, dx, drg, dig, dlam, dh0,
                                           pairs, part, sync, B, S, W, st);
  }
  const bool vec = whole_pieces(W, 4, inputs, 7);
  return (int)dispatch<float, 1>(vec, x, rg, ig, lam, h0, dh, dhf, states,
                                 dx, drg, dig, dlam, dh0, pairs, part, sync,
                                 B, S, W, st);
}
