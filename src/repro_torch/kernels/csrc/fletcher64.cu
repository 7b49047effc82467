// Fletcher-64 checksums of a batch of buffers for Hopper (sm_90a), written
// by hand for the PyTorch port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fletcher.py
// (fletcher64_pallas, body _kernel): Fletcher-64 over little-endian uint32
// words, both sums mod M = 2^32 - 1, the result (s2 << 32) | s1 with
// canonical residues in [0, M).  Each input is a byte buffer; a last
// partial word is read as zero-padded, as the reference pads the bytes
// to a u32 boundary.  One launch pair checksums n buffers (a checkpoint's
// shards) and writes n results.
//
// Math.  Over n words w_0..w_{n-1}:
//   s1 = sum_i w_i                        (mod M)
//   s2 = sum_i (n - i) w_i = n*s1 - sum_i i*w_i   (mod M)
// so both reduce to sums of independent terms, which blocks can take in
// any order; no ordered combine of (s1, s2, L) partials is needed.
// 2^32 = 1 (mod M): a 64-bit x reduces as (x >> 32) + (x & 0xffffffff).
//
// What bounds it on an H100.  A few integer operations per 4-byte word
// against 3.35 TB/s: bound by bytes (qwen1.5-0.5b's 1.86 GB of shards
// need 0.55 ms to read).  A checkpoint's shards are mostly small (4 KB
// norms), where a launch, not bytes, is the floor: hence one launch pair
// for the whole batch, not one per shard.
//
// Design.  Hopper has 64-bit integers, so the TPU kernel's end-around
// carries and 16-bit half sums (fletcher.py:4-8) are not carried over.
// The caller passes a device table: the n buffers' addresses, their byte
// counts, and a prefix table of pass-1 blocks per buffer (in proportion
// to bytes, at least one each).  Pass 1: each block finds its buffer by a
// binary search over the prefix table and runs a stride loop over its
// share of it; each thread reads 16 bytes (four words) per load with four
// loads in flight, and keeps sum w and sum i*w (i counted from the
// buffer's start, each product folded once to < 2^33) in 64-bit
// registers; the block reduces its threads by warp shuffles and shared
// memory and writes its two partial sums mod M.  Pass 2: a warp per
// buffer folds that buffer's partials and forms (s2 << 32) | s1.  The
// wrapper allocates the partials' scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr uint64_t kMod = 0xffffffffull;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t fold(uint64_t x) {
  return (x >> 32) + (x & kMod);  // < 2^33, congruent mod M
}

__device__ __forceinline__ uint64_t modm(uint64_t x) {
  x = fold(fold(x));  // <= 2^32
  return x >= kMod ? x - kMod : x;
}

__device__ __forceinline__ void add_word(uint64_t i, uint32_t w,
                                         uint64_t& s1, uint64_t& siw) {
  s1 += w;
  // i < 2^32 - 1 (the wrapper checks each size): one 32x32 -> 64 multiply
  siw += fold((uint64_t)(uint32_t)i * w);
}

// Sum of one value per thread of the block, each < 2^40; thread 0 gets it.
__device__ uint64_t block_sum(uint64_t x, uint64_t* smem) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) smem[warp] = x;
  __syncthreads();
  uint64_t total = 0;
  if (threadIdx.x == 0)
    for (int i = 0; i < kThreads / 32; ++i) total += smem[i];
  __syncthreads();
  return total;
}

// The table's three parts: addresses, byte counts, block prefix (n + 1).
struct Table {
  const uint64_t* addr;
  const uint64_t* nbytes;
  const uint64_t* prefix;
  __device__ Table(const uint64_t* t, int n)
      : addr(t), nbytes(t + n), prefix(t + 2 * n) {}
};

__global__ void __launch_bounds__(kThreads)
fletcher_partial(const uint64_t* __restrict__ table, int n,
                 uint64_t* __restrict__ partial) {
  __shared__ uint64_t smem[kThreads / 32];
  const Table tab(table, n);
  // the buffer: the last s with prefix[s] <= blockIdx.x (every buffer has
  // at least one block, so the prefix rises strictly)
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tab.prefix[mid] <= blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const uint64_t first = tab.prefix[lo];
  const uint64_t nblocks = tab.prefix[lo + 1] - first;
  const uint64_t block = blockIdx.x - first;
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(tab.addr[lo]);
  const uint64_t nbytes = tab.nbytes[lo];

  const uint64_t n_vec = nbytes / 16;
  const uint4* vec = reinterpret_cast<const uint4*>(bytes);
  const uint64_t stride = nblocks * kThreads;
  uint64_t v = block * kThreads + threadIdx.x;
  uint64_t s1 = 0, siw = 0;

  for (; v + (kUnroll - 1) * stride < n_vec; v += kUnroll * stride) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(vec + v + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const uint64_t i = 4 * (v + u * stride);
      add_word(i, r[u].x, s1, siw);
      add_word(i + 1, r[u].y, s1, siw);
      add_word(i + 2, r[u].z, s1, siw);
      add_word(i + 3, r[u].w, s1, siw);
    }
  }
  for (; v < n_vec; v += stride) {
    const uint4 r = __ldg(vec + v);
    const uint64_t i = 4 * v;
    add_word(i, r.x, s1, siw);
    add_word(i + 1, r.y, s1, siw);
    add_word(i + 2, r.z, s1, siw);
    add_word(i + 3, r.w, s1, siw);
  }
  // the tail after the last whole 16 bytes: up to 3 whole words and one
  // partial word, zero-padded, read byte by byte by the buffer's block 0
  if (block == 0 && threadIdx.x < 4) {
    const uint64_t start = n_vec * 16 + 4 * threadIdx.x;
    if (start < nbytes) {
      uint32_t w = 0;
      for (int b = 0; b < 4 && start + b < nbytes; ++b)
        w |= (uint32_t)bytes[start + b] << (8 * b);
      add_word(start / 4, w, s1, siw);
    }
  }
  // per thread: s1 < 2^32 * (words read) and siw < 2^33 * (words read),
  // far below 2^64; reduce to < 2^32 before the block sum
  const uint64_t a = block_sum(modm(s1), smem);
  const uint64_t b = block_sum(modm(siw), smem);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = modm(a);
    partial[2 * blockIdx.x + 1] = modm(b);
  }
}

__global__ void __launch_bounds__(kThreads)
fletcher_finish(const uint64_t* __restrict__ table, int n,
                const uint64_t* __restrict__ partial,
                uint64_t* __restrict__ out) {
  const Table tab(table, n);
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (s >= n) return;  // whole warps leave together
  // each partial < 2^32; a buffer has at most 132 * 8 blocks (the
  // wrapper's cap), so a lane sums at most 34 and the warp < 2^43
  uint64_t s1 = 0, siw = 0;
  for (uint64_t i = tab.prefix[s] + lane; i < tab.prefix[s + 1]; i += 32) {
    s1 += partial[2 * i];
    siw += partial[2 * i + 1];
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    s1 += __shfl_xor_sync(kFull, s1, d);
    siw += __shfl_xor_sync(kFull, siw, d);
  }
  if (lane == 0) {
    s1 = modm(s1);
    siw = modm(siw);
    const uint64_t n_words = (tab.nbytes[s] + 3) / 4;
    const uint64_t ns1 = modm(modm(n_words) * s1);  // product < 2^64
    const uint64_t s2 = ns1 >= siw ? ns1 - siw : ns1 + kMod - siw;
    out[s] = (s2 << 32) | s1;
  }
}

}  // namespace

// table: 3n + 1 uint64 on the device — n addresses (each 16-byte aligned),
// n byte counts (each < 4 * (2^32 - 1)), and the n + 1 prefix sums of
// pass-1 blocks per buffer, from 0 to nblocks, each buffer at least one;
// partial: 2 * nblocks uint64; out: n uint64.
extern "C" int repro_fletcher64_many(const uint64_t* table, int n,
                                     int nblocks, uint64_t* partial,
                                     uint64_t* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || nblocks < n) return (int)cudaErrorInvalidValue;
  fletcher_partial<<<nblocks, kThreads, 0, st>>>(table, n, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int warps = kThreads / 32;
  fletcher_finish<<<(n + warps - 1) / warps, kThreads, 0, st>>>(
      table, n, partial, out);
  return (int)cudaGetLastError();
}
