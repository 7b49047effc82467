// Fletcher-64 checksum for Hopper (sm_90a), written by hand for the PyTorch
// port.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fletcher.py
// (fletcher64_pallas, body _kernel): Fletcher-64 over little-endian uint32
// words, both sums mod M = 2^32 - 1, the result (s2 << 32) | s1 with
// canonical residues in [0, M).  The input is a byte buffer; a last
// partial word is read as zero-padded, as the reference pads the bytes
// to a u32 boundary.
//
// Math.  Over n words w_0..w_{n-1}:
//   s1 = sum_i w_i                        (mod M)
//   s2 = sum_i (n - i) w_i = n*s1 - sum_i i*w_i   (mod M)
// so both reduce to sums of independent terms, which blocks can take in
// any order; no ordered combine of (s1, s2, L) partials is needed.
// 2^32 = 1 (mod M): a 64-bit x reduces as (x >> 32) + (x & 0xffffffff).
//
// What bounds it on an H100.  A few integer operations per 4-byte word
// against 3.35 TB/s: the 155.6 M-word (622 MB) embedding shard of
// qwen1.5-0.5b needs 0.19 ms to read, and it is bound by bytes.
//
// Design.  Hopper has 64-bit integers, so the TPU kernel's end-around
// carries and 16-bit half sums (fletcher.py:4-8) are not carried over.
// Pass 1: a grid-stride loop; each thread reads 16 bytes (four words) per
// load with four loads in flight, and keeps sum w and sum i*w (each
// product folded once to < 2^33) in 64-bit registers; the block reduces
// its threads by warp shuffles and shared memory and writes its two
// partial sums mod M.  Pass 2: one block folds the partials and forms
// (s2 << 32) | s1.  The wrapper allocates the partials' scratch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks per SM of an H100
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
  // i < 2^32 - 1 (the launcher checks nbytes): one 32x32 -> 64 multiply
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

__global__ void __launch_bounds__(kThreads)
fletcher_partial(const uint8_t* __restrict__ bytes, uint64_t nbytes,
                 uint64_t* __restrict__ partial) {
  __shared__ uint64_t smem[kThreads / 32];
  const uint64_t n_vec = nbytes / 16;
  const uint4* vec = reinterpret_cast<const uint4*>(bytes);
  const uint64_t stride = (uint64_t)gridDim.x * kThreads;
  uint64_t v = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
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
  // partial word, zero-padded, read byte by byte by block 0
  if (blockIdx.x == 0 && threadIdx.x < 4) {
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
fletcher_finish(const uint64_t* __restrict__ partial, int nblocks,
                uint64_t n_words, uint64_t* __restrict__ out) {
  __shared__ uint64_t smem[kThreads / 32];
  uint64_t s1 = 0, siw = 0;  // each term < 2^32, at most 4 per thread
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
    s1 += partial[2 * i];
    siw += partial[2 * i + 1];
  }
  s1 = modm(block_sum(modm(s1), smem));
  siw = modm(block_sum(modm(siw), smem));
  if (threadIdx.x == 0) {
    const uint64_t ns1 = modm(modm(n_words) * s1);  // < 2^64
    const uint64_t s2 = ns1 >= siw ? ns1 - siw : ns1 + kMod - siw;
    out[0] = (s2 << 32) | s1;
  }
}

}  // namespace

// Number of pass-1 blocks for nbytes, i.e. the partials' scratch the
// caller provides: 2 * blocks uint64 words.
extern "C" int repro_fletcher64_blocks(uint64_t nbytes) {
  const uint64_t per_block = (uint64_t)kThreads * 16 * kUnroll;
  uint64_t nb = (nbytes + per_block - 1) / per_block;
  if (nb < 1) nb = 1;
  if (nb > (uint64_t)kMaxBlocks) nb = kMaxBlocks;
  return (int)nb;
}

// bytes: 16-byte aligned device buffer of nbytes (< 4 * (2^32 - 1));
// partial: 2 * repro_fletcher64_blocks(nbytes) uint64; out: one uint64.
extern "C" int repro_fletcher64(const void* bytes, uint64_t nbytes,
                                uint64_t* partial, uint64_t* out,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(bytes) % 16 != 0 ||
      nbytes / 4 >= kMod)
    return (int)cudaErrorInvalidValue;
  const int nb = repro_fletcher64_blocks(nbytes);
  fletcher_partial<<<nb, kThreads, 0, st>>>(
      static_cast<const uint8_t*>(bytes), nbytes, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fletcher_finish<<<1, kThreads, 0, st>>>(partial, nb, (nbytes + 3) / 4,
                                          out);
  return (int)cudaGetLastError();
}
