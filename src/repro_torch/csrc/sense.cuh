// Shared device code of the sense / reduce / popcount kernels.
//
// Layout (lane-major, identical to the JAX package's): a tile of 4096 cells
// packs into 128 words; word w of a tile holds bit k from column k*128 + w.
// Every kernel here gives one thread one output word. Neighbouring threads
// take neighbouring w, so each of the 32 loads a word needs is one coalesced
// 128-byte access per warp, and no re-layout is needed.
//
// Every C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a launch the CUDA runtime refused.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace mcf {

constexpr int kLanes = 128;
constexpr int kWordBits = 32;
constexpr int kTileCols = kLanes * kWordBits;  // 4096
constexpr int kMaxRefs = 8;
constexpr int kBlock = 256;

enum Kind { kLsb = 0, kMsb = 1, kSbr = 2, kParity = 3 };
enum Op { kAnd = 0, kOr = 1, kXor = 2 };

// The read references travel by value in the kernel's parameter space: the
// counterpart of the Pallas kernels' scalar-prefetched reference vector.
struct Refs {
  float r[kMaxRefs];
};

inline Refs load_refs(const float* host_refs) {
  Refs refs;
  for (int i = 0; i < kMaxRefs; ++i) refs.r[i] = host_refs[i];
  return refs;
}

template <int KIND>
__device__ __forceinline__ bool sense_bit(float v, const Refs& refs, int n_refs) {
  if (KIND == kLsb) return v < refs.r[0];
  if (KIND == kMsb) return (v < refs.r[0]) || (v > refs.r[1]);
  if (KIND == kSbr) {
    const bool neg = (v < refs.r[0]) || (v > refs.r[1]);
    const bool pos = (v < refs.r[2]) || (v > refs.r[3]);
    return neg == pos;
  }
  // parity: 1 iff an even number of references lie below v
  bool odd = v > refs.r[0];
#pragma unroll
  for (int i = 1; i < kMaxRefs; ++i) {
    if (i < n_refs) odd ^= (v > refs.r[i]);
  }
  return !odd;
}

// Sense and pack the 32 cells of one word: bit k from column tile*4096 +
// k*128 + w of `row`.
template <int KIND>
__device__ __forceinline__ uint32_t sense_word(const float* __restrict__ row,
                                               int64_t tile, int w,
                                               const Refs& refs, int n_refs,
                                               bool invert) {
  const float* base = row + tile * kTileCols + w;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < kWordBits; ++k) {
    const bool bit = sense_bit<KIND>(__ldg(base + k * kLanes), refs, n_refs);
    word |= static_cast<uint32_t>(bit != invert) << k;
  }
  return word;
}

__device__ __forceinline__ uint32_t combine(uint32_t acc, uint32_t x, int op) {
  if (op == kAnd) return acc & x;
  if (op == kOr) return acc | x;
  return acc ^ x;
}

// Sum `v` over the block and add it to *out with one atomic. Hopper's blocks
// run in no order, so this replaces the Pallas kernels' accumulator carried
// across a sequential grid. Integer atomics are exact in any order.
__device__ __forceinline__ void block_add(int v, int* out) {
  __shared__ int warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(out, v);
  }
}

inline unsigned int grid_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kBlock - 1) / kBlock);
}

}  // namespace mcf
