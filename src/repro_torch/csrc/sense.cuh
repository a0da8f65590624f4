// Shared device code of the sense / reduce / popcount kernels.
//
// Layout (lane-major, identical to the JAX package's): a tile of 4096 cells
// packs into 128 words; word w of a tile holds bit k from column k*128 + w.
// The sense kernels give one thread one output word. Neighbouring threads
// take neighbouring w, so each of the 32 loads a word needs is one coalesced
// 128-byte access per warp, and no re-layout is needed. The word kernels
// (bitops.cu, popcount.cu) take 16-byte loads where their inputs are aligned.
//
// The sense kernels read Vth rows where they live: an operand is a base
// pointer (an arena shard's buffer, or a dense stack) and a device int32 slot
// table, and row p of operand i starts at base[i] + slots_i[p] * cols. A block
// covers kBlock words of one row, so it looks up one slot per operand and its
// loads stay coalesced. A dense stack is one base with the identity table.
//
// Every C entry point launches on the caller's stream, does not synchronise,
// allocates nothing, and returns cudaGetLastError() so the Python wrapper can
// raise on a launch the CUDA runtime refused. mcf_mlc_sense_drain also
// enqueues copies on a second stream the caller gives, after one event per
// device that it creates at its first call.
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

// Operands (slot tables) one sense launch takes: the executor's
// MAX_FUSED_OPERANDS, so a fused pass is one launch.
constexpr int kMaxTables = 32;

// The operands' base pointers and slot tables travel by value in the
// kernel's parameter space (768 B), as bitops.cu's operand pointers do.
// `end` (mlc_sense only) holds the cumulative rows through each table: the
// output rows are the tables' rows in order.
struct RowTables {
  const float* base[kMaxTables];
  const int32_t* slots[kMaxTables];
  int64_t end[kMaxTables];
};

inline RowTables load_tables(const float* const* bases,
                             const int32_t* const* slots, const int64_t* ends,
                             int n) {
  RowTables t = {};
  for (int i = 0; i < n; ++i) {
    t.base[i] = bases[i];
    t.slots[i] = slots[i];
    t.end[i] = ends ? ends[i] : 0;
  }
  return t;
}

// The first row of table i's p-th entry.
__device__ __forceinline__ const float* table_row(const RowTables& t, int i,
                                                  int64_t p, int64_t cols) {
  return t.base[i] + static_cast<int64_t>(__ldg(t.slots[i] + p)) * cols;
}

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

// A parity read compares v with its first n_refs references. NREFS bounds
// n_refs at compile time: kMaxRefs, or n_refs itself in a launch for a known
// count, which then unrolls to exactly that many compares a cell.
template <int KIND, int NREFS = kMaxRefs>
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
  for (int i = 1; i < NREFS; ++i) {
    if (i < n_refs) odd ^= (v > refs.r[i]);
  }
  return !odd;
}

// Sense and pack the 32 cells of one word: bit k from column tile*4096 +
// k*128 + w of `row`.
template <int KIND, int NREFS = kMaxRefs>
__device__ __forceinline__ uint32_t sense_word(const float* __restrict__ row,
                                               int64_t tile, int w,
                                               const Refs& refs, int n_refs,
                                               bool invert) {
  const float* base = row + tile * kTileCols + w;
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < kWordBits; ++k) {
    const bool bit = sense_bit<KIND, NREFS>(__ldg(base + k * kLanes), refs, n_refs);
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

// Blocks of kBlock threads the current card holds at once (2048 threads on
// each SM), read once per device: the grid of a grid-stride kernel.
inline int64_t resident_blocks() {
  constexpr int kMaxDevices = 64;
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) dev = 0;
  if (cached[dev] == 0) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = (sms > 0 ? sms : 1) * (2048 / kBlock);
  }
  return cached[dev];
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// One thread per unit, but at most `cap` blocks (and at least one).
inline unsigned int grid_for(int64_t units, int64_t cap) {
  const int64_t blocks = (units + kBlock - 1) / kBlock;
  return static_cast<unsigned int>(blocks < 1 ? 1 : (blocks < cap ? blocks : cap));
}

}  // namespace mcf
