// Fused sense -> reduce (-> masked popcount) over N same-plan operands.
//
// Replaces src/repro/kernels/fused.py:sense_reduce (_sense_reduce_kernel) and
// :sense_reduce_popcount (_sense_reduce_popcount_kernel). Bound by memory:
// 4 B read per cell of every operand; 1/8 B per cell written (sense_reduce),
// or the mask read plus 4 B per row (popcount). Each thread senses its word
// in every operand and folds the words in registers, so no partial result
// goes to device memory.
#include "sense.cuh"

namespace mcf {

template <int KIND>
__device__ __forceinline__ uint32_t fold_word(const float* __restrict__ vth,
                                              int64_t n, int64_t plane,
                                              int64_t row, int64_t words,
                                              int64_t wcol, const Refs& refs,
                                              int n_refs, bool sense_invert,
                                              int op, bool invert) {
  const float* r = vth + row * words * kWordBits;
  const int64_t tile = wcol / kLanes;
  const int w = static_cast<int>(wcol % kLanes);
  uint32_t acc = sense_word<KIND>(r, tile, w, refs, n_refs, sense_invert);
  for (int64_t i = 1; i < n; ++i) {
    acc = combine(acc, sense_word<KIND>(r + i * plane, tile, w, refs, n_refs,
                                        sense_invert), op);
  }
  return invert ? ~acc : acc;
}

template <int KIND>
__global__ void __launch_bounds__(kBlock)
sense_reduce_kernel(const float* __restrict__ vth, uint32_t* __restrict__ out,
                    int64_t n, int64_t rows, int64_t words, Refs refs,
                    int n_refs, int sense_invert, int op, int invert) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= rows * words) return;
  out[t] = fold_word<KIND>(vth, n, rows * words * kWordBits, t / words, words,
                           t % words, refs, n_refs, sense_invert != 0, op,
                           invert != 0);
}

// One block covers kBlock words of one row; blocks are numbered row-major.
template <int KIND>
__global__ void __launch_bounds__(kBlock)
sense_reduce_popcount_kernel(const float* __restrict__ vth,
                             const uint32_t* __restrict__ mask,
                             int* __restrict__ out, int64_t n, int64_t rows,
                             int64_t words, int64_t blocks_per_row, Refs refs,
                             int n_refs, int sense_invert, int op, int invert) {
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t wcol = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  int count = 0;
  if (wcol < words) {
    const uint32_t word = fold_word<KIND>(vth, n, rows * words * kWordBits, row,
                                          words, wcol, refs, n_refs,
                                          sense_invert != 0, op, invert != 0);
    count = __popc(word & __ldg(mask + row * words + wcol));
  }
  block_add(count, out + row);
}

}  // namespace mcf

#define MCF_DISPATCH_KIND(KERNEL, ...)                              \
  switch (kind) {                                                   \
    case kLsb: KERNEL<kLsb><<<grid, kBlock, 0, stream>>>(__VA_ARGS__); break; \
    case kMsb: KERNEL<kMsb><<<grid, kBlock, 0, stream>>>(__VA_ARGS__); break; \
    case kSbr: KERNEL<kSbr><<<grid, kBlock, 0, stream>>>(__VA_ARGS__); break; \
    case kParity: KERNEL<kParity><<<grid, kBlock, 0, stream>>>(__VA_ARGS__); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);        \
  }

extern "C" int mcf_sense_reduce(const float* vth, uint32_t* out, int64_t n,
                                int64_t rows, int64_t cols, int kind,
                                int n_refs, int sense_invert, int op,
                                int invert, const float* host_refs,
                                cudaStream_t stream) {
  using namespace mcf;
  const int64_t words = cols / kWordBits;
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = grid_for(rows * words);
  MCF_DISPATCH_KIND(sense_reduce_kernel, vth, out, n, rows, words, refs,
                    n_refs, sense_invert, op, invert)
  return static_cast<int>(cudaGetLastError());
}

// `out` must hold `rows` zeroed ints: blocks add their partial counts to it.
extern "C" int mcf_sense_reduce_popcount(const float* vth, const uint32_t* mask,
                                         int* out, int64_t n, int64_t rows,
                                         int64_t cols, int kind, int n_refs,
                                         int sense_invert, int op, int invert,
                                         const float* host_refs,
                                         cudaStream_t stream) {
  using namespace mcf;
  const int64_t words = cols / kWordBits;
  const int64_t blocks_per_row = (words + kBlock - 1) / kBlock;
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  MCF_DISPATCH_KIND(sense_reduce_popcount_kernel, vth, mask, out, n, rows,
                    words, blocks_per_row, refs, n_refs, sense_invert, op,
                    invert)
  return static_cast<int>(cudaGetLastError());
}
