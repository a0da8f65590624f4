// Fused sense -> reduce (-> masked popcount) over N same-plan operands, each
// R rows read through its slot table.
//
// Replaces src/repro/kernels/fused.py:sense_reduce (_sense_reduce_kernel) and
// :sense_reduce_popcount (_sense_reduce_popcount_kernel). Bound by memory:
// 4 B read per cell of every operand; 1/8 B per cell written (sense_reduce),
// or the mask read plus 4 B per row (popcount). Each thread senses its word
// in every operand and folds the words in registers, so no partial result
// goes to device memory. A block covers kBlock words of one row: its first N
// threads look up that row in the N tables, once for the block.
#include "sense.cuh"

namespace mcf {

// The addresses of row `row` of the n operands, in shared memory.
__device__ __forceinline__ void load_rows(const RowTables& tables, int n,
                                          int64_t row, int64_t cols,
                                          const float** rows) {
  const int t = static_cast<int>(threadIdx.x);
  if (t < n) rows[t] = table_row(tables, t, row, cols);
  __syncthreads();
}

template <int KIND>
__device__ __forceinline__ uint32_t fold_word(const float* const* rows, int n,
                                              int64_t wcol, const Refs& refs,
                                              int n_refs, bool sense_invert,
                                              int op, bool invert) {
  const int64_t tile = wcol / kLanes;
  const int w = static_cast<int>(wcol % kLanes);
  uint32_t acc = sense_word<KIND>(rows[0], tile, w, refs, n_refs, sense_invert);
  for (int i = 1; i < n; ++i) {
    acc = combine(acc, sense_word<KIND>(rows[i], tile, w, refs, n_refs,
                                        sense_invert), op);
  }
  return invert ? ~acc : acc;
}

template <int KIND>
__global__ void __launch_bounds__(kBlock)
sense_reduce_kernel(const RowTables tables, int n, uint32_t* __restrict__ out,
                    int64_t words, int64_t blocks_per_row, Refs refs,
                    int n_refs, int sense_invert, int op, int invert) {
  __shared__ const float* rows[kMaxTables];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t wcol = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  load_rows(tables, n, row, words * kWordBits, rows);
  if (wcol >= words) return;
  out[row * words + wcol] = fold_word<KIND>(rows, n, wcol, refs, n_refs,
                                            sense_invert != 0, op, invert != 0);
}

template <int KIND>
__global__ void __launch_bounds__(kBlock)
sense_reduce_popcount_kernel(const RowTables tables, int n,
                             const uint32_t* __restrict__ mask,
                             int* __restrict__ out, int64_t words,
                             int64_t blocks_per_row, Refs refs, int n_refs,
                             int sense_invert, int op, int invert) {
  __shared__ const float* rows[kMaxTables];
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t wcol = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  load_rows(tables, n, row, words * kWordBits, rows);
  int count = 0;
  if (wcol < words) {
    const uint32_t word = fold_word<KIND>(rows, n, wcol, refs, n_refs,
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

// `bases` and `slots` are host arrays of `n` (1..kMaxTables) operands, each
// with a table of `rows` slots.
extern "C" int mcf_sense_reduce(const float* const* bases,
                                const int32_t* const* slots, int n,
                                uint32_t* out, int64_t rows, int64_t cols,
                                int kind, int n_refs, int sense_invert, int op,
                                int invert, const float* host_refs,
                                cudaStream_t stream) {
  using namespace mcf;
  if (n < 1 || n > kMaxTables || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = cols / kWordBits;
  const int64_t blocks_per_row = (words + kBlock - 1) / kBlock;
  const RowTables tables = load_tables(bases, slots, nullptr, n);
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  MCF_DISPATCH_KIND(sense_reduce_kernel, tables, n, out, words, blocks_per_row,
                    refs, n_refs, sense_invert, op, invert)
  return static_cast<int>(cudaGetLastError());
}

// `out` must hold `rows` zeroed ints: blocks add their partial counts to it.
extern "C" int mcf_sense_reduce_popcount(const float* const* bases,
                                         const int32_t* const* slots, int n,
                                         const uint32_t* mask, int* out,
                                         int64_t rows, int64_t cols, int kind,
                                         int n_refs, int sense_invert, int op,
                                         int invert, const float* host_refs,
                                         cudaStream_t stream) {
  using namespace mcf;
  if (n < 1 || n > kMaxTables || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = cols / kWordBits;
  const int64_t blocks_per_row = (words + kBlock - 1) / kBlock;
  const RowTables tables = load_tables(bases, slots, nullptr, n);
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  MCF_DISPATCH_KIND(sense_reduce_popcount_kernel, tables, n, mask, out, words,
                    blocks_per_row, refs, n_refs, sense_invert, op, invert)
  return static_cast<int>(cudaGetLastError());
}
