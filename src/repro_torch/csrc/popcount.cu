// Per-row popcount: (R, W) words -> (R,) int32.
//
// Replaces src/repro/kernels/popcount.py:popcount_rows (_popcount_kernel).
// Bound by memory: 4 B read per word. Each thread counts kItems words of one
// row with __popc (strided by the block, so loads coalesce), and the block
// adds its sum to the row with one atomic.
#include "sense.cuh"

namespace mcf {

constexpr int kItems = 8;

__global__ void __launch_bounds__(kBlock)
popcount_rows_kernel(const uint32_t* __restrict__ words, int* __restrict__ out,
                     int64_t n_words, int64_t blocks_per_row) {
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t start = (blockIdx.x % blocks_per_row) * (kBlock * kItems) + threadIdx.x;
  const uint32_t* r = words + row * n_words;
  int count = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t c = start + static_cast<int64_t>(i) * kBlock;
    if (c < n_words) count += __popc(__ldg(r + c));
  }
  block_add(count, out + row);
}

}  // namespace mcf

// `out` must hold `rows` zeroed ints: blocks add their partial counts to it.
extern "C" int mcf_popcount_rows(const uint32_t* words, int* out, int64_t rows,
                                 int64_t n_words, cudaStream_t stream) {
  using namespace mcf;
  const int64_t per_block = static_cast<int64_t>(kBlock) * kItems;
  const int64_t blocks_per_row = (n_words + per_block - 1) / per_block;
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  mcf::popcount_rows_kernel<<<grid, kBlock, 0, stream>>>(words, out, n_words,
                                                         blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}
