// Per-row popcount, optionally masked: (R, W) words [& (R, W) mask] ->
// (R,) int32.
//
// Replaces src/repro/kernels/popcount.py:popcount_rows (_popcount_kernel);
// the mask folds in the `& mask` pass that preceded every root count, the
// masked-count idiom of src/repro/kernels/fused.py:sense_reduce_popcount.
// Bound by memory: 4 B read per word (and per mask word), 4 B written per
// row. Each row gets a share of a resident grid (the blocks the card holds
// at once), which keeps the atomics per row few; a block strides 16-byte
// loads over its row when the words (and the mask) are 16-byte aligned at
// every row, then a scalar loop takes the words left over. Counts use
// __popc, and each block adds its sum to the row with one atomic, after a
// warp-shuffle and block reduction. The C entry zeroes the output on the
// same stream first, so the wrapper issues one call and allocates with
// torch.empty.
#include "sense.cuh"

namespace mcf {

template <bool MASKED>
__global__ void __launch_bounds__(kBlock)
popcount_rows_kernel(const uint32_t* __restrict__ words,
                     const uint32_t* __restrict__ mask, int* __restrict__ out,
                     int64_t n_words, int64_t vecs, int64_t blocks_per_row) {
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t stride = blocks_per_row * kBlock;
  const int64_t first = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  const uint32_t* w = words + row * n_words;
  const uint32_t* m = MASKED ? mask + row * n_words : nullptr;
  int count = 0;
#pragma unroll 4
  for (int64_t v = first; v < vecs; v += stride) {
    uint4 x = __ldg(reinterpret_cast<const uint4*>(w) + v);
    if (MASKED) {
      const uint4 k = __ldg(reinterpret_cast<const uint4*>(m) + v);
      x.x &= k.x; x.y &= k.y; x.z &= k.z; x.w &= k.w;
    }
    count += __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
  }
  for (int64_t c = vecs * 4 + first; c < n_words; c += stride) {
    uint32_t x = __ldg(w + c);
    if (MASKED) x &= __ldg(m + c);
    count += __popc(x);
  }
  block_add(count, out + row);
}

}  // namespace mcf

// `out` gets `rows` ints, zeroed here on `stream` before the kernel adds to
// them; `mask` is null or `rows * n_words` words like `words`.
extern "C" int mcf_popcount_rows(const uint32_t* words, const uint32_t* mask,
                                 int* out, int64_t rows, int64_t n_words,
                                 cudaStream_t stream) {
  using namespace mcf;
  if (rows < 1 || n_words < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(out, 0, rows * sizeof(int), stream);
  if (err != cudaSuccess || n_words == 0) return static_cast<int>(err);
  // every row starts on a 16-byte boundary only if W is a multiple of 4
  const bool vec = aligned16(words) && (mask == nullptr || aligned16(mask)) &&
                   (rows == 1 || n_words % 4 == 0);
  const int64_t vecs = vec ? n_words / 4 : 0;
  const int64_t units = vec ? vecs : n_words;
  const int64_t per_row = (resident_blocks() + rows - 1) / rows;
  const int64_t blocks_per_row = grid_for(units, per_row);
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  if (mask != nullptr)
    popcount_rows_kernel<true><<<grid, kBlock, 0, stream>>>(
        words, mask, out, n_words, vecs, blocks_per_row);
  else
    popcount_rows_kernel<false><<<grid, kBlock, 0, stream>>>(
        words, mask, out, n_words, vecs, blocks_per_row);
  return static_cast<int>(cudaGetLastError());
}
