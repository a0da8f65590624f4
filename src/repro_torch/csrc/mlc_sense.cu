// Sense + pack: R float32 Vth rows, read through slot tables -> (R, C/32)
// packed words.
//
// Replaces src/repro/kernels/mlc_sense.py:mlc_sense (_sense_kernel). Bound by
// memory: 4 B read per cell, 1/8 B written. One thread per output word; a
// block covers kBlock words of one output row, whose address its first thread
// looks up in the tables (the output rows are the tables' rows in order).
#include "sense.cuh"

namespace mcf {

template <int KIND, int NREFS = kMaxRefs>
__global__ void __launch_bounds__(kBlock)
mlc_sense_kernel(const RowTables tables, int n_tables,
                 uint32_t* __restrict__ out, int64_t words,
                 int64_t blocks_per_row, Refs refs, int n_refs, int invert) {
  __shared__ const float* src;
  const int64_t row = blockIdx.x / blocks_per_row;
  const int64_t wcol = (blockIdx.x % blocks_per_row) * kBlock + threadIdx.x;
  if (threadIdx.x == 0) {
    int i = 0;
    while (i + 1 < n_tables && row >= tables.end[i]) ++i;
    src = table_row(tables, i, row - (i ? tables.end[i - 1] : 0),
                    words * kWordBits);
  }
  __syncthreads();
  if (wcol >= words) return;
  out[row * words + wcol] = sense_word<KIND, NREFS>(src, wcol / kLanes,
                                             static_cast<int>(wcol % kLanes),
                                             refs, n_refs, invert != 0);
}

}  // namespace mcf

// `bases`, `slots` and `ends` are host arrays of `n_tables` (1..kMaxTables)
// entries: table i's rows are the output rows [ends[i-1], ends[i]), and
// ends[n_tables - 1] == rows.
extern "C" int mcf_mlc_sense(const float* const* bases,
                             const int32_t* const* slots, const int64_t* ends,
                             int n_tables, uint32_t* out, int64_t rows,
                             int64_t cols, int kind, int n_refs, int invert,
                             const float* host_refs, cudaStream_t stream) {
  using namespace mcf;
  if (n_tables < 1 || n_tables > kMaxTables || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t words = cols / kWordBits;
  const int64_t blocks_per_row = (words + kBlock - 1) / kBlock;
  const RowTables tables = load_tables(bases, slots, ends, n_tables);
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = static_cast<unsigned int>(rows * blocks_per_row);
  switch (kind) {
    case kLsb:
      mlc_sense_kernel<kLsb><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      break;
    case kMsb:
      mlc_sense_kernel<kMsb><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      break;
    case kSbr:
      mlc_sense_kernel<kSbr><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      break;
    case kParity:
      // TLC's AND3 and the reduced-MLC AND read one reference, TLC's OR3
      // two: their launches compare each cell that often, not kMaxRefs times
      if (n_refs == 1)
        mlc_sense_kernel<kParity, 1><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      else if (n_refs == 2)
        mlc_sense_kernel<kParity, 2><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      else
        mlc_sense_kernel<kParity><<<grid, kBlock, 0, stream>>>(tables, n_tables, out, words, blocks_per_row, refs, n_refs, invert);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
