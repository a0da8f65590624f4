// Sense + pack: (R, C) float32 Vth -> (R, C/32) packed words.
//
// Replaces src/repro/kernels/mlc_sense.py:mlc_sense (_sense_kernel). Bound by
// memory: 4 B read per cell, 1/8 B written. One thread per output word.
#include "sense.cuh"

namespace mcf {

template <int KIND>
__global__ void __launch_bounds__(kBlock)
mlc_sense_kernel(const float* __restrict__ vth, uint32_t* __restrict__ out,
                 int64_t rows, int64_t words, Refs refs, int n_refs, int invert) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= rows * words) return;
  const int64_t row = t / words, wcol = t % words;
  out[t] = sense_word<KIND>(vth + row * words * kWordBits, wcol / kLanes,
                            static_cast<int>(wcol % kLanes), refs, n_refs,
                            invert != 0);
}

}  // namespace mcf

extern "C" int mcf_mlc_sense(const float* vth, uint32_t* out, int64_t rows,
                             int64_t cols, int kind, int n_refs, int invert,
                             const float* host_refs, cudaStream_t stream) {
  using namespace mcf;
  const int64_t words = cols / kWordBits;
  const Refs refs = load_refs(host_refs);
  const unsigned int grid = grid_for(rows * words);
  switch (kind) {
    case kLsb:
      mlc_sense_kernel<kLsb><<<grid, kBlock, 0, stream>>>(vth, out, rows, words, refs, n_refs, invert);
      break;
    case kMsb:
      mlc_sense_kernel<kMsb><<<grid, kBlock, 0, stream>>>(vth, out, rows, words, refs, n_refs, invert);
      break;
    case kSbr:
      mlc_sense_kernel<kSbr><<<grid, kBlock, 0, stream>>>(vth, out, rows, words, refs, n_refs, invert);
      break;
    case kParity:
      mlc_sense_kernel<kParity><<<grid, kBlock, 0, stream>>>(vth, out, rows, words, refs, n_refs, invert);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* mcf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
