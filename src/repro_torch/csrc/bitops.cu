// Packed multi-operand chain: (N, R, W) words -> (R, W) and/or/xor fold,
// optional final NOT.
//
// Replaces src/repro/kernels/bitops.py:bitwise_reduce (_chain_kernel). Bound
// by memory: 4 B read per word of each operand, 4 B written per output word.
// One thread per output word; the fold stays in a register.
#include "sense.cuh"

namespace mcf {

__global__ void __launch_bounds__(kBlock)
bitwise_reduce_kernel(const uint32_t* __restrict__ stack,
                      uint32_t* __restrict__ out, int64_t n, int64_t plane,
                      int op, int invert) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (t >= plane) return;
  uint32_t acc = __ldg(stack + t);
  for (int64_t i = 1; i < n; ++i) acc = combine(acc, __ldg(stack + i * plane + t), op);
  out[t] = invert ? ~acc : acc;
}

}  // namespace mcf

extern "C" int mcf_bitwise_reduce(const uint32_t* stack, uint32_t* out,
                                  int64_t n, int64_t rows, int64_t words,
                                  int op, int invert, cudaStream_t stream) {
  using namespace mcf;
  if (op < kAnd || op > kXor) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t plane = rows * words;
  mcf::bitwise_reduce_kernel<<<grid_for(plane), kBlock, 0, stream>>>(
      stack, out, n, plane, op, invert);
  return static_cast<int>(cudaGetLastError());
}
