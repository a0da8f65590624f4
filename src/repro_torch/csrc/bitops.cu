// Packed multi-operand chain: N operands of `plane` words each -> `plane`
// words, and/or/xor fold, optional final NOT.
//
// Replaces src/repro/kernels/bitops.py:bitwise_reduce (_chain_kernel). Bound
// by memory: 4 B read per word of each operand, 4 B written per output word.
//
// The operands arrive by pointer, up to kMaxOperands of them, in a struct
// passed by value in the kernel's parameter space (8 B a pointer, far inside
// the 4 KB parameter limit), so callers fold separate tensors without
// stacking them first and nothing is copied to the card before the launch.
// When the output and every operand are 16-byte aligned, each thread folds
// uint4 (16-byte) loads across the operands in registers; a scalar loop then
// takes the words the vector loop left (plane % 4, or every word when an
// operand or the output is not aligned). The grid gives every thread one
// uint4 (or one word): on the H100 a grid of resident blocks looping over
// the plane streamed two 1.2 GB operands more slowly than torch's own
// elementwise kernel, and this grid does not. Both loops stride by the grid
// only where a plane outgrows the largest grid.
#include "sense.cuh"

namespace mcf {

constexpr int kMaxOperands = 64;
constexpr int64_t kMaxGrid = int64_t{1} << 30;

struct Operands {
  const uint32_t* p[kMaxOperands];
};

template <int OP>
__device__ __forceinline__ uint4 combine4(uint4 a, uint4 b) {
  return make_uint4(combine(a.x, b.x, OP), combine(a.y, b.y, OP),
                    combine(a.z, b.z, OP), combine(a.w, b.w, OP));
}

template <int OP>
__global__ void __launch_bounds__(kBlock)
bitwise_reduce_kernel(const Operands ops, int n, uint32_t* out, int64_t plane,
                      int64_t vecs, uint32_t flip) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kBlock;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  for (int64_t v = first; v < vecs; v += stride) {
    uint4 acc = __ldg(reinterpret_cast<const uint4*>(ops.p[0]) + v);
#pragma unroll 4
    for (int i = 1; i < n; ++i)
      acc = combine4<OP>(acc, __ldg(reinterpret_cast<const uint4*>(ops.p[i]) + v));
    acc.x ^= flip; acc.y ^= flip; acc.z ^= flip; acc.w ^= flip;
    reinterpret_cast<uint4*>(out)[v] = acc;
  }
  for (int64_t t = vecs * 4 + first; t < plane; t += stride) {
    uint32_t acc = __ldg(ops.p[0] + t);
#pragma unroll 4
    for (int i = 1; i < n; ++i) acc = combine(acc, __ldg(ops.p[i] + t), OP);
    out[t] = acc ^ flip;
  }
}

}  // namespace mcf

// `operands` is a host array of `n` (1..64) device pointers, each to `plane`
// words. `out` (`plane` words) may be an operand itself, since each thread
// reads every operand's word before it writes that word, but must not
// partly overlap one.
extern "C" int mcf_bitwise_reduce(const uint32_t* const* operands, int n,
                                  uint32_t* out, int64_t plane, int op,
                                  int invert, cudaStream_t stream) {
  using namespace mcf;
  if (op < kAnd || op > kXor || n < 1 || n > kMaxOperands || plane < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plane == 0) return static_cast<int>(cudaGetLastError());
  Operands ops;
  bool vec = aligned16(out);
  for (int i = 0; i < n; ++i) {
    ops.p[i] = operands[i];
    vec = vec && aligned16(operands[i]);
  }
  const int64_t vecs = vec ? plane / 4 : 0;
  const int64_t units = vec ? vecs + plane % 4 : plane;
  const unsigned int grid = grid_for(units, kMaxGrid);
  const uint32_t flip = invert ? 0xffffffffu : 0u;
  if (op == kAnd)
    bitwise_reduce_kernel<kAnd><<<grid, kBlock, 0, stream>>>(ops, n, out, plane, vecs, flip);
  else if (op == kOr)
    bitwise_reduce_kernel<kOr><<<grid, kBlock, 0, stream>>>(ops, n, out, plane, vecs, flip);
  else
    bitwise_reduce_kernel<kXor><<<grid, kBlock, 0, stream>>>(ops, n, out, plane, vecs, flip);
  return static_cast<int>(cudaGetLastError());
}
