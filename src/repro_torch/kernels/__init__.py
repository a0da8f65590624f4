"""Hand-written CUDA kernels for the MCFlash hot paths, each beside its
plain PyTorch version.

- ``mlc_sense``: sense + lane-major pack, and sense + count in one pass
  (``csrc/mlc_sense.cu``).
- ``fused``: sense -> reduce (-> popcount) megakernels (``csrc/fused.cu``).
- ``bitops``: and/or/xor folds of operands passed by pointer (``csrc/bitops.cu``).
- ``popcount``: per-row popcount, optionally masked (``csrc/popcount.cu``).
- ``rows``: the sense kernels' operand form, Vth rows read in place through
  int32 slot tables (a dense stack takes the identity table).
- ``ops``: plan-level entry points the backends call.
- ``ref``: the plain versions and the packing convention.
- ``cuda``: the nvcc build, ctypes loading and launch counts.
"""
