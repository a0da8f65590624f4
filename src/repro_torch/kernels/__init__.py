"""Hand-written CUDA kernels for the MCFlash hot paths, each beside its
plain PyTorch version.

- ``mlc_sense``: sense + lane-major pack (``csrc/mlc_sense.cu``).
- ``fused``: sense -> reduce (-> popcount) megakernels (``csrc/fused.cu``).
- ``bitops``: and/or/xor folds of operands passed by pointer (``csrc/bitops.cu``).
- ``popcount``: per-row popcount, optionally masked (``csrc/popcount.cu``).
- ``ops``: plan-level entry points the backends call.
- ``ref``: the plain versions and the packing convention.
- ``cuda``: the nvcc build, ctypes loading and launch counts.
"""
