"""repro_torch — the PyTorch / CUDA port of the MCFlash reproduction.

It mirrors :mod:`repro` (the JAX reference, which stays as it is) module by
module, runs on one NVIDIA H100 with hand-written CUDA kernels for the five
sense / reduce / popcount hot paths, and runs the kernels' plain PyTorch
versions on the CPU when asked (``ComputeSession(device="cpu")``).

Ported so far: the compute-session main path (``api``, ``core``, ``flash``,
``kernels``, ``obs.metrics``).  See ROADMAP.md for what is still to come.
"""
