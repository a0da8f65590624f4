"""repro_torch — the PyTorch / CUDA port of the MCFlash reproduction.

It mirrors :mod:`repro` (the JAX reference, which stays as it is) module by
module, runs on one NVIDIA H100 with hand-written CUDA kernels for the five
sense / reduce / popcount hot paths, and runs the kernels' plain PyTorch
versions on the CPU when asked (``ComputeSession(device="cpu")``).

Ported so far: the compute-session main path (``api``, ``core``, ``flash``,
``kernels``), the static plan verifier (``verify``), the span tracer and
metrics (``obs``), the serving engine (``serve``) and the wear-fault and
recovery layer (``reliability``, ``core.calibration``).  See ROADMAP.md for
what is still to come.
"""
