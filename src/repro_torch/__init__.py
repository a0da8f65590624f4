"""repro_torch — the PyTorch / CUDA port of the MCFlash reproduction.

It mirrors :mod:`repro` (the JAX reference, which stays as it is) module by
module, runs on one NVIDIA H100 with hand-written CUDA kernels for the five
sense / reduce / popcount hot paths, and runs the kernels' plain PyTorch
versions on the CPU when asked (``ComputeSession(device="cpu")``).

Ported so far: the compute-session main path (``api``, ``core``, ``flash``,
``kernels``) with the placed wave runner (shards on per-entry CUDA
streams), the static plan verifier (``verify``), the span tracer and
metrics (``obs``), the serving engines (``serve``: bitmap queries and LM
decode), the wear-fault and recovery layer (``reliability``,
``core.calibration``), the attention-stack LMs (``configs``, ``models``)
and checkpoints with XOR deltas (``checkpoint``).  See ROADMAP.md for what
is still to come.
"""
