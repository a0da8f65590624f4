"""Functional execution of the Fig-10 application workloads on a session.

:mod:`repro_torch.flash.system` models the paper's workloads analytically
(latency projections at full SSD scale); this module runs a scaled-down
wave of each workload through :class:`ComputeSession` (program operands,
in-flash k-operand chain, controller combine), checks it bit for bit
against a logical oracle on the session's device, and pairs the measured
ledger with the analytic full-scale projection.

The operand bits come from ``numpy.random.default_rng(seed)``, as in the
JAX package, so both packages run a workload on the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.session import ComputeSession
from repro_torch.core import encoding
from repro_torch.flash.system import SystemModel, Workload, speedup_table
from repro_torch.kernels import ref as kernel_ref


def run_workload(workload: Workload, *, session: ComputeSession | None = None,
                 device: "torch.device | str | None" = None,
                 n_bits: int | None = None, model: SystemModel | None = None,
                 seed: int = 0, verify: bool = True) -> dict:
    """Run one scaled-down wave of a workload functionally + project full scale.

    ``session`` defaults to a new one on ``device`` (the card unless
    ``"cpu"``).  Returns ``{"result_packed", "measured", "projection",
    "stats"}``: the result's packed words on the session's device, the
    session ledger summary of the run, and the analytic full-scale speedup
    table.
    """
    session = session or ComputeSession(device, seed=seed)
    n = n_bits or session.device.config.page_bits
    rng = np.random.default_rng(seed)
    k = workload.k_operands
    bits = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(k)]

    vecs = []
    for i in range(0, k - 1, 2):
        a, b = session.write_pair(f"{workload.name}_op{i}", bits[i],
                                  f"{workload.name}_op{i + 1}", bits[i + 1])
        vecs.extend((a, b))
    if k % 2:
        vecs.append(session.write(f"{workload.name}_op{k - 1}", bits[k - 1]))

    expr = session.chain(workload.op, vecs)
    result = session.materialize(expr, to_host=workload.result_to_host)

    if verify:
        dev = session.torch_device
        oracle = torch.from_numpy(bits[0]).to(dev)
        for v in bits[1:]:
            oracle = encoding.logical_op(workload.op, oracle,
                                         torch.from_numpy(v).to(dev))
        got = kernel_ref.unpack_bits(result.reshape(1, -1))[0][:n]
        wrong = int(torch.count_nonzero(got != oracle))
        if wrong:
            raise AssertionError(f"{workload.name}: {wrong} of {n} result "
                                 "bits differ from the logical oracle")

    return {
        "result_packed": result,
        "measured": session.ledger.summary(),
        "projection": speedup_table(workload, model),
        "stats": session.stats(),
    }
