"""repro_torch.api — the compute-session layer of the PyTorch port.

>>> from repro_torch.api import ComputeSession
>>> sess = ComputeSession()                       # the card, CUDA kernels
>>> a, b = sess.write_pair("a", bits_a, "b", bits_b)
>>> words = (a & b).materialize()                 # one in-flash sense
>>> hits = (a & b).popcount()

``ComputeSession(device="cpu")`` runs the plain PyTorch versions instead.
Names resolve lazily to keep the ``core <- flash <- api`` layering
cycle-free.
"""
from repro_torch.api.ledger import LEDGER_MODES, Ledger
from repro_torch.api.plan_cache import ExecutableCache, PlanCache

_LAZY = {
    "ComputeSession": "repro_torch.api.session",
    "resolve_device": "repro_torch.api.session",
    "DrainHandle": "repro_torch.api.hostio",
    "HostDrainQueue": "repro_torch.api.hostio",
    "BitVector": "repro_torch.api.graph",
    "simplify": "repro_torch.api.graph",
    "Executor": "repro_torch.api.executor",
    "ExecPlan": "repro_torch.api.executor",
    "Backend": "repro_torch.api.backends",
}

__all__ = ["ExecutableCache", "LEDGER_MODES", "Ledger", "PlanCache",
           *sorted(_LAZY)]


def __getattr__(name: str):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)


def __dir__():
    return sorted(__all__)
