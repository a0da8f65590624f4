"""Distribution layer (PyTorch port of :mod:`repro.parallel`): sharding
rules and gradient compression.  The GPipe schedule (``pipeline.py``)
needs several ranks and is not ported yet."""
from repro_torch.parallel import compression, sharding
from repro_torch.parallel.sharding import (RULES_MULTI_POD, RULES_SINGLE_POD,
                                           constrain, resolve_spec,
                                           rules_for_mesh)

__all__ = ["sharding", "compression", "constrain", "resolve_spec",
           "rules_for_mesh", "RULES_SINGLE_POD", "RULES_MULTI_POD"]
