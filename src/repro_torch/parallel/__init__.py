"""Distribution layer (PyTorch port of :mod:`repro.parallel`): sharding
rules, gradient compression with its all-reduce over a process group, and
the GPipe schedule on CUDA streams (``pipeline.py``)."""
from repro_torch.parallel import compression, pipeline, sharding
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.parallel.sharding import (RULES_MULTI_POD, RULES_SINGLE_POD,
                                           constrain, named_sharding,
                                           resolve_spec, rules_for_mesh,
                                           shard_shape)

__all__ = ["sharding", "compression", "pipeline", "pipeline_apply",
           "constrain", "resolve_spec", "named_sharding", "shard_shape",
           "rules_for_mesh", "RULES_SINGLE_POD", "RULES_MULTI_POD"]
