"""Model zoo: config-driven LM assembly (the attention stacks so far)."""
from repro_torch.models import attention, layers, lm, specs
from repro_torch.models.lm import (build_specs, cache_layout, cast_params,
                                   decode_step, init_cache, prefill)
from repro_torch.models.specs import (ParamSpec, count_params, init_tree,
                                      params_from_jax, params_to_numpy)

__all__ = ["attention", "layers", "lm", "specs", "build_specs",
           "cast_params", "prefill", "decode_step", "init_cache",
           "cache_layout", "ParamSpec", "init_tree", "count_params",
           "params_from_jax", "params_to_numpy"]
