"""Model zoo: config-driven LM assembly (every registry config serves)."""
from repro_torch.models import attention, layers, lm, moe, rglru, specs, ssd
from repro_torch.models.lm import (build_specs, cache_layout, cast_params,
                                   decode_step, encdec_prefill, forward_loss,
                                   init_cache, prefill)
from repro_torch.models.specs import (ParamSpec, count_params, init_tree,
                                      params_from_jax, params_to_numpy)

__all__ = ["attention", "layers", "lm", "moe", "rglru", "specs", "ssd",
           "build_specs", "cast_params", "forward_loss", "prefill",
           "decode_step", "encdec_prefill", "init_cache", "cache_layout",
           "ParamSpec", "init_tree", "count_params", "params_from_jax",
           "params_to_numpy"]
