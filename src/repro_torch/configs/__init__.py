"""Arch registry: ``get_config("<id>")`` for every assigned architecture.

The port keeps its own copy of the JAX package's configs (plain data), so
it imports nothing of :mod:`repro`."""
from repro_torch.configs import (dbrx_132b, gemma3_1b, granite_3_2b,
                                 internvl2_26b, mamba2_130m, mixtral_8x7b,
                                 qwen3_1p7b, qwen3_32b, recurrentgemma_9b,
                                 whisper_tiny)
from repro_torch.configs.base import SHAPES, BlockCfg, ModelConfig, ShapeCfg, shapes_for

_MODULES = (recurrentgemma_9b, qwen3_32b, gemma3_1b, granite_3_2b, qwen3_1p7b,
            internvl2_26b, mamba2_130m, dbrx_132b, mixtral_8x7b, whisper_tiny)

REGISTRY = {m.CONFIG.name: m.CONFIG for m in _MODULES}
ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str) -> ModelConfig:
    key = name.strip().lower()
    if key not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[key]


__all__ = ["ModelConfig", "BlockCfg", "ShapeCfg", "SHAPES", "shapes_for",
           "REGISTRY", "ARCH_NAMES", "get_config"]
