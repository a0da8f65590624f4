"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 (per
expert) vocab=32000, 8 experts top-2, sliding-window attention 4096
[arXiv:2401.04088].  SWA bounds every KV cache -> runs long_500k."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=32000,
    pattern=(BlockCfg("swa", mlp="moe", window=4096),), repeats=32,
    n_experts=8, top_k=2,
    rope_theta=1e6,
    supports_long_context=True,
)
