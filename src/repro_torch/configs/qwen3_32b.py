"""qwen3-32b [dense]: 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936, qk_norm, head_dim=128 [hf:Qwen/Qwen3-8B scaled]."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    d_model=5120, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=25600, vocab=151936,
    pattern=(BlockCfg("attn"),), repeats=64,
    qk_norm=True, rope_theta=1e6,
)
