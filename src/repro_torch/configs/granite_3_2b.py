"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 [hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155,
    pattern=(BlockCfg("attn"),), repeats=40,
    rope_theta=1e4,
)
