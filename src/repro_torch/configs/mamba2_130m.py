"""mamba2-130m [ssm]: 24L d_model=768 attn-free, vocab=50280, ssm_state=128,
SSD (state-space duality) [arXiv:2405.21060].  O(1) decode state ->
runs long_500k."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    d_model=768, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab=50280,
    pattern=(BlockCfg("ssd", mlp="none"),), repeats=24,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    supports_long_context=True,
)
