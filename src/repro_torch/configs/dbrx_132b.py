"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert)
vocab=100352, 16 experts top-4 fine-grained [hf:databricks/dbrx-base]."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352,
    pattern=(BlockCfg("attn", mlp="moe"),), repeats=40,
    n_experts=16, top_k=4,
    rope_theta=5e5,
)
