"""internvl2-26b [vlm]: InternLM2 backbone, 48L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=92553 [arXiv:2404.16821].  The InternViT frontend is a
STUB: input_specs() provides precomputed patch embeddings (B, S, d_model)."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92553,
    pattern=(BlockCfg("attn"),), repeats=48,
    rope_theta=1e6,
    frontend="vision",
)
