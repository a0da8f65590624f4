"""recurrentgemma-9b [hybrid]: RG-LRU + local attention, 1 attn : 2 recurrent.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000 [arXiv:2402.19427].
Stack: (rglru, rglru, local-attn@2048) x 12 + 2 rglru tail = 38 layers.
Sub-quadratic (RG-LRU state + windowed attention) -> runs long_500k.
"""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    pattern=(BlockCfg("rglru"), BlockCfg("rglru"), BlockCfg("swa", window=2048)),
    repeats=12,
    tail=(BlockCfg("rglru"), BlockCfg("rglru")),
    rnn_width=4096, conv_width=4,
    rope_theta=1e4,
    supports_long_context=True,
)
