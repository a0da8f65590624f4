"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144,
5:1 local:global (window 512), 128k context [hf:google/gemma-3-1b-pt].
Stack: (5 x local@512 + 1 global) x 4 + 2 local = 26 layers.
Mostly-local stack -> runs long_500k (4 global layers decode linearly
against a sequence-sharded KV cache)."""
from repro_torch.configs.base import BlockCfg, ModelConfig

_LOCAL = BlockCfg("swa", window=512)
CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab=262144,
    pattern=(_LOCAL, _LOCAL, _LOCAL, _LOCAL, _LOCAL, BlockCfg("attn")),
    repeats=4,
    tail=(_LOCAL, _LOCAL),
    qk_norm=True, rope_theta=1e6,
    supports_long_context=True,
)
