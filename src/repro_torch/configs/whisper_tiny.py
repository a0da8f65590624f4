"""whisper-tiny [audio]: enc-dec, 4L encoder + 4L decoder, d_model=384 6H
d_ff=1536 vocab=51865 [arXiv:2212.04356].  The conv frontend is a STUB:
input_specs() provides precomputed frame embeddings (B, S_frames, d_model).
Encoder is full attention (quadratic) -> long_500k skipped."""
from repro_torch.configs.base import BlockCfg, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865,
    pattern=(BlockCfg("attn"),), repeats=4,     # decoder layers
    encdec=True, enc_layers=4, dec_seq=448,
    frontend="audio", rope_theta=1e4,
)
