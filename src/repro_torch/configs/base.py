"""Model / shape configuration dataclasses and the arch registry."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BlockCfg:
    """One decoder block: a sequence-mixing layer + an MLP."""
    kind: str                 # 'attn' | 'swa' | 'rglru' | 'ssd'
    mlp: str = "dense"        # 'dense' | 'moe' | 'none'
    window: int = 0           # sliding-window size for kind == 'swa'


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    # layer stack: pattern repeated `repeats` times, then `tail` (unrolled)
    pattern: Tuple[BlockCfg, ...]
    repeats: int
    tail: Tuple[BlockCfg, ...] = ()
    qk_norm: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    # RG-LRU
    rnn_width: int = 0
    # encoder-decoder (whisper)
    encdec: bool = False
    enc_layers: int = 0
    dec_seq: int = 448
    # modality frontend stub: model consumes precomputed embeddings
    frontend: str = "none"    # none | audio | vision
    tie_embeddings: bool = True
    # long_500k eligibility (sub-quadratic stacks only)
    supports_long_context: bool = False
    notes: str = ""

    @property
    def n_layers(self) -> int:
        return self.repeats * len(self.pattern) + len(self.tail)

    @property
    def uses_tokens(self) -> bool:
        return self.frontend == "none"


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    step: str                 # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> list[str]:
    """The shape grid cells this arch runs (long_500k only if sub-quadratic)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
