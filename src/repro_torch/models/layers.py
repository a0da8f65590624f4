"""Shared model layers: norms, rotary embeddings, the dense MLP, embedding.

Plain functions over tensors, as in the JAX package (``models/layers.py``).
Training's pieces (``grad_bf16``, ``chunked_softmax_xent``) wait for the
port of training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.specs import ParamSpec

__all__ = ["rms_norm", "rotary", "mlp_specs", "mlp_apply", "embed_specs",
           "embed_lookup", "causal_conv1d"]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32 with the gemma-style ``(1 + w)`` gain."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w)).to(dt)      # (1 + w) in w's dtype, as in JAX


def rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE.  x: (..., S, D) with D even; positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(device=x.device, dtype=torch.float32) * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    while cos.ndim < x.ndim:        # broadcast over the head dims
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------- dense (SwiGLU) MLP -----------------------------

def mlp_specs(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ----------------------------- embedding -------------------------------------

def embed_specs(vocab: int, d_model: int) -> ParamSpec:
    return ParamSpec((vocab, d_model), ("vocab", "embed"), init="scaled",
                     scale=0.02)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: "torch.Tensor | None" = None,
                  state: "torch.Tensor | None" = None):
    """Depthwise causal conv.  x: (B, S, C), w: (W, C).  Returns (y,
    new_state), where the state carries the trailing W-1 inputs for
    streaming decode (in x's dtype)."""
    width = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                          # (B, S+W-1, C)
    s = x.shape[1]
    y = 0
    for i in range(width):
        y = y + xp[:, i:i + s] * w[i]
    if b is not None:
        y = y + b
    new_state = xp[:, -(width - 1):] if width > 1 else pad
    return y, new_state
