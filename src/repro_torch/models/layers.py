"""Shared model layers: norms, rotary embeddings, the dense MLP, embedding.

Plain functions over tensors, as in the JAX package (``models/layers.py``),
with training's two pieces: :func:`grad_bf16` (an identity whose gradient
is cast to bfloat16) and :func:`chunked_softmax_xent` (the tied or untied
head and its cross-entropy in sequence chunks, one chunk's logits alive at
a time).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.specs import ParamSpec

__all__ = ["grad_bf16", "rms_norm", "rotary", "mlp_specs", "mlp_apply",
           "embed_specs", "embed_lookup", "chunked_softmax_xent",
           "causal_conv1d"]


class _GradBf16(torch.autograd.Function):
    """Identity forward; the backward casts the gradient of a bfloat16
    input to bfloat16 and hands a float32 input's on unchanged."""

    @staticmethod
    def forward(ctx, x):
        ctx.cast = x.dtype == torch.bfloat16
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16) if ctx.cast else g


def grad_bf16(x: torch.Tensor) -> torch.Tensor:
    """Identity whose gradient is cast to bfloat16, at the JAX package's
    ``grad_bf16`` points (activations leaving a bfloat16 region for a
    float32 interior).  A float32 input (the float32 path,
    ``dtype=torch.float32``) has no bfloat16 region to guard and passes
    its gradient on unchanged: the JAX package's cast hands a bfloat16
    cotangent to a float32 value there, which its own float32 backward
    cannot take (ROADMAP R10)."""
    return _GradBf16.apply(x)


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


def _xent_chunk(xc: torch.Tensor, table: torch.Tensor, yc: torch.Tensor,
                mc: torch.Tensor) -> torch.Tensor:
    """Masked cross-entropy summed over one chunk: xc (B, C, D)."""
    logits = (xc @ table.T).float()                          # (B, C, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, yc[..., None].long())[..., 0]
    return ((logz - gold) * mc).sum()


def chunked_softmax_xent(x: torch.Tensor, table: torch.Tensor,
                         labels: torch.Tensor, mask: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Cross-entropy of (B, S, D) activations against the head ``table``
    (V, D), in sequence chunks: each chunk's (B, chunk, V) float32 logits
    are recomputed in the backward (``checkpoint``), so one chunk's logits
    are alive at a time, in the forward and in the backward; at V = 262144
    that decides whether a step fits.  The sum of the masked losses over
    ``max(mask.sum(), 1)``."""
    s = x.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk "
                         f"{chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        sl = slice(i, i + chunk)
        total = total + checkpoint(_xent_chunk, x[:, sl], table,
                                   labels[:, sl], mask[:, sl],
                                   use_reentrant=False)
    return total / torch.clamp(mask.sum(), min=1)


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
