"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The JAX package's ``models/rglru.py`` as plain PyTorch.  The recurrence
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t), with
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t)), is a first-order linear
scan: prefill runs it as a log-depth scan in float32 (``ceil(log2 S)``
passes over the whole sequence, where the JAX package uses
``lax.associative_scan``), decode as an O(1) state update.  The input and
recurrence gates are block-diagonal linears (16 blocks).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import causal_conv1d
from repro_torch.models.specs import ParamSpec

__all__ = ["N_BLOCKS", "C_SCALE", "rglru_specs", "rglru_forward",
           "rglru_decode", "rglru_init_state"]

N_BLOCKS = 16
C_SCALE = 8.0


def rglru_specs(cfg) -> dict:
    d, r = cfg.d_model, cfg.rnn_width
    blk = r // N_BLOCKS
    return {
        "w_y": ParamSpec((d, r), ("embed", "mlp")),       # gate branch
        "w_x": ParamSpec((d, r), ("embed", "mlp")),       # recurrent branch
        "conv_w": ParamSpec((cfg.conv_width, r), ("conv", None),
                            init="scaled", scale=0.1),
        "conv_b": ParamSpec((r,), (None,), init="zeros"),
        "gate_i_w": ParamSpec((N_BLOCKS, blk, blk), (None, None, None)),
        "gate_i_b": ParamSpec((r,), (None,), init="zeros"),
        "gate_a_w": ParamSpec((N_BLOCKS, blk, blk), (None, None, None)),
        "gate_a_b": ParamSpec((r,), (None,), init="zeros"),
        "lam": ParamSpec((r,), (None,), init="scaled", scale=0.5),
        "w_out": ParamSpec((r, cfg.d_model), ("mlp", "embed")),
    }


def _block_linear(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Block-diagonal linear: x (..., R) with R = N_BLOCKS * blk."""
    shape = x.shape
    xb = x.reshape(*shape[:-1], N_BLOCKS, shape[-1] // N_BLOCKS)
    yb = torch.einsum("...nb,nbc->...nc", xb, w)
    return yb.reshape(shape) + b


def _gates(p: dict, x: torch.Tensor):
    """x: (..., R) -> (a, gated input), both (..., R) in float32."""
    xf = x.float()
    i_t = torch.sigmoid(_block_linear(xf, p["gate_i_w"].float(),
                                      p["gate_i_b"].float()))
    r_t = torch.sigmoid(_block_linear(xf, p["gate_a_w"].float(),
                                      p["gate_a_b"].float()))
    a = torch.exp(-C_SCALE * F.softplus(p["lam"].float()) * r_t)
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    return a, mult * i_t * xf


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 (h_{-1} = 0), as
    ``ceil(log2 S)`` out-of-place passes of ``b[t] += a[t] * b[t-d];
    a[t] *= a[t-d]`` for d = 1, 2, 4, ..."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])],
                      dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_forward(p: dict, x: torch.Tensor, cfg, state=None):
    """Full-sequence RG-LRU block.  x: (B, S, D) -> (y, state)."""
    y_branch = F.gelu(x @ p["w_y"], approximate="tanh")
    xr = x @ p["w_x"]
    conv_in = None if state is None else state["conv"]
    xr, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"], conv_in)
    a, bx = _gates(p, xr)                                    # (B, S, R) f32
    if state is not None:
        # seed the scan with the carried hidden state via a virtual step 0
        bx = torch.cat([bx[:, :1] + a[:, :1] * state["h"].float()[:, None],
                        bx[:, 1:]], dim=1)
    hh = _linear_scan(a, bx)
    h = hh.to(x.dtype)                                       # (B, S, R)
    out = (h * y_branch) @ p["w_out"]
    return out, {"h": hh[:, -1], "conv": conv_state}


def rglru_decode(p: dict, x: torch.Tensor, cfg, state: dict):
    """Single-token update.  x: (B, 1, D)."""
    y_branch = F.gelu(x @ p["w_y"], approximate="tanh")
    xr = x @ p["w_x"]
    xr, conv_state = causal_conv1d(xr, p["conv_w"], p["conv_b"],
                                   state["conv"])
    a, bx = _gates(p, xr)                                    # (B, 1, R)
    h = a[:, 0] * state["h"].float() + bx[:, 0]
    out = (h[:, None].to(x.dtype) * y_branch) @ p["w_out"]
    return out, {"h": h, "conv": conv_state}


def rglru_init_state(cfg, batch: int, device: "torch.device | str") -> dict:
    return {
        "h": torch.zeros((batch, cfg.rnn_width), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.rnn_width),
                            dtype=torch.float32, device=device),
    }
