"""Mamba-2 SSD (state-space duality) block, arXiv:2405.21060.

The JAX package's ``models/ssd.py`` as plain PyTorch.  Prefill uses the
chunked SSD algorithm: attention-like compute within chunks of up to 128
tokens plus a linear state pass across chunks (a loop over chunks, where
the JAX package uses ``lax.scan``).  Decode is the O(1) recurrent update.

Mixed dtypes follow the JAX function's promotions: bfloat16 operands meet
float32 decays in float32 (``torch.einsum`` does not promote, so they are
cast where JAX promotes), and the intra-chunk scores are cast to the
input's dtype where the JAX function casts them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import causal_conv1d, rms_norm
from repro_torch.models.specs import ParamSpec

__all__ = ["CHUNK", "ssd_dims", "ssd_specs", "ssd_forward", "ssd_decode",
           "ssd_init_state"]

CHUNK = 128


def ssd_dims(cfg) -> dict:
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    conv_dim = d_inner + 2 * cfg.ssm_state
    return dict(d_inner=d_inner, n_heads=n_heads, conv_dim=conv_dim,
                p=cfg.ssm_head_dim, n=cfg.ssm_state)


def ssd_specs(cfg) -> dict:
    d = ssd_dims(cfg)
    zxbcdt = 2 * d["d_inner"] + 2 * d["n"] + d["n_heads"]
    return {
        "in_proj": ParamSpec((cfg.d_model, zxbcdt), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.conv_width, d["conv_dim"]), ("conv", None),
                            init="scaled", scale=0.1),
        "conv_b": ParamSpec((d["conv_dim"],), (None,), init="zeros"),
        "a_log": ParamSpec((d["n_heads"],), (None,), init="ones"),
        "d_skip": ParamSpec((d["n_heads"],), (None,), init="ones"),
        "dt_bias": ParamSpec((d["n_heads"],), (None,), init="zeros"),
        "norm": ParamSpec((d["d_inner"],), (None,), init="zeros"),
        "out_proj": ParamSpec((d["d_inner"], cfg.d_model), ("mlp", "embed")),
    }


def _split_zxbcdt(zxbcdt: torch.Tensor, d: dict):
    di, n, h = d["d_inner"], d["n"], d["n_heads"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * n]
    dt = zxbcdt[..., di + di + 2 * n:]
    if dt.shape[-1] != h:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt heads, not {h}")
    return z, xbc, dt


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise cumulative sums:
    out[..., i, j] = sum a[..., j+1..i], -inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return diff.masked_fill(~mask, -torch.inf)


def _chunk_len(s: int) -> int:
    """The largest divisor of ``s`` that is at most ``CHUNK``."""
    return next(c for c in range(min(CHUNK, s), 0, -1) if s % c == 0)


def ssd_forward(p: dict, x: torch.Tensor, cfg, state=None):
    """Full-sequence chunked SSD.  x: (B, S, D) -> (y, final state)."""
    d = ssd_dims(cfg)
    b, s, _ = x.shape
    h, hp, n = d["n_heads"], d["p"], d["n"]
    z, xbc, dt = _split_zxbcdt(x @ p["in_proj"], d)
    conv_in = None if state is None else state["conv"]
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"], conv_in)
    xbc = F.silu(xbc)
    xs = xbc[..., :d["d_inner"]].reshape(b, s, h, hp)
    bm = xbc[..., d["d_inner"]:d["d_inner"] + n]                   # (B, S, N)
    cm = xbc[..., d["d_inner"] + n:]                               # (B, S, N)
    dt = F.softplus(dt.float() + p["dt_bias"].float())             # (B, S, H)
    a = -torch.exp(p["a_log"].float())                             # (H,)

    q = _chunk_len(s)
    nc = s // q
    xs_c = xs.reshape(b, nc, q, h, hp)
    b_c = bm.reshape(b, nc, q, n)
    c_c = cm.reshape(b, nc, q, n)
    dt_c = dt.reshape(b, nc, q, h)
    da_t = (dt_c * a).transpose(2, 3)                              # (B,nc,H,q)
    da_cum = torch.cumsum(da_t, dim=-1)                         # within-chunk

    # intra-chunk (attention-like), float32 decay math
    l_mat = torch.exp(_segsum(da_t))                            # (B,nc,H,q,q)
    scores = (torch.einsum("bcqn,bckn->bcqk", c_c, b_c)[:, :, None].float()
              * l_mat).to(xs.dtype)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", scores,
                           xs_c * dt_c.to(xs.dtype)[..., None])

    # per-chunk end states
    decay_to_end = torch.exp(da_cum[..., -1:] - da_cum)            # (B,nc,H,q)
    chunk_states = torch.einsum("bckn,bckh,bckhp->bchpn", b_c.float(),
                                dt_c * decay_to_end.transpose(2, 3),
                                xs_c.float())

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_cum[..., -1])                       # (B,nc,H)
    carry = (torch.zeros((b, h, hp, n), dtype=torch.float32, device=x.device)
             if state is None else state["ssm"].float())
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                      # (B,nc,H,P,N)

    # inter-chunk output: the decayed prior state read out through C
    state_decay = torch.exp(da_cum).transpose(2, 3)                # (B,nc,q,H)
    y_inter = torch.einsum("bcqn,bchpn,bcqh->bcqhp", c_c.float(),
                           prev_states, state_decay)

    y = (y_intra.float() + y_inter).reshape(b, s, d["d_inner"])
    y = y + (xs * p["d_skip"][None, None, :, None]).reshape(b, s, d["d_inner"])
    y = rms_norm(y.to(x.dtype), p["norm"]) * F.silu(z)
    return y @ p["out_proj"], {"ssm": carry, "conv": conv_state}


def ssd_decode(p: dict, x: torch.Tensor, cfg, state: dict):
    """Single-token recurrent update.  x: (B, 1, D)."""
    d = ssd_dims(cfg)
    b = x.shape[0]
    z, xbc, dt = _split_zxbcdt(x @ p["in_proj"], d)
    xbc, conv_state = causal_conv1d(xbc, p["conv_w"], p["conv_b"],
                                    state["conv"])
    xbc = F.silu(xbc)
    xs = xbc[:, 0, :d["d_inner"]].reshape(b, d["n_heads"], d["p"])
    bm = xbc[:, 0, d["d_inner"]:d["d_inner"] + d["n"]]             # (B, N)
    cm = xbc[:, 0, d["d_inner"] + d["n"]:]
    dt1 = F.softplus(dt[:, 0].float() + p["dt_bias"].float())      # (B, H)
    a = -torch.exp(p["a_log"].float())
    decay = torch.exp(dt1 * a)                                     # (B, H)
    ssm = state["ssm"].float() * decay[..., None, None] + torch.einsum(
        "bn,bh,bhp->bhpn", bm.float(), dt1, xs.float())
    y = torch.einsum("bn,bhpn->bhp", cm.float(), ssm)              # (B, H, P)
    y = y + xs * p["d_skip"][None, :, None]
    y = y.reshape(b, 1, d["d_inner"])
    y = rms_norm(y.to(x.dtype), p["norm"]) * F.silu(z)
    return y @ p["out_proj"], {"ssm": ssm, "conv": conv_state}


def ssd_init_state(cfg, batch: int, device: "torch.device | str") -> dict:
    d = ssd_dims(cfg)
    return {
        "ssm": torch.zeros((batch, d["n_heads"], d["p"], d["n"]),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, d["conv_dim"]),
                            dtype=torch.float32, device=device),
    }
