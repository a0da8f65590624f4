"""Mixture-of-Experts layer: top-k routing with capacity-bounded dispatch.

The JAX package's ``models/moe.py`` as plain PyTorch at world size 1 (its
sharding constraints and ``_cap_axis`` are identities there and are left
out).  Dispatch is index-scatter + payload-gather: each (token, expert)
assignment takes the next free slot of its expert's ``cap`` slots, in the
flattened (N * k) order; an assignment past the capacity goes to the drop
bin ``E * cap``, which is sliced away.  Batches of more than
``MAX_DISPATCH_TOKENS`` tokens (a multiple of it) run in token chunks.

Ties among the router's probabilities go to the lower expert index, as
``jax.lax.top_k`` breaks them: a stable descending sort, first k.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import grad_bf16
from repro_torch.models.specs import ParamSpec

__all__ = ["MAX_DISPATCH_TOKENS", "moe_specs", "moe_apply", "route"]

MAX_DISPATCH_TOKENS = 65536


def moe_specs(d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": ParamSpec((d_model, n_experts), ("embed", None)),
        "w_gate": ParamSpec((n_experts, d_model, d_ff),
                            ("experts", "embed", "mlp")),
        "w_up": ParamSpec((n_experts, d_model, d_ff),
                          ("experts", "embed", "mlp")),
        "w_down": ParamSpec((n_experts, d_ff, d_model),
                            ("experts", "mlp", "embed")),
    }


def moe_apply(p: dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25):
    """x: (B, S, D) -> (out, aux_loss), the load-balancing loss included."""
    b, s, d = x.shape
    n_total = b * s
    xt = x.reshape(n_total, d)
    if n_total > MAX_DISPATCH_TOKENS and n_total % MAX_DISPATCH_TOKENS == 0:
        chunks = n_total // MAX_DISPATCH_TOKENS
        outs, aux = [], torch.zeros((), dtype=torch.float32, device=x.device)
        for xch in xt.split(MAX_DISPATCH_TOKENS):
            out, a = _moe_tokens(p, xch, top_k=top_k,
                                 capacity_factor=capacity_factor)
            outs.append(out)
            aux = aux + a
        return torch.cat(outs).reshape(b, s, d), aux / chunks
    out, aux = _moe_tokens(p, xt, top_k=top_k, capacity_factor=capacity_factor)
    return out.reshape(b, s, d), aux


def route(p: dict, xt: torch.Tensor, *, top_k: int, capacity_factor: float):
    """The routing of one token chunk xt (N, D): ``(gates (N, k) float32,
    idx (N, k) expert ids, dest (N * k,) slot or the drop bin E * cap,
    cap, aux)``."""
    n = xt.shape[0]
    e = p["router"].shape[-1]
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)      # (N, E)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = order.values[:, :top_k], order.indices[:, :top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style): E * <f_e, p_e>
    me = probs.mean(dim=0)
    fe = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(fe * me)

    # capacity-bounded positions: rank of each assignment within its expert
    cap = max(int(capacity_factor * n * top_k / e), top_k)
    eid = idx.reshape(-1)                                          # (N*k,)
    pos = torch.cumsum(F.one_hot(eid, e), dim=0) - 1
    pos = pos.gather(1, eid[:, None])[:, 0]
    dest = torch.where(pos < cap, eid * cap + pos, e * cap)
    return gates, idx, dest, cap, aux


def _moe_tokens(p: dict, xt: torch.Tensor, *, top_k: int,
                capacity_factor: float):
    """Dispatch, compute and combine for one token chunk.  xt: (N, D)."""
    n, d = xt.shape
    e = p["router"].shape[-1]
    gates, _, dest, cap, aux = route(p, xt, top_k=top_k,
                                     capacity_factor=capacity_factor)

    # dispatch: scatter token indices, gather the payload (kept destinations
    # are unique; the drop bin takes duplicate writes and is sliced away)
    slot_src = torch.zeros(e * cap + 1, dtype=torch.long, device=xt.device)
    slot_src[dest] = torch.arange(n * top_k, device=xt.device) // top_k
    slot_fill = torch.zeros(e * cap + 1, dtype=xt.dtype, device=xt.device)
    slot_fill[dest] = 1
    buf = grad_bf16(xt[slot_src[:e * cap]] * slot_fill[:e * cap, None])
    buf = buf.reshape(e, cap, d)

    h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_down"])                               # (E, cap, D)

    # combine: gather back by destination slot, weight by gates, sum over k
    kept = (dest < e * cap)[:, None].to(xt.dtype)
    out_flat = y.reshape(e * cap, d)[torch.clamp(dest, max=e * cap - 1)] * kept
    out = (out_flat.reshape(n, top_k, d)
           * gates[..., None].to(xt.dtype)).sum(dim=1)
    return out, aux
