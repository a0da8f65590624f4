"""Attention: GQA blockwise (online softmax), sliding window, and decode.

The JAX package's plain attention functions (``models/attention.py``; it
has no attention kernel), as plain PyTorch on the same blocks.  Scores
whose JAX einsum asks for float32 (``preferred_element_type``) are taken
from float32 copies of the operands here, which is exact for bfloat16
inputs; ``decode_attention`` keeps the operands' dtype, as the JAX
function does.

- ``flash_attention``: online-softmax loop over KV blocks.
- ``local_attention``: banded two-chunk form, exact for window <= chunk,
  and a q-chunk loop for windows of 2048 and more.
- ``decode_attention``: one query token against a KV cache, ring buffers
  included (``entry_positions``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["NEG_INF", "flash_attention", "local_attention",
           "decode_attention"]

NEG_INF = -2.0e38


def _group(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, G, S, D)."""
    b, hq, s, d = q.shape
    return q.reshape(b, n_kv, hq // n_kv, s, d)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Blockwise attention.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).
    ``q_offset`` positions the queries within the kv sequence."""
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    block = min(block, skv)
    if skv % block:
        raise ValueError(f"kv length {skv} is not a multiple of {block}")
    qg = (_group(q, hkv) * (d ** -0.5)).float()             # (B, Hkv, G, Sq, D)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    o = torch.zeros((b, hkv, hq // hkv, sq, d), dtype=torch.float32,
                    device=q.device)
    m = torch.full((b, hkv, hq // hkv, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for start in range(0, skv, block):
        kb = k[:, :, start:start + block]
        vb = v[:, :, start:start + block]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kb.float())
        if causal:
            kv_pos = start + torch.arange(block, device=q.device)
            mask = q_pos[:, None] >= kv_pos[None, :]         # (Sq, block)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bhkd->bhgqd", p.to(vb.dtype).float(),
                          vb.float())
        o = o * alpha[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-37)
    return out.reshape(b, hq, sq, d).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int) -> torch.Tensor:
    """Sliding-window causal attention, exact, O(S * 2W).

    Small windows use the banded two-chunk form; windows of 2048 and more
    a loop over query chunks (the banded form would hold (S, 2W) scores).
    """
    if window >= 2048 and q.shape[2] > window:
        return _local_attention_scanned(q, k, v, window=window)
    b, hq, s, d = q.shape
    _, hkv, _, _ = k.shape
    w = min(window, s)
    if s % w:
        raise ValueError(f"sequence {s} is not a multiple of the window {w}")
    n = s // w
    qg = (_group(q, hkv).reshape(b, hkv, hq // hkv, n, w, d)
          * (d ** -0.5)).float()

    def chunk2(x):                                           # prev ++ cur chunks
        xc = x.reshape(b, hkv, n, w, d)
        prev = F.pad(xc[:, :, :-1], (0, 0, 0, 0, 1, 0))
        return torch.cat([prev, xc], dim=3)                  # (B, Hkv, n, 2w, D)

    k2, v2 = chunk2(k), chunk2(v)
    s_ = torch.einsum("bhgnqd,bhnkd->bhgnqk", qg, k2.float())
    qpos = torch.arange(w, device=q.device)[:, None] + w     # within 2w frame
    kpos = torch.arange(2 * w, device=q.device)[None, :]
    band = (qpos >= kpos) & (qpos - kpos < w)                # causal, in window
    first = torch.arange(n, device=q.device) == 0            # no prev chunk
    valid = band[None, :, :] & ~(first[:, None, None] & (kpos < w))
    s_ = torch.where(valid, s_, NEG_INF)
    p = torch.softmax(s_, dim=-1)
    out = torch.einsum("bhgnqk,bhnkd->bhgnqd", p.to(v2.dtype), v2)
    return out.reshape(b, hq, s, d).to(q.dtype)


def _local_attention_scanned(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             q_chunk: int = 512) -> torch.Tensor:
    """Sliding-window attention as a loop over query chunks: each chunk of
    C tokens attends the (W + C)-token KV span ending at its last token,
    one softmax per chunk."""
    b, hq, s, d = q.shape
    _, hkv, _, _ = k.shape
    c = min(q_chunk, s)
    if s % c:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {c}")
    qg = (_group(q, hkv) * (d ** -0.5)).float()              # (B,Hkv,G,S,D)
    span = window + c
    kp = F.pad(k, (0, 0, window, 0))                         # front halo
    vp = F.pad(v, (0, 0, window, 0))
    chunks = []
    for i in range(s // c):
        q_i = qg[:, :, :, i * c:(i + 1) * c]
        k_i = kp[:, :, i * c:i * c + span]
        v_i = vp[:, :, i * c:i * c + span]
        s_ = torch.einsum("bhgqd,bhkd->bhgqk", q_i, k_i.float())
        qpos = i * c + torch.arange(c, device=q.device)[:, None]
        kpos = i * c + torch.arange(span, device=q.device)[None, :] - window
        valid = (qpos >= kpos) & (qpos - kpos < window) & (kpos >= 0)
        s_ = torch.where(valid, s_, NEG_INF)
        p = torch.softmax(s_, dim=-1)
        chunks.append(torch.einsum("bhgqk,bhkd->bhgqd", p.to(v_i.dtype), v_i))
    out = torch.cat(chunks, dim=3)                           # (B,Hkv,G,S,D)
    return out.reshape(b, hq, s, d).to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, cur_index: int,
                     entry_positions: "torch.Tensor | None" = None
                     ) -> torch.Tensor:
    """One-token attention.  q: (B, Hq, 1, D); caches: (B, Hkv, S, D).

    ``entry_positions`` gives each cache slot's absolute token position
    (ring buffers); by default slot == position.  Slots whose position is
    past ``cur_index`` (unwritten) are masked, and so are a ring's slots
    not written yet, whose positions come out negative.  The JAX function
    masks only the former, so until its ring fills it attends those zero
    slots and its decode disagrees with a prefill over the same prefix
    (ROADMAP R5); once the ring is full the two functions agree.
    """
    b, hq, _, d = q.shape
    _, hkv, s, _ = k_cache.shape
    qg = _group(q, hkv)[:, :, :, 0] * (d ** -0.5)            # (B, Hkv, G, D)
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache).float()
    pos = (entry_positions if entry_positions is not None
           else torch.arange(s, device=q.device))
    valid = (pos <= cur_index) & (pos >= 0)
    scores = torch.where(valid, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, 1, d).to(q.dtype)
