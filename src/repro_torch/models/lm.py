"""Config-driven LMs: decoder-only stacks and the whisper-style
encoder-decoder, for training (``forward_loss``) and serving (prefill and
decode).

The JAX package's ``models/lm.py``.  Blocks of kind ``attn``, ``swa``
(sliding window), ``rglru`` and ``ssd``, each with a ``dense``, ``moe``
or no (``none``) MLP.  The layer stack is ``pattern x repeats (+ tail)``:
pattern-block parameters are stacked along a leading "layers" axis (the
JAX package scans over it; here a Python loop indexes it), and caches
mirror the same structure: K/V rings for attention, float32 states
(``h``/``conv``, ``ssm``/``conv``) for the recurrent blocks.  Parameters
are nested dicts of tensors keyed as the JAX package's pytrees
(:func:`repro_torch.models.specs.params_from_jax`).

Unlike the JAX functions, :func:`prefill`, :func:`decode_step` and
:func:`encdec_prefill` write the caches in place (one cache per request
batch saves a copy of it per step) and return the same dicts; a
recurrent block ``copy_``s its new state into its cache.  Sharding
constraints are left out: ``parallel.sharding.constrain`` is the identity
at world size 1.

Two behaviours of the JAX package are kept for parity (ROADMAP R7, R8):
the ``hybrid`` family's ``sqrt(d_model)`` embedding scale is applied in
``forward_loss`` only, not in serving; whisper's ``enc_pos`` parameter is
carried but unread.

A sliding-window ring holds token position ``p`` in slot ``p % window``,
after a prefill as after a decode step (the JAX package's prefill puts a
long prompt's tail in slots ``0..window-1``, ROADMAP R6).

Training: :func:`forward_loss` runs the stack without caches, each
pattern unit (and each encoder-decoder block) rematerialized in the
backward under ``remat`` (``torch.utils.checkpoint``, as the JAX package's
``jax.checkpoint``), the head and its cross-entropy in sequence chunks
(``chunked_softmax_xent``), and ``grad_bf16`` at the JAX package's points
(q, k and v after the rotary embedding, each pattern unit's input, the
loss input, the MoE dispatch buffer).  The forward is unchanged by it.

Entry points:
  build_specs(cfg)                          -> ParamSpec tree
  forward_loss(params, cfg, batch)          -> (loss, {"xent", "aux"})
  prefill(params, cfg, batch, caches)       -> (last-token logits, caches)
  decode_step(params, cfg, tokens, caches, cur_index) -> (logits, caches)
  encdec_prefill(params, cfg, batch, caches) -> caches (encoder-decoder)
  cache_layout(cfg, batch, seq) / init_cache(cfg, batch, seq, device)

The entry points compute in bfloat16, as the JAX package's do; their
``dtype=torch.float32`` (for serving with caches from ``init_cache(...,
dtype=torch.float32)``) runs the same code on the float32 master weights.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssd as ssd_lib
from repro_torch.models.layers import (chunked_softmax_xent, embed_lookup,
                                       embed_specs, grad_bf16, mlp_apply,
                                       mlp_specs, rms_norm, rotary)
from repro_torch.models.specs import ParamSpec, stacked, tree_map

__all__ = ["build_specs", "cast_params", "forward_loss", "prefill",
           "decode_step", "encdec_prefill", "cache_layout", "init_cache",
           "abstract_cache", "apply_unit"]


# --------------------------------------------------------------------------
# Parameter specs
# --------------------------------------------------------------------------

def _attn_specs(cfg: ModelConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, k, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, k, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), init="zeros")
        s["k_norm"] = ParamSpec((hd,), (None,), init="zeros")
    return s


def _block_specs(cfg: ModelConfig, blk: BlockCfg) -> dict:
    s: dict[str, Any] = {"ln1": ParamSpec((cfg.d_model,), (None,),
                                          init="zeros")}
    if blk.kind in ("attn", "swa"):
        s["attn"] = _attn_specs(cfg)
    elif blk.kind == "rglru":
        s["rglru"] = rglru_lib.rglru_specs(cfg)
    elif blk.kind == "ssd":
        s["ssd"] = ssd_lib.ssd_specs(cfg)
    else:
        raise ValueError(blk.kind)
    if blk.mlp == "dense":
        s["ln2"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        s["mlp"] = mlp_specs(cfg.d_model, cfg.d_ff)
    elif blk.mlp == "moe":
        s["ln2"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        s["moe"] = moe_lib.moe_specs(cfg.d_model, cfg.d_ff, cfg.n_experts)
    elif blk.mlp != "none":
        raise ValueError(blk.mlp)
    return s


def build_specs(cfg: ModelConfig) -> dict:
    """Full parameter-spec tree for an arch."""
    if cfg.encdec:
        return _encdec_specs(cfg)
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="zeros"),
    }
    specs["pattern"] = {
        f"b{i}": tree_map(lambda sp: stacked(sp, cfg.repeats),
                          _block_specs(cfg, blk),
                          is_leaf=lambda x: isinstance(x, ParamSpec))
        for i, blk in enumerate(cfg.pattern)}
    specs["tail"] = {f"t{i}": _block_specs(cfg, blk)
                     for i, blk in enumerate(cfg.tail)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    return specs


# --------------------------------------------------------------------------
# Block application (full sequence, prefill and decode)
# --------------------------------------------------------------------------

def _attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, blk: BlockCfg, *,
                positions: torch.Tensor, cache: "dict | None",
                cur_index: "int | None", causal: bool = True) -> torch.Tensor:
    """Attention, with its cache write when there is a cache: a prefill
    (S > 1) fills it, a decode step (S == 1) writes one slot and attends
    the cache.  ``cache=None`` is a plain full-sequence pass."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = grad_bf16(rotary(q, positions, cfg.rope_theta))
    k = grad_bf16(rotary(k, positions, cfg.rope_theta))
    v = grad_bf16(v)
    if cache is None or s > 1:
        if cache is not None:
            _cache_write_prefill(cache, k, v, blk)
        if blk.kind == "swa" and causal:
            o = attn.local_attention(q, k, v, window=blk.window)
        else:
            o = attn.flash_attention(q, k, v, causal=causal)
    else:
        entry_pos = _cache_write_decode(cache, k, v, blk, cur_index)
        o = attn.decode_attention(q, cache["k"], cache["v"],
                                  cur_index=cur_index,
                                  entry_positions=entry_pos)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def _cache_write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         blk: BlockCfg) -> None:
    """The prompt's K/V into the cache, position ``p`` in slot ``p``; a
    sliding window keeps a longer prompt's last ``window`` tokens, position
    ``p`` in slot ``p % window`` (the slot decode reads and overwrites)."""
    kc, vc = cache["k"], cache["v"]
    s = k.shape[2]
    if blk.kind == "swa" and blk.window < s:
        # tail position s - window + j belongs in slot (s + j) % window
        k, v = (torch.roll(t[:, :, -blk.window:], shifts=s % blk.window,
                           dims=2) for t in (k, v))
    n = k.shape[2]
    if n > kc.shape[2]:
        raise ValueError(f"prompt of {n} tokens exceeds the cache's "
                         f"{kc.shape[2]} slots")
    kc[:, :, :n] = k.to(kc.dtype)
    vc[:, :, :n] = v.to(vc.dtype)


def _cache_write_decode(cache: dict, k: torch.Tensor, v: torch.Tensor,
                        blk: BlockCfg, cur_index) -> "torch.Tensor | None":
    """One token's K/V into its slot; returns each slot's token position
    for a sliding-window ring (None: slot == position)."""
    kc, vc = cache["k"], cache["v"]
    window = kc.shape[2]
    entry_pos = None
    slot = cur_index
    if blk.kind == "swa":
        slot = cur_index % window
        # ring-buffer slot positions: p_j = cur - ((cur - j) mod window)
        j = torch.arange(window, device=kc.device)
        entry_pos = cur_index - torch.remainder(cur_index - j, window)
    if isinstance(slot, torch.Tensor):      # a position never read on the host
        kc.index_copy_(2, slot.reshape(1), k.to(kc.dtype))
        vc.index_copy_(2, slot.reshape(1), v.to(vc.dtype))
    else:
        kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
        vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
    return entry_pos


def _state_apply(forward, decode, p: dict, h: torch.Tensor, cfg: ModelConfig,
                 cache: "dict | None") -> torch.Tensor:
    """A recurrent block: a full pass from a zero state, its final state
    copied into ``cache`` when there is one (prefill), or one decode step
    from the cached state, copied back."""
    if cache is None:
        return forward(p, h, cfg)[0]
    if h.shape[1] > 1:
        o, new = forward(p, h, cfg)
    else:
        o, new = decode(p, h, cfg, cache)
    for name, t in new.items():
        cache[name].copy_(t)
    return o


def _apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, blk: BlockCfg,
                 *, positions, cache: "dict | None", cur_index,
                 causal: bool = True):
    """Pre-norm residual block.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if blk.kind in ("attn", "swa"):
        o = _attn_apply(p["attn"], h, cfg, blk, positions=positions,
                        cache=cache, cur_index=cur_index, causal=causal)
    elif blk.kind == "rglru":
        o = _state_apply(rglru_lib.rglru_forward, rglru_lib.rglru_decode,
                         p["rglru"], h, cfg, cache)
    elif blk.kind == "ssd":
        o = _state_apply(ssd_lib.ssd_forward, ssd_lib.ssd_decode, p["ssd"],
                         h, cfg, cache)
    else:
        raise ValueError(blk.kind)
    x = x + o
    if blk.mlp == "dense":
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))
    elif blk.mlp == "moe":
        mo, aux = moe_lib.moe_apply(p["moe"],
                                    rms_norm(x, p["ln2"], cfg.norm_eps),
                                    top_k=cfg.top_k,
                                    capacity_factor=cfg.capacity_factor)
        x = x + mo
    return x, aux


def _index(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked tree (views: writes reach the stack)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def apply_unit(unit_params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions=None, caches: "dict | None" = None,
               cur_index=None):
    """One pattern unit, the blocks of ``cfg.pattern`` in order, with the
    parameters (and caches) of one repeat (``{"b0": ..., "b1": ...}``);
    ``positions`` default to ``0..S-1``.  Returns (x, the summed MoE aux
    loss).  A pipeline stage (``parallel.pipeline``) is one such unit."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, blk in enumerate(cfg.pattern):
        x, a = _apply_block(unit_params[f"b{i}"], x, cfg, blk,
                            positions=positions,
                            cache=None if caches is None
                            else caches[f"b{i}"], cur_index=cur_index)
        aux = aux + a
    return x, aux


def _run_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions, caches: "dict | None", cur_index=None,
               remat: bool = False):
    """The pattern stack ``repeats`` times, then the tail (``caches=None``:
    a plain full-sequence pass).  Returns (x, the blocks' summed MoE aux
    loss).  ``remat`` recomputes each pattern unit in the backward instead
    of keeping its activations."""
    def unit(x, r: int):
        return apply_unit(_index(params["pattern"], r), grad_bf16(x), cfg,
                          positions=positions,
                          caches=(None if caches is None
                                  else _index(caches["pattern"], r)),
                          cur_index=cur_index)

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(cfg.repeats):
        if remat:
            x, aux = checkpoint(unit, x, r, use_reentrant=False)
        else:
            x, aux = unit(x, r)
        total = total + aux
    for i, blk in enumerate(cfg.tail):
        c = None if caches is None else caches["tail"][f"t{i}"]
        x, aux = _apply_block(params["tail"][f"t{i}"], x, cfg, blk,
                              positions=positions, cache=c,
                              cur_index=cur_index)
        total = total + aux
    return x, total


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------

def cast_params(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Mixed precision: f32 master weights -> compute copies (leaves of
    another dtype are kept as they are, uncopied)."""
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32 else p,
                    params)


def forward_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                 remat: bool = True, dtype: torch.dtype = torch.bfloat16):
    """Training loss and its metrics ``{"xent", "aux"}``: the cross-entropy
    of the next token plus 0.01 x the MoE load-balancing loss.

    ``batch`` holds ``tokens`` (B, S) (labels: the tokens shifted left,
    0-padded, unless ``labels`` is given), or ``embeds`` (B, S, D) and
    ``labels`` for an arch with a modality frontend, or ``frames`` and
    ``tokens`` for the encoder-decoder.  Positions whose label is 0 are
    masked out.  As in the JAX package (ROADMAP R7), the ``hybrid``
    family's inputs are scaled by ``sqrt(d_model)`` here, and only here.
    ``dtype`` is the compute dtype of the weights' copies."""
    params = cast_params(params, dtype)
    if cfg.encdec:
        return _encdec_loss(params, cfg, batch, remat=remat)
    if cfg.uses_tokens:
        tokens = batch["tokens"]
        x = embed_lookup(params["embed"], tokens)
        labels = batch.get("labels")
        if labels is None:
            labels = F.pad(tokens[:, 1:], (0, 1))
    else:
        x = batch["embeds"]
        labels = batch["labels"]
    x = x.to(dtype)
    if cfg.family == "hybrid":
        x = x * cfg.d_model ** 0.5
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux = _run_stack(params, x, cfg, positions=positions, caches=None,
                        remat=remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    mask = (labels > 0).float()
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    loss = chunked_softmax_xent(grad_bf16(x), table, labels, mask)
    return loss + 0.01 * aux, {"xent": loss, "aux": aux}


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    return x @ table.T


def prefill(params: dict, cfg: ModelConfig, batch: dict, caches: dict, *,
            dtype: torch.dtype = torch.bfloat16):
    """Run the prompt, ``batch["tokens"]`` (B, S) or, for an arch with a
    modality frontend, ``batch["embeds"]`` (B, S, D); fill ``caches`` and
    return the last position's logits (B, 1, V)."""
    if cfg.encdec:
        raise ValueError("use encdec_prefill for encoder-decoder archs")
    params = cast_params(params, dtype)
    if cfg.uses_tokens:
        x = embed_lookup(params["embed"], batch["tokens"])
    else:
        x = batch["embeds"]
    x = x.to(dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(params, x, cfg, positions=positions, caches=caches)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                caches: dict, cur_index, *,
                dtype: torch.dtype = torch.bfloat16):
    """One serving step at position ``cur_index`` (an int or a 0-d
    tensor): token ids (B, 1), or
    embeds (B, 1, D) -> logits (B, 1, V), the caches updated in place.
    Archs with a modality frontend decode text tokens as ids."""
    params = cast_params(params, dtype)
    cur_index = _index_arg(cur_index)
    if cfg.encdec:
        return _encdec_decode_step(params, cfg, tokens, caches, cur_index)
    if tokens.ndim == 2:
        x = embed_lookup(params["embed"], tokens)
    else:
        x = tokens
    x = x.to(dtype)
    x, _ = _run_stack(params, x, cfg,
                      positions=_decode_positions(cur_index, x.device),
                      caches=caches, cur_index=cur_index)
    return _logits(params, cfg, x), caches


def _index_arg(cur_index):
    """A decode position as an int, or as the 0-d tensor it was given:
    a tensor is never read on the host (an AOT bundle's meta tensors hold
    no values), and slot writes and masks index with it as a tensor."""
    if isinstance(cur_index, torch.Tensor):
        return cur_index.long()
    return int(cur_index)


def _decode_positions(cur_index, device) -> torch.Tensor:
    """The (1,) position tensor of a decode step."""
    if isinstance(cur_index, torch.Tensor):
        return cur_index.reshape(1).to(device)
    return torch.full((1,), cur_index, device=device)


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def _block_cache_shape(cfg: ModelConfig, blk: BlockCfg, batch: int, seq: int,
                       dtype=torch.bfloat16) -> dict:
    if blk.kind in ("attn", "swa"):
        length = min(blk.window, seq) if blk.kind == "swa" else seq
        shape = (batch, cfg.n_kv_heads, length, cfg.head_dim)
        axes = ("batch", "kv_heads", "kv_seq" if blk.kind == "attn" else None,
                None)
        return {"k": (shape, dtype, axes), "v": (shape, dtype, axes)}
    if blk.kind == "rglru":
        return {
            "h": ((batch, cfg.rnn_width), torch.float32, ("batch", "mlp")),
            "conv": ((batch, cfg.conv_width - 1, cfg.rnn_width),
                     torch.float32, ("batch", None, "mlp")),
        }
    if blk.kind == "ssd":
        d = ssd_lib.ssd_dims(cfg)
        return {
            "ssm": ((batch, d["n_heads"], d["p"], d["n"]), torch.float32,
                    ("batch", None, None, None)),
            "conv": ((batch, cfg.conv_width - 1, d["conv_dim"]),
                     torch.float32, ("batch", None, None)),
        }
    raise ValueError(blk.kind)


def cache_layout(cfg: ModelConfig, batch: int, seq: int,
                 dtype: torch.dtype = torch.bfloat16) -> dict:
    """(shape, dtype, logical_axes) tree matching the cache structure; for
    the encoder-decoder, ``seq`` is the encoder's frame count.  K/V rings
    take ``dtype``; recurrent states are float32."""
    if cfg.encdec:
        return _encdec_cache_layout(cfg, batch, seq, dtype)
    pattern = {}
    for i, blk in enumerate(cfg.pattern):
        pattern[f"b{i}"] = {
            name: ((cfg.repeats,) + shape, dt, ("layers",) + axes)
            for name, (shape, dt, axes)
            in _block_cache_shape(cfg, blk, batch, seq, dtype).items()}
    tail = {f"t{i}": _block_cache_shape(cfg, blk, batch, seq, dtype)
            for i, blk in enumerate(cfg.tail)}
    return {"pattern": pattern, "tail": tail}


def _is_layout_leaf(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 and isinstance(t[0], tuple)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: "torch.device | str",
               dtype: torch.dtype = torch.bfloat16) -> dict:
    """Zeroed caches for ``batch`` sequences of up to ``seq`` tokens."""
    return tree_map(lambda t: torch.zeros(t[0], dtype=t[1], device=device),
                    cache_layout(cfg, batch, seq, dtype),
                    is_leaf=_is_layout_leaf)


def abstract_cache(cfg: ModelConfig, batch: int, seq: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The caches of :func:`init_cache` as ``meta`` tensors (AOT bundles):
    shapes and dtypes of :func:`cache_layout`, no storage."""
    return tree_map(lambda t: torch.empty(t[0], dtype=t[1], device="meta"),
                    cache_layout(cfg, batch, seq, dtype),
                    is_leaf=_is_layout_leaf)


# --------------------------------------------------------------------------
# Encoder-decoder (whisper-tiny)
# --------------------------------------------------------------------------

_ENCDEC_BLOCK = BlockCfg("attn", "dense")


def _encdec_specs(cfg: ModelConfig) -> dict:
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        # specified and initialised, but never read (ROADMAP R8)
        "enc_pos": ParamSpec((1, 8192, cfg.d_model), (None, None, "embed"),
                             init="scaled", scale=0.02),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "enc_final_norm": ParamSpec((cfg.d_model,), (None,), init="zeros"),
    }
    specs["encoder"] = {f"e{i}": _block_specs(cfg, _ENCDEC_BLOCK)
                        for i in range(cfg.enc_layers)}
    dec = {}
    for i in range(cfg.repeats):
        d = _block_specs(cfg, _ENCDEC_BLOCK)
        d["cross"] = _attn_specs(cfg)
        d["ln_cross"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        dec[f"d{i}"] = d
    specs["decoder"] = dec
    return specs


def _encdec_encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   remat: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed conv-frontend embeddings (a stub
    frontend) -> encoder output, non-causal self-attention throughout, in
    the dtype of the compute copies ``params``; ``remat`` recomputes each
    block in the backward."""
    x = frames.to(params["embed"].dtype)
    pos = torch.arange(x.shape[1], device=x.device)

    def block(p, x):
        return _apply_block(p, x, cfg, _ENCDEC_BLOCK, positions=pos,
                            cache=None, cur_index=None, causal=False)[0]

    for i in range(cfg.enc_layers):
        p = params["encoder"][f"e{i}"]
        x = (checkpoint(block, p, x, use_reentrant=False) if remat
             else block(p, x))
    return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _cross_attend(p: dict, x: torch.Tensor, cfg: ModelConfig,
                  k: torch.Tensor, v: torch.Tensor, *,
                  decode: bool) -> torch.Tensor:
    """The cross-attention residual: x's queries against the encoder's K/V,
    every frame valid (a decode step attends the cached K/V)."""
    h = rms_norm(x, p["ln_cross"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bhsk", h, p["cross"]["wq"])
    if decode:
        o = attn.decode_attention(q, k, v, cur_index=k.shape[2] - 1)
    else:
        o = attn.flash_attention(q, k, v, causal=False)
    return x + torch.einsum("bhsk,hkd->bsd", o, p["cross"]["wo"])


def _decode_all(params: dict, cfg: ModelConfig, enc_out: torch.Tensor,
                tokens: torch.Tensor, remat: bool = False) -> torch.Tensor:
    """The decoder over whole token sequences (B, S) against ``enc_out``,
    to the final norm; ``remat`` recomputes each block in the backward."""
    x = embed_lookup(params["embed"], tokens)
    pos = torch.arange(x.shape[1], device=x.device)

    def block(p, x, enc_out):
        x, _ = _apply_block(p, x, cfg, _ENCDEC_BLOCK, positions=pos,
                            cache=None, cur_index=None)
        ek = torch.einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wk"])
        ev = torch.einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wv"])
        return _cross_attend(p, x, cfg, ek, ev, decode=False)

    for i in range(cfg.repeats):
        p = params["decoder"][f"d{i}"]
        x = (checkpoint(block, p, x, enc_out, use_reentrant=False) if remat
             else block(p, x, enc_out))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _encdec_forward(params: dict, cfg: ModelConfig, enc_out: torch.Tensor,
                    tokens: torch.Tensor) -> torch.Tensor:
    """The decoder's logits (B, S, V) over whole token sequences against
    ``enc_out``; ``params`` are the compute copies."""
    return _decode_all(params, cfg, enc_out, tokens) @ params["embed"].T


def _encdec_loss(params: dict, cfg: ModelConfig, batch: dict, *,
                 remat: bool = True):
    """The encoder-decoder's training loss over ``batch["frames"]`` and
    ``batch["tokens"]``: the next token's cross-entropy in chunks of
    ``min(448, S)`` (no MoE, so ``aux`` is 0)."""
    enc_out = _encdec_encode(params, cfg, batch["frames"], remat=remat)
    tokens = batch["tokens"]
    x = _decode_all(params, cfg, enc_out, tokens, remat=remat)
    labels = F.pad(tokens[:, 1:], (0, 1))
    mask = (labels > 0).float()
    loss = chunked_softmax_xent(x, params["embed"], labels, mask,
                                chunk=min(448, x.shape[1]))
    return loss, {"xent": loss,
                  "aux": torch.zeros((), dtype=torch.float32,
                                     device=x.device)}


def _encdec_cache_layout(cfg: ModelConfig, batch: int, seq: int,
                         dtype: torch.dtype) -> dict:
    """Decoder caches: self-attention over ``dec_seq`` tokens and the cross
    K/V over ``seq`` frames."""
    self_shape = (batch, cfg.n_kv_heads, cfg.dec_seq, cfg.head_dim)
    cross_shape = (batch, cfg.n_kv_heads, seq, cfg.head_dim)
    axes_self = ("batch", "kv_heads", None, None)
    axes_cross = ("batch", "kv_heads", "kv_seq", None)
    return {
        f"d{i}": {
            "k": (self_shape, dtype, axes_self),
            "v": (self_shape, dtype, axes_self),
            "ck": (cross_shape, dtype, axes_cross),
            "cv": (cross_shape, dtype, axes_cross),
        } for i in range(cfg.repeats)
    }


def encdec_prefill(params: dict, cfg: ModelConfig, batch: dict,
                   caches: dict, *, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Encode ``batch["frames"]`` (B, S_enc, D) and stage each decoder
    layer's cross-attention K/V into ``caches`` (in place)."""
    return _encdec_stage(cast_params(params, dtype), cfg, batch["frames"],
                         caches)


def _encdec_stage(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                  caches: dict) -> dict:
    """``encdec_prefill`` in the dtype of ``params`` (the compute copies)."""
    enc_out = _encdec_encode(params, cfg, frames)
    for i in range(cfg.repeats):
        p, c = params["decoder"][f"d{i}"], caches[f"d{i}"]
        c["ck"].copy_(torch.einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wk"]))
        c["cv"].copy_(torch.einsum("bsd,dhk->bhsk", enc_out, p["cross"]["wv"]))
    return caches


def _encdec_decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                        caches: dict, cur_index):
    x = embed_lookup(params["embed"], tokens)
    pos = _decode_positions(cur_index, x.device)
    for i in range(cfg.repeats):
        p, c = params["decoder"][f"d{i}"], caches[f"d{i}"]
        x, _ = _apply_block(p, x, cfg, _ENCDEC_BLOCK, positions=pos,
                            cache={"k": c["k"], "v": c["v"]},
                            cur_index=cur_index)
        x = _cross_attend(p, x, cfg, c["ck"], c["cv"], decode=True)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T, caches
