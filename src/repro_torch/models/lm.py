"""Config-driven decoder-only LM: the attention stacks, prefill and decode.

The JAX package's ``models/lm.py`` for blocks of kind ``attn`` and ``swa``
with a dense MLP.  The layer stack is ``pattern x repeats (+ tail)``:
pattern-block parameters are stacked along a leading "layers" axis (the
JAX package scans over it; here a Python loop indexes it), and caches
mirror the same structure.  Parameters are nested dicts of tensors keyed
as the JAX package's pytrees (:func:`repro_torch.models.specs.params_from_jax`).

Unlike the JAX functions, :func:`prefill` and :func:`decode_step` write
the caches in place (one cache per request batch saves a copy of it per
step) and return the same dicts.  Sharding constraints (``constrain``) are
identities at world size 1 and are left out until ``parallel/`` is ported.

Not ported yet (ROADMAP queue 1 item 7): ``moe``, ``rglru`` and ``ssd``
blocks, MLPs other than dense, the encoder-decoder, modality frontends
and ``forward_loss`` (training); each raises ``NotImplementedError``.

Entry points:
  build_specs(cfg)                          -> ParamSpec tree
  prefill(params, cfg, batch, caches)       -> (last-token logits, caches)
  decode_step(params, cfg, tokens, caches, cur_index) -> (logits, caches)
  cache_layout(cfg, batch, seq) / init_cache(cfg, batch, seq, device)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import BlockCfg, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (embed_lookup, embed_specs, mlp_apply,
                                       mlp_specs, rms_norm, rotary)
from repro_torch.models.specs import ParamSpec, stacked, tree_map

__all__ = ["build_specs", "cast_params", "prefill", "decode_step",
           "cache_layout", "init_cache"]

_NOT_PORTED = "is not ported yet (ROADMAP queue 1 item 7)"


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for what the port does not run yet."""
    if cfg.encdec:
        raise NotImplementedError(f"the encoder-decoder ({cfg.name}) "
                                  + _NOT_PORTED)
    if not cfg.uses_tokens:
        raise NotImplementedError(f"the {cfg.frontend} frontend ({cfg.name}) "
                                  + _NOT_PORTED)
    for blk in cfg.pattern + cfg.tail:
        if blk.kind not in ("attn", "swa"):
            raise NotImplementedError(f"{blk.kind!r} blocks ({cfg.name}) "
                                      + _NOT_PORTED)
        if blk.mlp != "dense":
            raise NotImplementedError(f"the {blk.mlp!r} MLP ({cfg.name}) "
                                      + _NOT_PORTED)


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


def _block_specs(cfg: ModelConfig) -> dict:
    return {"ln1": ParamSpec((cfg.d_model,), (None,), init="zeros"),
            "attn": _attn_specs(cfg),
            "ln2": ParamSpec((cfg.d_model,), (None,), init="zeros"),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff)}


def build_specs(cfg: ModelConfig) -> dict:
    """Full parameter-spec tree for an arch."""
    _check_ported(cfg)
    specs: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab, cfg.d_model),
        "final_norm": ParamSpec((cfg.d_model,), (None,), init="zeros"),
    }
    specs["pattern"] = {
        f"b{i}": tree_map(lambda sp: stacked(sp, cfg.repeats),
                          _block_specs(cfg),
                          is_leaf=lambda x: isinstance(x, ParamSpec))
        for i in range(len(cfg.pattern))}
    specs["tail"] = {f"t{i}": _block_specs(cfg) for i in range(len(cfg.tail))}
    if not cfg.tie_embeddings:
        specs["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab),
                                     ("embed", "vocab"))
    return specs


# --------------------------------------------------------------------------
# Block application (prefill and decode)
# --------------------------------------------------------------------------

def _attn_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, blk: BlockCfg, *,
                positions: torch.Tensor, cache: dict,
                cur_index: "int | None") -> torch.Tensor:
    """Attention with its cache write: a prefill (S > 1) fills the cache,
    a decode step (S == 1) writes one slot and attends the cache."""
    s = x.shape[1]
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    if s > 1:
        _cache_write_prefill(cache, k, v, blk)
        if blk.kind == "swa":
            o = attn.local_attention(q, k, v, window=blk.window)
        else:
            o = attn.flash_attention(q, k, v, causal=True)
    else:
        entry_pos = _cache_write_decode(cache, k, v, blk, cur_index)
        o = attn.decode_attention(q, cache["k"], cache["v"],
                                  cur_index=cur_index,
                                  entry_positions=entry_pos)
    return torch.einsum("bhsk,hkd->bsd", o, p["wo"])


def _cache_write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         blk: BlockCfg) -> None:
    """The prompt's K/V into the first slots (a sliding window keeps its
    last ``window`` tokens, as the JAX package does)."""
    kc, vc = cache["k"], cache["v"]
    if blk.kind == "swa" and blk.window < k.shape[2]:
        k, v = k[:, :, -blk.window:], v[:, :, -blk.window:]
    n = k.shape[2]
    if n > kc.shape[2]:
        raise ValueError(f"prompt of {n} tokens exceeds the cache's "
                         f"{kc.shape[2]} slots")
    kc[:, :, :n] = k.to(kc.dtype)
    vc[:, :, :n] = v.to(vc.dtype)


def _cache_write_decode(cache: dict, k: torch.Tensor, v: torch.Tensor,
                        blk: BlockCfg, cur_index: int) -> "torch.Tensor | None":
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
    kc[:, :, slot] = k[:, :, 0].to(kc.dtype)
    vc[:, :, slot] = v[:, :, 0].to(vc.dtype)
    return entry_pos


def _apply_block(p: dict, x: torch.Tensor, cfg: ModelConfig, blk: BlockCfg,
                 *, positions, cache: dict, cur_index) -> torch.Tensor:
    """Pre-norm residual block."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    x = x + _attn_apply(p["attn"], h, cfg, blk, positions=positions,
                        cache=cache, cur_index=cur_index)
    return x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"], cfg.norm_eps))


def _index(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked tree (views: writes reach the stack)."""
    return {k: _index(v, r) if isinstance(v, dict) else v[r]
            for k, v in tree.items()}


def _run_stack(params: dict, x: torch.Tensor, cfg: ModelConfig, *,
               positions, caches: dict, cur_index=None) -> torch.Tensor:
    """The pattern stack ``repeats`` times, then the tail."""
    for r in range(cfg.repeats):
        for i, blk in enumerate(cfg.pattern):
            x = _apply_block(_index(params["pattern"][f"b{i}"], r), x, cfg,
                             blk, positions=positions,
                             cache=_index(caches["pattern"][f"b{i}"], r),
                             cur_index=cur_index)
    for i, blk in enumerate(cfg.tail):
        x = _apply_block(params["tail"][f"t{i}"], x, cfg, blk,
                         positions=positions, cache=caches["tail"][f"t{i}"],
                         cur_index=cur_index)
    return x


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------

def cast_params(params: dict, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Mixed precision: f32 master weights -> compute copies (leaves of
    another dtype are kept as they are, uncopied)."""
    return tree_map(lambda p: p.to(dtype) if p.dtype == torch.float32 else p,
                    params)


def _logits(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"].T
    return x @ table.T


def prefill(params: dict, cfg: ModelConfig, batch: dict, caches: dict):
    """Run the prompt ``batch["tokens"]`` (B, S), fill ``caches`` and
    return the last token's logits (B, 1, V)."""
    _check_ported(cfg)
    params = cast_params(params)
    x = embed_lookup(params["embed"], batch["tokens"]).to(torch.bfloat16)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_stack(params, x, cfg, positions=positions, caches=caches)
    return _logits(params, cfg, x[:, -1:]), caches


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                caches: dict, cur_index: int):
    """One serving step: tokens (B, 1) at position ``cur_index`` -> logits
    (B, 1, V), the caches updated in place."""
    _check_ported(cfg)
    params = cast_params(params)
    x = embed_lookup(params["embed"], tokens).to(torch.bfloat16)
    positions = torch.full((1,), int(cur_index), device=x.device)
    x = _run_stack(params, x, cfg, positions=positions, caches=caches,
                   cur_index=int(cur_index))
    return _logits(params, cfg, x), caches


# --------------------------------------------------------------------------
# Caches
# --------------------------------------------------------------------------

def _block_cache_shape(cfg: ModelConfig, blk: BlockCfg, batch: int, seq: int,
                       dtype=torch.bfloat16) -> dict:
    length = min(blk.window, seq) if blk.kind == "swa" else seq
    shape = (batch, cfg.n_kv_heads, length, cfg.head_dim)
    axes = ("batch", "kv_heads", "kv_seq" if blk.kind == "attn" else None, None)
    return {"k": (shape, dtype, axes), "v": (shape, dtype, axes)}


def cache_layout(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """(shape, dtype, logical_axes) tree matching the cache structure."""
    _check_ported(cfg)
    pattern = {}
    for i, blk in enumerate(cfg.pattern):
        pattern[f"b{i}"] = {
            name: ((cfg.repeats,) + shape, dtype, ("layers",) + axes)
            for name, (shape, dtype, axes)
            in _block_cache_shape(cfg, blk, batch, seq).items()}
    tail = {f"t{i}": _block_cache_shape(cfg, blk, batch, seq)
            for i, blk in enumerate(cfg.tail)}
    return {"pattern": pattern, "tail": tail}


def _is_layout_leaf(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 and isinstance(t[0], tuple)


def init_cache(cfg: ModelConfig, batch: int, seq: int,
               device: "torch.device | str") -> dict:
    """Zeroed caches for ``batch`` sequences of up to ``seq`` tokens."""
    return tree_map(lambda t: torch.zeros(t[0], dtype=t[1], device=device),
                    cache_layout(cfg, batch, seq), is_leaf=_is_layout_leaf)
