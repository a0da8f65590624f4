"""Sampled-parity checkwords: oracle-free detection for in-flash ops.

A *checkword* is the vector's bit values at ``n_samples`` deterministic
positions (shared per vector length), stored host-side in
:class:`~repro_torch.flash.ftl.VectorMeta` when the vector is programmed.  Bitwise
ops are positionwise, so evaluating the stored per-leaf samples through the
op DAG predicts the materialized result's samples *exactly* — any
disagreement proves a sense error without consulting the device's debug
oracle.

Everything here is numpy + stdlib only: :mod:`repro_torch.flash.ftl` imports this
module, so it must not pull in :mod:`repro_torch.api` (cycle) or trace anything.

The packed-word extraction mirrors the lane-major layout of
``repro_torch.kernels.ref.pack_bits``: within each ``TILE_COLS``-column tile the
word index is ``tile * LANES + (col % LANES)`` and the bit index is
``col // LANES`` — *not* the naive ``col >> 5`` / ``col & 31`` split.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

# Mirrors repro_torch.kernels.ref — kept literal so this module stays numpy-only
# (tests cross-check against pack_bits).
LANES = 128
WORD_BITS = 32
TILE_COLS = LANES * WORD_BITS  # 4096

DEFAULT_SAMPLES = 1024
_POSITION_SEED = 0x5EED

#: ops evaluable over sampled bits (every op the graph layer can emit).
_INVERTED = {"nand": "and", "nor": "or", "xnor": "xor"}

_position_cache: Dict[tuple, np.ndarray] = {}


def sample_positions(n_bits: int, n_samples: int = DEFAULT_SAMPLES,
                     seed: int = _POSITION_SEED) -> np.ndarray:
    """Deterministic sorted sample positions, shared per (n_bits, n_samples).

    Every vector of the same length samples the *same* positions, so leaf
    checkwords compose positionwise through any op DAG.
    """
    key = (int(n_bits), int(n_samples), int(seed))
    pos = _position_cache.get(key)
    if pos is None:
        rng = np.random.default_rng([seed, n_bits, n_samples])
        k = min(int(n_samples), int(n_bits))
        pos = np.sort(rng.choice(n_bits, size=k, replace=False).astype(np.int64))
        pos.setflags(write=False)
        _position_cache[key] = pos
    return pos


def checkword(bits, positions: np.ndarray) -> np.ndarray:
    """Sample an unpacked {0,1} bit vector at ``positions``."""
    return np.asarray(bits).reshape(-1)[positions].astype(np.uint8)


def words_per_page(page_bits: int) -> int:
    tiles = -(-int(page_bits) // TILE_COLS)
    return tiles * LANES


def sample_packed(packed, positions: np.ndarray, page_bits: int) -> np.ndarray:
    """Sample a packed uint32 result (one or more pages, row-major) at the
    same bit ``positions`` without unpacking the whole vector."""
    w = np.asarray(packed).reshape(-1)
    wpp = words_per_page(page_bits)
    page, c_page = np.divmod(positions, int(page_bits))
    tile, c = np.divmod(c_page, TILE_COLS)
    word = page * wpp + tile * LANES + (c % LANES)
    bit = c // LANES
    return ((w[word] >> bit) & 1).astype(np.uint8)


def expected_samples(node, leaf_samples: Mapping[str, np.ndarray]) -> np.ndarray:
    """Evaluate the op DAG over per-leaf checkwords.

    ``node`` is a :class:`repro_torch.api.graph.Node` (duck-typed here — ``.name``
    for leaves, ``.op``/``.args`` for ops — so this module never imports the
    api package).  Returns the predicted sample bits of the materialized
    result as uint8.
    """
    memo: Dict[int, np.ndarray] = {}
    stack = [node]
    while stack:
        n = stack[-1]
        if id(n) in memo:
            stack.pop()
            continue
        name = getattr(n, "name", None)
        if name is not None:
            memo[id(n)] = np.asarray(leaf_samples[name], dtype=np.uint8)
            stack.pop()
            continue
        pending = [a for a in n.args if id(a) not in memo]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        args = [memo[id(a)] for a in n.args]
        op = n.op
        if op == "not":
            out = (1 - args[0]).astype(np.uint8)
        else:
            base = _INVERTED.get(op, op)
            acc = args[0]
            for a in args[1:]:
                if base == "and":
                    acc = acc & a
                elif base == "or":
                    acc = acc | a
                elif base == "xor":
                    acc = acc ^ a
                else:
                    raise ValueError(f"unsupported op in checkword eval: {op!r}")
            out = ((1 - acc) if op in _INVERTED else acc).astype(np.uint8)
        memo[id(n)] = out
    return memo[id(node)]
