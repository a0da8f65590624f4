"""Bit-sliced range scans (BitWeaving/V): ``select count(*) from T where
lo <= v <= hi`` over one code column stored vertically, a bit-slice a
column, most significant first, adjacent slices sharing a wordline.

Mix keys: ``predicates`` (how many fixed ranges), ``selectivity`` (the
share of the code space each covers: ``w = floor(selectivity * 2**b)``
codes) and ``constants_seed`` (each ``lo`` is drawn once, uniform on
``[0, 2**b - w]``, from ``numpy.random.default_rng(constants_seed)``: the
same ranges for every run seed, which only shuffles them).  Query
``("between_count", lo, hi)``: one counted root, ``hi = lo + w - 1``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from mcbench import data, roofline
from mcbench.reference import count

KEYS = {"predicates", "selectivity", "constants_seed"}
RESULT = "count"
#: the columns whose codes were last built, and those codes (one entry:
#: a window asks the same column set every time)
_CODES: Dict[str, object] = {}


def check(mix: dict) -> None:
    n, s, seed = mix["predicates"], mix["selectivity"], mix["constants_seed"]
    if not isinstance(n, int) or n < 1:
        raise ValueError(f"predicates must be a whole number >= 1, got {n!r}")
    if not 0 < float(s) <= 1:
        raise ValueError(f"selectivity must lie in (0, 1], got {s!r}")
    if not isinstance(seed, int):
        raise ValueError(f"constants_seed must be a whole number, got {seed!r}")


def _slices(cfg: dict) -> list:
    """The code's bit-slice columns, most significant first."""
    return [name for name, _ in data.columns(cfg)]


def distinct(mix: dict, cfg: dict) -> list:
    bits = len(_slices(cfg))
    w = max(1, int(float(mix["selectivity"]) * 2 ** bits))
    rng = np.random.default_rng(int(mix["constants_seed"]))
    los = rng.integers(0, 2 ** bits - w, size=int(mix["predicates"]),
                       endpoint=True)
    return list(dict.fromkeys(("between_count", int(lo), int(lo) + w - 1)
                              for lo in los))


def block(mix: dict, cfg: dict, rng) -> list:
    return distinct(mix, cfg)


def operand_bits(query, cfg: dict) -> int:
    return len(_slices(cfg)) * int(cfg["users"])


def bytes_needed(query, cfg: dict) -> int:
    """Each pair's float32 Vth row read once, the 4-byte count written."""
    return len(data.groups(cfg)) * int(cfg["users"]) * roofline.VTH_BYTES \
        + roofline.COUNT_BYTES


def roots(sess, query, cfg: dict) -> list:
    return [sess.between(_slices(cfg), query[1], query[2])]


def _codes(cols: dict, cfg: dict) -> torch.Tensor:
    """Each row's int64 code from its slices' bits, built once per set of
    columns."""
    if _CODES.get("cols") is not cols:
        _CODES.clear()
        v = torch.zeros_like(cols[_slices(cfg)[0]], dtype=torch.int64)
        for name in _slices(cfg):
            v <<= 1
            v |= cols[name].to(torch.int64)
        _CODES.update(cols=cols, codes=v)
    return _CODES["codes"]


def answer(cols: dict, query, cfg: dict) -> list:
    v = _codes(cols, cfg)
    return [count((v >= query[1]) & (v <= query[2]))]
