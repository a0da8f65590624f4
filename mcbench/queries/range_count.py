"""The Fig-10 cohort query: a fold (``op``) over ``k`` consecutive stored
groups, its bit count returned.

Mix keys: ``op`` (``and``, ``or`` or ``xor``), ``groups_per_query`` (a size
choice of ``k``) and ``start_group`` (a position choice of the first group,
rank 0 the first stored group).  Query ``("range_count", op, start, k)``.
"""
from __future__ import annotations

from mcbench import data, loadgen, roofline
from mcbench.reference import OPS, count, fold

KEYS = {"op", "groups_per_query", "start_group"}
RESULT = "count"


def check(mix: dict) -> None:
    if mix["op"] not in OPS:
        raise ValueError(f"op {mix['op']!r} is none of {sorted(OPS)}")
    loadgen.sizes(mix["groups_per_query"])
    loadgen.check_position(mix["start_group"])


def _ks(mix: dict, cfg: dict) -> list:
    n = len(data.groups(cfg))
    ks = loadgen.sizes(mix["groups_per_query"])
    if not all(1 <= int(k) <= n for k in ks):
        raise ValueError(f"groups_per_query {sorted(set(ks))} on {n} groups")
    return [int(k) for k in ks]


def block(mix: dict, cfg: dict, rng) -> list:
    n = len(data.groups(cfg))
    return [("range_count", mix["op"],
             loadgen.position(rng, n - k + 1, mix["start_group"]), k)
            for k in _ks(mix, cfg)]


def distinct(mix: dict, cfg: dict) -> list:
    n = len(data.groups(cfg))
    return [("range_count", mix["op"], s, k) for k in sorted(set(_ks(mix, cfg)))
            for s in range(n - k + 1)]


def _names(query, cfg: dict) -> list:
    _, _, start, k = query
    return [c for g in data.groups(cfg)[start:start + k] for c in g]


def operand_bits(query, cfg: dict) -> int:
    return len(_names(query, cfg)) * int(cfg["users"])


def bytes_needed(query, cfg: dict) -> int:
    """Each group's float32 Vth row read once, the 4-byte count written."""
    return query[3] * int(cfg["users"]) * roofline.VTH_BYTES \
        + roofline.COUNT_BYTES


def roots(sess, query, cfg: dict) -> list:
    return [sess.chain(query[1], _names(query, cfg))]


def answer(cols: dict, query, cfg: dict) -> list:
    return [count(fold(query[1], [cols[n] for n in _names(query, cfg)]))]
