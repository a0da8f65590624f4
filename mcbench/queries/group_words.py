"""One stored group under one op, its packed result words drained to the
host (the paper's bitmap result "ships to the host").

Mix key: ``ops`` (a size choice over ``and``, ``or``, ``xor``).  A block
holds every (group, op) of it once.  Query ``("group_words", group, op)``.
"""
from __future__ import annotations

from mcbench import data, loadgen, roofline
from mcbench.reference import OPS, fold, lane_major_words

KEYS = {"ops"}
RESULT = "words"


def check(mix: dict) -> None:
    bad = set(loadgen.sizes(mix["ops"])) - set(OPS)
    if bad:
        raise ValueError(f"ops {sorted(bad)} are none of {sorted(OPS)}")


def block(mix: dict, cfg: dict, rng) -> list:
    return [("group_words", g, op) for g in range(len(data.groups(cfg)))
            for op in loadgen.sizes(mix["ops"])]


def distinct(mix: dict, cfg: dict) -> list:
    ops = sorted(set(loadgen.sizes(mix["ops"])))
    return [("group_words", g, op) for g in range(len(data.groups(cfg)))
            for op in ops]


def operand_bits(query, cfg: dict) -> int:
    return len(data.groups(cfg)[query[1]]) * int(cfg["users"])


def bytes_needed(query, cfg: dict) -> int:
    """The group's float32 Vth row read once, its result bits written."""
    users = int(cfg["users"])
    return users * roofline.VTH_BYTES + users // 8


def roots(sess, query, cfg: dict) -> list:
    return [sess.chain(query[2], list(data.groups(cfg)[query[1]]))]


def answer(cols: dict, query, cfg: dict) -> list:
    names = data.groups(cfg)[query[1]]
    return [lane_major_words(fold(query[2], [cols[n] for n in names]))]
