"""The Fig-10 image segmentation: every pixel of a batch of frames labelled
by colour class, a class's pixels being the AND of its Y, U and V
channel-match planes, and each class's hit count returned.

A configuration stores ``classes`` wordline groups a batch, batch after
batch and class after class inside a batch: group ``g`` holds the Y, U and
V planes of class ``g % classes`` of batch ``g // classes``, one TLC triple.
No mix key.  Query ``("yuv_segment", batch)``: ``classes`` counted roots in
class order, each a 3-operand AND of one triple.
"""
from __future__ import annotations

from mcbench import data, roofline
from mcbench.reference import count, fold

KEYS: set = set()
RESULT = "count"
#: channel-match planes a class: Y, U and V
PLANES = 3


def check(mix: dict) -> None:
    """No key of its own to check."""


def _triples(cfg: dict) -> list:
    groups, classes = data.groups(cfg), int(cfg["classes"])
    if any(len(g) != PLANES for g in groups) or len(groups) % classes:
        raise ValueError(f"{cfg['name']}: {len(groups)} groups of "
                         f"{cfg['columns_per_wordline']} columns are not "
                         f"batches of {classes} Y, U, V triples")
    return groups


def block(mix: dict, cfg: dict, rng) -> list:
    return distinct(mix, cfg)


def distinct(mix: dict, cfg: dict) -> list:
    n = len(_triples(cfg)) // int(cfg["classes"])
    return [("yuv_segment", b) for b in range(n)]


def _classes(query, cfg: dict) -> list:
    """The (Y, U, V) column names of each class of the query's batch."""
    k = int(cfg["classes"])
    return _triples(cfg)[query[1] * k:(query[1] + 1) * k]


def operand_bits(query, cfg: dict) -> int:
    return PLANES * int(cfg["classes"]) * int(cfg["users"])


def bytes_needed(query, cfg: dict) -> int:
    """Each triple's float32 Vth row read once, each class's count written."""
    return int(cfg["classes"]) * (int(cfg["users"]) * roofline.VTH_BYTES
                                  + roofline.COUNT_BYTES)


def roots(sess, query, cfg: dict) -> list:
    return [sess.chain("and", list(yuv)) for yuv in _classes(query, cfg)]


def answer(cols: dict, query, cfg: dict) -> list:
    return [count(fold("and", [cols[n] for n in yuv]))
            for yuv in _classes(query, cfg)]
