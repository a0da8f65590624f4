"""Ambit's weekly bitmap-index request: for ``w`` weeks back from an end
day, each week is the OR of its 7 daily bitmaps; the request counts the
users active in every week (the AND of the weeks) and, for each week, the
``male`` users active in it: w + 1 counted roots, submitted together.

Mix keys: ``weeks`` (a size choice of ``w``), ``end_day_window`` (the end
day is one of the last that many stored days) and ``end_day`` (a position
choice, rank 0 the newest day).  Query ``("ambit_weekly", w, end_day)``.
"""
from __future__ import annotations

from typing import List

from mcbench import data, loadgen
from mcbench.reference import count, fold

KEYS = {"weeks", "end_day_window", "end_day"}
RESULT = "count"
SPLIT = "male"


def check(mix: dict) -> None:
    loadgen.sizes(mix["weeks"])
    loadgen.check_position(mix["end_day"])
    if int(mix["end_day_window"]) < 1:
        raise ValueError("end_day_window must be 1 or more")


def _ws(mix: dict, cfg: dict) -> list:
    ws = [int(w) for w in loadgen.sizes(mix["weeks"])]
    days, window = int(cfg["days"]), int(mix["end_day_window"])
    if min(ws) < 1 or days - window + 1 < 7 * max(ws):
        raise ValueError(f"{days} stored days cannot look back {max(ws)} "
                         f"weeks from the last {window}")
    if SPLIT not in dict(data.columns(cfg)):
        raise ValueError(f"{cfg['name']} stores no {SPLIT!r} column")
    return ws


def block(mix: dict, cfg: dict, rng) -> list:
    last = int(cfg["days"]) - 1
    window = int(mix["end_day_window"])
    return [("ambit_weekly", w,
             last - loadgen.position(rng, window, mix["end_day"]))
            for w in _ws(mix, cfg)]


def distinct(mix: dict, cfg: dict) -> list:
    days, window = int(cfg["days"]), int(mix["end_day_window"])
    return [("ambit_weekly", w, e) for w in sorted(set(_ws(mix, cfg)))
            for e in range(days - window, days)]


def weeks(w: int, end_day: int) -> List[List[int]]:
    """The days of each of the ``w`` weeks that end at ``end_day``, newest
    week first."""
    return [list(range(end_day - 7 * (j + 1) + 1, end_day - 7 * j + 1))
            for j in range(w)]


def operand_bits(query, cfg: dict) -> int:
    return (7 * query[1] + 1) * int(cfg["users"])


def bytes_needed(query, cfg: dict) -> None:
    return None


def roots(sess, query, cfg: dict) -> list:
    wks = [sess.chain("or", [f"day{d}" for d in days])
           for days in weeks(query[1], query[2])]
    return [sess.chain("and", wks)] + [sess[SPLIT] & wk for wk in wks]


def answer(cols: dict, query, cfg: dict) -> list:
    wks = [fold("or", [cols[f"day{d}"] for d in days])
           for days in weeks(query[1], query[2])]
    return [count(fold("and", wks))] + [count(cols[SPLIT] & wk) for wk in wks]
