"""Query kinds: one module per kind, found by the name a mix's ``query``
gives, so a new kind is a new file here and edits none.

A kind module holds:

- ``KEYS``: the mix keys it reads (size and position choices are read
  through :func:`mcbench.loadgen.sizes` and :func:`mcbench.loadgen.position`);
- ``RESULT``: ``"count"`` (each root's bit count comes back) or ``"words"``
  (each root's packed words drain to the host);
- ``check(mix)``: refuse a value it cannot run;
- ``block(mix, cfg, rng)``: one block of queries, which the generator
  shuffles; a query is a hashable tuple whose first item is the kind's name
  and which carries everything its answer depends on;
- ``distinct(mix, cfg)``: every query the mix can draw (the warm-up set);
- ``operand_bits(query, cfg)``: the operand bits it reads (k operands of n
  bits count k * n);
- ``bytes_needed(query, cfg)``: the least bytes it moves through the card's
  memory, counted from shapes, or None where no roofline is read;
- ``roots(sess, query, cfg)``: the program side, its lazy expressions in
  submission order, built through the session's public operators;
- ``answer(cols, query, cfg)``: the reference side, each root's answer from
  the columns' bits in plain PyTorch.

No kind module imports the program.
"""
from __future__ import annotations

import importlib
import re


def kind(name: str):
    """The module of a query kind."""
    if not isinstance(name, str) or not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"query kind {name!r} is not a module name")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"no query kind {name!r}: mcbench/queries/{name}.py "
                         f"does not exist") from None
