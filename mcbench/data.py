"""Seeded bitmaps of a configuration, made on the device in a few large calls.

Both sides take their bits from here: the harness hands them to the program
through ``ComputeSession.write_pair`` (or ``write_triple``), and the
reference makes them again from the same seed once the window has closed.
The draw order is fixed: one ``torch.rand((width, users))`` per group, in
group order.

A configuration's columns are its ``days`` daily bitmaps (``day0``, ...)
then its ``extra_columns``; every ``columns_per_wordline`` consecutive
columns share a wordline (a group), and group ``i`` lives on die ``i``.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import torch

#: seeds are taken modulo this, so any whole number (the driver's are large)
#: is a valid torch seed
SEED_MOD = 2 ** 63
#: columns a wordline can hold together, by what the session can write
WIDTHS = (2, 3)


def columns(cfg: dict) -> List[Tuple[str, float]]:
    """(name, probability a bit is set) of every stored column, in order."""
    cols = [(f"day{d}", float(cfg["p_active"])) for d in range(cfg["days"])]
    cols += [(c["name"], float(c["p_set"])) for c in cfg["extra_columns"]]
    return cols


def groups(cfg: dict) -> List[Tuple[str, ...]]:
    """The columns of each wordline group, in order."""
    width = int(cfg["columns_per_wordline"])
    if width not in WIDTHS:
        raise ValueError(f"{cfg['name']}: columns_per_wordline {width} is "
                         f"none of {WIDTHS}")
    cols = [name for name, _ in columns(cfg)]
    if len(cols) % width:
        raise ValueError(f"{cfg['name']}: {len(cols)} columns do not make "
                         f"groups of {width}")
    return [tuple(cols[i:i + width]) for i in range(0, len(cols), width)]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % SEED_MOD)
    return gen


def group_bits(cfg: dict, seed: int, device
               ) -> Iterator[Tuple[int, Tuple[str, ...], torch.Tensor]]:
    """Yield ``(i, names, bits)`` per group, ``bits`` a (width, users)
    uint8 tensor of {0, 1} on ``device``."""
    gen = generator(seed, device)
    probs = dict(columns(cfg))
    users = int(cfg["users"])
    for i, names in enumerate(groups(cfg)):
        p = torch.tensor([[probs[n]] for n in names], device=device)
        yield i, names, (torch.rand((len(names), users), generator=gen,
                                    device=device) < p).to(torch.uint8)
