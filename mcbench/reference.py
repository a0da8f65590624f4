"""The plain reference: the logical answer of every query, from the seeded
bits alone.

It makes the bits again from the seed (:mod:`mcbench.data`, the same draws
the program was given), computes each query's AND / OR / XOR and counts in
plain PyTorch (its kind's ``answer`` in ``queries/``, with the helpers
here), and packs words into the program's lane-major layout itself:
word ``w`` of each 4096-bit tile holds bit ``k`` from column ``k * 128 + w``.
It imports nothing of the program and reads nothing the program made.
"""
from __future__ import annotations

from typing import Dict, List, Union

import torch

from mcbench import data, queries

#: bits of one packed tile of the lane-major layout (32 x 128)
TILE_BITS = 4096
OPS = ("and", "or", "xor")


def column_bits(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every stored column's (users,) uint8 bits, drawn again from the seed."""
    cols: Dict[str, torch.Tensor] = {}
    for _, names, bits in data.group_bits(cfg, seed, device):
        cols.update(zip(names, bits))
    return cols


def lane_major_words(bits: torch.Tensor) -> torch.Tensor:
    """(n,) {0, 1} bits, n a multiple of 4096 -> (n / 32,) int32 words."""
    if bits.numel() % TILE_BITS:
        raise ValueError(f"{bits.numel()} bits are not whole 4096-bit tiles")
    tiles = bits.reshape(-1, 32, 128)
    words = torch.zeros(tiles.shape[0], 128, dtype=torch.int64,
                        device=bits.device)
    for k in range(32):
        words |= tiles[:, k, :].to(torch.int64) << k   # in [0, 2**32)
    words -= (words >= 2 ** 31).to(torch.int64) << 32
    return words.to(torch.int32).reshape(-1)


def count(bits: torch.Tensor) -> int:
    return int(bits.sum(dtype=torch.int64))


def fold(op: str, vecs: List[torch.Tensor]) -> torch.Tensor:
    out = vecs[0].clone()
    for v in vecs[1:]:
        if op == "and":
            out &= v
        elif op == "or":
            out |= v
        elif op == "xor":
            out ^= v
        else:
            raise ValueError(op)
    return out


class Reference:
    """Answers of one configuration's queries on one seed, memoized per
    query (a window repeats its distinct queries many times)."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = cfg
        self.cols = column_bits(cfg, seed, device)
        self._memo: Dict[tuple, list] = {}

    def answer(self, query) -> List[Union[int, torch.Tensor]]:
        """Each root's answer, in submission order: a count, or the packed
        int32 words (the query kind's ``answer``)."""
        if query not in self._memo:
            self._memo[query] = queries.kind(query[0]).answer(
                self.cols, query, self.cfg)
        return self._memo[query]
