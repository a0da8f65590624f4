"""Plain PyTorch versions of every kernel in this package.

They are the ``sim`` backend, the oracle the CUDA kernels are held against,
and what each kernel wrapper runs when its input lies on the CPU.

Bit-packing convention (lane-major, the JAX package's layout bit for bit):
  A tile of ``TILE_COLS = 4096`` cells packs into 128 32-bit words.  Word
  ``w`` of a tile holds bit ``k`` from cell column ``k*128 + w``.  Packed
  words are held as ``torch.int32`` (the same bits as the reference's
  ``uint32``) and viewed as ``uint32`` only at the numpy boundary.

Two int32 hazards the code below avoids: ``>>`` on int32 is an arithmetic
shift, and ``torch.sum`` on int32 returns int64 unless told otherwise.
Unpacking masks each shifted word with ``& 1``, so sign fill never reaches
bit 0; the SWAR popcount runs on the words zero-extended to int64, which is
exact uint32 arithmetic.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

LANES = 128
WORD_BITS = 32
TILE_COLS = LANES * WORD_BITS  # 4096 cells -> 128 words
#: widest reference stack any read plan may carry (TLC XOR3 needs 7)
MAX_REFS = 8
OPS = ("and", "or", "xor")

Refs = Union[Sequence[float], torch.Tensor]


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int32, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(R, C) {0,1} -> (R, C // 32) int32 words, lane-major in 4096-col tiles."""
    r, c = bits.shape
    if c % TILE_COLS:
        raise ValueError(f"cols {c} must be a multiple of {TILE_COLS}")
    tiles = c // TILE_COLS
    b = bits.to(torch.int32).reshape(r, tiles, WORD_BITS, LANES)
    # the terms hold disjoint bits, so their int32 sum is their OR and no
    # partial sum overflows (bit 31 enters as -2**31)
    words = (b << _shifts(bits.device)[None, None, :, None]).sum(
        dim=2, dtype=torch.int32)
    return words.reshape(r, tiles * LANES)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (R, W) int32 -> (R, W * 32) uint8."""
    r, w = words.shape
    if w % LANES:
        raise ValueError(f"words {w} must be a multiple of {LANES}")
    tiles = w // LANES
    x = words.reshape(r, tiles, 1, LANES)
    bits = (x >> _shifts(words.device)[None, None, :, None]) & 1
    return bits.reshape(r, tiles * TILE_COLS).to(torch.uint8)


def sense_bits(vth: torch.Tensor, refs: Refs, kind: str,
               invert: bool = False, n_refs: int | None = None) -> torch.Tensor:
    """Per-cell boolean result of one read kind (see :func:`mlc_sense`)."""
    # float32 references: the kernels' compare type
    r = torch.as_tensor(refs, dtype=torch.float32, device=vth.device).reshape(-1)
    if kind == "lsb":
        bits = vth < r[0]
    elif kind == "msb":
        bits = (vth < r[0]) | (vth > r[1])
    elif kind == "sbr":
        neg = (vth < r[0]) | (vth > r[1])
        pos = (vth < r[2]) | (vth > r[3])
        bits = ~(neg ^ pos)
    elif kind == "parity":
        if n_refs is None or not 1 <= n_refs <= MAX_REFS:
            raise ValueError(f"parity reads need 1..{MAX_REFS} refs, got {n_refs}")
        odd = vth > r[0]
        for i in range(1, n_refs):
            odd = odd ^ (vth > r[i])
        bits = ~odd
    else:
        raise ValueError(kind)
    return ~bits if invert else bits


def mlc_sense(vth: torch.Tensor, refs: Refs, kind: str,
              invert: bool = False, n_refs: int | None = None) -> torch.Tensor:
    """Sense + pack: (R, C) float32 Vth -> (R, C // 32) int32 words.

    kind='lsb' uses refs[0]; 'msb' refs[0:2]; 'sbr' refs[0:2] as negative
    and refs[2:4] as positive sensing; 'parity' refs[0:n_refs], bit = 1 iff
    an even number of references lie below the cell's Vth.
    """
    return pack_bits(sense_bits(vth, refs, kind, invert, n_refs))


def mlc_sense_multi(vth: torch.Tensor,
                    plans: Sequence[tuple]) -> torch.Tensor:
    """Sense under several plans: (R, C) float32 Vth and P read plans
    ``(refs, kind, invert)`` -> (P, R, C // 32) int32, plane ``p`` the
    words :func:`mlc_sense` gives under plan ``p``."""
    return torch.stack([mlc_sense(vth, refs, kind, invert)
                        for refs, kind, invert in plans])


def sense_popcount(vth: torch.Tensor, refs: Refs, kind: str,
                   invert: bool = False, n_refs: int | None = None,
                   n_bits: int | None = None) -> torch.Tensor:
    """0-d int32 count of the cells of (R, C) Vth that sense to 1 (as
    :func:`mlc_sense` reads them) among the first ``n_bits``, row after
    row (all of them where None): the words' masked popcount, unpacked."""
    bits = sense_bits(vth, refs, kind, invert, n_refs).reshape(-1)
    return bits[:n_bits].sum(dtype=torch.int32)


def _combine(acc: torch.Tensor, nxt: torch.Tensor, op: str) -> torch.Tensor:
    if op == "and":
        return acc & nxt
    if op == "or":
        return acc | nxt
    if op == "xor":
        return acc ^ nxt
    raise ValueError(op)


def bitwise_reduce(operands: Union[torch.Tensor, Sequence[torch.Tensor]],
                   op: str, invert: bool = False,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold N same-shape int32 word tensors with ``op``: a sequence of N,
    or an (N, ...) stack.  The result has one operand's shape; with
    ``out`` it is written there and ``out`` is returned."""
    if op not in OPS:
        raise ValueError(op)
    acc = operands[0].clone()
    for n in range(1, len(operands)):
        acc = _combine(acc, operands[n], op)
    acc = ~acc if invert else acc
    if out is None:
        return acc
    return out.copy_(acc)


def sense_reduce(vth: torch.Tensor, refs: Refs, kind: str,
                 sense_invert: bool, op: str, invert: bool = False,
                 n_refs: int | None = None) -> torch.Tensor:
    """(N, R, C) same-plan Vth -> (R, C // 32): sense each operand (inverse
    read when ``sense_invert``), fold with ``op``, optional final NOT."""
    n, r, c = vth.shape
    packed = mlc_sense(vth.reshape(n * r, c), refs, kind, invert=sense_invert,
                       n_refs=n_refs)
    return bitwise_reduce(packed.reshape(n, r, -1), op, invert)


def sense_reduce_popcount(vth: torch.Tensor, refs: Refs, mask: torch.Tensor,
                          kind: str, sense_invert: bool, op: str,
                          invert: bool = False,
                          n_refs: int | None = None) -> torch.Tensor:
    """(R,) int32 counts of :func:`sense_reduce` ANDed with ``mask``."""
    words = sense_reduce(vth, refs, kind, sense_invert, op, invert,
                         n_refs=n_refs)
    return popcount_rows(words, mask)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Per-word popcount (SWAR) of int32 words holding uint32 bits."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def popcount_rows(words: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, W) int32 words -> (R,) int32 row popcounts, of ``words & mask``
    where a mask of the same shape is given."""
    if mask is not None:
        words = words & mask
    return popcount_words(words).sum(dim=-1, dtype=torch.int32)
