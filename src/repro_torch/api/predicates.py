"""Range predicates over bit-sliced integer columns, built from pair senses.

A b-bit code column is stored as b bit-slice vectors, most significant
first.  :func:`between` builds ``lo <= v <= hi`` as a lazy DAG from the
session's public operators alone; lowering, verification and execution
stay the executor's (``ComputeSession.between`` is the entry point).

**Digits.**  A slice whose stored FTL partner (``partner_of``) is its
neighbour one place down in significance makes a 2-bit digit
``d = (h, l)`` with it: the two pages of one wordline.  Any other slice is
a lone bit.

**The recurrence.**  Strict ``v > c`` is built from the least significant
digit up as ``r = G_k | (E_k & r)``, ``k`` the constant's digit:

    k   G = [d > k]   E = [d == k]
    0   or(h, l)      nor(h, l)
    1   h             xor(or(h, l), h)
    2   and(h, l)     xor(h, and(h, l))
    3   0             and(h, l)

Every term is a Table-1 pair sense or a single page read; no leaf is
inverted.  ``v >= c`` starts from all-ones, where ``G | E`` folds to
``[d >= k]``.  A lone bit ``b`` gives ``b | r`` for a 0 (``b | (~b & r)``
absorbed) and ``b & r`` for a 1.  ``v <= hi`` is ``~(v > hi)``, which
``simplify`` folds into the top combine (a nor or a nand); where
``v > hi`` is one bare page ``h``, it is inverted as
``nor(h, and(h, partner))``, never as ``not(h)``.  Constants fold: True
and False never reach the graph.

**Why nothing realigns.**  After ``simplify`` no op holds two leaves from
different wordlines, so ``FTL.group_for_sense`` never regroups and nothing
reaches ``ensure_aligned``, ``align_group`` or ``ensure_not_ready``:

- a digit's lone page sits only in an XOR (E for k = 1, 2) or in the OR
  at its own level (G for k = 1), which holds no other leaf;
- the AND that carries ``r`` flattens only with k = 3 digits, whole pairs;
- the one lone page that AND can hold is a bare ``r = h`` at the bottom
  of the recurrence.

The textbook MSB-first form (``eq &= ~x_i``, ``gt |= eq & x_i & ~c_i``)
breaks all three: ``simplify`` flattens the running ``eq`` into k-ary ANDs
of up to b literals, so slices are re-sensed O(b^2) times; each ``~x_i`` of
a stored slice costs a NOT-ready copy; and an AND holding two half-pairs
moves both to new wordlines (copyback realignment).  Writing E for k = 1
and 2 as ``xor(h, l) & l`` and ``xor(h, l) & h`` breaks the second rule:
it puts the digit's lone page into the AND that carries ``r``, where it
meets the lone page of the digit below.

A lone bit keeps the invariant at the bottom of the column (an odd width
paired from the most significant slice).  Higher up, ``b | r`` or
``b & r`` can meet a lone page of ``r`` in one op; the executor then
realigns the two, which stays correct but costs FTL time.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

from repro_torch.api.graph import BitVector, Leaf, Op

#: a folded constant or a lazy vector
Term = Union[bool, BitVector]


def digits(ftl, names: Sequence[str]) -> List[Tuple[str, ...]]:
    """The column's digits, most significant first: ``(h, l)`` where ``l``
    is ``h``'s stored partner and next in significance, else ``(b,)``."""
    names = list(names)
    if not names:
        raise ValueError("a column needs at least one bit-slice")
    if len(set(names)) != len(names):
        raise ValueError(f"a slice appears twice in {names}")
    out: List[Tuple[str, ...]] = []
    i = 0
    while i < len(names):
        if i + 1 < len(names) and ftl.partner_of(names[i]) == names[i + 1]:
            out.append((names[i], names[i + 1]))
            i += 2
        else:
            out.append((names[i],))
            i += 1
    return out


def _or(a: Term, b: Term) -> Term:
    if a is True or b is True:
        return True
    if a is False:
        return b
    return a if b is False else a | b


def _and(a: Term, b: Term) -> Term:
    if a is False or b is False:
        return False
    if a is True:
        return b
    return a if b is True else a & b


def _step(sess, digit: Tuple[str, ...], k: int, r: Term) -> Term:
    """``[d > k] | ([d == k] & r)`` for one digit, constants folded."""
    if len(digit) == 1:
        b = sess.vector(digit[0])
        return _or(b, r) if k == 0 else _and(b, r)
    h, l = sess.vector(digit[0]), sess.vector(digit[1])
    if r is True:                        # [d >= k]
        return (True, h | l, h, h & l)[k]
    if k == 0:
        return _or(h | l, _and(h.nor(l), r))
    if k == 1:
        return _or(h, _and((h | l) ^ h, r))
    if k == 2:
        return _or(h & l, _and(h ^ (h & l), r))
    return _and(h & l, r)


def _greater(sess, digs: List[Tuple[str, ...]], c: int, r: Term) -> Term:
    """``v > c`` (``r`` False) or ``v >= c`` (``r`` True), LSB digit first."""
    shift = 0
    for digit in reversed(digs):
        w = len(digit)
        r = _step(sess, digit, (c >> shift) & ((1 << w) - 1), r)
        shift += w
    return r


def _invert(sess, r: BitVector) -> BitVector:
    """``~r``; a bare stored page with a partner inverts as
    ``nor(h, and(h, partner))`` (a pair sense and a combine, no NOT-ready
    copy)."""
    if isinstance(r.node, Leaf):
        partner = sess.ftl.partner_of(r.node.name)
        if partner is not None:
            return r.nor(r & sess.vector(partner))
    return ~r


def _constant(sess, digit: Tuple[str, ...], value: bool) -> BitVector:
    """All ones or all zeros, built from one digit's wordline."""
    a = sess.vector(digit[0])
    partner = digit[1] if len(digit) == 2 else sess.ftl.partner_of(digit[0])
    if partner is None:
        return a | ~a if value else a & ~a
    b = sess.vector(partner)
    return (a | b) | a.nor(b) if value else (a & b) & a.nor(b)


def count_nodes(expr: BitVector) -> int:
    """Distinct op nodes of an expression's DAG."""
    seen: set = set()
    stack = [expr.node]
    while stack:
        n = stack.pop()
        if isinstance(n, Op) and n not in seen:
            seen.add(n)
            stack.extend(n.args)
    return len(seen)


def between(sess, digs: List[Tuple[str, ...]], lo: int, hi: int
            ) -> BitVector:
    """Rows of a column (its :func:`digits`) with ``lo <= v <= hi``."""
    top = (1 << sum(len(d) for d in digs)) - 1
    lo, hi = max(int(lo), 0), min(int(hi), top)
    if lo > hi:
        return _constant(sess, digs[0], False)
    ge = _greater(sess, digs, lo, True)
    gt = _greater(sess, digs, hi, False)
    le = True if gt is False else _invert(sess, gt)
    out = _and(ge, le)
    return _constant(sess, digs[0], True) if out is True else out
