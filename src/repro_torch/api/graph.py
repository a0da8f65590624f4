"""Lazy bit-vector expression graph.

A :class:`BitVector` is a named handle into a :class:`ComputeSession`;
operators build :class:`Op` nodes instead of executing anything.  The DAG is
canonicalised by :func:`simplify` before compilation:

- chained associative ops (``and``/``or``/``xor``) flatten into one k-ary
  node, so a whole reduction chain compiles to per-pair in-flash senses plus
  a *single* ``bitwise_reduce`` combine;
- double negation cancels;
- ``not`` over an op with an inverse-read twin rewrites into that twin
  (``~(a & b)`` becomes a NAND node — on a leaf pair that is one inverse-read
  sense, zero extra phases, exactly the paper's Table-1 trick).

Nodes are frozen dataclasses, hence hashable: sessions memoise per-node
results so shared subexpressions evaluate once.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

ASSOCIATIVE = ("and", "or", "xor")
#: op <-> its inverse-read twin (both directions).
INVERSE = {"and": "nand", "nand": "and", "or": "nor", "nor": "or",
           "xor": "xnor", "xnor": "xor"}
#: inverted op -> (associative base op used for partial combines; the k-ary
#: node evaluates as base-op fold + final inversion — ``xnor`` included,
#: since a k-ary xnor only arises from ``~(xor chain)``).
BASE_OF = {"nand": "and", "nor": "or", "xnor": "xor"}


@dataclasses.dataclass(frozen=True)
class Node:
    pass


@dataclasses.dataclass(frozen=True)
class Leaf(Node):
    """A named bit-vector stored in flash."""
    name: str


@dataclasses.dataclass(frozen=True, eq=False, repr=False)
class Op(Node):
    """A bitwise operation over child nodes ('not' is unary, others k-ary).

    Hashing is cached at construction (children are built first, so a
    parent's hash derives from already-cached child hashes in O(arity)) and
    equality walks iteratively — the dataclass-generated recursive
    hash/eq/repr would overflow the interpreter stack on the left-deep
    trees that long operand chains build.
    """
    op: str
    args: Tuple[Node, ...]

    def __post_init__(self):
        object.__setattr__(
            self, "_hash", hash((self.op, tuple(hash(a) for a in self.args))))

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other):
        if self is other:
            return True
        if not isinstance(other, Op):
            return NotImplemented
        stack = [(self, other)]
        while stack:
            x, y = stack.pop()
            if x is y:
                continue
            if isinstance(x, Op):
                if (not isinstance(y, Op) or x._hash != y._hash
                        or x.op != y.op or len(x.args) != len(y.args)):
                    return False
                stack.extend(zip(x.args, y.args))
            elif x != y:                      # Leafs: shallow dataclass eq
                return False
        return True

    def __repr__(self) -> str:
        return f"Op({self.op!r}, <{len(self.args)} args>)"


def _flatten(op: str, args: Tuple[Node, ...]) -> Node:
    """One-level fold of same-op children (children are already canonical,
    so their own args contain no nested same-op nodes)."""
    flat: list[Node] = []
    for a in args:
        if isinstance(a, Op) and a.op == op:
            flat.extend(a.args)
        else:
            flat.append(a)
    return Op(op, tuple(flat))


def _rewrite(op: str, args: Tuple[Node, ...]) -> Node:
    """Fold rules over already-simplified children."""
    if op == "not":
        (x,) = args
        if isinstance(x, Op) and x.op == "not":
            return x.args[0]
        if isinstance(x, Op) and x.op in INVERSE:
            twin = INVERSE[x.op]
            return _flatten(twin, x.args) if twin in ASSOCIATIVE else Op(twin, x.args)
        return Op("not", args)
    if op in ASSOCIATIVE:
        return _flatten(op, args)
    return Op(op, args)


def simplify(node: Node) -> Node:
    """Canonicalise a DAG: flatten associative chains, fold negations.

    Iterative post-order walk with memoisation — k-operand chains build
    left-deep trees one level per operand, so a recursive walk would blow
    the interpreter stack on a few hundred operands, and shared
    subexpressions are canonicalised once, not once per reference.
    """
    memo: dict[Node, Node] = {}
    stack = [node]
    while stack:
        n = stack[-1]
        if n in memo:
            stack.pop()
            continue
        if isinstance(n, Leaf):
            memo[n] = n
            stack.pop()
            continue
        assert isinstance(n, Op), n
        pending = [a for a in n.args if a not in memo]
        if pending:
            stack.extend(pending)
            continue
        stack.pop()
        memo[n] = _rewrite(n.op, tuple(memo[a] for a in n.args))
    return memo[node]


class BitVector:
    """Lazy handle to a (possibly not yet computed) bit vector.

    Created by :meth:`ComputeSession.write` / :meth:`ComputeSession.vector`;
    composing handles with ``& | ^ ~`` (or :meth:`xnor`/:meth:`nand`/
    :meth:`nor`) records ops into the session's DAG.  Nothing executes until
    :meth:`materialize`.
    """

    __slots__ = ("_session", "node", "n_bits")

    def __init__(self, session, node: Node, n_bits: int):
        self._session = session
        self.node = node
        self.n_bits = int(n_bits)

    # -- graph building ------------------------------------------------------
    def _binary(self, op: str, other: "BitVector",
                dunder: bool = False) -> "BitVector":
        if not isinstance(other, BitVector):
            if dunder:                       # let Python raise the TypeError
                return NotImplemented
            raise TypeError(f"expected a BitVector operand, got {type(other).__name__}")
        if other._session is not self._session:
            raise ValueError("cannot combine BitVectors from different sessions")
        if other.n_bits != self.n_bits:
            raise ValueError(f"operand sizes differ: {self.n_bits} vs {other.n_bits}")
        return BitVector(self._session, Op(op, (self.node, other.node)), self.n_bits)

    def __and__(self, other): return self._binary("and", other, dunder=True)
    def __or__(self, other): return self._binary("or", other, dunder=True)
    def __xor__(self, other): return self._binary("xor", other, dunder=True)

    def __invert__(self) -> "BitVector":
        return BitVector(self._session, Op("not", (self.node,)), self.n_bits)

    def xnor(self, other): return self._binary("xnor", other)
    def nand(self, other): return self._binary("nand", other)
    def nor(self, other): return self._binary("nor", other)

    # -- execution -----------------------------------------------------------
    def materialize(self, **kwargs):
        """Compile + run the recorded expression; see ComputeSession.materialize."""
        return self._session.materialize(self, **kwargs)

    def popcount(self) -> int:
        return self._session.popcount(self)

    def __repr__(self) -> str:
        return f"BitVector({self.node!r}, n_bits={self.n_bits})"
