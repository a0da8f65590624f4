"""Plan-corpus verification: every plan of the corpus verifies clean in
paranoid mode.

``python -m repro_torch.verify.corpus`` lowers the expression
corpus — every Table-1 pair op, NOT, fused chains, mixed multi-wave DAGs,
scattered operands (which force realignment programs at lowering time), and
seeded random DAGs — across every encoding x die count the test matrix
covers, through sessions with ``verify="paranoid"``.  Any
:class:`~repro_torch.verify.PlanInvariantError` fails the run.  The
sessions run on the card unless ``--device cpu`` (or ``device="cpu"``)
asks for the CPU.
"""
from __future__ import annotations

import argparse
import sys
from typing import Tuple

import numpy as np

__all__ = ["iter_corpus", "run_corpus", "main"]

ENCODINGS = ("mlc", "tlc", "reduced-mlc")
DIES = (1, 2, 4)
PAIR_OPS = ("and", "or", "xor", "nand", "nor", "xnor")


def _session(encoding: str, dies: int, seed: int, device=None):
    from repro_torch.api import ComputeSession
    from repro_torch.flash.geometry import SSDConfig

    cfg = SSDConfig(page_kb=1, channels=1, dies_per_channel=dies)
    return ComputeSession(device, config=cfg, encoding=encoding,
                          seed=seed, verify="paranoid")


def _random_expr(rng, vecs, depth: int = 0):
    if depth >= 3 or rng.random() < 0.35:
        return vecs[int(rng.integers(0, len(vecs)))]
    if rng.random() < 0.15:
        return ~_random_expr(rng, vecs, depth + 1)
    op = ("and", "or", "xor")[int(rng.integers(0, 3))]
    expr = _random_expr(rng, vecs, depth + 1)
    for _ in range(int(rng.integers(1, 4))):
        expr = getattr(expr, f"__{op}__")(_random_expr(rng, vecs, depth + 1))
    return expr


def _pair_expr(a, b, op):
    pos = {"and": a & b, "or": a | b, "xor": a ^ b}
    if op in pos:
        return pos[op]
    return ~_pair_expr(a, b, {"nand": "and", "nor": "or", "xnor": "xor"}[op])


def iter_corpus(encoding: str, dies: int, seed: int = 0, device=None):
    """Yield ``(label, session, expr)`` for one encoding x die count."""
    from repro_torch.core import tlc

    rng = np.random.default_rng(seed)
    sess = _session(encoding, dies, seed, device)
    n = sess.ftl.cfg.page_bits
    bits = [(rng.random(n) < 0.5).astype(np.uint8) for _ in range(12)]
    if encoding == tlc.TLC:
        vecs = list(sess.write_triple("a", bits[0], "b", bits[1],
                                      "c", bits[2]))
        vecs += list(sess.write_triple("d", bits[3], "e", bits[4],
                                       "f", bits[5]))
        # two wordlines pinned to one die: their sense groups contend, so
        # the plan always needs >= 2 waves (at every die count)
        pinned = list(sess.write_triple("p", bits[8], "q", bits[9],
                                        "r", bits[10], die=0))
        contended = (pinned[0] & pinned[1]) ^ (pinned[0] | pinned[2])
    else:
        vecs = []
        for i, (x, y) in enumerate((("a", "b"), ("c", "d"), ("e", "f"))):
            vecs += list(sess.write_pair(x, bits[2 * i], y, bits[2 * i + 1]))
        p, q = sess.write_pair("p", bits[8], "q", bits[9], die=0)
        r, s = sess.write_pair("r", bits[10], "s", bits[11], die=0)
        contended = (p & q) ^ (r | s)
    # scattered singles: co-locating them forces a realignment program
    # during lowering (slot-hazard coverage)
    vecs.append(sess.write("g", bits[6]))
    vecs.append(sess.write("h", bits[7]))
    a, b = vecs[0], vecs[1]
    ops = PAIR_OPS if encoding == tlc.MLC else ("and", "or", "xor")
    for op in ops:
        yield f"{op}(a,b)", sess, _pair_expr(a, b, op)
    yield "not(a)", sess, ~a
    yield "chain6-and", sess, sess.chain("and", vecs[:6])
    yield "chain6-xor", sess, sess.chain("xor", vecs[:6])
    yield "mixed-dag", sess, (vecs[0] & vecs[1]) ^ (vecs[2] | vecs[3])
    yield "die-contended", sess, contended
    yield "scattered", sess, (vecs[6] & vecs[7]) | vecs[0]
    if encoding == tlc.TLC:
        yield "triple-and", sess, vecs[0] & vecs[1] & vecs[2]
        yield "triple-nand", sess, ~(vecs[0] & vecs[1] & vecs[2])
    for i in range(3):
        yield f"random-{i}", sess, _random_expr(
            np.random.default_rng(seed * 97 + i), vecs)


def run_corpus(seed: int = 0, verbose: bool = False,
               device=None) -> Tuple[int, int]:
    """Lower + paranoid-verify the full corpus; returns
    ``(plans_verified, failures)`` (failures only when errors are caught
    for reporting — the CLI lets the first error propagate)."""
    total = 0
    for encoding in ENCODINGS:
        for dies in DIES:
            for label, sess, expr in iter_corpus(encoding, dies, seed,
                                                 device):
                plan = sess.lower(expr)
                total += 1
                if verbose:
                    print(f"  ok [{encoding} x{dies}d] {label}: "
                          f"{len(plan.waves)} wave(s), "
                          f"{len(plan.groups)} group(s)")
    return total, 0


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify.corpus",
        description="verify the quick-benchmark plan corpus (paranoid mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("-v", "--verbose", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device of the sessions (default: the card)")
    args = ap.parse_args(argv)
    from repro_torch.verify import PlanInvariantError

    try:
        total, _ = run_corpus(seed=args.seed, verbose=args.verbose,
                              device=args.device)
    except PlanInvariantError as exc:
        print(f"corpus verification FAILED: {exc}", file=sys.stderr)
        return 1
    print(f"plan corpus clean: {total} plans verified (paranoid) across "
          f"{len(ENCODINGS)} encodings x {len(DIES)} die counts")
    return 0


if __name__ == "__main__":
    sys.exit(main())
