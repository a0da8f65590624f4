#!/usr/bin/env python3
"""Main-path and served-pass wall time of two checkouts of this repository,
in alternating turns on one NVIDIA card, and the cost of the change's page
records; or, with ``--placed``, the placed wave runner against the
unplaced one in one checkout.

    python3 ab_main_path.py PARENT_DIR CHANGE_DIR [--rounds 2] [--pairs 8] [--serve-pairs 4]
    python3 ab_main_path.py PARENT_DIR CHANGE_DIR --device cpu --pairs 0
    python3 ab_main_path.py --placed DIR [--rounds 2] [--pairs 8] [--profile]

In each of ``--rounds`` rounds, one fresh worker process per checkout
imports that checkout's ``chip_smoke``, builds its CUDA kernels (once per
checkout: later rounds find them built) and runs one warm-up of each
workload.  The workers then take turns: pair ``i`` runs parent then change
for even ``i`` and change then parent for odd ``i``, so neither side always
goes first; fresh processes each round keep a slow process from standing
for its side.
The workloads are ``chip_smoke.main_path()`` (``--pairs``) and the served
pass of ``chip_smoke.serve_workload``: 96 requests through a
``QueryEngine`` over 32 columns, every result held against numpy
(``--serve-pairs``).  Each turn prints a line ``AB {...}``; the end prints
per side the median and quartiles over all rounds, and the median of the
paired differences (change - parent), of the main path's wall time and
of the served pass's and its writes'.

On the card each turn also reports the caching allocator's segments
(``cudaMalloc`` calls) and peak bytes.  Last, where the change has
``FlashDevice._keep_records`` (the page records that programming keeps:
a copy of each batch's pages, or the bits copyback sensed itself), the
change's worker runs each workload once more with that method timed:
calls, rows, bytes copied, host seconds spent in it and, on the card, the
time between CUDA events around each call (line ``AB records {...}``).
The timed runs are not part of the pairs.  ``--profile`` then runs each
workload once more on each side under ``cProfile`` and prints the 15
Python functions, and the 10 source files, with the most time of their
own (line ``AB profile``).

``--placed`` runs both workers in ``DIR``, one on unplaced devices and
one on ``FlashDevice(shard_devices=[device] * 4)`` (four streams on one
card), and pairs them the same way on two workloads (``--pairs`` each):
``chip_smoke.placed_workload`` on a fresh device (the main path's Table-1
ops under three encodings and the bitmap index, each against numpy), and
the die-parallel fold query (``chip_smoke.fold_query``: one wave of 15
die-disjoint sense groups and a combine) on a device written once per
worker, in ms per materialize over ``chip_smoke.QUERY_ITERS`` calls.
The paired differences are then placed - unplaced.

``--device cpu`` rehearses the served pass at 1 kB pages and 2**16-bit
columns (the main path has no small size: give ``--pairs 0``), and the
placed workloads at 1 kB pages, 2**17-bit bitmaps and 2**15-bit Table-1
operands.  Exits non-zero when a turn fails or, with ``--device cuda``,
without a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WORKER = r"""
import gc, json, sys, time
import numpy as np
import torch
import chip_smoke
from repro_torch.api.session import ComputeSession
from repro_torch.flash.device import FlashDevice
from repro_torch.flash.geometry import SSDConfig
from repro_torch.serve import QueryEngine

DEVICE = sys.argv[1]
ON_CARD = DEVICE == "cuda"
MODE = sys.argv[2]        # "checkout", or "unplaced" / "placed" devices
SHARDS = [DEVICE] * chip_smoke.PLACED_SHARDS if MODE == "placed" else None
CONFIG = None if ON_CARD else SSDConfig(page_kb=1)
COLUMN_BITS = chip_smoke.BITMAP_USERS if ON_CARD else 2 ** 16


def sync():
    if ON_CARD:
        torch.cuda.synchronize()


if not ON_CARD:
    chip_smoke.sync = sync
    chip_smoke.BITMAP_USERS, chip_smoke.TABLE1_BITS = 2 ** 17, 2 ** 15


def tidy():
    gc.collect()
    if ON_CARD:
        torch.cuda.empty_cache()


def allocator(work):
    # on the card, add the caching allocator's counts over ``work``: the
    # segments it had to allocate (cudaMalloc calls) and peak bytes
    if not ON_CARD:
        return work()
    torch.cuda.reset_accumulated_memory_stats()
    torch.cuda.reset_peak_memory_stats()
    out = work()
    st = torch.cuda.memory_stats()
    out.update(segments=st["segment.all.allocated"],
               alloc_retries=st["num_alloc_retries"],
               peak_gib=st["allocated_bytes.all.peak"] / 2 ** 30,
               reserved_peak_gib=st["reserved_bytes.all.peak"] / 2 ** 30)
    return out


def main_path():
    return {"main_path_s": chip_smoke.main_path()["phases"]["main_path_s"]}


def serve():
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    sess = ComputeSession(DEVICE, config=CONFIG, trace=True)
    t = time.perf_counter()
    exprs, pcs, oracles = chip_smoke.serve_workload(sess, gen, COLUMN_BITS)
    sync()
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    eng = QueryEngine(sess)
    tickets = []
    for expr, pc in zip(exprs, pcs):
        tickets.append(eng.submit(expr, popcount=pc))
        eng.poll()
    results = eng.drain(tickets)
    sync()
    serve_s = time.perf_counter() - t
    for ticket, got, want in zip(tickets, results, oracles):
        same = (got == want if ticket.popcount
                else got.dtype == np.uint32 and np.array_equal(got, want))
        if not same:
            raise SystemExit(f"served request {ticket.rid} differs from numpy")
    return {"write_s": write_s, "serve_s": serve_s}


def placed_workload():
    sess = chip_smoke.placed_session(SHARDS, DEVICE, CONFIG)
    return {"workload_s": chip_smoke.placed_workload(sess)[0]}


FOLD = []


def fold():
    # the fold query on one device per worker, written on the first call
    if not FOLD:
        sess = chip_smoke.placed_session(SHARDS, DEVICE, CONFIG)
        FOLD.extend((sess, chip_smoke.placed_workload(sess)[1]))
    sess, query = FOLD
    return {"fold_ms": 1e3 * chip_smoke.time_query(sess, query,
                                                   chip_smoke.QUERY_ITERS),
            "placed_unit_dispatches": sess.placed_unit_dispatches}


def records(work):
    orig = FlashDevice._keep_records
    acc = {"calls": 0, "rows": 0, "copied_bytes": 0, "host_s": 0.0}
    events = []

    def timed(self, wls, roles, encoding, kept):
        t = time.perf_counter()
        if ON_CARD:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        orig(self, wls, roles, encoding, kept)
        if ON_CARD:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            events.append((start, end))
        acc["host_s"] += time.perf_counter() - t
        acc["calls"] += 1
        acc["rows"] += len(wls)
        if kept is None and wls:
            acc["copied_bytes"] += sum(r.numel() * r.element_size()
                                       for r in self._operands[wls[0]][0])

    FlashDevice._keep_records = timed
    try:
        acc.update(work())
    finally:
        FlashDevice._keep_records = orig
    sync()
    acc["device_ms"] = (sum(s.elapsed_time(e) for s, e in events)
                        if ON_CARD else None)
    return acc


def profiled(work):
    # the 15 Python functions with the most time of their own, on the host
    import cProfile, os, pstats
    prof = cProfile.Profile()
    out = prof.runcall(work)
    rows = sorted(pstats.Stats(prof).stats.items(), key=lambda kv: -kv[1][2])
    out["top"] = [[f"{os.path.basename(f)}:{ln}:{fn}", nc, tt, ct]
                  for (f, ln, fn), (_, nc, tt, ct, _) in rows[:15]]
    # and the 10 source files with the most time of their own
    by_file = {}
    for (f, _, _), (_, _, tt, _, _) in rows:
        by_file[os.path.basename(f)] = by_file.get(os.path.basename(f), 0) + tt
    out["files"] = sorted(by_file.items(), key=lambda kv: -kv[1])[:10]
    return out


WORK = ({"main": main_path, "serve": serve} if MODE == "checkout"
        else {"workload": placed_workload, "fold": fold})
if ON_CARD:
    from repro_torch.kernels import cuda
    cuda.build()
print("AB ready", flush=True)
for line in sys.stdin:
    kind, _, how = line.split()[0].partition(":")
    if how == "records":
        out = (records(WORK[kind]) if hasattr(FlashDevice, "_keep_records")
               else None)
    elif how == "profile":
        out = profiled(WORK[kind])
    else:
        out = allocator(WORK[kind])
    tidy()
    print("AB " + json.dumps(out), flush=True)
"""


class Worker:
    """One checkout's worker process: send a workload, read its result.
    ``mode`` is ``"checkout"`` (the main path and the served pass), or
    ``"unplaced"`` / ``"placed"`` (the placed workloads on such devices)."""

    def __init__(self, tree: Path, device: str, mode: str):
        self.tree = tree
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKER, device, mode], cwd=tree, text=True,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def read(self):
        for line in self.proc.stdout:
            if line.startswith("AB "):
                return line[3:].strip()
        raise SystemExit(f"worker in {self.tree} ended "
                         f"(exit {self.proc.wait()})")

    def run(self, kind: str):
        self.proc.stdin.write(kind + "\n")
        self.proc.stdin.flush()
        return json.loads(self.read())

    def close(self) -> None:
        self.proc.stdin.close()
        if self.proc.wait(timeout=120):
            raise SystemExit(f"worker in {self.tree} exited "
                             f"{self.proc.returncode}")


def summary(samples: dict, key: str) -> dict:
    """Per side, the median, quartiles and range of ``key``; then the median
    of the paired differences (second side - first) and how many pairs
    the second side was slower in."""
    out = {}
    for side, runs in samples.items():
        xs = [r[key] for r in runs]
        q = (statistics.quantiles(xs, n=4, method="inclusive")
             if len(xs) > 1 else xs * 3)
        out[side] = {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
                     "min": min(xs), "max": max(xs)}
    first, second = samples.values()
    diffs = [c[key] - p[key] for p, c in zip(first, second)]
    out["paired_diff_median"] = statistics.median(diffs)
    out["slower_pairs"] = sum(d > 0 for d in diffs)
    out["pairs"] = len(diffs)
    return out


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", type=Path, nargs="+", metavar="DIR",
                    help="PARENT_DIR CHANGE_DIR, or one DIR with --placed")
    ap.add_argument("--placed", action="store_true",
                    help="placed against unplaced devices in one DIR")
    ap.add_argument("--pairs", type=int, default=8,
                    help="main-path pairs per round, or with --placed pairs "
                         "of each workload (0 skips it)")
    ap.add_argument("--serve-pairs", type=int, default=4,
                    help="served-pass pairs per round (0 skips it)")
    ap.add_argument("--rounds", type=int, default=2,
                    help="rounds, each with fresh worker processes")
    ap.add_argument("--profile", action="store_true",
                    help="last, profile each workload once on each side")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if len(args.trees) != (1 if args.placed else 2):
        ap.error("give PARENT_DIR CHANGE_DIR, or one DIR with --placed")
    if args.placed:
        tree = args.trees[0].resolve()
        sides = {"unplaced": (tree, "unplaced"), "placed": (tree, "placed")}
        work = [("workload", "workload_s", args.pairs),
                ("fold", "fold_ms", args.pairs)]
    else:
        sides = {side: (tree.resolve(), "checkout")
                 for side, tree in zip(("parent", "change"), args.trees)}
        work = [("main", "main_path_s", args.pairs),
                ("serve", "serve_s", args.serve_pairs)]
    work = [w for w in work if w[2]]
    first, second = sides
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("ab_main_path: no CUDA device", file=sys.stderr)
            return 2
    samples = {kind: {side: [] for side in sides} for kind, _, _ in work}
    for rnd in range(args.rounds):
        workers = {side: Worker(tree, args.device, mode)
                   for side, (tree, mode) in sides.items()}
        try:
            for w in workers.values():
                w.read()                       # built and imported
            for kind, _, pairs in work:
                for side, w in workers.items():
                    print(f"AB warm-up {kind} round {rnd} {side} "
                          + json.dumps(w.run(kind)), flush=True)
                for i in range(pairs):
                    for side in ((first, second) if i % 2 == 0
                                 else (second, first)):
                        out = workers[side].run(kind)
                        samples[kind][side].append(out)
                        print(f"AB {kind} round {rnd} pair {i} {side} "
                              + json.dumps(out), flush=True)
            if rnd == args.rounds - 1:
                for kind, _, _ in work:
                    if not args.placed:
                        print(f"AB records {kind} " + json.dumps(
                            workers[second].run(kind + ":records")),
                            flush=True)
                    for side, w in (workers.items() if args.profile else ()):
                        print(f"AB profile {kind} {side} " + json.dumps(
                            w.run(kind + ":profile")), flush=True)
            for w in workers.values():
                w.close()
        finally:
            for w in workers.values():
                if w.proc.poll() is None:
                    w.proc.kill()
                    w.proc.wait()
    for kind, key, _ in work:
        keys = [key] + (["write_s"] if kind == "serve" else [])
        for k in keys:
            print(f"AB summary {kind} {k} "
                  + json.dumps(summary(samples[kind], k)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
