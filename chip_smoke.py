#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``) and builds the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source, in
   parallel).
2. Holds each of the five kernels against its plain PyTorch version on
   the card at full 16 kB pages (131072 cells), bit for bit: rows that are
   and are not multiples of 8, every read kind (``parity`` with 1..8
   references), every op, both inversion flags, words with bit 31 set.
   Then, at the shapes the main path gives each kernel, holds it against
   its plain version once more and times both with CUDA events (and the
   one PyTorch call that computes the same function, where there is one).
3. Drives the compute-session main path, ``ComputeSession(device="cuda")``
   on the default SSD (16 channels x 8 dies, 16 kB pages): the seven
   Table-1 ops and the TLC AND3/OR3 fast paths under mlc, tlc and
   reduced-mlc; the Fig-10 bitmap index (AND over 30 daily bitmaps of
   2**25 users, 256 pages each) with its popcount; an image-encryption XOR.
   Every result is held against a numpy oracle bit for bit, and every
   kernel's launch count must have risen during this phase.
4. Serving phase: a ``repro_torch.serve.QueryEngine`` with the default
   ``SLOConfig`` over a session on the default SSD: 32 column bitmaps of
   2**25 bits (16 MLC pairs over 16 dies, 2 GiB of Vth) and 96 requests in
   the mix of ``benchmarks/serve_latency.py`` (pair AND, pair XOR,
   3-operand OR chain, popcount of an AND).  Every result is held against
   a numpy oracle; it prints solo against batched waves, ``waves_shared``,
   ``coalesced_sense_groups`` and the p50/p99 admit->result latency read
   from the tracer's request spans.
5. Recovery phase: sessions with 10k-P/E wear faults and one dead
   (plane, block) under a written pair, recovery on, under mlc and
   reduced-mlc: Table-1 ops, a fused chain and a controller combine on
   2**20-bit pairs.  The dead block's data cannot be read back at any
   reference, so the ladder (retry, recalibrate, migrate) retires it and
   raises ``BlockRetiredError``; the pair is rewritten from the host copy
   and every result is then held against numpy.  It prints the raw bit
   errors of the same work with recovery off, the ladder's counters, and
   reduced-mlc's raw error rate at 10k P/E over 8 fault seeds.
   In both phases the session's backend records the first call of each
   kernel at each read plan, as the served pass and the ladder make them
   (the ladder's shifted references included), and each recorded call is
   held against its kernel's plain version on the same inputs; every
   kernel the phase launched must have a recorded call, and the phase's
   launch counts must be above 0 for the kernels it needs.
6. Prints the ``kernels`` JSON line (launches summed over the three
   paths), then a last line ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits non-zero.
A fuller record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate and fp32 (non-tensor) peak, from the data sheet
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
COLS = 131072                        # one 16 kB page of cells
BITMAP_USERS = 2 ** 25               # 256 pages per daily bitmap
BITMAP_DAYS = 30
TABLE1_BITS = 2 ** 20                # 8 pages per operand
IMAGE_BITS = 800 * 600 * 24          # one RGB image as 24 bitplanes (Fig 10)
SERVE_COLUMNS = 32                   # 16 MLC pairs of 2**25-bit bitmaps
SERVE_REQUESTS = 96
FAULT_PE = 10_000
DEAD_BLOCK = (0, 0)                  # (plane, block): under die 0's first pair
RATE_SEEDS = 8                       # fault seeds of the raw error rate

KERNELS = {
    "mlc_sense": ("src/repro_torch/csrc/mlc_sense.cu",
                  "src/repro/kernels/mlc_sense.py:87"),
    "sense_reduce": ("src/repro_torch/csrc/fused.cu",
                     "src/repro/kernels/fused.py:168"),
    "sense_reduce_popcount": ("src/repro_torch/csrc/fused.cu",
                              "src/repro/kernels/fused.py:211"),
    "bitwise_reduce": ("src/repro_torch/csrc/bitops.cu",
                       "src/repro/kernels/bitops.py:46"),
    "popcount_rows": ("src/repro_torch/csrc/popcount.cu",
                      "src/repro/kernels/popcount.py:47"),
}
KIND_REFS = {"lsb": [1.9], "msb": [0.1, 3.7], "sbr": [0.1, 3.7, 1.9, 5.5]}
#: float32 compares per cell of each read kind (parity: one per reference)
KIND_COMPARES = {"lsb": 1, "msb": 2, "sbr": 4}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def sync() -> None:
    torch.cuda.synchronize()


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def word_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest difference of two word tensors, read as uint32 (0 = equal)."""
    if a.shape != b.shape:
        fail(f"shapes differ: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    ua, ub = a.long() & 0xFFFFFFFF, b.long() & 0xFFFFFFFF
    return int((ua - ub).abs().max())


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, from CUDA events: the stream's time, which includes the host's
    launch path wherever that is longer than the device's work."""
    for _ in range(warmup):
        fn()
    sync()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Mean milliseconds per call that the card spends in kernels (all the
    kernels ``fn`` launches), from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    if total_us <= 0:
        fail("torch.profiler recorded no device time")
    return total_us / iters / 1e3


# -- phase 2: every kernel against its plain version ----------------------------

def kind_cases(gen: torch.Generator):
    """(kind, refs, n_refs) for every read kind, parity with 1..8 refs."""
    cases = [(k, refs, len(refs)) for k, refs in KIND_REFS.items()]
    for n in range(1, 9):
        refs = torch.sort(torch.rand(n, generator=gen, device="cuda") * 6 - 1).values
        cases.append(("parity", [float(r) for r in refs.cpu()], n))
    return cases


def random_words(gen: torch.Generator, shape) -> torch.Tensor:
    """int32 words over the full 32-bit range (half with bit 31 set)."""
    return torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device="cuda", dtype=torch.int64).to(torch.int32)


def check_kernels(gen: torch.Generator) -> dict:
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    errs = {name: 0 for name in KERNELS}
    cases = kind_cases(gen)
    for rows in (5, 8):
        vth = torch.randn(rows, COLS, generator=gen, device="cuda") * 2 + 2
        stack = torch.randn(3, rows, COLS, generator=gen, device="cuda") * 2 + 2
        mask = random_words(gen, (rows, COLS // 32))
        for kind, refs, n_refs in cases:
            for invert in (False, True):
                got = mlc_sense.mlc_sense(vth, refs, kind=kind, invert=invert,
                                          n_refs=n_refs)
                want = mlc_sense.reference(vth, refs, kind, invert, n_refs)
                errs["mlc_sense"] = max(errs["mlc_sense"], word_err(got, want))
            for op in ("and", "or", "xor"):
                for sense_invert in (False, True):
                    for invert in (False, True):
                        got = fused.sense_reduce(
                            stack, refs, kind=kind, sense_invert=sense_invert,
                            op=op, invert=invert, n_refs=n_refs)
                        want = fused.reference(stack, refs, kind, sense_invert,
                                               op, invert, n_refs)
                        errs["sense_reduce"] = max(errs["sense_reduce"],
                                                   word_err(got, want))
                        got = fused.sense_reduce_popcount(
                            stack, refs, mask, kind=kind,
                            sense_invert=sense_invert, op=op, invert=invert,
                            n_refs=n_refs)
                        want = fused.reference_popcount(
                            stack, refs, mask, kind, sense_invert, op, invert,
                            n_refs)
                        errs["sense_reduce_popcount"] = max(
                            errs["sense_reduce_popcount"], word_err(got, want))
        for n in (1, 2, 3, 8):
            words = random_words(gen, (n, rows, COLS // 32))
            for op in ("and", "or", "xor"):
                for invert in (False, True):
                    got = bitops.bitwise_reduce(words, op=op, invert=invert)
                    want = bitops.reference(words, op, invert)
                    errs["bitwise_reduce"] = max(errs["bitwise_reduce"],
                                                 word_err(got, want))
    for shape in ((1, COLS // 32), (5, COLS // 32), (8, 130), (3, 2 * 1024 * 1024)):
        words = random_words(gen, shape)
        words[0, : min(shape[1], 7)] = -1                 # all-ones words
        errs["popcount_rows"] = max(errs["popcount_rows"], word_err(
            popcount.popcount_rows(words), popcount.reference(words)))
    sync()
    bad = {k: v for k, v in errs.items() if v}
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    return errs


def time_kernels(gen: torch.Generator, errs: dict, fused_n: int,
                 rows: int) -> dict:
    """Each kernel against its plain version, bit for bit, then both timed,
    at the main path's shapes: a sense group of ``rows`` pages, a
    ``fused_n``-operand fused chain over them, and a two-operand combine /
    root popcount of ``rows`` pages of words.  Folds the differences into
    ``errs``."""
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    words = rows * COLS // 32
    vth = torch.randn(rows, COLS, generator=gen, device="cuda") * 2 + 2
    stack = torch.randn(fused_n, rows, COLS, generator=gen, device="cuda") * 2 + 2
    mask = torch.full((rows, COLS // 32), -1, dtype=torch.int32, device="cuda")
    pair = random_words(gen, (2, 1, words))
    flat = random_words(gen, (1, words))
    lsb = KIND_REFS["lsb"]
    cell_bytes = 4 + 1 / 8
    plan = {
        "mlc_sense": (
            lambda: mlc_sense.mlc_sense(vth, lsb, kind="lsb", n_refs=1),
            lambda: mlc_sense.reference(vth, lsb, "lsb", False, 1),
            None, rows * COLS * cell_bytes,
            rows * COLS * KIND_COMPARES["lsb"], 20),
        "sense_reduce": (
            lambda: fused.sense_reduce(stack, lsb, kind="lsb", sense_invert=False,
                                       op="and", n_refs=1),
            lambda: fused.reference(stack, lsb, "lsb", False, "and", False, 1),
            None, fused_n * rows * COLS * 4 + rows * COLS / 8,
            fused_n * rows * COLS * 2, 5),
        "sense_reduce_popcount": (
            lambda: fused.sense_reduce_popcount(stack, lsb, mask, kind="lsb",
                                                sense_invert=False, op="and",
                                                n_refs=1),
            lambda: fused.reference_popcount(stack, lsb, mask, "lsb", False,
                                             "and", False, 1),
            None, fused_n * rows * COLS * 4 + rows * COLS / 8 + rows * 4,
            fused_n * rows * COLS * 2 + rows * COLS, 5),
        "bitwise_reduce": (
            lambda: bitops.bitwise_reduce(pair, op="or"),
            lambda: bitops.reference(pair, "or", False),
            lambda: torch.bitwise_or(pair[0], pair[1]),
            3 * words * 4, words, 50),
        "popcount_rows": (
            lambda: popcount.popcount_rows(flat),
            lambda: popcount.reference(flat),
            None, words * 4 + 4, words * 2, 50),
    }
    out = {}
    for name, (kernel, plain, library, n_bytes, n_ops, iters) in plan.items():
        err = word_err(kernel(), plain())
        if library is not None:
            err = max(err, word_err(kernel(), library()))
        sync()
        if err:
            fail(f"{name} disagrees with its plain version at the main "
                 f"path's shape: max word difference {err}")
        errs[name] = max(errs[name], err)
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / FP32_OPS_PER_S * 1e3
        plain_iters = max(2, iters // 5)
        out[name] = {
            "ms": time_ms(kernel, iters),
            "plain_ms": time_ms(plain, plain_iters, warmup=1),
            "library_ms": (time_ms(library, iters) if library is not None
                           else None),
            "device_ms": device_ms(kernel, iters),
            "plain_device_ms": device_ms(plain, plain_iters),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes,
        }
        torch.cuda.empty_cache()
    return out


# -- phase 3: the main path -------------------------------------------------------

def oracle(op: str, a: np.ndarray, b: np.ndarray | None = None) -> np.ndarray:
    if op == "not":
        return ~a
    return {"and": a & b, "or": a | b, "xor": a ^ b, "xnor": ~(a ^ b),
            "nand": ~(a & b), "nor": ~(a | b)}[op]


def host_bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().astype(bool)


def expect(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    got = host_bits(got)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = int((got != want).sum()) if got.shape == want.shape else -1
        fail(f"{what}: {bad} bits differ from the numpy oracle")


def table1(sess, encoding: str, gen: torch.Generator) -> int:
    """The seven Table-1 ops (and the TLC 3-operand fast paths) under one
    encoding, each materialized and counted; returns the checks made."""
    p = f"{encoding}_"
    raw = (torch.rand(3, TABLE1_BITS, generator=gen, device=sess.torch_device)
           < 0.5).to(torch.uint8)
    a_np, b_np, c_np = (host_bits(r) for r in raw)
    if encoding == "tlc":
        a, b, c = sess.write_triple(p + "a", raw[0], p + "b", raw[1],
                                    p + "c", raw[2])
    else:
        a, b = sess.write_pair(p + "a", raw[0], p + "b", raw[1])
        c = sess.write(p + "c", raw[2])
    exprs = {"and": a & b, "or": a | b, "xor": a ^ b, "xnor": a.xnor(b),
             "nand": a.nand(b), "nor": a.nor(b), "not": ~b}
    checks = 0
    for op, expr in exprs.items():
        want = oracle(op, a_np, b_np) if op != "not" else ~b_np
        expect(sess.materialize(expr, unpacked=True), want, f"{encoding} {op}")
        if sess.popcount(expr) != int(want.sum()):
            fail(f"{encoding} {op} popcount")
        checks += 2
    extra = {"and-scattered": (a & c, a_np & c_np)}
    if encoding == "tlc":
        extra = {"and3": (a & b & c, a_np & b_np & c_np),
                 "or3": (a | b | c, a_np | b_np | c_np)}
    for name, (expr, want) in extra.items():
        expect(sess.materialize(expr, unpacked=True), want, f"{encoding} {name}")
        if sess.popcount(expr) != int(want.sum()):
            fail(f"{encoding} {name} popcount")
        checks += 2
    return checks


def bitmap_index(sess, gen: torch.Generator) -> dict:
    """Fig-10 bitmap index: AND over 30 daily activity bitmaps, 2**25 users."""
    days = (torch.rand(BITMAP_DAYS, BITMAP_USERS, generator=gen,
                       device=sess.torch_device) < 0.9).to(torch.uint8)
    vecs = []
    for d in range(0, BITMAP_DAYS, 2):
        vecs.extend(sess.write_pair(f"day{d}", days[d], f"day{d + 1}", days[d + 1]))
    host = days.cpu().numpy().astype(bool)
    want = np.logical_and.reduce(host, axis=0)
    expr = sess.chain("and", vecs)
    expect(sess.materialize(expr, unpacked=True), want, "bitmap AND of 30")
    count = sess.popcount(expr)
    if count != int(want.sum()):
        fail(f"bitmap popcount {count} != {int(want.sum())}")
    pair_want = host[0] & host[1]
    if sess.popcount(vecs[0] & vecs[1]) != int(pair_want.sum()):
        fail("day0 & day1 popcount")
    mixed = (vecs[0] & vecs[1]) | (vecs[2] ^ vecs[3])
    expect(sess.materialize(mixed, unpacked=True),
           pair_want | (host[2] ^ host[3]), "(d0 & d1) | (d2 ^ d3)")
    return {"users": BITMAP_USERS, "days": BITMAP_DAYS,
            "active_all_month": count, "checks": 4}


def image_encryption(sess, gen: torch.Generator) -> int:
    """Bulk XOR of one image's 24 bitplanes with a key (Fig 10)."""
    raw = (torch.rand(2, IMAGE_BITS, generator=gen, device=sess.torch_device)
           < 0.5).to(torch.uint8)
    img, key = sess.write_pair("image", raw[0], "key", raw[1])
    host = raw.cpu().numpy().astype(bool)
    expect(sess.materialize(img ^ key, unpacked=True), host[0] ^ host[1],
           "image XOR key")
    return 1


def main_path(device: str = "cuda", config=None, seed: int = 0) -> dict:
    """The compute-session main path; returns phase times and stats."""
    from repro_torch.api.session import ComputeSession

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phases, checks = {}, 0
    t0 = time.perf_counter()
    sess = ComputeSession(device=device, config=config, seed=seed)
    for encoding in ("mlc", "tlc", "reduced-mlc"):
        s = sess if encoding == "mlc" else ComputeSession(
            flash=sess.device, encoding=encoding)
        t = time.perf_counter()
        checks += table1(s, encoding, gen)
        if device == "cuda":
            sync()
        phases[f"table1_{encoding}_s"] = time.perf_counter() - t
    t = time.perf_counter()
    bitmap = bitmap_index(sess, gen)
    if device == "cuda":
        sync()
    phases["bitmap_index_s"] = time.perf_counter() - t
    t = time.perf_counter()
    checks += bitmap["checks"] + image_encryption(sess, gen)
    if device == "cuda":
        sync()
    phases["image_encryption_s"] = time.perf_counter() - t
    phases["main_path_s"] = time.perf_counter() - t0
    stats = sess.stats()
    return {"phases": phases, "checks": checks, "bitmap": bitmap,
            "stats": {k: stats[k] for k in (
                "backend", "device", "sense_items", "sense_batches",
                "sense_waves", "megakernel_calls", "in_flash_senses",
                "executor", "plan_cache", "arena_shards")},
            "makespan_us": sess.ledger.makespan_us()}


# -- phases 4 and 5: serving and recovery -------------------------------------

def lane_major_words(bits: np.ndarray) -> np.ndarray:
    """{0,1} bits -> uint32 words in the packed layout, in numpy: word ``w``
    of each 4096-cell tile holds bit ``k`` from column ``k * 128 + w``."""
    tiles = np.ascontiguousarray(bits.reshape(-1, 32, 128).transpose(0, 2, 1))
    return np.packbits(tiles, axis=-1, bitorder="little").view("<u4").reshape(-1)


def word_popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8)).sum())


#: backend method -> the kernel its call launches
BACKEND_KERNELS = {"sense": "mlc_sense", "sense_reduce": "sense_reduce",
                   "sense_reduce_popcount": "sense_reduce_popcount",
                   "reduce": "bitwise_reduce", "popcount": "popcount_rows"}


@contextlib.contextmanager
def recording(backend):
    """While the block runs, keep the inputs and output of the first call of
    each kernel at each read plan that ``backend`` makes: a dict
    ``(kernel, plan or None) -> (args, kwargs, output)``."""
    from repro_torch.core.mcflash import ReadPlan

    calls: dict = {}

    def wrap(method: str, name: str):
        real = getattr(backend, method)

        def call(*args, **kwargs):
            out = real(*args, **kwargs)
            plan = next((a for a in args if isinstance(a, ReadPlan)), None)
            if (name, plan) not in calls:
                calls[name, plan] = (args, kwargs, out.clone())
            return out
        return call

    for method, name in BACKEND_KERNELS.items():
        setattr(backend, method, wrap(method, name))
    try:
        yield calls
    finally:
        for method in BACKEND_KERNELS:
            delattr(backend, method)        # the class's methods again


def hold_recorded(calls: dict) -> dict:
    """Each recorded call's output against its kernel's plain version on the
    same inputs.  Returns the largest word difference per kernel."""
    from repro_torch.kernels import bitops, fused, mlc_sense, popcount

    def parts(plan):
        return list(plan.refs), plan.kind, plan.uses_inverse, len(plan.refs)

    def sense(vth, plan):
        refs, kind, inv, n = parts(plan)
        return mlc_sense.reference(vth, refs, kind, inv, n)

    def sense_reduce(vth, plan, *, op, invert=False):
        refs, kind, inv, n = parts(plan)
        return fused.reference(vth, refs, kind, inv, op, invert, n)

    def sense_reduce_popcount(vth, plan, mask, *, op, invert=False):
        refs, kind, inv, n = parts(plan)
        return fused.reference_popcount(vth, refs, mask, kind, inv, op,
                                        invert, n)

    plain = {"mlc_sense": sense, "sense_reduce": sense_reduce,
             "sense_reduce_popcount": sense_reduce_popcount,
             "bitwise_reduce": lambda stack, op, invert=False:
                 bitops.reference(stack, op, invert),
             "popcount_rows": popcount.reference}
    out: dict = {}
    for (name, _), (args, kwargs, got) in calls.items():
        out[name] = max(out.get(name, 0),
                        word_err(got, plain[name](*args, **kwargs)))
    sync()
    return out


def fold_errs(errs: dict, checked: dict, launches: dict, phase: str) -> None:
    unchecked = [k for k, n in launches.items() if n and k not in checked]
    if unchecked:
        fail(f"{phase}: launched {unchecked} but recorded no call of them")
    bad = {k: v for k, v in checked.items() if v}
    if bad:
        fail(f"{phase}: kernels disagree with their plain versions at the "
             f"phase's shapes and references: {bad}")
    for name, err in checked.items():
        errs[name] = max(errs[name], err)


def require_launches(launches: dict, names, phase: str) -> None:
    idle = [k for k in names if launches[k] == 0]
    if idle:
        fail(f"{phase} never launched {idle}")


def serve_workload(sess, gen: torch.Generator, column_bits: int):
    """The request mix of ``benchmarks/serve_latency.py:_workload`` over 32
    column bitmaps: returns (exprs, popcounts, oracles), the oracles as
    numpy words (or counts)."""
    rng = np.random.default_rng(11)
    dies = sess.device.config.dies
    words, vecs = {}, {}
    for i in range(SERVE_COLUMNS // 2):
        raw = (torch.rand(2, column_bits, generator=gen,
                          device=sess.torch_device) < 0.5).to(torch.uint8)
        a, b = f"col{2 * i}", f"col{2 * i + 1}"
        vecs[a], vecs[b] = sess.write_pair(a, raw[0], b, raw[1], die=i % dies)
        host = raw.cpu().numpy()
        words[a], words[b] = lane_major_words(host[0]), lane_major_words(host[1])

    def pick(k: int):
        return list(rng.choice(sorted(vecs), size=k, replace=False))

    exprs, pcs, oracles = [], [], []
    for i in range(SERVE_REQUESTS):
        kind = i % 4
        if kind in (0, 1):
            op = ("and", "xor")[kind]
            a, b = pick(2)
            exprs.append(vecs[a]._binary(op, vecs[b]))
            oracles.append(words[a] & words[b] if op == "and"
                           else words[a] ^ words[b])
        elif kind == 2:
            a, b, c = pick(3)
            exprs.append(sess.chain("or", [vecs[a], vecs[b], vecs[c]]))
            oracles.append(words[a] | words[b] | words[c])
        else:
            a, b = pick(2)
            exprs.append(vecs[a] & vecs[b])
            oracles.append(word_popcount(words[a] & words[b]))
        pcs.append(kind == 3)
    return exprs, pcs, oracles


def serving_phase(gen: torch.Generator, errs: dict, gpu: str,
                  device: str = "cuda", config=None,
                  column_bits: int = BITMAP_USERS) -> dict:
    from repro_torch.api.session import ComputeSession
    from repro_torch.kernels import cuda
    from repro_torch.serve import QueryEngine

    t0 = time.perf_counter()
    sess = ComputeSession(device, config=config, trace=True)
    exprs, pcs, oracles = serve_workload(sess, gen, column_bits)
    sync()
    write_s = time.perf_counter() - t0
    t = time.perf_counter()
    solo_waves = sum(len(sess.lower(e).waves) for e in exprs)
    lower_s = time.perf_counter() - t
    sess.reset_stats()
    sess.trace.clear()
    cuda.reset_launches()
    t = time.perf_counter()
    eng = QueryEngine(sess)
    tickets = []
    with recording(sess.backend) as calls:
        for expr, pc in zip(exprs, pcs):
            tickets.append(eng.submit(expr, popcount=pc))
            eng.poll()
        results = eng.drain(tickets)
        sync()
    serve_s = time.perf_counter() - t
    launches = dict(cuda.launches)
    for ticket, got, want in zip(tickets, results, oracles):
        if ticket.popcount:
            if got != want:
                fail(f"served request {ticket.rid}: count {got} != {want}")
        elif got.dtype != np.uint32 or not np.array_equal(got, want):
            fail(f"served request {ticket.rid}: words differ from the numpy "
                 "oracle")
    st = eng.stats()
    if st["requests_completed"] != SERVE_REQUESTS:
        fail(f"served {st['requests_completed']} of {SERVE_REQUESTS}")
    if not (st["sense_waves"] < solo_waves and st["waves_shared"] >= 1
            and st["coalesced_sense_groups"] >= 1):
        fail(f"no cross-request coalescing: {st}, solo waves {solo_waves}")
    lat = sorted(s.dur_us for s in sess.trace.wall_spans
                 if s.category == "serve")
    if len(lat) != SERVE_REQUESTS:
        fail(f"{len(lat)} request spans for {SERVE_REQUESTS} requests")
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))]
    checked = hold_recorded(calls)
    del calls
    fold_errs(errs, checked, launches, "serving")
    require_launches(launches, ("mlc_sense", "bitwise_reduce",
                                "popcount_rows"), "serving")
    out = {"requests": SERVE_REQUESTS, "batches": st["batches_dispatched"],
           "solo_waves": solo_waves, "batched_waves": st["sense_waves"],
           "waves_shared": st["waves_shared"],
           "coalesced_sense_groups": st["coalesced_sense_groups"],
           "p50_ms": p50 / 1e3, "p99_ms": p99 / 1e3,
           "write_s": write_s, "solo_lowering_s": lower_s,
           "serve_s": serve_s, "seconds": time.perf_counter() - t0,
           "launches": launches, "kernel_checks": sorted(checked),
           "megakernel_calls": sess.megakernel_calls,
           "makespan_us": sess.ledger.makespan_us()}
    print(f"serving ({gpu}): {SERVE_REQUESTS} requests over "
          f"{SERVE_COLUMNS} columns of {column_bits} bits in "
          f"{out['batches']} batches, "
          f"all bit-exact; waves solo {solo_waves} vs batched "
          f"{out['batched_waves']}, waves_shared {out['waves_shared']}, "
          f"coalesced_sense_groups {out['coalesced_sense_groups']}; "
          f"admit->result p50 {out['p50_ms']:.3f} ms, p99 "
          f"{out['p99_ms']:.3f} ms (tracer request spans); serve "
          f"{serve_s:.2f} s, phase {out['seconds']:.2f} s; launches "
          + json.dumps(launches), flush=True)
    return out


def _recovery_work(sess, raw) -> dict:
    """Three pairs, the first (a0, b0) on die 0 over the dead block."""
    vec = {}
    for i in range(3):
        vec[f"a{i}"], vec[f"b{i}"] = sess.write_pair(
            f"a{i}", raw[2 * i], f"b{i}", raw[2 * i + 1], die=i)
    return vec


def _recovery_exprs(sess, vec, host):
    """(label, expr, numpy oracle) of the phase: a fused chain under a
    controller combine, then the Table-1 ops on the first pair."""
    a0, b0, a1, b1, a2, b2 = (vec[k] for k in ("a0", "b0", "a1", "b1",
                                               "a2", "b2"))
    x, y = host[0], host[1]
    return [
        ("chain|xor", sess.chain("and", [a0, b0, a1, b1]) | (a2 ^ b2),
         (x & y & host[2] & host[3]) | (host[4] ^ host[5])),
        ("and", a0 & b0, x & y), ("or", a0 | b0, x | y),
        ("xor", a0 ^ b0, x ^ y), ("nand", a0.nand(b0), ~(x & y)),
        ("nor", a0.nor(b0), ~(x | y)), ("xnor", a0.xnor(b0), ~(x ^ y)),
        ("not", ~b0, ~y),
    ]


def recovery_phase(gen: torch.Generator, errs: dict, gpu: str,
                   device: str = "cuda", config=None,
                   operand_bits: int = TABLE1_BITS) -> dict:
    from repro_torch.api.session import ComputeSession
    from repro_torch.core.calibration import shift_plan
    from repro_torch.kernels import cuda
    from repro_torch.reliability import BlockRetiredError

    t0 = time.perf_counter()
    out: dict = {"encodings": {}}
    launches = {k: 0 for k in cuda.launches}
    for encoding in ("mlc", "reduced-mlc"):
        t = time.perf_counter()
        faults = {"pe": FAULT_PE, "seed": 1, "dead_blocks": (DEAD_BLOCK,)}
        raw = (torch.rand(6, operand_bits, generator=gen, device=device)
               < 0.5).to(torch.uint8)
        host = raw.cpu().numpy().astype(bool)
        # the same writes with recovery off: the raw bit errors
        control = ComputeSession(device, config=config, encoding=encoding,
                                 faults=faults, recovery="off", seed=5)
        cvec = _recovery_work(control, raw)
        raw_errors = raw_bits = 0
        for _, expr, want in _recovery_exprs(control, cvec, host):
            got = host_bits(control.materialize(expr, unpacked=True))
            raw_errors += int(np.count_nonzero(got != want))
            raw_bits += want.size
        del control, cvec

        sess = ComputeSession(device, config=config, encoding=encoding,
                              faults=faults, seed=5)
        vec = _recovery_work(sess, raw)
        if (DEAD_BLOCK + (0,)) not in sess.ftl.vectors["a0"].pages:
            fail("the dead block holds none of the first pair's pages")
        exprs = _recovery_exprs(sess, vec, host)
        cuda.reset_launches()
        with recording(sess.backend) as calls:
            try:
                sess.materialize(exprs[0][1])
            except BlockRetiredError as exc:
                retired = exc.blocks
            else:
                fail(f"{encoding}: data over a dead block read back clean")
            if DEAD_BLOCK not in retired:
                fail(f"{encoding}: retired {retired}, not the dead block")
            detected = sess.reliability.incidents[0]["mismatches"]
            # the data in a dead block is lost: rewrite the pair from the host
            sess.write_pair("a0", raw[0], "b0", raw[1], die=0)
            exprs = _recovery_exprs(sess, {k: sess[k] for k in vec}, host)
            checks = 0
            for label, expr, want in exprs:
                expect(sess.materialize(expr, unpacked=True), want,
                       f"{encoding} {label} after recovery")
                if sess.popcount(expr) != int(want.sum()):
                    fail(f"{encoding} {label} popcount after recovery")
                checks += 2
            sync()
        phase_launches = dict(cuda.launches)
        for k, n in phase_launches.items():
            launches[k] += n
        rel = sess.stats()["reliability"]
        # the ladder's first retry shifts every reference by ``dv``
        dv = sess.reliability.policy.ladder_offsets()[0]
        shifted = sorted({name for name, p in calls if p is not None
                          and (name, shift_plan(p, dv)) in calls})
        if not shifted:
            fail(f"recovery {encoding}: no kernel call at the ladder's "
                 f"first offset {dv:+.3f} V was recorded")
        checked = hold_recorded(calls)
        del calls
        fold_errs(errs, checked, phase_launches, f"recovery {encoding}")
        out["encodings"][encoding] = {
            "raw_bit_errors": raw_errors, "raw_bits": raw_bits,
            "detected_sample_mismatches": detected,
            "retired_blocks": [list(b) for b in retired], "checks": checks,
            "retries": rel["retries"],
            "recalibrations": rel["recalibrations"],
            "migrations": rel["migrations"],
            "retired": rel["retired_blocks"], "ref_trim": rel["ref_trim"],
            "recovery_us": sess.ledger.category_us.get("recovery", 0.0),
            "migration_us": sess.ledger.category_us.get("migration", 0.0),
            "kernel_checks": sorted(checked), "shifted_checks": shifted,
            "kernel_checks_dv": dv, "seconds": time.perf_counter() - t}
        del sess, vec, exprs
    require_launches(launches, ("mlc_sense", "sense_reduce", "bitwise_reduce",
                                "popcount_rows"), "recovery")
    out["launches"] = launches

    # reduced-MLC's raw error rate at 10k P/E (no dead block, recovery off)
    t = time.perf_counter()
    errors = bits = 0
    for seed in range(RATE_SEEDS):
        sess = ComputeSession(device, config=config, encoding="reduced-mlc",
                              recovery="off",
                              faults={"pe": FAULT_PE, "seed": seed},
                              seed=100 + seed)
        raw = (torch.rand(6, operand_bits, generator=gen, device=device)
               < 0.5).to(torch.uint8)
        host = raw.cpu().numpy().astype(bool)
        vec = _recovery_work(sess, raw)
        for _, expr, want in _recovery_exprs(sess, vec, host):
            got = host_bits(sess.materialize(expr, unpacked=True))
            errors += int(np.count_nonzero(got != want))
            bits += want.size
    out["reduced_mlc_rate"] = {"seeds": RATE_SEEDS, "bit_errors": errors,
                               "bits": bits, "rate": errors / bits,
                               "seconds": time.perf_counter() - t}
    out["seconds"] = time.perf_counter() - t0
    for enc, r in out["encodings"].items():
        print(f"recovery ({gpu}) {enc} at {FAULT_PE} P/E, dead block "
              f"{DEAD_BLOCK}: raw bit errors with recovery off "
              f"{r['raw_bit_errors']} of {r['raw_bits']}; detected "
              f"{r['detected_sample_mismatches']} sampled mismatches; ladder "
              f"retries {r['retries']}, recalibrations {r['recalibrations']}, "
              f"migrations {r['migrations']}, retired blocks {r['retired']} "
              f"(BlockRetiredError, pair rewritten); {r['checks']} checks "
              f"bit-exact after recovery; {r['seconds']:.2f} s", flush=True)
    rate = out["reduced_mlc_rate"]
    print(f"reduced-mlc raw error rate at {FAULT_PE} P/E over {RATE_SEEDS} "
          f"fault seeds ({gpu}): {rate['bit_errors']} bit errors in "
          f"{rate['bits']} bits = {rate['rate']:.3e}; recovery phase "
          f"{out['seconds']:.2f} s; launches " + json.dumps(launches),
          flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda

    gpu = gpu_line()
    print(gpu, flush=True)
    record: dict = {"gpu": gpu, "torch": torch.__version__,
                    "cuda": torch.version.cuda}
    t = time.perf_counter()
    build_s = cuda.build()
    cuda._libraries()
    print(f"build: {build_s:.1f} s for {len(cuda.SOURCES)} sources "
          f"(load {time.perf_counter() - t:.1f} s)", flush=True)
    for name, log in cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    record["build_s"] = build_s
    record["build_log"] = cuda.build_log

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t = time.perf_counter()
    errs = check_kernels(gen)
    print(f"kernels vs plain versions: bit-exact ({time.perf_counter() - t:.1f} s)",
          flush=True)
    t = time.perf_counter()
    timing = time_kernels(gen, errs, fused_n=BITMAP_DAYS // 2,
                          rows=BITMAP_USERS // COLS)
    print(f"kernels vs plain versions at the main path's shapes: bit-exact; "
          f"timing ({time.perf_counter() - t:.1f} s), device ms per call "
          "(torch.profiler; kernel / plain): " + json.dumps(
              {k: [v["device_ms"], v["plain_device_ms"]] for k, v in timing.items()}),
          flush=True)
    torch.cuda.empty_cache()

    from torch.profiler import ProfilerActivity, profile

    cuda.reset_launches()
    run = main_path()
    launches = dict(cuda.launches)
    # a second, profiled pass (same seed, fresh device) for the breakdown
    gc.collect()
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiled = main_path()
    busy = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()), reverse=True)
    busy_s = sum(us for us, _, _ in busy) / 1e6
    wall_s = profiled["phases"]["main_path_s"]
    run["device"] = {
        "busy_s": busy_s, "wall_s": wall_s, "idle_share": 1 - busy_s / wall_s,
        "top": [{"kernel": key[:80], "ms": us / 1e3, "count": n}
                for us, n, key in busy[:8]]}
    print(f"main path, profiled pass: device busy {busy_s:.3f} s of "
          f"{wall_s:.3f} s wall (torch.profiler); top kernels "
          + json.dumps(run["device"]["top"][:4]), flush=True)
    print(f"main path ({gpu}): " + json.dumps(
        {k: round(v, 3) for k, v in run["phases"].items()}), flush=True)
    print("stats: " + json.dumps(run["stats"]), flush=True)
    print(f"bitmap index: {json.dumps(run['bitmap'])}; "
          f"{run['checks']} checks bit-exact; launches {json.dumps(launches)}",
          flush=True)
    require_launches(launches, KERNELS, "main path")
    del prof
    gc.collect()
    torch.cuda.empty_cache()

    serve = serving_phase(gen, errs, gpu)
    gc.collect()
    torch.cuda.empty_cache()
    recovery = recovery_phase(gen, errs, gpu)
    per_path = {"main": launches, "serving": serve["launches"],
                "recovery": recovery["launches"]}
    total = {k: sum(p[k] for p in per_path.values()) for k in KERNELS}

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        tm = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": total[name],
                        "max_abs_err": errs[name], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"]})
    record.update(main_path=run, launches=per_path, kernels=kernels,
                  timing=timing, serving=serve, recovery=recovery)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
