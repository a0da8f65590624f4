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
4. Prints the ``kernels`` JSON line, then a last line
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero before the last line.  Without a
card, or without the rest of the repository beside it, it exits non-zero.
A fuller record goes to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

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
    idle = [k for k, n in launches.items() if n == 0]
    if idle:
        fail(f"main path never launched {idle}")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        tm = timing[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "ms": tm["ms"],
                        "plain_ms": tm["plain_ms"], "bound_ms": tm["bound_ms"],
                        "bound_by": tm["bound_by"],
                        "library_ms": tm["library_ms"]})
    record.update(main_path=run, launches=launches, kernels=kernels,
                  timing=timing)
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
