"""One run of one benchmark cell: set up, warm up, measure, judge, report.

``run_cell`` does the work on any torch device, so the tests drive it on
the CPU at a tiny size; ``main`` is the command line, which runs on the card
only and prints the result line.  Everything a cell needs is found by name
in ``BENCHMARK.json``: its configuration file (``configs/``), its traffic
mix (``traffic/``, read by :mod:`mcbench.loadgen`), the mix's query kind
(``queries/<kind>.py``) and one reader per metric (``metrics/<metric>.py``,
a ``read(record)`` that returns a number or None).  The program under test
is ``repro_torch``, imported only here.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from collections import deque
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mcbench import data, devtrace, loadgen, queries, roofline
from mcbench.reference import Reference

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: an open loop waits this long past the window's close for late answers
DRAIN_GRACE_S = 60.0
#: the session tracer's spans are folded and cleared past this many
SPAN_CHUNK = 100_000


# -- the benchmark's files -----------------------------------------------------

def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_files(spec: dict, workload: str):
    """(workload entry, configuration, traffic mix) of a cell."""
    wl = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{[w['name'] for w in spec['workloads']]}")
    entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    cfg = json.loads((ROOT / entry["file"]).read_text())
    return wl, cfg, loadgen.load_mix(wl["traffic"])


def cell_metrics(spec: dict, workload: str, trace: bool) -> List[dict]:
    """The metrics a cell reports: end-to-end untraced, per-layer traced."""
    group = spec["per_layer" if trace else "end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def read_metric(name: str, record: dict) -> Optional[float]:
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "mcbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    value = mod.read(record)
    return None if value is None else float(value)


def forbidden_modules() -> List[str]:
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# -- the program ----------------------------------------------------------------

def open_session(cfg: dict, seed: int, device, trace: bool,
                 faults: Optional[str] = None):
    """A session as the configuration states it; ``faults`` (a
    ``REPRO_FAULTS`` spec) switches the program's wear path on, with its
    recovery ladder off: the control."""
    from repro_torch.api.session import ComputeSession
    from repro_torch.flash.geometry import SSDConfig

    wear = ({"faults": faults, "recovery": "off"} if faults
            else {"faults": cfg["guarantees"]["faults"]})
    return ComputeSession(device=device, config=SSDConfig(**cfg["ssd"]),
                          seed=int(seed) % data.SEED_MOD,
                          encoding=cfg["encoding"], trace=trace,
                          verify=cfg["guarantees"]["verify"], **wear)


def program(sess, cfg: dict, seed: int, device, sync: Callable) -> dict:
    """Write every group through the session (``write_pair`` or
    ``write_triple``, group ``i`` on die ``i``); the host clock runs around
    the writes alone, each ending in a synchronize."""
    page_bits = sess.ftl.cfg.page_bits
    write = {2: sess.write_pair, 3: sess.write_triple}
    wordlines, seconds = 0, 0.0
    for i, names, bits in data.group_bits(cfg, seed, device):
        args = [x for name, col in zip(names, bits) for x in (name, col)]
        sync()
        t = time.perf_counter()
        write[len(names)](*args, die=i)
        sync()
        seconds += time.perf_counter() - t
        wordlines += -(-int(cfg["users"]) // page_bits)
        del bits, args
    return {"wordlines": wordlines, "seconds": seconds}


# -- spans of the session tracer --------------------------------------------------

def fold_spans(tracer, acc: dict) -> None:
    """Add the tracer's ``lower`` self time (less the FTL spans inside it),
    its ``dispatch`` time and its FTL (copyback realignment) time to
    ``acc`` and clear the tracer, so its span cap never drops one."""
    if tracer is None:
        return
    ftl = sorted((s.start_us, s.end_us) for s in tracer.wall_spans
                 if s.category == "ftl")
    starts = [s for s, _ in ftl]
    for s in tracer.wall_spans:
        if s.category == "dispatch":
            acc["dispatch_us"] = acc.get("dispatch_us", 0.0) + s.dur_us
        if s.category != "lower":
            continue
        inner = 0.0
        for fs, fe in ftl[bisect.bisect_left(starts, s.start_us):]:
            if fs >= s.end_us:
                break
            inner += min(fe, s.end_us) - fs
        acc["lower_us"] = acc.get("lower_us", 0.0) + s.dur_us - inner
        acc["lower_spans"] = acc.get("lower_spans", 0) + 1
    acc["ftl_spans"] = acc.get("ftl_spans", 0) + len(ftl)
    acc["ftl_us"] = acc.get("ftl_us", 0.0) + sum(
        e - s for s, e in devtrace.union(ftl))
    acc["dropped"] = acc.get("dropped", 0) + tracer.dropped
    tracer.clear()


def _spans_full(tracer) -> bool:
    return tracer is not None and \
        len(tracer.wall_spans) + len(tracer.device_spans) > SPAN_CHUNK


# -- the loops ---------------------------------------------------------------------

class Loop:
    """The client side of a window: the session, the traffic and, in a
    traced run, the profiler's labels."""

    def __init__(self, sess, cfg: dict, mix: dict, traced: bool):
        self.sess, self.cfg, self.mix = sess, cfg, mix
        self.kind = queries.kind(mix["query"])
        self.counts = self.kind.RESULT == "count"
        self.traced = traced
        self.spans: dict = {}

    def label(self, what: str):
        """A host range of the traced run's profiler (never nested)."""
        if not self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function(devtrace.PREFIX + what)

    def roots(self, query) -> list:
        with self.label("build"):
            return self.kind.roots(self.sess, query, self.cfg)

    def ask(self, query) -> list:
        """One query answered on the host before it returns (one client):
        each root's count, or its words."""
        exprs = self.roots(query)
        if self.counts:
            with self.label("session.popcount"):
                return [self.sess.popcount(e) for e in exprs]
        with self.label("session.materialize_async"):
            handles = [self.sess.materialize_async(e) for e in exprs]
        return self.collect(handles)

    def send(self, query) -> list:
        """One query sent without waiting for it (several clients): its
        drain handles, one a root.  Counts go through
        ``materialize_batch_async``, since ``popcount`` waits."""
        exprs = self.roots(query)
        if self.counts:
            with self.label("session.materialize_batch_async"):
                return self.sess.materialize_batch_async(
                    exprs, popcount=[True] * len(exprs))
        with self.label("session.materialize_async"):
            return [self.sess.materialize_async(e) for e in exprs]

    def collect(self, handles) -> list:
        with self.label("hostio.result"):
            got = [h.result() for h in handles]
        return [int(g) for g in got] if self.counts else got

    def tally(self, acc: dict, query, got: list) -> None:
        """Add one completed query to the window's totals."""
        acc["queries"] += 1
        acc["operand_bits"] += self.kind.operand_bits(query, self.cfg)
        need = self.kind.bytes_needed(query, self.cfg)
        acc["bytes_needed"] = None if need is None or \
            acc["bytes_needed"] is None else acc["bytes_needed"] + need
        acc["result_bytes"] += sum(
            roofline.COUNT_BYTES if self.counts else np.asarray(g).nbytes
            for g in got)

    def closed(self, seed: int, seconds: float) -> dict:
        """``clients`` clients, each with its own query stream: a client's
        next query goes out when its last has come back, until the
        window's time is up; queries still in flight then are waited for
        and counted, the window running on until the last."""
        n = int(self.mix.get("clients", 1))
        streams = [loadgen.queries(self.mix, self.cfg, seed, c)
                   for c in range(n)]
        sample_k = int(self.mix.get("sample_answers", 0))
        rng = np.random.default_rng([int(seed) % data.SEED_MOD, 3])
        kept: list = []
        acc = _totals()

        def done(q, got):
            if not sample_k or acc["queries"] < sample_k:
                kept.append((q, got))
            else:                        # a reservoir sample of the answers
                j = int(rng.integers(0, acc["queries"] + 1))
                if j < sample_k:
                    kept[j] = (q, got)
            self.tally(acc, q, got)
            if _spans_full(self.sess.trace):
                fold_spans(self.sess.trace, self.spans)

        t0 = time.perf_counter()
        if n == 1:
            while True:
                q = next(streams[0])
                done(q, self.ask(q))
                if time.perf_counter() - t0 >= seconds:
                    break
        else:
            inflight: deque = deque()
            for c in range(n):
                q = next(streams[c])
                inflight.append((c, q, self.send(q)))
            while inflight:
                c, q, handles = inflight.popleft()
                done(q, self.collect(handles))
                if time.perf_counter() - t0 < seconds:
                    q = next(streams[c])
                    inflight.append((c, q, self.send(q)))
        return {"window_s": time.perf_counter() - t0,
                "attempted": acc["queries"], "answers": kept, **acc}

    def open(self, seed: int, seconds: float,
             rate_per_s: Optional[float] = None) -> dict:
        """Requests go out at their due times, whatever is in flight; each
        request's roots are submitted together and ``poll()`` runs in a
        busy loop.  Requests due in the window are waited for up to a
        minute past its close."""
        from repro_torch.serve import QueryEngine

        plan = loadgen.schedule(self.mix, self.cfg, seed, seconds, rate_per_s)
        n = len(plan)
        eng = QueryEngine(self.sess)
        tickets: List[list] = [None] * n
        dispatched = [None] * n
        done_at = [None] * n
        answers = [None] * n
        waiting: List[int] = []               # submitted, not all dispatched
        inflight: Dict[int, list] = {}
        late = 0.0
        nxt = 0
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            while nxt < n and plan[nxt][0] <= now:
                late = max(late, now - plan[nxt][0])
                exprs = self.roots(plan[nxt][1])
                with self.label("serve.submit"):
                    tickets[nxt] = [eng.submit(e, popcount=self.counts)
                                    for e in exprs]
                inflight[nxt] = tickets[nxt]
                waiting.append(nxt)
                nxt += 1
            if eng.metrics["queue_depth"].value:
                with self.label("serve.poll"):
                    eng.poll()
            # an empty queue's poll returns at once: no range, so a traced
            # run's busy loop adds no events while it waits
            now = time.perf_counter() - t0
            if waiting:
                still = []
                for i in waiting:
                    if all(t.dispatched for t in tickets[i]):
                        dispatched[i] = now
                    else:
                        still.append(i)
                waiting = still
            if inflight:
                ready = [i for i, ts in inflight.items()
                         if all(t.done for t in ts)]
                for i in ready:
                    with self.label("serve.result"):
                        answers[i] = [t.result() for t in inflight.pop(i)]
                    done_at[i] = time.perf_counter() - t0
            if _spans_full(self.sess.trace):
                fold_spans(self.sess.trace, self.spans)
            if nxt >= n and not inflight:
                break
            if now > seconds + DRAIN_GRACE_S:
                break
        window_s = time.perf_counter() - t0
        st = eng.stats()
        done = [i for i in range(n) if done_at[i] is not None]
        acc = _totals()
        for i in done:
            self.tally(acc, plan[i][1], answers[i])
        return {
            "window_s": window_s, "attempted": n, **acc,
            "answers": [(plan[i][1], answers[i]) for i in done],
            "missing": n - len(done),
            "serve": {
                "requests": n,
                "latencies_ms": [1e3 * (done_at[i] - plan[i][0])
                                 for i in done],
                "queue_waits_ms": [1e3 * (dispatched[i] - plan[i][0])
                                   for i in range(n)
                                   if dispatched[i] is not None],
                "tickets_completed": st["requests_completed"],
                "batches": st["batches_dispatched"],
                "late_s": late,
            },
        }


def _totals() -> dict:
    return {"queries": 0, "operand_bits": 0, "bytes_needed": 0,
            "result_bytes": 0}


def warm_up(loop: Loop) -> None:
    """Every distinct query of the mix once, down the path the window
    takes (kernels built, runners and plan verdicts cached); an open
    loop's also all at once, as a burst."""
    qs = loadgen.distinct_queries(loop.mix, loop.cfg)
    if loop.mix["loop"] == "closed":
        several = int(loop.mix.get("clients", 1)) > 1
        for q in qs:
            if several:
                loop.collect(loop.send(q))
            else:
                loop.ask(q)
        return
    from repro_torch.serve import QueryEngine

    eng = QueryEngine(loop.sess)
    for q in qs:
        eng.drain([eng.submit(e, popcount=loop.counts)
                   for e in loop.kind.roots(loop.sess, q, loop.cfg)])
    eng.drain([t for q in qs for t in (
        eng.submit(e, popcount=loop.counts)
        for e in loop.kind.roots(loop.sess, q, loop.cfg))])


# -- judging -------------------------------------------------------------------------

def judge(out: dict, ref: Reference, kind) -> Dict[str, Dict[str, int]]:
    """Every kept answer against the reference, root by root: numbers and
    their limits (all exact, so every limit is 0)."""
    words = kind.RESULT == "words"
    wrong = wrong_words = 0
    for q, got in out["answers"]:
        want = ref.answer(q)
        if not words:
            wrong += [int(g) for g in got] != list(want)
            continue
        bad = 0 if len(got) == len(want) else sum(w.numel() for w in want)
        for g, w in zip(got, want):
            g = torch.from_numpy(np.asarray(g).view(np.int32).copy())
            bad += w.numel() if g.shape != w.shape else \
                int((g.to(w.device) != w).sum())
        wrong_words += bad
        wrong += bad > 0
    checks = {"wrong_answers": {"value": int(wrong), "limit": 0},
              "missing_answers": {"value": int(out.get("missing", 0)),
                                  "limit": 0}}
    if words:
        checks["wrong_words"] = {"value": int(wrong_words), "limit": 0}
    return checks


# -- one run ---------------------------------------------------------------------------

class Cell:
    """A cell set up and warmed: the session holds the configuration's
    data, every distinct query of the mix has run once."""

    def __init__(self, spec: dict, workload: str, seed: int, trace: bool,
                 device, *, faults: Optional[str] = None,
                 cfg_override: Optional[dict] = None,
                 mix_override: Optional[dict] = None):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.sync = torch.cuda.synchronize if self.on_card else (lambda: None)
        self.wl, cfg, self.mix = cell_files(spec, workload)
        self.cfg = {**cfg, **(cfg_override or {})}
        if mix_override:
            self.mix = loadgen.check_mix({**self.mix, **mix_override})
        self.seed, self.trace = seed, trace
        t = time.perf_counter()
        self.sess = open_session(self.cfg, seed, self.device, trace, faults)
        self.program = program(self.sess, self.cfg, seed, self.device,
                               self.sync)
        self.program["write_s"] = time.perf_counter() - t
        self.loop = Loop(self.sess, self.cfg, self.mix, trace)
        t = time.perf_counter()
        warm_up(self.loop)
        self.sync()
        self.program["warm_up_s"] = time.perf_counter() - t

    def measure(self, seconds: float,
                rate_per_s: Optional[float] = None) -> dict:
        """One measured window from a clean slate of counters; with
        tracing, under ``torch.profiler``.  Returns the loop's output, with
        the profiler's summary under ``device``."""
        sess, loop = self.sess, self.loop
        sess.reset_stats()
        fold_spans(sess.trace, {})
        loop.spans = {}
        gc.collect()
        gc.freeze()
        self.sync()
        prof = None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if self.on_card else [])
            prof = profile(activities=acts)
            prof.__enter__()
        with loop.label("window"):
            if self.mix["loop"] == "closed":
                out = loop.closed(self.seed, seconds)
            else:
                out = loop.open(self.seed, seconds, rate_per_s)
            self.sync()
        if prof is not None:
            prof.__exit__(None, None, None)
            out["device"] = devtrace.summarize(*devtrace.from_profiler(prof))
        fold_spans(sess.trace, loop.spans)
        gc.unfreeze()
        return out

    def record(self, out: dict, setup_s: float) -> dict:
        """What the metric readers read."""
        sess, mix = self.sess, self.mix
        rec = {"cell": self.wl["name"], "loop": mix["loop"],
               "setup_s": setup_s, "program": self.program,
               **{k: v for k, v in out.items() if k != "answers"},
               "makespan_us": sess.ledger.makespan_us(),
               "counters": {k: getattr(sess, k) for k in (
                   "sense_waves", "sense_batches", "megakernel_calls",
                   "coalesced_sense_groups", "waves_shared",
                   "host_drain_submits")},
               "spans": dict(self.loop.spans)}
        return rec

    def close(self) -> None:
        """Free the program's state, so the reference finds the card empty."""
        del self.loop, self.sess
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, *, t0: Optional[float] = None,
             faults: Optional[str] = None, cfg_override: Optional[dict] = None,
             mix_override: Optional[dict] = None,
             rate_per_s: Optional[float] = None) -> dict:
    """Set up, warm up, measure and judge one cell; returns the result
    object (the last line's keys) with the run's record under ``record``."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(spec, workload, seed, trace, device, faults=faults,
                cfg_override=cfg_override, mix_override=mix_override)
    setup_s = time.perf_counter() - t0
    out = cell.measure(seconds, rate_per_s)
    record = cell.record(out, setup_s)
    peak = torch.cuda.max_memory_allocated(cell.device) if cell.on_card else 0
    if cell.on_card:
        record["memory_reserved_peak_bytes"] = \
            torch.cuda.max_memory_reserved(cell.device)
    cell.close()
    checks = judge(out, Reference(cell.cfg, seed, cell.device),
                   queries.kind(cell.mix["query"]))
    del out["answers"]
    correct = all(c["value"] <= c["limit"] for c in checks.values()) \
        and out["attempted"] > 0

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        value = read_metric(m["name"], record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cell.on_card else cell.device.type,
           "kind": (torch.cuda.get_device_name(cell.device) if cell.on_card
                    else "cpu"),
           "count": int(cell.wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(checks["wrong_answers"]["value"]
                            + checks["missing_answers"]["value"]),
              "metrics": metrics, "device": dev}
    if trace and record.get("device"):
        dev["busy_s"] = record["device"]["busy_s"]
        dev["window_s"] = record["device"]["window_s"]
        result["breakdown"] = {k: record["device"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = checks
    result["record"] = record
    return result


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    wl = next((w for w in spec["workloads"] if w["name"] == args.workload),
              None)
    if wl is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"{args.workload} needs {wl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr, flush=True)
    res = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", t0=t0)
    rec = res.pop("record")
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: no result", file=sys.stderr)
        return 4
    print("record: " + json.dumps({k: v for k, v in rec.items()
                                   if k != "serve"}), file=sys.stderr)
    if "serve" in rec:
        s = rec["serve"]
        print(f"serve: {s['requests']} requests, {s['tickets_completed']} "
              f"tickets in {s['batches']} batches, generator late by at most "
              f"{s['late_s'] * 1e3:.3f} ms", file=sys.stderr)
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0
