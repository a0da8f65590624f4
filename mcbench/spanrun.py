"""Run one cell once, traced, and put its idle time down to program spans.

    python3 mcbench/spanrun.py --workload <name> --seed <n> --seconds <s>

The run is ``run.py --trace 1``'s: the harness's own set-up, warm-up,
window, profiler, ranges and judge.  What the harness's record does not
hold yet, this adds from the program's tracer (``repro_torch.obs.Tracer``):

- ``span_totals``: the tracer's running totals over the window (a
  difference of ``Tracer.totals`` read at the two anchors), and
  ``setup_span_totals``: from the session's start to the end of
  programming;
- ``idle_by_span`` and ``idle_by_label`` (:mod:`mcbench.spanclock`): the
  window's idle seconds per innermost program span, and per harness range
  split by program span;
- ``span_metrics``: five per-query and per-wordline numbers read from the
  totals (``SPAN_METRICS``);
- ``end_to_end``: the cell's end-to-end metrics of this traced run, read by
  the harness's own readers, for the tracing overhead against untraced
  ``run.py`` runs of the same seeds.

It prints one JSON line; ``--out`` also writes it to a file.  The harness's
files stay as they are: this module hooks the functions it needs to see
into (the cell, the span fold before it clears the tracer, programming,
the profiler's reduction) for its own process only.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from mcbench import devtrace, harness, spanclock  # noqa: E402

#: the harness ranges whose idle time a program span should cover
CALLS = ("mcbench.session.popcount", "mcbench.session.materialize_async",
         "mcbench.hostio.result", "mcbench.serve.poll",
         "mcbench.serve.result")


#: name -> (the totals it reads: "window" or "setup", category, total,
#: what it is per, unit scale of microseconds)
SPAN_METRICS = {
    "verify_ms_per_query.serve":
        ("window", "verify", "self_us", "requests", 1e-3),
    "account_ms_per_query.serve":
        ("window", "account", "self_us", "requests", 1e-3),
    "gather_ms_per_query.scan":
        ("window", "gather", "self_us", "queries", 1e-3),
    "drain_wait_ms_per_query.scan":
        ("window", "drain_wait", "us", "queries", 1e-3),
    "vth_draw_us_per_wordline.setup":
        ("setup", "program_draw", "self_us", "wordlines", 1.0),
}


def _count(rec: dict, per: str):
    """Requests of an open loop, queries of a closed one, or wordlines
    programmed; None where the cell has none."""
    if per == "requests":
        return rec.get("serve", {}).get("requests")
    if per == "queries":
        return rec["queries"] if rec["loop"] == "closed" else None
    return rec["program"]["wordlines"]


class _State:
    """What the hooks see during one run."""

    def __init__(self):
        self.spans = []              # program spans of the window
        self.armed = False
        self.anchors = None          # tracer clock at the window's ends
        self.totals = [None, None]   # Tracer.totals at the two anchors
        self.setup_totals = {}
        self.intervals = None        # (device ops, harness ranges)


@contextlib.contextmanager
def _hooked(state: _State):
    cell, fold, program = harness.Cell, harness.fold_spans, harness.program
    from_profiler = devtrace.from_profiler

    class SpanCell(cell):
        def measure(self, seconds, rate_per_s=None):
            loop, tracer = self.loop, self.sess.trace
            for name in ("closed", "open"):
                setattr(loop, name, _anchored(getattr(loop, name), tracer))
            return super().measure(seconds, rate_per_s)

    def _anchored(run, tracer):
        def anchored(*args, **kw):
            state.anchors = [tracer.now_us()]
            state.totals[0] = spanclock.totals(tracer)
            state.spans, state.armed = [], True
            out = run(*args, **kw)
            state.totals[1] = spanclock.totals(tracer)
            state.anchors.append(tracer.now_us())
            return out
        return anchored

    def fold_spans(tracer, acc):
        if state.armed:
            spanclock.collect(tracer, state.spans)
        fold(tracer, acc)

    def programmed(sess, *args, **kw):
        out = program(sess, *args, **kw)
        state.setup_totals = spanclock.totals(sess.trace)
        return out

    def profiled(prof):
        state.intervals = from_profiler(prof)
        return state.intervals

    harness.Cell, harness.fold_spans, harness.program = \
        SpanCell, fold_spans, programmed
    devtrace.from_profiler = profiled
    try:
        yield
    finally:
        harness.Cell, harness.fold_spans, harness.program = \
            cell, fold, program
        devtrace.from_profiler = from_profiler


def run(spec: dict, workload: str, seed: int, seconds: float, device,
        t0=None, **kw) -> dict:
    """One traced run of a cell; returns the line's object (``record``
    holds the harness's record)."""
    state = _State()
    with _hooked(state):
        res = harness.run_cell(spec, workload, seed, seconds, True, device,
                               t0=t0, **kw)
    rec = res["record"]
    window = spanclock.since(*state.totals) if state.totals[1] else {}
    line = {"cell": workload, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"],
            "end_to_end": {}, "per_layer": res["metrics"],
            "span_metrics": {}, "span_totals": window,
            "setup_span_totals": spanclock.since({}, state.setup_totals),
            "spans_dropped": rec["spans"].get("dropped", 0),
            "spans_collected": len(state.spans),
            "device": res["device"], "record": rec}
    for m in harness.cell_metrics(spec, workload, False):
        value = harness.read_metric(m["name"], rec)
        if value is not None:
            line["end_to_end"][m["name"]] = value
    for name, (which, cat, key, per, scale) in SPAN_METRICS.items():
        tot = (window if which == "window" else line["setup_span_totals"])
        n, got = _count(rec, per), tot.get(cat, {}).get(key)
        if n and got is not None:
            line["span_metrics"][name] = got / n * scale
    idle = (spanclock.idle_by_span(*state.intervals, state.spans,
                                   state.anchors)
            if state.intervals and state.anchors else None)
    if idle is not None:
        line["idle_by_span"] = idle["by_span"]
        line["idle_by_label"] = idle["by_label"]
        line["covered"] = {c: spanclock.covered_share(idle["by_label"], c)
                           for c in CALLS if c in idle["by_label"]}
    return line


def main(argv, t0) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", help="also write the line to this file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: no result", file=sys.stderr)
        return 3
    print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    line = run(harness.load_spec(), args.workload, args.seed, args.seconds,
               "cuda", t0=t0)
    line["record"].pop("serve", None)      # every latency: too long a line
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
