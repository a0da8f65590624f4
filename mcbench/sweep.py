"""Find the knee of an open-loop cell once: the highest offered rate at
which the backlog does not grow over the window.

    python3 mcbench/sweep.py --workload ambit-weekly-steady --seed 7 \\
        --seconds 8 --rates 25,50,100,200

One set-up, then one window per rate, in the order given.  For each rate it
prints the requests offered and completed, p50 and p95, the p95 of the
window's first and second halves (by due time) and how long the last
requests took to drain after the close: a backlog that grows shows as a
second half far slower than the first and a drain that grows with the
window.  A tool for defining a cell; no run of the benchmark calls it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def p(xs, q):
    import numpy as np
    return float(np.percentile(xs, q)) if len(xs) else None


def main(argv) -> int:
    from mcbench import harness
    from mcbench.reference import Reference

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cell = harness.Cell(spec, args.workload, args.seed, False, "cuda")
    print(f"set-up {time.perf_counter() - T0:.3f} s", file=sys.stderr)
    ref = Reference(cell.cfg, args.seed, cell.device)
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        out = cell.measure(args.seconds, rate)
        lat = out["serve"]["latencies_ms"]
        half = len(lat) // 2
        checks = harness.judge(out, ref, cell.loop.kind)
        row = {"rate_per_s": rate, "offered": out["attempted"],
               "completed": out["queries"], "p50_ms": p(lat, 50),
               "p95_ms": p(lat, 95), "p95_first_half_ms": p(lat[:half], 95),
               "p95_second_half_ms": p(lat[half:], 95),
               "drain_after_close_s": out["window_s"] - args.seconds,
               "late_s": out["serve"]["late_s"],
               "requests_per_batch": (out["serve"]["tickets_completed"]
                                      / max(1, out["serve"]["batches"])),
               "wrong": checks["wrong_answers"]["value"],
               "missing": checks["missing_answers"]["value"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"sweep": args.workload, "seed": args.seed,
                      "seconds": args.seconds, "card": harness.card_line(),
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
