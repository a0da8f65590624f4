"""The control of ``correct``: every cell of a configuration run with the
program's own wear path switched on and its recovery ladder off.

    python3 mcbench/control.py --config fig10-bitmap-mlc --seeds 11,12,13 \\
        --seconds 4 [--faults pe=10000,retention_hours=5000]

The configurations state fresh blocks (no wear, no faults) and exact
answers; programmed at 10k P/E cycles and 5000 h of retention (the
program's own fault path, ``REPRO_FAULTS`` syntax) without the ladder, that
guarantee is broken, and the run's compared numbers must come out above
their limits.  It prints one JSON line
per (cell, seed) with those numbers.  No run of the benchmark calls it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv) -> int:
    from mcbench import harness

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--faults", default="pe=10000,retention_hours=5000")
    args = ap.parse_args(argv)
    spec = harness.load_spec()
    cells = [w["name"] for w in spec["workloads"]
             if w["config"] == args.config]
    for seed in (int(s) for s in args.seeds.split(",")):
        for cell in cells:
            t = time.perf_counter()
            res = harness.run_cell(
                spec, cell, seed, args.seconds, False, "cuda",
                faults=f"{args.faults},seed={seed % 2 ** 31}")
            print(json.dumps({"cell": cell, "seed": seed,
                              "faults": args.faults,
                              "correct": res["correct"],
                              "attempted": res["attempted"],
                              "checks": res["checks"],
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
