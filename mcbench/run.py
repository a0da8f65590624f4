"""Run one benchmark cell once on the card and print its result line.

    python3 mcbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

With no card, or fewer cards than the cell asks for, it exits non-zero and
prints no result.
"""
import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

if __name__ == "__main__":
    from mcbench.harness import main
    sys.exit(main(sys.argv[1:], T0))
