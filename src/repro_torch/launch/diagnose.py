"""Per-op cost breakdown of one dry-run cell: the top aten ops by FLOPs and
by bytes, from the dry run's counter (``launch/cost_analysis.py``).

The JAX package's ``launch/diagnose.py`` walks compiled HLO for its top
collectives and HBM-traffic contributors; the port's step runs eagerly on
``meta`` tensors, with no collective, so the breakdown is by op.  Each
entry is keyed by the aten op and its first output's shape, summed over
every call (loops run every iteration: no trip counts).

    PYTHONPATH=src python -m repro_torch.launch.diagnose --arch mixtral-8x7b \\
        --shape train_4k [--multi-pod]
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.train import step as step_lib

__all__ = ["breakdown", "main"]


def breakdown(cost: "cost_analysis.Cost", top: int = 14) -> dict:
    """Print (and return) the ``top`` ops by FLOPs and by bytes of a
    counted step: ``{"flops": [(op, shape, n)], "bytes": [...]}``."""
    res = {}
    for name, counter in (("flops", cost.flops_by_op),
                          ("bytes", cost.bytes_by_op)):
        rows = [(op, shape, n) for (op, shape), n
                in counter.most_common(top)]
        res[name] = rows
        print(f"== top {name} (global per step) ==")
        for op, shape, n in rows:
            print(f"  {n:.3e}  {op:28s} {shape}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    b = step_lib.aot_bundle(get_config(args.arch), SHAPES[args.shape], mesh)
    _, cost = cost_analysis.count_cost(b["fn"], *b["args"])
    r = cost_analysis.roofline(cost, mesh.size)
    print(f"{args.arch} {args.shape}: compute {r.compute_s:.3f}s  memory "
          f"{r.memory_s:.3f}s per device (even split over {mesh.size})")
    breakdown(cost)


if __name__ == "__main__":
    main()
