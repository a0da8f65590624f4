"""Dry run: every (arch x shape) cell on the production meshes, ahead of
time, on the ``meta`` device.

The JAX package's ``launch/dryrun.py`` AOT-lowers and compiles each cell
on 256 or 512 forced host devices and reads XLA's memory and cost
analyses.  The port has no compiler and no partitioner: a cell's bundle
(``train.step.aot_bundle``) runs its step function eagerly on ``meta``
tensors, which allocate nothing and compute nothing, under
``launch.cost_analysis.CostCounter``, on the CPU and with no card.  Per
cell it records:

- memory: the argument and output bytes one device holds, exact, from
  ``parallel.sharding.shard_shape`` over the bundle's spec trees (an
  output with no spec counts whole); the step's temporaries as the global
  peak of live meta bytes (one device running the whole step); and
  ``fits_80GiB``, judged on the arguments per device plus that peak split
  evenly over the chips, against the 80 GiB of one H100;
- the counter's FLOPs and bytes of the global step, and its roofline
  with those split evenly over the chips (no collective is counted: there
  is no partitioner);
- the model FLOPs, 6·N·D for training and 2·N·D for inference, N the
  non-embedding parameters with only the active share of MoE experts.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
        --shape train_4k --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

A cell that cannot run prints ``[FAIL]`` with its traceback, and ``main``
then exits 1.  Records go to ``build/dryrun_torch/<cell>.json``.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import REGISTRY, SHAPES, get_config, shapes_for
from repro_torch.launch import cost_analysis
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import lm
from repro_torch.models.specs import count_params
from repro_torch.parallel.sharding import shard_shape
from repro_torch.train import step as step_lib

__all__ = ["ARTIFACT_DIR", "model_flops", "run_cell", "all_cells", "main"]

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference) with N = non-embedding params."""
    n = count_params(lm.build_specs(cfg)) - cfg.vocab * cfg.d_model
    if cfg.n_experts > 0:
        # active fraction of expert weights
        expert_params = cfg.repeats * cfg.n_experts * 3 * cfg.d_model \
            * cfg.d_ff
        n = n - expert_params + cfg.top_k / cfg.n_experts * expert_params
    if shape.step == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.step == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def tree_bytes(tree, specs, mesh: Mesh, per_device: bool = True) -> int:
    """The bytes of ``tree``'s tensors, per device under the partition
    specs ``specs`` (a tree of the same structure; ``None`` for a subtree
    that is held whole), or globally."""
    if isinstance(tree, torch.Tensor):
        dims = tree.shape
        if per_device and specs is not None:
            dims = shard_shape(dims, specs, mesh)
        return math.prod(dims) * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v, None if specs is None else specs[k], mesh,
                              per_device) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v, None if specs is None else s, mesh,
                              per_device)
                   for v, s in zip(tree, specs if specs is not None
                                   else [None] * len(tree)))
    return 0


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = ARTIFACT_DIR, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = f"{arch}__{shape_name}__{_mesh_name(multi_pod)}"
    chips = mesh.size
    t0 = time.time()
    bundle = step_lib.aot_bundle(cfg, shape, mesh)
    out, cost = cost_analysis.count_cost(bundle["fn"], *bundle["args"])
    dt = time.time() - t0

    arg_dev = tree_bytes(bundle["args"], bundle["in_shardings"], mesh)
    arg_all = tree_bytes(bundle["args"], None, mesh, per_device=False)
    mem = {
        "argument_bytes_per_device": arg_dev,
        "output_bytes_per_device": tree_bytes(out, bundle["out_shardings"],
                                              mesh),
        "argument_bytes_global": arg_all,
        "output_bytes_global": tree_bytes(out, None, mesh, per_device=False),
        "temp_bytes_global": cost.peak_live_bytes,
    }
    # the temporaries split evenly over the chips: what a partitioner
    # that shards every activation would leave each device
    peak = arg_dev + cost.peak_live_bytes / chips
    roof = cost_analysis.roofline(cost, chips)
    mflops = model_flops(cfg, shape)
    record = {
        "cell": cell, "arch": arch, "shape": shape_name,
        "mesh": _mesh_name(multi_pod), "chips": chips, "step": shape.step,
        "microbatches": bundle.get("microbatches"),
        "run_s": round(dt, 1),
        "memory": mem,
        "peak_bytes_per_device_temps_split_evenly": peak,
        "fits_80GiB": bool(peak < cost_analysis.H100_MEMORY_BYTES),
        "unsharded_peak_bytes": arg_all + cost.peak_live_bytes,
        "flops_global": cost.flops,
        "product_flops_global": cost.product_flops,
        "bytes_global": cost.bytes,
        "aten_ops": cost.ops,
        "roofline_even_split": roof.to_dict(),
        "model_flops_global": mflops,
        "model_flops_per_device": mflops / chips,
        "useful_compute_ratio": mflops / max(cost.flops, 1.0),
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(record, indent=1))
    if verbose:
        print(f"[OK] {cell}: run {dt:.0f}s  peak/dev (temps split evenly) "
              f"{peak / 2 ** 30:.2f} GiB  flops {cost.flops:.3e}  bytes "
              f"{cost.bytes:.3e} (global)  temps {cost.peak_live_bytes / 2 ** 30:.1f}"
              f" GiB (global)  bottleneck={roof.bottleneck}", flush=True)
    return record


def all_cells() -> list:
    return [(arch, shape_name) for arch, cfg in REGISTRY.items()
            for shape_name in shapes_for(cfg)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        cells = all_cells()
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = []
    for arch, shape_name in cells:
        for multi in meshes:
            path = ARTIFACT_DIR / f"{arch}__{shape_name}__{_mesh_name(multi)}.json"
            if args.skip_existing and path.exists():
                print(f"[skip] {path.name}", flush=True)
                continue
            try:
                run_cell(arch, shape_name, multi)
            except Exception as e:  # record and continue: failures are bugs
                failures.append((arch, shape_name, multi, repr(e)))
                print(f"[FAIL] {arch} {shape_name} multi={multi}: {e}",
                      flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nAll dry-run cells ran on the meta device.")


if __name__ == "__main__":
    main()
