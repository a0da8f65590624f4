"""Checkpoints of nested-dict tensor trees: atomic save, manifest, restore.

The JAX package's ``checkpoint/ckpt.py`` on the same on-disk layout, so
either package restores what the other wrote:

- ``<dir>/step_XXXXXXXX/arrays.npz``, one array per leaf keyed by its
  ``/``-joined path, and ``manifest.json`` (step, keys, tree structure);
- atomic: written to ``<dir>/tmp.<step>`` and then renamed, so a preempted
  job never sees a torn checkpoint;
- retention: the newest ``keep`` checkpoints stay.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.models.specs import flatten, map_with_path

__all__ = ["save", "latest_step", "restore"]


def _treedef(tree) -> str:
    """The structure in the JAX package's ``PyTreeDef`` notation."""
    def walk(node) -> str:
        if not isinstance(node, dict):
            return "*"
        return "{" + ", ".join(f"'{k}': {walk(node[k])}"
                               for k in sorted(node)) + "}"
    return f"PyTreeDef({walk(tree)})"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: "str | Path", step: int, tree: Any, keep: int = 3) -> Path:
    """Write ``tree`` (a nested dict of tensors or arrays) as checkpoint
    ``step`` and drop all but the newest ``keep``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {k: _host(v) for k, v in flatten(tree)}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps({
        "step": step, "keys": sorted(arrays), "treedef": _treedef(tree)}))
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    ckpts = sorted(d for d in ckpt_dir.iterdir() if d.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)
    return final


def latest_step(ckpt_dir: "str | Path") -> "int | None":
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    ckpts = sorted(d.name for d in ckpt_dir.iterdir()
                   if d.name.startswith("step_"))
    return int(ckpts[-1].split("_")[1]) if ckpts else None


def restore(ckpt_dir: "str | Path", like: Any, step: "int | None" = None,
            device: "torch.device | str | None" = None) -> Tuple[dict, int]:
    """Restore checkpoint ``step`` (default: the newest) into the structure
    of ``like``, as tensors on ``device`` (default: each ``like`` leaf's
    device, else the CPU).  Returns ``(tree, step)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz") as data:
        flat_like = flatten(like)
        if {p for p, _ in flat_like} != set(data.files):
            raise ValueError("checkpoint/model structure mismatch")

        def leaf(path: str, ref) -> torch.Tensor:
            dev = device if device is not None else getattr(ref, "device",
                                                            "cpu")
            return torch.from_numpy(data[path]).to(dev)

        tree = map_with_path(leaf, like)
    return tree, step
