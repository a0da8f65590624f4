"""Checkpoints of tensor trees: atomic save, manifest, restore.

The JAX package's ``checkpoint/ckpt.py`` on the same on-disk layout, so
either package restores what the other wrote:

- ``<dir>/step_XXXXXXXX/arrays.npz``, one array per leaf keyed by its
  ``/``-joined path, and ``manifest.json`` (step, keys, tree structure);
- a tree is nested dicts, tuples and ``NamedTuple``s (a training
  loop saves ``(params, OptState)``); the path keys and the structure
  string are those ``jax.tree_util`` gives the JAX package: a dict key as
  it is (sorted), a tuple index as its number, a ``NamedTuple`` field as
  ``.name``;
- atomic: written to ``<dir>/tmp.<step>`` and then renamed, so a preempted
  job never sees a torn checkpoint;
- retention: the newest ``keep`` checkpoints stay;
- a bfloat16 leaf is stored as the JAX package's ``np.asarray`` stores it:
  two-byte void records (``|V2``) holding the bfloat16 bits, so the npz
  entry (key, dtype, bytes) is the JAX package's.  ``restore`` reads such
  an entry back as bfloat16 wherever the matching leaf of ``like`` is
  bfloat16; the JAX package's own ``restore`` cannot read it.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["save", "latest_step", "restore"]


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> "List[Tuple[str, Any]] | None":
    """A container's (path key, child) pairs in the JAX package's leaf
    order, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, tuple):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs, paths ``/``-joined."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [pair for key, child in kids
            for pair in _flatten(child, f"{prefix}/{key}" if prefix else key)]


def _rebuild(tree, fn: Callable[[str, Any], Any], prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree)
    new = [_rebuild(child, fn, f"{prefix}/{key}" if prefix else key)
           for key, child in kids]
    if isinstance(tree, dict):
        return dict(zip(sorted(tree), new))
    if _is_namedtuple(tree):
        return type(tree)(*new)
    return type(tree)(new)


def _treedef(tree) -> str:
    """The structure in the JAX package's ``PyTreeDef`` notation."""
    def walk(node) -> str:
        kids = _children(node)
        if kids is None:
            return "*"
        inner = ", ".join(walk(c) for _, c in kids)
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{k}': {walk(c)}"
                                   for k, c in kids) + "}"
        if _is_namedtuple(node):
            return (f"CustomNode(namedtuple[{type(node).__name__}], "
                    f"[{inner}])")
        return f"({inner},)" if len(kids) == 1 else f"({inner})"
    return f"PyTreeDef({walk(tree)})"


#: numpy's name for the records a bfloat16 leaf is stored as
BF16_RECORD = np.dtype("V2")


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16_RECORD)
        return leaf.numpy()
    return np.asarray(leaf)


def _tensor(a: np.ndarray, like_dtype) -> torch.Tensor:
    """An npz entry as a tensor: ``|V2`` records as bfloat16 where the
    matching leaf of ``like`` is bfloat16."""
    if a.dtype == BF16_RECORD:
        if like_dtype != torch.bfloat16:
            raise TypeError(f"a bfloat16 entry restores only into a bfloat16 "
                            f"leaf, not {like_dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save(ckpt_dir: "str | Path", step: int, tree: Any, keep: int = 3) -> Path:
    """Write ``tree`` (of tensors or arrays) as checkpoint
    ``step`` and drop all but the newest ``keep``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"tmp.{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    arrays = {k: _host(v) for k, v in _flatten(tree)}
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
            device: "torch.device | str | None" = None) -> Tuple[Any, int]:
    """Restore checkpoint ``step`` (default: the newest) into the structure
    of ``like``, as tensors on ``device`` (default: each ``like`` leaf's
    device, else the CPU).  Returns ``(tree, step)``."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    with np.load(ckpt_dir / f"step_{step:08d}" / "arrays.npz") as data:
        if {p for p, _ in _flatten(like)} != set(data.files):
            raise ValueError("checkpoint/model structure mismatch")

        def leaf(path: str, ref) -> torch.Tensor:
            dev = device if device is not None else getattr(ref, "device",
                                                            "cpu")
            return _tensor(data[path], getattr(ref, "dtype", None)).to(dev)

        tree = _rebuild(like, leaf)
    return tree, step
