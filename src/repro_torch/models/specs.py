"""Parameter specs: shape, logical axes and initializer of every parameter.

A model definition builds a nested dict of :class:`ParamSpec`; from it the
port materializes parameters (:func:`init_tree`) and counts them.  The
trees are plain nested dicts of tensors, keyed as the JAX package's
parameter pytrees are, so :func:`params_from_jax` carries the JAX
package's parameters (as numpy arrays) across leaf for leaf and
:func:`params_to_numpy` carries them back.  :func:`partition_specs_tree`
resolves every parameter's logical axes on a mesh descriptor, and
:func:`shardings_tree` (the JAX package's tree of ``NamedSharding``s) gives
the same specs.
:func:`abstract_tree` is the AOT view of a spec tree: tensors on the
``meta`` device, with shapes and dtypes and no storage.

Initial values come from one ``torch.Generator`` per leaf, seeded from
``(seed, leaf index)`` in sorted-key order: they match the JAX package's
in distribution, not in value (``jax.random`` bits cannot be replayed).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

__all__ = ["ParamSpec", "init_param", "init_tree", "keyed_generator",
           "stacked", "count_params", "flatten", "map_with_path", "tree_map",
           "params_from_jax", "params_to_numpy", "partition_specs_tree",
           "abstract_tree", "shardings_tree"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[str | None, ...]       # logical axis names, len == ndim
    init: str = "normal"               # normal | zeros | ones | scaled
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError((self.shape, self.axes))


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def flatten(tree, is_leaf: Callable[[Any], bool] = None) -> List[Tuple[str, Any]]:
    """``("a/b/c", leaf)`` pairs of a nested dict, keys sorted at every
    level (the JAX package's pytree order and checkpoint key format)."""
    is_leaf = is_leaf or (lambda x: not isinstance(x, dict))

    def walk(node, prefix: str) -> Iterator[Tuple[str, Any]]:
        if is_leaf(node):
            yield prefix, node
            return
        for key in sorted(node):
            yield from walk(node[key], f"{prefix}/{key}" if prefix else str(key))

    return list(walk(tree, ""))


def map_with_path(fn: Callable[[str, Any], Any], tree, is_leaf=None):
    """``fn(path, leaf)`` over a nested dict's leaves, paths ``/``-joined;
    the structure is kept (empty dicts too, as in a JAX pytree)."""
    is_leaf = is_leaf or (lambda x: not isinstance(x, dict))

    def walk(node, path: str):
        if is_leaf(node):
            return fn(path, node)
        return {k: walk(v, f"{path}/{k}" if path else str(k))
                for k, v in node.items()}

    return walk(tree, "")


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of equally structured nested dicts (empty
    dicts are kept, as in a JAX pytree)."""
    is_leaf = is_leaf or (lambda x: not isinstance(x, dict))
    if is_leaf(tree):
        return fn(tree, *rest)
    if any(not isinstance(r, dict) or r.keys() != tree.keys() for r in rest):
        raise ValueError("trees differ in structure")
    return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
            for k, v in tree.items()}


def keyed_generator(seed: int, index: int,
                    device: "torch.device | str") -> torch.Generator:
    """An independent stream per ``(seed, index)`` (a parameter leaf, a
    data step): a generator seeded with splitmix64 of the pair."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(index) + 1) & (2 ** 64 - 1)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2 ** 64 - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2 ** 64 - 1)
    gen = torch.Generator(device=device)
    gen.manual_seed((z ^ (z >> 31)) & (2 ** 63 - 1))
    return gen


def init_param(gen: torch.Generator, spec: ParamSpec,
               device: "torch.device | str") -> torch.Tensor:
    """One parameter on ``device``, drawn from ``gen``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = spec.scale / math.sqrt(max(fan_in, 1))
    elif spec.init == "scaled":              # plain N(0, scale)
        std = spec.scale
    else:
        raise ValueError(spec.init)
    x = torch.randn(spec.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(spec.dtype)


def init_tree(seed: int, specs, device: "torch.device | str") -> dict:
    """Materialize a spec tree into parameters on ``device``, one generator
    per leaf seeded from ``(seed, leaf index)``."""
    device = torch.device(device)
    index = {path: i for i, (path, _) in enumerate(flatten(specs, _is_spec))}
    return map_with_path(
        lambda path, spec: init_param(keyed_generator(seed, index[path],
                                                      device), spec, device),
        specs, _is_spec)


def count_params(specs) -> int:
    return int(sum(np.prod(s.shape) for _, s in flatten(specs, _is_spec)))


def partition_specs_tree(specs, mesh, rules=None) -> dict:
    """Each parameter's per-dimension mesh-axis assignment on ``mesh`` (a
    :class:`~repro_torch.launch.mesh.Mesh`), as the JAX package's
    ``PartitionSpec`` holds it (``parallel.sharding.resolve_spec``)."""
    # imported here: parallel/ imports this module's tree helpers
    from repro_torch.parallel.sharding import resolve_spec

    return tree_map(lambda s: resolve_spec(s.shape, s.axes, mesh, rules),
                    specs, is_leaf=_is_spec)


def abstract_tree(specs) -> dict:
    """Every parameter as a ``meta`` tensor of its shape and dtype: what an
    AOT step (``train.step.aot_bundle``) runs on, allocating nothing."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs,
                    is_leaf=_is_spec)


def shardings_tree(specs, mesh, rules=None) -> dict:
    """The JAX package's tree of ``NamedSharding``s: on a mesh descriptor a
    sharding is its partition spec, so this is :func:`partition_specs_tree`."""
    return partition_specs_tree(specs, mesh, rules)


def stacked(spec: ParamSpec, n: int) -> ParamSpec:
    """Add a leading ('layers') dimension of ``n`` pattern repeats."""
    return ParamSpec((n,) + spec.shape, ("layers",) + spec.axes,
                     spec.init, spec.scale, spec.dtype)


def _from_numpy(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":            # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree, device: "torch.device | str",
                    specs=None) -> dict:
    """The JAX package's parameter tree, as numpy arrays (stacked leaves
    included), as the port's parameters on ``device``: the same nested
    keys, shapes, dtypes and values.  With ``specs`` (``build_specs(cfg)``),
    the tree must hold exactly its leaves at its shapes."""
    pairs = flatten(tree)
    if specs is not None:
        want = {p: s.shape for p, s in flatten(specs, _is_spec)}
        got = {p: tuple(np.shape(a)) for p, a in pairs}
        if got != want:
            raise ValueError("parameter tree does not match the specs: "
                             f"{sorted(set(got) ^ set(want)) or 'shapes differ'}")
    return tree_map(lambda a: _from_numpy(np.asarray(a)).to(device), tree)


def params_to_numpy(params) -> Dict[str, Any]:
    """The converse of :func:`params_from_jax`: the port's parameters as a
    nested dict of numpy arrays (``jax.tree.map(jnp.asarray, ...)`` makes
    them the JAX package's)."""
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves have no numpy dtype; cast first")
        return t.numpy()

    return tree_map(host, params)
