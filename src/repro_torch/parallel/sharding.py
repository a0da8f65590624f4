"""Logical-axis sharding rules: one table maps model-logical axes to mesh
axes.

The JAX package's ``parallel/sharding.py``.  Parameters and activations
carry *logical* axes ("embed", "mlp", "heads", ...); a rule table per mesh
maps each to an ordered list of candidate mesh axes, and resolution is
greedy per tensor: a candidate is taken iff the dimension divides by the
mesh axis's size (times the axes already picked for it) and no other
dimension of the tensor uses that axis.  Only "batch" and "kv_seq" stack
several mesh axes.

:func:`resolve_spec` returns the per-dimension assignment that the JAX
package's ``PartitionSpec`` holds, as a tuple (trailing ``None``s
trimmed); :func:`named_sharding` is the counterpart of the JAX package's
``NamedSharding`` constructor and returns that tuple, and
:func:`shard_shape` the shape one device holds of a tensor so sharded.
The port runs at world size 1, where no mesh is active and
:func:`constrain` is the identity; its calls are left out of the models.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.launch.mesh import Mesh

__all__ = ["RULES_SINGLE_POD", "RULES_MULTI_POD", "rules_for_mesh",
           "resolve_spec", "named_sharding", "shard_shape", "constrain"]

# logical axis -> ordered mesh-axis candidates
RULES_SINGLE_POD: Dict[str, Tuple[str, ...]] = {
    "batch": ("data",),
    "embed": ("data",),          # FSDP: shard weight d_model over data
    "mlp": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "vocab": ("model", "data"),
    "experts": ("model",),
    "moe_cap": ("data",),        # capacity dim (only when experts cannot shard "model")
    "kv_seq": ("data", "model"),  # SP for KV caches (whichever axis is free)
    "seq": ("model",),           # sequence-parallel residual stream carries
    "act_embed": (),             # activations' d_model: replicated
    "act_heads": ("model",),
    "layers": (),
    "conv": (),
    "state": (),
}

RULES_MULTI_POD: Dict[str, Tuple[str, ...]] = {
    **RULES_SINGLE_POD,
    "batch": ("pod", "data"),    # DP across pods
}

#: logical axes that may take several mesh axes at once
_STACKING = ("batch", "kv_seq")


def rules_for_mesh(mesh: Mesh) -> Dict[str, Tuple[str, ...]]:
    return RULES_MULTI_POD if "pod" in mesh.axis_names else RULES_SINGLE_POD


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh: Mesh,
                 rules: Optional[Mapping[str, Tuple[str, ...]]] = None
                 ) -> tuple:
    """Greedy logical -> mesh resolution for one tensor: per dimension a
    mesh axis name, a tuple of them, or None (replicated)."""
    rules = rules or rules_for_mesh(mesh)
    sizes = mesh.sizes
    used: set = set()
    out: list = []
    for dim, name in zip(shape, axes):
        picked: list = []
        for cand in rules.get(name, ()) if name is not None else ():
            if cand in used or cand in picked or cand not in sizes:
                continue
            cur = 1
            for p in picked:
                cur *= sizes[p]
            if dim % (cur * sizes[cand]) == 0:
                picked.append(cand)
                if name not in _STACKING:
                    break
        used.update(picked)
        out.append(tuple(picked) if len(picked) > 1
                   else picked[0] if picked else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   mesh: Mesh,
                   rules: Optional[Mapping[str, Tuple[str, ...]]] = None
                   ) -> tuple:
    """The JAX package's ``named_sharding``: the tensor's partition spec on
    ``mesh``, as :func:`resolve_spec` gives it (the mesh is the caller's,
    so the spec alone names the sharding)."""
    return resolve_spec(shape, axes, mesh, rules)


def shard_shape(shape: Sequence[int], spec: tuple, mesh: Mesh) -> tuple:
    """The shape one device holds of a ``shape`` tensor sharded by
    ``spec`` on ``mesh``: each dimension divided by the product of the
    mesh axes it is assigned to (the resolver only assigns axes that
    divide it)."""
    sizes = mesh.sizes
    out = list(shape)
    for i, assigned in enumerate(spec):
        if assigned is None:
            continue
        names = assigned if isinstance(assigned, tuple) else (assigned,)
        for name in names:
            if out[i] % sizes[name]:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not "
                                 f"divide over {name}={sizes[name]}")
            out[i] //= sizes[name]
    return tuple(out)


def constrain(x, axes: Sequence[Optional[str]], mesh: Optional[Mesh] = None):
    """Sharding constraint by logical axes: the identity when no mesh is
    active (world size 1); a mesh of several devices has no port yet."""
    if mesh is None or mesh.size == 1:
        return x
    raise NotImplementedError("sharded activations need a multi-rank "
                              "port of parallel/ (ROADMAP queue 1 item 7.4)")
