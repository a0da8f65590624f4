"""Mesh descriptors: the axis names and sizes of a device mesh.

The JAX package's ``launch/mesh.py`` builds ``jax.sharding.Mesh`` objects
(the 16 x 16 ``data``/``model`` pod, the 2 x 16 x 16 ``pod``/``data``/
``model`` pair of pods).  The port has no SPMD partitioner, so a mesh is
described by its axis names and sizes, which is all that the sharding
rules (``parallel/sharding.py``), microbatch sizing and the AOT bundles
(``train/step.py``), the dry run (``launch/dryrun.py``) and the pipeline's
stage count (``parallel/pipeline.py``) read.  The production meshes are
described, never built: no process holds 256 or 512 devices here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["Mesh", "make_production_mesh", "make_host_mesh"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError((self.axis_names, self.shape))

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The 16 x 16 (``data``, ``model``) pod of 256 devices, or the 2 x 16
    x 16 (``pod``, ``data``, ``model``) pair of pods of 512."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small (``data``, ``model``) mesh (tests)."""
    return Mesh(("data", "model"), (data, model))
