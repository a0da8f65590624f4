"""Mesh descriptors: the axis names and sizes of a device mesh.

The JAX package's ``launch/mesh.py`` builds ``jax.sharding.Mesh`` objects
(the 16 x 16 ``data``/``model`` pod, the 2 x 16 x 16 ``pod``/``data``/
``model`` pair of pods); the port has no SPMD partitioner, so a mesh is
described by its axis names and sizes, which is all that the sharding
rules (``parallel/sharding.py``) and microbatch sizing (``train/step.py``)
read.  A device mesh over several ranks waits for a multi-rank port
(ROADMAP queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["Mesh"]


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
