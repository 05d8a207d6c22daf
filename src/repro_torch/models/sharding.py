"""The sharding context of the model code, for one device.

The reference's `Ctx` carries a JAX mesh and its GSPMD partition rules
(`leaf_spec`, `param_specs`, `cache_spec`) place every parameter and
cache leaf on it.  The port runs the models on one device: `Ctx()` is
the context every entry point takes, its `constraint` is the identity,
and a mesh is refused until the GSPMD layer is ported (ROADMAP Queue 1,
item 7c).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass
class Ctx:
    mesh: Optional[Any] = None

    def __post_init__(self):
        if self.mesh is not None:
            raise NotImplementedError(
                "the port runs the models on one device; sharding them over "
                "a mesh waits for the GSPMD slice (ROADMAP Queue 1, item 7c)")

    def constraint(self, x, spec=None):
        """The reference pins `x` to `spec` on its mesh; without a mesh
        it is the identity, as here."""
        return x
