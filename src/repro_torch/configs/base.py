"""Architecture registry scaffolding (`repro.configs.base`, field for
field)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One (input-shape) cell of the assigned suite."""

    name: str
    kind: str         # train | prefill | decode | serve | retrieval
    meta: dict        # family-specific shape numbers

    def __getitem__(self, k):
        return self.meta[k]


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str                      # lm | gnn | recsys
    source: str                      # citation tag from the assignment
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict
    skips: dict = dataclasses.field(default_factory=dict)  # shape → reason

    def cells(self):
        for name, cell in self.shapes.items():
            yield name, cell, self.skips.get(name)
