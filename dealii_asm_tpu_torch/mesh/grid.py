"""Structured Cartesian meshes (NumPy).

Carried over from ``dealii_asm_tpu/mesh/grid.py`` (the part the port uses): a
grid of ``n_cells`` uniform cells over a box, cells lexicographic with x
fastest.  The port has no deformed meshes yet (Kershaw: ROADMAP item 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class StructuredMesh:
    dim: int
    n_cells: tuple[int, ...]
    lengths: tuple[float, ...] = None  # box side lengths; default all 1.0
    periodic: tuple[bool, ...] = None

    def __post_init__(self):
        for name, default in (("lengths", 1.0), ("periodic", False)):
            if getattr(self, name) is None:
                object.__setattr__(self, name, (default,) * self.dim)
        if len(self.n_cells) != self.dim:
            raise ValueError(f"n_cells {self.n_cells} for dim {self.dim}")

    @property
    def n_cells_total(self) -> int:
        return int(np.prod(self.n_cells))

    @property
    def h(self) -> np.ndarray:
        """Cell widths per direction."""
        return np.array(self.lengths) / np.array(self.n_cells)

    def max_aspect_ratio(self) -> float:
        h = self.h
        return float(h.max() / h.min())
