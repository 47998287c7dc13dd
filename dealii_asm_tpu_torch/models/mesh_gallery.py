"""Mesh gallery and coarsening-sequence drivers (NumPy, host).

Counterpart of ``dealii_asm_tpu/models/mesh_gallery.py`` (``run_gallery``
:20, ``run_coarsening`` :50), the reference's ``mesh_types_01/02/03.cc``
(each mesh family written as VTU, with its largest cell aspect ratio) and
``coarsening_types.cc`` (the level layout of each multigrid variant), on
the port's meshes and ``p_sequence``.  Same printout as the JAX drivers.

    python -m dealii_asm_tpu_torch.models.mesh_gallery gallery [outdir]
    python -m dealii_asm_tpu_torch.models.mesh_gallery coarsening [degree]
"""

from __future__ import annotations

import os
import sys

from ..mesh.grid import StructuredMesh
from ..mesh.transforms import kershaw_transform
from ..mesh.unstructured import hyper_ball_balanced
from ..ops.transfer import p_sequence
from ..utils.vtu import write_vtu_mesh


def run_gallery(outdir: str = "mesh_gallery"):
    """Write each gallery mesh to ``outdir``/<name>.vtu and print the
    ``| mesh | n_cells | aspect_ratio |`` table; returns its rows."""
    os.makedirs(outdir, exist_ok=True)
    rows = []

    def emit(name, mesh):
        write_vtu_mesh(os.path.join(outdir, f"{name}.vtu"), mesh)
        rows.append((name, mesh.n_cells_total,
                     round(mesh.max_aspect_ratio(), 3)))

    emit("hypercube", StructuredMesh(3, (8, 8, 8)))
    for stretch in (2.0, 10.0, 50.0):
        emit(f"anisotropy_{stretch:g}",
             StructuredMesh(3, (8, 8, 8), lengths=(1.0, 1.0, stretch)))
    for eps in (1.0, 0.5, 0.3, 0.05):
        emit(f"kershaw_{eps:g}", StructuredMesh(
            3, (6, 6, 6), transform=kershaw_transform(eps, eps)))
    for dim in (2, 3):
        emit(f"hyperball_{dim}d", hyper_ball_balanced(dim).refine_global(2))

    print("| mesh | n_cells | aspect_ratio |")
    for name, nc, ar in rows:
        print(f"| {name} | {nc} | {ar} |")
    return rows


def coarsening_levels(mg_type: str, degree: int, n_refinements: int):
    """(refinement, degree) levels of one multigrid variant, coarse → fine,
    consecutive duplicates dropped (the bisect degree sequence)."""
    degrees = p_sequence(degree, "bisect")
    top = n_refinements
    if mg_type == "h":
        levels = [(r, degree) for r in range(top + 1)]
    elif mg_type == "p":
        levels = [(top, d) for d in degrees]
    elif mg_type == "hp":
        levels = [(0, d) for d in degrees] + [(r, degree)
                                              for r in range(top + 1)]
    else:
        levels = [(r, degrees[0]) for r in range(top + 1)] + [
            (top, d) for d in degrees]
    return [lv for i, lv in enumerate(levels)
            if i == 0 or lv != levels[i - 1]]


def run_coarsening(degree: int = 4, n_refinements: int = 3):
    """Print each degree sequence and each multigrid variant's levels."""
    print(f"degree = {degree}, n_refinements = {n_refinements}")
    for seq in ("bisect", "go to one", "decrease by one"):
        print(f"p sequence {seq!r}: {p_sequence(degree, seq)}")
    for mg_type in ("h", "p", "hp", "ph"):
        print(f"mg type {mg_type!r}: levels (refinement, degree) = "
              f"{coarsening_levels(mg_type, degree, n_refinements)}")


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    which = argv[0] if argv else "gallery"
    if which == "gallery":
        run_gallery(argv[1] if len(argv) > 1 else "mesh_gallery")
    else:
        run_coarsening(int(argv[1]) if len(argv) > 1 else 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
