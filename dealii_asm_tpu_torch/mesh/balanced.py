"""Balanced hyper-cube decomposition (NumPy-free host code).

Carried over from ``dealii_asm_tpu/mesh/balanced.py``, the decomposition of
the reference's ``grid_generator.h:107-156``: a refinement count ``s`` is
split into ``n_refine = s // 6`` global refinements and per-axis
subdivisions (1, 2, 3, 2×2, 3×2 or 3×2×2 by ``s % 6``), so that the DoF
count grows smoothly with s.  The domain is the box
[0, subdiv_0] × … × [0, subdiv_{dim−1}] tiled with cells of width
2^−n_refine.
"""

from __future__ import annotations


def decompose_balanced(dim: int, s: int) -> tuple[int, list[int]]:
    """(n_refine, subdivisions).  At s ≡ 1 (mod 6), s > 1, the split is
    3×2×2 with one refinement less; it needs three axes, so a 2D mesh has
    none there and this raises ValueError (the JAX function fails with an
    IndexError at the same s)."""
    n_refine, remainder = divmod(s, 6)
    subdivisions = [1] * dim
    if remainder == 1 and s > 1:
        if dim < 3:
            raise ValueError(
                f"n subdivisions {s}: the balanced split 3x2x2 needs 3 axes, "
                f"got dim {dim}")
        subdivisions[:3] = [3, 2, 2]
        n_refine -= 1
    elif remainder in (2, 3):
        subdivisions[0] = remainder
    elif remainder in (4, 5):
        subdivisions[:2] = [remainder - 2, 2]
    return n_refine, subdivisions


def balanced_hyper_cube_subdivisions(dim: int,
                                     s: int) -> tuple[list[int], list[float]]:
    """(cells per axis, box lengths) of the balanced hyper cube at s."""
    n_refine, subdivisions = decompose_balanced(dim, s)
    cells = [sd << n_refine for sd in subdivisions]
    lengths = [float(sd) for sd in subdivisions]
    return cells, lengths
