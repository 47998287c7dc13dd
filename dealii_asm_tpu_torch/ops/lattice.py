"""Element windows of the node lattice (PyTorch).

Counterpart of ``grid_to_cells_sliced`` and ``cells_to_grid_sliced``
(``dealii_asm_tpu/ops/lattice.py:198-240``) for element windows of overlap 1
on a non-periodic 3D lattice: the window of cell c along an axis is the
m = p+1 nodes c·p … c·p+p, so the cells' node values are strided views of
the grid (``Tensor.unfold``) and the transpose is an overlap-add of one
contiguous block and one p-strided column per axis.  Layout (C, L): C cells
(x fastest), L = m³ local nodes (x fastest); the JAX package's (L, C) is its
transpose, chosen there for the TPU's lane tiling.
"""

from __future__ import annotations

import torch


def grid_to_cells_sliced(u_grid: torch.Tensor, degree: int) -> torch.Tensor:
    """(Nz, Ny, Nx) grid → (C, m³) element windows."""
    p, m = degree, degree + 1
    w = u_grid.unfold(0, m, p).unfold(1, m, p).unfold(2, m, p)
    cz, cy, cx = w.shape[:3]
    return w.reshape(cz * cy * cx, m ** 3)


def _overlap_add_axis(w: torch.Tensor, axis: int, degree: int):
    """(..., C, m, ...) at ``axis``, ``axis+1`` → (..., C·p+1, ...)."""
    p = degree
    w = torch.movedim(w, (axis, axis + 1), (-2, -1))
    C = w.shape[-2]
    out = w.new_zeros(w.shape[:-2] + (C * p + 1,))
    out[..., :C * p] = w[..., :p].reshape(w.shape[:-2] + (C * p,))
    out[..., p::p] += w[..., p]
    return torch.movedim(out, -1, axis)


def cells_to_grid_sliced(v: torch.Tensor, n_cells: tuple,
                         degree: int) -> torch.Tensor:
    """(C, m³) element windows → (Nz, Ny, Nx) grid, overlapping window
    nodes summed (the transpose of ``grid_to_cells_sliced``)."""
    m = degree + 1
    cx, cy, cz = n_cells
    w = v.reshape(cz, cy, cx, m, m, m).permute(0, 3, 1, 4, 2, 5)
    for a in range(3):
        w = _overlap_add_axis(w, a, degree)
    return w
