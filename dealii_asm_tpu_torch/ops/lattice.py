"""Patch windows of the node lattice (PyTorch).

Counterpart of ``grid_to_cells_sliced`` and ``cells_to_grid_sliced``
(``dealii_asm_tpu/ops/lattice.py:198-240``) on a non-periodic 3D lattice,
for windows of m nodes at stride p along each axis whose first window
starts at node ``first`` (``window_layout``):

- element patches of overlap o: m = p − 1 + 2·o, first = −(o − 1), one
  window per cell (slots outside the lattice read zero and are dropped);
- vertex-star patches: m = 2p − 1, first = 1, one window per interior
  vertex (the ``u[1:-1, 1:-1, 1:-1]`` interior cut into windows).

The windows are strided views of the (padded or cropped) grid
(``Tensor.unfold``).  The transpose is an overlap-add in a fixed order:
windows ⌈m/p⌉ apart never overlap, so each axis is ⌈m/p⌉ strided writes
(two for element overlap 1 and for vertex patches).  No atomics: two calls
give the same bits.  Layout (P, L): P windows (x fastest), L = m³ local
nodes (x fastest); the JAX package's (L, C) is its transpose, chosen there
for the TPU's lane tiling.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def window_layout(degree: int, n_overlap: int = 1,
                  patch: str = "element") -> tuple:
    """(m, first): window size and the first window's start node."""
    if patch == "vertex":
        return 2 * degree - 1, 1
    if patch == "element":
        return degree - 1 + 2 * n_overlap, 1 - n_overlap
    raise ValueError(f"patch type {patch!r}")


def _axis_pads(grid_shape: tuple, degree: int, m: int, first: int) -> list:
    """F.pad amounts (last axis first) that make window w of every axis
    start at w·p: −first before, and up to the last window's end after
    (negative amounts crop)."""
    pads = []
    for n in reversed(grid_shape):
        n_cells = (n - 1) // degree
        count = n_cells if first <= 0 else n_cells - 1
        pads += [-first, first + (count - 1) * degree + m - n]
    return pads


def grid_to_windows(u_grid: torch.Tensor, degree: int, m: int,
                    first: int) -> torch.Tensor:
    """(Nz, Ny, Nx) grid → (P, m³) windows."""
    p = degree
    u = F.pad(u_grid, _axis_pads(u_grid.shape, p, m, first))
    w = u.unfold(0, m, p).unfold(1, m, p).unfold(2, m, p)
    wz, wy, wx = w.shape[:3]
    return w.reshape(wz * wy * wx, m ** 3)


def _overlap_add_axis(w: torch.Tensor, axis: int, degree: int):
    """(..., W, m, ...) at ``axis``, ``axis+1`` → (..., (W−1)·p + m, ...):
    chunk c of every window's slots [c·p, c·p + p) lands on the nodes
    [w·p + c·p, ...), disjoint over w, so each chunk is one strided add."""
    p = degree
    w = torch.movedim(w, (axis, axis + 1), (-2, -1))
    W, m = w.shape[-2:]
    k = -(-m // p)
    out = w.new_zeros(w.shape[:-2] + ((W + k - 1) * p,))
    for c in range(k):
        r = min(p, m - c * p)
        view = out[..., c * p:(c + W) * p].unflatten(-1, (W, p))[..., :r]
        view += w[..., c * p:c * p + r]
    return torch.movedim(out[..., :(W - 1) * p + m], -1, axis)


def windows_to_grid(v: torch.Tensor, grid_shape: tuple, degree: int, m: int,
                    first: int) -> torch.Tensor:
    """(P, m³) windows → (Nz, Ny, Nx) grid, overlapping window nodes summed
    (the transpose of ``grid_to_windows``)."""
    pads = _axis_pads(grid_shape, degree, m, first)
    counts = [(n + pads[2 * (2 - a)] + pads[2 * (2 - a) + 1] - m) // degree + 1
              for a, n in enumerate(grid_shape)]
    w = v.reshape(*counts, m, m, m).permute(0, 3, 1, 4, 2, 5)
    for a in range(3):
        w = _overlap_add_axis(w, a, degree)
    return F.pad(w, [-x for x in pads])


def grid_to_cells_sliced(u_grid: torch.Tensor, degree: int) -> torch.Tensor:
    """(Nz, Ny, Nx) grid → (C, (p+1)³) element windows of overlap 1."""
    return grid_to_windows(u_grid, degree, degree + 1, 0)


def cells_to_grid_sliced(v: torch.Tensor, n_cells: tuple,
                         degree: int) -> torch.Tensor:
    """(C, (p+1)³) element windows of overlap 1 → (Nz, Ny, Nx) grid,
    overlapping window nodes summed."""
    grid = tuple(c * degree + 1 for c in reversed(n_cells))
    return windows_to_grid(v, grid, degree, degree + 1, 0)
