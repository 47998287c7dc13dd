"""Patch windows of the node lattice (PyTorch).

Counterpart of ``grid_to_cells_sliced`` and ``cells_to_grid_sliced``
(``dealii_asm_tpu/ops/lattice.py:198-240``) on a 2D or 3D lattice, for
windows of m nodes at stride p along each axis whose first window starts
at node ``first`` (``window_layout``):

- element patches of overlap o: m = p − 1 + 2·o, first = −(o − 1), one
  window per cell (slots outside a non-periodic lattice read zero and are
  dropped);
- vertex-star patches: m = 2p − 1, first = 1, one window per interior
  vertex (the ``u[1:-1, 1:-1, 1:-1]`` interior cut into windows); on a
  periodic axis every vertex is interior, first = 1 − p (vertex 0).

A periodic axis (N = p·C nodes) pads by wrapping: slot n of the padded
axis is node n mod N (``lattice.py:23-90``), and the transpose folds the
wrapped slots back onto their nodes (``:121-160``).

The windows are strided views of the (padded or cropped) grid
(``Tensor.unfold``).  The transpose is an overlap-add in a fixed order:
windows ⌈m/p⌉ apart never overlap, so each axis is ⌈m/p⌉ strided writes
(two for element overlap 1 and for vertex patches), then on a periodic
axis the two wrapped ends are added in, lower end first.  No atomics: two
calls give the same bits.  Layout (P, L): P windows (x fastest), L =
m^dim local nodes (x fastest); the JAX package's (L, C) is its transpose,
chosen there for the TPU's lane tiling.
"""

from __future__ import annotations

import torch
from torch.nn import functional as F


def window_layout(degree: int, n_overlap: int = 1, patch: str = "element",
                  periodic: bool = False) -> tuple:
    """(m, first): window size and the first window's start node along an
    axis (``periodic``: a periodic one)."""
    if patch == "vertex":
        return 2 * degree - 1, 1 - degree if periodic else 1
    if patch == "element":
        return degree - 1 + 2 * n_overlap, 1 - n_overlap
    raise ValueError(f"patch type {patch!r}")


def axis_firsts(degree: int, n_overlap: int, patch: str,
                periodic: tuple) -> tuple:
    """Per-direction (x first) start node of the first window."""
    return tuple(window_layout(degree, n_overlap, patch, per)[1]
                 for per in periodic)


def _axis_plan(n: int, degree: int, m: int, first: int,
               periodic: bool) -> tuple:
    """(lo, hi, count) of one axis of n nodes: ``count`` windows, window w
    at padded slot w·p after ``lo`` slots before node 0 and ``hi`` after
    node n − 1 (negative amounts crop a non-periodic axis)."""
    if periodic:
        count = n // degree
    else:
        n_cells = (n - 1) // degree
        count = n_cells if first <= 0 else n_cells - 1
    return -first, first + (count - 1) * degree + m - n, count


def _plans(grid_shape: tuple, degree: int, m: int, first, periodic):
    """Per grid axis (z first) ``_axis_plan``s and periodic flags."""
    dim = len(grid_shape)
    firsts = (first,) * dim if isinstance(first, int) else tuple(first)
    per = tuple(periodic) if periodic else (False,) * dim
    plans = [_axis_plan(n, degree, m, firsts[dim - 1 - a], per[dim - 1 - a])
             for a, n in enumerate(grid_shape)]
    return plans, [per[dim - 1 - a] for a in range(dim)]


def _wrap_axis(u: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Periodic padding: lo wrapped slots before, hi after (each ≤ n)."""
    n = u.shape[axis]
    parts = [u.narrow(axis, n - lo, lo)] if lo else []
    parts.append(u)
    if hi:
        parts.append(u.narrow(axis, 0, hi))
    return torch.cat(parts, dim=axis) if len(parts) > 1 else u


def _fold_axis(v: torch.Tensor, axis: int, n: int, lo: int,
               hi: int) -> torch.Tensor:
    """Transpose of ``_wrap_axis``: the core n slots plus the wrapped ends,
    the lower end first."""
    core = v.narrow(axis, lo, n).clone()
    if lo:
        core.narrow(axis, n - lo, lo).add_(v.narrow(axis, 0, lo))
    if hi:
        core.narrow(axis, 0, hi).add_(v.narrow(axis, lo + n, hi))
    return core


def grid_to_windows(u_grid: torch.Tensor, degree: int, m: int, first,
                    periodic=None) -> torch.Tensor:
    """([Nz,] Ny, Nx) grid → (P, m^dim) windows.  ``first`` is one start
    node for every axis or one per direction (x first); ``periodic`` one
    flag per direction (default none)."""
    dim = u_grid.ndim
    plans, per = _plans(u_grid.shape, degree, m, first, periodic)
    pads = []
    for (lo, hi, _), p in zip(reversed(plans), reversed(per)):
        pads += [0, 0] if p else [lo, hi]
    w = F.pad(u_grid, pads)
    for a, ((lo, hi, _), p) in enumerate(zip(plans, per)):
        if p:
            w = _wrap_axis(w, a, lo, hi)
    for a in range(dim):
        w = w.unfold(a, m, degree)
    return w.reshape(-1, m ** dim)


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
                    first, periodic=None) -> torch.Tensor:
    """(P, m^dim) windows → ([Nz,] Ny, Nx) grid, overlapping window nodes
    summed (the transpose of ``grid_to_windows``)."""
    dim = len(grid_shape)
    plans, per = _plans(grid_shape, degree, m, first, periodic)
    w = v.reshape(*[c for _, _, c in plans], *(m,) * dim).permute(
        *[i for a in range(dim) for i in (a, dim + a)])
    for a in range(dim):
        w = _overlap_add_axis(w, a, degree)
    for a, ((lo, hi, _), p) in enumerate(zip(plans, per)):
        if p:
            w = _fold_axis(w, a, grid_shape[a], lo, hi)
    pads = []
    for (lo, hi, _), p in zip(reversed(plans), reversed(per)):
        pads += [0, 0] if p else [-lo, -hi]
    return F.pad(w, pads)


def _cell_grid(n_cells: tuple, degree: int, periodic) -> tuple:
    """([Nz,] Ny, Nx) node grid of ``n_cells`` (x first)."""
    per = tuple(periodic) if periodic else (False,) * len(n_cells)
    return tuple(c * degree + (0 if p else 1)
                 for c, p in zip(reversed(n_cells), reversed(per)))


def grid_to_cells_sliced(u_grid: torch.Tensor, degree: int,
                         periodic=None) -> torch.Tensor:
    """([Nz,] Ny, Nx) grid → (C, (p+1)^dim) element windows of overlap 1."""
    return grid_to_windows(u_grid, degree, degree + 1, 0, periodic)


def cells_to_grid_sliced(v: torch.Tensor, n_cells: tuple, degree: int,
                         periodic=None) -> torch.Tensor:
    """(C, (p+1)^dim) element windows of overlap 1 → ([Nz,] Ny, Nx) grid,
    overlapping window nodes summed."""
    return windows_to_grid(v, _cell_grid(n_cells, degree, periodic), degree,
                           degree + 1, 0, periodic)
