"""Global tensor-product operator algebra on the node lattice.

Counterpart of ``dealii_asm_tpu/ops/tensorops.py``.  On Cartesian meshes the
Laplace operator and the element-centric FDM Schwarz apply factor per axis:

- A = Σ_d  M̂ ⊗ … K̂_d … ⊗ M̂  with assembled banded 1D mass/stiffness M̂, K̂;
- P⁻¹ = (⊗_d G_dᵀ)·diag(1/Σ_d λ_d)·(⊗_d G_d) with G_d the per-window
  eigen-transform fused with the window selector.

On deformed meshes the Laplace operator is the merged form: per-axis global
value/derivative evaluation matrices E (C_d·q × N_d) and the symmetric
coefficient w|J|J⁻¹J⁻ᵀ on the quadrature grid (``merged_laplace_apply``).

The NumPy setup functions are carried over (the JAX module sits behind a package
``__init__`` that imports jax), without the optional C++ setup core: their
loops are O(N_d) per axis; the applies are plain torch and serve as the
reference versions of the CUDA kernels.  Grids are (Nz, Ny, Nx) with x
fastest; direction d (x = 0) lives on grid axis dim-1-d.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fem.lagrange import reference_mass_stiffness_1d

# -- NumPy setup --------------------------------------------------------------


def assemble_global_1d(degree: int, n_cells: int, h: float, periodic: bool,
                       n_q_1d: int | None = None):
    """Global assembled 1D mass/stiffness (N × N), natural boundary rows.
    A 1-cell periodic axis (N = p) maps the cell's two end nodes to node 0,
    so the cell's entries accumulate (``np.add.at``), as the JAX package's
    C++ setup core assembles them."""
    M_ref, K_ref = reference_mass_stiffness_1d(degree, n_q_1d)
    p = degree
    N = p * n_cells if periodic else p * n_cells + 1
    M = np.zeros((N, N))
    K = np.zeros((N, N))
    for c in range(n_cells):
        idx = (c * p + np.arange(p + 1)) % N
        np.add.at(M, (idx[:, None], idx[None, :]), M_ref * h)
        np.add.at(K, (idx[:, None], idx[None, :]), K_ref / h)
    return M, K


def global_laplace_1d_factors(mesh, degree: int, n_q_1d: int | None = None):
    """Per-direction (M̂_d, K̂_d) for the separable global Laplace."""
    return [assemble_global_1d(degree, mesh.n_cells[d], mesh.h[d],
                               mesh.periodic[d], n_q_1d)
            for d in range(mesh.dim)]


def fdm_direction_transform(eigvecs_c: np.ndarray, n_nodes: int, degree: int,
                            n_overlap: int, periodic: bool,
                            patch: str = "element") -> np.ndarray:
    """G_d (W·m × N): window selection fused with the eigen-transform,
    G[(w,k), n] = Σ_s V_w[s,k]·[n == wrap(start(w) + s)].  Element windows
    start at w·p − (o−1); vertex windows (m = 2p − 1) at w·p + 1, the star
    of interior vertex w + 1 (periodic: every vertex, w·p − (p − 1))
    (``dealii_asm_tpu/ops/tensorops.py:87-124``).  Out-of-range slots
    (ghosts beyond a boundary) select nothing."""
    C, m, _ = eigvecs_c.shape
    p = degree
    if patch == "element":
        first = -(n_overlap - 1)
    elif patch == "vertex":
        first = -(p - 1) if periodic else 1
    else:
        raise ValueError(f"patch type {patch!r}")
    G = np.zeros((C * m, n_nodes))
    for c in range(C):
        for s in range(m):
            n = c * p + first + s
            if periodic:
                n %= n_nodes
            elif n < 0 or n >= n_nodes:
                continue
            G[c * m:(c + 1) * m, n] += eigvecs_c[c, s, :]
    return G


def interp_direction_transform(B: np.ndarray, n_nodes: int, degree: int,
                               n_cells: int, periodic: bool) -> np.ndarray:
    """Global per-axis evaluation matrix E (C·q × N) from a 1D shape matrix
    B (q × p+1): row (c, iq) evaluates at quadrature point iq of cell c.
    On a 1-cell periodic axis (N = p) the cell's two end nodes are node 0,
    so their columns add."""
    q, n1 = B.shape
    E = np.zeros((n_cells * q, n_nodes))
    for c in range(n_cells):
        cols = (c * degree + np.arange(n1)) % n_nodes
        np.add.at(E, (slice(c * q, (c + 1) * q), cols), B)
    return E


# symmetric coefficient components, packed [xx, yy, zz, xy, xz, yz] in 3D
# and [xx, yy, xy] in 2D (``dealii_asm_tpu/ops/laplace.py:365-366``)
SYM_PAIRS = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
SYM_PAIRS_2D = ((0, 0), (1, 1), (0, 1))


def sym_pairs(dim: int) -> tuple:
    return SYM_PAIRS if dim == 3 else SYM_PAIRS_2D


def pack_merged_coeff(coeff: torch.Tensor, h) -> torch.Tensor:
    """(C, Q, dim, dim) reference-gradient coefficient → cell-major (C, 6,
    Q) in 3D, (C, 3, Q) in 2D, in box coordinates, C_box[a, b] =
    h_a·C_ref[a, b]·h_b (the global derivative matrices differentiate in
    box coordinates, ∂ξ = h·∂box; ``dealii_asm_tpu/ops/laplace.py:353-
    370``)."""
    return torch.stack([coeff[:, :, a, b] * float(h[a] * h[b])
                        for a, b in sym_pairs(coeff.shape[-1])], dim=1)


def cell_diagonal(coeff6: torch.Tensor, grad: np.ndarray) -> torch.Tensor:
    """(C, L) diagonal of each cell matrix, Σ_q Σ_ab C_ab(q) ∂_a φ_l ∂_b φ_l,
    in the pair form over the packed coefficients (C, 6 or 3, Q) (pairs off
    the diagonal count twice); ``grad`` (Q, L, dim) holds the basis
    gradients in the coefficients' coordinates
    (``laplace_general.py:418-440``)."""
    C, n_sym, Q = coeff6.shape
    BB = np.stack([grad[:, :, a] * grad[:, :, b] * (1.0 if a == b else 2.0)
                   for a, b in sym_pairs(grad.shape[2])])  # (n_sym, Q, L)
    BB = torch.as_tensor(BB.reshape(n_sym * Q, -1), dtype=coeff6.dtype,
                         device=coeff6.device)
    return coeff6.reshape(C, n_sym * Q) @ BB


def merged_coeff_qgrid(coeff6: torch.Tensor, cells_zyx: tuple, qn: int):
    """Cell-major (C, 6, Q) → six (Cz·q, Cy·q, Cx·q) q-grids (the JAX
    package's ``coeff6`` layout); in 2D (C, 3, Q) → three (Cy·q, Cx·q)."""
    if len(cells_zyx) == 2:
        cy, cx = cells_zyx
        g = coeff6.reshape(cy, cx, 3, qn, qn).permute(2, 0, 3, 1, 4)
        return list(g.reshape(3, cy * qn, cx * qn))
    cz, cy, cx = cells_zyx
    g = coeff6.reshape(cz, cy, cx, 6, qn, qn, qn).permute(3, 0, 4, 1, 5, 2, 6)
    return list(g.reshape(6, cz * qn, cy * qn, cx * qn))


def merged_laplace_apply(u_grid, Ev, Ed, coeff6):
    """Deformed-geometry Laplace apply as q-space axis products:
    g = (∇̂⊗N̂) u, t = C g, v = (∇̂⊗N̂)ᵀ t.  Ev/Ed: per-direction global
    value/derivative matrices (x first); coeff6: six q-grids
    [xx, yy, zz, xy, xz, yz] in 3D, three [xx, yy, xy] in 2D
    (``dealii_asm_tpu/ops/tensorops.py:190-226``)."""
    if u_grid.ndim == 2:
        a = axis_matmul(u_grid, Ev[0], 1)
        d1 = axis_matmul(u_grid, Ed[0], 1)
        gy = axis_matmul(a, Ed[1], 0)
        gx = axis_matmul(d1, Ev[1], 0)
        cxx, cyy, cxy = coeff6
        tx = cxx * gx + cxy * gy
        ty = cxy * gx + cyy * gy
        v = axis_matmul(axis_matmul(ty, Ed[1].T, 0), Ev[0].T, 1)
        return v + axis_matmul(axis_matmul(tx, Ev[1].T, 0), Ed[0].T, 1)
    a = axis_matmul(u_grid, Ev[0], 2)    # x values
    d1 = axis_matmul(u_grid, Ed[0], 2)   # x derivatives
    b = axis_matmul(a, Ev[1], 1)
    c = axis_matmul(a, Ed[1], 1)
    e = axis_matmul(d1, Ev[1], 1)
    gz = axis_matmul(b, Ed[2], 0)
    gy = axis_matmul(c, Ev[2], 0)
    gx = axis_matmul(e, Ev[2], 0)
    cxx, cyy, czz, cxy, cxz, cyz = coeff6
    tx = cxx * gx + cxy * gy + cxz * gz
    ty = cxy * gx + cyy * gy + cyz * gz
    tz = cxz * gx + cyz * gy + czz * gz
    w1 = axis_matmul(tz, Ed[2].T, 0)
    w2 = axis_matmul(ty, Ev[2].T, 0)
    w3 = axis_matmul(tx, Ev[2].T, 0)
    r12 = axis_matmul(w1, Ev[1].T, 1) + axis_matmul(w2, Ed[1].T, 1)
    r3 = axis_matmul(w3, Ev[1].T, 1)
    return axis_matmul(r12, Ev[0].T, 2) + axis_matmul(r3, Ed[0].T, 2)


def banded_offsets(N: int, bandwidth: int, periodic: bool) -> list[int]:
    """Distinct diagonal offsets of a banded (possibly periodic) N×N matrix."""
    if periodic and 2 * bandwidth + 1 > N:
        return list(range(N))
    return list(range(-bandwidth, bandwidth + 1))


def banded_diagonals(M: np.ndarray, bandwidth: int, periodic: bool = False):
    """(diags, offsets): diags[k][i] = M[i, i+offsets[k]] (zero outside the
    matrix when not periodic; wrapped mod N when periodic)."""
    N = M.shape[0]
    offs = banded_offsets(N, bandwidth, periodic)
    out = np.zeros((len(offs), N))
    idx = np.arange(N)
    for k, off in enumerate(offs):
        cols = idx + off
        if periodic:
            out[k] = M[idx, cols % N]
        else:
            ok = (cols >= 0) & (cols < N)
            out[k, idx[ok]] = M[idx[ok], cols[ok]]
    return out, offs


# -- plain torch applies -------------------------------------------------------


def axis_matmul(T: torch.Tensor, M: torch.Tensor, grid_axis: int):
    """Contract M (out, in) against one axis of the grid tensor T."""
    return torch.movedim(torch.tensordot(T, M, dims=([grid_axis], [1])), -1,
                         grid_axis)


def banded_axis_apply(t: torch.Tensor, diags: torch.Tensor, grid_axis: int,
                      offsets=None, periodic: bool = False):
    """y = M̂ t along one grid axis, M̂ given by its diagonal table: row k
    holds the diagonal at ``offsets[k]`` (default −b..b).  A non-periodic
    axis pads with zeros, a periodic one by wrapping, which with the
    aliased offsets 0..N−1 of a short periodic axis (``banded_offsets``)
    counts every column once (``dealii_asm_tpu/ops/tensorops.py:270-300``).
    A bfloat16 axis sums its band in float32 and rounds once, as a dot does
    (XLA's bfloat16 dot in the JAX package's dense axis products)."""
    if t.dtype == torch.bfloat16:
        return banded_axis_apply(t.float(), diags.float(), grid_axis, offsets,
                                 periodic).to(torch.bfloat16)
    nd = t.ndim
    if offsets is None:
        b = (diags.shape[0] - 1) // 2
        offsets = range(-b, b + 1)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    N = t.shape[grid_axis]
    shape = [1] * nd
    shape[grid_axis] = N
    if periodic:
        parts = [t.narrow(grid_axis, N - lo, lo)] if lo else []
        parts += [t] + ([t.narrow(grid_axis, 0, hi)] if hi else [])
        tp = torch.cat(parts, dim=grid_axis)
    else:
        pad = [0, 0] * nd  # F.pad order: last axis first
        pad[2 * (nd - 1 - grid_axis)] = lo
        pad[2 * (nd - 1 - grid_axis) + 1] = hi
        tp = torch.nn.functional.pad(t, pad)
    acc = None
    for k, off in enumerate(offsets):
        term = diags[k].reshape(shape) * tp.narrow(grid_axis, lo + off, N)
        acc = term if acc is None else acc + term
    return acc


def separable_laplace_apply_banded(u_grid, Mdiags, Kdiags, offsets=None,
                                   periodic=None):
    """v = Kz My Mx u + Mz Ky Mx u + Mz My Kx u with banded axis applies
    (3D; 2D: Ky Mx u + My Kx u; Mdiags/Kdiags, and the optional per-
    direction ``offsets`` and ``periodic`` flags, ordered by direction, x
    first)."""
    dim = u_grid.ndim
    offs = offsets or (None,) * dim
    per = periodic or (False,) * dim
    ap = lambda t, tab, d: banded_axis_apply(t, tab, dim - 1 - d, offs[d],
                                             per[d])
    if dim == 2:
        a = ap(u_grid, Mdiags[0], 0)
        return ap(a, Kdiags[1], 1) + ap(ap(u_grid, Kdiags[0], 0), Mdiags[1], 1)
    a = ap(u_grid, Mdiags[0], 0)
    b = ap(a, Mdiags[1], 1)
    v = ap(b, Kdiags[2], 2)
    v = v + ap(ap(a, Kdiags[1], 1), Mdiags[2], 2)
    v = v + ap(ap(ap(u_grid, Kdiags[0], 0), Mdiags[1], 1), Mdiags[2], 2)
    return v


def fdm_global_apply(x_grid, Gs, Gts, inv_denom):
    """P⁻¹x = (⊗G_dᵀ)·diag(inv_denom)·(⊗G_d)x — six axis matmuls + one scale."""
    dim = x_grid.ndim
    t = x_grid
    for d in range(dim):
        t = axis_matmul(t, Gs[d], dim - 1 - d)
    t = t * inv_denom
    for d in range(dim):
        t = axis_matmul(t, Gts[d], dim - 1 - d)
    return t


def outer_grid(vecs_xyz):
    """([Nz,] Ny, Nx) outer product of per-direction vectors given x first
    (z slowest, multiplied in from the slowest axis)."""
    out = vecs_xyz[-1]
    for v in reversed(vecs_xyz[:-1]):
        out = out[..., None] * v
    return out


def outer_sum(vecs_xyz):
    """([Nz,] Ny, Nx) outer sum of per-direction vectors given x first (the
    FDM's eigenvalue sums λ_x + λ_y (+ λ_z))."""
    out = vecs_xyz[0]
    for v in vecs_xyz[1:]:
        out = v.reshape(v.shape + (1,) * out.ndim) + out
    return out
