"""State carried across from the JAX package into the port's modules.

The JAX objects' tables arrive as NumPy arrays (``np.asarray``); this module
imports no jax itself.  The tests use it to drive the port with the JAX
package's tables, and to hold the port's own jax-free setup code against those
tables entry by entry.  A deformed mesh keeps the JAX mesh's transform, a
NumPy callable; an unstructured mesh keeps its boundary projection, and its
chart is rebuilt in the port from the chart's corner table.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE
from .fem.dofs import DofHandler
from .fem.general_dofs import GeneralDofHandler
from .mesh.grid import StructuredMesh
from .mesh.unstructured import BallChart, UnstructuredMesh
from .ops.laplace import LaplaceOperator
from .ops.laplace_general import GeneralLaplaceOperator
from .ops.tensorops import sym_pairs
from .ops.transfer import TwoLevelTransfer
from .ops.transfer_general import GeneralTwoLevelTransfer
from .precond.asm import ASMPreconditioner, CellASMPreconditioner
from .precond.asm_general import GeneralASMPreconditioner
from .precond.block_asm import (BlockCG, BlockInverse,
                                RestrictedPreconditioner, Restrictor)
from .precond.fdm import FDMCollection
from .solvers.chebyshev import (ChebyshevPreconditioner, EigenvalueInfo,
                                RelaxationPreconditioner)

# the JAX package's order of the symmetric coefficient components of its
# general operator (``_SYM_PAIRS``, ``ops/laplace_general.py:36-37``)
JAX_SYM_PAIRS = {2: ((0, 0), (0, 1), (1, 1)),
                 3: ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}


def dofs_from_jax(dofs) -> DofHandler:
    """The port's DofHandler for a JAX package DofHandler."""
    m = dofs.mesh
    mesh = StructuredMesh(m.dim, tuple(m.n_cells), tuple(m.lengths),
                          tuple(m.periodic), m.transform, tuple(m.origin))
    return DofHandler(mesh, dofs.degree)


def laplace_from_jax(op, dtype=torch.float64,
                     device=DEFAULT_DEVICE) -> LaplaceOperator:
    """Port operator from a JAX ``LaplaceOperator``: its M1d_global/K1d_global
    (Cartesian) or its merged geometry ``coeff`` and ``jxw`` (deformed)."""
    dofs = dofs_from_jax(op.dofs)
    if op.mesh.transform is not None:
        geometry = (np.asarray(op.geometry.coeff, np.float64),
                    np.asarray(op.geometry.jxw, np.float64))
        return LaplaceOperator(dofs, dtype=dtype, device=device,
                               mapping_degree=op.mapping_degree,
                               geometry=geometry)
    factors = [(np.asarray(M, np.float64), np.asarray(K, np.float64))
               for M, K in zip(op.M1d_global, op.K1d_global)]
    return LaplaceOperator(dofs, dtype=dtype, device=device, factors=factors)


def _optional(a):
    return None if a is None else np.asarray(a)


def general_dofs_from_jax(dofs) -> GeneralDofHandler:
    """The port's GeneralDofHandler for a JAX package GeneralDofHandler: the
    mesh's vertices, cells, chart fields, parent_cells and child_index as
    NumPy."""
    m = dofs.mesh
    chart = None
    if m.chart is not None:
        corners = np.asarray(m.chart.corners, np.float64)  # (C0, 2^dim, dim)
        c0, nv, dim = corners.shape
        chart = BallChart(corners.reshape(-1, dim),
                          np.arange(c0 * nv).reshape(c0, nv), m.chart.radius)
    mesh = UnstructuredMesh(
        m.dim, np.array(m.vertices, np.float64), np.array(m.cells, np.int64),
        project=m.project, parent_cells=_optional(m.parent_cells),
        child_index=_optional(m.child_index), chart=chart,
        chart_cell=_optional(m.chart_cell), chart_lo=_optional(m.chart_lo),
        chart_h=_optional(m.chart_h))
    return GeneralDofHandler(mesh, dofs.degree)


def coeff6_from_jax(op) -> np.ndarray:
    """(C, 6, Q) coefficients in the port's order [xx, yy, zz, xy, xz, yz]
    ((C, 3, Q) as [xx, yy, xy] in 2D) from a JAX ``GeneralLaplaceOperator``:
    its lane-major ``coeff6`` (six (q, q, q, C) arrays, three (q, q, C) in
    2D, in the JAX order) or its (C, Q, dim, dim) ``coeff``."""
    pairs = sym_pairs(op.dim)
    if op.coeff6 is not None:
        comps = [np.asarray(c, np.float64) for c in op.coeff6]
        C = comps[0].shape[-1]
        order = JAX_SYM_PAIRS[op.dim]
        return np.stack([comps[order.index(pair)].reshape(-1, C).T
                         for pair in pairs], axis=1)
    coeff = np.asarray(op.coeff, np.float64)
    return np.stack([coeff[:, :, a, b] for a, b in pairs], axis=1)


def general_laplace_from_jax(op, dtype=torch.float64,
                             device=DEFAULT_DEVICE) -> GeneralLaplaceOperator:
    """Port operator from a JAX ``GeneralLaplaceOperator``: its ``coeff`` or
    ``coeff6`` and its ``jxw``."""
    return GeneralLaplaceOperator(
        general_dofs_from_jax(op.dofs), dtype=dtype, device=device,
        mapping_degree=op.mapping_degree,
        geometry=(coeff6_from_jax(op), np.asarray(op._jxw_np, np.float64)))


def _collection_from_jax(c) -> FDMCollection:
    return FDMCollection([np.asarray(V, np.float64) for V in c.eigvecs],
                         [np.asarray(l, np.float64) for l in c.eigvals],
                         np.asarray(c.ids))


def general_asm_from_jax(asm, dtype=torch.float64,
                         device=DEFAULT_DEVICE) -> GeneralASMPreconditioner:
    """Port FDM Schwarz from a JAX ``GeneralASMPreconditioner`` (element
    patches of any overlap or vertex patches): its deduplicated FDM
    ``collection`` and its RAS mask."""
    return GeneralASMPreconditioner(
        general_dofs_from_jax(asm.dofs), n_overlap=asm.n_overlap,
        weighting_type=asm.weighting_type, dtype=dtype, device=device,
        collection=_collection_from_jax(asm.collection),
        patch_type=asm.patch_type, ras_mask=_optional(asm.ras_mask))


def general_transfer_from_jax(tr, dtype=torch.float64, device=DEFAULT_DEVICE,
                              ) -> GeneralTwoLevelTransfer:
    """Port transfer from a JAX ``GeneralTwoLevelTransfer``'s T1."""
    return GeneralTwoLevelTransfer(
        general_dofs_from_jax(tr.coarse), general_dofs_from_jax(tr.fine),
        dtype=dtype, device=device, T1=np.asarray(tr.T1, np.float64))


def ras_axis_masks(ras_mask, windows: tuple) -> list:
    """Per-direction (W_d, m) masks (x first) whose tensor product is the
    (P, m³) RAS mask ``ras_mask`` of a JAX ``ASMPreconditioner`` over
    ``windows`` = (W_x, W_y, W_z) patches per axis (patches and local nodes
    x fastest); ValueError if it is not such a product."""
    wx, wy, wz = windows
    mask = np.asarray(ras_mask, np.float64)
    m = round(mask.shape[1] ** (1.0 / 3.0))
    g = mask.reshape(wz, wy, wx, m, m, m)
    # the (window, slot) axes of x, y and z in g; the rest reduce away
    mx, my, mz = (g.max(axis=tuple(a for a in range(6) if a not in keep))
                  for keep in ((2, 5), (1, 4), (0, 3)))
    prod = (mz[:, None, None, :, None, None] * my[None, :, None, None, :, None]
            * mx[None, None, :, None, None, :])
    if not np.array_equal(prod, g):
        raise ValueError("the RAS mask is not a per-axis tensor product")
    return [mx, my, mz]


def asm_from_jax(asm, dtype=torch.float64, device=DEFAULT_DEVICE):
    """Port FDM Schwarz from a JAX ``ASMPreconditioner`` (element patches
    of any overlap or vertex patches): on a Cartesian mesh its
    per-coordinate eigen-tables ``percoord`` (its ``global_fdm`` is built
    from them) with its RAS mask factored per axis; on a deformed mesh its
    per-patch ``collection`` and RAS mask."""
    dofs = dofs_from_jax(asm.dofs)
    kw = dict(n_overlap=asm.n_overlap, weighting_type=asm.weighting_type,
              dtype=dtype, device=device, patch_type=asm.patch_type)
    if dofs.mesh.transform is not None:
        return CellASMPreconditioner(
            dofs, collection=_collection_from_jax(asm.collection),
            ras_mask=_optional(asm.ras_mask), **kw)
    if asm.percoord is None:
        raise ValueError("the JAX preconditioner has no per-coordinate "
                         "tables")
    percoord = [(np.asarray(V, np.float64), np.asarray(lam, np.float64))
                for V, lam in asm.percoord]
    windows = tuple(V.shape[0] for V, _ in percoord)
    ras = (None if asm.ras_mask is None
           else ras_axis_masks(asm.ras_mask, windows))
    return ASMPreconditioner(dofs, percoord=percoord, ras_masks=ras, **kw)


def transfer_from_jax(tr, dtype=torch.float64,
                      device=DEFAULT_DEVICE) -> TwoLevelTransfer:
    """Port transfer from a JAX ``TwoLevelTransfer``'s P1d."""
    return TwoLevelTransfer(dofs_from_jax(tr.coarse), dofs_from_jax(tr.fine),
                            dtype=dtype, device=device,
                            P1d=[np.asarray(P, np.float64) for P in tr.P1d])


def global_fdm_numpy(asm) -> tuple:
    """(Gs, Gts, lams) of a JAX or port ASMPreconditioner as NumPy arrays."""
    Gs, Gts, lams = asm.global_fdm
    conv = lambda xs: [np.asarray(x.cpu() if isinstance(x, torch.Tensor)
                                  else x, np.float64) for x in xs]
    return conv(Gs), conv(Gts), conv(lams)


def _eigenvalues_from_jax(info) -> EigenvalueInfo | None:
    if info is None:
        return None
    return EigenvalueInfo(float(info.min_eigenvalue_estimate),
                          float(info.max_eigenvalue_estimate),
                          int(info.cg_n_iterations))


def chebyshev_from_jax(cheb, A, M, n_dofs: int,
                       device=DEFAULT_DEVICE) -> ChebyshevPreconditioner:
    """Port Chebyshev smoother around (A, M) with a JAX
    ``ChebyshevPreconditioner``'s degree, kind, smoothing range and
    eigenvalue estimates, so that both apply the same polynomial."""
    return ChebyshevPreconditioner(
        A, M, n_dofs, degree=cheb.degree,
        smoothing_range=cheb.smoothing_range,
        polynomial_type=cheb.polynomial_type,
        eigenvalues=_eigenvalues_from_jax(cheb.eigenvalues), device=device)


def relaxation_from_jax(rel, A, M, n_dofs: int,
                        device=DEFAULT_DEVICE) -> RelaxationPreconditioner:
    """Port relaxation smoother around (A, M) with a JAX
    ``RelaxationPreconditioner``'s step count, ω and eigenvalue estimates."""
    return RelaxationPreconditioner(
        A, M, n_dofs, n_iterations=rel.n_iterations, omega=float(rel.omega),
        eigenvalues=_eigenvalues_from_jax(rel.eigenvalues), device=device)


def restrictor_from_jax(r) -> Restrictor:
    """The port's ``Restrictor`` holding a JAX ``Restrictor``'s index table
    (pad index n) and inverse multiplicities, on the port's DoF handler."""
    out = Restrictor.__new__(Restrictor)
    out.dofs = dofs_from_jax(r.dofs)
    out.weighting_type = r.weighting_type
    out.restriction_type = r.restriction_type
    out.indices = np.asarray(r.indices)
    out.inv_multiplicity = np.asarray(r.inv_multiplicity, np.float64)
    return out


def block_preconditioner_from_jax(prec, dtype=torch.float64,
                                  device=DEFAULT_DEVICE
                                  ) -> RestrictedPreconditioner:
    """Port ``RestrictedPreconditioner`` from a JAX one whose solver is a
    ``BlockInverse`` (its inverted blocks) or a ``BlockCG`` (its blocks,
    iteration count and inverse-block preconditioner)."""
    s = prec.solver
    if hasattr(s, "inv"):
        solver = BlockInverse(None, dtype, device,
                              inverse=np.array(s.inv, np.float64))
    else:
        inner = (None if s.precon is None else
                 BlockInverse(None, dtype, device,
                              inverse=np.array(s.precon.inv, np.float64)))
        solver = BlockCG(np.array(s.A, np.float64), precon=inner,
                         n_iterations=s.n_iterations, dtype=dtype,
                         device=device)
    return RestrictedPreconditioner(solver, restrictor_from_jax(
        prec.restrictor), dtype, device)


def domain_partition_from_jax(dp) -> list:
    """The global DoF ids of each subdomain of a JAX
    ``DomainPreconditioner`` (ascending, free DoFs only), as NumPy."""
    return [np.asarray(ids) for ids, _solve in dp.blocks]
