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
from .ops.tensorops import SYM_PAIRS
from .ops.transfer import TwoLevelTransfer
from .ops.transfer_general import GeneralTwoLevelTransfer
from .precond.asm import ASMPreconditioner, CellASMPreconditioner
from .precond.asm_general import GeneralASMPreconditioner
from .precond.fdm import FDMCollection

# the JAX package's order of the six symmetric coefficient components
# (``_SYM_PAIRS``, ``ops/laplace_general.py:36-37``)
JAX_SYM_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


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
    from a JAX ``GeneralLaplaceOperator``: its lane-major ``coeff6`` (six
    (q, q, q, C) arrays in the JAX order) or its (C, Q, 3, 3) ``coeff``."""
    if op.coeff6 is not None:
        comps = [np.asarray(c, np.float64) for c in op.coeff6]
        C = comps[0].shape[-1]
        return np.stack([comps[JAX_SYM_PAIRS.index(pair)].reshape(-1, C).T
                         for pair in SYM_PAIRS], axis=1)
    coeff = np.asarray(op.coeff, np.float64)
    return np.stack([coeff[:, :, a, b] for a, b in SYM_PAIRS], axis=1)


def general_laplace_from_jax(op, dtype=torch.float64,
                             device=DEFAULT_DEVICE) -> GeneralLaplaceOperator:
    """Port operator from a JAX ``GeneralLaplaceOperator``: its ``coeff`` or
    ``coeff6`` and its ``jxw``."""
    return GeneralLaplaceOperator(
        general_dofs_from_jax(op.dofs), dtype=dtype, device=device,
        mapping_degree=op.mapping_degree,
        geometry=(coeff6_from_jax(op), np.asarray(op._jxw_np, np.float64)))


def general_asm_from_jax(asm, dtype=torch.float64,
                         device=DEFAULT_DEVICE) -> GeneralASMPreconditioner:
    """Port FDM Schwarz from a JAX ``GeneralASMPreconditioner`` (element
    patches): its deduplicated FDM ``collection``."""
    if asm.patch_type != "element":
        raise ValueError("the JAX preconditioner has no element tables")
    c = asm.collection
    coll = FDMCollection([np.asarray(V, np.float64) for V in c.eigvecs],
                         [np.asarray(l, np.float64) for l in c.eigvals],
                         np.asarray(c.ids))
    return GeneralASMPreconditioner(
        general_dofs_from_jax(asm.dofs), n_overlap=asm.n_overlap,
        weighting_type=asm.weighting_type, dtype=dtype, device=device,
        collection=coll)


def general_transfer_from_jax(tr, dtype=torch.float64, device=DEFAULT_DEVICE,
                              ) -> GeneralTwoLevelTransfer:
    """Port transfer from a JAX ``GeneralTwoLevelTransfer``'s T1."""
    return GeneralTwoLevelTransfer(
        general_dofs_from_jax(tr.coarse), general_dofs_from_jax(tr.fine),
        dtype=dtype, device=device, T1=np.asarray(tr.T1, np.float64))


def asm_from_jax(asm, dtype=torch.float64, device=DEFAULT_DEVICE):
    """Port FDM Schwarz from a JAX ``ASMPreconditioner``: its per-coordinate
    eigen-tables ``percoord`` (Cartesian; its ``global_fdm`` is built from
    them) or its per-cell ``collection`` (deformed)."""
    if asm.patch_type != "element":
        raise ValueError("the JAX preconditioner has no element tables")
    dofs = dofs_from_jax(asm.dofs)
    if dofs.mesh.transform is not None:
        c = asm.collection
        coll = FDMCollection([np.asarray(V, np.float64) for V in c.eigvecs],
                             [np.asarray(l, np.float64) for l in c.eigvals],
                             np.asarray(c.ids))
        return CellASMPreconditioner(dofs, n_overlap=asm.n_overlap,
                                     weighting_type=asm.weighting_type,
                                     dtype=dtype, device=device,
                                     collection=coll)
    if asm.percoord is None:
        raise ValueError("the JAX preconditioner has no per-coordinate "
                         "element tables")
    percoord = [(np.asarray(V, np.float64), np.asarray(lam, np.float64))
                for V, lam in asm.percoord]
    return ASMPreconditioner(dofs, n_overlap=asm.n_overlap,
                             weighting_type=asm.weighting_type, dtype=dtype,
                             device=device, percoord=percoord)


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
