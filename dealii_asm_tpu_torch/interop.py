"""State carried across from the JAX package into the port's modules.

The JAX objects' tables arrive as NumPy arrays (``np.asarray``); this module
imports no jax itself.  The tests use it to drive the port with the JAX
package's tables, and to hold the port's own jax-free setup code against those
tables entry by entry.  A deformed mesh keeps the JAX mesh's transform, a
NumPy callable.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import DEFAULT_DEVICE
from .fem.dofs import DofHandler
from .mesh.grid import StructuredMesh
from .ops.laplace import LaplaceOperator
from .ops.transfer import TwoLevelTransfer
from .precond.asm import ASMPreconditioner, CellASMPreconditioner
from .precond.fdm import FDMCollection


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
