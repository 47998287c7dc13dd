"""State carried across from the JAX package into the port's modules.

The JAX objects' tables arrive as NumPy arrays (``np.asarray``); this module
imports no jax itself.  The tests use it to drive the port with the JAX
package's tables, and to hold the port's own jax-free setup code against those
tables entry by entry.
"""

from __future__ import annotations

import numpy as np
import torch

from .fem.dofs import DofHandler
from .mesh.grid import StructuredMesh
from .ops.laplace import LaplaceOperator
from .ops.transfer import TwoLevelTransfer
from .precond.asm import ASMPreconditioner


def dofs_from_jax(dofs) -> DofHandler:
    """The port's DofHandler for a JAX package DofHandler (Cartesian)."""
    m = dofs.mesh
    if m.transform is not None:
        raise NotImplementedError("deformed meshes are not ported yet "
                                  "(ROADMAP item 8)")
    mesh = StructuredMesh(m.dim, tuple(m.n_cells), tuple(m.lengths),
                          tuple(m.periodic))
    return DofHandler(mesh, dofs.degree)


def laplace_from_jax(op, dtype=torch.float64, device="cpu") -> LaplaceOperator:
    """Port operator from a JAX ``LaplaceOperator``'s M1d_global/K1d_global."""
    factors = [(np.asarray(M, np.float64), np.asarray(K, np.float64))
               for M, K in zip(op.M1d_global, op.K1d_global)]
    return LaplaceOperator(dofs_from_jax(op.dofs), dtype=dtype, device=device,
                           factors=factors)


def asm_from_jax(asm, dtype=torch.float64, device="cpu") -> ASMPreconditioner:
    """Port FDM Schwarz from a JAX ``ASMPreconditioner``'s per-coordinate
    eigen-tables (``percoord``; its ``global_fdm`` is built from them)."""
    if asm.percoord is None or asm.patch_type != "element":
        raise ValueError("the JAX preconditioner has no per-coordinate "
                         "element tables")
    percoord = [(np.asarray(V, np.float64), np.asarray(lam, np.float64))
                for V, lam in asm.percoord]
    return ASMPreconditioner(dofs_from_jax(asm.dofs), n_overlap=asm.n_overlap,
                             weighting_type=asm.weighting_type, dtype=dtype,
                             device=device, percoord=percoord)


def transfer_from_jax(tr, dtype=torch.float64, device="cpu") -> TwoLevelTransfer:
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
