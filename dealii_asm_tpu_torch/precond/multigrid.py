"""Geometric/polynomial multigrid V-cycle and the coarse solvers.

Counterpart of ``dealii_asm_tpu/precond/multigrid.py`` (``Multigrid``
:82-152, ``DirectCoarseSolver`` :23, ``IterativeCoarseSolver`` :49), run
eagerly: per level a zero-guess
pre-smooth, the residual rhs − A x (kernel A with its residual epilogue),
restriction, the coarse correction, prolongation, and the post-smoothing
step (kernel C on CUDA).  Options: one-sided V-cycle, several coarse cycles,
and the intermediate split (the caller nests a Multigrid as coarse solver).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.general_dofs import GeneralDofHandler
from ..ops.laplace import LaplaceOperator
from ..ops.laplace_general import GeneralLaplaceOperator
from ..solvers.krylov import cg_traceable


class DirectCoarseSolver:
    """Dense inverse of the constrained coarse matrix, applied as a matmul.

    Stands in for the reference's AMG on the coarsest level (as in the JAX
    package).  The matrix is the port's own float64 operator applied to unit
    vectors (identity rows and columns at constrained nodes); it is inverted
    in float64 and cast to ``dtype``.  On a deformed mesh that operator takes
    its default mapping degree min(p, 3), as the JAX package's assembly does
    (``fem/assemble.py:34-36``): 1 on a Q1 coarse level, whatever degree the
    level operators map with.  On an unstructured mesh (a
    ``GeneralDofHandler``) the operator is the general one with its default
    mapping degree, 2 on the ball (``assemble_laplace_general``,
    ``fem/assemble.py:148-149``)."""

    def __init__(self, dofs, dtype=torch.float64, device=DEFAULT_DEVICE):
        # assembled and inverted on the host on purpose: the coarse matrix is
        # small, and NumPy inverts it in float64; only Ainv goes to ``device``
        cls = (GeneralLaplaceOperator if isinstance(dofs, GeneralDofHandler)
               else LaplaceOperator)
        op = cls(dofs, dtype=torch.float64, device="cpu")
        n = dofs.n_dofs
        eye = torch.eye(n, dtype=torch.float64)
        A = torch.stack([op.vmult(eye[j]) for j in range(n)], dim=1).numpy()
        self.Ainv = torch.as_tensor(np.linalg.inv(A), dtype=dtype,
                                    device=resolve_device(device))

    def vmult(self, b):
        return self.Ainv @ b

    def __call__(self, b):
        return self.vmult(b)


class IterativeCoarseSolver:
    """Matrix-free coarse solve: CG preconditioned with the inverse diagonal,
    to ``reduction``·‖b‖ or ``max_iterations`` (the "CoarseCG" type, which
    the large configs of the scaling ladder name in place of the dense
    inverse)."""

    def __init__(self, op, reduction: float = 1e-4,
                 max_iterations: int = 200):
        self.op = op
        self.reduction = reduction
        self.max_iterations = max_iterations
        self._inv_diag = op.compute_inverse_diagonal()

    def vmult(self, b):
        inv_diag = self._inv_diag
        return cg_traceable(self.op.vmult, b, lambda v: v * inv_diag,
                            reduction=self.reduction,
                            max_iterations=self.max_iterations)

    def __call__(self, b):
        return self.vmult(b)


class Multigrid:
    """V-cycle over levels ordered coarse → fine.

    operators[l]: the level operator (with ``vmult`` and ``residual``) or a
    callable; smoothers[l-1]: object with vmult(b) and step(x, b) for level
    l >= 1; transfers[l-1] connects level l-1 (coarse) to l (fine)."""

    def __init__(self, operators, smoothers, transfers, coarse_solver,
                 one_sided: bool = False, n_coarse_cycles: int = 1):
        if len(operators) not in (len(smoothers), len(smoothers) + 1):
            raise ValueError("need one smoother per level above the coarsest")
        self.operators = operators
        self.smoothers = smoothers
        self.transfers = transfers
        self.coarse_solver = coarse_solver
        self.one_sided = one_sided
        self.n_coarse_cycles = n_coarse_cycles
        self.n_levels = len(operators)

    def _residual(self, level: int, rhs, x):
        A = self.operators[level]
        if hasattr(A, "residual"):
            return A.residual(rhs, x)
        return rhs - A(x)

    def _coarse_solve(self, rhs):
        x = self.coarse_solver(rhs)
        for _ in range(1, self.n_coarse_cycles):
            x = x + self.coarse_solver(self._residual(0, rhs, x))
        return x

    def _v_step(self, level: int, rhs):
        if level == 0:
            return self._coarse_solve(rhs)
        smoother = self.smoothers[level - 1]
        x = smoother.vmult(rhs)
        r = self._residual(level, rhs, x)
        rc = self.transfers[level - 1].restrict(r)
        xc = self._v_step(level - 1, rc)
        x = x + self.transfers[level - 1].prolongate(xc)
        if not self.one_sided:
            x = smoother.step(x, rhs)
        return x

    def vmult(self, src):
        return self._v_step(self.n_levels - 1, src)

    def __call__(self, src):
        return self.vmult(src)
