"""Geometric/polynomial multigrid V-cycle and the direct coarse solver.

Counterpart of ``dealii_asm_tpu/precond/multigrid.py`` (``Multigrid``
:82-152, ``DirectCoarseSolver`` :23), run eagerly: per level a zero-guess
pre-smooth, the residual rhs − A x (kernel A with its residual epilogue),
restriction, the coarse correction, prolongation, and the post-smoothing
step (kernel C on CUDA).  Options: one-sided V-cycle, several coarse cycles,
and the intermediate split (the caller nests a Multigrid as coarse solver).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.laplace import LaplaceOperator


class DirectCoarseSolver:
    """Dense inverse of the constrained coarse matrix, applied as a matmul.

    Stands in for the reference's AMG on the coarsest level (as in the JAX
    package).  The matrix is the port's own float64 operator applied to unit
    vectors (identity rows and columns at constrained nodes); it is inverted
    in float64 and cast to ``dtype``."""

    def __init__(self, dofs, dtype=torch.float64, device="cpu"):
        op = LaplaceOperator(dofs, dtype=torch.float64, device="cpu")
        n = dofs.n_dofs
        eye = torch.eye(n, dtype=torch.float64)
        A = torch.stack([op.vmult(eye[j]) for j in range(n)], dim=1).numpy()
        self.Ainv = torch.as_tensor(np.linalg.inv(A), dtype=dtype,
                                    device=resolve_device(device))

    def vmult(self, b):
        return self.Ainv @ b

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
