"""Geometric/polynomial multigrid V-cycle and the coarse solvers.

Counterpart of ``dealii_asm_tpu/precond/multigrid.py`` (``Multigrid``
:82-152, ``DirectCoarseSolver`` :23, ``IterativeCoarseSolver`` :49), run
eagerly: per level a zero-guess
pre-smooth, the residual rhs − A x (kernel A with its residual epilogue),
restriction, the coarse correction, prolongation, and the post-smoothing
step (kernel C on CUDA).  Options: one-sided V-cycle, several coarse cycles,
and the intermediate split (the caller nests a Multigrid as coarse solver).
While tracing is on (``utils/profiling.py``) each V-cycle and each stage is
a span on its level, the levels of nested multigrids counted together.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.general_dofs import GeneralDofHandler
from ..ops.laplace import LaplaceOperator
from ..ops.laplace_general import GeneralLaplaceOperator
from ..ops.tensorops import outer_grid, outer_sum
from ..solvers.krylov import cg_traceable
from ..utils.profiling import span


def assemble_dense(op) -> torch.Tensor:
    """(n, n) float64 constrained matrix of the float64 operator ``op`` on
    its device (identity rows and columns at constrained DoFs), its columns
    probed through ``op.vmult``.

    On a structured lattice a node couples only to nodes within p along
    every axis, so the unit vectors of all nodes whose coordinates agree
    modulo 2p + 1 (one colour) are probed together: Π_d min(2p + 1, N_d)
    applies, and row i of the colour's product is the entry of the one node
    of that colour within p of i (the cells around i hold no other node of
    it, so the sum is the unit vector's).  An unstructured mesh (small
    coarse levels) probes one unit vector an apply."""
    n, dev = op.n_dofs, op.device
    A = torch.zeros((n, n), dtype=torch.float64, device=dev)
    if isinstance(op.dofs, GeneralDofHandler):
        e = torch.zeros(n, dtype=torch.float64, device=dev)
        for j in range(n):
            e[j] = 1.0
            A[:, j] = op.vmult(e)
            e[j] = 0.0
        return A
    dofs, s = op.dofs, 2 * op.degree + 1
    k = [torch.arange(N, device=dev) for N in dofs.nodes_per_dim]  # x first
    strides = np.cumprod([1] + list(dofs.nodes_per_dim[:-1]))
    for color in itertools.product(*[range(min(s, N))
                                     for N in dofs.nodes_per_dim]):
        onehot = [(kd % s == c).double() for kd, c in zip(k, color)]
        v = op.vmult(outer_grid(onehot).reshape(-1))
        cols, ok = [], []
        for kd, c, N in zip(k, color, dofs.nodes_per_dim):
            r = (kd - c) % s
            jd = torch.where(r <= op.degree, kd - r, kd + s - r)
            cols.append(jd.clamp(0, N - 1) * int(strides[len(cols)]))
            ok.append((jd >= 0) & (jd < N))
        col = outer_sum(cols).reshape(-1)
        rows = torch.nonzero(outer_grid(ok).reshape(-1)).reshape(-1)
        A[rows, col[rows]] = v[rows]
    return A


def inverse_from_cholesky(L: torch.Tensor, dtype,
                          block: int = 4096) -> torch.Tensor:
    """A⁻¹ = L⁻ᵀL⁻¹ from the float64 Cholesky factor L (A = LLᵀ) on its
    device, cast to ``dtype``: blocks of ``block`` unit columns go through
    two triangular solves against L, so neither a float64 inverse nor a
    copy of L is held whole beside it."""
    n = L.shape[0]
    out = torch.empty((n, n), dtype=dtype, device=L.device)
    for j0 in range(0, n, block):
        k = min(block, n - j0)
        E = torch.zeros((n, k), dtype=torch.float64, device=L.device)
        E[torch.arange(j0, j0 + k), torch.arange(k)] = 1.0
        Y = torch.linalg.solve_triangular(L, E, upper=False)
        out[:, j0:j0 + k] = torch.linalg.solve_triangular(
            L.mT, Y, upper=True).to(dtype)
    return out


class DirectCoarseSolver:
    """Dense inverse of the constrained coarse matrix, applied as a matmul.

    Stands in for the reference's AMG on the coarsest level (as in the JAX
    package).  The matrix is the port's own float64 operator on ``device``
    probed with unit vectors (``assemble_dense``: identity rows and columns
    at constrained nodes); it is inverted there in float64 through its
    Cholesky factor (``inverse_from_cholesky``) and cast to ``dtype``.  The
    matrix lives only until it is factorised: 50,653 coarse DoFs (Kershaw-mp
    at 36³ cells) hold 20.5 GB in float64.  On a deformed mesh that
    operator takes its default mapping degree min(p, 3), as the JAX
    package's assembly does (``fem/assemble.py:34-36``): 1 on a Q1 coarse
    level, whatever degree the level operators map with.  On an
    unstructured mesh (a ``GeneralDofHandler``) the operator is the general
    one with its default mapping degree, 2 on the ball
    (``assemble_laplace_general``, ``fem/assemble.py:148-149``)."""

    def __init__(self, dofs, dtype=torch.float64, device=DEFAULT_DEVICE):
        cls = (GeneralLaplaceOperator if isinstance(dofs, GeneralDofHandler)
               else LaplaceOperator)
        op = cls(dofs, dtype=torch.float64, device=resolve_device(device))
        L = torch.linalg.cholesky(assemble_dense(op))
        del op
        self.Ainv = inverse_from_cholesky(L, dtype)

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
    l >= 1; transfers[l-1] connects level l-1 (coarse) to l (fine).
    Traced, the V-cycle is the span "mg.vcycle" on its finest level and its
    stages (the JAX package's "pre smooth", "residual", "restrict",
    "coarse solve", "prolongate" and "post smooth") the spans
    ``profiling.STAGES`` on theirs.  Those levels start at
    ``level_offset``: the levels below this V-cycle's coarsest when its
    coarse solver is another Multigrid's V-cycle (a ph or hp layout), else
    0."""

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
        inner = getattr(coarse_solver, "__self__", None)
        self.level_offset = (inner.level_offset + inner.n_levels - 1
                             if isinstance(inner, Multigrid) else 0)

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
        at = self.level_offset + level
        if level == 0:
            with span("mg.coarse_solve", at):
                return self._coarse_solve(rhs)
        smoother = self.smoothers[level - 1]
        transfer = self.transfers[level - 1]
        with span("mg.pre_smooth", at):
            x = smoother.vmult(rhs)
        with span("mg.residual", at):
            r = self._residual(level, rhs, x)
        with span("mg.restrict", at):
            rc = transfer.restrict(r)
        xc = self._v_step(level - 1, rc)
        with span("mg.prolongate", at):
            x = x + transfer.prolongate(xc)
        if not self.one_sided:
            with span("mg.post_smooth", at):
                x = smoother.step(x, rhs)
        return x

    def vmult(self, src):
        with span("mg.vcycle", self.level_offset + self.n_levels - 1):
            return self._v_step(self.n_levels - 1, src)

    def __call__(self, src):
        return self.vmult(src)
