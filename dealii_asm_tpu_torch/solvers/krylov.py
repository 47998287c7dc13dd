"""Conjugate gradients with deal.II iteration semantics (PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/krylov.py``: ``ReductionControl``
(:39; success when value <= tolerance or value < reduce·initial, checked at
step 0 on the initial residual), ``IterationNumberControl``, ``cg`` (:432,
the host loop, monitoring the unpreconditioned ‖r‖ and optionally returning
the CG-Lanczos tridiagonal eigenvalues, with the stall guard of :482-503),
``_lanczos_eigenvalues`` (:532), ``solve`` (:1061) for CG, and
``cg_traceable`` (:1073), the coarse solver's CG to a fixed reduction.
``cg``'s dot products of sub-float64 vectors accumulate in float64.  The JAX package's double-
single outer loop is not ported: the outer matvec is native float64.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class SolveResult:
    x: object
    n_iterations: int
    converged: bool
    residuals: list = field(default_factory=list)
    tridiag_eigenvalues: np.ndarray | None = None


class ReductionControl:
    """deal.II ReductionControl: success when value < max(tolerance,
    reduce·initial)."""

    def __init__(self, max_steps=1000, tolerance=1e-10, reduce=1e-2):
        self.max_steps = max_steps
        self.tolerance = tolerance
        self.reduce = reduce
        self.initial = None
        self.history = []

    def check(self, step: int, value: float) -> str:
        value = float(value)
        self.history.append(value)
        if step == 0:
            self.initial = value
        if value <= self.tolerance or (self.initial is not None
                                       and value < self.reduce * self.initial):
            return "success"
        if step >= self.max_steps:
            return "failure"
        return "iterate"


class IterationNumberControl:
    """deal.II IterationNumberControl: run max_steps unless below tolerance."""

    def __init__(self, max_steps=100, tolerance=1e-10):
        self.max_steps = max_steps
        self.tolerance = tolerance
        self.history = []

    def check(self, step: int, value: float) -> str:
        value = float(value)
        self.history.append(value)
        if value <= self.tolerance or step >= self.max_steps:
            return "success"
        return "iterate"


def _identity(x):
    return x


def _dot(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.dtype != torch.float64:
        a, b = a.double(), b.double()
    return float(torch.dot(a, b))


def _norm(a: torch.Tensor) -> float:
    if a.dtype != torch.float64:
        a = a.double()
    return float(torch.linalg.vector_norm(a))


def cg(A, b, M=None, control: ReductionControl | None = None,
       track_eigenvalues: bool = False) -> SolveResult:
    """Preconditioned CG from a zero initial guess, deal.II SolverCG
    semantics."""
    M = M or _identity
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b.clone()
    res = _norm(r)
    state = control.check(0, res)
    alphas, betas = [], []
    it = 0
    stall = 0
    best_res = res
    if state != "success":
        z = M(r)
        p = z
        rz = _dot(r, z)
        while state == "iterate":
            it += 1
            Ap = A(p)
            pAp = _dot(p, Ap)
            if pAp <= 0.0 and track_eigenvalues:
                break  # breakdown: further coefficients are noise
            if pAp == 0.0:
                break
            alpha = rz / pAp
            x = x + alpha * p
            r = r - alpha * Ap
            res = _norm(r)
            if track_eigenvalues:
                # stagnation guard: once the residual stops decreasing in
                # working precision, Lanczos coefficients are noise
                if res < best_res * 0.999:
                    best_res = min(best_res, res)
                    stall = 0
                else:
                    stall += 1
                    if stall >= 8:
                        alphas.append(alpha)
                        break
            state = control.check(it, res)
            if state != "iterate":
                alphas.append(alpha)
                break
            z = M(r)
            rz_new = _dot(r, z)
            beta = rz_new / rz
            rz = rz_new
            p = z + beta * p
            alphas.append(alpha)
            betas.append(beta)

    eigs = None
    if track_eigenvalues and alphas:
        eigs = _lanczos_eigenvalues(alphas, betas)
    return SolveResult(x, it, state == "success", control.history, eigs)


def _lanczos_eigenvalues(alphas, betas):
    """Eigenvalues of the CG-Lanczos tridiagonal:
    T[k,k] = 1/α_k + β_{k−1}/α_{k−1}, T[k,k+1] = √β_k/α_k."""
    m = len(alphas)
    diag = np.zeros(m)
    off = np.zeros(max(m - 1, 0))
    for k in range(m):
        diag[k] = 1.0 / alphas[k]
        if k > 0:
            diag[k] += betas[k - 1] / alphas[k - 1]
        if k < m - 1:
            off[k] = np.sqrt(max(betas[k], 0.0)) / alphas[k]
    if m == 1:
        return diag
    from scipy.linalg import eigh_tridiagonal

    return eigh_tridiagonal(diag, off, eigvals_only=True)


def solve(solver_type, A, b, M=None, max_iterations=1000, abs_tolerance=1e-10,
          rel_tolerance=1e-2) -> SolveResult:
    """Dispatch mirroring the reference program's solve(); CG only."""
    if solver_type != "CG":
        raise NotImplementedError(
            f"solver {solver_type!r} is not ported yet (ROADMAP item 11)")
    return cg(A, b, M=M, control=ReductionControl(
        max_iterations, abs_tolerance, rel_tolerance))


def cg_traceable(A, b, M=None, reduction: float = 1e-4,
                 max_iterations: int = 200) -> torch.Tensor:
    """Preconditioned CG from x = 0 until ‖r‖ ≤ reduction·‖b‖ or
    ``max_iterations``; returns x only.  The JAX counterpart runs on the
    device in a ``lax.while_loop``; this loop reads ‖r‖² on the host once per
    iteration.  The dot products run in the vectors' dtype, as there.  With
    b = 0 it stops before its first division."""
    M = M or _identity
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    target2 = (reduction * reduction) * torch.dot(b, b)
    it = 0
    while it < max_iterations and bool(torch.dot(r, r) > target2):
        Ap = A(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x
