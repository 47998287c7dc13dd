"""Chebyshev smoother with Lanczos eigenvalue estimation (PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/chebyshev.py``: the i%11 start
vector (``eig_initial_guess`` :33), ``estimate_eigenvalues`` (:49; 40 CG
iterations, λ̂ = largest Lanczos eigenvalue, max estimate 1.2·λ̂) and
``ChebyshevPreconditioner`` (:130; 1st kind on [max/range, max], 4th kind
with the Lottes recurrence), with the ``fused_step`` hook the factory fills
with kernel C (``kernels/smoother_step.py``) for degree-1 steps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .krylov import IterationNumberControl, cg

EIG_CG_N_ITERATIONS = 40  # deal.II's eig_cg_n_iterations


def eig_initial_guess(n_dofs: int, constrained_mask=None,
                      device=DEFAULT_DEVICE):
    """deal.II's deterministic start vector: i % 11, mean removed, zero at
    constrained rows; float64."""
    v = (np.arange(n_dofs) % 11).astype(np.float64)
    v -= v.mean()
    if constrained_mask is not None:
        v[np.asarray(constrained_mask)] = 0.0
    return torch.as_tensor(v, device=device)


@dataclass
class EigenvalueInfo:
    min_eigenvalue_estimate: float
    max_eigenvalue_estimate: float
    cg_n_iterations: int


def estimate_eigenvalues(A, n_dofs: int, M=None, constrained_mask=None,
                         algorithm: str = "lanczos",
                         device=DEFAULT_DEVICE) -> EigenvalueInfo:
    """Largest eigenvalue of M⁻¹A from the float64 i%11 vector, by 40
    Lanczos-CG or power iterations; returns (λ̂, 1.2·λ̂) as the reference
    prints them."""
    b = eig_initial_guess(n_dofs, constrained_mask, device)
    M = M or (lambda x: x)
    if algorithm == "power iteration":
        v = b
        lam = 1.0
        for _ in range(EIG_CG_N_ITERATIONS):
            w = M(A(v))
            lam = float(torch.linalg.vector_norm(w)) / float(
                torch.linalg.vector_norm(v))
            v = w / torch.linalg.vector_norm(w)
        return EigenvalueInfo(lam, 1.2 * lam, EIG_CG_N_ITERATIONS)
    if algorithm != "lanczos":
        raise ValueError(algorithm)
    # stop once converged in float64: later coefficients are noise
    tol = max(1e-8, float(np.sqrt(np.finfo(np.float64).eps))) * float(
        torch.linalg.vector_norm(b))
    control = IterationNumberControl(EIG_CG_N_ITERATIONS, tol)
    result = cg(A, b, M=M, control=control, track_eigenvalues=True)
    if result.tridiag_eigenvalues is None or len(result.tridiag_eigenvalues) == 0:
        lam = 1.0
    else:
        lam = float(result.tridiag_eigenvalues[-1])
    return EigenvalueInfo(lam, 1.2 * lam, result.n_iterations)


class ChebyshevPreconditioner:
    """deal.II-style Chebyshev smoother around (A, P⁻¹)."""

    def __init__(self, A, M, n_dofs, degree=3, smoothing_range=20.0,
                 polynomial_type="1st kind",
                 eigenvalues: EigenvalueInfo | None = None,
                 constrained_mask=None, ev_algorithm="lanczos",
                 device=DEFAULT_DEVICE):
        self.A = A
        self.M = M
        self.degree = int(degree)
        self.smoothing_range = smoothing_range
        self.polynomial_type = polynomial_type
        if eigenvalues is None:
            eigenvalues = estimate_eigenvalues(
                A, n_dofs, M=M, constrained_mask=constrained_mask,
                algorithm=ev_algorithm, device=device)
        self.eigenvalues = eigenvalues
        mx = eigenvalues.max_eigenvalue_estimate
        mn = eigenvalues.min_eigenvalue_estimate
        alpha = mx / smoothing_range if smoothing_range > 1.0 else min(0.9 * mx, mn)
        self.alpha, self.beta_range = alpha, mx
        self.theta = (mx + alpha) / 2.0
        self.delta = (mx - alpha) / 2.0
        # callable (x, b, omega) -> x + omega·M(b − A x) in one kernel call;
        # exact for degree 1, attached by the factory on CUDA
        self.fused_step = None

    def _first_kind(self, x, b, zero_guess=False):
        theta, delta = self.theta, self.delta
        if zero_guess:
            p = self.M(b) * (1.0 / theta)  # x = 0: the residual is b
            x = p
        else:
            if self.degree == 1 and self.fused_step is not None:
                return self.fused_step(x, b, 1.0 / theta)
            r = b - self.A(x)
            p = self.M(r) * (1.0 / theta)
            x = x + p
        rhok = delta / theta
        for _ in range(1, self.degree):
            r = b - self.A(x)
            rhokp = 1.0 / (2.0 * theta / delta - rhok)
            p = (rhokp * rhok) * p + (2.0 * rhokp / delta) * self.M(r)
            x = x + p
            rhok = rhokp
        return x

    def _fourth_kind(self, x, b, zero_guess=False):
        lam = self.beta_range
        if zero_guess:
            d = self.M(b) * (4.0 / (3.0 * lam))
        elif self.degree == 1 and self.fused_step is not None:
            return self.fused_step(x, b, 4.0 / (3.0 * lam))
        else:
            r = b - self.A(x)
            d = self.M(r) * (4.0 / (3.0 * lam))
        for k in range(1, self.degree):
            x = x + d
            r = b - self.A(x)
            d = d * ((2.0 * k - 1.0) / (2.0 * k + 3.0)) + self.M(r) * (
                (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lam))
        return x + d

    def _apply(self, x, b, zero_guess=False):
        if self.polynomial_type in ("1st kind", "first_kind", "first"):
            return self._first_kind(x, b, zero_guess)
        return self._fourth_kind(x, b, zero_guess)

    def vmult(self, b):
        return self._apply(torch.zeros_like(b), b, zero_guess=True)

    def step(self, x, b):
        return self._apply(x, b)

    def __call__(self, b):
        return self.vmult(b)
