"""Chebyshev and relaxation smoothers with Lanczos eigenvalue estimation
(PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/chebyshev.py``: the i%11 start
vector (``eig_initial_guess`` :33), ``estimate_eigenvalues`` (:49; 40 CG
iterations, λ̂ = largest Lanczos eigenvalue, max estimate 1.2·λ̂),
``chebyshev_sweep_coefficients`` (:103), ``ChebyshevPreconditioner`` (:130;
1st kind on [max/range, max], 4th kind with the Lottes recurrence) and
``RelaxationPreconditioner`` (:246; ω = 2/(max/range + max)).  The factory
fills their hooks on Cartesian CUDA levels: ``fused_step`` with kernel C
(``kernels/smoother_step.py``) for single steps, and, for the degrees named
in ``DEALII_ASM_TPU_CHAIN_DEGREES``, ``fused_sweep``/``fused_sweep_zero``
with kernel D (``kernels/smoother_sweep.py``), which runs the whole
degree-k sweep.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE
from .krylov import LOCAL, IterationNumberControl, cg

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
                         device=DEFAULT_DEVICE, b0=None,
                         reduction=None) -> EigenvalueInfo:
    """Largest eigenvalue of M⁻¹A from the float64 i%11 vector, by 40
    Lanczos-CG or power iterations; returns (λ̂, 1.2·λ̂) as the reference
    prints them.  ``b0`` overrides the start vector and ``reduction`` the
    inner products (a sharded level passes its slab of the padded i%11
    vector and the group's reduction, ``parallel/driver.py``)."""
    b = eig_initial_guess(n_dofs, constrained_mask, device) if b0 is None \
        else b0
    red = reduction or LOCAL
    M = M or (lambda x: x)
    if algorithm == "power iteration":
        v = b
        lam = 1.0
        for _ in range(EIG_CG_N_ITERATIONS):
            w = M(A(v))
            norm_w = red.norm_t(w)
            lam = float(norm_w) / red.norm(v)
            v = w / norm_w
        return EigenvalueInfo(lam, 1.2 * lam, EIG_CG_N_ITERATIONS)
    if algorithm != "lanczos":
        raise ValueError(algorithm)
    # stop once converged in float64: later coefficients are noise
    tol = max(1e-8, float(np.sqrt(np.finfo(np.float64).eps))) * red.norm(b)
    control = IterationNumberControl(EIG_CG_N_ITERATIONS, tol)
    result = cg(A, b, M=M, control=control, track_eigenvalues=True,
                reduction=reduction)
    if result.tridiag_eigenvalues is None or len(result.tridiag_eigenvalues) == 0:
        lam = 1.0
    else:
        lam = float(result.tridiag_eigenvalues[-1])
    return EigenvalueInfo(lam, 1.2 * lam, result.n_iterations)


def _scalar(c: float, like: torch.Tensor) -> float:
    """``c`` as the JAX package's weakly typed Python scalar meets a vector
    like ``like``: rounded to the vector's dtype first.  Torch keeps a Python
    scalar in float32 for a bfloat16 op, so a bfloat16 level rounds it here;
    float32 and float64 need nothing."""
    if like.dtype == torch.bfloat16:
        return float(torch.tensor(c, dtype=torch.bfloat16))
    return c


def chebyshev_sweep_coefficients(degree, theta, delta, polynomial_type,
                                 lam_max=None):
    """(f1_s, f2_s) rows of the two-term recurrence

        p_s = f1_s·p_{s−1} + f2_s·M(b − A x_{s−1}),   x_s = x_{s−1} + p_s

    of a degree-``degree`` Chebyshev sweep (1st kind: the rho recurrence;
    4th kind: the Lottes factors), the rows kernel D takes."""
    if polynomial_type in ("1st kind", "first_kind", "first"):
        coefs = [(0.0, 1.0 / theta)]
        rhok = delta / theta
        for _ in range(1, degree):
            rhokp = 1.0 / (2.0 * theta / delta - rhok)
            coefs.append((rhokp * rhok, 2.0 * rhokp / delta))
            rhok = rhokp
        return coefs
    lam = float(lam_max)
    coefs = [(0.0, 4.0 / (3.0 * lam))]
    for k in range(1, degree):
        coefs.append(((2.0 * k - 1.0) / (2.0 * k + 3.0),
                      (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lam)))
    return coefs


class ChebyshevPreconditioner:
    """deal.II-style Chebyshev smoother around (A, P⁻¹)."""

    def __init__(self, A, M, n_dofs, degree=3, smoothing_range=20.0,
                 polynomial_type="1st kind",
                 eigenvalues: EigenvalueInfo | None = None,
                 constrained_mask=None, ev_algorithm="lanczos",
                 device=DEFAULT_DEVICE, eig_b0=None, reduction=None):
        self.A = A
        self.M = M
        self.degree = int(degree)
        self.smoothing_range = smoothing_range
        self.polynomial_type = polynomial_type
        if eigenvalues is None:
            eigenvalues = estimate_eigenvalues(
                A, n_dofs, M=M, constrained_mask=constrained_mask,
                algorithm=ev_algorithm, device=device, b0=eig_b0,
                reduction=reduction)
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
        # the whole sweep in one kernel call: fused_sweep(x, b) == step(x, b)
        # and fused_sweep_zero(b) == vmult(b); attached by the factory
        self.fused_sweep = None
        self.fused_sweep_zero = None

    def sweep_coefficients(self):
        """(f1, f2) rows of this smoother's sweep."""
        return chebyshev_sweep_coefficients(
            self.degree, self.theta, self.delta, self.polynomial_type,
            lam_max=self.beta_range)

    def _first_kind(self, x, b, zero_guess=False):
        theta, delta = self.theta, self.delta
        c = lambda v: _scalar(v, b)
        if zero_guess:
            p = self.M(b) * c(1.0 / theta)  # x = 0: the residual is b
            x = p
        else:
            if self.degree == 1 and self.fused_step is not None:
                return self.fused_step(x, b, 1.0 / theta)
            r = b - self.A(x)
            p = self.M(r) * c(1.0 / theta)
            x = x + p
        rhok = delta / theta
        for _ in range(1, self.degree):
            r = b - self.A(x)
            rhokp = 1.0 / (2.0 * theta / delta - rhok)
            p = c(rhokp * rhok) * p + c(2.0 * rhokp / delta) * self.M(r)
            x = x + p
            rhok = rhokp
        return x

    def _fourth_kind(self, x, b, zero_guess=False):
        lam = self.beta_range
        c = lambda v: _scalar(v, b)
        if zero_guess:
            d = self.M(b) * c(4.0 / (3.0 * lam))
        elif self.degree == 1 and self.fused_step is not None:
            return self.fused_step(x, b, 4.0 / (3.0 * lam))
        else:
            r = b - self.A(x)
            d = self.M(r) * c(4.0 / (3.0 * lam))
        for k in range(1, self.degree):
            x = x + d
            r = b - self.A(x)
            d = d * c((2.0 * k - 1.0) / (2.0 * k + 3.0)) + self.M(r) * c(
                (8.0 * k + 4.0) / ((2.0 * k + 3.0) * lam))
        return x + d

    def _apply(self, x, b, zero_guess=False):
        if zero_guess and self.fused_sweep_zero is not None:
            return self.fused_sweep_zero(b)
        if not zero_guess and self.fused_sweep is not None:
            return self.fused_sweep(x, b)
        if self.polynomial_type in ("1st kind", "first_kind", "first"):
            return self._first_kind(x, b, zero_guess)
        return self._fourth_kind(x, b, zero_guess)

    def vmult(self, b):
        return self._apply(torch.zeros_like(b), b, zero_guess=True)

    def step(self, x, b):
        return self._apply(x, b)

    def __call__(self, b):
        return self.vmult(b)


class RelaxationPreconditioner:
    """deal.II PreconditionRelaxation: x ← x + ω P⁻¹(b − A x), n_iterations
    times; ω = 2/(max/range + max) from the eigenvalue estimate unless
    given."""

    def __init__(self, A, M, n_dofs, n_iterations=3, omega=0.0,
                 eigenvalues: EigenvalueInfo | None = None,
                 smoothing_range=20.0, constrained_mask=None,
                 ev_algorithm="lanczos", device=DEFAULT_DEVICE, eig_b0=None,
                 reduction=None):
        self.A = A
        self.M = M
        self.n_iterations = int(n_iterations)
        if omega == 0.0:
            if eigenvalues is None:
                eigenvalues = estimate_eigenvalues(
                    A, n_dofs, M=M, constrained_mask=constrained_mask,
                    algorithm=ev_algorithm, device=device, b0=eig_b0,
                    reduction=reduction)
            mx = eigenvalues.max_eigenvalue_estimate
            alpha = mx / smoothing_range if smoothing_range > 1.0 else min(
                0.9 * mx, eigenvalues.min_eigenvalue_estimate)
            omega = 2.0 / (alpha + mx)
        self.eigenvalues = eigenvalues
        self.omega = omega
        # hooks as on ChebyshevPreconditioner, attached by the factory
        self.fused_step = None
        self.fused_sweep = None
        self.fused_sweep_zero = None

    def sweep_coefficients(self):
        """(f1, f2) rows: a Richardson sweep is f1 ≡ 0, f2 = ω."""
        return [(0.0, self.omega)] * self.n_iterations

    def step(self, x, b):
        if self.fused_sweep is not None:
            return self.fused_sweep(x, b)
        for _ in range(self.n_iterations):
            if self.fused_step is not None:
                x = self.fused_step(x, b, self.omega)
            else:
                x = x + _scalar(self.omega, b) * self.M(b - self.A(x))
        return x

    def vmult(self, b):
        if self.fused_sweep_zero is not None:
            return self.fused_sweep_zero(b)
        # zero initial guess: the first step is ω·M(b), with no operator
        x = _scalar(self.omega, b) * self.M(b)
        for _ in range(1, self.n_iterations):
            if self.fused_step is not None:
                x = self.fused_step(x, b, self.omega)
            else:
                x = x + _scalar(self.omega, b) * self.M(b - self.A(x))
        return x

    def __call__(self, b):
        return self.vmult(b)
