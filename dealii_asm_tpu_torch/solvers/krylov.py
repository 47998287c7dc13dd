"""CG and GMRES with deal.II iteration semantics (PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/krylov.py``: ``ReductionControl``
(:39; success when value <= tolerance or value < reduce·initial, checked at
step 0 on the initial residual), ``IterationNumberControl``, ``cg`` (:432,
the host loop, monitoring the unpreconditioned ‖r‖ and optionally returning
the CG-Lanczos tridiagonal eigenvalues, with the stall guard of :482-503),
``_lanczos_eigenvalues`` (:532), ``gmres`` (:739, restarted, Givens QR,
right preconditioning by default; the math of ``_gmres_device`` :595),
``solve`` (:1061) for CG and GMRES, and ``cg_traceable`` (:1073), the
coarse solver's CG to a fixed reduction.  Dot products of sub-float64
vectors accumulate in float64.  The JAX package's double-single outer loop
is not ported: the outer matvec is native float64.
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


def _f64(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.float64 else t.double()


def gmres(A, b, M=None, control: ReductionControl | None = None,
          restart: int = 28, right_preconditioning: bool = True,
          orthogonalization: str = "classical") -> SolveResult:
    """Restarted GMRES with a Givens QR of the Hessenberg matrix; right
    preconditioning by default, as deal.II's SolverGMRES in the reference
    program.  ``orthogonalization`` "classical" is CGS2 (two Gram-Schmidt
    passes, each two matrix-vector products with the basis, H's column the
    sum of both), anything else modified Gram-Schmidt.

    The basis is one preallocated (restart + 1, n) tensor in b's dtype; its
    products run in float64.  Each iteration copies the k + 2 new Hessenberg
    entries to the host once; the rotations, the convergence test on |g_k+1|
    (the residual estimate, recorded once per iteration in
    ``control.history``) and the small triangular solve run there in NumPy.
    A breakdown step (h_k+1,k = 0) counts as an iteration and ends the
    cycle; each later cycle restarts from r = b − A x (the first from
    x = 0)."""
    M = M or _identity
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    V = torch.empty((restart + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    it = 0
    state = "iterate"
    first = True
    while True:
        r = b if first else b - A(x)
        if not right_preconditioning:
            r = M(r)
        beta = _norm(r)
        if first:
            first = False
            state = control.check(0, beta)
            if state != "iterate":
                break
        V[0] = r / beta
        H = np.zeros((restart + 1, restart))
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        for k in range(restart):
            w = A(M(V[k])) if right_preconditioning else M(A(V[k]))
            w = _f64(w)
            Vk = _f64(V[: k + 1])
            if orthogonalization == "classical":
                h1 = Vk @ w
                w = torch.addmv(w, Vk.T, h1, alpha=-1.0)
                h2 = Vk @ w
                w = torch.addmv(w, Vk.T, h2, alpha=-1.0)
                hcol = h1 + h2
            else:
                hs = []
                for j in range(k + 1):
                    hs.append(torch.dot(Vk[j], w))
                    w = w - hs[-1] * Vk[j]
                hcol = torch.stack(hs)
            # the one device-to-host copy of the iteration
            col = torch.cat([hcol, torch.linalg.vector_norm(w)[None]]).cpu()
            H[: k + 2, k] = col.numpy()
            hk1 = H[k + 1, k]
            V[k + 1] = w / hk1 if hk1 != 0.0 else w
            for j in range(k):
                t = cs[j] * H[j, k] + sn[j] * H[j + 1, k]
                H[j + 1, k] = -sn[j] * H[j, k] + cs[j] * H[j + 1, k]
                H[j, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            cs[k] = H[k, k] / denom if denom else 1.0
            sn[k] = H[k + 1, k] / denom if denom else 0.0
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            it += 1
            state = control.check(it, abs(g[k + 1]))
            if state != "iterate" or hk1 == 0.0:
                k += 1
                break
        else:
            k = restart
        if k > 0:
            from scipy.linalg import solve_triangular

            y = solve_triangular(H[:k, :k], g[:k])
            update = _f64(V[:k]).T @ torch.as_tensor(y, device=b.device)
            update = update.to(b.dtype)
            if right_preconditioning:
                update = M(update)
            x = x + update
        if state != "iterate":
            break
    return SolveResult(x, it, state == "success", control.history)


_SOLVERS = {"CG": cg, "GMRES": gmres}


def solve(solver_type, A, b, M=None, max_iterations=1000, abs_tolerance=1e-10,
          rel_tolerance=1e-2, **kwargs) -> SolveResult:
    """Dispatch mirroring the reference program's solve() for CG and GMRES;
    ``kwargs`` go to the solver (GMRES: restart, right_preconditioning,
    orthogonalization)."""
    if solver_type not in _SOLVERS:
        raise NotImplementedError(
            f"solver {solver_type!r} is not ported yet (ROADMAP item 11c)")
    return _SOLVERS[solver_type](A, b, M=M, control=ReductionControl(
        max_iterations, abs_tolerance, rel_tolerance), **kwargs)


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
