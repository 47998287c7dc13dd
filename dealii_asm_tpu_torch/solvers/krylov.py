"""Krylov solvers with deal.II iteration semantics (PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/krylov.py``: ``ReductionControl``
(:39; success when value <= tolerance or value < reduce·initial, checked at
step 0 on the initial residual), ``IterationNumberControl`` (:57), ``cg``
(:432, the host loop, monitoring the unpreconditioned ‖r‖ and optionally
returning the CG-Lanczos tridiagonal eigenvalues, with the stall guard of
:482-503), ``_lanczos_eigenvalues`` (:532), ``flexible_cg`` (:555,
Polak-Ribière β), ``gmres`` (:739, restarted, Givens QR, right
preconditioning by default; the math of ``_gmres_device`` :595),
``fgmres`` (:852, the preconditioned vectors Z stored), ``bicgstab``
(:918, right preconditioned, with its breakdown tests), ``richardson``
(:962), ``idr`` (:981, IDR(s) with a NumPy shadow space), ``solve``
(:1061) and ``cg_traceable`` (:1073), the coarse solver's CG to a fixed
reduction.  Dot products of sub-float64 vectors accumulate in float64.
Every solver takes its inner products from ``reduction`` (a
``Reduction``; by default ``LOCAL``, the vectors held whole on one device).
The JAX package's double-single outer loop is not ported: the outer matvec
is native float64.  While tracing is on (``utils/profiling.py``), ``solve``
is the span "solve", each CG iteration "cg.iteration" with its operator
apply "cg.operator" and preconditioner apply "cg.precond", and every read
of a device value on the host adds to the counter "host_syncs".
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils.profiling import count, solve_span, span


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


class Reduction:
    """The inner products of the solvers, on vectors held whole on one
    device: in float64, sub-float64 vectors widened first.  A sharded solve
    passes ``parallel/sharding.py::GroupReduction``, whose products sum the
    ranks' slabs in one ``all_reduce``, as the JAX package's dots on sharded
    arrays do; ``world`` and ``rank`` place a rank's rows in the global
    vector (IDR's shadow space)."""

    world = 1
    rank = 0

    def dot_t(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if a.dtype != torch.float64:
            a, b = a.double(), b.double()
        return torch.dot(a, b)

    def norm_t(self, a: torch.Tensor) -> torch.Tensor:
        if a.dtype != torch.float64:
            a = a.double()
        return torch.linalg.vector_norm(a)

    def dots(self, V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """V @ w for float64 rows V and vector w."""
        return V @ w

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> float:
        count("host_syncs")
        return float(self.dot_t(a, b))

    def norm(self, a: torch.Tensor) -> float:
        count("host_syncs")
        return float(self.norm_t(a))


LOCAL = Reduction()


def cg(A, b, M=None, control: ReductionControl | None = None,
       track_eigenvalues: bool = False, reduction=None) -> SolveResult:
    """Preconditioned CG from a zero initial guess, deal.II SolverCG
    semantics."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b.clone()
    res = red.norm(r)
    state = control.check(0, res)
    alphas, betas = [], []
    it = 0
    stall = 0
    best_res = res
    if state != "success":
        with span("cg.precond"):
            z = M(r)
        p = z
        rz = red.dot(r, z)
        while state == "iterate":
            with span("cg.iteration"):
                it += 1
                with span("cg.operator"):
                    Ap = A(p)
                pAp = red.dot(p, Ap)
                if pAp <= 0.0 and track_eigenvalues:
                    break  # breakdown: further coefficients are noise
                if pAp == 0.0:
                    break
                alpha = rz / pAp
                x = x + alpha * p
                r = r - alpha * Ap
                res = red.norm(r)
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
                with span("cg.precond"):
                    z = M(r)
                rz_new = red.dot(r, z)
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
          orthogonalization: str = "classical",
          reduction=None) -> SolveResult:
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
    red = reduction or LOCAL
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
        beta = red.norm(r)
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
                h1 = red.dots(Vk, w)
                w = torch.addmv(w, Vk.T, h1, alpha=-1.0)
                h2 = red.dots(Vk, w)
                w = torch.addmv(w, Vk.T, h2, alpha=-1.0)
                hcol = h1 + h2
            else:
                hs = []
                for j in range(k + 1):
                    hs.append(red.dot_t(Vk[j], w))
                    w = w - hs[-1] * Vk[j]
                hcol = torch.stack(hs)
            # the one device-to-host copy of the iteration
            count("host_syncs")
            col = torch.cat([hcol, red.norm_t(w)[None]]).cpu()
            H[: k + 2, k] = col.numpy()
            hk1 = H[k + 1, k]
            V[k + 1] = w / hk1 if hk1 != 0.0 else w
            it += 1
            state = control.check(it, _givens(H, cs, sn, g, k))
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


def flexible_cg(A, b, M=None, control=None, reduction=None) -> SolveResult:
    """Flexible CG from x = 0, deal.II SolverFlexibleCG: the Polak-Ribière
    β = (z, r − r_old) / (z_old, r_old), so a preconditioner that varies
    between applies keeps the iteration well defined."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b
    state = control.check(0, red.norm(r))
    it = 0
    r_old = p = rz_old = None
    while state == "iterate":
        z = M(r)
        rz = red.dot(r, z)
        if p is None:
            p = z
        else:
            p = z + (red.dot(z, r - r_old) / rz_old) * p
        it += 1
        Ap = A(p)
        pAp = red.dot(p, Ap)
        if pAp == 0.0:
            break
        alpha = rz / pAp
        r_old, rz_old = r, rz
        x = x + alpha * p
        r = r - alpha * Ap
        state = control.check(it, red.norm(r))
    return SolveResult(x, it, state == "success", control.history)


def _givens(H, cs, sn, g, k):
    """Apply the k earlier rotations to column k of H, make the new one and
    rotate g; returns |g_k+1|, the residual estimate."""
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
    return abs(g[k + 1])


def fgmres(A, b, M=None, control=None, restart: int = 28,
           reduction=None) -> SolveResult:
    """Flexible GMRES (deal.II SolverFGMRES): right preconditioned with the
    preconditioned vectors z_k = M(v_k) stored, so x is updated from them
    and M may vary between applies; modified Gram-Schmidt, Givens QR, the
    small system solved with ``np.linalg.solve`` as in the JAX package.
    Each later cycle restarts from r = b − A x."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    it = 0
    first = True
    while True:
        r = b if first else b - A(x)
        beta = red.norm(r)
        if first:
            first = False
            state = control.check(0, beta)
            if state != "iterate":
                break
        V, Z = [r / beta], []
        H = np.zeros((restart + 1, restart))
        cs, sn = np.zeros(restart), np.zeros(restart)
        g = np.zeros(restart + 1)
        g[0] = beta
        k = 0
        for k in range(restart):
            Z.append(M(V[k]))
            w = A(Z[k])
            for j in range(k + 1):
                H[j, k] = red.dot(V[j], w)
                w = w - H[j, k] * V[j]
            hk1 = H[k + 1, k] = red.norm(w)
            it += 1
            state = control.check(it, _givens(H, cs, sn, g, k))
            if state != "iterate" or hk1 == 0.0:
                k += 1
                break
            V.append(w / hk1)
        else:
            k = restart
        if k > 0:
            y = np.linalg.solve(H[:k, :k], g[:k])
            update = Z[0] * y[0]
            for j in range(1, k):
                update = update + Z[j] * y[j]
            x = x + update
        if state != "iterate":
            break
    return SolveResult(x, it, state == "success", control.history)


def bicgstab(A, b, M=None, control=None, reduction=None) -> SolveResult:
    """Right-preconditioned BiCGStab from x = 0 (deal.II SolverBicgstab's
    monitoring): each iteration checks ‖s‖ after the half step (and stops
    there with x + α·M(p)) and ‖r‖ after the full one; ρ = 0, ω = 0,
    (r̂₀, v) = 0 end the loop as breakdowns, and (t, t) = 0 sets ω = 0."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b
    state = control.check(0, red.norm(r))
    r0 = r
    rho_old = alpha = omega = 1.0
    v = p = torch.zeros_like(b)
    it = 0
    while state == "iterate":
        rho = red.dot(r0, r)
        if rho == 0.0 or omega == 0.0:
            break
        beta = (rho / rho_old) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        denom = red.dot(r0, v)
        if denom == 0.0:
            break
        alpha = rho / denom
        s = r - alpha * v
        it += 1
        state = control.check(it, red.norm(s))
        if state != "iterate":
            x = x + alpha * phat
            break
        shat = M(s)
        t = A(shat)
        tt = red.dot(t, t)
        omega = red.dot(t, s) / tt if tt else 0.0
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho_old = rho
        state = control.check(it, red.norm(r))
    return SolveResult(x, it, state == "success", control.history)


def richardson(A, b, M=None, control=None, omega: float = 1.0,
               reduction=None) -> SolveResult:
    """Preconditioned Richardson from x = 0, x ← x + ω M(b − A x), the true
    residual checked each step (deal.II SolverRelaxation)."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b
    state = control.check(0, red.norm(r))
    it = 0
    while state == "iterate":
        x = x + omega * M(r)
        r = b - A(x)
        it += 1
        state = control.check(it, red.norm(r))
    return SolveResult(x, it, state == "success", control.history)


def idr_shadow_space(n: int, s: int, seed: int) -> np.ndarray:
    """(n, s) orthonormal shadow space of IDR(s), built on the host as the
    JAX package builds it: Q of ``np.linalg.qr`` of a standard normal
    (n, s) draw from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return np.linalg.qr(rng.standard_normal((n, s)))[0]


def idr(A, b, M=None, control=None, s: int = 2, seed: int = 42,
        reduction=None) -> SolveResult:
    """IDR(s) from x = 0 (van Gijzen/Sonneveld, deal.II SolverIDR): s
    bi-orthogonalised steps against the shadow space, then one minimal-
    residual step; every step counts as an iteration and checks ‖r‖.  The
    shadow space is made once a solve on the host (``idr_shadow_space``)
    and copied to b's device in b's dtype."""
    M = M or _identity
    red = reduction or LOCAL
    control = control or ReductionControl()
    x = torch.zeros_like(b)
    r = b
    state = control.check(0, red.norm(r))
    it = 0
    # a sharded solve draws the global space and keeps its rank's rows
    n = b.shape[0]
    Pnp = idr_shadow_space(n * red.world, s, seed)[red.rank * n:
                                                   (red.rank + 1) * n]
    P = [torch.as_tensor(Pnp[:, j], device=b.device).to(b.dtype)
         for j in range(s)]
    del Pnp
    G = [torch.zeros_like(b) for _ in range(s)]
    U = [torch.zeros_like(b) for _ in range(s)]
    Mmat = np.eye(s)
    om = 1.0
    while state == "iterate":
        f = np.array([red.dot(P[j], r) for j in range(s)])
        for k in range(s):
            c = np.linalg.solve(Mmat[k:, k:], f[k:])
            v = r
            for j in range(k, s):
                v = v - c[j - k] * G[j]
            v = M(v)
            u = om * v
            for j in range(k, s):
                u = u + c[j - k] * U[j]
            g = A(u)
            for j in range(k):  # bi-orthogonalise against P[0..k-1]
                alpha = red.dot(P[j], g) / Mmat[j, j]
                g = g - alpha * G[j]
                u = u - alpha * U[j]
            G[k], U[k] = g, u
            for j in range(k, s):
                Mmat[j, k] = red.dot(P[j], g)
            if Mmat[k, k] == 0.0:
                state = "failure"
                break
            beta = f[k] / Mmat[k, k]
            x = x + beta * u
            r = r - beta * g
            it += 1
            state = control.check(it, red.norm(r))
            if state != "iterate":
                break
            for j in range(k + 1, s):
                f[j] -= beta * Mmat[j, k]
            f[k] = 0.0
        if state != "iterate":
            break
        # the dimension-reduction step
        v = M(r)
        t = A(v)
        tt = red.dot(t, t)
        om = red.dot(t, r) / tt if tt else 0.0
        x = x + om * v
        r = r - om * t
        it += 1
        state = control.check(it, red.norm(r))
    return SolveResult(x, it, state == "success", control.history)


SOLVERS = {"CG": cg, "FCG": flexible_cg, "GMRES": gmres, "FGMRES": fgmres,
           "Bicgstab": bicgstab, "IDR": idr, "Richardson": richardson}


def solve(solver_type, A, b, M=None, max_iterations=1000, abs_tolerance=1e-10,
          rel_tolerance=1e-2, control_type="ReductionControl",
          **kwargs) -> SolveResult:
    """Dispatch mirroring the reference program's solve(); ``control_type``
    "ReductionControl" or anything else for ``IterationNumberControl``;
    ``kwargs`` go to the solver (GMRES: restart, right_preconditioning,
    orthogonalization; FGMRES: restart; every solver: ``reduction``, the
    inner products of a sharded solve)."""
    if solver_type not in SOLVERS:
        raise ValueError(f"Solver <{solver_type}> is not known!")
    if control_type == "ReductionControl":
        control = ReductionControl(max_iterations, abs_tolerance,
                                   rel_tolerance)
    else:
        control = IterationNumberControl(max_iterations, abs_tolerance)
    with solve_span():
        return SOLVERS[solver_type](A, b, M=M, control=control, **kwargs)


def _host_bool(t: torch.Tensor) -> bool:
    count("host_syncs")
    return bool(t)


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
    while it < max_iterations and _host_bool(torch.dot(r, r) > target2):
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
