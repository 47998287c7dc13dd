"""Plain reference of the benchmark's solves (PyTorch, float64 by default).

The same mathematics as the program under test, written again from the
finite-element definitions and computed in plain torch operations in blocks
of cell layers, on whatever device its tensors live:

- ``Level``: a structured mesh of the unit box (optionally bent by the
  Kershaw map) and a continuous Q_p space on its GLL-node lattice.  Its
  Laplace operator sums the cell integrals: on a Cartesian box the separable
  sum of 1D mass and stiffness products, on a deformed one w·|J|·J⁻¹J⁻ᵀ
  at the (p+1)³ Gauss points of an isoparametric Q_m mapping whose support
  points are the mapped GLL lattice of degree m.  Dirichlet rows and
  columns act as the identity.
- ``FDMSchwarz``: additive Schwarz over element patches of overlap 1 (each
  cell's own node lattice), each patch inverted by fast diagonalization of
  its 1D patch problems (the three-cell assembly restricted to the cell's
  nodes, an absent neighbour's end node decoupled), the multiplicity
  weights split as a square root on both sides ("symm").  The 1D problems
  take the cell's widths: on the Kershaw mesh the face-to-face distance of
  the mapped cell averaged over the face's Gauss points.
- ``Chebyshev``: first-kind Chebyshev smoothing around the Schwarz apply on
  [λ/20, λ] with λ = 1.2 × the largest Lanczos eigenvalue of 40 CG steps
  from the vector i mod 11 (mean removed, zero at Dirichlet rows).
- ``Transfer``: the tensor product of 1D interpolation matrices (h: the
  coarse cell's basis at the two children's GLL nodes; p: the low degree's
  basis at the high degree's nodes), restriction its transpose, Dirichlet
  rows and columns dropped.
- ``VCycle``: pre-smoothing from zero, residual, restriction, the coarse
  correction, prolongation and one post-smoothing step, down to a dense
  Cholesky solve of the coarsest level.
- ``cg``: preconditioned conjugate gradients from zero, stopped when ‖r‖
  falls below the relative tolerance times ‖b‖ (or the absolute one).

``build(config, level_dtype=...)`` reads a benchmark configuration (the
published JSON) and returns the outer operator and the V-cycle; an option
of the smoother or the multigrid that this module does not implement
(vertex patches, another overlap or weighting, another eigenvalue
estimate, an intermediate smoother, ...) raises ``ValueError``.  The
module numbers its DoFs as the box lattice (``lattice``) and gives the
rest of the interface of ``fembench/reference/__init__.py`` (``n_dofs``,
``points``, ``cg``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fe import gauss, gll, lagrange, mass_stiffness_1d, node_coordinates
from .kershaw import kershaw

SLAB_BYTES = 256 << 20  # cell-layer blocks of at most this many bytes


def _ax(t: torch.Tensor, A: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply A (…, out, in) along the local ``axis`` (−3 z, −2 y, −1 x) of
    cell arrays t (Cz, Cy, Cx, nz, ny, nx); A is shared (2D) or broadcast
    over the cell dimensions (Cz|1, Cy|1, Cx|1, 1, out, in)."""
    t = t.movedim(axis, -1)
    return (t @ A.mT).movedim(-1, axis)


def _slab(t: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
    """The rows z0:z1 of a per-cell table broadcast along the cell z axis."""
    return t if t.ndim < 6 or t.shape[0] == 1 else t[z0:z1]


class Level:
    """Q_p on ``cells`` = (Cx, Cy, Cz) cells of the box [0, L]³, optionally
    mapped by ``transform`` through a Q_m isoparametric mapping."""

    def __init__(self, cells, lengths, degree: int, transform=None,
                 mapping_degree: int = 1, dtype=torch.float64,
                 device="cpu"):
        self.cells = tuple(int(c) for c in cells)
        self.h = np.asarray(lengths, np.float64) / np.asarray(self.cells)
        self.p = p = int(degree)
        self.n1 = p + 1
        self.N = tuple(p * c + 1 for c in self.cells)  # nodes per axis, x first
        self.shape = tuple(reversed(self.N))  # grid (Nz, Ny, Nx)
        self.n_dofs = int(np.prod(self.N))
        self.transform = transform
        self.mapping_degree = int(mapping_degree)
        self.dtype = dtype
        self.device = torch.device(device)
        free = [torch.ones(n, dtype=torch.bool, device=self.device)
                for n in self.N]
        for f in free:
            f[0] = f[-1] = False
        self.free = (free[2][:, None, None] & free[1][None, :, None]
                     & free[0][None, None, :])
        self.free_1d = [f.to(torch.float64) for f in free]
        cz, cy, cx = reversed(self.cells)
        self.slab = max(1, SLAB_BYTES // (cy * cx * self.n1 ** 3 * 8))
        M, K = mass_stiffness_1d(p)
        if transform is None:
            self.Mh = [self._t(M * h) for h in self.h]
            self.Kh = [self._t(K / h) for h in self.h]
        else:
            self._geometry()

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=self.dtype,
                               device=self.device)

    # -- geometry of a mapped mesh --------------------------------------------

    def box_points(self, unit: np.ndarray) -> np.ndarray:
        """(C, P, 3) box coordinates of per-cell reference points ``unit``
        (P, 3), cells x fastest."""
        cx, cy, cz = self.cells
        iz, iy, ix = np.meshgrid(np.arange(cz), np.arange(cy), np.arange(cx),
                                 indexing="ij")
        idx = np.stack([ix.ravel(), iy.ravel(), iz.ravel()], axis=1)
        return (idx[:, None, :] + unit[None, :, :]) * self.h[None, None, :]

    @staticmethod
    def lattice(pts: list) -> np.ndarray:
        """(Π n, 3) tensor lattice of per-axis point sets [x, y, z], x
        fastest."""
        z, y, x = np.meshgrid(pts[2], pts[1], pts[0], indexing="ij")
        return np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    def mapped(self, unit: np.ndarray) -> np.ndarray:
        pts = self.box_points(unit)
        C, P, _ = pts.shape
        return self.transform(pts.reshape(-1, 3)).reshape(C, P, 3)

    def _geometry(self):
        """w·|J|·J⁻¹J⁻ᵀ (6 entries, xx yy zz xy xz yz) at the Gauss points
        of every cell, float64, (Cz, Cy, Cx, q, q, q, 6)."""
        m, q = self.mapping_degree, self.p + 1
        nodes = gll(m + 1)
        sp = self.mapped(self.lattice([nodes] * 3))  # (C, (m+1)³, 3)
        cx, cy, cz = self.cells
        sp = torch.as_tensor(sp, device=self.device).reshape(
            cz, cy, cx, m + 1, m + 1, m + 1, 3).movedim(-1, 3)
        xq, wq = gauss(q)
        Nm, Dm = (torch.as_tensor(a, device=self.device)
                  for a in lagrange(nodes, xq))
        w3 = torch.as_tensor(np.einsum("a,b,c->abc", wq, wq, wq),
                             device=self.device)
        coeff = torch.empty((cz, cy, cx, q, q, q, 6), dtype=torch.float64,
                            device=self.device)
        for z0 in range(0, cz, self.slab):
            s = sp[z0:z0 + self.slab]  # (cz', cy, cx, 3, m+1, m+1, m+1)
            cols = []
            for d in range(3):  # ∂x/∂ξ_d, d = x, y, z
                t = s
                for axis in (-1, -2, -3):
                    t = _ax(t, Dm if axis == -1 - d else Nm, axis)
                cols.append(t)
            J = torch.stack(cols, dim=-1).movedim(3, -2)  # [..., e, d]
            det = torch.linalg.det(J)
            if bool((det <= 0).any()):
                raise ValueError("non-positive Jacobian determinant")
            Ji = torch.linalg.inv(J)
            G = (Ji @ Ji.mT) * (w3 * det)[..., None, None]
            coeff[z0:z0 + self.slab] = torch.stack(
                [G[..., 0, 0], G[..., 1, 1], G[..., 2, 2], G[..., 0, 1],
                 G[..., 0, 2], G[..., 1, 2]], dim=-1)
        self.coeff = coeff.to(self.dtype)
        N, D = lagrange(gll(self.n1), xq)
        self.Nq, self.Dq = self._t(N), self._t(D)

    def harmonic_extents(self) -> np.ndarray:
        """(Cz, Cy, Cx, 3) mean distance between each cell's opposite faces
        along x, y, z: the mapped face points at the Gauss points of the
        face, weighted by the face's Gauss weights."""
        cx, cy, cz = self.cells
        if self.transform is None:
            return np.broadcast_to(self.h, (cz, cy, cx, 3)).copy()
        xq, wq = gauss(self.n1)
        out = np.empty((cz * cy * cx, 3))
        for d in range(3):
            faces = []
            for end in (0.0, 1.0):
                pts = [xq] * 3
                pts[d] = np.array([end])
                faces.append(self.mapped(self.lattice(pts)))
            dist = np.linalg.norm(faces[1] - faces[0], axis=2)
            ws = [wq if e != d else np.array([1.0]) for e in range(3)]
            out[:, d] = dist @ np.einsum("c,b,a->cba", ws[2], ws[1],
                                         ws[0]).ravel()
        return out.reshape(cz, cy, cx, 3)

    # -- cells of the node grid -------------------------------------------------

    def gather(self, g: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
        """(z1 − z0, Cy, Cx, n, n, n) node values of the cell layers z0:z1."""
        p, n = self.p, self.n1
        return (g[z0 * p:z1 * p + 1].unfold(0, n, p).unfold(1, n, p)
                .unfold(2, n, p))

    def scatter_add(self, out: torch.Tensor, v: torch.Tensor, z0: int):
        """Add cell values v (Cz', Cy, Cx, n, n, n) into the grid ``out``."""
        p, n = self.p, self.n1
        cz, cy, cx = v.shape[:3]
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    out[z0 * p + i:(z0 + cz - 1) * p + i + 1:p,
                        j:(cy - 1) * p + j + 1:p,
                        k:(cx - 1) * p + k + 1:p] += v[:, :, :, i, j, k]

    def cell_sum(self, g: torch.Tensor, local) -> torch.Tensor:
        """Σ over cells of local(cell values, z0, z1), block by block."""
        out = torch.zeros_like(g)
        cz = self.cells[2]
        for z0 in range(0, cz, self.slab):
            z1 = min(cz, z0 + self.slab)
            self.scatter_add(out, local(self.gather(g, z0, z1), z0, z1), z0)
        return out

    # -- the operator -----------------------------------------------------------

    def _cell_laplace(self, u: torch.Tensor, z0: int, z1: int):
        if self.transform is None:
            Mx, My, Mz = self.Mh
            Kx, Ky, Kz = self.Kh
            a, b = _ax(u, Mx, -1), _ax(u, Kx, -1)
            ay = _ax(a, My, -2)
            rest = _ax(a, Ky, -2) + _ax(b, My, -2)
            return _ax(ay, Kz, -3) + _ax(rest, Mz, -3)
        N, D = self.Nq, self.Dq
        grads = []
        for d in range(3):  # reference gradient at the Gauss points
            t = u
            for axis in (-1, -2, -3):
                t = _ax(t, D if axis == -1 - d else N, axis)
            grads.append(t)
        c = self.coeff[z0:z1]
        gx, gy, gz = grads
        flux = [c[..., 0] * gx + c[..., 3] * gy + c[..., 4] * gz,
                c[..., 3] * gx + c[..., 1] * gy + c[..., 5] * gz,
                c[..., 4] * gx + c[..., 5] * gy + c[..., 2] * gz]
        v = None
        for d in range(3):
            t = flux[d]
            for axis in (-1, -2, -3):
                t = _ax(t, (D if axis == -1 - d else N).mT, axis)
            v = t if v is None else v + t
        return v

    def unconstrained(self, g: torch.Tensor) -> torch.Tensor:
        return self.cell_sum(g, self._cell_laplace)

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u on (n,) vectors, Dirichlet rows and columns the identity; a
        vector of another dtype is computed in the level's and cast back."""
        g = u.to(self.dtype).reshape(self.shape)
        zero = torch.zeros((), dtype=self.dtype, device=g.device)
        v = self.unconstrained(torch.where(self.free, g, zero))
        return torch.where(self.free, v, g).reshape(-1).to(u.dtype)

    def dense(self) -> torch.Tensor:
        """The (n, n) float64 matrix, one unit vector an apply (small
        levels)."""
        A = torch.zeros((self.n_dofs, self.n_dofs), dtype=torch.float64,
                        device=self.device)
        e = torch.zeros(self.n_dofs, dtype=torch.float64, device=self.device)
        for j in range(self.n_dofs):
            e[j] = 1.0
            A[:, j] = self.vmult(e)
            e[j] = 0.0
        return A


def _fdm_1d(p: int, h_lo: np.ndarray, h: np.ndarray, h_hi: np.ndarray):
    """(M, K) stacks (k, p+1, p+1) of 1D element patches of overlap 1: the
    three-cell assembly restricted to the middle cell's nodes; an absent
    neighbour (width 0) decouples the patch's end node on its side."""
    M_ref, K_ref = mass_stiffness_1d(p)
    k = h.shape[0]
    M = M_ref[None] * h[:, None, None]
    K = K_ref[None] / h[:, None, None]
    M[:, 0, 0] += M_ref[p, p] * h_lo
    K[:, 0, 0] += np.where(h_lo > 0, K_ref[p, p] / np.where(h_lo > 0, h_lo, 1), 0)
    M[:, p, p] += M_ref[0, 0] * h_hi
    K[:, p, p] += np.where(h_hi > 0, K_ref[0, 0] / np.where(h_hi > 0, h_hi, 1), 0)
    for end, absent in ((0, h_lo <= 0), (p, h_hi <= 0)):
        for A in (M, K):
            A[absent, end, :] = 0.0
            A[absent, :, end] = 0.0
            A[absent, end, end] = 1.0
    return M, K


def _gen_eigh(M: np.ndarray, K: np.ndarray):
    """K V = M V Λ, Vᵀ M V = I, for stacks of small SPD pairs (NumPy on
    the host: the batches are small matrices)."""
    Li = np.linalg.inv(np.linalg.cholesky(M))
    LiT = np.swapaxes(Li, -1, -2)
    lam, Y = np.linalg.eigh(Li @ K @ LiT)
    return lam, LiT @ Y


class FDMSchwarz:
    """Additive Schwarz, element patches of overlap 1, symm weighting,
    fast-diagonalization patch inverses."""

    def __init__(self, level: Level):
        self.level = lv = level
        p, n = lv.p, lv.n1
        ext = lv.harmonic_extents()  # (Cz, Cy, Cx, 3)
        cz, cy, cx = ext.shape[:3]
        self.V, lams = [], []
        for d, (axis, C) in enumerate(((2, cx), (1, cy), (0, cz))):
            h = ext[..., d]
            lo = np.zeros_like(h)
            hi = np.zeros_like(h)
            sl = [slice(None)] * 3
            sl_lo, sl_hi = list(sl), list(sl)
            sl_lo[axis], sl_hi[axis] = slice(1, None), slice(None, -1)
            lo[tuple(sl_lo)] = h[tuple(sl_hi)]
            hi[tuple(sl_hi)] = h[tuple(sl_lo)]
            if lv.transform is None:  # Cartesian: depends on the index along d
                pick = [0, 0, 0]
                pick[axis] = slice(None)
                h, lo, hi = (a[tuple(pick)] for a in (h, lo, hi))
            M, K = _fdm_1d(p, lo.reshape(-1), h.reshape(-1), hi.reshape(-1))
            lam, V = (torch.as_tensor(a, device=lv.device)
                      for a in _gen_eigh(M, K))
            shape = [1, 1, 1]
            if lv.transform is None:
                shape[axis] = C
            else:
                shape = [cz, cy, cx]
            V = V.reshape(*shape, 1, n, n)
            lam = lam.reshape(*shape, n)
            self.V.append(V.to(lv.dtype))
            lams.append(lam)
        lx, ly, lz = lams
        # eigenvalue sums, broadcast to (Cz, Cy, Cx, n, n, n) per block
        self.lam = (lz[..., :, None, None], ly[..., None, :, None],
                    lx[..., None, None, :])
        w = []
        for d in range(3):  # multiplicity of each node among the patches
            count = torch.ones(lv.N[d], dtype=torch.float64, device=lv.device)
            count[p:-1:p] = 2.0
            w.append(lv.free_1d[d] / count.sqrt())
        self.weight = (w[2][:, None, None] * w[1][None, :, None]
                       * w[0][None, None, :]).to(lv.dtype)

    def _local(self, u: torch.Tensor, z0: int, z1: int) -> torch.Tensor:
        Vx, Vy, Vz = (_slab(V, z0, z1) for V in self.V)
        t = _ax(_ax(_ax(u, Vx.mT, -1), Vy.mT, -2), Vz.mT, -3)
        lz, ly, lx = (_slab(a, z0, z1) for a in self.lam)
        t = t * (1.0 / (lz + ly + lx)).to(t.dtype)
        return _ax(_ax(_ax(t, Vx, -1), Vy, -2), Vz, -3)

    def vmult(self, r: torch.Tensor) -> torch.Tensor:
        lv = self.level
        g = r.to(lv.dtype).reshape(lv.shape) * self.weight
        return (lv.cell_sum(g, self._local) * self.weight).reshape(-1).to(
            r.dtype)


def _tridiag_max(alphas, betas) -> float:
    m = len(alphas)
    T = np.zeros((m, m))
    for k in range(m):
        T[k, k] = 1.0 / alphas[k] + (betas[k - 1] / alphas[k - 1] if k else 0.0)
        if k < m - 1:
            T[k, k + 1] = T[k + 1, k] = math.sqrt(max(betas[k], 0.0)) / alphas[k]
    return float(np.linalg.eigvalsh(T)[-1])


def lanczos_max(A, M, level: Level, steps: int = 40) -> float:
    """Largest eigenvalue of M⁻¹A from the CG-Lanczos tridiagonal of up
    to ``steps`` CG iterations from i mod 11 (mean removed, zero at
    Dirichlet rows), in float64; stops early on convergence to 1e-8·‖b‖
    or when ‖r‖ has not fallen for 8 steps."""
    b = torch.arange(level.n_dofs, dtype=torch.float64,
                     device=level.device) % 11
    b = torch.where(level.free.reshape(-1), b - b.mean(), 0.0)
    tol = 1e-8 * float(torch.linalg.vector_norm(b))
    r = b.clone()
    x = torch.zeros_like(b)
    z = M(r)
    p = z
    rz = float(r @ z)
    alphas, betas = [], []
    best, stall = float(torch.linalg.vector_norm(r)), 0
    for it in range(1, steps + 1):
        Ap = A(p)
        pAp = float(p @ Ap)
        if pAp <= 0.0:
            break
        alpha = rz / pAp
        x = x + alpha * p
        r = r - alpha * Ap
        res = float(torch.linalg.vector_norm(r))
        alphas.append(alpha)
        if res < 0.999 * best:
            best, stall = res, 0
        else:
            stall += 1
            if stall >= 8:
                break
        if res <= tol or it >= steps:
            break
        z = M(r)
        rz_new = float(r @ z)
        betas.append(rz_new / rz)
        rz = rz_new
        p = z + betas[-1] * p
    return _tridiag_max(alphas, betas) if alphas else 1.0


class Chebyshev:
    """First-kind Chebyshev smoother of ``degree`` around (A, P⁻¹) on
    [λ/20, λ], λ = 1.2 × the Lanczos estimate."""

    def __init__(self, level: Level, degree: int, smoothing_range=20.0):
        self.A = level.vmult
        self.P = FDMSchwarz(level)
        self.degree = int(degree)
        self.lam = 1.2 * lanczos_max(self.A, self.P.vmult, level)
        lo = self.lam / smoothing_range
        self.theta = (self.lam + lo) / 2.0
        self.delta = (self.lam - lo) / 2.0

    def _sweep(self, x, b, zero):
        theta, delta = self.theta, self.delta
        if zero:
            p = self.P.vmult(b) / theta
            x = p
        else:
            p = self.P.vmult(b - self.A(x)) / theta
            x = x + p
        rho = delta / theta
        for _ in range(1, self.degree):
            rho_new = 1.0 / (2.0 * theta / delta - rho)
            p = (rho_new * rho) * p + (2.0 * rho_new / delta) * self.P.vmult(
                b - self.A(x))
            x = x + p
            rho = rho_new
        return x

    def vmult(self, b):
        return self._sweep(None, b, True)

    def step(self, x, b):
        return self._sweep(x, b, False)


class Transfer:
    """Prolongation ⊗ P̂_d from ``coarse`` to ``fine`` and its transpose."""

    def __init__(self, coarse: Level, fine: Level):
        pc, pf = coarse.p, fine.p
        if coarse.cells == fine.cells:
            T = lagrange(gll(pc + 1), gll(pf + 1))[0]
            step = pf
        else:
            nodes = gll(pc + 1)
            T = lagrange(nodes, np.concatenate([nodes / 2, 0.5 + nodes[1:] / 2]))[0]
            step = 2 * pc
        self.P = []
        for d in range(3):
            P = np.zeros((fine.N[d], coarse.N[d]))
            for c in range(coarse.cells[d]):
                P[c * step:c * step + T.shape[0], c * pc:c * pc + pc + 1] = T
            P *= (fine.free_1d[d].cpu().numpy()[:, None]
                  * coarse.free_1d[d].cpu().numpy()[None, :])
            self.P.append(torch.as_tensor(P, dtype=fine.dtype,
                                          device=fine.device))
        self.cshape, self.fshape = coarse.shape, fine.shape

    @staticmethod
    def _apply(g, mats, transpose):
        for d, P in enumerate(mats):  # axis 2 − d of the grid is direction d
            A = P.mT if transpose else P
            g = (g.movedim(2 - d, -1) @ A.mT).movedim(-1, 2 - d)
        return g

    def prolongate(self, u):
        return self._apply(u.reshape(self.cshape), self.P, False).reshape(-1)

    def restrict(self, r):
        return self._apply(r.reshape(self.fshape), self.P, True).reshape(-1)


class DenseCoarse:
    """Cholesky solve of the coarsest level's matrix (float64)."""

    def __init__(self, level: Level):
        self.L = torch.linalg.cholesky(level.dense())

    def vmult(self, b):
        x = torch.cholesky_solve(b.to(torch.float64)[:, None], self.L)
        return x[:, 0].to(b.dtype)


class VCycle:
    """One V-cycle over ``levels`` (coarse → fine), in the levels' dtype;
    the input and output keep theirs."""

    def __init__(self, levels, smoothers, transfers, coarse):
        self.levels, self.smoothers = levels, smoothers
        self.transfers, self.coarse = transfers, coarse

    def _v(self, l, b):
        if l == 0:
            return self.coarse.vmult(b)
        S, T, A = self.smoothers[l - 1], self.transfers[l - 1], self.levels[l]
        x = S.vmult(b)
        xc = self._v(l - 1, T.restrict(b - A.vmult(x)))
        return S.step(x + T.prolongate(xc), b)

    def vmult(self, b):
        dt = self.levels[-1].dtype
        return self._v(len(self.levels) - 1, b.to(dt)).to(b.dtype)


def cg(A, b, M, rel_tol: float, abs_tol: float = 1e-10,
       max_it: int = 1000):
    """(x, iterations, converged, residual history) of preconditioned CG
    from zero, in b's dtype."""
    x = torch.zeros_like(b)
    r = b.clone()
    res = [float(torch.linalg.vector_norm(r.double()))]
    target = max(abs_tol, rel_tol * res[0])
    if res[0] <= target:
        return x, 0, True, res
    z = M(r)
    p = z
    rz = float(r.double() @ z.double())
    for it in range(1, max_it + 1):
        Ap = A(p)
        alpha = rz / float(p.double() @ Ap.double())
        x = x + alpha * p
        r = r - alpha * Ap
        res.append(float(torch.linalg.vector_norm(r.double())))
        if res[-1] <= target:
            return x, it, True, res
        z = M(r)
        rz_new = float(r.double() @ z.double())
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, max_it, False, res


def _degrees(p: int, sequence: str) -> list:
    """Ascending degrees of the p-levels."""
    if sequence != "bisect":
        raise ValueError(f"p sequence {sequence!r} is not part of the reference")
    seq = [p]
    while seq[-1] > 1:
        seq.append(max(seq[-1] // 2, 1))
    return list(reversed(seq))


class Problem:
    """The mesh family of a configuration: base cells, lengths, refinements,
    degree and the map of a deformed mesh."""

    def __init__(self, config: dict):
        if int(config.get("dim", 2)) != 3:
            raise ValueError("the reference covers 3D configurations")
        mesh = config.get("mesh", {})
        name = mesh.get("name", "hypercube")
        self.refinements = int(config.get("n refinements", 6))
        self.degree = int(config.get("degree", 1))
        self.transform, self.mapping_degree = None, 1
        if name == "anisotropy":
            self.base = (1, 1, 1)
            self.lengths = (1.0, 1.0, float(mesh.get("stratch", 1.0)))
        elif name == "hypercube":
            n = int(mesh.get("n subdivisions", 1))
            self.base, self.lengths = (n, n, n), (1.0, 1.0, 1.0)
        elif name == "kershaw":
            eps = float(mesh.get("eps", 1.0))
            n = int(mesh.get("n subdivisions", 3)) * 2 ** int(
                mesh.get("n initial refinements", 1))
            self.base, self.lengths = (n, n, n), (1.0, 1.0, 1.0)
            self.transform = lambda pts: kershaw(pts, eps, eps)
            self.mapping_degree = min(int(config.get("mapping degree", 10)), 3)
        else:
            raise ValueError(f"mesh {name!r} is not part of the reference")

    def level(self, refinement: int, degree: int, dtype, device,
              mapping_degree: int | None = None) -> Level:
        cells = tuple(c * 2 ** refinement for c in self.base)
        return Level(cells, self.lengths, degree, self.transform,
                     self.mapping_degree if mapping_degree is None
                     else mapping_degree, dtype, device)


# the keys of the smoother and of its Schwarz apply that the reference
# reads, each with the values it implements beyond the check in ``build``
# (None: any), and the options of the multigrid that it implements only at
# the program's default; a configuration with any other key or value raises
_SMOOTHER = {"type": None, "degree": None, "polynomial type": None,
             "smoothing range": None, "ev algorithm": ("lanczos",),
             "preconditioner": None}
_SCHWARZ = {"type": None, "n overlap": None, "weighting type": None,
            "element centric": (True,), "sub mesh approximation": (3,),
            "weight sequence": None}
_MULTIGRID = {"mg intermediate smoother": ({},), "one-sided v-cycle": (False,),
              "n coarse cycles": (1,)}


def _unsupported(params: dict, allowed: dict, every_key: bool) -> list:
    """'key: value' of the options in ``params`` that ``allowed`` does not
    accept; with ``every_key`` a key absent from ``allowed`` counts too."""
    out = []
    for key, value in params.items():
        if key not in allowed:
            if every_key:
                out.append(f"{key}: {value!r}")
        elif allowed[key] is not None and value not in allowed[key]:
            out.append(f"{key}: {value!r}")
    return out


def build(config: dict, device="cpu", outer_dtype=torch.float64,
          level_dtype=torch.float64):
    """(outer Level, VCycle) of a configuration: its float outer operator
    and its multigrid preconditioner (h, p, hp or ph levels; Chebyshev
    around FDM overlap-1 symm on element patches; a dense coarse solve)."""
    prob = Problem(config)
    pre = config["preconditioner"]
    sm = pre["mg smoother"]
    inner = sm.get("preconditioner", {})
    if (pre.get("type") != "Multigrid" or sm.get("type") != "Chebyshev"
            or sm.get("polynomial type", "1st kind") != "1st kind"
            or inner.get("type") != "FDM" or int(inner.get("n overlap", 1)) != 1
            or inner.get("weighting type", "symm") != "symm"
            or pre.get("mg coarse grid solver", {}).get("type") != "AMG"):
        raise ValueError("the reference covers Chebyshev (1st kind) around "
                         "FDM overlap-1 symm with a dense coarse solve")
    bad = (_unsupported(sm, _SMOOTHER, True)
           + _unsupported(inner, _SCHWARZ, True)
           + _unsupported(pre, _MULTIGRID, False))
    if bad:
        raise ValueError("options the reference does not implement: "
                         + ", ".join(bad))
    R, p = prob.refinements, prob.degree
    degrees = _degrees(p, pre.get("mg p sequence", "bisect"))
    kind = pre.get("mg type", "h")
    layout = {"h": [(r, p) for r in range(R + 1)],
              "p": [(R, d) for d in degrees],
              "hp": [(0, d) for d in degrees] + [(r, p) for r in range(R + 1)],
              "ph": [(r, degrees[0]) for r in range(R + 1)]
              + [(R, d) for d in degrees]}[kind]
    layout = [lv for i, lv in enumerate(layout) if i == 0 or lv != layout[i - 1]]
    levels = [prob.level(r, d, level_dtype, device) for r, d in layout]
    smoothers = [Chebyshev(lv, int(sm.get("degree", 3)),
                           float(sm.get("smoothing range", 20.0)))
                 for lv in levels[1:]]
    transfers = [Transfer(levels[i], levels[i + 1])
                 for i in range(len(levels) - 1)]
    r0, d0 = layout[0]
    coarse = DenseCoarse(prob.level(r0, d0, torch.float64, device,
                                    mapping_degree=min(d0, 3)))
    outer = prob.level(R, p, outer_dtype, device)
    return outer, VCycle(levels, smoothers, transfers, coarse)


def lattice(config: dict) -> tuple:
    """(fine cells (Cx, Cy, Cz), degree): the reference numbers its DoFs
    as the GLL-node lattice of the box, x fastest."""
    prob = Problem(config)
    return [c * 2 ** prob.refinements for c in prob.base], prob.degree


def n_dofs(config: dict) -> int:
    cells, degree = lattice(config)
    return math.prod(degree * c + 1 for c in cells)


def points(config: dict) -> tuple:
    """(support (n, 3), free (n,), unit (n, 3)) of the finest lattice, x
    fastest: the mapped support points, the DoFs off the boundary and the
    unit-box coordinates before any map."""
    prob = Problem(config)
    cells, degree = lattice(config)
    axes = [node_coordinates(c, degree) for c in cells]
    unit = Level.lattice(axes)
    support = unit * np.asarray(prob.lengths)
    if prob.transform is not None:
        support = prob.transform(support)
    inner = [(np.arange(len(x)) > 0) & (np.arange(len(x)) < len(x) - 1)
             for x in axes]
    free = Level.lattice(inner).all(axis=1)
    return support, free, unit
