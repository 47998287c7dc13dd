"""Matrix-based Schwarz preconditioners (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/block_asm.py`` (:34-310), the
reference program's matrix-based family:

- ``Restrictor``: per-patch global index lists ("element" of overlap
  1..p + 1, "vertex" stars, "vertex_all") with the constrained DoFs and
  the slots outside the mesh at the pad index n, and the inverse
  multiplicities;
- ``BlockInverse``: dense patch blocks of the assembled matrix, inverted
  once at setup, applied as a batched matrix-vector product;
- ``BlockCG``: a fixed number of CG iterations on every block at once;
- ``BlockDiagonal`` and ``BlockTriDiagonal`` (a batched Thomas solve);
- ``RestrictedPreconditioner``: weight → gather → block solve → scatter-add
  → weight.

The blocks come from the host assembly (``fem/assemble.py``: the true
matrix, or its FE_Q_iso_Q1 "lobatto"/"equidistant" approximation, or per
patch the sub-mesh re-assembly of ``SubMeshPreconditioner``) and are
extracted on the host, as in the JAX package; they are inverted with
``torch.linalg.inv`` in float64 on the operator's device (the JAX package
inverts with NumPy on the host) and cast to the operator's dtype.  The
applies run on that device: a batched product for the inverse, a batched
loop for CG, and the fixed-order scatter of ``ops/fixed_sum.py``.  The JAX
package computes these applies as XLA einsums, not in a Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..fem.assemble import assemble_laplace, assemble_laplace_iso_q1
from ..fem.dofs import DofHandler
from ..fem.patches import (element_patch_indices, vertex_all_patch_indices,
                           vertex_patch_indices)
from ..mesh.grid import patch_submesh
from ..ops.fixed_sum import FixedOrderSum
from ..utils.config import get_param


class Restrictor:
    """Per-patch global index lists (P, L), pad index n, and the inverse
    multiplicity of each DoF over the patches (1 where no patch holds it)."""

    def __init__(self, dofs, n_overlap=1, weighting_type="symm",
                 restriction_type="element"):
        self.dofs = dofs
        self.weighting_type = weighting_type
        self.restriction_type = restriction_type
        n = dofs.n_dofs
        if restriction_type == "element":
            idx = element_patch_indices(dofs, n_overlap)
        elif restriction_type == "vertex":
            idx, _ = vertex_patch_indices(dofs)
        elif restriction_type == "vertex_all":
            idx, _ = vertex_all_patch_indices(dofs)
        else:
            raise ValueError(restriction_type)
        # constrained DoFs take no part
        idx = np.where(dofs.boundary_mask[np.clip(idx, 0, n - 1)] | (idx >= n),
                       n, idx)
        self.indices = idx
        counts = np.bincount(idx.reshape(-1), minlength=n + 1)[:n].astype(
            np.float64)
        counts[counts == 0] = 1.0
        self.inv_multiplicity = 1.0 / counts


def _extract_blocks(A_csr, indices: np.ndarray, n: int) -> np.ndarray:
    """(P, L, L) dense patch blocks of the CSR matrix; pad slots become
    decoupled identity rows."""
    P, L = indices.shape
    blocks = np.zeros((P, L, L))
    A = A_csr.tocsr()
    A.sort_indices()
    for pi in range(P):
        ids = indices[pi]
        vv = np.where(ids < n)[0]
        sub = A[ids[vv]][:, ids[vv]].toarray()
        blocks[pi][np.ix_(vv, vv)] = sub
        pad = np.where(ids >= n)[0]
        blocks[pi][pad, pad] = 1.0
    return blocks


def _batched(r: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    return torch.bmm(M, r.unsqueeze(-1)).squeeze(-1)


class BlockInverse:
    """The blocks' inverses, computed once in float64: on a CUDA device
    there, on the CPU with NumPy as the JAX package does (the batched
    torch inverse of this CPU build fails on batches of 343 × 343 blocks);
    ``inverse`` gives them instead (``interop.py`` passes the JAX ones)."""

    def __init__(self, blocks: np.ndarray, dtype=torch.float64,
                 device=DEFAULT_DEVICE, inverse: np.ndarray = None):
        dev = resolve_device(device)
        if inverse is None and dev.type == "cuda":
            inv = torch.linalg.inv(torch.as_tensor(blocks, device=dev))
        else:
            inv = torch.as_tensor(np.linalg.inv(blocks) if inverse is None
                                  else inverse, device=dev)
        self.inv = inv.to(dtype)

    def apply(self, r):  # r: (P, L)
        return _batched(r, self.inv)


class BlockCG:
    """A fixed number of CG iterations on every block at once, from zero,
    optionally preconditioned by another block solver; a zero curvature or
    residual product gives a zero step, as in the JAX package."""

    def __init__(self, blocks: np.ndarray, precon=None, n_iterations=1,
                 dtype=torch.float64, device=DEFAULT_DEVICE):
        self.A = torch.as_tensor(blocks, device=resolve_device(device)).to(
            dtype)
        self.n_iterations = n_iterations
        self.precon = precon

    def apply(self, r):
        M = self.precon.apply if self.precon is not None else (lambda x: x)
        x = torch.zeros_like(r)
        res = r
        z = M(res)
        p = z
        rz = (res * z).sum(dim=1, keepdim=True)
        one = torch.ones((), dtype=r.dtype, device=r.device)
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        for _ in range(self.n_iterations):
            Ap = _batched(p, self.A)
            pAp = (p * Ap).sum(dim=1, keepdim=True)
            alpha = torch.where(pAp != 0,
                                rz / torch.where(pAp != 0, pAp, one), zero)
            x = x + alpha * p
            res = res - alpha * Ap
            z = M(res)
            rz_new = (res * z).sum(dim=1, keepdim=True)
            beta = torch.where(rz != 0,
                               rz_new / torch.where(rz != 0, rz, one), zero)
            p = z + beta * p
            rz = rz_new
        return x


class BlockDiagonal:
    """The blocks' inverted diagonals (a zero diagonal entry counts as 1)."""

    def __init__(self, blocks: np.ndarray, dtype=torch.float64,
                 device=DEFAULT_DEVICE):
        d = np.einsum("pii->pi", blocks).copy()
        d[d == 0] = 1.0
        self.inv_diag = torch.as_tensor(1.0 / d, device=resolve_device(
            device)).to(dtype)

    def apply(self, r):
        return self.inv_diag * r


class BlockTriDiagonal:
    """Batched Thomas solve of the blocks' tridiagonal parts."""

    def __init__(self, blocks: np.ndarray, dtype=torch.float64,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.a, self.b, self.c = (
            torch.as_tensor(np.stack([np.diagonal(bl, k) for bl in blocks]),
                            device=dev).to(dtype) for k in (-1, 0, 1))
        self.L = blocks.shape[1]

    def apply(self, r):
        a, b, c, L = self.a, self.b, self.c, self.L
        cp = [c[:, 0] / b[:, 0]]
        dp = [r[:, 0] / b[:, 0]]
        for i in range(1, L):
            denom = b[:, i] - a[:, i - 1] * cp[i - 1]
            cp.append(c[:, i] / denom if i < L - 1
                      else torch.zeros_like(denom))
            dp.append((r[:, i] - a[:, i - 1] * dp[i - 1]) / denom)
        x = [None] * L
        x[L - 1] = dp[L - 1]
        for i in range(L - 2, -1, -1):
            x[i] = dp[i] - cp[i] * x[i + 1]
        return torch.stack(x, dim=1)


class RestrictedPreconditioner:
    """x·w → gather the patches → block solve → fixed-order scatter-add
    → ·w; w is the inverse multiplicity ("pre"/"post") or its square root
    ("symm")."""

    def __init__(self, solver, restrictor: Restrictor, dtype=torch.float64,
                 device=DEFAULT_DEVICE):
        dev = resolve_device(device)
        self.solver = solver
        self.restrictor = restrictor
        self.dtype = dtype
        self.n = restrictor.dofs.n_dofs
        self.idx = torch.as_tensor(restrictor.indices.astype(np.int64),
                                   device=dev)
        wt = restrictor.weighting_type
        w = restrictor.inv_multiplicity
        self.w = torch.as_tensor(np.sqrt(w) if wt == "symm" else w,
                                 device=dev).to(dtype)
        self.weighting_type = wt
        self.is_symmetric = wt in ("none", "symm")
        self._scatter = FixedOrderSum(self.idx, self.n)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        x = src.to(self.dtype)
        if self.weighting_type in ("pre", "symm"):
            x = x * self.w
        y = self.solver.apply(torch.cat([x, x.new_zeros(1)])[self.idx])
        dst = self._scatter(y)
        if self.weighting_type in ("post", "symm"):
            dst = dst * self.w
        return dst.to(src.dtype)

    def __call__(self, src):
        return self.vmult(src)


def _assemble(dofs, approximation: str = "none", constrained="identity"):
    """The matrix the blocks come from: the true operator or its iso-Q1
    approximation (structured meshes, as in the JAX package)."""
    if approximation in ("", "none"):
        return assemble_laplace(dofs, constrained=constrained)
    if approximation in ("lobatto", "equidistant"):
        return assemble_laplace_iso_q1(dofs, points=approximation,
                                       constrained=constrained)
    raise ValueError(f"Matrix approximation <{approximation}> is not known!")


def _submesh_blocks(dofs, n_overlap: int, approximation: str = "none"):
    """(C, m^dim, m^dim) element-patch blocks re-assembled on each cell's
    3^dim sub-mesh (raw Neumann Laplace, its principal submatrix on the
    window; slots outside the sub-mesh decoupled), the reference program's
    SubMeshMatrixView.  Undeformed meshes reuse the blocks of equal
    (sub-mesh size, lower flags)."""
    mesh, p, o = dofs.mesh, dofs.degree, n_overlap
    m, dim = p - 1 + 2 * o, mesh.dim
    blocks = np.zeros((mesh.n_cells_total, m ** dim, m ** dim))
    cache: dict = {}
    for c in range(mesh.n_cells_total):
        sub, lo = patch_submesh(mesh, c)
        key = (sub.n_cells, lo) if mesh.transform is None else None
        if key is not None and key in cache:
            blocks[c] = cache[key]
            continue
        sub_dofs = DofHandler(sub, p)
        A = _assemble(sub_dofs, approximation, constrained="raw").toarray()
        # window slot s of axis d is sub-mesh node lo·p − (o − 1) + s
        strides = np.cumprod([1] + list(sub_dofs.nodes_per_dim[:-1]))
        win = np.zeros(m ** dim, dtype=np.int64)
        ok = np.ones(m ** dim, dtype=bool)
        for d in range(dim):
            n_sub = sub_dofs.nodes_per_dim[d]
            ids = lo[d] * p - (o - 1) + np.arange(m)
            sel = np.tile(np.repeat(np.arange(m), m ** d), m ** (dim - 1 - d))
            win += np.clip(ids, 0, n_sub - 1)[sel] * strides[d]
            ok &= ((ids >= 0) & (ids < n_sub))[sel]
        B = np.eye(m ** dim)
        vv = np.where(ok)[0]
        B[np.ix_(vv, vv)] = A[np.ix_(win[vv], win[vv])]
        blocks[c] = B
        if key is not None:
            cache[key] = B
    return blocks


def create_block_preconditioner(op, params: dict, log=lambda *_: None):
    """AdditiveSchwarzPreconditioner, SubMeshPreconditioner or
    CGPreconditioner for the operator ``op`` from its config node
    (``block_asm.py:264-310``)."""
    ptype = params.get("type")
    log(f"- Create system preconditioner: {ptype}\n")
    dofs, dtype, device = op.dofs, op.dtype, op.device
    n_overlap = min(int(get_param(params, "n overlap", 1)), op.degree + 1)
    weighting = get_param(params, "weighting type", "symm")
    restriction_type = get_param(params, "restriction type", "element")
    approximation = get_param(params, "matrix approximation", "none")

    restrictor = Restrictor(dofs, n_overlap, weighting, restriction_type)
    n = dofs.n_dofs
    if ptype == "SubMeshPreconditioner" and restriction_type == "element":
        blocks = _submesh_blocks(dofs, n_overlap, approximation)
        # decouple the slots the restrictor masks (constrained DoFs)
        for c in range(blocks.shape[0]):
            bad = np.where(restrictor.indices[c] >= n)[0]
            blocks[c][bad, :] = 0.0
            blocks[c][:, bad] = 0.0
            blocks[c][bad, bad] = 1.0
    else:
        blocks = _extract_blocks(_assemble(dofs, approximation),
                                 restrictor.indices, n)

    if ptype in ("AdditiveSchwarzPreconditioner", "SubMeshPreconditioner"):
        solver = BlockInverse(blocks, dtype, device)
    elif ptype == "CGPreconditioner":
        n_it = int(get_param(params, "n iterations", 1))
        inner = BlockInverse(blocks, dtype, device)
        exact = (blocks if approximation in ("", "none") else
                 _extract_blocks(_assemble(dofs), restrictor.indices, n))
        solver = BlockCG(exact, precon=inner, n_iterations=n_it, dtype=dtype,
                         device=device)
    else:
        raise ValueError(ptype)
    return RestrictedPreconditioner(solver, restrictor, dtype, device)
