"""Kernel F: the unstructured-mesh Laplace apply, gather → sum-factorised
cell integral → scatter (csrc/lanes_laplace.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/lanes_vmult.py``
``LanesDDVmultKernel`` (the hyperball's outer float64 matvec, double-single
on the TPU, native float64 here); the same template in float32 serves the
ball's multigrid levels, which the JAX package runs in XLA
(``GeneralLaplaceOperator.apply_local_lanes``).

``lanes_laplace(u, tables, rhs)`` computes, on the flat DoF vector ``u``,

    vmult:     free ? Σ_c P_cᵀ (∇̂⊗N̂)ᵀ C_c (∇̂⊗N̂) P_c (free ? u : 0) : u
    residual:  rhs − vmult(u)            (when ``rhs`` is given)

with P_c the gather of cell c's DoFs through ``cell_dofs``.  It launches the
CUDA kernel for a CUDA tensor and runs ``lanes_laplace_plain`` (the JAX
package's ``apply_cells`` sum-factorised form with an ``index_add_``
scatter) for a CPU tensor.

The kernel shares kernel E's cell body (``csrc/sumfac_cell.cuh``: one thread
per 1D line of a cell, launch plan ``merged_laplace.cell_plan``); its 1D
tables travel by value in the launch, copied from ``shape_host``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fixed_sum import csr_inverse
from . import LAUNCHES
from .banded_laplace import _MODE, _check_vec
from .build import check, load
from .merged_laplace import check_shape_host


@dataclass
class LanesTables:
    """Tables of one unstructured operator, on its device.

    ``coeff``: cell-major (C, 6, Q) symmetric coefficients [xx, yy, zz, xy,
    xz, yz] in reference coordinates, quadrature points x fastest, in the
    operator's dtype; ``shape``: (4, m, m) = N, D, D, D as [quadrature
    point, node]; ``shape_host``: the same values on the host, which the
    kernel launch copies into its parameters; ``cell_dofs``: (C, m³)
    int32; ``gather``: the same with -1 at constrained DoFs; ``row_ptr``
    (n+1,) and ``slots`` int32: the CSR inverse of ``cell_dofs`` over the
    free DoFs (an empty row is a constrained DoF); ``free``: (n,) bool, a
    DoF that no cell holds (a shard's pad slots) counted as constrained,
    so that the plain version reads the kernel's empty rows as it does."""

    coeff: torch.Tensor
    shape: torch.Tensor
    shape_host: torch.Tensor
    cell_dofs: torch.Tensor
    gather: torch.Tensor
    row_ptr: torch.Tensor
    slots: torch.Tensor
    free: torch.Tensor
    p: int

    def __post_init__(self):
        check_shape_host(self.shape_host, self.p, self.coeff.dtype,
                         "LanesTables")

    @property
    def n(self) -> int:
        return self.free.numel()


def lanes_tables(cell_dofs: np.ndarray, boundary_mask: np.ndarray,
                 coeff: torch.Tensor, shape: torch.Tensor,
                 shape_host: torch.Tensor, p: int) -> LanesTables:
    """Index tables on ``coeff``'s device for ``cell_dofs`` (C, m³)."""
    dev = coeff.device
    cd = torch.as_tensor(np.ascontiguousarray(cell_dofs, np.int32), device=dev)
    free = torch.as_tensor(~np.asarray(boundary_mask, bool), device=dev)
    free &= torch.bincount(cd.reshape(-1).long(), minlength=free.numel()) > 0
    gather = torch.where(free[cd.long()], cd, -1)
    row_ptr, slots = csr_inverse(gather, free.numel())
    return LanesTables(coeff, shape, shape_host, cd, gather, row_ptr.int(),
                       slots.int(), free, p)


def sumfac_gradients(W: torch.Tensor, shape: torch.Tensor) -> tuple:
    """Reference-direction derivatives (gx, gy, gz), each (C, q, q, q) as
    [z, y, x] quadrature points, of the cell values W (C, m, m, m) as
    [z, y, x]; ``shape`` (4, m, m) = N, Dx, Dy, Dz as [point, node]."""
    N, Dx, Dy, Dz = shape
    a = torch.einsum("czyx,qx->czyq", W, N)
    dx = torch.einsum("czyx,qx->czyq", W, Dx)
    b = torch.einsum("czyq,ry->czrq", a, N)
    c = torch.einsum("czyq,ry->czrq", a, Dy)
    e = torch.einsum("czyq,ry->czrq", dx, N)
    gz = torch.einsum("czrq,sz->csrq", b, Dz)
    gy = torch.einsum("czrq,sz->csrq", c, N)
    gx = torch.einsum("czrq,sz->csrq", e, N)
    return gx, gy, gz


def sumfac_integrate(tx: torch.Tensor, ty: torch.Tensor, tz: torch.Tensor,
                     shape: torch.Tensor) -> torch.Tensor:
    """The transpose of ``sumfac_gradients``: Σ_d ∫ t_d ∂_d φ, (C, m, m, m)."""
    N, Dx, Dy, Dz = shape
    w1 = torch.einsum("csrq,sz->czrq", tz, Dz)
    w2 = torch.einsum("csrq,sz->czrq", ty, N)
    w3 = torch.einsum("csrq,sz->czrq", tx, N)
    r12 = (torch.einsum("czrq,ry->czyq", w1, N)
           + torch.einsum("czrq,ry->czyq", w2, Dy))
    r3 = torch.einsum("czrq,ry->czyq", w3, N)
    return (torch.einsum("czyq,qx->czyx", r12, N)
            + torch.einsum("czyq,qx->czyx", r3, Dx))


def sumfac_cell_apply(W: torch.Tensor, coeff: torch.Tensor,
                      shape: torch.Tensor) -> torch.Tensor:
    """Local cell integrals (∇̂⊗N̂)ᵀ C_c (∇̂⊗N̂) W_c of W (C, m, m, m) as
    [z, y, x] with ``coeff`` (C, 6, Q) and ``shape`` (4, m, m); in 2D W
    (C, m, m) as [y, x] with ``coeff`` (C, 3, Q) as [xx, yy, xy]
    (``laplace_general.py:229-236``)."""
    m = shape.shape[1]
    if W.ndim == 3:
        N, D = shape[0], shape[1]
        a = torch.einsum("cyx,qx->cyq", W, N)
        dx = torch.einsum("cyx,qx->cyq", W, D)
        gy = torch.einsum("cyq,ry->crq", a, D)
        gx = torch.einsum("cyq,ry->crq", dx, N)
        cxx, cyy, cxy = coeff.reshape(-1, 3, m, m).unbind(1)
        tx = cxx * gx + cxy * gy
        ty = cxy * gx + cyy * gy
        v = torch.einsum("crq,ry->cyq", ty, D)
        w = torch.einsum("crq,ry->cyq", tx, N)
        return (torch.einsum("cyq,qx->cyx", v, N)
                + torch.einsum("cyq,qx->cyx", w, D))
    gx, gy, gz = sumfac_gradients(W, shape)
    cxx, cyy, czz, cxy, cxz, cyz = coeff.reshape(-1, 6, m, m, m).unbind(1)
    tx = cxx * gx + cxy * gy + cxz * gz
    ty = cxy * gx + cyy * gy + cyz * gz
    tz = cxz * gx + cyz * gy + czz * gz
    return sumfac_integrate(tx, ty, tz, shape)


def lanes_laplace_plain(u: torch.Tensor, t: LanesTables,
                        rhs: torch.Tensor | None = None) -> torch.Tensor:
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    m = t.p + 1
    W = torch.where(t.free, u, zero)[t.cell_dofs].reshape(-1, m, m, m)
    local = sumfac_cell_apply(W, t.coeff, t.shape)
    v = torch.zeros_like(u).index_add_(0, t.cell_dofs.reshape(-1),
                                       local.reshape(-1))
    v = torch.where(t.free, v, u)
    return v if rhs is None else rhs - v


def lanes_laplace(u: torch.Tensor, t: LanesTables,
                  rhs: torch.Tensor | None = None) -> torch.Tensor:
    if u.device.type == "cpu":
        return lanes_laplace_plain(u, t, rhs)
    if u.device.type != "cuda":
        raise TypeError(f"lanes_laplace: unsupported device {u.device}")
    _check_vec(u, "u", t.coeff, t.n)
    if rhs is not None:
        _check_vec(rhs, "rhs", t.coeff, t.n)
    C, m3 = t.gather.shape
    m = t.p + 1
    if m3 != m ** 3 or not 1 <= t.p <= 7:
        raise ValueError(f"lanes_laplace: degree {t.p} with {m3} DoFs per "
                         "cell; the kernel takes 1 <= p <= 7")
    tab, want = t.coeff, (C, 6, m3)
    if (tab.shape != want or tab.dtype != u.dtype
            or tab.device != u.device or not tab.is_contiguous()):
        raise ValueError(f"lanes_laplace: coeff table {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}, expected a "
                         f"contiguous {want} {u.dtype} on {u.device}")
    for name in ("gather", "row_ptr", "slots"):
        tab = getattr(t, name)
        if (tab.dtype != torch.int32 or tab.device != u.device
                or not tab.is_contiguous()):
            raise TypeError(f"lanes_laplace: {name} must be a contiguous "
                            f"int32 tensor on {u.device}")
    if u.dtype == torch.float32:
        fn, key = load().dat_lanes_laplace_f32, "lanes_laplace_f32"
    elif u.dtype == torch.float64:
        fn, key = load().dat_lanes_laplace_f64, "lanes_laplace_f64"
    else:
        raise TypeError(f"lanes_laplace: unsupported dtype {u.dtype}")
    out = torch.empty_like(u)
    scratch = torch.empty((C, m3), dtype=u.dtype, device=u.device)
    err = fn(u.data_ptr(), rhs.data_ptr() if rhs is not None else None,
             out.data_ptr(), scratch.data_ptr(), t.coeff.data_ptr(),
             t.shape_host.data_ptr(), t.gather.data_ptr(),
             t.row_ptr.data_ptr(), t.slots.data_ptr(), C, t.n, t.p,
             _MODE[rhs is not None],
             torch.cuda.current_stream(u.device).cuda_stream)
    check(err, key)
    LAUNCHES[key] += 1
    return out
