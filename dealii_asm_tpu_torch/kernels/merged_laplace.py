"""Kernel E: the deformed-geometry (merged) Laplace apply
(csrc/merged_laplace.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/merged_vmult.py``
``MergedDDVmultKernel`` (the Kershaw outer float64 matvec, double-single on
the TPU, native float64 here); the same template in float32 serves the
deformed multigrid levels, which the JAX package runs as dense XLA matmuls.

``merged_laplace(u, tables, rhs)`` computes, on the flat lexicographic
vector ``u`` of the (Nz, Ny, Nx) node grid,

    vmult:     free ? A(free ? u : 0) : u
    residual:  rhs − vmult(u)            (when ``rhs`` is given)

with A = Σ_c (∇̂⊗N̂)ᵀ C_c (∇̂⊗N̂) over the cells.  It launches the CUDA kernel
for a CUDA tensor and runs ``merged_laplace_plain`` (the JAX package's
``merged_laplace_apply`` q-space axis products) for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import merged_coeff_qgrid, merged_laplace_apply
from . import LAUNCHES
from .banded_laplace import _MODE, _check_vec
from .build import check, load


@dataclass
class MergedTables:
    """Tables of one deformed operator, on its device and in its dtype.

    ``coeff``: cell-major (C, 6, Q) symmetric coefficients [xx, yy, zz, xy,
    xz, yz] in box coordinates, quadrature points x fastest;
    ``shape``: (4, m, m) = N, D/h_x, D/h_y, D/h_z as [quadrature point,
    node]; ``Ev``/``Ed``: per-direction global value/derivative matrices
    (C_d·m, N_d) of the plain version; ``free``: the (Nz, Ny, Nx) bool mask
    of unconstrained nodes (the kernel tests lattice coordinates)."""

    coeff: torch.Tensor
    shape: torch.Tensor
    Ev: list
    Ed: list
    p: int
    cells: tuple  # (Cz, Cy, Cx)
    free: torch.Tensor

    @property
    def grid_shape(self) -> tuple:
        return tuple(c * self.p + 1 for c in self.cells)


def merged_laplace_plain(u: torch.Tensor, t: MergedTables,
                         rhs: torch.Tensor | None = None) -> torch.Tensor:
    g = u.reshape(t.grid_shape)
    u0 = torch.where(t.free, g, torch.zeros((), dtype=g.dtype, device=g.device))
    c6 = merged_coeff_qgrid(t.coeff, t.cells, t.p + 1)
    v = merged_laplace_apply(u0, t.Ev, t.Ed, c6)
    v = torch.where(t.free, v, g).reshape(-1)
    return v if rhs is None else rhs - v


def merged_laplace(u: torch.Tensor, t: MergedTables,
                   rhs: torch.Tensor | None = None) -> torch.Tensor:
    if u.device.type == "cpu":
        return merged_laplace_plain(u, t, rhs)
    if u.device.type != "cuda":
        raise TypeError(f"merged_laplace: unsupported device {u.device}")
    nz, ny, nx = t.grid_shape
    _check_vec(u, "u", t.coeff, nz * ny * nx)
    if rhs is not None:
        _check_vec(rhs, "rhs", t.coeff, nz * ny * nx)
    cz, cy, cx = t.cells
    m3 = (t.p + 1) ** 3
    if t.coeff.shape != (cz * cy * cx, 6, m3) or not t.coeff.is_contiguous():
        raise ValueError(f"merged_laplace: coefficient table of shape "
                         f"{tuple(t.coeff.shape)}, expected a contiguous "
                         f"{(cz * cy * cx, 6, m3)}")
    if u.dtype == torch.float32:
        fn, key = load().dat_merged_laplace_f32, "merged_laplace_f32"
    elif u.dtype == torch.float64:
        fn, key = load().dat_merged_laplace_f64, "merged_laplace_f64"
    else:
        raise TypeError(f"merged_laplace: unsupported dtype {u.dtype}")
    out = torch.empty_like(u)
    scratch = torch.empty((cz * cy * cx, m3), dtype=u.dtype, device=u.device)
    err = fn(u.data_ptr(), rhs.data_ptr() if rhs is not None else None,
             out.data_ptr(), scratch.data_ptr(), t.coeff.data_ptr(),
             t.shape.data_ptr(), cz, cy, cx, t.p, _MODE[rhs is not None],
             torch.cuda.current_stream(u.device).cuda_stream)
    check(err, key)
    LAUNCHES[key] += 1
    return out
