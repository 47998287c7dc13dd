"""Kernel A: the separable Cartesian Laplace apply (csrc/banded_laplace.cu).

Replaces the TPU kernels ``dealii_asm_tpu/ops/pallas/dd_vmult.py``
``F32VmultKernel`` (float32 MG levels) and ``DDVmultKernel`` (the outer
float64 matvec, double-single on the TPU, native float64 here).

``banded_laplace(u, tables, rhs)`` computes, on the flat lexicographic vector
``u`` of the (Nz, Ny, Nx) node grid,

    vmult:     free ? A(free ? u : 0) : u
    residual:  rhs − vmult(u)            (when ``rhs`` is given)

It launches the CUDA kernel for a CUDA tensor and runs
``banded_laplace_plain`` for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import separable_laplace_apply_banded
from . import LAUNCHES
from .build import check, load

_MODE = {False: 0, True: 1}  # vmult, residual


@dataclass
class BandedTables:
    """Diagonal tables of the 1D factors, per direction (x first): each
    (2p+1, N_d), contiguous, on the operator's device and in its dtype.
    ``free`` is the (Nz, Ny, Nx) bool mask of unconstrained nodes, used by
    the plain version; the kernel tests the node's lattice coordinates."""

    Mdiags: list
    Kdiags: list
    p: int
    grid_shape: tuple  # (Nz, Ny, Nx)
    free: torch.Tensor


def banded_laplace_plain(u: torch.Tensor, t: BandedTables,
                         rhs: torch.Tensor | None = None) -> torch.Tensor:
    g = u.reshape(t.grid_shape)
    u0 = torch.where(t.free, g, torch.zeros((), dtype=g.dtype, device=g.device))
    v = separable_laplace_apply_banded(u0, t.Mdiags, t.Kdiags)
    v = torch.where(t.free, v, g).reshape(-1)
    return v if rhs is None else rhs - v


def _check_vec(x: torch.Tensor, name: str, like: torch.Tensor, n: int):
    if x.device != like.device or x.dtype != like.dtype:
        raise TypeError(f"{name}: expected {like.dtype} on {like.device}, "
                        f"got {x.dtype} on {x.device}")
    if x.numel() != n or not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous vector of {n} "
                         f"entries, got shape {tuple(x.shape)}")


def banded_laplace(u: torch.Tensor, t: BandedTables,
                   rhs: torch.Tensor | None = None) -> torch.Tensor:
    if u.device.type == "cpu":
        return banded_laplace_plain(u, t, rhs)
    if u.device.type != "cuda":
        raise TypeError(f"banded_laplace: unsupported device {u.device}")
    nz, ny, nx = t.grid_shape
    n = nz * ny * nx
    tab0 = t.Mdiags[0]
    _check_vec(u, "u", tab0, n)
    if rhs is not None:
        _check_vec(rhs, "rhs", tab0, n)
    if u.dtype == torch.float32:
        fn, key = load().dat_banded_laplace_f32, "banded_laplace_f32"
    elif u.dtype == torch.float64:
        fn, key = load().dat_banded_laplace_f64, "banded_laplace_f64"
    else:
        raise TypeError(f"banded_laplace: unsupported dtype {u.dtype}")
    out = torch.empty_like(u)
    tabs = [x for d in range(3) for x in (t.Mdiags[d], t.Kdiags[d])]
    err = fn(u.data_ptr(), rhs.data_ptr() if rhs is not None else None,
             out.data_ptr(), *[x.data_ptr() for x in tabs], nz, ny, nx, t.p,
             _MODE[rhs is not None], torch.cuda.current_stream(u.device).cuda_stream)
    check(err, key)
    LAUNCHES[key] += 1
    return out
