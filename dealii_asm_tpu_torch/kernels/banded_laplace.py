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

The kernel (``csrc/banded_plane.cuh``) gives a block a WX × WY tile of
output nodes and a chunk of output planes; tiles and chunks cover the nodes
[0, N − 1) of each axis and the last block of an axis also writes the
closing (constrained) node N − 1.  ``launch_plan`` mirrors its tile shapes,
shared-memory layout, chunk rule and grid.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import separable_laplace_apply_banded
from . import LAUNCHES
from .build import check, load

_MODE = {False: 0, True: 1}  # vmult, residual
SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory (1 KB more per block)
H100_SMS = 132


def _odd(n: int) -> int:
    return n | 1


def _pad4(n: int) -> int:
    return (n + 3) & ~3


@dataclass(frozen=True)
class BandPlan:
    """Kernel A's launch at degree p (``band_shape`` and ``band_elems`` of
    ``csrc/banded_plane.cuh``): a block per (wx, wy) tile of nodes and chunk
    of at most cz planes, ``threads`` threads, ``shared_bytes`` of dynamic
    shared memory, ``minb`` its ``__launch_bounds__`` minimum of blocks per
    SM."""

    p: int
    itemsize: int
    tile: tuple  # (wx, wy, cz)
    threads: int
    minb: int
    shared_bytes: int

    def chunk(self, grid_shape: tuple, sms: int = H100_SMS) -> int:
        """Planes per block (``chunk_layers`` over the Nz − 1 core planes):
        the largest of cz, cz/2, ... that gives the card 90% of the
        blocks it holds at ``minb`` a SM."""
        nz, ny, nx = grid_shape
        wx, wy, cz = self.tile
        tiles = ((nx - 2) // wx + 1) * ((ny - 2) // wy + 1)
        want = -(-9 * sms * self.minb // 10)
        while cz > 1 and tiles * -(-(nz - 1) // cz) < want:
            cz = (cz + 1) // 2
        return cz

    def grid(self, grid_shape: tuple, sms: int = H100_SMS) -> tuple:
        """CUDA grid (x, y, z) for an (Nz, Ny, Nx) node grid."""
        nz, ny, nx = grid_shape
        wx, wy, _ = self.tile
        return ((nx - 2) // wx + 1, (ny - 2) // wy + 1,
                (nz - 2) // self.chunk(grid_shape, sms) + 1)


def launch_plan(p: int, itemsize: int) -> BandPlan:
    """Kernel A's launch plan at degree p for float32 (itemsize 4) or
    float64 (8)."""
    if not 1 <= p <= 7 or itemsize not in (4, 8):
        raise ValueError(f"launch_plan: no plan for p={p} itemsize={itemsize}")
    if itemsize == 4 and p == 4:
        wx, wy, cz, threads, minb = 64, 16, 64, 256, 2
    elif itemsize == 8 and p >= 5:
        wx, wy, cz, threads, minb = 32, 8, 64, 256, 2
    else:
        wx, wy, cz, threads, minb = 32, 16, 64, 256, 2
    band, hy, hx = 2 * p + 1, wy + 2 * p, wx + 2 * p
    # two raw planes with the band halo, two x-band planes of pairs, the
    # x, y and z tables (cz + 1 own planes, 2p on each side)
    elems = (2 * _pad4(hy * _odd(hx)) + 4 * hy * wx
             + 2 * band * (wx + wy + cz + 1 + 4 * p))
    return BandPlan(p, itemsize, (wx, wy, cz), threads, minb,
                    elems * itemsize)


@dataclass
class BandedTables:
    """Diagonal tables of the 1D factors, per direction (x first): each
    (2p+1, N_d), contiguous, on the operator's device and in its dtype.
    ``free`` is the (Nz, Ny, Nx) bool mask of unconstrained nodes, used by
    the plain version; the kernel tests the node's lattice coordinates.
    ``periodic`` (per direction, x first) marks wrapped axes, whose tables
    hold the diagonals at ``offsets`` (``tensorops.banded_offsets``); only
    the plain version takes them, as no JAX kernel does
    (``dd_vmult.py:301,569``)."""

    Mdiags: list
    Kdiags: list
    p: int
    grid_shape: tuple  # (Nz, Ny, Nx)
    free: torch.Tensor
    offsets: tuple = None
    periodic: tuple = None


def banded_laplace_plain(u: torch.Tensor, t: BandedTables,
                         rhs: torch.Tensor | None = None) -> torch.Tensor:
    g = u.reshape(t.grid_shape)
    u0 = torch.where(t.free, g, torch.zeros((), dtype=g.dtype, device=g.device))
    v = separable_laplace_apply_banded(u0, t.Mdiags, t.Kdiags, t.offsets,
                                       t.periodic)
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
    if t.periodic and any(t.periodic):
        raise ValueError("banded_laplace: the kernel does not take periodic "
                         "meshes")
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
