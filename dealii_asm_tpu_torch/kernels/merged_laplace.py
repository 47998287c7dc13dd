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

The kernel's cell body (``csrc/sumfac_cell.cuh``, shared with kernel F)
gives each thread one 1D line of a cell; ``cell_plan`` mirrors its launch
(``cell_shape``: cells a warp and a block, threads, shared and parameter
bytes).  The 1D tables travel by value in the launch, copied from the host
copy ``shape_host`` the operator builds once, so no launch reads the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import merged_coeff_qgrid, merged_laplace_apply
from . import LAUNCHES
from .banded_laplace import _MODE, _check_vec
from .build import check, load


# cell_shape of csrc/sumfac_cell.cuh: p -> (cells a warp, cells a block,
# threads); p = 4 by itemsize: one cell a warp in float64, lines packed
# across cells in float32
_CELL_SHAPES = {1: (8, 64, 256), 2: (3, 24, 256), 3: (2, 16, 256),
                5: (0, 7, 252), 6: (0, 5, 245), 7: (0, 4, 256)}
_CELL_SHAPES_P4 = {8: (1, 4, 128), 4: (0, 5, 125)}


@dataclass(frozen=True)
class CellPlan:
    """Kernel E's and F's cell launch at degree p: ``cells`` cells and
    ``threads`` threads a block, one thread per 1D line (m² a cell);
    ``cells_per_warp`` whole cells a warp (barrier ``__syncwarp``), 0 where
    a cell's lines span warps (``__syncthreads``); ``shared_bytes`` of
    static shared memory (three m³ stage buffers a cell); ``param_bytes``
    of the by-value (4, m, m) table parameter."""

    p: int
    itemsize: int
    cells_per_warp: int
    cells: int
    threads: int
    shared_bytes: int
    param_bytes: int

    def blocks(self, n_cells: int) -> int:
        return -(-n_cells // self.cells)

    def lanes(self):
        """(cell of the block, line, owns a line) of each thread, in thread
        order (``cell_lane``)."""
        m2 = (self.p + 1) ** 2
        for t in range(self.threads):
            if self.cells_per_warp:
                warp, lane = divmod(t, 32)
                k, li = divmod(lane, m2)
                yield (warp * self.cells_per_warp + k, li,
                       lane < self.cells_per_warp * m2)
            else:
                k, li = divmod(t, m2)
                yield k, li, True


def cell_plan(p: int, itemsize: int) -> CellPlan:
    """The launch plan of kernels E and F at degree p for float32 (itemsize
    4) or float64 (8)."""
    if not 1 <= p <= 7 or itemsize not in (4, 8):
        raise ValueError(f"cell_plan: no plan for p={p} itemsize={itemsize}")
    cpw, cells, threads = (_CELL_SHAPES_P4[itemsize] if p == 4
                           else _CELL_SHAPES[p])
    m = p + 1
    return CellPlan(p, itemsize, cpw, cells, threads,
                    cells * 3 * m ** 3 * itemsize, 4 * m * m * itemsize)


def check_shape_host(tab: torch.Tensor, p: int, dtype: torch.dtype,
                     who: str) -> None:
    """Raise unless ``tab`` is a contiguous host (4, p+1, p+1) table of
    ``dtype`` (the launch reads it with the CPU)."""
    m = p + 1
    if (tab.device.type != "cpu" or tab.dtype != dtype
            or tuple(tab.shape) != (4, m, m) or not tab.is_contiguous()):
        raise ValueError(f"{who}: host shape table {tuple(tab.shape)} "
                         f"{tab.dtype} on {tab.device}, expected a contiguous "
                         f"{(4, m, m)} {dtype} on the CPU")


@dataclass
class MergedTables:
    """Tables of one deformed operator, on its device and in its dtype.

    ``coeff``: cell-major (C, 6, Q) symmetric coefficients [xx, yy, zz, xy,
    xz, yz] in box coordinates, quadrature points x fastest ((C, 3, Q),
    [xx, yy, xy], on a 2D mesh, which only the plain version takes);
    ``shape``: (4, m, m) = N, D/h_x, D/h_y, D/h_z as [quadrature point,
    node] ((3, m, m) in 2D); ``shape_host``: the same values on the host,
    which the kernel launch copies into its parameters; ``Ev``/``Ed``:
    per-direction global value/derivative matrices (C_d·m, N_d) of the
    plain version; ``free``: the ([Nz,] Ny, Nx) bool mask of unconstrained
    nodes (the kernel tests lattice coordinates)."""

    coeff: torch.Tensor
    shape: torch.Tensor
    shape_host: torch.Tensor
    Ev: list
    Ed: list
    p: int
    cells: tuple  # ([Cz,] Cy, Cx)
    free: torch.Tensor

    def __post_init__(self):
        if len(self.cells) == 3:
            check_shape_host(self.shape_host, self.p, self.coeff.dtype,
                             "MergedTables")

    @property
    def grid_shape(self) -> tuple:
        return tuple(self.free.shape)

    @property
    def periodic(self) -> bool:
        """Whether an axis wraps (p·C nodes, not p·C + 1): kernel E refuses
        it, as the JAX kernel does (``merged_vmult.py:344``)."""
        return self.grid_shape != tuple(c * self.p + 1 for c in self.cells)


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
    if t.periodic or len(t.cells) != 3:
        raise ValueError("merged_laplace: the kernel takes non-periodic 3D "
                         "meshes only")
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
             t.shape_host.data_ptr(), cz, cy, cx, t.p,
             _MODE[rhs is not None],
             torch.cuda.current_stream(u.device).cuda_stream)
    check(err, key)
    LAUNCHES[key] += 1
    return out
