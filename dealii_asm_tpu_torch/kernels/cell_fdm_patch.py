"""Kernel G: the per-cell FDM Schwarz apply of deformed levels
(csrc/cell_fdm_patch.cu).

Replaces no TPU kernel: the JAX package applies the per-cell tables with an
XLA einsum (``dealii_asm_tpu/precond/asm.py::_fdm_apply``).
``cell_fdm_patch(src, tables)`` computes P⁻¹ src for element patches of
overlap 1 on a non-periodic 3D deformed structured mesh, with each cell's
own eigenvectors and eigenvalues and the weights and Dirichlet masks folded
per axis.  It launches the CUDA kernel for a CUDA tensor and runs the
tables' ``plain`` apply (``CellASMPreconditioner.vmult_plain``: strided
windows, batched per-cell products, overlap-add) for a CPU tensor.

The kernel walks kernel B's tiles (``csrc/fdm_tile.cuh``) with per-cell
tables staged per layer; ``launch_plan`` mirrors its tile shapes and
shared-memory layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import LAUNCHES
from .banded_laplace import _check_vec
from .build import check
from .fdm_patch import H100_SMS, LaunchPlan, _kernel_fn, _odd, _pad4


@dataclass
class CellFDMTables:
    """Per-cell tables (x first), on the preconditioner's device and dtype.

    V (P, m, m) per direction (node s, mode k; cells x fastest), lam
    (P, 3, m) the eigenvalues of directions x, y, z, fin/fout (N_d,) the
    per-axis folds; ``plain`` the same apply in plain torch (the owning
    preconditioner's chain).
    """

    V: list
    lam: torch.Tensor
    fin: list
    fout: list
    cells: tuple  # (Cz, Cy, Cx)
    p: int
    plain: Callable[[torch.Tensor], torch.Tensor]

    @property
    def grid_shape(self) -> tuple:
        return tuple(c * self.p + 1 for c in self.cells)


# (tx, ty, cz, threads) per m = p + 1, as csrc/cell_fdm_patch.cu's
# cell_tile_shape(); a float64 entry overrides where the float32 tile does
# not fit
_TILES = {2: (8, 8, 16, 128), 3: (8, 8, 16, 256)}
_TILE = (4, 4, 16, 256)
_TILES_F64 = {8: (4, 2, 16, 256)}


class CellLaunchPlan(LaunchPlan):
    """Kernel G's launch: B's tiles with G's chunk rule."""

    def chunk(self, cells: tuple, sms: int = H100_SMS) -> int:
        """Cell layers per block (``cell_chunk_layers``): of 1 .. cz, the
        fewest waves of blocks times the layers a block solves (its own and
        the one below), the larger on a tie."""
        cz_n, cy, cx = cells
        tx, ty, cz = self.tile
        tiles = -(-cx // tx) * -(-cy // ty)
        slots = sms * self.blocks_per_sm
        best, best_cost = 1, None
        for c in range(1, min(cz, cz_n) + 1):
            cost = -(-tiles * -(-cz_n // c) // slots) * (c + (c < cz_n))
            if best_cost is None or cost <= best_cost:
                best, best_cost = c, cost
        return best


def launch_plan(p: int, itemsize: int) -> CellLaunchPlan:
    """Kernel G's launch plan at degree p for float32 (itemsize 4) or
    float64 (8), with the shared bytes of ``cell_layout``."""
    if not 1 <= p <= 7 or itemsize not in (4, 8):
        raise ValueError(f"launch_plan: no plan for cell_fdm_patch p={p} "
                         f"itemsize={itemsize}")
    m = p + 1
    tx, ty, cz, threads = ((_TILES_F64.get(m) if itemsize == 8 else None)
                           or _TILES.get(m, _TILE))
    nx, ny = (tx + 1) * p + 1, (ty + 1) * p + 1
    lx, ly = (tx + 1) * m, (ty + 1) * m
    ox, oy = tx * p + 1, ty * p + 1
    npt = (tx + 1) * (ty + 1)
    vtab = 3 * npt * m * _pad4(m)  # eigenvector rows padded to 16 bytes
    buf = _pad4(m * ly * _odd(lx))
    # carry, eigenvalues, folds
    tables = _pad4(oy * ox + 3 * npt * m + nx + ny + ox + oy + m)
    return CellLaunchPlan("cell_fdm_patch", p, itemsize, (tx, ty, cz),
                          threads, (vtab + 2 * buf + tables) * itemsize)


def cell_fdm_patch(src: torch.Tensor, t: CellFDMTables) -> torch.Tensor:
    if src.device.type == "cpu":
        return t.plain(src)
    if src.device.type != "cuda":
        raise TypeError(f"cell_fdm_patch: unsupported device {src.device}")
    nz, ny, nx = t.grid_shape
    _check_vec(src, "src", t.V[0], nz * ny * nx)
    fn = _kernel_fn("cell_fdm_patch", src.dtype)
    out = torch.empty_like(src)
    cz, cy, cx = t.cells
    err = fn(src.data_ptr(), out.data_ptr(),
             *[x.data_ptr() for x in (*t.V, t.lam, *t.fin, *t.fout)],
             cz, cy, cx, t.p, torch.cuda.current_stream(src.device).cuda_stream)
    check(err, "cell_fdm_patch")
    LAUNCHES["cell_fdm_patch"] += 1
    return out
