"""Kernel B: element-centric overlap-1 FDM Schwarz apply (csrc/fdm_patch.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/fdm_slab.py``
``FDMSlabKernel``.  ``fdm_patch(src, tables, omega, xold)`` computes

    omega · P⁻¹ src            (xold is None)
    xold + omega · P⁻¹ src     (the update epilogue of the smoother step)

with P⁻¹ the sum of the weighted patch inverses (weights and Dirichlet masks
folded per axis).  It launches the CUDA kernel for a CUDA tensor and runs
``fdm_patch_plain`` (the dense per-axis transforms G_d of the JAX package's
global-FDM path) for a CPU tensor.

The kernel is tiled (``csrc/fdm_tile.cuh``): a block owns a TX × TY tile of
cells and a chunk of at most CZ cell layers.  ``launch_plan`` mirrors the tile
shapes and shared-memory layout of the CUDA sources, for kernel B and for
kernel C, which shares the tile body.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import fdm_global_apply
from . import LAUNCHES
from .banded_laplace import _check_vec
from .build import check, load


@dataclass
class FDMTables:
    """Per-direction tables (x first), on the preconditioner's device/dtype.

    Kernel form: V (C_d, m, m) per-coordinate eigenvectors (node s, mode k),
    lam (C_d, m), fin/fout (N_d,) the input/output folds.
    Plain form: G (C_d·m, N_d) with fin folded, Gt (N_d, C_d·m) with fout
    folded, inv_denom the (C_z·m, C_y·m, C_x·m) reciprocal eigenvalue sums.
    ``periodic`` (per direction, x first) marks wrapped axes; only the
    plain form takes them, as no JAX kernel does (``fdm_slab.py:152``).
    """

    V: list
    lam: list
    fin: list
    fout: list
    G: list
    Gt: list
    inv_denom: torch.Tensor
    cells: tuple  # (Cz, Cy, Cx)
    p: int
    periodic: tuple = None

    @property
    def grid_shape(self) -> tuple:
        per = reversed(self.periodic or (False,) * len(self.cells))
        return tuple(c * self.p + (0 if w else 1)
                     for c, w in zip(self.cells, per))


def check_kernel_tables(t: FDMTables, name: str) -> None:
    """The tiled kernels B, C and D take non-periodic 3D tables only."""
    if t.periodic and any(t.periodic):
        raise ValueError(f"{name}: the kernel does not take periodic meshes")


# (tx, ty, cz, threads) per kernel and m = p + 1, as csrc/fdm_tile.cuh's
# tile_shape(): cz is the most cell layers a block takes (chunk_layers); a
# float64 entry overrides where the float32 tile does not fit
_TILES = {
    "fdm_patch": {2: (16, 16, 16, 256), 3: (16, 8, 16, 256),
                  4: (8, 8, 16, 512), 5: (8, 8, 16, 512), 6: (8, 4, 16, 512),
                  7: (4, 4, 16, 512), 8: (4, 4, 16, 512)},
    "smoother_step": {2: (16, 16, 32, 256), 3: (8, 8, 32, 256),
                      4: (8, 8, 32, 512), 5: (8, 8, 32, 512),
                      6: (4, 4, 32, 256), 7: (2, 2, 32, 256),
                      8: (2, 2, 32, 256)},
}
_TILES_F64 = {("smoother_step", 4): (4, 4, 32, 256),
              ("smoother_step", 5): (4, 4, 32, 256),
              ("smoother_step", 6): (2, 2, 32, 256),
              ("smoother_step", 8): (2, 1, 32, 256)}
SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory (1 KB more per block)
H100_SMS = 132
KERNEL_IDS = {"fdm_patch": 0, "smoother_step": 1}  # dat_tile_plan's kernel


@dataclass(frozen=True)
class LaunchPlan:
    """One kernel instantiation's launch: a block per (tx, ty) tile of cells
    and chunk of at most cz cell layers, ``threads`` threads,
    ``shared_bytes`` of dynamic shared memory."""

    kernel: str
    p: int
    itemsize: int
    tile: tuple  # (tx, ty, cz)
    threads: int
    shared_bytes: int

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds by shared memory and threads, leaving 64
        registers a thread (the kernels' ``__launch_bounds__`` minimum,
        ``min_blocks``)."""
        return max(1, min(SM_SHARED_BYTES // (self.shared_bytes + 1024),
                          2048 // self.threads, 65536 // (64 * self.threads)))

    def chunk(self, cells: tuple, sms: int = H100_SMS) -> int:
        """Cell layers per block (``chunk_layers``): the largest of cz,
        cz/2, ... that still gives the card 90% of the blocks it holds."""
        cz_n, cy, cx = cells
        tx, ty, cz = self.tile
        tiles = -(-cx // tx) * -(-cy // ty)
        want = -(-9 * sms * self.blocks_per_sm // 10)
        while cz > 1 and tiles * -(-cz_n // cz) < want:
            cz = (cz + 1) // 2
        return cz

    def grid(self, cells: tuple, sms: int = H100_SMS) -> tuple:
        """CUDA grid (x, y, z) for (Cz, Cy, Cx) cells on ``sms`` SMs."""
        cz, cy, cx = cells
        tx, ty, _ = self.tile
        return (-(-cx // tx), -(-cy // ty), -(-cz // self.chunk(cells, sms)))


def _odd(n: int) -> int:
    return n | 1


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def launch_plan(p: int, itemsize: int, kernel: str = "fdm_patch") -> LaunchPlan:
    """The launch plan of kernel B (``fdm_patch``) or C (``smoother_step``)
    at degree p for float32 (itemsize 4) or float64 (8), with the shared
    bytes of the layout in ``csrc/fdm_tile.cuh`` (``tile_elems``)."""
    if not 1 <= p <= 7 or itemsize not in (4, 8) or kernel not in _TILES:
        raise ValueError(f"launch_plan: no plan for {kernel} p={p} "
                         f"itemsize={itemsize}")
    m = p + 1
    tx, ty, cz, threads = (_TILES_F64.get((kernel, m)) if itemsize == 8
                           else None) or _TILES[kernel][m]
    nx, ny = (tx + 1) * p + 1, (ty + 1) * p + 1
    lx, ly = (tx + 1) * m, (ty + 1) * m
    ox, oy = tx * p + 1, ty * p + 1
    buf = _pad4(m * ly * _odd(lx))
    # V tables (rows padded to 16 bytes), lambda, folds
    tables = ((tx + ty + 4) * m * _pad4(m) + (tx + ty + 4) * m + nx + ny + ox
              + oy + 2 * m)
    elems = 2 * buf + _pad4(oy * ox + tables)
    if kernel == "smoother_step":
        hy, hx = ny + 2 * p, nx + 2 * p
        # two x planes with the band halo and their (Mx x, Kx x) pairs
        stage = 2 * _pad4(hy * _odd(hx)) + 4 * hy * _odd(nx)
        band = 2 * p + 1
        elems += (max(buf, stage) - buf + _pad4(m * ny * _odd(nx))
                  + 2 * band * ny * nx + 2 * band * (nx + ny))
    return LaunchPlan(kernel, p, itemsize, (tx, ty, cz), threads,
                      elems * itemsize)


def fdm_patch_plain(src: torch.Tensor, t: FDMTables, omega: float = 1.0,
                    xold: torch.Tensor | None = None) -> torch.Tensor:
    y = fdm_global_apply(src.reshape(t.grid_shape), t.G, t.Gt,
                         t.inv_denom).reshape(-1) * omega
    return y if xold is None else xold + y


def _pointers(t: FDMTables) -> list:
    return [x.data_ptr() for x in (*t.V, *t.lam, *t.fin, *t.fout)]


def _kernel_fn(name: str, dtype):
    if dtype == torch.float32:
        return getattr(load(), f"dat_{name}_f32")
    if dtype == torch.float64:
        return getattr(load(), f"dat_{name}_f64")
    raise TypeError(f"{name}: unsupported dtype {dtype}")


def fdm_patch(src: torch.Tensor, t: FDMTables, omega: float = 1.0,
              xold: torch.Tensor | None = None) -> torch.Tensor:
    if src.device.type == "cpu":
        return fdm_patch_plain(src, t, omega, xold)
    if src.device.type != "cuda":
        raise TypeError(f"fdm_patch: unsupported device {src.device}")
    check_kernel_tables(t, "fdm_patch")
    nz, ny, nx = t.grid_shape
    n = nz * ny * nx
    _check_vec(src, "src", t.V[0], n)
    if xold is not None:
        _check_vec(xold, "xold", t.V[0], n)
    fn = _kernel_fn("fdm_patch", src.dtype)
    out = torch.empty_like(src)
    cz, cy, cx = t.cells
    err = fn(src.data_ptr(), xold.data_ptr() if xold is not None else None,
             out.data_ptr(), *_pointers(t), cz, cy, cx, t.p, float(omega),
             0 if xold is None else 1,
             torch.cuda.current_stream(src.device).cuda_stream)
    check(err, "fdm_patch")
    LAUNCHES["fdm_patch"] += 1
    return out
