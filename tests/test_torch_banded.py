"""The tiling of kernel A (kernels/csrc/banded_laplace.cu, banded_plane.cuh)
on the CPU: its launch plans, and a NumPy mirror of its tile and plane order
held against the port's plain version and the JAX package's TPU kernel.

The CUDA kernel runs only on the GPU (``chip_smoke.py`` holds it against its
plain version there); what a CPU can check is the decomposition it
implements.  ``_tiled_banded`` below walks the same blocks: tiles of WX × WY
nodes and chunks of planes covering the nodes [0, N − 1) of each axis (the
last block of an axis also writes the closing node N − 1, a copy), input
planes streamed from 2p below the chunk to 2p above it, x band on the tile's
rows with their y halo, y band, and the z band in the scatter form of the
kernel's registers (2p + 1 partial sums per node, the completed one popped
after each plane).  Every node must be written exactly once.

Tolerances (max |difference| / max |reference|):
- float32 vs ``banded_laplace_plain`` and vs ``F32VmultKernel`` run with
  ``interpret=True`` (the JAX operator's ``kernel="pallas-f32"``): 1e-5,
  float32 rounding of the same products in another order (observed ~1e-7);
- float64 vs ``banded_laplace_plain`` and the JAX ``kernel="banded"``
  float64 apply: 1e-12, the same products in another order (~1e-16).
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels.banded_laplace import (banded_laplace_plain,
                                                         launch_plan)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator

MAX_SHARED = 232_448  # bytes of shared memory one H100 block may use
SM_SHARED = 233_472   # an SM's, with 1 KB reserved per block
MAX_GRID = (2 ** 31 - 1, 65_535, 65_535)
Q4_64 = (257, 257, 257)  # 64^3 cells Q4: the flagship's finest grid


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("p", range(1, 8))
def test_launch_plan_fits_two_blocks_per_sm(itemsize, p):
    plan = launch_plan(p, itemsize)
    wx, wy, cz = plan.tile
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert wx % 32 == 0 and plan.threads % wx == 0  # a warp is one tile row
    assert wy % (plan.threads // wx) == 0
    assert 0 < plan.shared_bytes <= MAX_SHARED
    assert 2 * (plan.shared_bytes + 1024) <= SM_SHARED
    assert plan.minb >= 2 and 65536 // (plan.threads * plan.minb) >= 64
    for cells in [(64, 64, 64), (13, 7, 5), (6, 9, 1), (1, 1, 1),
                  (128, 128, 128)]:
        shape = tuple(c * p + 1 for c in cells)
        grid = plan.grid(shape)
        assert all(1 <= g <= lim for g, lim in zip(grid, MAX_GRID))
    # at 64^3 Q4 no block holds a single column or row
    nz, ny, nx = Q4_64
    if p == 4:
        assert (nx - 1) % wx == 0 and (ny - 1) % wy == 0


def _tiled_banded(u, t, wx, wy, chunk, rhs=None):
    """free ? A(free ? u : 0) : u (or rhs minus it) walked block by block,
    plane by plane, as the kernel does, in u's dtype; also returns how often
    each node was written."""
    nz, ny, nx = t.grid_shape
    p = t.p
    band = 2 * p + 1
    g = u.reshape(nz, ny, nx).numpy()
    dt = g.dtype
    free = t.free.numpy()
    u0 = np.where(free, g, 0).astype(dt)
    Mx, Kx = t.Mdiags[0].numpy(), t.Kdiags[0].numpy()
    My, Ky = t.Mdiags[1].numpy(), t.Kdiags[1].numpy()
    Mz, Kz = t.Mdiags[2].numpy(), t.Kdiags[2].numpy()
    r = None if rhs is None else rhs.reshape(nz, ny, nx).numpy()
    out = np.full((nz, ny, nx), np.nan, dt)
    written = np.zeros((nz, ny, nx), np.int64)

    def put(idx, av):
        out[idx] = av if r is None else r[idx] - av
        written[idx] += 1

    bx, by = (nx - 2) // wx + 1, (ny - 2) // wy + 1
    bzn = (nz - 2) // chunk + 1
    for bz, byi, bxi in itertools.product(range(bzn), range(by), range(bx)):
        x0, y0, zb = bxi * wx, byi * wy, bz * chunk
        ze = nz if zb + chunk >= nz - 1 else zb + chunk
        # the tile's stage: rows y0 - p .. y0 + wy + p, columns likewise
        ys = np.arange(y0 - p, y0 + wy + p)
        xs = np.arange(x0 - p, x0 + wx + p)
        yin = (ys >= 0) & (ys < ny)
        xin = (xs >= 0) & (xs < nx)
        # tables of the tile's columns and rows (zero outside the grid)
        cols = np.arange(x0, x0 + wx)
        rows = np.arange(y0, y0 + wy)
        mx = np.where(cols < nx, Mx[:, np.minimum(cols, nx - 1)], 0).astype(dt)
        kx = np.where(cols < nx, Kx[:, np.minimum(cols, nx - 1)], 0).astype(dt)
        my = np.where(rows < ny, My[:, np.minimum(rows, ny - 1)], 0).astype(dt)
        ky = np.where(rows < ny, Ky[:, np.minimum(rows, ny - 1)], 0).astype(dt)
        acc = np.zeros((band, wy, wx), dt)  # acc[j]: output plane z - p + j
        for z in range(zb - p, ze + p):
            if 0 < z < nz - 1:
                st = np.zeros((len(ys), len(xs)), dt)
                st[np.ix_(yin, xin)] = u0[z][np.ix_(ys[yin], xs[xin])]
                # x band: (Mx u0, Kx u0) on every stage row
                sa = sum(mx[k] * st[:, k:k + wx] for k in range(band))
                sk = sum(kx[k] * st[:, k:k + wx] for k in range(band))
                # y band
                nb = sum(my[k][:, None] * sa[k:k + wy] for k in range(band))
                nc = sum(ky[k][:, None] * sa[k:k + wy]
                         + my[k][:, None] * sk[k:k + wy] for k in range(band))
                for j in range(band):  # scatter into output z - p + j
                    zo = z - p + j
                    if zb <= zo < ze:
                        acc[j] += Kz[2 * p - j, zo] * nb + Mz[2 * p - j, zo] * nc
            zo = z - p
            done, acc = acc[0], np.concatenate([acc[1:], np.zeros_like(acc[:1])])
            if not zb <= zo < ze:
                continue
            for wyi, wxi in itertools.product(range(wy), range(wx)):
                gy, gx = y0 + wyi, x0 + wxi
                if gy < ny and gx < nx:
                    idx = (zo, gy, gx)
                    put(idx, done[wyi, wxi] if free[idx] else g[idx])
        # the closing column and row just outside the tile: copies
        ex, ey = x0 + wx == nx - 1, y0 + wy == ny - 1
        extra = set()
        if ex:
            extra |= {(gy, nx - 1) for gy in range(y0, min(y0 + wy, ny) + ey)}
        if ey:
            extra |= {(ny - 1, gx) for gx in range(x0, min(x0 + wx, nx))}
        for zo in range(zb, ze):
            for gy, gx in sorted(extra):
                put((zo, gy, gx), g[zo, gy, gx])
    return torch.as_tensor(out.reshape(-1)), written


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("cells", [(2, 3, 5), (1, 4, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_tile_order_matches_plain_and_tpu_kernel(cells, p, dtype):
    dofs = DofHandler(StructuredMesh(3, cells), p)
    rng = np.random.default_rng(300 + 10 * p + cells[0])
    x = rng.standard_normal(dofs.n_dofs)
    b = rng.standard_normal(dofs.n_dofs)
    t = LaplaceOperator(dofs, dtype=dtype, device="cpu").tables
    xt = torch.as_tensor(x, dtype=dtype)
    bt = torch.as_tensor(b, dtype=dtype)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    ref = banded_laplace_plain(xt, t)
    ref_r = banded_laplace_plain(xt, t, bt)
    plan = launch_plan(p, xt.element_size())
    # the plan's tile with its chunk rule, and small tiles that split every
    # axis into several ragged blocks and chunks
    wx, wy, _ = plan.tile
    for tile in ((wx, wy, plan.chunk(t.grid_shape)), (2, 3, 2), (3, 1, 1),
                 (4, 2, 3)):
        got, written = _tiled_banded(xt, t, *tile)
        assert (written == 1).all(), f"{tile}: a node written {written.max()}"
        assert _rel(got, ref) < tol, tile
    got_r, _ = _tiled_banded(xt, t, 2, 3, 2, bt)
    assert _rel(got_r, ref_r) < tol
    jdofs = JaxDofHandler(JaxMesh(3, cells), p)
    if dtype == torch.float32:
        jop = JaxLaplace(jdofs, dtype=jnp.float32, kernel="pallas-f32")
        jx = jnp.asarray(x.astype(np.float32))
    else:
        jop = JaxLaplace(jdofs, dtype=jnp.float64, kernel="banded")
        jx = jnp.asarray(x)
    assert _rel(got, np.asarray(jop.vmult(jx))) < tol


@pytest.mark.parametrize("p", range(1, 8))
def test_every_node_written_once_at_the_plans(p):
    """Ownership alone (no arithmetic): the plan's tiles and chunk on a
    ragged 5 x 7 x 13 mesh, a 1-cell axis, and 64^3 cells Q4 along x/y."""
    for itemsize in (4, 8):
        plan = launch_plan(p, itemsize)
        wx, wy, _ = plan.tile
        for cells in [(13, 7, 5), (6, 9, 1), (2, 64, 64)]:
            shape = tuple(c * p + 1 for c in cells)
            nz, ny, nx = shape
            chunk = plan.chunk(shape)
            count = np.zeros(shape, np.int64)
            bx, by, bzn = plan.grid(shape)
            for bz, byi, bxi in itertools.product(range(bzn), range(by),
                                                  range(bx)):
                x0, y0, zb = bxi * wx, byi * wy, bz * chunk
                ze = nz if zb + chunk >= nz - 1 else zb + chunk
                xe = min(x0 + wx, nx) + (x0 + wx == nx - 1)
                ye = min(y0 + wy, ny) + (y0 + wy == ny - 1)
                count[zb:ze, y0:ye, x0:xe] += 1
            assert (count == 1).all(), (itemsize, cells)
