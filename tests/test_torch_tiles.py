"""The tile decomposition of kernels B and C (kernels/csrc/fdm_tile.cuh) on
the CPU: their launch plans, and a plain per-cell mirror of the tile order
held against the port's plain versions and the JAX package's TPU kernels.

The CUDA kernels run only on the GPU (``chip_smoke.py`` holds them against
their plain versions there); what a CPU can check is the decomposition they
implement.  ``_tiled_fdm`` below walks the same tiles, chunks and layers:
each block owns the nodes at local positions [0, p) of its tile's cells (and
the closing plane on the last tile of an axis), solves its cells' and the
lower halo cells' patches with the per-cell m × m transforms, carries the
upper node plane of each layer to the next, re-solves the layer below the
chunk, and sums each node's contributions in the kernels' order (the carry
first, then the patches by (dy, dx), lower cell first).  Every node must be
written exactly once.

Tolerances (max |difference| / max |reference|):
- the mirror in float32 vs ``fdm_patch_plain`` and vs
  ``FDMSlabKernel(jasm).apply(..., interpret=True)``: 1e-5, float32
  rounding of the same products in another order and grouping (the dense
  folded transforms against per-cell ones; observed ~3e-7);
- the mirror's update on the banded residual, vs
  ``SmootherStepKernel.step(..., interpret=True)``: 3e-2, the bound of
  ``tests/test_torch_smoother_step.py``: the TPU kernel runs its FDM stage in
  bfloat16, the port in float32.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.pallas.fdm_slab import FDMSlabKernel
from dealii_asm_tpu.ops.pallas.smoother_step import SmootherStepKernel
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace_plain
from dealii_asm_tpu_torch.kernels.fdm_patch import (fdm_patch_plain,
                                                    launch_plan)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

MAX_SHARED = 232_448  # bytes of shared memory one H100 block may use
MAX_GRID = (2 ** 31 - 1, 65_535, 65_535)
KERNELS = ("fdm_patch", "smoother_step")


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("p", range(1, 8))
def test_launch_plan_fits_the_h100(kernel, itemsize, p):
    plan = launch_plan(p, itemsize, kernel)
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert 0 < plan.shared_bytes <= MAX_SHARED
    assert plan.shared_bytes % itemsize == 0
    assert all(t >= 1 for t in plan.tile)
    for cells in [(128, 128, 128), (1, 128, 128), (128, 1, 128),
                  (128, 128, 1), (1, 1, 1)]:
        grid = plan.grid(cells)
        assert all(1 <= g <= lim for g, lim in zip(grid, MAX_GRID))
        # the tiles cover every cell
        tx, ty, tz = plan.tile
        assert grid[0] * tx >= cells[2] and grid[1] * ty >= cells[1]
        assert grid[2] * tz >= cells[0]


def _tiled_fdm(src, t, omega, tile, xold=None):
    """omega·P⁻¹ src (+ xold) walked tile by tile, layer by layer, as the
    kernels do, in src's dtype."""
    cz_n, cy_n, cx_n = t.cells
    p = t.p
    tx, ty, tz = tile
    nz, ny, nx = t.grid_shape
    g = src.reshape(nz, ny, nx).numpy()
    dt = g.dtype
    Vx, Vy, Vz = (v.numpy().astype(dt) for v in t.V)
    lx, ly, lz = (v.numpy().astype(dt) for v in t.lam)
    fin = [f.numpy().astype(dt) for f in t.fin]
    fout = [f.numpy().astype(dt) for f in t.fout]
    out = np.full((nz, ny, nx), np.nan, dt)
    written = np.zeros((nz, ny, nx), np.int64)

    def patch(cz, cy, cx):
        """The patch solve of one cell: its m³ window values."""
        sl = (slice(cz * p, cz * p + p + 1), slice(cy * p, cy * p + p + 1),
              slice(cx * p, cx * p + p + 1))
        w = (g[sl] * fin[2][sl[0], None, None] * fin[1][None, sl[1], None]
             * fin[0][None, None, sl[2]])
        u = np.einsum("ai,bj,ck,abc->ijk", Vz[cz], Vy[cy], Vx[cx], w)
        u = u / (lz[cz][:, None, None] + ly[cy][None, :, None]
                 + lx[cx][None, None, :])
        return np.einsum("ia,jb,kc,abc->ijk", Vz[cz], Vy[cy], Vx[cx], u)

    for bz, by, bx in itertools.product(range(-(-cz_n // tz)),
                                        range(-(-cy_n // ty)),
                                        range(-(-cx_n // tx))):
        cx0, cy0, cz_begin = bx * tx, by * ty, bz * tz
        ncx, ncy = min(tx, cx_n - cx0), min(ty, cy_n - cy0)
        ox = ncx * p + (cx0 + ncx == cx_n)
        oy = ncy * p + (cy0 + ncy == cy_n)
        cz_end = min(cz_n, cz_begin + tz)
        first = max(cz_begin - 1, 0)  # the halo layer, if any
        carry = np.zeros((oy, ox), dt)
        for cz in range(first, cz_end):
            acc = np.zeros((p + 1, oy, ox), dt)
            if cz > first:
                acc[0] = carry
            # the halo cells cy0 - 1, cx0 - 1 and the tile's own, lower first
            for cy in range(cy0 - 1, cy0 + ncy):
                for cx in range(cx0 - 1, cx0 + ncx):
                    if cy < 0 or cx < 0:
                        continue
                    r = patch(cz, cy, cx)
                    # the patch's nodes among the tile's owned columns
                    y0, x0 = cy * p - cy0 * p, cx * p - cx0 * p
                    ys = slice(max(y0, 0), min(y0 + p + 1, oy))
                    xs = slice(max(x0, 0), min(x0 + p + 1, ox))
                    acc[:, ys, xs] += r[:, ys.start - y0: ys.stop - y0,
                                        xs.start - x0: xs.stop - x0]
            carry = acc[p]
            if cz < cz_begin:
                continue
            n_planes = p + 1 if cz == cz_n - 1 else p
            sl = (slice(cz * p, cz * p + n_planes),
                  slice(cy0 * p, cy0 * p + oy), slice(cx0 * p, cx0 * p + ox))
            fo = (fout[2][sl[0], None, None] * fout[1][None, sl[1], None]
                  * fout[0][None, None, sl[2]])
            out[sl] = omega * (acc[:n_planes] * fo)
            written[sl] += 1
    assert (written == 1).all(), "a node is owned by no block or by two"
    y = torch.as_tensor(out.reshape(-1))
    return y if xold is None else xold + y


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    # (a 1-cell axis at p = 1 has no free node: both sides are zero)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


MESHES = [((2, 3, 4), "symm"), ((3, 5, 2), "post"), ((1, 4, 3), "pre")]


@pytest.mark.parametrize("p", [1, 2, 3, 4])
@pytest.mark.parametrize("cells,wt", MESHES)
def test_tile_order_matches_plain_and_tpu_kernel(cells, wt, p):
    dofs = DofHandler(StructuredMesh(3, cells), p)
    rng = np.random.default_rng(100 + 10 * p + len(wt))
    x = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    xold = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    t = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32,
                          device="cpu").tables
    xt = torch.as_tensor(x)
    ref = fdm_patch_plain(xt, t, 0.37)
    # the plan's tiles (ragged here: every mesh is smaller than one tile),
    # and small tiles that split every axis into several, ragged ones
    for tile in (launch_plan(p, 4).tile, (2, 2, 1), (1, 3, 2)):
        got = _tiled_fdm(xt, t, 0.37, tile)
        assert _rel(got, ref) < 1e-5, tile
    upd = _tiled_fdm(xt, t, 0.37, launch_plan(p, 4).tile,
                     torch.as_tensor(xold))
    assert _rel(upd, fdm_patch_plain(xt, t, 0.37, torch.as_tensor(xold))) < 1e-5
    jasm = JaxASM(JaxDofHandler(JaxMesh(3, cells), p), n_overlap=1,
                  weighting_type=wt, dtype=jnp.float32)
    slab = np.asarray(FDMSlabKernel(jasm).apply(jnp.asarray(x),
                                                interpret=True))
    assert _rel(_tiled_fdm(xt, t, 1.0, (2, 2, 1)), slab) < 1e-5


@pytest.mark.parametrize("cells,p,wt", [((2, 3, 4), 2, "symm"),
                                        ((3, 2, 2), 4, "post")])
def test_tile_order_step_matches_tpu_kernel(cells, p, wt):
    """x + ω·P⁻¹(b − A x) with the residual from the banded operator and
    P⁻¹ walked in kernel C's tiles."""
    dofs = DofHandler(StructuredMesh(3, cells), p)
    rng = np.random.default_rng(200 + p)
    x = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    b = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    op = LaplaceOperator(dofs, dtype=torch.float32, device="cpu")
    t = ASMPreconditioner(dofs, weighting_type=wt, dtype=torch.float32,
                          device="cpu").tables
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    r = banded_laplace_plain(xt, op.tables, rhs=bt)
    got = _tiled_fdm(r, t, 0.37, launch_plan(p, 4, "smoother_step").tile, xt)
    small = _tiled_fdm(r, t, 0.37, (1, 2, 1), xt)
    assert _rel(small, got) < 1e-5
    # constrained nodes keep x
    np.testing.assert_array_equal(got.numpy()[dofs.boundary_mask],
                                  x[dofs.boundary_mask])
    jdofs = JaxDofHandler(JaxMesh(3, cells), p)
    kern = SmootherStepKernel(JaxLaplace(jdofs, dtype=jnp.float32),
                              JaxASM(jdofs, n_overlap=1, weighting_type=wt,
                                     dtype=jnp.float32))
    ref = np.asarray(kern.step(jnp.asarray(x), jnp.asarray(b), 0.37,
                               interpret=True))
    assert _rel(got, ref) < 3e-2
