"""The tile decomposition of kernels B and C (kernels/csrc/fdm_tile.cuh) and
of kernel G (kernels/csrc/cell_fdm_patch.cu) on the CPU: their launch
plans, and a plain per-cell mirror of the tile order held against the
port's plain versions and the JAX package's TPU kernels.

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

Kernel G walks the same tiles with each cell's own V and lambda (its
eigenvalue sums (lz + ly) + lx formed per patch, then the reciprocal).
``_tiled_fdm`` with ``cell_tables`` is its mirror, held against
``CellASMPreconditioner``'s plain apply (windows, batched per-cell einsums,
overlap-add) on Kershaw meshes: float32 1e-5, float32 rounding of the same
products in another order and grouping (the einsums contract through
cuBLAS-style batched products, the mirror per line); float64 1e-12, the
same float64 products in another order.
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
from dealii_asm_tpu_torch.kernels import LAUNCHES
from dealii_asm_tpu_torch.kernels import cell_fdm_patch as kernel_g
from dealii_asm_tpu_torch.kernels.banded_laplace import banded_laplace_plain
from dealii_asm_tpu_torch.kernels.fdm_patch import (fdm_patch_plain,
                                                    launch_plan)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond.asm import (ASMPreconditioner,
                                              CellASMPreconditioner)

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


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("p", range(1, 8))
def test_cell_launch_plan_fits_the_h100(itemsize, p):
    """Kernel G's plans (csrc/cell_fdm_patch.cu's cell_tile_shape and
    cell_layout) fit a block of the H100 and cover the Kershaw levels."""
    plan = kernel_g.launch_plan(p, itemsize)
    assert plan.kernel == "cell_fdm_patch"
    assert plan.threads <= 1024 and plan.threads % 32 == 0
    assert 0 < plan.shared_bytes <= MAX_SHARED
    assert plan.shared_bytes % 16 == 0  # regions stay 16-byte aligned
    assert plan.blocks_per_sm >= 1
    for cells in [(48, 48, 48), (1, 48, 48), (48, 1, 48), (48, 48, 1),
                  (1, 1, 1), (6, 6, 6)]:
        grid = plan.grid(cells)
        assert all(1 <= g <= lim for g, lim in zip(grid, MAX_GRID))
        tx, ty, _ = plan.tile
        assert grid[0] * tx >= cells[2] and grid[1] * ty >= cells[1]
        assert grid[2] * plan.chunk(cells) >= cells[0]
    with pytest.raises(ValueError):
        kernel_g.launch_plan(p, 2)


def _tiled_fdm(src, t, omega, tile, xold=None, cell_tables=False):
    """omega·P⁻¹ src (+ xold) walked tile by tile, layer by layer, as the
    kernels do, in src's dtype: kernels B and C with per-coordinate tables
    ``FDMTables``, or kernel G with per-cell ``CellFDMTables``
    (``cell_tables``)."""
    cz_n, cy_n, cx_n = t.cells
    p = t.p
    tx, ty, tz = tile
    nz, ny, nx = t.grid_shape
    g = src.reshape(nz, ny, nx).numpy()
    dt = g.dtype
    Vx, Vy, Vz = (v.numpy().astype(dt) for v in t.V)
    if cell_tables:
        lam = t.lam.numpy().astype(dt)
    else:
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
        if cell_tables:
            c = (cz * cy_n + cy) * cx_n + cx  # cells numbered x fastest
            vz, vy, vx = Vz[c], Vy[c], Vx[c]
            sx, sy, sz = lam[c]
            u = np.einsum("ai,bj,ck,abc->ijk", vz, vy, vx, w)
            # (lz + ly) + lx in the level's dtype, then the reciprocal
            u = u * (dt.type(1) / (sz[:, None, None] + sy[None, :, None]
                                   + sx[None, None, :]))
        else:
            vz, vy, vx = Vz[cz], Vy[cy], Vx[cx]
            u = np.einsum("ai,bj,ck,abc->ijk", vz, vy, vx, w)
            u = u / (lz[cz][:, None, None] + ly[cy][None, :, None]
                     + lx[cx][None, None, :])
        return np.einsum("ia,jb,kc,abc->ijk", vz, vy, vx, u)

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


# -- kernel G: per-cell tables on Kershaw meshes -----------------------------
# cells not multiples of any tile, and a 1-cell axis in each direction
KERSHAW_MESHES = [((3, 5, 2), "symm"), ((2, 1, 3), "none"),
                  ((1, 4, 3), "pre"), ((5, 3, 1), "post")]


def _kershaw(cells, p):
    return DofHandler(StructuredMesh(3, cells,
                                     transform=kershaw_transform(0.3, 0.3)),
                      p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 2, 4, 7])
@pytest.mark.parametrize("cells,wt", KERSHAW_MESHES)
def test_cell_tile_order_matches_plain(cells, wt, p, dtype):
    """Kernel G's tile order (the mirror with per-cell tables) against
    ``CellASMPreconditioner``'s plain apply (``vmult`` on a CPU tensor is
    ``vmult_plain``, bit for bit); every node written once."""
    dofs = _kershaw(cells, p)
    asm = CellASMPreconditioner(dofs, weighting_type=wt, dtype=dtype,
                                device="cpu")
    assert asm.fused
    x = torch.as_tensor(np.random.default_rng(300 + 10 * p + len(wt))
                        .standard_normal(dofs.n_dofs), dtype=dtype)
    before = LAUNCHES["cell_fdm_patch"]
    ref = asm.vmult(x)
    assert LAUNCHES["cell_fdm_patch"] == before  # a CPU tensor: plain
    assert torch.equal(ref, asm.vmult_plain(x))
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    itemsize = 4 if dtype == torch.float32 else 8
    for tile in (kernel_g.launch_plan(p, itemsize).tile, (2, 2, 1),
                 (1, 3, 2)):
        got = _tiled_fdm(x, asm.cell_tables, 1.0, tile, cell_tables=True)
        assert _rel(got, ref) < tol, tile


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 3, 4])
def test_cell_eigenvalue_sums_equal_the_plain_table(p, dtype):
    """The reciprocal of the per-cell sums (lz + ly) + lx that kernel G
    forms on chip equals the plain path's (P, m, m, m) ``inv_denom`` bit
    for bit, and the tables add no (P, m, m) copy."""
    asm = CellASMPreconditioner(_kershaw((3, 2, 2), p), weighting_type="symm",
                                dtype=dtype, device="cpu")
    t = asm.cell_tables
    lx, ly, lz = t.lam.unbind(1)
    inv = 1.0 / (lz[:, :, None, None] + ly[:, None, :, None]
                 + lx[:, None, None, :])
    assert torch.equal(inv, asm.inv_denom)
    assert t.lam.shape == (12, 3, p + 1) and t.lam.dtype == dtype
    for d in range(3):
        assert t.V[d] is getattr(asm, f"V{d}")
        n_d = asm.dofs.nodes_per_dim[d]
        assert t.fin[d].shape == t.fout[d].shape == (n_d,)
    # the per-axis folds multiply out to the plain path's grid folds
    assert torch.allclose(t.fin[2][:, None, None] * t.fin[1][None, :, None]
                          * t.fin[0][None, None, :], asm.fin, rtol=1e-6)


def test_kernel_g_gate():
    """Which ``CellASMPreconditioner`` configurations take kernel G: element
    patches at overlap 1 with the weightings none/pre/post/symm on a
    non-periodic 3D mesh in float32 or float64; RAS, vertex patches,
    overlap 2, 2D, periodic and bfloat16 levels keep the plain path, as do
    CPU tensors.  The patch count the benchmark reads (``V0.shape[0]``) is
    the cell count either way."""
    k = kershaw_transform(0.3, 0.3)
    dofs = DofHandler(StructuredMesh(3, (3, 2, 2), transform=k), 2)
    n = dofs.mesh.n_cells_total
    for wt in ("none", "pre", "post", "symm"):
        for dt in (torch.float32, torch.float64):
            asm = CellASMPreconditioner(dofs, weighting_type=wt, dtype=dt,
                                        device="cpu")
            assert asm.fused and asm.V0.shape[0] == n
    plain = [CellASMPreconditioner(dofs, weighting_type="ras", device="cpu"),
             CellASMPreconditioner(dofs, patch_type="vertex", device="cpu"),
             CellASMPreconditioner(dofs, n_overlap=2, device="cpu"),
             CellASMPreconditioner(dofs, dtype=torch.bfloat16, device="cpu"),
             CellASMPreconditioner(
                 DofHandler(StructuredMesh(2, (3, 2), transform=k), 2),
                 device="cpu"),
             CellASMPreconditioner(
                 DofHandler(StructuredMesh(3, (3, 2, 2), transform=k,
                                           periodic=(True, False, False)), 2),
                 device="cpu")]
    for asm in plain:
        assert not asm.fused and not hasattr(asm, "cell_tables")
        assert not hasattr(asm, "lam")
    assert plain[0].V0.shape[0] == n and plain[2].V0.shape[0] == n
    fused = CellASMPreconditioner(dofs, weighting_type="symm",
                                  dtype=torch.float32, device="cpu")
    x = torch.randn(dofs.n_dofs, dtype=torch.float64)
    before = LAUNCHES["cell_fdm_patch"]
    y = fused.vmult(x)
    assert y.dtype == torch.float64 and LAUNCHES["cell_fdm_patch"] == before
    with pytest.raises(TypeError, match="unsupported device"):
        kernel_g.cell_fdm_patch(x.to(torch.float32).to("meta"),
                                fused.cell_tables)


def test_every_kershaw_smoother_apply_takes_kernel_g(monkeypatch):
    """Every level of ``e2e_kershaw_q4.json`` (ph-multigrid, Chebyshev-2
    around element overlap-1 symm FDM, float32 levels) passes G's gate, and
    every per-cell FDM apply of its solve goes through G's wrapper (on a CPU
    tensor the wrapper runs the plain apply, so each plain apply must come
    from it)."""
    import copy
    import json
    import os

    from dealii_asm_tpu_torch.models.poisson import run_config
    from dealii_asm_tpu_torch.precond import asm as asm_module

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "experiments", "e2e_kershaw_q4.json")) as f:
        params = json.load(f)
    params = copy.deepcopy(params)
    params["n refinements"] = 0
    params["solver"].update({"best of": 1, "max iterations": 3})
    params["print timing"] = False
    calls = {"wrapper": 0, "plain": 0}
    wrapper, plain = asm_module.cell_fdm_patch, \
        CellASMPreconditioner.vmult_plain

    def count_wrapper(src, t):
        calls["wrapper"] += 1
        return wrapper(src, t)

    def count_plain(self, src):
        calls["plain"] += 1
        return plain(self, src)

    monkeypatch.setattr(asm_module, "cell_fdm_patch", count_wrapper)
    monkeypatch.setattr(CellASMPreconditioner, "vmult_plain", count_plain)
    res = run_config(params, log=lambda *_: None, device="cpu")
    assert calls["wrapper"] > 0 and calls["plain"] == calls["wrapper"]
    mg, inner = res["preconditioner"].inner, []
    while True:
        inner += [s.M.__self__ for s in mg.smoothers]
        nested = getattr(mg.coarse_solver, "__self__", None)
        if type(nested) is not type(mg):
            break
        mg = nested
    assert len(inner) >= 2  # Q4 and Q2 above the coarse Q1 level here
    assert all(isinstance(a, CellASMPreconditioner) and a.fused
               and a.dtype == torch.float32 for a in inner)
