"""The line-per-thread cell body of kernels E and F
(``kernels/csrc/sumfac_cell.cuh``) on the CPU: its launch plans, a NumPy
mirror of its line order held against the port's plain versions and the
JAX package, and the host copy of the 1D tables that its launch reads.

The CUDA kernels run only on the GPU (``chip_smoke.py`` holds them against
their plain versions there); what a CPU can check is the decomposition they
implement.  ``_cell_lines`` walks it: one thread per 1D line of a cell (m²
lines, m = p + 1), each stage an m × m product on the m values a thread
holds, and between directions an explicit round trip through three m³
stage buffers at the kernel's addresses (x-line li = (z, y) at li·m + j,
y-line (z, qx) at z·m² + qx + j·m, z-line (qy, qx) at li + j·m², and the
coalesced load and store at li + j·m²).  Sums run in the kernel's order,
one table column at a time.

Tolerances (max |difference| / max |reference|):
- float64: 1e-12 against ``sumfac_cell_apply``, ``merged_laplace_plain``,
  ``lanes_laplace_plain``, the JAX ``kernel="pallas-dd"`` (the TPU kernel
  MergedDDVmultKernel in interpret mode) and ``"lanes-pallas"``
  (LanesDDVmultKernel in interpret mode): the same products summed in
  another order;
- float32: 1e-5 against the same port functions in float32 and the JAX
  float32 operators (``merged_laplace_apply`` at matmul precision
  "highest", the ``"lanes"`` operator): float32 rounding in another order.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxDofs
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxGeneral
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
from dealii_asm_tpu_torch.fem.lagrange import shape_1d
from dealii_asm_tpu_torch.kernels.lanes_laplace import (lanes_laplace_plain,
                                                        sumfac_cell_apply)
from dealii_asm_tpu_torch.kernels.merged_laplace import (check_shape_host,
                                                         cell_plan,
                                                         merged_laplace_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.laplace_general import GeneralLaplaceOperator

DEGREES = range(1, 8)
STATIC_SHARED = 48 * 1024  # bytes of static shared memory a block may use
PARAM_LIMIT = 4096         # bytes of kernel parameters
TOL = {np.float64: 1e-12, np.float32: 1e-5}
TORCH = {np.float64: torch.float64, np.float32: torch.float32}
JAX = {np.float64: jnp.float64, np.float32: jnp.float32}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _positions(m):
    """The m entries of each thread's line li in a cell's m³ buffer, per
    stage: x-lines, y-lines, z-lines (also the coalesced load and store)."""
    li = np.arange(m * m)[:, None]
    j = np.arange(m)[None, :]
    return {"x": li * m + j,
            "y": (li // m) * m * m + li % m + j * m,
            "z": li + j * m * m}


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("p", DEGREES)
def test_cell_plan_fits_the_h100(p, itemsize):
    plan = cell_plan(p, itemsize)
    m2 = (p + 1) ** 2
    assert 0 < plan.threads <= 1024
    assert plan.shared_bytes == plan.cells * 3 * (p + 1) ** 3 * itemsize
    assert plan.shared_bytes <= STATIC_SHARED
    # the tables by value, beside at most 5 pointers and 3 ints
    assert plan.param_bytes == 4 * (p + 1) ** 2 * itemsize
    assert plan.param_bytes + 64 <= PARAM_LIMIT
    if plan.cells_per_warp:  # whole cells a warp: __syncwarp suffices
        assert plan.cells_per_warp * m2 <= 32
        assert plan.threads % 32 == 0
        assert plan.cells == plan.threads // 32 * plan.cells_per_warp
    else:  # lines packed across cells: block barriers
        assert plan.threads == plan.cells * m2
    if p >= 5:  # m² > 32: a cell's lines span warps
        assert not plan.cells_per_warp
    lanes = list(plan.lanes())
    assert len(lanes) == plan.threads
    for cells in [(5, 7, 13), (1, 1, 1)]:
        n_cells = int(np.prod(cells))
        seen = np.zeros((n_cells, m2), int)
        for blk in range(plan.blocks(n_cells)):
            for k, li, active in lanes:
                if active:
                    assert 0 <= k < plan.cells and 0 <= li < m2
                    c = blk * plan.cells + k
                    if c < n_cells:
                        seen[c, li] += 1
        assert (seen == 1).all()  # every line of every cell exactly once
    # a warp's lines never belong to two warps' cells
    if plan.cells_per_warp:
        for t, (k, _, active) in enumerate(lanes):
            if active:
                assert k // plan.cells_per_warp == t // 32


@pytest.mark.parametrize("p", DEGREES)
def test_line_positions_partition_the_cell(p):
    m = p + 1
    for pos in _positions(m).values():
        np.testing.assert_array_equal(np.sort(pos.reshape(-1)),
                                      np.arange(m ** 3))


def _lines(A, v):
    """out[..., q] = Σ_s A[q, s] v[..., s], one column at a time."""
    acc = np.zeros_like(v)
    for s in range(A.shape[1]):
        acc = acc + A[:, s] * v[..., s:s + 1]
    return acc


def _lines_t(A, v, B=None, w=None):
    """out[..., s] = Σ_q A[q, s] v[..., q] (+ B[q, s] w[..., q])."""
    acc = np.zeros_like(v)
    for q in range(A.shape[0]):
        term = A[q] * v[..., q:q + 1]
        if B is not None:
            term = term + B[q] * w[..., q:q + 1]
        acc = acc + term
    return acc


def _cell_lines(W, coeff, shape):
    """The cell body's line order: W (C, m³) cell values [z, y, x] x
    fastest, coeff (C, 6, m³), shape (4, m, m) = N, Dx, Dy, Dz; returns the
    cells' results (C, m³) in W's dtype."""
    N, Dx, Dy, Dz = shape
    m = N.shape[0]
    pos = _positions(m)
    px, py, pz = pos["x"], pos["y"], pos["z"]
    b0, b1, b2 = (np.zeros_like(W) for _ in range(3))
    b0[:, pz] = W[:, pz]                       # coalesced load
    u = b0[:, px]                              # forward x
    b0[:, px], b1[:, px] = _lines(N, u), _lines(Dx, u)
    a, d = b0[:, py], b1[:, py]                # forward y
    b0[:, py], b2[:, py], b1[:, py] = _lines(N, a), _lines(Dy, a), _lines(N, d)
    gz = _lines(Dz, b0[:, pz])                 # forward z
    gy = _lines(N, b2[:, pz])
    gx = _lines(N, b1[:, pz])
    cxx, cyy, czz, cxy, cxz, cyz = (coeff[:, k][:, pz] for k in range(6))
    tx = cxx * gx + cxy * gy + cxz * gz
    ty = cxy * gx + cyy * gy + cyz * gz
    tz = cxz * gx + cyz * gy + czz * gz
    b0[:, pz], b1[:, pz], b2[:, pz] = (_lines_t(Dz, tz), _lines_t(N, ty),
                                       _lines_t(N, tx))
    w1, w2, w3 = b0[:, py], b1[:, py], b2[:, py]   # backward y
    b0[:, py], b1[:, py] = _lines_t(N, w1, Dy, w2), _lines_t(N, w3)
    r12, r3 = b0[:, px], b1[:, px]                 # backward x
    b0[:, px] = _lines_t(N, r12, Dx, r3)
    out = np.zeros_like(W)
    out[:, pz] = b0[:, pz]                     # coalesced store
    return out


def _apply_mirror(u, cell_nodes, free, coeff, shape, rhs=None):
    """free ? Σ_c P_cᵀ body(P_c (free ? u : 0)) : u (or rhs minus it)."""
    u0 = np.where(free, u, 0).astype(u.dtype)
    local = _cell_lines(u0[cell_nodes], coeff, shape)
    v = np.zeros_like(u)
    np.add.at(v, cell_nodes, local)
    v = np.where(free, v, u)
    return v if rhs is None else rhs - v


def _lattice_nodes(cells, p):
    """(C, m³) lattice node of each cell's local point [z, y, x], cells x
    fastest (the kernel's cell numbering and gather)."""
    cz, cy, cx = cells
    nx, ny = cx * p + 1, cy * p + 1
    m = p + 1
    c = np.arange(cz * cy * cx)[:, None]
    lx = np.arange(m ** 3)[None, :]
    x = (c % cx) * p + lx % m
    y = (c // cx % cy) * p + lx // m % m
    z = c // (cx * cy) * p + lx // (m * m)
    return (z * ny + y) * nx + x


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("p", DEGREES)
def test_mirror_matches_sumfac_cell_apply(p, dtype):
    m = p + 1
    rng = np.random.default_rng(40 + p)
    s = shape_1d(p, m)
    shape = np.stack([s.N, s.D / 0.7, s.D / 1.3, s.D]).astype(dtype)
    W = rng.standard_normal((5, m ** 3)).astype(dtype)
    coeff = rng.standard_normal((5, 6, m ** 3)).astype(dtype)
    got = _cell_lines(W, coeff, shape)
    want = sumfac_cell_apply(torch.as_tensor(W).reshape(5, m, m, m),
                             torch.as_tensor(coeff), torch.as_tensor(shape))
    assert got.dtype == dtype
    assert _rel(got, want.reshape(5, -1).numpy()) < TOL[dtype]


@pytest.fixture(scope="module")
def kershaw():
    """{p: (JAX DofHandler, port DofHandler)} on Kershaw meshes of at most
    3 x 3 x 3 cells (fewer at high degree, to keep the run short)."""
    out = {}
    for p in DEGREES:
        cells = (3, 3, 2) if p <= 3 else (2, 2, 2)
        out[p] = (JaxDofHandler(JaxMesh(3, cells,
                                        transform=jax_kershaw(0.3, 0.3)), p),
                  DofHandler(StructuredMesh(
                      3, cells, transform=kershaw_transform(0.3, 0.3)), p))
    return out


def _merged_case(kershaw, p, dtype):
    """(mirror vmult, mirror residual, port operator, x, b) on the Kershaw
    mesh at degree p."""
    _, dofs = kershaw[p]
    op = LaplaceOperator(dofs, dtype=TORCH[dtype], mapping_degree=3,
                         device="cpu")
    t = op.tables
    rng = np.random.default_rng(60 + p)
    x = rng.standard_normal(dofs.n_dofs).astype(dtype)
    b = rng.standard_normal(dofs.n_dofs).astype(dtype)
    args = (_lattice_nodes(t.cells, p), t.free.reshape(-1).numpy(),
            t.coeff.numpy(), t.shape_host.numpy())
    got, res = _apply_mirror(x, *args), _apply_mirror(x, *args, rhs=b)
    assert got.dtype == res.dtype == dtype
    return got, res, op, x, b


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("p", DEGREES)
def test_merged_mirror_matches_plain(kershaw, p, dtype):
    """Kernel E's line order against ``merged_laplace_plain``; in float32
    also against the JAX float32 operator."""
    got, res, op, x, b = _merged_case(kershaw, p, dtype)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    assert _rel(got, merged_laplace_plain(xt, op.tables).numpy()) < TOL[dtype]
    assert _rel(res, merged_laplace_plain(xt, op.tables, bt).numpy()) \
        < TOL[dtype]
    if dtype == np.float32:
        jop = JaxLaplace(kershaw[p][0], mapping_degree=3, dtype=jnp.float32,
                         matmul_precision="highest")
        assert _rel(got, np.asarray(jop.vmult(jnp.asarray(x)))) < TOL[dtype]


def test_merged_mirror_matches_jax_kernel_e_interpret(kershaw):
    """In float64 against the TPU kernel MergedDDVmultKernel in interpret
    mode (p = 1: the Kershaw coarse level's degree; the port's plain
    version is held to it at p = 1, 2 and 4 in test_torch_merged.py)."""
    got, _, _, x, _ = _merged_case(kershaw, 1, np.float64)
    jop = JaxLaplace(kershaw[1][0], mapping_degree=3, dtype=jnp.float64,
                     kernel="pallas-dd")
    assert jop._merged_dd_pallas is not None and jop._merged_dd_pallas.interpret
    assert _rel(got, np.asarray(jop.vmult(jnp.asarray(x)))) < 1e-12


@pytest.fixture(scope="module")
def ball():
    """The 32-cell balanced ball (0 refinements): (port mesh, JAX mesh)."""
    return hyper_ball_balanced(3), jax_ball(3)


def _lanes_case(ball, p, dtype):
    """(mirror vmult, mirror residual, port operator, x, b) on the ball at
    degree p."""
    op = GeneralLaplaceOperator(GeneralDofHandler(ball[0], p),
                                dtype=TORCH[dtype], device="cpu")
    t = op.tables
    rng = np.random.default_rng(80 + p)
    x = rng.standard_normal(op.n_dofs).astype(dtype)
    b = rng.standard_normal(op.n_dofs).astype(dtype)
    args = (t.cell_dofs.long().numpy(), t.free.numpy(), t.coeff.numpy(),
            t.shape_host.numpy())
    got, res = _apply_mirror(x, *args), _apply_mirror(x, *args, rhs=b)
    assert got.dtype == res.dtype == dtype
    return got, res, op, x, b


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("p", DEGREES)
def test_lanes_mirror_matches_plain(ball, p, dtype):
    """Kernel F's line order against ``lanes_laplace_plain``."""
    got, res, op, x, b = _lanes_case(ball, p, dtype)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    assert _rel(got, lanes_laplace_plain(xt, op.tables).numpy()) < TOL[dtype]
    assert _rel(res, lanes_laplace_plain(xt, op.tables, bt).numpy()) \
        < TOL[dtype]


@pytest.mark.parametrize("p,dtype", [(1, np.float64), (2, np.float32),
                                     (5, np.float32)])
def test_lanes_mirror_matches_jax(ball, p, dtype):
    """Against the JAX package: in float64 the TPU kernel
    LanesDDVmultKernel in interpret mode ("lanes-pallas"; the port's plain
    version is held to it at p = 2, 3 and 4 in test_torch_lanes.py), in
    float32 the ball's level operator ("lanes")."""
    got, _, _, x, _ = _lanes_case(ball, p, dtype)
    kernel = "lanes-pallas" if dtype == np.float64 else "lanes"
    ref = JaxGeneral(JaxDofs(ball[1], p), dtype=JAX[dtype], kernel=kernel)
    if dtype == np.float64:
        assert ref._lanes_dd_pallas is not None
    assert _rel(got, np.asarray(ref.vmult(jnp.asarray(x)))) < TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_shape_host_equals_device_table(kershaw, ball, dtype):
    """The host copy the launch reads is the device table, bit for bit, in
    the operator's dtype; built once with the operator."""
    ops = [LaplaceOperator(kershaw[3][1], dtype=dtype, mapping_degree=3,
                           device="cpu"),
           GeneralLaplaceOperator(GeneralDofHandler(ball[0], 3), dtype=dtype,
                                  device="cpu")]
    for op in ops:
        t = op.tables
        assert t.shape_host.device.type == "cpu"
        assert t.shape_host.dtype == dtype and t.shape_host.is_contiguous()
        assert t.shape_host.shape == (4, 4, 4)
        assert torch.equal(t.shape_host, t.shape.cpu())
        check_shape_host(t.shape_host, 3, dtype, "test")


def test_tables_refuse_a_bad_host_table(kershaw, ball):
    """The tables check the host copy once, when they are built."""
    for op in (LaplaceOperator(kershaw[2][1], mapping_degree=3, device="cpu"),
               GeneralLaplaceOperator(GeneralDofHandler(ball[0], 2),
                                      device="cpu")):
        bad = op.tables.shape_host.float()
        with pytest.raises(ValueError, match="host shape table"):
            dataclasses.replace(op.tables, shape_host=bad)


def test_check_shape_host_raises():
    good = torch.zeros(4, 3, 3, dtype=torch.float64)
    check_shape_host(good, 2, torch.float64, "test")
    for bad, p, dt in ((good, 2, torch.float32), (good, 3, torch.float64),
                       (good.transpose(1, 2), 2, torch.float64),
                       (torch.zeros(4, 3, 3, device="meta",
                                    dtype=torch.float64), 2, torch.float64)):
        with pytest.raises(ValueError, match="host shape table"):
            check_shape_host(bad, p, dt, "test")
