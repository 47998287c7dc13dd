"""Port's degree-k smoother sweep (dealii_asm_tpu_torch.kernels.smoother_sweep,
kernel D's plain PyTorch path on CPU), its Chebyshev/Relaxation hooks and the
factory's chain gate, vs the JAX package.

Tolerances (max |difference| / max |reference|):
- vs the JAX float32 composition ``cheb.step``/``cheb.vmult`` (and
  ``RelaxationPreconditioner``): 1e-5, float32 rounding of the same products
  in another order over k sub-steps (observed up to 5.3e-7).  The port's own
  unfused loop is held to the same bound: its coefficients are Python
  floats, the sweep's rows the same floats;
- vs ``SmootherStepKernel(op, asm, n_chain=k).sweep_padded(...,
  interpret=True)``: 4e-2, the bound of ``tests/test_pallas_fdm.py:183``.
  The TPU kernel runs its FDM transforms and its residual ring in
  bfloat16 (unit roundoff 2^-8 per rounding), the port in float32
  (observed 1.5e-3);
- the factory's attach wiring (the wrapper's plain path on CPU tensors)
  against the unfused smoother: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.ops.pallas.smoother_step import SmootherStepKernel
from dealii_asm_tpu.precond import factory as jfactory
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.solvers import chebyshev as jcheb
from dealii_asm_tpu_torch import interop
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.kernels import launch_counts
from dealii_asm_tpu_torch.kernels.smoother_sweep import (smoother_sweep,
                                                         smoother_sweep_plain)
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.precond import factory
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

EV = jcheb.EigenvalueInfo(1.6, 1.92, 40)
GATE = "DEALII_ASM_TPU_CHAIN_DEGREES"


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _level(cells, p, seed):
    """(JAX op, JAX asm, port op, port asm, x, b) of one float32 level."""
    jdofs = JaxDofHandler(JaxMesh(3, cells), p)
    dofs = DofHandler(StructuredMesh(3, cells), p)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    b = rng.standard_normal(dofs.n_dofs).astype(np.float32)
    return (JaxLaplace(jdofs, dtype=jnp.float32),
            JaxASM(jdofs, n_overlap=1, weighting_type="symm",
                   dtype=jnp.float32),
            LaplaceOperator(dofs, dtype=torch.float32, device="cpu"),
            ASMPreconditioner(dofs, weighting_type="symm",
                              dtype=torch.float32, device="cpu"), x, b)


@pytest.mark.parametrize("kind", ["1st kind", "4th kind"])
@pytest.mark.parametrize("degree", [2, 3])
@pytest.mark.parametrize("cells,p", [((4, 4, 4), 2), ((4, 3, 5), 3)])
def test_sweep_matches_jax_chebyshev(cells, p, degree, kind):
    jop, jasm, op, asm, x, b = _level(cells, p, 10 * p + degree)
    ref = jcheb.ChebyshevPreconditioner(jop.vmult, jasm.vmult, op.n_dofs,
                                        degree=degree, polynomial_type=kind,
                                        eigenvalues=EV)
    loop = interop.chebyshev_from_jax(ref, op.vmult, asm.vmult, op.n_dofs,
                                      device="cpu")
    coefs = loop.sweep_coefficients()
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    step = smoother_sweep(xt, bt, op.tables, asm.tables, coefs)
    zero = smoother_sweep(None, bt, op.tables, asm.tables, coefs, zero_x=True)
    assert _rel(step, ref.step(jnp.asarray(x), jnp.asarray(b))) < 1e-5
    assert _rel(zero, ref.vmult(jnp.asarray(b))) < 1e-5
    assert _rel(step, loop.step(xt, bt)) < 1e-5
    assert _rel(zero, loop.vmult(bt)) < 1e-5
    # constrained nodes keep x, and are 0 from the zero guess
    mask = op.dofs.boundary_mask
    np.testing.assert_array_equal(step.numpy()[mask], x[mask])
    assert not zero.numpy()[mask].any()


@pytest.mark.parametrize("zero_x", [False, True])
def test_sweep_matches_tpu_chain_kernel_interpret(zero_x):
    jop, jasm, op, asm, x, b = _level((4, 4, 4), 2, 50)
    coefs = jcheb.chebyshev_sweep_coefficients(2, 1.0, 0.9, "1st kind")
    ck = SmootherStepKernel(jop, jasm).as_chain(2)
    shape = op.grid_shape
    xg, bg = jnp.asarray(x).reshape(shape), jnp.asarray(b).reshape(shape)
    bp = ck.pad_grid(bg)
    out = ck.sweep_padded(bp if zero_x else ck.pad_grid(xg), bp, coefs,
                          zero_x=zero_x, interpret=True)
    ref = ck.unpad_grid(out, full_src=None if zero_x else xg).reshape(-1)
    got = smoother_sweep(None if zero_x else torch.as_tensor(x),
                         torch.as_tensor(b), op.tables, asm.tables, coefs,
                         zero_x=zero_x)
    assert _rel(got, ref) < 4e-2


def test_relaxation_rows_match_jax_relaxation():
    jop, jasm, op, asm, x, b = _level((3, 4, 3), 3, 60)
    ref = jcheb.RelaxationPreconditioner(jop.vmult, jasm.vmult, op.n_dofs,
                                         n_iterations=3, omega=0.41)
    port = interop.relaxation_from_jax(ref, op.vmult, asm.vmult, op.n_dofs,
                                       device="cpu")
    coefs = port.sweep_coefficients()
    assert coefs == [(0.0, 0.41)] * 3
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    step = smoother_sweep(xt, bt, op.tables, asm.tables, coefs)
    zero = smoother_sweep(None, bt, op.tables, asm.tables, coefs, zero_x=True)
    for got, theirs, mine in ((step, ref.step(jnp.asarray(x), jnp.asarray(b)),
                               port.step(xt, bt)),
                              (zero, ref.vmult(jnp.asarray(b)),
                               port.vmult(bt))):
        assert _rel(got, theirs) < 1e-5
        assert _rel(mine, theirs) < 1e-5


def test_zero_guess_reads_no_x_and_cpu_launches_nothing():
    _, _, op, asm, _, b = _level((2, 3, 2), 2, 70)
    bt = torch.as_tensor(b)
    coefs = [(0.0, 0.8), (0.3, 1.1), (0.2, 1.2)]
    nan_x = torch.full_like(bt, float("nan"))
    before = launch_counts()
    got = smoother_sweep(nan_x, bt, op.tables, asm.tables, coefs, zero_x=True)
    assert launch_counts() == before
    assert torch.isfinite(got).all()
    assert torch.equal(got, smoother_sweep_plain(None, bt, op.tables,
                                                 asm.tables, coefs, True))


@pytest.mark.parametrize("env", ["2,3", "", " 4 ,", None])
def test_chain_degrees_parse_like_jax(env, monkeypatch):
    if env is None:
        monkeypatch.delenv(GATE, raising=False)
    else:
        monkeypatch.setenv(GATE, env)
    assert factory._chain_win_degrees() == jfactory._chain_win_degrees()


def _cheb_params(degree, kind="1st kind"):
    return {"type": "Chebyshev", "degree": degree, "polynomial type": kind,
            "preconditioner": {"type": "FDM", "weighting type": "symm"}}


def test_gate_attaches_nothing_on_cpu(monkeypatch):
    monkeypatch.setenv(GATE, "1,2,3")
    _, _, op, _, _, _ = _level((2, 2, 2), 2, 80)
    for params in (_cheb_params(2),
                   {"type": "Relaxation", "degree": 2,
                    "preconditioner": _cheb_params(2)["preconditioner"]}):
        sm = factory.create_system_preconditioner(op, params)
        assert sm.fused_step is None and sm.fused_sweep is None
        assert sm.fused_sweep_zero is None


@pytest.mark.parametrize("params", [
    _cheb_params(2), _cheb_params(3, "4th kind"),
    {"type": "Relaxation", "degree": 3, "omega": 0.5,
     "preconditioner": {"type": "FDM", "weighting type": "symm"}}])
def test_attach_wiring_matches_unfused_smoother(params, monkeypatch):
    """The factory's wiring with kernel D's plain path (the wrapper on CPU
    tensors) gives the unfused smoother's result; a degree outside the gate
    attaches kernel C only."""
    _, _, op, asm, x, b = _level((3, 3, 2), 2, 90)
    degree = params["degree"]
    sm = factory.create_system_preconditioner(op, params)
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    ref_step, ref_zero = sm.step(xt, bt), sm.vmult(bt)
    monkeypatch.setenv(GATE, str(degree + 1))
    factory.attach_fused_kernels(sm, op, asm)
    assert sm.fused_step is not None and sm.fused_sweep is None
    monkeypatch.setenv(GATE, f"1,{degree}")
    factory.attach_fused_kernels(sm, op, asm)
    assert sm.fused_sweep is not None
    assert _rel(sm.step(xt, bt), ref_step) < 1e-6
    assert _rel(sm.vmult(bt), ref_zero) < 1e-6


def _sub_step_sweep(x, b, op, asm, coefs, zero_x):
    """Kernel D's sub-steps as csrc/smoother_sweep.cu runs them, walked with
    the plain versions of its launches: kernel A's residual r = b - A x_s
    (none in the zero guess's first sub-step, which reads b), then kernel
    B's momentum step.  p starts as garbage (NaN) and is read only where
    f1 != 0 after the first sub-step, written only where a later row reads
    it; the iterates ping-pong between two buffers so that the last
    sub-step writes out."""
    from dealii_asm_tpu_torch.kernels.banded_laplace import \
        banded_laplace_plain
    from dealii_asm_tpu_torch.kernels.fdm_patch import fdm_patch_plain

    k = len(coefs)
    p = torch.full_like(b, float("nan"))
    out, tmp = torch.full_like(b, float("nan")), torch.full_like(b, float("nan"))
    xs = None if zero_x else x
    for i, (f1, f2) in enumerate(coefs):
        xn = out if (k - 1 - i) % 2 == 0 else tmp
        read_p = i > 0 and f1 != 0.0
        write_p = i + 1 < k and coefs[i + 1][0] != 0.0
        src = b if xs is None else banded_laplace_plain(xs, op.tables, b)
        v = fdm_patch_plain(src, asm.tables, f2)
        pn = f1 * p + v if read_p else v
        if write_p:
            p.copy_(pn)
        xn.copy_(pn if xs is None else xs + pn)
        xs = xn
    return out


@pytest.mark.parametrize("rows", [
    [(0.0, 0.9), (0.4, 1.3)],              # Chebyshev-like, degree 2
    [(0.0, 0.8), (0.3, 1.1), (0.2, 1.2)],  # degree 3
    [(0.0, 0.5)] * 3,                      # Relaxation: p never read
    [(0.0, 0.7)]])                         # one sub-step
@pytest.mark.parametrize("zero_x", [False, True])
@pytest.mark.parametrize("p", [2, 4])  # the fdm1 ladder's level degrees
def test_sweep_sub_steps_match_plain_and_tpu_chain(rows, zero_x, p):
    cells = (3, 4, 3) if p == 2 else (2, 3, 2)
    jop, jasm, op, asm, x, b = _level(cells, p, 110 + len(rows))
    xt, bt = torch.as_tensor(x), torch.as_tensor(b)
    got = _sub_step_sweep(None if zero_x else xt, bt, op, asm, rows, zero_x)
    assert torch.isfinite(got).all()  # garbage p was never read
    ref = smoother_sweep_plain(None if zero_x else xt, bt, op.tables,
                               asm.tables, rows, zero_x)
    assert _rel(got, ref) < 1e-6
    mask = op.dofs.boundary_mask
    if zero_x:
        assert not got.numpy()[mask].any()
    else:
        np.testing.assert_array_equal(got.numpy()[mask], x[mask])
    ck = SmootherStepKernel(jop, jasm).as_chain(len(rows))
    shape = op.grid_shape
    xg, bg = jnp.asarray(x).reshape(shape), jnp.asarray(b).reshape(shape)
    bp = ck.pad_grid(bg)
    out = ck.sweep_padded(bp if zero_x else ck.pad_grid(xg), bp, rows,
                          zero_x=zero_x, interpret=True)
    tpu = ck.unpad_grid(out, full_src=None if zero_x else xg).reshape(-1)
    assert _rel(got, tpu) < 4e-2
