"""The port's matrix-free-loop benchmark driver
(dealii_asm_tpu_torch.models.benchmark) against the JAX package's.

Each label's apply is built by both drivers on the same periodic balanced
hyper-cube and applied once to the same source vector (``default_rng(0)``
normal, cast to the number type); the port runs its plain PyTorch paths on
CPU tensors, the paths it runs on the card for these meshes (no kernel
takes a periodic mesh).  The label families: the operator; the weightings
add/none/pre/post/symm/RAS around element overlap 1 and 2 and vertex
patches, under several storage letters; Chebyshev around the diagonal and
around FDM (Lanczos for the symmetric weightings, power iteration
otherwise).  Sizes: ``matrix_free_loop.json`` (s = 6, 2³ cells, Q4), s = 6
at Q3, s = 3 at Q2 (cells (3, 1, 1): a 1-cell periodic axis), and the
deformed periodic box (``"use cartesian mesh": false``) at s = 6 and s = 3,
Q2.  float64 runs with ``jax_enable_x64`` on (``tests/conftest.py``).

Tolerances (relative L2 against the JAX apply; the Chebyshev labels'
largest-eigenvalue estimates relative 1e-4 in float32, 1e-10 in float64):
- float32: 1e-5 (float32 rounding of the same products in another order;
  the JAX float32 operator is its dense separable form, the port's the
  banded one); Chebyshev labels 1e-4: the eigenvalue estimates of the two
  packages differ at float32 rounding, and the degree-k polynomial
  carries that difference;
- float64: 1e-12.
The ``>>`` lines agree with the JAX driver's field for field, apart from
the seconds.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

import _torch_ranks
import jax.numpy as jnp

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.balanced import \
    balanced_hyper_cube_subdivisions as jax_subdivisions
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import \
    sinusoidal_displacement as jax_sinusoidal
from dealii_asm_tpu.models import benchmark as jax_benchmark
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu_torch.mesh.transforms import sinusoidal_displacement
from dealii_asm_tpu_torch.models import benchmark
from dealii_asm_tpu_torch.parallel.dryrun import spawn

HERE = os.path.dirname(os.path.abspath(__file__))
# the Chebyshev labels' largest-eigenvalue estimates (float64 Lanczos or
# power iteration in both packages, around the operator of the number
# type): the two packages' float32 operators round differently, and 40
# Lanczos steps carry that to ~5e-5 (observed)
EV_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
MFL = os.path.join(HERE, os.pardir, "experiments", "matrix_free_loop.json")
# the JAX driver test's own config (tests/test_drivers.py)
DRIVER_2D = {"dim": 2, "n subdivision": 3, "fe degree": 3,
             "n repetitions": 2, "number type": "float64",
             "preconditioner types": "vmult post-1-c cheby-2-2-diag"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread per test process (see tests/test_torch_gmres.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mfl():
    with open(MFL) as f:
        return json.load(f)


def _config(s, p, number_type, labels, cartesian=True):
    return {"dim": 3, "n subdivision": s, "fe degree": p,
            "n repetitions": 2, "number type": number_type,
            "use cartesian mesh": cartesian, "preconditioner types": labels}


CONFIGS = {
    "mfl": _mfl(),
    "s6_q3": _config(
        6, 3, "float32",
        "vmult add-1-c none-1-g-s-n pre-1-l post-1-dg symm-1-g-p-c "
        "ras-1-c pre-2-l post-2-dg symm-2-g-p-n ras-2-c none-v-c pre-v-c "
        "post-v-l symm-v-c ras-v-c cheby-3-0-diag cheby-3-2-symm-1-c "
        "cheby-2-0-symm-2-g-p-n cheby-3-2-symm-v-c cheby-2-0-post-1-c"),
    "s3_q2_f64": _config(
        3, 2, "float64",
        "vmult add-1-c pre-1-c post-2-c symm-2-g-p-n ras-2-c symm-v-c "
        "ras-v-c cheby-2-0-diag cheby-3-2-symm-v-c cheby-2-0-pre-1-c"),
    "s3_q2_f32": _config(3, 2, "float32",
                         "vmult symm-1-c symm-v-c cheby-3-2-symm-1-c"),
    "deformed_s6_q2": _config(
        6, 2, "float64",
        "vmult symm-1-c pre-2-c ras-2-c symm-v-c ras-v-c cheby-2-0-diag "
        "cheby-2-2-symm-1-c", cartesian=False),
    "deformed_s3_q2": _config(3, 2, "float64",
                              "vmult symm-1-c symm-2-c symm-v-c",
                              cartesian=False),
}


def _jax_problem(params):
    """(dofs, op, src0, dtype) of the JAX driver's ``run_benchmark``."""
    s, p = params["n subdivision"], params["fe degree"]
    cells, lengths = jax_subdivisions(3, s)
    cartesian = params.get("use cartesian mesh", True)
    mesh = JaxMesh(3, tuple(cells), lengths=tuple(lengths),
                   periodic=(True,) * 3,
                   transform=None if cartesian else jax_sinusoidal(0.1))
    dofs = JaxDofHandler(mesh, p)
    dtype = {"float32": jnp.float32,
             "float64": jnp.float64}[params["number type"]]
    op = JaxLaplace(dofs, dtype=dtype)
    src0 = jnp.asarray(np.random.default_rng(0).standard_normal(dofs.n_dofs),
                       dtype)
    return dofs, op, src0, dtype


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_label_applies_match_jax(name):
    params = CONFIGS[name]
    jdofs, jop, jsrc, jdtype = _jax_problem(params)
    dofs, op, src, dtype = benchmark.make_problem(params, device="cpu")
    assert dofs.n_dofs == jdofs.n_dofs
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    for label in params["preconditioner types"].split():
        jfn, jfactor, _, _, _ = jax_benchmark.build_from_label(
            label, jop, jdofs, jdtype)
        fn, factor = benchmark.build_from_label(label, op, dofs)
        assert factor == jfactor
        got = fn(src)
        assert got.dtype == dtype and got.shape == src.shape
        if dtype == torch.float64:
            tol = 1e-12
        else:
            tol = 1e-4 if label.startswith("cheby") else 1e-5
        err = _rel_l2(got.numpy(), jfn(jsrc))
        assert err < tol, (label, err)
        if label.startswith("cheby"):
            ev = fn.__self__.eigenvalues.max_eigenvalue_estimate
            jev = jfn.__self__.eigenvalues.max_eigenvalue_estimate
            assert abs(ev - jev) <= EV_TOL[dtype] * abs(jev), (label, ev, jev)


def _lines(text):
    return [l.split() for l in text.splitlines() if l.startswith(">>")]


@pytest.mark.parametrize("params", [_mfl(), DRIVER_2D],
                         ids=["matrix_free_loop", "driver_2d_f64"])
def test_lines_match_jax(params):
    jout, out = io.StringIO(), io.StringIO()
    n_jax = jax_benchmark.run_benchmark(params, out=jout)
    n = benchmark.run_benchmark(params, out=out, device="cpu")
    assert n == n_jax
    got, ref = _lines(out.getvalue()), _lines(jout.getvalue())
    assert len(got) == len(ref) == len(params["preconditioner types"].split())
    for g, r in zip(got, ref):
        assert len(g) == 9
        assert g[:4] + g[5:] == r[:4] + r[5:]  # all but the seconds
        assert float(g[4]) > 0


def test_cli_on_the_cpu(capsys):
    assert benchmark.main([MFL, "--device", "cpu"]) == 0
    lines = _lines(capsys.readouterr().out)
    labels = _mfl()["preconditioner types"].split()
    assert [l[1] for l in lines] == labels
    assert all(l[2] == "512" and l[6] == "4" for l in lines)
    assert [l[3] for l in lines] == ["10", "10", "10", "10", "30", "30"]


def test_device_policy_and_n_devices():
    """The card by default; "n devices" 2 on two gloo ranks prints the JAX
    package's sharded lines (ghost columns 2·hw·plane) and applies the
    operator and the FDM as one device does (float64, 1e-12); "auto"
    without a process group is one device on the CPU."""
    params = dict(DRIVER_2D, **{"preconditioner types": "vmult"})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            benchmark.run_benchmark(params)  # the card by default
    sharded = dict(DRIVER_2D, **{"n devices": 2})
    text, applied = spawn(2, _torch_ranks.benchmark_lines, (sharded,))[0]
    # the JAX sharded Chebyshev retraces its shard_map at every Lanczos
    # step (25 s here), so the JAX lines are those of the other labels;
    # the Chebyshev label exchanges the operator's halo, as in the JAX
    # package (``benchmark.py:93-97``)
    jout = io.StringIO()
    jax_benchmark.run_benchmark(
        dict(sharded, **{"preconditioner types": "vmult post-1-c"}),
        out=jout)
    got, ref = _lines(text), _lines(jout.getvalue())
    assert len(got) == 3 and [g[:4] + g[5:] for g in got[:2]] == [
        r[:4] + r[5:] for r in ref]
    assert got[2][1:4] == ["cheby-2-2-diag", got[0][2], "4"]
    assert got[2][5:] == got[0][5:] and int(got[0][7]) > 0
    assert np.isfinite(applied[2]).all()
    single = []
    benchmark.run_benchmark(dict(DRIVER_2D), out=io.StringIO(), device="cpu",
                            on_label=lambda rec, fn, src: single.append(
                                fn(src).numpy()))
    for k in (0, 1):  # vmult and post-1-c; the pad planes come last
        n = single[k].shape[0]
        np.testing.assert_allclose(applied[k][:n], single[k], rtol=0,
                                   atol=1e-12 * np.abs(single[k]).max())
    out = io.StringIO()
    benchmark.run_benchmark(dict(params, **{"n devices": "auto"}), out=out,
                            device="cpu")
    assert len(_lines(out.getvalue())) == 1


def test_parse_fdm_label():
    parse = benchmark.parse_fdm_label
    for label in ("add-1-c", "none-2-g-s-n", "ras-v-dg", "symm-3-l"):
        props = label.split("-")
        assert parse(props, 0) == jax_benchmark.parse_fdm_label(props, 0)
    assert parse("add-1-c".split("-"), 0) == {
        "weighting_type": "none", "patch_type": "element", "n_overlap": 1}
    assert parse("cheby-3-2-symm-v-c".split("-"), 3) == {
        "weighting_type": "symm", "patch_type": "vertex", "n_overlap": 1}


def test_sinusoidal_displacement_matches_jax():
    pts = np.random.default_rng(3).uniform(0.0, 3.0, (50, 3))
    np.testing.assert_array_equal(sinusoidal_displacement(0.1)(pts),
                                  jax_sinusoidal(0.1)(pts))
