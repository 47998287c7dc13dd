"""The port's last drivers and output against the JAX package's: the VTU
writers (dealii_asm_tpu_torch.utils.vtu), the mesh gallery and coarsening
printout (models/mesh_gallery.py), the multigrid's stage spans
(utils/profiling.py, precond/multigrid.py), the power-kernel study
(models/power_kernel.py) and the variant studies (models/variant_bench.py).

Contract:
- VTU files byte-equal to the JAX writer's for the same fields: 2D and 3D
  lattices (one periodic), a Kershaw mesh and the 3D ball; the gallery's
  files and table and the coarsening printout equal the JAX ones;
- one V-cycle of the same h-multigrid records the same (level, stage) keys
  and counts in the port's tracer as in the JAX ``StageTimer``;
  ``run_config`` under "print timing" prints the tracer's level × stage
  table; with the tracer off the V-cycle gives the same bits; ``trace``
  writes a Chrome trace of an apply and a solve, the program's spans
  beside the operations, and tabulates its operations;
- ``power_kernel`` and ``variant_bench`` print the JAX labels (the JAX
  access label ``pallas`` is the port's ``cuda``), with the JAX n_dofs,
  repetition and size fields; on the CPU every label runs eagerly.  Their
  applies agree with the JAX ones in float32 to 1e-5 (relative L2); the
  access study's ``gather`` step with the JAX ``gather`` route's.
"""

import contextlib
import copy
import filecmp
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform as jax_kershaw
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.models import mesh_gallery as jax_gallery
from dealii_asm_tpu.models import power_kernel as jax_power
from dealii_asm_tpu.models import variant_bench as jax_variant
from dealii_asm_tpu.models.poisson import _build_multigrid as jax_build_mg
from dealii_asm_tpu.models.poisson import make_mesh_family as jax_family
from dealii_asm_tpu.ops.laplace import LaplaceOperator as JaxLaplace
from dealii_asm_tpu.precond.asm import ASMPreconditioner as JaxASM
from dealii_asm_tpu.utils.profiling import StageTimer as JaxStageTimer
from dealii_asm_tpu.utils.vtu import write_vtu as jax_write_vtu
from dealii_asm_tpu.utils.vtu import write_vtu_mesh as jax_write_vtu_mesh
from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced
from dealii_asm_tpu_torch.models import mesh_gallery, power_kernel
from dealii_asm_tpu_torch.models import variant_bench
from dealii_asm_tpu_torch.models.poisson import (_build_multigrid,
                                                 make_mesh_family, run_config)
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.solvers import krylov
from dealii_asm_tpu_torch.utils.profiling import trace, tracing
from dealii_asm_tpu_torch.utils.vtu import write_vtu, write_vtu_mesh

SMALL = {"n subdivisions": 2, "degree": 3, "n repetitions": 2}
MG = {
    "dim": 3, "degree": 2, "n refinements": 2,
    "solver": {"type": "CG", "rel tolerance": 1e-6},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h",
        "mg smoother": {"type": "Chebyshev", "degree": 2,
                        "preconditioner": {"type": "FDM",
                                           "weighting type": "symm"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _lines(text):
    return [l.split() for l in text.splitlines() if l.startswith(">>")]


@pytest.mark.parametrize("dim,cells,degree,periodic", [
    (2, (3, 2), 3, (False, False)),
    (3, (2, 2, 3), 2, (False, False, False)),
    (3, (2, 1, 2), 2, (True, False, True)),
])
def test_vtu_lattice_bytes_equal_jax(tmp_path, dim, cells, degree, periodic):
    dofs = DofHandler(StructuredMesh(dim, cells, periodic=periodic), degree)
    jdofs = JaxDofHandler(JaxMesh(dim, cells, periodic=periodic), degree)
    rng = np.random.default_rng(3)
    fields = {"solution": rng.standard_normal(dofs.n_dofs),
              "rhs": rng.standard_normal(dofs.n_dofs)}
    write_vtu(str(tmp_path / "port.vtu"), dofs, fields)
    jax_write_vtu(str(tmp_path / "jax.vtu"), jdofs, fields)
    assert filecmp.cmp(tmp_path / "port.vtu", tmp_path / "jax.vtu",
                       shallow=False)


@pytest.mark.parametrize("which", ["kershaw", "ball"])
def test_vtu_mesh_bytes_equal_jax(tmp_path, which):
    if which == "ball":
        mesh, jmesh = (hyper_ball_balanced(3).refine(),
                       jax_ball(3).refine())
    else:
        mesh = StructuredMesh(3, (3, 2, 2),
                              transform=kershaw_transform(0.3, 0.3))
        jmesh = JaxMesh(3, (3, 2, 2), transform=jax_kershaw(0.3, 0.3))
    data = {"id": np.arange(mesh.n_cells_total, dtype=np.float64)}
    write_vtu_mesh(str(tmp_path / "port.vtu"), mesh, data)
    jax_write_vtu_mesh(str(tmp_path / "jax.vtu"), jmesh, data)
    assert filecmp.cmp(tmp_path / "port.vtu", tmp_path / "jax.vtu",
                       shallow=False)


def test_gallery_and_coarsening_equal_jax(tmp_path):
    out = {}
    for name, mod in (("port", mesh_gallery), ("jax", jax_gallery)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = mod.run_gallery(str(tmp_path / name))
            mod.run_coarsening(4)
            mod.run_coarsening(3, 2)
        out[name] = (rows, buf.getvalue())
    assert out["port"] == out["jax"]
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port")) and len(files) == 10
    for f in files:
        assert filecmp.cmp(tmp_path / "port" / f, tmp_path / "jax" / f,
                           shallow=False), f


def test_stage_timer_keys_and_counts_equal_jax():
    pp = MG["preconditioner"]
    jmg = jax_build_mg(pp, jax_family(MG), 2, None, _quiet, jnp.float32)
    jmg.timer = JaxStageTimer(enabled=True)
    mg = _build_multigrid(pp, make_mesh_family(MG), 2, _quiet, torch.float32,
                          torch.device("cpu"))
    b = np.random.default_rng(5).standard_normal(9 ** 3)
    with tracing() as tracer:
        y = mg.vmult(torch.as_tensor(b, dtype=torch.float32))
    y_ref = jmg.vmult(jnp.asarray(b, jnp.float32))
    counts = tracer.stage_counts()
    assert counts == dict(jmg.timer.counts)
    assert len(counts) == 1 + 5 * 2  # coarse + 5 stages × 2 levels
    assert set(counts) == set(jmg.timer.times)
    assert _rel(y.numpy(), y_ref) < 1e-5
    # with the tracer off the V-cycle gives the same bits
    assert torch.equal(mg.vmult(torch.as_tensor(b, dtype=torch.float32)), y)
    assert tracer.stage_counts() == counts and counts[(0, "coarse solve")] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    dofs = DofHandler(StructuredMesh(3, (2, 2, 2)), 2)
    op = LaplaceOperator(dofs, dtype=torch.float64, device="cpu")
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(dofs.n_dofs))
    with trace(str(tmp_path)) as prof:
        y = op.vmult(u)
        krylov.solve("CG", op.vmult, u, max_iterations=2)
    assert y.shape == u.shape and bool(torch.isfinite(y).all())
    assert prof.key_averages()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    # the program's spans beside the operations
    assert {"solve", "cg.iteration", "cg.operator"} <= names
    assert any(str(n).startswith("aten::") for n in names)


def test_run_config_prints_the_stage_table(capsys):
    params = dict(copy.deepcopy(MG), **{"print timing": True})
    with tracing() as tracer:
        res = run_config(params, log=_quiet, device="cpu")
    lines = capsys.readouterr().out.splitlines()
    head = lines[0].split("|")
    assert head[0].strip() == "level"
    assert [h.strip() for h in head[1:]] == sorted(
        ["coarse solve", "post smooth", "pre smooth", "prolongate",
         "residual", "restrict"])
    # a row per level, the coarsest 0: host ms / device ms ("-" on the CPU)
    assert [int(l.split("|")[0]) for l in lines[1:4]] == [0, 1, 2]
    assert lines[2].split("|")[1].strip() == "-"  # no coarse solve on 1
    assert lines[1].split("|")[1].strip().endswith("/        -")
    assert res["converged"]
    # the warm-up solve is traced, the timed one not: CG applies the
    # V-cycle once per iteration, and each V-cycle solves the coarse
    # level once
    assert tracer.stage_counts()[(0, "coarse solve")] == res["it"]


def test_power_kernel_lines_and_applies_match_jax():
    params = {"n subdivision": 3, "fe degree": 3, "n repetitions": 2}
    buf, jbuf, applied = io.StringIO(), io.StringIO(), {}
    n = power_kernel.run_power_kernel(
        params, out=buf, device="cpu",
        on_label=lambda label, fn, u: applied.setdefault(label, fn(u)))
    jax_power.run_power_kernel(params, out=jbuf)
    got, ref = _lines(buf.getvalue()), _lines(jbuf.getvalue())
    assert [g[:4] + g[5:] for g in got] == [r[:4] + r[5:] for r in ref]
    assert int(got[0][2]) == n and "eager" in buf.getvalue().splitlines()[0]
    # A·(A·u) (+ 0.5·u) against the JAX operator on the same u
    from dealii_asm_tpu.mesh.balanced import balanced_hyper_cube_subdivisions

    cells, lengths = balanced_hyper_cube_subdivisions(3, 3)
    jop = JaxLaplace(JaxDofHandler(JaxMesh(3, tuple(cells), tuple(lengths),
                                           (True,) * 3), 3),
                     dtype=jnp.float32)
    u = jnp.asarray(np.random.default_rng(0).standard_normal(n), jnp.float32)
    aau = jop.vmult(jop.vmult(u))
    for label, ref_y in (("sequential", aau), ("power-own", aau),
                         ("power-own-axpy", aau + 0.5 * u)):
        assert _rel(applied[label].numpy(), ref_y) < 1e-5


def test_variant_bench_labels_and_steps_match_jax():
    buf, jbuf, steps = io.StringIO(), io.StringIO(), {}
    variant_bench.run_composition_bench(SMALL, out=buf, device="cpu")
    jax_variant.run_composition_bench(SMALL, out=jbuf)
    got, ref = _lines(buf.getvalue()), _lines(jbuf.getvalue())
    assert len(got) == 12
    assert [g[:4] + g[5:] for g in got] == [r[:4] + r[5:] for r in ref]
    buf = io.StringIO()
    n = variant_bench.run_access_bench(
        SMALL, out=buf, device="cpu",
        on_label=lambda label, fn, x: steps.setdefault(label, fn(x)))
    got = _lines(buf.getvalue())
    # the JAX labels global, gather, lanes, pallas: kernel C's fused step
    # is ``cuda``
    assert [g[1] for g in got] == ["global", "gather", "lanes", "cuda"]
    assert all(g[2:4] == [str(n), "2"] and g[5:] == ["4", "3", "0", "0"]
               for g in got)
    # one step y + P⁻¹(b − A y) from the JAX global route on the same x, b
    dofs = JaxDofHandler(JaxMesh(3, (2, 2, 2)), 3)
    op = JaxLaplace(dofs, dtype=jnp.float32)
    asm = JaxASM(dofs, n_overlap=1, weighting_type="symm", dtype=jnp.float32)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    b = jnp.asarray(rng.standard_normal(n), jnp.float32)
    ref_step = x + asm.vmult(b - op.vmult(x))
    for label in ("global", "gather", "lanes", "cuda"):
        assert _rel(steps[label].numpy(), ref_step) < 1e-5, label
    # the JAX gather route (variant_bench.py:135-142) on the same x, b
    gather = JaxASM(dofs, n_overlap=1, weighting_type="symm",
                    dtype=jnp.float32)
    gather.access, gather.global_fdm, gather.dense = "gather", None, None
    gather_step = x + gather.vmult_traceable(b - op.vmult(x))
    assert _rel(steps["gather"].numpy(), gather_step) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gather_route_in_chunks_matches_jax(monkeypatch, dtype):
    """The access study's ``gather`` route with its chunk size forced down
    to 512 bytes: 8 patches of 64 values make 4 chunks in float32 and 8 in
    float64 (sized by the itemsize), and the apply still matches the JAX
    ``gather`` route (``variant_bench.py:135-142``)."""
    monkeypatch.setattr(variant_bench, "GATHER_CHUNK_BYTES", 512)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    asm = variant_bench.ASMPreconditioner(
        DofHandler(StructuredMesh(3, (2, 2, 2)), 3), n_overlap=1,
        weighting_type="symm", dtype=tdt, device="cpu")
    gather = variant_bench.GatherASM(asm)
    itemsize = torch.empty((), dtype=tdt).element_size()
    assert list(gather.chunk_bounds(itemsize)) == list(
        range(0, 9, 2 if dtype == "float32" else 1))
    jasm = JaxASM(JaxDofHandler(JaxMesh(3, (2, 2, 2)), 3), n_overlap=1,
                  weighting_type="symm", dtype=jdt)
    jasm.access, jasm.global_fdm, jasm.dense = "gather", None, None
    x = np.random.default_rng(3).standard_normal(asm.dofs.n_dofs)
    ref = jasm.vmult_traceable(jnp.asarray(x, jdt))
    got = gather.vmult(torch.as_tensor(x, dtype=tdt))
    assert _rel(got.numpy(), ref) < (1e-5 if dtype == "float32" else 1e-12)
