"""The port's run_config (dealii_asm_tpu_torch.models.poisson) vs the JAX
package's, both run in-test on the CPU on the same config.

Contract: the same CG iteration counts (the flagship e2e_aniso_q4.json takes
4 iterations at 2 refinements and 5 at 3 in the JAX package), and solutions
equal to rel-l2 1e-8.  Both solve in float64 over float32 multigrid levels;
the level applies differ at float32 rounding, and the converged iterate
sees that perturbation scaled by the remaining relative residual (1e-5 here):
observed 1e-11 to 1e-14.

The Kershaw solve e2e_kershaw_q4.json (ph-multigrid, Chebyshev degree 2
around per-cell FDM, deformed geometry) takes 28 iterations at 0 refinements
and 38 at 1 in both packages; solutions equal to rel-l2 1e-6.  There the JAX
package's CPU float64 outer operator is its double-single composition
(about 1e-8 relative, see tests/test_torch_merged.py), so the iterates
differ by more: observed 4.4e-8 (0 refinements) and 1.7e-7 (1).

The large-scaling ladder (experiments/sweep_large_scaling/, anisotropy
stretch 50, Q4, hp-multigrid, float32 levels) takes the JAX package's
counts on the CPU: fdm1 (Chebyshev-2 around FDM) 7, 9 and 15 at 1, 2 and 3
refinements, diag (Chebyshev-3 around Diagonal) 15 at 2, fdm1 with the
CoarseCG coarse solve (the r = 7 config input_0029.json) 9 at 2, and fdm1
with its smoother replaced by Relaxation degree 3 around the same FDM 8 at
2.  The fdm1 count at 2 refinements and its solution (rel-l2 1e-8) come
from a JAX run in the test; the other counts are pinned from one run each
of ``dealii_asm_tpu.models.poisson.run_config`` on the CPU with the same
config.
"""

import copy
import filecmp
import json
import os

import numpy as np
import pytest
import torch

import _torch_ranks
from dealii_asm_tpu.fem.dofs import DofHandler as JaxDofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh as JaxMesh
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.utils.vtu import write_vtu as jax_write_vtu
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.parallel.dryrun import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "experiments", "e2e_aniso_q4.json")) as _f:
    FLAGSHIP = json.load(_f)
with open(os.path.join(ROOT, "experiments", "e2e_kershaw_q4.json")) as _f:
    KERSHAW = json.load(_f)
with open(os.path.join(ROOT, "experiments", "e2e_ball_q4.json")) as _f:
    BALL = json.load(_f)
LADDER = os.path.join(ROOT, "experiments", "sweep_large_scaling")

HYPERCUBE_Q2 = {
    "dim": 3, "degree": 2, "n refinements": 3,
    "mesh": {"name": "hypercube", "n subdivisions": 1},
    "solver": {"type": "CG", "rel tolerance": 1e-8},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "mg number type": "float32",
        "mg smoother": {
            "type": "Chebyshev", "degree": 2, "polynomial type": "4th kind",
            "preconditioner": {"type": "FDM", "n overlap": 1,
                               "weighting type": "post"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


# degree 1: the intermediate-level split (every level has degree 1), with a
# one-sided V-cycle, two coarse cycles and float64 levels
HYPERCUBE_Q1 = {
    "dim": 3, "degree": 1, "n refinements": 3, "mg number type": "float64",
    "mesh": {"name": "hypercube", "n subdivisions": 2},
    "solver": {"type": "CG", "rel tolerance": 1e-6},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "one-sided v-cycle": True,
        "n coarse cycles": 2,
        "mg smoother": {
            "type": "Chebyshev", "degree": 3,
            "preconditioner": {"type": "FDM", "weighting type": "none"}},
        "mg coarse grid solver": {"type": "AMG"}},
}


@pytest.fixture(autouse=True)
def one_torch_thread(request):
    """One intra-op thread per test process (see tests/test_torch_gmres.py),
    except for the Kershaw solve at 0 refinements, which keeps torch's
    default.  Its count depends on the thread count: the last residual lies
    within 4% of the threshold, and the float32 level applies round
    differently when their products are split over another number of
    threads (the port takes 28 iterations with 8 threads, its last residual
    at 0.526 of the threshold and the one before at 1.005; 27 with 1, 2 or
    4, its last at 0.964).  At 1 refinement the port takes 38 with 1 or 8
    threads."""
    if (request.function.__name__ == "test_kershaw_run_config_matches_jax"
            and "n refinements 0" in request.node.callspec.params["name"]):
        yield
        return
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(*_):
    pass


def _config(name):
    if name.startswith("hypercube"):
        p = copy.deepcopy(HYPERCUBE_Q2 if name == "hypercube-q2"
                          else HYPERCUBE_Q1)
    else:
        p = copy.deepcopy(KERSHAW if name.startswith("e2e_kershaw")
                          else BALL if name.startswith("e2e_ball")
                          else FLAGSHIP)
        p["n refinements"] = int(name[-1])
    # one solve: "best of" only repeats the timed solve
    p["print timing"] = False
    p["solver"]["best of"] = 1
    return p


@pytest.mark.parametrize("name,expected_it", [
    ("e2e_aniso_q4 n refinements 2", 4),
    ("e2e_aniso_q4 n refinements 3", 5),
    ("hypercube-q2", None),
    ("hypercube-q1", None),
])
def test_run_config_matches_jax(name, expected_it):
    params = _config(name)
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"]
    if expected_it is not None:
        assert got["it"] == expected_it
    assert got["n_dofs"] == ref["n_dofs"] and got["L"] == ref["L"]
    x_ref = np.asarray(ref["solution"])
    x = got["solution"]
    assert x.dtype == torch.float64 and x.shape == x_ref.shape
    rel = np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-8


@pytest.mark.parametrize("name,expected_it", [
    ("e2e_kershaw_q4 n refinements 0", 28),
    ("e2e_kershaw_q4 n refinements 1", 38),
])
def test_kershaw_run_config_matches_jax(name, expected_it):
    params = _config(name)
    ref = jax_run_config(copy.deepcopy(params), log=_quiet)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and ref["converged"]
    assert got["it"] == ref["it"] == expected_it
    assert got["n_dofs"] == ref["n_dofs"] and got["L"] == ref["L"]
    x_ref = np.asarray(ref["solution"])
    x = got["solution"]
    assert x.dtype == torch.float64 and x.shape == x_ref.shape
    rel = np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)
    assert rel < 1e-6


@pytest.mark.parametrize("mg_type", ["h", "p", "hp", "ph"])
@pytest.mark.parametrize("mesh,degree,seq", [
    ({"name": "kershaw", "eps": 0.3}, 4, "bisect"),
    ({"name": "hypercube", "n subdivisions": 2}, 3, "decrease by one"),
    ({"name": "anisotropy", "stratch": 2.0}, 1, "go to one"),
])
def test_mg_level_layout_matches_jax(mg_type, mesh, degree, seq):
    from dealii_asm_tpu.models.poisson import make_mesh_family as jax_family
    from dealii_asm_tpu.models.poisson import mg_level_layout as jax_layout
    from dealii_asm_tpu_torch.models.poisson import (make_mesh_family,
                                                     mg_level_layout)

    params = {"dim": 3, "n refinements": 2, "mesh": mesh}
    precon = {"mg type": mg_type, "mg p sequence": seq}
    family, jfamily = make_mesh_family(params), jax_family(params)
    assert family.mapping_degree == jfamily.mapping_degree
    assert family.base_cells == jfamily.base_cells
    assert (mg_level_layout(precon, family, degree)
            == jax_layout(precon, jfamily, degree))


@pytest.mark.parametrize("path,value,item", [
    # the options that raised until PR 13, with the ROADMAP item each waited
    # for; they now run and are held against the JAX package
    (("do output",), True, "ROADMAP item 12"),
    (("n devices",), 2, "ROADMAP item 14"),
    (("n devices",), 4, "ROADMAP item 14"),
])
def test_unported_options_raise(path, value, item, tmp_path):
    """"do output" writes the VTU file the JAX writer writes for the same
    solution; "n devices" 2 and 4 run the flagship at 2 refinements on that
    many gloo ranks (the 17^3 top level sharded, "replicate below" 1000),
    both with the JAX package's one-device count and solution (rel-l2
    1e-8)."""
    name = ("e2e_aniso_q4 n refinements 1" if path == ("do output",)
            else "e2e_aniso_q4 n refinements 2")
    params = _config(name)
    params[path[-1]] = value
    ref = jax_run_config(_config(name), log=_quiet)
    x_ref = np.asarray(ref["solution"])
    if path == ("do output",):
        params["output file"] = str(tmp_path / "port.vtu")
        got = run_config(params, log=_quiet, device="cpu")
        runs = [(got["it"], got["converged"], got["solution"].numpy())]
        dofs = JaxDofHandler(JaxMesh(3, (2, 2, 2)), 4)
        jax_write_vtu(str(tmp_path / "jax.vtu"), dofs,
                      {"solution": runs[0][2]})
        assert filecmp.cmp(tmp_path / "port.vtu", tmp_path / "jax.vtu",
                           shallow=False)
    else:
        params["preconditioner"]["replicate below"] = 1000
        ranks = spawn(value, _torch_ranks.run_configs, ([params],))
        runs = [rank[0][:3] for rank in ranks]  # one config per rank
        assert len(runs) == value
    for it, converged, x in runs:
        assert converged and ref["converged"] and it == ref["it"]
        rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
        assert rel < 1e-8


def _ladder(name, r):
    """A ladder rung's config at ``r`` refinements (``name``: fdm1, diag,
    fdm1-coarsecg or fdm1-relaxation3)."""
    column = {"diag": 0, "fdm1": 1}[name.split("-")[0]]
    idx = 29 if name == "fdm1-coarsecg" else 4 * r + column
    with open(os.path.join(LADDER, f"input_{idx:04d}.json")) as f:
        p = json.load(f)
    p["n refinements"] = r
    p["print timing"] = False
    p["solver"]["best of"] = 1
    if name == "fdm1-relaxation3":
        sm = p["preconditioner"]["mg smoother"]
        p["preconditioner"]["mg smoother"] = {
            "type": "Relaxation", "degree": 3,
            "preconditioner": sm["preconditioner"]}
    return p


@pytest.mark.parametrize("name,r,expected_it,against_jax", [
    ("fdm1", 1, 7, False),
    ("fdm1", 2, 9, True),
    ("fdm1", 3, 15, False),
    ("diag", 2, 15, False),
    ("fdm1-coarsecg", 2, 9, False),
    ("fdm1-relaxation3", 2, 8, False),
])
def test_large_scaling_ladder_counts(name, r, expected_it, against_jax):
    params = _ladder(name, r)
    got = run_config(copy.deepcopy(params), log=_quiet, device="cpu")
    assert got["converged"] and got["it"] == expected_it
    assert got["n_dofs"] == (4 * 2 ** r + 1) ** 3
    if against_jax:
        ref = jax_run_config(copy.deepcopy(params), log=_quiet)
        assert ref["converged"] and ref["it"] == expected_it
        x_ref = np.asarray(ref["solution"])
        rel = np.linalg.norm(got["solution"].numpy() - x_ref) / np.linalg.norm(
            x_ref)
        assert rel < 1e-8


def test_probe_ladder_records_on_cpu(capsys):
    """``probe ladder`` prints one JSON record per rung; fdm2 (overlap 2)
    takes the JAX package's 6 iterations at 1 refinement (pinned from one
    JAX run_config of input_0006.json); a rung that cannot run records the
    error: fdmv's hp layout puts p-levels on the 1-cell mesh, which has no
    interior vertex (the JAX package raises there too)."""
    from dealii_asm_tpu_torch import probe

    recs = probe.ladder(["fdm1:0-1", "fdm2:1", "fdmv:1"], best_of=1,
                        device="cpu")
    assert [(r["smoother"], r["refinement"]) for r in recs] == [
        ("fdm1", 0), ("fdm1", 1), ("fdm2", 1), ("fdmv", 1)]
    assert recs[1]["it"] == 7 and recs[1]["n_dofs"] == 729
    assert recs[2]["it"] == 6 and recs[2]["converged"]
    assert ("level (refinement 0, degree 2) has no interior vertex"
            in recs[3]["error"])
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert printed == recs
