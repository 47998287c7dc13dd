"""The port's ``run_config`` and benchmark driver with ``"n devices"`` > 1
(dealii_asm_tpu_torch.parallel.driver), on 2 and 4 gloo ranks of CPU
processes, against the JAX package on one device.

Contract (tests/test_sharded_driver.py, whose own sharded JAX runs are
marked slow and hold the JAX sharded path to one device): on both configs
of that file, Q3 h-multigrid with Chebyshev-1 around FDM overlap 1 and the
sharded top level above a replicated tail ("replicate below" 500), and Q2
at 3 refinements with Chebyshev-2 around the Diagonal over two sharded
levels joined by a sharded-sharded transfer ("replicate below" 300), the
sharded port takes the JAX package's single-device iteration count, and
its solution agrees to rtol 1e-7, atol 1e-9.  The sharded benchmark's
``>>`` lines (apart from the seconds) equal the JAX package's sharded ones
at the same device count, ghost columns ``2·hw·plane`` included
(2·4·16·32 for the Q4 vmult at 14 subdivisions on 2 devices); each rank
count is one spawn for the configs and the benchmark.  Without a process group, several devices raise with the
torchrun command; the CUDA default raises without a GPU.  The sharded
unstructured ball is tests/test_torch_general_sharded.py's.
"""

import copy
import io

import numpy as np
import pytest
import torch

import _torch_ranks
from dealii_asm_tpu.models.benchmark import run_benchmark as jax_benchmark
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.parallel.dryrun import spawn


def _cfg(**over):
    base = {
        "dim": 3, "degree": 3, "n refinements": 2,
        "solver": {"type": "CG", "rel tolerance": 1e-6},
        "preconditioner": {
            "type": "Multigrid", "mg type": "h",
            "mg smoother": {
                "type": "Chebyshev", "degree": 1,
                "preconditioner": {"type": "FDM", "n overlap": 1,
                                   "weighting type": "symm"}},
            "mg coarse grid solver": {"type": "AMG"}},
    }
    base.update(over)
    return base


def _fdm_top_level():
    cfg = _cfg()
    cfg["preconditioner"]["replicate below"] = 500
    return cfg


def _two_sharded_levels():
    cfg = _cfg(**{"degree": 2, "n refinements": 3})
    cfg["preconditioner"]["replicate below"] = 300
    cfg["preconditioner"]["mg smoother"] = {
        "type": "Chebyshev", "degree": 2,
        "preconditioner": {"type": "Diagonal"}}
    return cfg


CONFIGS = {"fdm-top-level": _fdm_top_level,
           "two-sharded-levels": _two_sharded_levels}
BENCH = {"dim": 3, "n subdivisions": 14, "fe degree": 4, "n repetitions": 2,
         "preconditioner types": "vmult symm-1-g", "number type": "float32"}


def _quiet(*_):
    pass


@pytest.fixture(scope="module")
def jax_single():
    return {name: jax_run_config(make(), log=_quiet)
            for name, make in CONFIGS.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def sharded(request):
    """One spawn of n ranks: both configs, then the benchmark driver."""
    n = request.param
    configs = [dict(make(), **{"n devices": n}) for make in CONFIGS.values()]
    ranks = spawn(n, _torch_ranks.run_configs,
                  (configs, dict(BENCH, **{"n devices": n})))
    runs = {name: [r[0][i] for r in ranks] for i, name in enumerate(CONFIGS)}
    return n, runs, ranks[0][1]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_run_config_matches_jax_single_device(sharded, jax_single,
                                                      name):
    n, runs, _ = sharded
    ref = jax_single[name]
    x_ref = np.asarray(ref["solution"])
    assert ref["converged"]
    for it, converged, x, n_dofs in runs[name]:  # every rank
        assert converged and it == ref["it"]
        assert n_dofs == ref["n_dofs"] and x.shape == x_ref.shape
        np.testing.assert_allclose(x, x_ref, rtol=1e-7, atol=1e-9)


def test_sharded_benchmark_ghost_columns_match_jax(sharded):
    n, _, (text, applied) = sharded
    buf = io.StringIO()
    jax_benchmark(dict(BENCH, **{"n devices": n}), out=buf)
    ref = [l.split() for l in buf.getvalue().splitlines()
           if l.startswith(">>")]
    got = [l.split() for l in text.splitlines() if l.startswith(">>")]
    assert [g[:4] + g[5:] for g in got] == [r[:4] + r[5:] for r in ref]
    if n == 2:  # z: 16 nodes over 2 ranks; the vmult band 4, plane 16·32
        assert int(got[0][7]) == 2 * 4 * 16 * 32
    assert int(got[1][7]) > 0
    assert all(np.isfinite(a).all() for a in applied)


def test_several_devices_without_a_process_group_raise():
    cfg = dict(_fdm_top_level(), **{"n devices": 2})
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        run_config(copy.deepcopy(cfg), log=_quiet, device="cpu")


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cfg = dict(_fdm_top_level(), **{"n devices": 2})
    with pytest.raises(RuntimeError, match="is_available"):
        run_config(cfg, log=_quiet)
