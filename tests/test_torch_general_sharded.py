"""The port's sharded unstructured ball (dealii_asm_tpu_torch.parallel.
general_sharded) on 2 and 4 gloo ranks against the JAX package on one
device, and the compact "operator mapping type" under "n devices".

Contract:
- ``GeneralPartition``'s tables (owners, renumbering, blocked slots, the
  cell map's gather, fetch and recv tables) equal the JAX ones entry for
  entry at 4 and 8 ranks (host only, no spawn);
- on the balanced ball refined once at Q2 (tests/test_general_sharded.py's
  mesh), gathered from the ranks: the sharded operator in float64 within
  1e-11·max of the JAX ``kernel="sumfac"`` product (the exact float64
  oracle) and in float32 within 2e-5·max of the JAX ``"lanes"`` one; the
  sharded ASM (symm, post, ras) within 3e-5·max of the JAX
  ``GeneralASMPreconditioner``; the replicated-coarse transfers (p: Q1 →
  Q2 on the unrefined ball; h: the ball → its refinement at Q2), prolongate
  and restrict, within 3e-6·(max + 1) of the JAX
  ``GeneralTwoLevelTransfer``; the 2D ball's operator within 1e-11·max of
  the JAX one; every apply repeated gives the same bits;
- ``run_config`` of experiments/e2e_ball_q4.json with "n devices" 2 and 4
  at 0 refinements (2,273 DoFs): 5 iterations on every rank, the solution
  within 1e-6 relative l2 of the JAX package's single-device run, two
  V-cycle applies bit-identical; at 1 refinement on 2 ranks (17,217 DoFs,
  the intermediate split below the sharded level): 6 iterations (the JAX
  count, tests/test_torch_poisson_ball.py), within 1e-6 of the port's
  single-device run;
- a compact mapping type ("linear geometry" on a Kershaw mesh) with
  float32 levels on 2 ranks converges on every rank, and its sharded outer
  operator equals the single-device merged float64 operator to 1e-12
  relative (the JAX package builds that lattice on the merged form too);
- a fine smoother other than element FDM overlap 1 raises ValueError.

Each rank count is one spawn for all its checks (``tests/_torch_ranks.py``:
the ranks import no JAX); this process computes the JAX references while
both spawns run.
"""

import copy
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks
from dealii_asm_tpu.fem.general_dofs import GeneralDofHandler as JaxDofs
from dealii_asm_tpu.mesh.unstructured import hyper_ball_balanced as jax_ball
from dealii_asm_tpu.models.poisson import run_config as jax_run_config
from dealii_asm_tpu.ops.laplace_general import \
    GeneralLaplaceOperator as JaxOperator
from dealii_asm_tpu.ops.transfer_general import \
    GeneralTwoLevelTransfer as JaxTransfer
from dealii_asm_tpu.parallel.general_sharded import \
    GeneralPartition as JaxPartition
from dealii_asm_tpu.precond.asm_general import \
    GeneralASMPreconditioner as JaxASM
from dealii_asm_tpu_torch.models.poisson import run_config
from dealii_asm_tpu_torch.parallel.dryrun import Ranks
from dealii_asm_tpu_torch.parallel.general_sharded import GeneralPartition
from dealii_asm_tpu_torch.parallel.sharding import Shards

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "experiments", "e2e_ball_q4.json")) as _f:
    BALL = json.load(_f)
# Q2 on a Kershaw mesh of 8^3 cells with the linear-geometry outer
# operator, float32 levels, Chebyshev-2 around the inverse diagonal (the
# sharded FDM smoother needs a Cartesian mesh); the top level sharded
COMPACT = {
    "dim": 3, "degree": 2, "n refinements": 2,
    "mesh": {"name": "kershaw", "eps": 0.3, "n subdivisions": 1,
             "n initial refinements": 1},
    "operator mapping type": "linear geometry",
    "solver": {"type": "CG", "rel tolerance": 1e-6},
    "preconditioner": {
        "type": "Multigrid", "mg type": "h", "replicate below": 1000,
        "mg smoother": {"type": "Chebyshev", "degree": 2,
                        "preconditioner": {"type": "Diagonal"}},
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


def _ball(refinements):
    params = copy.deepcopy(BALL)
    params["n refinements"] = refinements
    params["print timing"] = False
    params["solver"]["best of"] = 1
    return params


def _jax_ball_dofs(degree=2, refinements=1, dim=3):
    mesh = jax_ball(dim)
    for _ in range(refinements):
        mesh = mesh.refine()
    return JaxDofs(mesh, degree)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(21)
    n = lambda *a: _jax_ball_dofs(*a).n_dofs  # noqa: E731
    return {"u": rng.standard_normal(n()),
            "uc_p": rng.standard_normal(n(1, 0)),
            "rf_p": rng.standard_normal(n(2, 0)),
            "uc_h": rng.standard_normal(n(2, 0)),
            "rf_h": rng.standard_normal(n()),
            "u2d": rng.standard_normal(n(2, 1, 2))}


def _start(n_ranks: int) -> Ranks:
    """One spawn of ``n_ranks`` ranks for every check of this file."""
    configs = [dict(_ball(0), **{"n devices": n_ranks})]
    compact = None
    if n_ranks == 2:
        configs.append(dict(_ball(1), **{"n devices": 2}))
        u = np.random.default_rng(5).standard_normal(17 ** 3)
        compact = (dict(COMPACT, **{"n devices": 2}), u)
    return Ranks(n_ranks, _torch_ranks.general_sharded_checks,
                 (_inputs(), configs, compact))


@functools.lru_cache(maxsize=None)
def _run_all():
    """The 2- and 4-rank spawns, with the JAX references computed here
    while the ranks run: ({n: rank results}, JAX applies, JAX ball run)."""
    started = {n: _start(n) for n in (2, 4)}
    try:
        applies, ball0 = _jax_applies(), jax_run_config(_ball(0), log=_quiet)
    finally:
        results = {n: r.join() for n, r in started.items()}
    return results, applies, ball0


def _spawned(n_ranks: int):
    return _run_all()[0][n_ranks]


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def ranks(request):
    return _spawned(request.param)


@pytest.fixture(scope="module")
def jax_applies():
    return _run_all()[1]


def _jax_applies():
    x = _inputs()
    dofs = _jax_ball_dofs()
    u = jnp.asarray(x["u"])
    ref = {"vmult_f64": JaxOperator(dofs, dtype=jnp.float64,
                                    kernel="sumfac").vmult(u),
           "vmult_f32": JaxOperator(dofs, dtype=jnp.float32,
                                    kernel="lanes").vmult(
               u.astype(jnp.float32))}
    for wt in ("symm", "post", "ras"):
        asm = JaxASM(dofs, n_overlap=1, weighting_type=wt, dtype=jnp.float32)
        ref[f"asm_{wt}"] = asm.vmult(u.astype(jnp.float32))
    for kind, coarse, fine in (("p", (1, 0), (2, 0)),
                               ("h", (2, 0), (2, 1))):
        tr = JaxTransfer(_jax_ball_dofs(*coarse), _jax_ball_dofs(*fine),
                         dtype=jnp.float32)
        ref[f"prolongate_{kind}"] = tr.prolongate(
            jnp.asarray(x[f"uc_{kind}"], jnp.float32))
        ref[f"restrict_{kind}"] = tr.restrict(
            jnp.asarray(x[f"rf_{kind}"], jnp.float32))
    d2 = _jax_ball_dofs(2, 1, 2)
    ref["vmult_2d"] = JaxOperator(d2, dtype=jnp.float64,
                                  kernel="sumfac").vmult(jnp.asarray(x["u2d"]))
    return {k: np.asarray(v, np.float64) for k, v in ref.items()}


def _close(got, ref, tol, plus=0.0):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * (np.abs(ref).max() + plus))


@pytest.mark.parametrize("n_dev", [4, 8])
def test_partition_tables_match_jax(n_dev):
    dofs = _torch_ranks.ball_dofs()
    got = GeneralPartition(dofs, n_dev)
    ref = JaxPartition(_jax_ball_dofs(), n_dev)
    for name in ("cell_bounds", "owner", "new_of_old", "old_of_new",
                 "n_own", "offsets", "slot_of_new"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(ref, name), err_msg=name)
    assert (got.B, got.NB, got.Gmax, got.n_loc) == (
        ref.B, ref.NB, ref.Gmax, ref.n_loc)
    for name in ("gather_tab", "fetch_tab", "recv_tab"):
        np.testing.assert_array_equal(getattr(got.cells, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    u = np.random.default_rng(0).standard_normal(dofs.n_dofs)
    np.testing.assert_array_equal(got.pad(torch.as_tensor(u)).numpy(),
                                  np.asarray(ref.pad(jnp.asarray(u))))
    np.testing.assert_array_equal(
        got.unpad(got.pad(torch.as_tensor(u))).numpy(), u)


def _applies(ranks, name):
    """Rank 0's gathered result of an apply; every rank gathers the same
    vector, and each rank's repeat gave the same bits."""
    first = ranks[0]["applies"][name][0]
    for rank in ranks:
        got, same = rank["applies"][name]
        np.testing.assert_array_equal(got, first)
        assert same, f"{name}: a repeated apply differs"
    return first


@pytest.mark.parametrize("n_dev", [4, 12])
def test_local_tables_hold_unheld_slots_constrained(n_dev):
    """Kernel F reads an empty CSR row as a constrained DoF.  On a rank's
    local vector the pad slots of its slab and of its ghost block are held
    by no cell, so its operator's tables mark exactly those constrained,
    and the plain version returns u there, as the kernel does (host only:
    no collective runs at construction)."""
    from dealii_asm_tpu_torch.kernels.lanes_laplace import \
        lanes_laplace_plain
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator
    from dealii_asm_tpu_torch.parallel.general_sharded import \
        ShardedGeneralOperator

    dofs = _torch_ranks.ball_dofs()
    part = GeneralPartition(dofs, n_dev)
    op = GeneralLaplaceOperator(dofs, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(n_dev)
    for r in range(n_dev):
        t = ShardedGeneralOperator(
            op, part, Shards(r, n_dev, torch.device("cpu"))).tables
        held = np.zeros(part.n_loc, bool)
        held[part.cells.local_rows(r).reshape(-1)] = True
        rows = (t.row_ptr[1:] - t.row_ptr[:-1]).numpy() > 0
        np.testing.assert_array_equal(t.free.numpy(), held)
        np.testing.assert_array_equal(rows, held)
        assert (~held).sum() == (part.B - part.n_own[r]
                                 + part.Gmax - np.count_nonzero(
                                     held[part.B:]))
        u = torch.as_tensor(rng.standard_normal(part.n_loc))
        v = lanes_laplace_plain(u, t)
        assert torch.equal(v[~t.free], u[~t.free])


def test_sharded_operator_zero_at_pads(ranks):
    """A slab whose pad slots hold ones: the product is zero there, as the
    JAX scatter-add gives, and the same bits elsewhere."""
    results = [rank["applies"]["pads"] for rank in ranks]
    assert all(zero and same for _, zero, same in results)
    assert sum(n for n, _, _ in results) > 0


def test_operator_matches_jax(ranks, jax_applies):
    _close(_applies(ranks, "vmult_f64"), jax_applies["vmult_f64"], 1e-11)
    _close(_applies(ranks, "vmult_f32"), jax_applies["vmult_f32"], 2e-5)


@pytest.mark.parametrize("wt", ["symm", "post", "ras"])
def test_asm_matches_jax(ranks, jax_applies, wt):
    _close(_applies(ranks, f"asm_{wt}"), jax_applies[f"asm_{wt}"], 3e-5)


@pytest.mark.parametrize("kind", ["p", "h"])
def test_transfer_matches_jax(ranks, jax_applies, kind):
    for what in ("prolongate", "restrict"):
        _close(_applies(ranks, f"{what}_{kind}"),
               jax_applies[f"{what}_{kind}"], 3e-6, plus=1.0)


def test_2d_ball_operator_matches_jax(ranks, jax_applies):
    _close(_applies(ranks, "vmult_2d"), jax_applies["vmult_2d"], 1e-11)


def test_run_config_matches_jax_single_device(ranks):
    ref = _run_all()[2]
    x_ref = np.asarray(ref["solution"])
    assert ref["converged"] and ref["it"] == 5
    for rank in ranks:
        it, converged, x, n_dofs, vcycle_same = rank["runs"][0]
        assert converged and it == 5 and n_dofs == 2273 and vcycle_same
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-6


def test_run_config_intermediate_split_two_ranks():
    single = run_config(_ball(1), log=_quiet, device="cpu")
    x_ref = single["solution"].numpy()
    assert single["converged"] and single["it"] == 6
    for rank in _spawned(2):
        it, converged, x, n_dofs, vcycle_same = rank["runs"][1]
        assert converged and it == 6 and n_dofs == 17217 and vcycle_same
        assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 1e-6


def test_compact_mapping_type_solves_under_n_devices():
    counts = set()
    for rank in _spawned(2):
        it, converged, is_compact, got, ref = rank["compact"]
        assert is_compact and converged
        counts.add(it)
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12
    assert len(counts) == 1


def test_fine_smoother_other_than_fdm_overlap_1_raises():
    params = _ball(0)
    params["preconditioner"]["mg smoother"]["preconditioner"][
        "n overlap"] = 2
    with pytest.raises(ValueError, match="element-centric FDM overlap 1"):
        run_config(params, log=_quiet, device="cpu",
                   shards=Shards(0, 1, torch.device("cpu")))
