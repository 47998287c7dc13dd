"""The port's z-slab sharded operators (dealii_asm_tpu_torch.parallel) on 2
and 4 gloo ranks against the JAX package's ``ShardedLattice`` and
``ShardedTransfer`` at the same device count (tests/conftest.py gives JAX
8 virtual CPU devices), on the problems of tests/test_sharding.py: a
(4, 4, 6)-cell box at degree 3 in float64.

Contract: the same padded layout (z padded to a multiple of the rank
count, the pad planes' entries included), the same halo widths, and the
padded outputs equal to 1e-12 of the vector's largest entry: the Cartesian
and the merged Kershaw ``vmult``, the FDM smoother at overlap 1 (symm) and
2 (post), both transfer forms (Q2 → Q4 with both levels sharded, Q1 → Q4
with the coarse level replicated) and one ``HaloSolverStep`` of the dryrun
problem.  At 4 ranks the FDM output transform's halo (8 planes) exceeds the
5-plane slab, so its exchange takes two hops.  Every Krylov solver over the
ranks' slabs takes the count and the solution of the same solver on one
process's whole padded vector.  One spawn per rank count
runs every check (``tests/_torch_ranks.py``); the NumPy host helpers of
``parallel/halo.py`` are held equal to the JAX ones in
tests/test_torch_host.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks
from dealii_asm_tpu.fem.dofs import DofHandler
from dealii_asm_tpu.mesh.grid import StructuredMesh
from dealii_asm_tpu.mesh.transforms import kershaw_transform
from dealii_asm_tpu.ops.laplace import LaplaceOperator
from dealii_asm_tpu.ops.transfer import TwoLevelTransfer
from dealii_asm_tpu.parallel.halo import ShardedLattice, ShardedTransfer
from dealii_asm_tpu.parallel.sharding import make_mesh, sharded_solver_step
from dealii_asm_tpu.precond.asm import ASMPreconditioner
from dealii_asm_tpu_torch.parallel.dryrun import spawn

CELLS = _torch_ranks.CELLS


def _dofs(degree=3, kershaw=False):
    tf = kershaw_transform(0.3, 0.3) if kershaw else None
    return DofHandler(StructuredMesh(3, CELLS, transform=tf), degree)


def _inputs():
    n3, n2 = _dofs().n_dofs, _dofs(2).n_dofs
    n4, n1 = _dofs(4).n_dofs, _dofs(1).n_dofs
    rng = np.random.default_rng(13)
    return {"u": rng.standard_normal(n3), "r": rng.standard_normal(n3),
            "uc2": rng.standard_normal(n2), "rf4": rng.standard_normal(n4),
            "uc1": rng.standard_normal(n1)}


def _jax_reference(n_dev: int, x: dict) -> dict:
    """The same applies through the JAX package's sharded twins."""
    jm = make_mesh(n_dev)
    f64 = jnp.float64
    out = {}
    dofs = _dofs()
    op = LaplaceOperator(dofs, dtype=f64)
    sl = ShardedLattice(op, None, jm)
    out["vmult_cartesian"] = sl.vmult(sl.pad(x["u"]))
    out["hw_cartesian"] = {"Mz": sl._hw_Mz, "Kz": sl._hw_Kz}
    for ov, wt in ((1, "symm"), (2, "post")):
        asm = ASMPreconditioner(dofs, n_overlap=ov, weighting_type=wt,
                                dtype=f64)
        sl = ShardedLattice(op, asm, jm)
        out[f"fdm_{ov}_{wt}"] = sl.smoother_vmult(sl.pad(x["r"]))
        out[f"hw_fdm_{ov}_{wt}"] = {"Mz": sl._hw_Mz, "Kz": sl._hw_Kz,
                                    "Gz": sl._hw_Gz, "Gzt": sl._hw_Gzt}
    sl = ShardedLattice(LaplaceOperator(_dofs(kershaw=True), dtype=f64),
                        None, jm)
    out["vmult_kershaw"] = sl.vmult(sl.pad(x["u"]))
    out["hw_kershaw"] = {"Evz": sl._hw_Evz, "Edz": sl._hw_Edz,
                         "Evzt": sl._hw_Evzt, "Edzt": sl._hw_Edzt}
    d2, d4, d1 = _dofs(2), _dofs(4), _dofs(1)
    sl2 = ShardedLattice(LaplaceOperator(d2, dtype=f64), None, jm)
    sl4 = ShardedLattice(LaplaceOperator(d4, dtype=f64), None, jm)
    st = ShardedTransfer(TwoLevelTransfer(d2, d4), sl4, coarse_sl=sl2)
    out["prolongate_sharded"] = st.prolongate(sl2.pad(x["uc2"]))
    out["restrict_sharded"] = st.restrict(sl4.pad(x["rf4"]))
    st = ShardedTransfer(TwoLevelTransfer(d1, d4), sl4, coarse_dofs=d1)
    out["prolongate_replicated"] = st.prolongate(jnp.asarray(x["uc1"]))
    out["restrict_replicated"] = st.restrict(sl4.pad(x["rf4"]))
    step, xs, b = sharded_solver_step(mesh=jm, dtype=f64)
    out["halo_step"] = step.step(xs, b)
    out["halo_step_b"] = b
    return {k: v if isinstance(v, dict) else np.asarray(v)
            for k, v in out.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["2 ranks", "4 ranks"])
def both(request):
    x = _inputs()
    got = spawn(request.param, _torch_ranks.lattice_checks,
                (x["u"], x["r"], x["uc2"], x["rf4"], x["uc1"]))
    return got, _jax_reference(request.param, x)


def _close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("key", [
    "vmult_cartesian", "fdm_1_symm", "fdm_2_post", "vmult_kershaw",
    "prolongate_sharded", "restrict_sharded", "prolongate_replicated",
    "restrict_replicated", "halo_step"])
def test_sharded_apply_matches_jax(both, key):
    got, ref = both
    for rank in got:  # every rank gathers the same padded vector
        _close(rank[key], ref[key])


def test_halo_widths_and_pad_planes_match_jax(both):
    got, ref = both
    for key in ("hw_cartesian", "hw_fdm_1_symm", "hw_fdm_2_post",
                "hw_kershaw"):
        assert {k: got[0][key][k] for k in ref[key]} == ref[key]
    # the dryrun box's right-hand side: same slabs, zero pad planes
    _close(got[0]["halo_step_b"], ref["halo_step_b"])
    assert got[0]["halo_step_b"].shape[0] % len(got) == 0


@pytest.mark.parametrize("name", _torch_ranks.SOLVER_NAMES)
def test_sharded_solver_matches_one_device(both, name):
    """Each solver over the ranks' slabs (its inner products summed by
    ``GroupReduction``, IDR's shadow space drawn globally and cut to the
    rank's rows) takes the count of the same solver on one process's whole
    padded vector, its solution equal to 1e-10 of the vector's largest
    entry (the sums run in another order)."""
    got, _ = both
    it_sharded, it_one, x_sharded, x_one = got[0]["solvers"][name]
    assert it_sharded == it_one > 0
    np.testing.assert_allclose(x_sharded, x_one, rtol=0,
                               atol=1e-10 * np.abs(x_one).max())


def test_multi_hop_halo_at_four_ranks(both):
    """20 padded z planes: on 2 ranks the FDM output transform's halo is 4
    planes of a 10-plane slab (one hop), on 4 ranks 8 planes of a 5-plane
    slab (two hops)."""
    got, _ = both
    hw = got[0]["hw_fdm_1_symm"]["Gzt"]
    slab = 20 // len(got)
    assert (hw, -(-hw // slab)) == {2: (4, 1), 4: (8, 2)}[len(got)]
