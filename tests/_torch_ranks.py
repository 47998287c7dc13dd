"""Rank functions of the port's sharded-path tests.

``dealii_asm_tpu_torch.parallel.dryrun.spawn`` runs each of them on every
rank of a gloo group of CPU processes; they import torch and the port only
(the spawned interpreters never load JAX) and return NumPy results, the
padded vectors gathered from the ranks' slabs.  The problems are those of
``tests/test_sharding.py``: a (4, 4, 6)-cell box at degree 3 in float64,
Cartesian or Kershaw-deformed (eps 0.3).
"""

import torch

from dealii_asm_tpu_torch.fem.dofs import DofHandler
from dealii_asm_tpu_torch.mesh.grid import StructuredMesh
from dealii_asm_tpu_torch.mesh.transforms import kershaw_transform
from dealii_asm_tpu_torch.ops.laplace import LaplaceOperator
from dealii_asm_tpu_torch.ops.transfer import TwoLevelTransfer
from dealii_asm_tpu_torch.parallel.halo import ShardedLattice, ShardedTransfer
from dealii_asm_tpu_torch.parallel.sharding import sharded_solver_step
from dealii_asm_tpu_torch.precond.asm import ASMPreconditioner

CELLS = (4, 4, 6)
F64 = torch.float64


def dofs_of(degree=3, kershaw=False):
    tf = kershaw_transform(0.3, 0.3) if kershaw else None
    return DofHandler(StructuredMesh(3, CELLS, transform=tf), degree)


def _op(dofs):
    return LaplaceOperator(dofs, dtype=F64, device="cpu")


def _padded(sl_or_shards, y):
    shards = getattr(sl_or_shards, "shards", sl_or_shards)
    return shards.all_gather(y).numpy()


def _t(a):
    return torch.as_tensor(a)


def lattice_checks(shards, u, r, uc2, rf4, uc1):
    """The sharded applies of tests/test_sharding.py on these ranks: the
    padded outputs and the halo widths."""
    out = {}
    dofs = dofs_of()
    op = _op(dofs)
    sl = ShardedLattice(op, None, shards)
    out["vmult_cartesian"] = _padded(sl, sl.vmult(sl.pad(_t(u))))
    out["hw_cartesian"] = dict(sl.hw)
    for ov, wt in ((1, "symm"), (2, "post")):
        asm = ASMPreconditioner(dofs, n_overlap=ov, weighting_type=wt,
                                dtype=F64, device="cpu")
        sl = ShardedLattice(op, asm, shards)
        out[f"fdm_{ov}_{wt}"] = _padded(sl, sl.smoother_vmult(sl.pad(_t(r))))
        out[f"hw_fdm_{ov}_{wt}"] = dict(sl.hw)
    kdofs = dofs_of(kershaw=True)
    sl = ShardedLattice(_op(kdofs), None, shards)
    out["vmult_kershaw"] = _padded(sl, sl.vmult(sl.pad(_t(u))))
    out["hw_kershaw"] = dict(sl.hw)
    # p-transfers Q2 → Q4 (both sharded) and Q1 → Q4 (replicated coarse)
    d2, d4, d1 = dofs_of(2), dofs_of(4), dofs_of(1)
    sl2 = ShardedLattice(_op(d2), None, shards)
    sl4 = ShardedLattice(_op(d4), None, shards)
    st = ShardedTransfer(TwoLevelTransfer(d2, d4, dtype=F64, device="cpu"),
                         sl4, coarse_sl=sl2)
    out["prolongate_sharded"] = _padded(sl4, st.prolongate(sl2.pad(_t(uc2))))
    out["restrict_sharded"] = _padded(sl2, st.restrict(sl4.pad(_t(rf4))))
    st = ShardedTransfer(TwoLevelTransfer(d1, d4, dtype=F64, device="cpu"),
                         sl4, coarse_dofs=d1)
    out["prolongate_replicated"] = _padded(sl4, st.prolongate(_t(uc1)))
    out["restrict_replicated"] = st.restrict(sl4.pad(_t(rf4))).numpy()
    # the dryrun's one solver step, in float64
    step, x, b = sharded_solver_step(shards, dtype=F64)
    out["halo_step"] = _padded(shards, step.step(x, b))
    out["halo_step_b"] = _padded(shards, b)
    out["solvers"] = solver_checks(shards, u)
    return out


SOLVER_NAMES = ("CG", "FCG", "GMRES", "FGMRES", "Bicgstab", "IDR",
                "Richardson")


def solver_checks(shards, b_full):
    """Each Krylov solver on the padded Cartesian system with the FDM
    (symm) preconditioner, over the ranks' slabs with ``GroupReduction``
    and on one rank's whole padded vector with the default reduction
    (identity pad rows there too): name → (sharded count, one-device
    count, sharded solution, one-device solution), padded."""
    from dealii_asm_tpu_torch.parallel.sharding import GroupReduction
    from dealii_asm_tpu_torch.solvers.krylov import solve

    dofs = dofs_of()
    op = _op(dofs)
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=F64, device="cpu")
    sl = ShardedLattice(op, asm, shards)
    n, free = dofs.n_dofs, torch.as_tensor(~dofs.boundary_mask)
    b = _t(b_full) * free

    def whole_A(v):
        return torch.cat([op.vmult(v[:n]), v[n:]])

    def whole_M(v):
        return torch.cat([asm.vmult(v[:n]), torch.zeros_like(v[n:])])

    b_whole = torch.cat([b, b.new_zeros(sl.n_padded - n)])
    res = {}
    for name in SOLVER_NAMES:
        kw = dict(max_iterations=40, rel_tolerance=1e-8, abs_tolerance=0.0)
        rs = solve(name, sl.vmult, sl.pad(b), M=sl.smoother_vmult,
                   reduction=GroupReduction(shards), **kw)
        r1 = solve(name, whole_A, b_whole, M=whole_M, **kw)
        res[name] = (rs.n_iterations, r1.n_iterations,
                     _padded(shards, rs.x), r1.x.numpy())
    return res


def run_configs(shards, configs, bench=None):
    """run_config of each config on these ranks: (it, converged, solution,
    n_dofs) each; with ``bench`` also ``benchmark_lines(shards, bench)``
    after them (one spawn for both)."""
    from dealii_asm_tpu_torch.models.poisson import run_config

    res = []
    for params in configs:
        r = run_config(params, log=lambda *_: None, device="cpu")
        res.append((r["it"], r["converged"], r["solution"].numpy(),
                    r["n_dofs"]))
    return res if bench is None else (res, benchmark_lines(shards, bench))


def benchmark_lines(shards, params):
    """The ``>>`` lines of the sharded benchmark driver and each label's
    first apply on the source vector (gathered)."""
    import io

    from dealii_asm_tpu_torch.models.benchmark import run_benchmark

    out, applied = io.StringIO(), []
    run_benchmark(params, out=out, device="cpu",
                  on_label=lambda rec, fn, src0: applied.append(
                      _padded(shards, fn(src0))))
    return out.getvalue(), applied


# -- the sharded unstructured ball (parallel/general_sharded.py) -------------

F32 = torch.float32


def ball_dofs(degree=2, refinements=1, dim=3):
    """The balanced hyperball refined ``refinements`` times at ``degree``
    (tests/test_general_sharded.py's mesh: 3D, once refined, Q2)."""
    from dealii_asm_tpu_torch.fem.general_dofs import GeneralDofHandler
    from dealii_asm_tpu_torch.mesh.unstructured import hyper_ball_balanced

    mesh = hyper_ball_balanced(dim)
    for _ in range(refinements):
        mesh = mesh.refine()
    return GeneralDofHandler(mesh, degree)


def _general_applies(shards, x):
    """The sharded operator (float64, float32), ASM (symm, post, ras), the
    p- and h-transfers and the 2D operator, each applied twice: name →
    (gathered result in the problem's numbering, repeat bit-identical)."""
    from dealii_asm_tpu_torch.ops.laplace_general import \
        GeneralLaplaceOperator
    from dealii_asm_tpu_torch.ops.transfer_general import \
        GeneralTwoLevelTransfer
    from dealii_asm_tpu_torch.parallel.general_sharded import (
        GeneralPartition, ShardedGeneralASM, ShardedGeneralOperator,
        ShardedGeneralTransfer)
    from dealii_asm_tpu_torch.precond.asm_general import \
        GeneralASMPreconditioner

    def twice(obj, apply, v, out_pad=True):
        y, again = apply(v), apply(v)
        return ((obj.unpad(y) if out_pad else y).double().numpy(),
                torch.equal(y, again))

    out = {}
    dofs = ball_dofs()
    part = GeneralPartition(dofs, shards.world)
    op64 = GeneralLaplaceOperator(dofs, dtype=F64, device="cpu")
    for name, dt in (("f64", F64), ("f32", F32)):
        sop = ShardedGeneralOperator(op64, part, shards, dt)
        out[f"vmult_{name}"] = twice(sop, sop.vmult, sop.pad(_t(x["u"])))
    # the slab's pad slots (past the rank's owned count) filled with ones:
    # the product is zero there and unchanged elsewhere
    slab = sop.pad(_t(x["u"]))
    pads = torch.arange(part.B) >= int(part.n_own[shards.rank])
    y, y1 = sop.vmult(slab), sop.vmult(torch.where(pads, 1.0, slab))
    out["pads"] = (int(pads.sum()), bool((y1[pads] == 0).all()),
                   torch.equal(y1[~pads], y[~pads]))
    for wt in ("symm", "post", "ras"):
        asm = GeneralASMPreconditioner(dofs, n_overlap=1, weighting_type=wt,
                                       dtype=F32, device="cpu")
        sasm = ShardedGeneralASM(asm, part, shards)
        out[f"asm_{wt}"] = twice(sasm, sasm.vmult, sasm.pad(_t(x["u"])))
    # p: Q1 → Q2 on the unrefined ball; h: the ball → its refinement, Q2
    for kind, coarse, fine in (("p", ball_dofs(1, 0), ball_dofs(2, 0)),
                               ("h", ball_dofs(2, 0), dofs)):
        tr = GeneralTwoLevelTransfer(coarse, fine, dtype=F32, device="cpu")
        st = ShardedGeneralTransfer(tr, GeneralPartition(fine, shards.world),
                                    shards)
        out[f"prolongate_{kind}"] = twice(st, st.prolongate,
                                          _t(x[f"uc_{kind}"]).float())
        out[f"restrict_{kind}"] = twice(st, st.restrict,
                                        st.pad(_t(x[f"rf_{kind}"])), False)
    d2 = ball_dofs(2, 1, dim=2)
    op2 = GeneralLaplaceOperator(d2, dtype=F64, device="cpu")
    s2 = ShardedGeneralOperator(op2, GeneralPartition(d2, shards.world),
                                shards)
    out["vmult_2d"] = twice(s2, s2.vmult, s2.pad(_t(x["u2d"])))
    return out


def _ball_runs(shards, configs):
    """run_config of each config: (it, converged, solution, n_dofs, two
    V-cycle applies bit-identical)."""
    from dealii_asm_tpu_torch.models.poisson import run_config

    res = []
    for params in configs:
        r = run_config(params, log=lambda *_: None, device="cpu")
        pre = r["preconditioner"]
        top = pre.inner.operators[-1].__self__  # the sharded fine level
        b = torch.sin(torch.arange(top.n_local, dtype=F64)
                      + 7.0 * shards.rank)
        res.append((r["it"], r["converged"], r["solution"].numpy(),
                    r["n_dofs"], torch.equal(pre.vmult(b), pre.vmult(b))))
    return res


def _compact_outer(shards, params, u):
    """run_config of a compact "operator mapping type" config with float32
    levels (it, converged), and the sharded outer operator that
    ``build_sharded_multigrid`` builds for it applied to ``u`` beside the
    single-device merged float64 operator's product."""
    from dealii_asm_tpu_torch.models.poisson import (make_mesh_family,
                                                     run_config)
    from dealii_asm_tpu_torch.parallel.driver import build_sharded_multigrid

    r = run_config(params, log=lambda *_: None, device="cpu")
    family = make_mesh_family(params)
    dofs = family.dofs_at(family.n_refinements, params["degree"])
    compact = family.operator(dofs, F64, "cpu",
                              params["operator mapping type"])
    sh = build_sharded_multigrid(params["preconditioner"], family,
                                 params["degree"], lambda *_: None, F32,
                                 compact, shards)
    merged = family.operator(dofs, F64, "cpu")
    got = sh.unpad(sh.vmult(sh.pad(_t(u)))).numpy()
    return (r["it"], r["converged"], bool(compact.compact), got,
            merged.vmult(_t(u)).numpy())


def general_sharded_checks(shards, x, configs, compact=None):
    """One spawn's checks of the sharded ball: the applies, the run_config
    solves of ``configs`` and, given ``compact`` = (params, u), the compact
    mapping type's structured solve and outer operator."""
    out = {"applies": _general_applies(shards, x),
           "runs": _ball_runs(shards, configs)}
    if compact is not None:
        out["compact"] = _compact_outer(shards, *compact)
    return out
