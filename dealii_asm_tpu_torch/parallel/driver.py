"""The JSON-config solve over several ranks (PyTorch).

Counterpart of ``dealii_asm_tpu/parallel/driver.py``, wired into
``models/poisson.py::run_config`` by ``"n devices"``: level operators and
FDM smoothers become ``ShardedLattice`` slabs (``parallel/halo.py``), the
transfers ``ShardedTransfer``s, and the levels below ``"replicate below"``
DoFs (default 100,000) and at or below the intermediate split are held
whole on every rank and built by the single-device factory: the
reference's coarse sub-communicator.  The junction is a replicated-coarse
``ShardedTransfer``.

The rules are the JAX package's: padded z planes are identity rows with a
zero right-hand side, the FDM smoother needs the global-FDM form
(Cartesian, element patches, not RAS), the Diagonal inverse is padded,
and the eigenvalue estimate starts from the padded single-device i%11
vector.  The port keeps that vector in float64 (the JAX ``pad`` casts it to
the level dtype, which sends its estimate through the float32 branch), so
its estimates equal the single-device ones up to the order of the
``all_reduce`` sums.

Each rank builds the global host tables; the sharded levels' operators
are host objects (on the CPU), of which the rank keeps its slabs on its
device, beside the replicated tail.
"""

from __future__ import annotations

import torch

from ..precond.asm import ASMPreconditioner
from ..precond.diagonal import DiagonalPreconditioner
from ..precond.factory import create_system_preconditioner
from ..precond.multigrid import Multigrid
from ..solvers.chebyshev import (ChebyshevPreconditioner,
                                 RelaxationPreconditioner, eig_initial_guess)
from ..utils.config import get_child, get_param
from .halo import ShardedLattice, ShardedTransfer
from .sharding import GroupReduction, Shards

HOST = "cpu"


def _noop_log(msg=""):
    pass


def _padded_b0(sl: ShardedLattice) -> torch.Tensor:
    """The single-device eigenvalue start vector (i%11 over n_dofs, mean
    removed, constrained rows 0), this rank's slab of it, float64."""
    v = eig_initial_guess(sl.n_dofs, sl.op.dofs.boundary_mask, device=HOST)
    return sl.pad(v, torch.float64)


def _sharded_smoother(sl: ShardedLattice, params: dict, reduction,
                      log=_noop_log):
    """The sharded twin of the factory's Chebyshev or Relaxation around
    FDM or Diagonal (``driver.py:61-121``)."""
    ptype = params.get("type", "")
    inner_p = get_child(params, "preconditioner")
    itype = inner_p.get("type", "FDM" if ptype in ("Chebyshev", "Relaxation")
                        else "")
    if itype == "FDM":
        if sl.asm is None:
            raise ValueError("sharded FDM smoother needs the ASM attached")
        M = sl.smoother_vmult
        inner_sym = sl.asm.weighting_type in ("none", "symm")
    elif itype == "Diagonal":
        dinv = sl.pad(DiagonalPreconditioner(sl.op).inv_diag)
        M = lambda r: r * dinv  # noqa: E731
        inner_sym = True
    else:
        raise ValueError(
            f"sharded smoother: inner <{itype}> not supported (FDM/Diagonal)")
    sym = getattr(sl.op, "is_symmetric", True) and inner_sym
    algo = get_param(params, "ev algorithm",
                     "lanczos" if sym else "power iteration")
    common = dict(ev_algorithm=algo, eig_b0=_padded_b0(sl),
                  reduction=reduction, device=sl.device)
    if ptype == "Chebyshev":
        sm = ChebyshevPreconditioner(
            sl.vmult, M, sl.n_local,
            degree=int(get_param(params, "degree", 3)),
            smoothing_range=float(get_param(params, "smoothing range", 20.0)),
            polynomial_type=get_param(params, "polynomial type", "1st kind"),
            **common)
    elif ptype == "Relaxation":
        sm = RelaxationPreconditioner(
            sl.vmult, M, sl.n_local,
            n_iterations=int(get_param(params, "degree", 3)),
            omega=float(get_param(params, "omega", 0.0)), **common)
    else:
        raise ValueError(f"sharded smoother type <{ptype}> not supported "
                         "(Chebyshev/Relaxation)")
    ev = sm.eigenvalues
    log(f"- Create level smoother (sharded): {ptype}")
    if ev is not None:
        log(f"    - min ev: {ev.min_eigenvalue_estimate:g}")
        log(f"    - max ev: {ev.max_eigenvalue_estimate:g}\n")
    sm.is_symmetric = sym
    return sm


def _needs_asm(smoother_p: dict) -> bool:
    return get_child(smoother_p, "preconditioner").get("type", "FDM") == "FDM"


def _level_asm(dofs, smoother_p: dict, dtype) -> ASMPreconditioner:
    """The level's FDM Schwarz tables on the host (``driver.py:128-142``);
    the sharded smoother needs the global-FDM form."""
    inner_p = get_child(smoother_p, "preconditioner")
    weighting = get_param(inner_p, "weighting type", "symm")
    patch = ("element" if get_param(inner_p, "element centric", True)
             else "vertex")
    if dofs.mesh.transform is not None or weighting == "ras" \
            or patch == "vertex":
        raise ValueError(
            "sharded FDM smoother needs the separable global-FDM path "
            "(Cartesian/anisotropic lattice, element patches, non-RAS "
            "weighting)")
    return ASMPreconditioner(
        dofs, n_overlap=min(int(get_param(inner_p, "n overlap", 1)),
                            dofs.degree),
        weighting_type=weighting, patch_type=patch, dtype=dtype, device=HOST)


class ShardedMGSolve:
    """The sharded outer solve's handles: the outer-dtype fine lattice
    (``vmult``, ``pad``, ``unpad``), the level-dtype multigrid ``mg`` and the
    group's ``reduction``."""

    def __init__(self, mg, fine_sl_outer, reduction):
        self.mg = mg
        self.fine_sl = fine_sl_outer
        self.reduction = reduction

    def pad(self, v):
        return self.fine_sl.pad(v)

    def unpad(self, v):
        return self.fine_sl.unpad(v)

    @property
    def vmult(self):
        return self.fine_sl.vmult


def build_sharded_multigrid(precon_p: dict, family, fe_degree: int, log,
                            dtype, outer_op, shards: Shards) -> ShardedMGSolve:
    """The sharded twin of ``models/poisson.py::_build_multigrid``
    (``driver.py:172-263``).  Levels with fewer than "replicate below"
    DoFs, and everything at or below the intermediate split, are built
    whole by the standard factory on the rank's device; the rest become
    ``ShardedLattice`` levels.  ``outer_op`` is the finest level's host
    operator in the outer dtype (the one ``run_config`` assembles b with);
    the outer Krylov loop runs over its lattice, or, for a compact mapping
    type, over the lattice of the family's merged float64 operator."""
    from ..models.poisson import mg_level_layout

    device = shards.device
    levels, intermediate = mg_level_layout(precon_p, family, fe_degree, log)
    replicate_below = int(get_param(precon_p, "replicate below", 100_000))
    dofs_list = [family.dofs_at(r, d) for r, d in levels]

    # the junction: the first sharded level; at least one replicated level
    # (the coarse solver), and the intermediate split stays replicated
    k = len(levels) - 1
    while k > 1 and dofs_list[k - 1].n_dofs >= replicate_below:
        k -= 1
    k = max(k, intermediate + 1, 1)
    if k >= len(levels):
        raise ValueError("no sharded level: raise 'n devices' problem size "
                         "or lower 'replicate below'")
    ops = []
    for l, dofs in enumerate(dofs_list):
        ops.append(family.operator(dofs, dtype, device if l < k else HOST))
        log(f"- Create operator:\n  - n cells:          "
            f"{dofs.mesh.n_cells_total}\n"
            f"  - n dofs:           {dofs.n_dofs}\n")
    log(f" - sharded levels: {k}..{len(levels) - 1} over {shards.world} "
        f"devices (replicated below {replicate_below} DoFs)\n")

    smoother_p = get_child(precon_p, "mg smoother")
    interm_p = get_child(precon_p, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    coarse_p = get_child(precon_p, "mg coarse grid solver")
    one_sided = get_param(precon_p, "one-sided v-cycle", False)
    n_coarse_cycles = int(get_param(precon_p, "n coarse cycles", 1))
    transfers = [family.transfer(dofs_list[i], dofs_list[i + 1], dtype,
                                 device if i + 1 < k else HOST)
                 for i in range(len(levels) - 1)]

    # ---- replicated tail (levels 0..k-1): the standard factory ------------
    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(ops[0], coarse_p, log)
    if k == 1:
        replicated_fn = coarse.vmult
    else:
        rep_smoothers = []
        for l in range(1, k):
            log(f"- Setting up smoother on level {l}\n")
            rep_smoothers.append(create_system_preconditioner(
                ops[l], interm_p if l <= intermediate else smoother_p, log))
        replicated_fn = Multigrid(ops[:k], rep_smoothers, transfers[: k - 1],
                                  coarse.vmult, one_sided=one_sided,
                                  n_coarse_cycles=n_coarse_cycles).vmult

    # ---- sharded levels k..L-1 ---------------------------------------------
    reduction = GroupReduction(shards)
    sls, sh_smoothers = [], []
    for l in range(k, len(levels)):
        asm = (_level_asm(dofs_list[l], smoother_p, dtype)
               if _needs_asm(smoother_p) else None)
        sl = ShardedLattice(ops[l], asm, shards, dtype)
        sls.append(sl)
        log(f"- Setting up smoother on level {l} (sharded)\n")
        sh_smoothers.append(_sharded_smoother(sl, smoother_p, reduction, log))
    sh_transfers = [ShardedTransfer(transfers[k - 1], sls[0],
                                    coarse_dofs=dofs_list[k - 1])]
    for i in range(1, len(sls)):
        sh_transfers.append(ShardedTransfer(transfers[k - 1 + i], sls[i],
                                            coarse_sl=sls[i - 1]))
    # level 0 of the outer V-cycle is the replicated junction level; its
    # operator serves only "n coarse cycles" > 1
    mg = Multigrid([ops[k - 1]] + [sl.vmult for sl in sls], sh_smoothers,
                   sh_transfers, replicated_fn, one_sided=one_sided,
                   n_coarse_cycles=n_coarse_cycles)
    # the float64 outer operator: a second lattice of the same padded layout.
    # The lattice takes the merged form: for a compact mapping type the
    # outer lattice is the family's merged float64 operator, as in the JAX
    # package (``driver.py:258-262``), and b still comes from the compact one
    if outer_op.dtype == dtype:
        fine_outer = sls[-1]
    else:
        if getattr(outer_op, "compact", None):
            log(" - sharded outer operator: the merged float64 form (the "
                "compact mapping type assembles b only)")
            outer_op = family.operator(dofs_list[-1], outer_op.dtype, HOST)
        fine_outer = ShardedLattice(outer_op, None, shards)
    return ShardedMGSolve(mg, fine_outer, reduction)
