"""JSON-driven preconditioner factory (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/factory.py``: Identity, FDM
(element-centric overlap 1), AMG (the dense direct coarse solve) and
Chebyshev, with the reference's defaults.  On CUDA, every Chebyshev level
around an FDM preconditioner gets the fused smoother step (kernel C); there
is no size gate and no fallback.  Other types raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

from ..kernels.smoother_step import smoother_step
from ..solvers.chebyshev import ChebyshevPreconditioner
from ..utils.config import get_child, get_param
from .asm import ASMPreconditioner
from .multigrid import DirectCoarseSolver


class IdentityPreconditioner:
    is_symmetric = True

    def vmult(self, x):
        return x

    def __call__(self, x):
        return self.vmult(x)


def _noop_log(msg=""):
    pass


def _try_attach_fused_step(smoother, op, inner, log=_noop_log):
    """Attach kernel C as the smoother's fused step on CUDA levels whose
    inner preconditioner is the FDM Schwarz apply (``factory.py:51-90``
    without the chain kernel and without the TPU's size gate)."""
    if op.device.type != "cuda" or not isinstance(inner, ASMPreconditioner):
        return
    if inner.dtype != op.dtype:
        raise TypeError(f"operator {op.dtype} and FDM {inner.dtype} differ")
    a, f = op.tables, inner.tables
    smoother.fused_step = lambda x, b, om: smoother_step(x, b, a, f, om)
    log("    - fused step:  cuda\n")


def create_system_preconditioner(op, params: dict, log=_noop_log):
    """Return a preconditioner object with .vmult (and .is_symmetric)."""
    ptype = params.get("type", "")
    if ptype == "Identity":
        log("- Create system preconditioner: Identity\n")
        return IdentityPreconditioner()

    if ptype == "FDM":
        return _create_fdm(op, params, log)

    if ptype == "AMG":
        log("- Create system preconditioner: AMG\n")
        p = DirectCoarseSolver(op.dofs, dtype=op.dtype, device=op.device)
        p.is_symmetric = True
        return p

    if ptype == "Chebyshev":
        inner = create_system_preconditioner(
            op, get_child(params, "preconditioner"), log)
        degree = int(get_param(params, "degree", 3))
        sym = getattr(inner, "is_symmetric", False)
        algo = get_param(params, "ev algorithm",
                         "lanczos" if sym else "power iteration")
        cheb = ChebyshevPreconditioner(
            op.vmult, inner.vmult, op.n_dofs, degree=degree,
            smoothing_range=float(get_param(params, "smoothing range", 20.0)),
            polynomial_type=get_param(params, "polynomial type", "1st kind"),
            constrained_mask=op.dofs.boundary_mask, ev_algorithm=algo,
            device=op.device)
        ev = cheb.eigenvalues
        log("- Create system preconditioner: Chebyshev")
        log(f"    - degree: {degree}")
        log(f"    - min ev: {ev.min_eigenvalue_estimate:g}")
        log(f"    - max ev: {ev.max_eigenvalue_estimate:g}")
        log(f"    - omega:  "
            f"{2.0 / (ev.min_eigenvalue_estimate + ev.max_eigenvalue_estimate):g}\n")
        cheb.is_symmetric = sym
        _try_attach_fused_step(cheb, op, inner, log)
        return cheb

    if ptype in ("Diagonal", "Relaxation"):
        raise NotImplementedError(
            f"preconditioner {ptype!r} is not ported yet (ROADMAP item 11)"
            if ptype == "Diagonal" else
            "preconditioner 'Relaxation' is not ported yet (ROADMAP item 9)")
    if ptype == "CoarseCG":
        raise NotImplementedError(
            "preconditioner 'CoarseCG' is not ported yet (ROADMAP item 6)")
    if ptype in ("AdditiveSchwarzPreconditioner", "SubMeshPreconditioner",
                 "CGPreconditioner"):
        raise NotImplementedError(
            f"preconditioner {ptype!r} is not ported yet (ROADMAP item 11)")
    raise ValueError(f"Preconditioner <{ptype}> is not known!")


def _create_fdm(op, params: dict, log):
    n_overlap = min(int(get_param(params, "n overlap", 1)), op.degree)
    weighting = get_param(params, "weighting type", "symm")
    if not get_param(params, "element centric", True):
        raise NotImplementedError(
            "vertex patches are not ported yet (ROADMAP item 10)")
    log("- Create system preconditioner: FDM")
    log(f"    - n overlap:              {n_overlap}")
    log(f"    - weighting type:         {weighting}\n")
    return ASMPreconditioner(op.dofs, n_overlap=n_overlap,
                             weighting_type=weighting, dtype=op.dtype,
                             device=op.device)
