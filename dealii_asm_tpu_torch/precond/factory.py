"""JSON-driven preconditioner factory (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/factory.py``: Identity, Diagonal,
FDM (element patches of overlap 1..p or vertex-star patches, any weighting,
RAS included; per-coordinate tables on Cartesian meshes, per-patch tables
on deformed and unstructured ones), AMG (the dense direct coarse solve),
CoarseCG (diagonal-preconditioned CG to a reduction), the matrix-based
AdditiveSchwarzPreconditioner, SubMeshPreconditioner and CGPreconditioner
(``precond/block_asm.py``), Relaxation and Chebyshev, with the reference's
defaults.  On CUDA, every Relaxation or
Chebyshev level around an element-patch overlap-1 Cartesian FDM
preconditioner with a multiplicity weighting gets the fused smoother step
(kernel C), and, when
its degree is named in ``DEALII_ASM_TPU_CHAIN_DEGREES`` (none by default, as
in the JAX package), the fused sweep (kernel D); there is no size gate and
no fallback.
"""

from __future__ import annotations

import os

from ..fem.general_dofs import GeneralDofHandler
from ..kernels.banded_laplace import BandedTables
from ..kernels.smoother_step import smoother_step
from ..kernels.smoother_sweep import smoother_sweep
from ..solvers.chebyshev import (ChebyshevPreconditioner,
                                 RelaxationPreconditioner)
from ..utils.config import get_child, get_param
from .asm import ASMPreconditioner, CellASMPreconditioner
from .asm_general import GeneralASMPreconditioner
from .block_asm import create_block_preconditioner
from .diagonal import DiagonalPreconditioner
from .multigrid import DirectCoarseSolver, IterativeCoarseSolver


class IdentityPreconditioner:
    is_symmetric = True

    def vmult(self, x):
        return x

    def __call__(self, x):
        return self.vmult(x)


def _noop_log(msg=""):
    pass


def _chain_win_degrees() -> set:
    """Smoother degrees that take the fused sweep (kernel D): those named in
    ``DEALII_ASM_TPU_CHAIN_DEGREES`` (comma-separated), none by default, as
    in the JAX package (``factory.py:143-151``)."""
    env = os.environ.get("DEALII_ASM_TPU_CHAIN_DEGREES", "")
    return {int(t) for t in env.split(",") if t.strip()}


def _try_attach_fused_step(smoother, op, inner, log=_noop_log):
    """Attach the fused kernels on Cartesian CUDA levels whose inner
    preconditioner is the per-coordinate FDM Schwarz apply of kernel B
    (``factory.py:51-134``, without the TPU's size gate).  A deformed level
    has no banded tables and no kernel B tables, so it keeps the unfused
    smoother, as does an unstructured level, as in the JAX package; so does
    an overlap > 1, RAS or vertex-patch level, whose windows kernels B, C
    and D do not tile, a 2D level and a periodic one (the JAX kernels
    refuse them, ``smoother_step.py:1085-1089``, ``fdm_slab.py:151-154``)."""
    if (op.device.type != "cuda" or not isinstance(inner, ASMPreconditioner)
            or not inner.fused or inner.dim != 3 or any(inner.periodic)
            or not isinstance(op.tables, BandedTables)
            or len(op.tables.grid_shape) != 3):
        return
    attach_fused_kernels(smoother, op, inner, log)


def attach_fused_kernels(smoother, op, inner, log=_noop_log):
    """Kernel C as the smoother's fused step and, for a degree in
    ``_chain_win_degrees()``, kernel D as its fused sweeps.  On CPU tensors
    the wrappers run their plain versions."""
    if inner.dtype != op.dtype:
        raise TypeError(f"operator {op.dtype} and FDM {inner.dtype} differ")
    a, f = op.tables, inner.tables
    smoother.fused_step = lambda x, b, om: smoother_step(x, b, a, f, om)
    log("    - fused step:  cuda\n")
    degree = int(getattr(smoother, "degree", 0)
                 or getattr(smoother, "n_iterations", 0))
    if degree not in _chain_win_degrees():
        return
    coefs = tuple(smoother.sweep_coefficients())
    smoother.fused_sweep = lambda x, b: smoother_sweep(x, b, a, f, coefs)
    smoother.fused_sweep_zero = lambda b: smoother_sweep(None, b, a, f, coefs,
                                                         zero_x=True)
    log(f"    - fused sweep: cuda momentum chain (degree {degree})\n")


def create_system_preconditioner(op, params: dict, log=_noop_log):
    """Return a preconditioner object with .vmult (and .is_symmetric)."""
    ptype = params.get("type", "")
    if ptype == "Identity":
        log("- Create system preconditioner: Identity\n")
        return IdentityPreconditioner()

    if ptype == "Diagonal":
        log("- Create system preconditioner: Diagonal\n")
        p = DiagonalPreconditioner(op)
        p.is_symmetric = True
        return p

    if ptype == "FDM":
        return _create_fdm(op, params, log)

    if ptype == "AMG":
        log("- Create system preconditioner: AMG\n")
        p = DirectCoarseSolver(op.dofs, dtype=op.dtype, device=op.device)
        p.is_symmetric = True
        return p

    if ptype == "CoarseCG":
        p = IterativeCoarseSolver(
            op, reduction=float(get_param(params, "reduction", 1e-4)),
            max_iterations=int(get_param(params, "max iterations", 200)))
        p.is_symmetric = True
        log("- Create system preconditioner: CoarseCG\n")
        return p

    if ptype == "Relaxation":
        inner = create_system_preconditioner(
            op, get_child(params, "preconditioner"), log)
        degree = int(get_param(params, "degree", 3))
        omega = float(get_param(params, "omega", 0.0))
        log(f"- Create system preconditioner: Relaxation\n    - degree: "
            f"{degree}")
        sym = getattr(inner, "is_symmetric", False)
        algo = get_param(params, "ev algorithm",
                         "lanczos" if sym else "power iteration")
        rel = RelaxationPreconditioner(
            op.vmult, inner.vmult, op.n_dofs, n_iterations=degree,
            omega=omega, constrained_mask=op.dofs.boundary_mask,
            ev_algorithm=algo, device=op.device)
        if rel.eigenvalues is not None:
            log(f"    - min ev: {rel.eigenvalues.min_eigenvalue_estimate:g}")
            log(f"    - max ev: {rel.eigenvalues.max_eigenvalue_estimate:g}")
        log(f"    - omega:  {rel.omega:g}\n")
        rel.is_symmetric = sym
        _try_attach_fused_step(rel, op, inner, log)
        return rel

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

    if ptype in ("AdditiveSchwarzPreconditioner", "SubMeshPreconditioner",
                 "CGPreconditioner"):
        return create_block_preconditioner(op, params, log)
    raise ValueError(f"Preconditioner <{ptype}> is not known!")


def _create_fdm(op, params: dict, log):
    # overlap o needs the patch size p − 1 + 2·o within the neighbours' p
    # nodes (``factory.py:261``): a degree-1 level clamps 2 to 1
    n_overlap = min(int(get_param(params, "n overlap", 1)), op.degree)
    weighting = get_param(params, "weighting type", "symm")
    patch_type = ("element" if get_param(params, "element centric", True)
                  else "vertex")
    sub_mesh = int(get_param(params, "sub mesh approximation",
                             op.dofs.mesh.dim))
    # "weight sequence" names the reference's storage of the weights; the
    # weights fold into the FDM transforms here, so every sequence is the
    # same apply (``factory.py:265-275``)
    weight_sequence = get_param(params, "weight sequence",
                                "global" if n_overlap > 1 else "compressed")
    if weight_sequence not in ("global", "compressed", "dg"):
        raise ValueError(f"weight sequence <{weight_sequence}> is not known!")
    log("- Create system preconditioner: FDM")
    log(f"    - n overlap:              {n_overlap}")
    log(f"    - sub mesh approximation: {sub_mesh}")
    log(f"    - weight sequence:        {weight_sequence} (storage strategy; "
        "folded into the FDM transforms here)")
    log(f"    - patch type:             {patch_type}")
    log(f"    - weighting type:         {weighting}\n")
    # dispatch on the DoF handler first (``factory.py:283-291``): the
    # unstructured mesh has no ``transform``
    if isinstance(op.dofs, GeneralDofHandler):
        cls = GeneralASMPreconditioner
    elif op.dofs.mesh.transform is None:
        cls = ASMPreconditioner
    else:
        cls = CellASMPreconditioner
    return cls(op.dofs, n_overlap=n_overlap, weighting_type=weighting,
               dtype=op.dtype, device=op.device, patch_type=patch_type)
