"""Mixed-precision iterative refinement (PyTorch).

Counterpart of ``dealii_asm_tpu/solvers/refinement.py``:

    r₀ = b                 (float64, from x = 0)
    repeat: solve A e = r/‖r‖ on float32 vectors with the level-precision
            operator (multigrid-preconditioned CG or GMRES to
            ``inner_reduction``),
            x ← x + ‖r‖·e and r ← b − A x in float64

until ‖r‖ ≤ max(abs_tolerance, rel_tolerance·‖r₀‖), ``max_outer`` cycles,
or a stall (‖r‖ > ½ of the previous cycle's: the level-precision operator
no longer resolves the correction, κ(A)·relerr(A_level) ≥ 1).

The JAX package keeps this path because float64 is emulated on the TPU, so
moving the Krylov work to float32 pays there.  The H100 has native float64
units and the port's outer float64 matvec is a hand-written kernel, so that
reason does not hold here; the path is ported for parity with the JAX
package's ``"mixed precision solve"`` option, and its counts stand beside
the plain float64 CG's.
"""

from __future__ import annotations

import torch

from .krylov import LOCAL, ReductionControl, SolveResult, cg


def refined_solve(A64, A_level, b, M_level, rel_tolerance=1e-5,
                  abs_tolerance=1e-10, inner_reduction=3e-4, max_outer=6,
                  max_inner=25, inner_solver=cg,
                  log=lambda *_: None) -> SolveResult:
    """Solve A x = b with float64 residuals and float32 inner solves.
    ``A64``: the float64 operator's vmult; ``A_level`` and ``M_level``: the
    level-precision operator's and preconditioner's vmult, applied to the
    inner solve's float32 vectors.  ``n_iterations`` counts the inner
    iterations (the comparable cost); ``outer_cycles`` the refinement
    cycles."""
    b64 = b.to(torch.float64)
    r = b64
    x = torch.zeros_like(b64)
    res = r0 = LOCAL.norm(r)
    target = max(abs_tolerance, rel_tolerance * r0)
    total_inner = outer = 0
    history = [r0]
    while res > target and outer < max_outer:
        scale = res  # the scaled correction stays in the level's range
        inner = inner_solver(A_level, (r / scale).to(torch.float32),
                             M=M_level, control=ReductionControl(
                                 max_inner, 1e-30, inner_reduction))
        total_inner += inner.n_iterations
        x = x + inner.x.to(torch.float64) * scale
        r = b64 - A64(x)
        res = LOCAL.norm(r)
        history.append(res)
        outer += 1
        log(f"   - refinement cycle {outer}: true residual {res:.3e} "
            f"({inner.n_iterations} inner its)")
        if res > 0.5 * history[-2]:
            log("   - refinement stalled (level operator accuracy floor);"
                " aborting")
            break
    result = SolveResult(x, total_inner, res <= target, history)
    result.outer_cycles = outer
    return result
