"""Smoother-composition and access-route timing studies (PyTorch).

Counterpart of ``dealii_asm_tpu/models/variant_bench.py``, the reference's
variant benchmarks:
- ``matrix_free_loop_02.cc``, the composition sweep (``run_composition_
  bench``, :47-108): {FDM, diagonal} local solver × {Chebyshev-2,
  relaxation ω = 1.0, ω = 1.1} × {vmult, step}.  The JAX package asks "one
  jitted program vs per-op dispatch"; on the card that is a chain of n_rep
  calls captured as one CUDA graph against the same chain dispatched
  eagerly.  The ``>>`` line carries the graph time on CUDA (the eager time
  on the CPU, which has no graphs), a ``#`` line after it the eager time.
- ``matrix_free_loop_03.cc``, the access sweep (``run_access_bench``,
  :111-171): one smoothing step x + P⁻¹(b − A x) through each route the
  port has for it on a Cartesian mesh: ``global`` (the plain global FDM
  around the operator), ``lanes`` (the per-cell FDM of deformed meshes,
  ``CellASMPreconditioner``, forced onto the Cartesian mesh) and ``cuda``
  (kernel C's fused step; the JAX label ``pallas``).  The JAX ``gather``
  route (an index-table gather FDM on structured meshes) has no
  counterpart in the port, whose structured FDM applies are the global
  and the per-cell forms only, so it is left out.  On the CPU the ``cuda``
  label runs kernel C's plain version.

Output: ``>> label n_dofs n_rep time bytes degree 0 0`` lines
(``matrix_free_loop_08.likwid.cc:390-395``); DoF/s = n_dofs·n_rep/time.

    python -m dealii_asm_tpu_torch.models.variant_bench {access|composition} [cfg.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device, synchronize
from ..fem.dofs import DofHandler
from ..kernels.fdm_patch import fdm_patch_plain
from ..kernels.smoother_step import smoother_step
from ..mesh.grid import StructuredMesh
from ..ops.laplace import LaplaceOperator
from ..precond.asm import ASMPreconditioner, CellASMPreconditioner
from ..precond.diagonal import DiagonalPreconditioner
from ..solvers.chebyshev import (ChebyshevPreconditioner, EigenvalueInfo,
                                 RelaxationPreconditioner)
from .power_kernel import captured

DTYPE = torch.float32


def _problem(params: dict, device):
    """The Dirichlet box of ``n subdivisions``^dim cells at ``degree``,
    its float32 operator and x, b from ``default_rng(0)``."""
    dim = int(params.get("dim", 3))
    degree = int(params.get("degree", 4))
    s = int(params.get("n subdivisions", 16))
    dofs = DofHandler(StructuredMesh(dim, (s,) * dim), degree)
    op = LaplaceOperator(dofs, dtype=DTYPE, device=device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.standard_normal(dofs.n_dofs)).to(device, DTYPE)
    b = torch.as_tensor(rng.standard_normal(dofs.n_dofs)).to(device, DTYPE)
    return dofs, op, x, b


def time_chain(fn, x: torch.Tensor, n_rep: int, graph: bool) -> float:
    """Best of two timed chains y ← fn(y), n_rep calls from x (after one
    warm-up chain), as one CUDA-graph replay when ``graph``."""
    def chain(y):
        for _ in range(n_rep):
            y = fn(y)
        return y
    run = captured(chain, x) if graph else chain
    y = run(x)
    synchronize(x.device)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        y = run(y)
        synchronize(x.device)
        best = min(best, time.perf_counter() - t0)
    return best


def _emit(out, label, n_dofs, n_rep, degree, fn, x, graphs: bool,
          on_label=None) -> None:
    dt = time_chain(fn, x, n_rep, graph=graphs)
    print(f">> {label} {n_dofs} {n_rep} {dt:.6g} 4 {degree} 0 0", file=out,
          flush=True)
    if graphs:
        eager = time_chain(fn, x, n_rep, graph=False)
        print(f"# {label} eager {eager:.6g}", file=out, flush=True)
    if on_label is not None:
        on_label(label, fn, x)


def run_composition_bench(params: dict, out=None, device=DEFAULT_DEVICE,
                          on_label=None) -> int:
    """The composition sweep; returns the DoF count."""
    device = resolve_device(device)
    out = sys.stdout if out is None else out
    n_rep = int(params.get("n repetitions", 10))
    dofs, op, x, b = _problem(params, device)
    inners = {"fdm": ASMPreconditioner(dofs, n_overlap=1,
                                       weighting_type="symm", dtype=DTYPE,
                                       device=device),
              "diag": DiagonalPreconditioner(op)}
    ev = EigenvalueInfo(1.2, 2.2, 0)
    graphs = device.type == "cuda"
    for iname, inner in inners.items():
        wrappers = {
            "cheby-2": ChebyshevPreconditioner(
                op.vmult, inner.vmult, dofs.n_dofs, degree=2, eigenvalues=ev,
                device=device),
            "relax-1.0": RelaxationPreconditioner(
                op.vmult, inner.vmult, dofs.n_dofs, n_iterations=2,
                omega=1.0, device=device),
            "relax-1.1": RelaxationPreconditioner(
                op.vmult, inner.vmult, dofs.n_dofs, n_iterations=2,
                omega=1.1, device=device)}
        for wname, w in wrappers.items():
            for mode in ("vmult", "step"):
                fn = (w.vmult if mode == "vmult"
                      else (lambda y, w=w: w.step(y, b)))
                _emit(out, f"{iname}-{wname}-{mode}", dofs.n_dofs, n_rep,
                      dofs.degree, fn, x, graphs, on_label)
    return dofs.n_dofs


def access_routes(dofs, op, b, n_overlap: int = 1) -> dict:
    """label → one smoothing step y ↦ y + P⁻¹(b − A y) through each of the
    port's FDM routes (``cuda`` only where kernel C tiles the mesh)."""
    device = op.device
    asm = ASMPreconditioner(dofs, n_overlap=n_overlap, weighting_type="symm",
                            dtype=DTYPE, device=device)
    lanes = CellASMPreconditioner(dofs, n_overlap=n_overlap,
                                  weighting_type="symm", dtype=DTYPE,
                                  device=device)
    routes = {
        "global": lambda y: y + fdm_patch_plain(b - op.vmult(y), asm.tables),
        "lanes": lambda y: y + lanes.vmult(b - op.vmult(y))}
    if asm.fused:
        routes["cuda"] = lambda y: smoother_step(y, b, op.tables, asm.tables,
                                                 1.0)
    return routes


def run_access_bench(params: dict, out=None, device=DEFAULT_DEVICE,
                     on_label=None) -> int:
    """The access sweep; returns the DoF count."""
    device = resolve_device(device)
    out = sys.stdout if out is None else out
    n_rep = int(params.get("n repetitions", 10))
    dofs, op, x, b = _problem(params, device)
    routes = access_routes(dofs, op, b, int(params.get("n overlap", 1)))
    for label, fn in routes.items():
        _emit(out, label, dofs.n_dofs, n_rep, dofs.degree, fn, x,
              device.type == "cuda", on_label)
    return dofs.n_dofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_asm_tpu_torch.models.variant_bench")
    ap.add_argument("which", nargs="?", default="access",
                    choices=("access", "composition"))
    ap.add_argument("config", nargs="?", help="JSON config file")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    params = {}
    if args.config:
        with open(args.config) as f:
            params = json.load(f)
    run = (run_composition_bench if args.which == "composition"
           else run_access_bench)
    run(params, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
