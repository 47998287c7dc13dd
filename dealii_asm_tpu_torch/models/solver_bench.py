"""Krylov solver cost anatomy and transfer throughput (PyTorch).

Counterpart of ``dealii_asm_tpu/models/solver_bench.py``, the reference's
``outer_solver_01.likwid.cc`` and ``transfer_01.likwid.cc``:

- ``run_solver_anatomy``: the float32 Laplace operator on a balanced 3D
  hyper-cube (``"n subdivision"`` s, ``"fe degree"`` p; on a CUDA device
  kernel A in every operator apply), Jacobi preconditioned, a NumPy
  ``default_rng(0)`` normal right-hand side (0 at constrained DoFs); each
  solver of ``"solvers"`` (default CG FCG GMRES FGMRES Bicgstab IDR) runs
  ``"n iterations"`` steps under an ``IterationNumberControl`` (tolerance
  0), once to warm up and once timed;
- ``run_transfer_bench``: for each coarse degree in {1, p/2, p − 1} the
  p-transfer to degree p on the same mesh, ``"n repetitions"`` restrictions
  and prolongations of ``default_rng(0)`` normal vectors, after one of each.

The times are host-clock seconds between two ``torch.cuda.synchronize``
calls (the JAX package reads a scalar back).  Each prints the reference's
line

    >> solver-<name> n_dofs n_its seconds
    >> transfer-<pc>-<restrict|prolongate> fine_dofs n_rep seconds

    python -m dealii_asm_tpu_torch.models.solver_bench cfg.json [...] [--device cpu]

A config's ``"kind"`` is ``"solvers"`` (the default) or anything else for
the transfers.
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
from ..mesh.balanced import balanced_hyper_cube_subdivisions
from ..mesh.grid import StructuredMesh
from ..ops.laplace import LaplaceOperator
from ..ops.transfer import TwoLevelTransfer
from ..precond.diagonal import DiagonalPreconditioner
from ..solvers.krylov import SOLVERS, IterationNumberControl
from ..utils.config import get_param


def _mesh(params: dict) -> tuple:
    """(mesh, degree) of the config: the balanced hyper-cube of "n
    subdivision" in "dim" (default 3, 6 and Q4)."""
    dim = int(get_param(params, "dim", 3))
    s = int(get_param(params, "n subdivision", 6))
    cells, lengths = balanced_hyper_cube_subdivisions(dim, s)
    mesh = StructuredMesh(dim, tuple(cells), lengths=tuple(lengths))
    return mesh, int(get_param(params, "fe degree", 4))


def _timed(device, fn):
    """(result, seconds) of fn() between two device synchronisations."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def run_solver_anatomy(params: dict, out=None, device=DEFAULT_DEVICE,
                       on_solver=None) -> int:
    """Print one ``>> solver-`` line per solver; returns the DoF count.
    ``on_solver(record)``, if given, gets each line's numbers (``name``,
    ``n_dofs``, ``n_its``, ``seconds``)."""
    device = resolve_device(device)
    out = sys.stdout if out is None else out
    mesh, degree = _mesh(params)
    dofs = DofHandler(mesh, degree)
    n_its = int(get_param(params, "n iterations", 20))
    op = LaplaceOperator(dofs, dtype=torch.float32, device=device)
    diag = DiagonalPreconditioner(op)
    rng = np.random.default_rng(0)
    b = torch.as_tensor(np.where(dofs.boundary_mask, 0.0,
                                 rng.standard_normal(dofs.n_dofs)),
                        device=device).to(torch.float32)
    names = get_param(params, "solvers",
                      "CG FCG GMRES FGMRES Bicgstab IDR").split()
    for name in names:
        fn = SOLVERS[name]
        fn(op.vmult, b, M=diag.vmult,
           control=IterationNumberControl(n_its, 0.0))  # warm up
        res, dt = _timed(device, lambda: fn(
            op.vmult, b, M=diag.vmult,
            control=IterationNumberControl(n_its, 0.0)))
        print(f">> solver-{name} {dofs.n_dofs} {res.n_iterations} {dt:.6g}",
              file=out, flush=True)
        if on_solver is not None:
            on_solver({"name": name, "n_dofs": dofs.n_dofs,
                       "n_its": res.n_iterations, "seconds": dt})
    return dofs.n_dofs


def run_transfer_bench(params: dict, out=None, device=DEFAULT_DEVICE,
                       on_transfer=None) -> int:
    """Print one ``>> transfer-`` line per coarse degree and direction;
    returns the fine DoF count.  ``on_transfer(record)``, if given, gets
    each line's numbers (``pc``, ``direction``, ``n_dofs``, ``n_rep``,
    ``seconds``)."""
    device = resolve_device(device)
    out = sys.stdout if out is None else out
    mesh, degree = _mesh(params)
    n_rep = int(get_param(params, "n repetitions", 10))
    fine = DofHandler(mesh, degree)
    rng = np.random.default_rng(0)
    for pc in sorted({1, max(degree // 2, 1), degree - 1} - {0}):
        coarse = DofHandler(mesh, pc)
        tr = TwoLevelTransfer(coarse, fine, dtype=torch.float32,
                              device=device)
        uf = torch.as_tensor(rng.standard_normal(fine.n_dofs),
                             device=device).to(torch.float32)
        uc = torch.as_tensor(rng.standard_normal(coarse.n_dofs),
                             device=device).to(torch.float32)
        for direction, f, src in (("restrict", tr.restrict, uf),
                                  ("prolongate", tr.prolongate, uc)):
            f(src)

            def chain(f=f, src=src):
                for _ in range(n_rep):
                    y = f(src)
                return y
            _, dt = _timed(device, chain)
            print(f">> transfer-{pc}-{direction} {fine.n_dofs} {n_rep} "
                  f"{dt:.6g}", file=out, flush=True)
            if on_transfer is not None:
                on_transfer({"pc": pc, "direction": direction,
                             "n_dofs": fine.n_dofs, "n_rep": n_rep,
                             "seconds": dt})
    return fine.n_dofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_asm_tpu_torch.models.solver_bench")
    ap.add_argument("configs", nargs="+", help="JSON config files")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    for path in args.configs:
        with open(path) as f:
            params = json.load(f)
        if params.get("kind", "solvers") == "solvers":
            run_solver_anatomy(params, device=args.device)
        else:
            run_transfer_bench(params, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
