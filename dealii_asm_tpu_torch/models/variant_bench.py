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
  port has for it on a Cartesian mesh, in the JAX order: ``global`` (the
  plain global FDM around the operator), ``gather`` (``GatherASM``: the
  element patches gathered through their index table, the per-patch FDM
  of the Cartesian collection, a fixed-order scatter; the JAX
  ``ASMPreconditioner`` with ``access = "gather"``, ``asm.py:670-677``),
  ``lanes`` (the per-cell FDM of deformed meshes,
  ``CellASMPreconditioner``, forced onto the Cartesian mesh; kernel G on
  CUDA at overlap 1, its plain chain at overlap 2) and ``cuda``
  (kernel C's fused step; the JAX label ``pallas``).  The JAX package runs
  ``gather`` in XLA, so it is plain torch here.  On the CPU the ``cuda``
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
from ..fem.patches import element_patch_indices
from ..kernels.fdm_patch import fdm_patch_plain
from ..kernels.smoother_step import smoother_step
from ..mesh.grid import StructuredMesh
from ..ops.laplace import LaplaceOperator
from ..precond.asm import (ASMPreconditioner, CellASMPreconditioner,
                           patch_apply)
from ..precond.asm_general import GeneralASMPreconditioner
from ..precond.diagonal import DiagonalPreconditioner
from ..precond.fdm import FDMCollection
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


GATHER_CHUNK_BYTES = 256 << 20  # gathered values a chunk (asm.py:648-653)


class GatherASM(GeneralASMPreconditioner):
    """The index-table route of an element-patch ``ASMPreconditioner`` on
    a Cartesian mesh (the JAX ``access = "gather"`` apply with no global or
    dense form, ``asm.py:670-677``): the (P, m^dim) patch index table
    (``fem/patches.py``, constrained DoFs sent to the zero slot) and the
    Cartesian collection's per-patch FDM through the unstructured apply,
    the patches gathered in equal chunks of at most ``GATHER_CHUNK_BYTES``
    of values, sized by the dtype's itemsize."""

    def __init__(self, asm: ASMPreconditioner):
        dofs, n = asm.dofs, asm.dofs.n_dofs
        idx = element_patch_indices(dofs, asm.n_overlap).astype(np.int64)
        idx = np.where(dofs.boundary_mask[np.minimum(idx, n - 1)]
                       | (idx >= n), n, idx)
        super().__init__(dofs, asm.n_overlap, asm.weighting_type, asm.dtype,
                         asm.device, collection=FDMCollection(
                             [V for V, _ in asm.percoord],
                             [lam for _, lam in asm.percoord],
                             dofs.mesh.cell_multi_index()), patch_idx=idx)

    def chunk_bounds(self, itemsize: int) -> np.ndarray:
        """The patch ranges of the chunks, as the JAX package splits them."""
        P, L = self.patch_idx.shape
        n_chunks = max(1, -(-L * P * itemsize // GATHER_CHUNK_BYTES))
        return np.linspace(0, P, n_chunks + 1).astype(int)

    def local_solves(self, xpad: torch.Tensor, dt) -> torch.Tensor:
        shape = (-1,) + (self.m,) * self.dim
        y = xpad.new_empty((self.patch_idx.shape[0],) + shape[1:])
        bounds = self.chunk_bounds(xpad.element_size())
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            W = xpad[self.patch_idx[lo:hi]].reshape(shape)
            y[lo:hi] = patch_apply(self, W, dt, slice(lo, hi))
        return y


def access_routes(dofs, op, b, n_overlap: int = 1) -> dict:
    """label → one smoothing step y ↦ y + P⁻¹(b − A y) through each of the
    port's FDM routes (``cuda`` only where kernel C tiles the mesh)."""
    device = op.device
    asm = ASMPreconditioner(dofs, n_overlap=n_overlap, weighting_type="symm",
                            dtype=DTYPE, device=device)
    lanes = CellASMPreconditioner(dofs, n_overlap=n_overlap,
                                  weighting_type="symm", dtype=DTYPE,
                                  device=device)
    gather = GatherASM(asm)
    routes = {
        "global": lambda y: y + fdm_patch_plain(b - op.vmult(y), asm.tables),
        "gather": lambda y: y + gather.vmult(b - op.vmult(y)),
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
