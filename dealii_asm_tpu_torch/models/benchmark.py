"""Smoother and operator throughput benchmark (PyTorch): the matrix-free
loop of the reference's ``matrix_free_loop_08.likwid.cc``.

Counterpart of ``dealii_asm_tpu/models/benchmark.py``: a periodic balanced
hyper-cube (``mesh/balanced.py``; with ``"use cartesian mesh": false``
sinusoidally deformed), one float32 or float64 Laplace operator, and for
each label of ``"preconditioner types"`` a warm-up (one call and
min(n_rep, 3) chained calls) and a timed chain of n_rep calls, each fed the
last one's output, from the same source vector (``default_rng(0)``
normal, cast to the number type).  Each label prints one line

    >> label n_dofs n_rep·factor seconds sizeof(Number) degree n_ghost n_import

(the last two fields are the halo sizes of a sharded run, 0 on one device).
With ``"n devices"`` > 1 (one rank per device, ``parallel/sharding.py``;
``benchmark.py:55-115,171-196``) the ``vmult``, Diagonal-Chebyshev and
global-FDM labels apply over ``parallel/halo.py::ShardedLattice`` slabs
and both fields are the entries each rank exchanges per apply, 2·hw·plane
over the label's widest z factor; an FDM label without the global form
(RAS, vertex patches, a deformed mesh) runs whole on every rank with 0
ghosts, as in the JAX package, and says so on standard error.  Rank 0
prints.
The chain is timed on the host clock between two
``torch.cuda.synchronize`` calls (the JAX package forces a scalar read).

Label grammar (``benchmark.py:43-131``):

- ``vmult``: the operator;
- ``<wt>-<ov|v>-<seq...>``: the FDM Schwarz apply, weighting wt ∈ {add
  (= none), none, pre, post, symm, ras}, element overlap ov or vertex
  patches ``v``; the storage letters (``c``, ``l``, ``dg``, ``g-s-n`` ...)
  are accepted and recorded, and change no apply, as in the JAX package;
- ``cheby-<deg>-<opt>-diag`` and ``cheby-<deg>-<opt>-<fdm label>``: a
  degree-deg Chebyshev sweep around the inverse diagonal or the FDM apply
  (factor deg), its eigenvalue estimate by Lanczos for the symmetric
  weightings and the diagonal, power iteration otherwise; the opt field is
  accepted and recorded.

Periodic meshes reach no kernel: the JAX package's kernels refuse them
(``dd_vmult.py:301,569``, ``fdm_slab.py:152``, ``smoother_step.py:1086``,
``merged_vmult.py:344``), and so do the port's gates, so every label runs
plain torch (the banded operator, the global or per-patch FDM, the
diagonal).

    python -m dealii_asm_tpu_torch.models.benchmark cfg.json [...] [--device cpu]
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
from ..mesh.transforms import sinusoidal_displacement
from ..ops.laplace import LaplaceOperator
from ..precond.asm import ASMPreconditioner, CellASMPreconditioner
from ..precond.diagonal import DiagonalPreconditioner
from ..precond.factory import _try_attach_fused_step
from ..parallel.halo import ShardedLattice
from ..parallel.sharding import GroupReduction, process_shards, slab
from ..solvers.chebyshev import (ChebyshevPreconditioner,
                                 eig_initial_guess, estimate_eigenvalues)
from ..utils.config import get_param
from .poisson import n_devices

NUMBER_TYPES = {"float32": torch.float32, "float64": torch.float64}


def parse_fdm_label(props: list, offset: int) -> dict:
    """The FDM fields of a split label from ``offset``: weighting and
    overlap or ``v`` (``benchmark.py:43-53``)."""
    wt, overlap = props[offset], props[offset + 1]
    return {"weighting_type": "none" if wt == "add" else wt,
            "patch_type": "vertex" if overlap == "v" else "element",
            "n_overlap": 1 if overlap == "v" else int(overlap)}


def _fdm(op, dofs, cfg: dict, device=None):
    """The FDM Schwarz apply of a parsed label on the operator's mesh:
    per-coordinate tables on a Cartesian mesh, per-patch ones on a
    deformed mesh; on the operator's device unless ``device`` is given."""
    cls = (CellASMPreconditioner if dofs.mesh.transform is not None
           else ASMPreconditioner)
    return cls(dofs, dtype=op.dtype, device=device or op.device, **cfg)


def build_from_label(label: str, op, dofs):
    """(apply, factor) of one label (``benchmark.py:56-131``, one device)."""
    props = label.split("-")
    if props[0] == "vmult":
        return op.vmult, 1
    if props[0] == "cheby":
        degree = int(props[1])
        if props[3] == "diag":
            inner, asm, sym = DiagonalPreconditioner(op), None, True
        else:
            cfg = parse_fdm_label(props, 3)
            inner = asm = _fdm(op, dofs, cfg)
            sym = cfg["weighting_type"] in ("none", "symm")
        ev = estimate_eigenvalues(
            op.vmult, dofs.n_dofs, M=inner.vmult,
            constrained_mask=dofs.boundary_mask,
            algorithm="lanczos" if sym else "power iteration",
            device=op.device)
        cheb = ChebyshevPreconditioner(op.vmult, inner.vmult, dofs.n_dofs,
                                       degree=degree, eigenvalues=ev,
                                       device=op.device)
        if asm is not None:
            # the factory's kernel attach, which refuses periodic meshes
            _try_attach_fused_step(cheb, op, asm)
        return cheb.vmult, degree
    return _fdm(op, dofs, parse_fdm_label(props, 0)).vmult, 1


def _has_global_fdm(dofs, cfg: dict) -> bool:
    """Whether a parsed FDM label takes the global form that
    ``ShardedLattice`` splits: element patches, not RAS, Cartesian."""
    return (dofs.mesh.transform is None and cfg["patch_type"] == "element"
            and cfg["weighting_type"] != "ras")


def build_sharded_from_label(label: str, op, dofs, shards):
    """(apply, factor, pad, n_ghost) of one label over ``ShardedLattice``
    slabs (``benchmark.py:56-131`` with a device mesh); ``op`` is the host
    operator.  The Chebyshev estimate starts from the rank's slab of the
    padded i%11 vector, as the JAX package's over its padded length."""
    props = label.split("-")
    if props[0] == "vmult":
        sl = ShardedLattice(op, None, shards)
        return sl.vmult, 1, sl.pad, sl.ghost_planes(("Mz", "Kz"))
    if props[0] == "cheby":
        degree = int(props[1])
        if props[3] == "diag":
            sl = ShardedLattice(op, None, shards)
            dinv = sl.pad(DiagonalPreconditioner(op).inv_diag)
            M, sym = (lambda r: r * dinv), True
            ghost = sl.ghost_planes(("Mz", "Kz"))
        else:
            cfg = parse_fdm_label(props, 3)
            if not _has_global_fdm(dofs, cfg):
                raise ValueError(f"{label}: the sharded Chebyshev needs the "
                                 "global-FDM form")
            sl = ShardedLattice(op, _fdm(op, dofs, cfg), shards)
            M = sl.smoother_vmult
            sym = cfg["weighting_type"] in ("none", "symm")
            ghost = sl.ghost_planes(("Mz", "Kz", "Gz", "Gzt"))
        b0 = slab(eig_initial_guess(sl.n_padded, device="cpu"), shards,
                  sl.n_local).to(sl.device)
        cheb = ChebyshevPreconditioner(
            sl.vmult, M, sl.n_local, degree=degree,
            ev_algorithm="lanczos" if sym else "power iteration",
            eig_b0=b0, reduction=GroupReduction(shards), device=sl.device)
        return cheb.vmult, degree, sl.pad, ghost
    cfg = parse_fdm_label(props, 0)
    if _has_global_fdm(dofs, cfg):
        sl = ShardedLattice(op, _fdm(op, dofs, cfg), shards)
        return sl.smoother_vmult, 1, sl.pad, sl.ghost_planes(("Gz", "Gzt"))
    if shards.rank == 0:
        print(f"# {label}: no global-FDM form, every rank applies it whole",
              file=sys.stderr, flush=True)
    return (_fdm(op, dofs, cfg, shards.device).vmult, 1,
            lambda u: u.to(shards.device), 0)


def make_problem(params: dict, device=DEFAULT_DEVICE):
    """(dofs, op, src0, dtype) of a config: the periodic balanced
    hyper-cube, its operator in the number type and the source vector."""
    dim = int(get_param(params, "dim", 3))
    s = int(get_param(params, "n subdivisions",
                      get_param(params, "n subdivision", 6)))
    degree = int(get_param(params, "fe degree", 4))
    cartesian = get_param(params, "use cartesian mesh", True)
    dtype = NUMBER_TYPES[get_param(params, "number type", "float32")]
    cells, lengths = balanced_hyper_cube_subdivisions(dim, s)
    mesh = StructuredMesh(dim, tuple(cells), lengths=tuple(lengths),
                          periodic=(True,) * dim,
                          transform=(None if cartesian
                                     else sinusoidal_displacement(0.1)))
    dofs = DofHandler(mesh, degree)
    op = LaplaceOperator(dofs, dtype=dtype, device=device)
    src0 = torch.as_tensor(
        np.random.default_rng(0).standard_normal(dofs.n_dofs)).to(
            device=device, dtype=dtype)
    return dofs, op, src0, dtype


def run_benchmark(params: dict, out=None, device=DEFAULT_DEVICE,
                  on_label=None) -> int:
    """Print one ``>>`` line per label to ``out`` (standard output by
    default); returns the DoF count.
    ``on_label(record, apply, src0)``, if given, is called after each
    label's timed chain with the line's numbers (``label``, ``n_dofs``,
    ``count`` = n_rep·factor, ``seconds``) and the setup seconds of the
    problem (``problem_setup_s``: mesh, operator, source) and of the label
    (``setup_s``: its preconditioner and eigenvalue estimate);
    ``chip_smoke.py`` reads the apply there."""
    device = resolve_device(device)
    n_dev = n_devices(params, device)
    shards = process_shards(n_dev, device) if n_dev > 1 else None
    n_rep = int(get_param(params, "n repetitions", 10))
    labels = get_param(params, "preconditioner types", "vmult").split()
    t0 = time.perf_counter()
    # a sharded run builds the host tables on the CPU and keeps its slabs
    dofs, op, src0, dtype = make_problem(
        params, device if shards is None else "cpu")
    if shards is not None:
        device = shards.device
    synchronize(device)
    problem_setup_s = time.perf_counter() - t0
    itemsize = torch.empty((), dtype=dtype).element_size()
    out = sys.stdout if out is None else out
    for label in labels:
        t0 = time.perf_counter()
        if shards is None:
            fn, factor = build_from_label(label, op, dofs)
            src, n_ghost = src0, 0
        else:
            fn, factor, pad, n_ghost = build_sharded_from_label(
                label, op, dofs, shards)
            src = pad(src0)
        synchronize(device)
        setup_s = time.perf_counter() - t0
        y = fn(src)
        for _ in range(min(n_rep, 3)):
            y = fn(y)
        synchronize(device)
        t0 = time.perf_counter()
        y = src
        for _ in range(n_rep):
            y = fn(y)
        synchronize(device)
        dt = time.perf_counter() - t0
        if shards is None or shards.rank == 0:
            print(f">> {label} {dofs.n_dofs} {n_rep * factor} {dt:.6g} "
                  f"{itemsize} {dofs.degree} {n_ghost} {n_ghost}", file=out,
                  flush=True)
        if on_label is not None:
            on_label({"label": label, "n_dofs": dofs.n_dofs,
                      "count": n_rep * factor, "seconds": dt,
                      "problem_setup_s": problem_setup_s,
                      "setup_s": setup_s}, fn, src)
        del fn, y
    return dofs.n_dofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dealii_asm_tpu_torch.models.benchmark")
    ap.add_argument("configs", nargs="+", help="JSON config files")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    for path in args.configs:
        with open(path) as f:
            run_benchmark(json.load(f), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
