"""JSON-config-driven Poisson solve (PyTorch).

Counterpart of ``dealii_asm_tpu/models/poisson.py::run_config`` for the
structured families ``hypercube``, ``symmetric hypercube``, ``anisotropy``
(2D and 3D) and the deformed ``kershaw``/``kershaw-mp`` (3D), and the
unstructured ``hyperball`` (3D), on one device: mesh → float64 operator
(the "operator mapping type" selects a compact geometry form for it) →
multigrid (h, p, hp or ph levels, float32 by default) behind a precision
adapter → CG or GMRES with deal.II's ReductionControl.

The right-hand side ("rhs") comes with its Dirichlet data g: the port
solves deal.II's homogeneous system (the lift in the free rows, b = 0 at
constrained rows) and adds g to the solution.  The JAX package writes g
into the constrained rows of b instead, which its Schwarz smoothers never
reduce (ROADMAP queue 3).  The result dict carries the same keys (``it``,
``converged``, ``time``, ``solution`` ...), plus ``setup_time``, the first
solve's ``residuals`` and the ``preconditioner``.  Options outside the
slice raise NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from ..device import (DEFAULT_DEVICE, LEVEL_DTYPE, OUTER_DTYPE,
                      assert_no_tf32, resolve_device, synchronize)
from ..fem.dofs import DofHandler
from ..fem.functions import make_rhs_and_dbc
from ..fem.general_dofs import GeneralDofHandler
from ..mesh.grid import StructuredMesh
from ..mesh.transforms import kershaw_transform
from ..mesh.unstructured import hyper_ball_balanced
from ..ops.laplace import LaplaceOperator
from ..ops.laplace_general import GeneralLaplaceOperator
from ..ops.transfer import TwoLevelTransfer, p_sequence
from ..ops.transfer_general import GeneralTwoLevelTransfer
from ..precond.adapter import PrecisionAdapter
from ..precond.factory import create_system_preconditioner
from ..precond.fdm import NoVertexPatches
from ..precond.multigrid import Multigrid
from ..solvers.krylov import solve as krylov_solve
from ..utils.config import get_child, get_param
from ..utils.table import ConvergenceTable

# "mg number type" (top-level key, as in the JAX run_config): "" means the outer
# type; a missing key means the policy's level type
_LEVEL_DTYPES = {"": OUTER_DTYPE, "float64": torch.float64,
                 "float32": torch.float32}


@dataclass(frozen=True)
class MeshFamily:
    """A refinement family of structured meshes; ``transform`` (or None)
    deforms every member, whose operators map with ``mapping_degree``."""

    dim: int
    base_cells: tuple
    n_refinements: int
    lengths: tuple
    name: str
    transform: object = None
    mapping_degree: int = 1
    origin: tuple = None

    def mesh_at(self, refinement: int) -> StructuredMesh:
        cells = tuple(c * (1 << refinement) for c in self.base_cells)
        return StructuredMesh(self.dim, cells, lengths=self.lengths,
                              transform=self.transform, origin=self.origin)

    @property
    def fine_mesh(self) -> StructuredMesh:
        return self.mesh_at(self.n_refinements)

    @property
    def n_levels(self) -> int:
        return self.n_refinements + 1

    def dofs_at(self, refinement: int, degree: int) -> DofHandler:
        return DofHandler(self.mesh_at(refinement), degree)

    def operator(self, dofs, dtype, device,
                 mapping_type: str = "") -> LaplaceOperator:
        return LaplaceOperator(dofs, dtype=dtype, device=device,
                               mapping_degree=self.mapping_degree,
                               mapping_type=mapping_type)

    def transfer(self, coarse, fine, dtype, device) -> TwoLevelTransfer:
        return TwoLevelTransfer(coarse, fine, dtype=dtype, device=device)


class GeneralMeshFamily:
    """A refinement family of unstructured meshes (the hyperball), each
    refined once from the previous one (``poisson.py:60-85``).  Meshes and
    DoF handlers are built once and shared by the outer operator and the
    levels.  The operators take the general default mapping degree (2 on
    the curved ball), whatever the config's "mapping degree", as in the JAX
    package."""

    def __init__(self, dim: int, coarse_mesh, n_refinements: int, name: str):
        self.dim = dim
        self.n_refinements = n_refinements
        self.name = name
        self._meshes = [coarse_mesh]
        self._dofs = {}

    def mesh_at(self, refinement: int):
        while len(self._meshes) <= refinement:
            self._meshes.append(self._meshes[-1].refine())
        return self._meshes[refinement]

    @property
    def fine_mesh(self):
        return self.mesh_at(self.n_refinements)

    @property
    def n_levels(self) -> int:
        return self.n_refinements + 1

    def dofs_at(self, refinement: int, degree: int) -> GeneralDofHandler:
        key = (refinement, degree)
        if key not in self._dofs:
            self._dofs[key] = GeneralDofHandler(self.mesh_at(refinement),
                                                degree)
        return self._dofs[key]

    def operator(self, dofs, dtype, device,
                 mapping_type: str = "") -> GeneralLaplaceOperator:
        # the JAX package's general operator has no compact mapping types
        return GeneralLaplaceOperator(dofs, dtype=dtype, device=device)

    def transfer(self, coarse, fine, dtype, device) -> GeneralTwoLevelTransfer:
        return GeneralTwoLevelTransfer(coarse, fine, dtype=dtype,
                                       device=device)


def make_mesh_family(params: dict, log=lambda *_: None) -> MeshFamily:
    dim = int(get_param(params, "dim", 2))
    n_refine = int(get_param(params, "n refinements", 6))
    mesh_p = get_child(params, "mesh")
    name = get_param(mesh_p, "name", "hypercube")
    mapping_degree = int(get_param(params, "mapping degree", 10))
    if name == "hypercube":
        ns = int(get_param(mesh_p, "n subdivisions", 1))
        log("- Create mesh: hypercube\n")
        return MeshFamily(dim, (ns,) * dim, n_refine, (1.0,) * dim, name)
    if name == "anisotropy":
        stretch = float(get_param(mesh_p, "stratch", 1.0))
        log(f"- Create mesh: anisotropy\n  - stratch: {stretch:g}\n")
        return MeshFamily(dim, (1,) * dim, n_refine,
                          tuple([1.0] * (dim - 1) + [stretch]), name)
    if name in ("kershaw", "kershaw-mp"):
        epsy = float(get_param(mesh_p, "epsy", 0.0))
        epsz = float(get_param(mesh_p, "epsz", 0.0))
        if epsy == 0.0 or epsz == 0.0:
            epsy = epsz = float(get_param(mesh_p, "eps", 1.0))
        ni = int(get_param(mesh_p, "n initial refinements", 1))
        ns = int(get_param(mesh_p, "n subdivisions", 3))
        log(f"- Create mesh: kershaw\n  - epsx: 1\n  - epsy: {epsy:g}\n"
            f"  - epsz: {epsz:g}\n")
        tf = kershaw_transform(epsy, epsz, shift_mp=(name == "kershaw-mp"))
        return MeshFamily(dim, (ns * (1 << ni),) * dim, n_refine,
                          (1.0,) * dim, name, tf, min(mapping_degree, 3))
    if name == "symmetric hypercube":
        ns = int(get_param(mesh_p, "n subdivisions", 1))
        log("- Create mesh: symmetric hypercube\n")
        return MeshFamily(dim, (ns,) * dim, n_refine, (2.0,) * dim, name,
                          origin=(-1.0,) * dim)
    if name == "hyperball":
        if dim != 3:
            raise NotImplementedError(
                f"dim {dim}: the port runs 3D meshes only (ROADMAP item 9)")
        log("- Create mesh: hyperball\n")
        return GeneralMeshFamily(dim, hyper_ball_balanced(dim), n_refine,
                                 name)
    raise ValueError(f"Geometry with the name <{name}> is not known!")


def mg_level_layout(precon_p: dict, family, fe_degree: int,
                    log=lambda *_: None):
    """(refinement, degree) per level, coarse → fine, and the index of the
    intermediate level (the last degree-1 level seen from the top)
    (``dealii_asm_tpu/models/poisson.py:166-206``)."""
    mg_type = get_param(precon_p, "mg type", "h")
    mg_p_seq = get_param(precon_p, "mg p sequence", "bisect")
    log(f" - type:       {mg_type}")
    log(f" - p sequence: {mg_p_seq}\n")
    degrees = p_sequence(fe_degree, mg_p_seq)  # ascending
    n_trias = family.n_refinements + 1
    top = family.n_refinements
    if mg_type == "h":
        levels = [(r, degrees[-1]) for r in range(n_trias)]
    elif mg_type == "p":
        levels = [(top, d) for d in degrees]
    elif mg_type == "hp":
        levels = [(0, d) for d in degrees] + [(r, degrees[-1])
                                              for r in range(n_trias)]
    elif mg_type == "ph":
        levels = [(r, degrees[0]) for r in range(n_trias)] + [(top, d)
                                                              for d in degrees]
    else:
        raise ValueError(f"Multigrid variant <{mg_type}> is not known!")
    # the junction of hp/ph repeats a level; drop consecutive duplicates
    levels = [lv for i, lv in enumerate(levels) if i == 0 or lv != levels[i - 1]]
    intermediate = 0
    for i in range(len(levels) - 1, -1, -1):
        if levels[i][1] == 1:
            intermediate = i
            break
    return levels, intermediate


def _build_multigrid(params: dict, family, fe_degree: int, log,
                     dtype, device) -> Multigrid:
    levels, intermediate = mg_level_layout(params, family, fe_degree, log)
    ops, dofs_list = [], []
    for r, d in levels:
        dofs = family.dofs_at(r, d)
        ops.append(family.operator(dofs, dtype, device))
        dofs_list.append(dofs)
        log(f"- Create operator:\n  - n cells:          "
            f"{dofs.mesh.n_cells_total}\n  - n dofs:           {dofs.n_dofs}\n")
    transfers = [family.transfer(dofs_list[i], dofs_list[i + 1], dtype, device)
                 for i in range(len(levels) - 1)]

    smoother_p = get_child(params, "mg smoother")
    interm_p = get_child(params, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    one_sided = get_param(params, "one-sided v-cycle", False)
    n_coarse_cycles = int(get_param(params, "n coarse cycles", 1))

    def make_smoother(level: int, p: dict):
        log(f"- Setting up smoother on level {level}\n")
        try:
            return create_system_preconditioner(ops[level], p, log)
        except NoVertexPatches as e:
            # the hp layout's p-levels on a 1-cell mesh: the JAX package
            # raises a ValueError there too (``asm.py:438``)
            r, d = levels[level]
            raise NoVertexPatches(
                f"level (refinement {r}, degree {d}) has no interior "
                f"vertex ({e})") from e

    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(
        ops[0], get_child(params, "mg coarse grid solver"), log)
    if intermediate > 0:
        inner = Multigrid(ops[: intermediate + 1],
                          [make_smoother(l, interm_p)
                           for l in range(1, intermediate + 1)],
                          transfers[:intermediate], coarse.vmult,
                          one_sided=one_sided)
        return Multigrid(ops[intermediate:],
                         [make_smoother(l, smoother_p)
                          for l in range(intermediate + 1, len(levels))],
                         transfers[intermediate:], inner.vmult,
                         one_sided=one_sided, n_coarse_cycles=n_coarse_cycles)
    smoothers = [make_smoother(l, smoother_p) for l in range(1, len(levels))]
    return Multigrid(ops, smoothers, transfers, coarse.vmult,
                     one_sided=one_sided, n_coarse_cycles=n_coarse_cycles)


def n_devices(params: dict, device: torch.device) -> int:
    """The config's "n devices": an integer, or "auto" for every visible
    device of the run's type (``torch.cuda.device_count()`` on CUDA, 1 on
    the CPU), as the JAX package takes its visible device count."""
    value = get_param(params, "n devices", 1)
    if value == "auto":
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(value)


def _check_unported_options(params: dict, device: torch.device) -> None:
    if n_devices(params, device) > 1:
        raise NotImplementedError(
            "'n devices' > 1 is not ported yet (ROADMAP item 14)")
    if get_param(params, "do output", False):
        raise NotImplementedError("'do output' is not ported yet "
                                  "(ROADMAP item 12)")
    # "auto" engages refinement only for n_dofs > 2M with <= 80 nodes per
    # direction, which no 3D mesh satisfies
    if get_param(params, "mixed precision solve", "auto") is True:
        raise NotImplementedError(
            "mixed-precision refinement is not ported yet (ROADMAP item 11c)")


def run_config(params: dict, table: ConvergenceTable | None = None,
               log=print, device=DEFAULT_DEVICE):
    """Run one config on ``device`` (float64 outer solve); returns the result
    dict."""
    t_setup = time.perf_counter()
    device = resolve_device(device)
    assert_no_tf32()
    _check_unported_options(params, device)
    dtype = OUTER_DTYPE
    table = table or ConvergenceTable()
    fe_degree = int(get_param(params, "degree", 1))
    family = make_mesh_family(params, log)
    mesh = family.fine_mesh
    dofs = family.dofs_at(family.n_refinements, fe_degree)
    # the compact geometry forms serve the outer operator only; the levels
    # keep the merged coefficients, as in the JAX package (``poisson.py:345``)
    op = family.operator(dofs, dtype, device,
                         get_param(params, "operator mapping type", ""))
    rhs_fn, dbc_fn = make_rhs_and_dbc(get_param(params, "rhs", "constant"),
                                      family.dim)
    b = op.assemble_rhs(rhs_fn, dirichlet=dbc_fn)
    g = op.dirichlet_vector(dbc_fn)

    table.add_value("name", get_param(params, "name", family.name))
    table.add_value("n_cells", mesh.n_cells_total)
    table.add_value("L", family.n_levels)
    table.add_value("n_dofs", dofs.n_dofs)

    precon_p = get_child(params, "preconditioner")
    if precon_p.get("type", "") == "Multigrid":
        log("- Create system preconditioner: Multigrid")
        # float MG levels under a float64 outer Krylov, as the reference
        level_name = params.get("mg number type")
        if level_name is not None and level_name not in _LEVEL_DTYPES:
            raise NotImplementedError(
                f"mg number type {level_name!r} is not ported yet "
                "(ROADMAP item 9)")
        level_dtype = _LEVEL_DTYPES.get(level_name, LEVEL_DTYPE)
        precon = _build_multigrid(precon_p, family, fe_degree, log,
                                  level_dtype, device)
        if level_dtype != dtype:
            precon = PrecisionAdapter(precon, level_dtype)
    else:
        precon = create_system_preconditioner(op, precon_p, log)

    solver_p = get_child(params, "solver")
    solver_type = get_param(solver_p, "type", "")
    max_it = int(get_param(solver_p, "max iterations", 1000))
    abs_tol = float(get_param(solver_p, "abs tolerance", 1e-10))
    rel_tol = float(get_param(solver_p, "rel tolerance", 1e-2))
    log(f" - Solving with {solver_type}")
    log(f"   - max iterations: {max_it}")
    log(f"   - abs tolerance:  {abs_tol:g}")
    log(f"   - rel tolrance:   {rel_tol:g}")

    kwargs = {}
    if solver_type == "GMRES":  # ``poisson.py:488-498``
        kwargs["right_preconditioning"] = get_param(
            solver_p, "use right preconditioning", True)
        ortho = get_param(solver_p, "orthogonalization strategy",
                          "classical gram schmidt")
        kwargs["orthogonalization"] = (
            "classical" if ortho.startswith("classical") else "modified")
        mtv = int(get_param(solver_p, "max n tmp vectors", 0))
        if mtv > 0:
            kwargs["restart"] = mtv - 2

    def dispatch():
        return krylov_solve(solver_type, op.vmult, b, M=precon.vmult,
                            max_iterations=max_it, abs_tolerance=abs_tol,
                            rel_tolerance=rel_tol, **kwargs)

    synchronize(device)
    setup_time = time.perf_counter() - t_setup
    result = dispatch()  # warm-up
    best_of = int(get_param(solver_p, "best of", 1))
    print_timing = get_param(params, "print timing", False)
    solve_time = 999.0
    if result.converged and (best_of > 1 or print_timing):
        for _ in range(best_of):
            synchronize(device)
            t0 = time.perf_counter()
            r2 = dispatch()
            synchronize(device)
            solve_time = min(solve_time, time.perf_counter() - t0)
            if r2.n_iterations != result.n_iterations:
                raise RuntimeError(
                    f"repeated solve took {r2.n_iterations} iterations, the "
                    f"first {result.n_iterations}")
    if result.converged:
        log(f"   - n iterations:   {result.n_iterations}")
        if print_timing:
            log(f"   - time:           {solve_time} #")
        log("")
        table.add_value("it", result.n_iterations)
    else:
        log("   - DID NOT CONVERGE!\n")
        table.add_value("it", 999)
    if print_timing:
        table.add_value("time", solve_time)
        log("   - (the port prints no stage timings; ROADMAP item 12)")
    table.add_value("aspect_ratio", mesh.max_aspect_ratio())
    table.end_row()
    return {
        "n_cells": mesh.n_cells_total,
        "L": family.n_levels,
        "n_dofs": dofs.n_dofs,
        "it": result.n_iterations if result.converged else 999,
        "converged": result.converged,
        "time": solve_time,
        "setup_time": setup_time,
        "residuals": result.residuals,
        "solution": result.x if g is None else result.x + g,
        "preconditioner": precon,
        "table": table,
    }
