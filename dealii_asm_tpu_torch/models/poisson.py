"""JSON-config-driven Poisson solve (PyTorch).

Counterpart of ``dealii_asm_tpu/models/poisson.py::run_config`` for the
structured families ``hypercube``, ``symmetric hypercube``, ``anisotropy``
and the deformed ``kershaw``/``kershaw-mp``, and the unstructured
``hyperball``, in 2D and 3D, on one device: mesh → float64 operator (the
"operator mapping type" selects a compact geometry form for it) →
multigrid (h, p, hp or ph levels; float32 by default, float64 or bfloat16
on request) behind a precision adapter, or a single-level preconditioner
→ CG, FCG, GMRES, FGMRES, BiCGStab, IDR or Richardson with deal.II's
ReductionControl, or mixed-precision iterative refinement
(``"mixed precision solve"``, ``solvers/refinement.py``).

The right-hand side ("rhs") comes with its Dirichlet data g: the port
solves deal.II's homogeneous system (the lift in the free rows, b = 0 at
constrained rows) and adds g to the solution.  The JAX package writes g
into the constrained rows of b instead, which its Schwarz smoothers never
reduce (ROADMAP queue 3).  The result dict carries the same keys (``it``,
``converged``, ``time``, ``solution`` ...), plus ``setup_time``, the first
solve's ``residuals`` and the ``preconditioner``.

``"n devices"`` > 1 runs the multigrid solve over that many ranks of a
``torch.distributed`` group (one process per device, launched by
torchrun), as the JAX package runs it over a device mesh: a structured
mesh through z slabs (``parallel/driver.py``), the unstructured ball
through cell ranges with its fine level sharded
(``parallel/general_sharded.py``); every rank returns the gathered
solution and rank 0 logs.  The outer operator is assembled on the host.
``"do output"`` writes the solution as a VTU file
(``utils/vtu.py``).  Under ``"print timing"`` the set-up and the warm-up
solve run with the tracer on (``utils/profiling.py``; the timed solves
after them run untraced), and its level × stage table of the warm-up
solve's V-cycles is printed, the inner levels of a nested (ph or hp)
layout too; a caller that traces gets the set-up steps as the spans
``profiling.SETUP``.
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
from ..parallel.driver import build_sharded_multigrid
from ..parallel.general_sharded import build_sharded_general
from ..parallel.sharding import launched_world_size, process_shards
from ..precond.adapter import PrecisionAdapter
from ..precond.factory import create_system_preconditioner
from ..precond.fdm import NoVertexPatches
from ..precond.multigrid import Multigrid
from ..solvers.krylov import cg, gmres
from ..solvers.krylov import solve as krylov_solve
from ..solvers.refinement import refined_solve
from ..utils.config import get_child, get_param
from ..utils.profiling import paused, span, tracing
from ..utils.table import ConvergenceTable
from ..utils.vtu import write_vtu

# "mg number type" (top-level key, as in the JAX run_config): "" means the outer
# type; a missing key means the policy's level type
_LEVEL_DTYPES = {"": OUTER_DTYPE, "float64": torch.float64,
                 "float32": torch.float32, "bfloat16": torch.bfloat16}


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
        with span("setup.mesh"):
            mesh = self.mesh_at(refinement)
        return DofHandler(mesh, degree)

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
            with span("setup.mesh"):
                mesh = self.mesh_at(refinement)
            self._dofs[key] = GeneralDofHandler(mesh, degree)
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
        with span("setup.operator"):
            ops.append(family.operator(dofs, dtype, device))
        dofs_list.append(dofs)
        log(f"- Create operator:\n  - n cells:          "
            f"{dofs.mesh.n_cells_total}\n  - n dofs:           {dofs.n_dofs}\n")
    with span("setup.transfer"):
        transfers = [family.transfer(dofs_list[i], dofs_list[i + 1], dtype,
                                     device) for i in range(len(levels) - 1)]

    smoother_p = get_child(params, "mg smoother")
    interm_p = get_child(params, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    one_sided = get_param(params, "one-sided v-cycle", False)
    n_coarse_cycles = int(get_param(params, "n coarse cycles", 1))

    def make_smoother(level: int, p: dict):
        log(f"- Setting up smoother on level {level}\n")
        try:
            with span("setup.smoother", level):
                return create_system_preconditioner(ops[level], p, log)
        except NoVertexPatches as e:
            # the hp layout's p-levels on a 1-cell mesh: the JAX package
            # raises a ValueError there too (``asm.py:438``)
            r, d = levels[level]
            raise NoVertexPatches(
                f"level (refinement {r}, degree {d}) has no interior "
                f"vertex ({e})") from e

    log("- Setting up coarse-grid solver on level 0\n")
    with span("setup.coarse"):
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
    """The config's "n devices": an integer, or "auto" for the world size
    of the run's process group (or of its torchrun launch), and without
    one every visible device of the run's type
    (``torch.cuda.device_count()`` on CUDA, 1 on the CPU), as the JAX
    package takes its visible device count."""
    value = get_param(params, "n devices", 1)
    if value == "auto":
        world = launched_world_size()
        if world is not None:
            return world
        return torch.cuda.device_count() if device.type == "cuda" else 1
    return int(value)


def _quiet(*_):
    pass


def _sharding(params: dict, device: torch.device, shards):
    """This rank's ``Shards`` when the solve runs over several ranks (or
    over the ``shards`` given), else None."""
    n = n_devices(params, device)
    if shards is None and n <= 1:
        return None
    if get_child(params, "preconditioner").get("type", "") != "Multigrid":
        raise ValueError("'n devices' > 1 supports Multigrid "
                         "preconditioners")
    if shards is None:
        return process_shards(n, device)
    if "n devices" in params and n != shards.world:
        raise RuntimeError(f"'n devices' = {n}, but the shards number "
                           f"{shards.world}")
    return shards


def _use_refinement(params: dict, mg_inner, solver_type: str, n_dofs: int,
                    dim: int) -> bool:
    """The JAX ``run_config``'s condition as written (``poisson.py:516-
    521``): a float-level multigrid (one device), CG or GMRES, and "mixed
    precision solve" identical to True, or "auto" (the default) with more
    than 2M DoFs and at most 80 nodes per direction (n^(1/dim); the outer
    solve is float64).  ``get_param`` with the default "auto" reads JSON
    true as the string "True", so only "auto" engages it, as in the JAX
    package; no 2D or 3D mesh meets its size test."""
    mp_solve = get_param(params, "mixed precision solve", "auto")
    return (mg_inner is not None and solver_type in ("CG", "GMRES")
            and (mp_solve is True
                 or (mp_solve == "auto" and n_dofs > 2_000_000
                     and n_dofs ** (1.0 / dim) <= 80.0)))


def run_config(params: dict, table: ConvergenceTable | None = None,
               log=print, device=DEFAULT_DEVICE, shards=None):
    """Run one config on ``device`` (float64 outer solve); returns the result
    dict.  ``shards`` (a ``parallel/sharding.py::Shards``) runs the sharded
    path over its ranks whatever "n devices" says, world size 1 included.
    Under "print timing" the set-up and the warm-up solve are traced and
    the tracer's table is printed (on rank 0); the timed solves run
    untraced."""
    if not get_param(params, "print timing", False):
        return _run_config(params, table, log, device, shards, None)
    with tracing() as tracer:
        return _run_config(params, table, log, device, shards, tracer)


def _run_config(params: dict, table, log, device, shards, tracer):
    t_setup = time.perf_counter()
    device = resolve_device(device)
    assert_no_tf32()
    shards = _sharding(params, device, shards)
    if shards is not None:
        device = shards.device
        if shards.rank != 0:
            log = _quiet
    dtype = OUTER_DTYPE
    table = table or ConvergenceTable()
    fe_degree = int(get_param(params, "degree", 1))
    with span("setup.mesh"):
        family = make_mesh_family(params, log)
        mesh = family.fine_mesh
    if family.dim == 2:
        # the JAX kernels are 3D only, so its 2D paths run XLA
        log(" - 2D mesh: plain torch (kernels A-F take 3D meshes)")
    dofs = family.dofs_at(family.n_refinements, fe_degree)
    # the compact geometry forms serve the outer operator only; the levels
    # keep the merged coefficients, as in the JAX package (``poisson.py:345``).
    # A sharded solve assembles b on the host and keeps its slab
    with span("setup.operator"):
        op = family.operator(dofs, dtype,
                             device if shards is None else "cpu",
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
    mg_inner = None  # the float-level multigrid before its adapter
    sharded = None  # the sharded solve's handles (parallel/driver.py)
    if precon_p.get("type", "") == "Multigrid":
        log("- Create system preconditioner: Multigrid")
        # float MG levels under a float64 outer Krylov, as the reference
        level_name = params.get("mg number type")
        if level_name is not None and level_name not in _LEVEL_DTYPES:
            raise ValueError(f"mg number type <{level_name}> is not known!")
        level_dtype = _LEVEL_DTYPES.get(level_name, LEVEL_DTYPE)
        if level_dtype == torch.bfloat16:
            # the JAX kernels all require float32 (``factory.py:69``,
            # ``asm.py:550``, ``laplace.py:252``), so bfloat16 levels run
            # XLA there; the CUDA kernels are float and double templates
            log(" - bfloat16 levels: plain torch (kernels A-F take float32 "
                "and float64 only)")
        if shards is None:
            precon = _build_multigrid(precon_p, family, fe_degree, log,
                                      level_dtype, device)
        elif isinstance(family, GeneralMeshFamily):
            sharded = build_sharded_general(
                precon_p, family, fe_degree, log, level_dtype, op, shards)
            precon = sharded.mg
        else:
            log(f" - n devices:  {shards.world} (explicit-halo sharding)")
            sharded = build_sharded_multigrid(
                precon_p, family, fe_degree, log, level_dtype, op, shards)
            precon = sharded.mg
        if level_dtype != dtype:
            mg_inner = precon
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

    if shards is None and _use_refinement(params, mg_inner, solver_type,
                                          dofs.n_dofs, family.dim):
        # the inner operator: the outer one built at the level precision
        # (``poisson.py:516-541``); its solve runs on float32 vectors
        op_level = family.operator(dofs, level_dtype, device)
        M_level = (mg_inner.vmult if level_dtype == torch.float32 else
                   PrecisionAdapter(mg_inner, level_dtype).vmult)
        inner_solver = cg if solver_type == "CG" else gmres
        inner_red = float(get_param(solver_p, "inner reduction", 3e-4))
        log("   - mixed-precision refinement (f32 inner, f64 residuals)")

        def dispatch():
            return refined_solve(
                op.vmult, op_level.vmult, b, M_level, rel_tolerance=rel_tol,
                abs_tolerance=abs_tol, inner_reduction=inner_red,
                inner_solver=inner_solver, log=log)
    elif shards is not None:
        b_pad = sharded.pad(b)

        def dispatch():
            r = krylov_solve(solver_type, sharded.vmult, b_pad,
                             M=precon.vmult, max_iterations=max_it,
                             abs_tolerance=abs_tol, rel_tolerance=rel_tol,
                             reduction=sharded.reduction, **kwargs)
            r.x = sharded.unpad(r.x)
            return r
    else:
        def dispatch():
            return krylov_solve(solver_type, op.vmult, b, M=precon.vmult,
                                max_iterations=max_it, abs_tolerance=abs_tol,
                                rel_tolerance=rel_tol, **kwargs)

    synchronize(device)
    setup_time = time.perf_counter() - t_setup
    with span("setup.warmup"):
        result = dispatch()
    best_of = int(get_param(solver_p, "best of", 1))
    print_timing = get_param(params, "print timing", False)
    solve_time = 999.0
    if result.converged and (best_of > 1 or print_timing):
        with paused():  # the timed solves run untraced
            for _ in range(best_of):
                synchronize(device)
                t0 = time.perf_counter()
                r2 = dispatch()
                synchronize(device)
                solve_time = min(solve_time, time.perf_counter() - t0)
                if r2.n_iterations != result.n_iterations:
                    raise RuntimeError(
                        f"repeated solve took {r2.n_iterations} iterations, "
                        f"the first {result.n_iterations}")
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
        if tracer is not None and (shards is None or shards.rank == 0):
            tracer.print_table()
    table.add_value("aspect_ratio", mesh.max_aspect_ratio())
    solution = result.x if g is None else result.x + g.to(result.x.device)
    if get_param(params, "do output", False) and (shards is None
                                                  or shards.rank == 0):
        write_vtu(get_param(params, "output file", "multigrid.vtu"), dofs,
                  {"solution": solution.cpu().numpy()})
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
        "solution": solution,
        "preconditioner": precon,
        "table": table,
    }
