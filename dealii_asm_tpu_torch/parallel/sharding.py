"""Ranks, padded slabs and global reductions of the sharded solve (PyTorch).

Counterpart of ``dealii_asm_tpu/parallel/sharding.py``.  The JAX package
runs one controller over a 1D device mesh (``make_mesh`` :26) and places
arrays with ``NamedSharding``; the port runs SPMD: one process per device,
joined by ``torch.distributed``, each holding its own z-slab of every
sharded vector.  ``Shards`` names a rank's place in the group and its
device; ``process_shards`` takes the group that is already initialised, or
initialises one under ``torchrun`` (NCCL on CUDA, gloo on the CPU), and
otherwise raises with the command to use.  ``GroupReduction`` gives the
solvers their inner products: the local float64 product, then one
``all_reduce``.

``HaloSolverStep`` and ``sharded_solver_step`` (:86-156, ``mode="halo"``)
build the one-step dryrun problem over ``parallel/halo.py``.  The JAX
module's ``ShardedPoissonStep`` (:51-84, ``mode="spmd"``) checks the halo
path with XLA's automatic SPMD partitioner, which has no PyTorch
counterpart; the port's CPU tests hold its halo path against the JAX
package's at the same rank count instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..solvers.krylov import Reduction

TORCHRUN = ("torchrun --nproc-per-node {n} -m dealii_asm_tpu_torch cfg.json"
            " --device {device}")


def _no_traffic() -> dict:
    return {"all_reduce": 0, "all_gather": 0, "halo_bytes": 0}


@dataclass(frozen=True)
class Shards:
    """A rank's place among the ``world`` ranks of the default process
    group and its device.  ``traffic`` counts its collectives: calls of
    ``all_reduce`` and ``all_gather`` and the bytes its halo exchanges send
    (read by the dryrun and ``chip_smoke.py``)."""

    rank: int
    world: int
    device: torch.device
    traffic: dict = field(default_factory=_no_traffic, compare=False)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (in place)."""
        dist.all_reduce(t)
        self.traffic["all_reduce"] += 1
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' equal-sized tensors concatenated along axis 0."""
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t.contiguous())
        self.traffic["all_gather"] += 1
        return torch.cat(parts)

    def reset_traffic(self) -> None:
        self.traffic.update(_no_traffic())


def _under_torchrun() -> bool:
    return all(k in os.environ for k in
               ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"))


def launched_world_size() -> int | None:
    """The world size of an initialised group or of a torchrun launch, else
    None."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    if _under_torchrun():
        return int(os.environ["WORLD_SIZE"])
    return None


def process_shards(n_devices: int, device) -> Shards:
    """This rank's ``Shards`` in a group of ``n_devices`` ranks.  Takes the
    initialised default group, or initialises it from a torchrun
    environment (NCCL on CUDA, gloo on the CPU); raises with the torchrun
    command otherwise, and when the world size is not ``n_devices``.  On
    CUDA each rank takes ``cuda:LOCAL_RANK``."""
    if not (dist.is_available() and dist.is_initialized()
            or _under_torchrun()):
        raise RuntimeError(
            f"'n devices' = {n_devices} runs one process per device: "
            "launch it as " + TORCHRUN.format(
                n=n_devices, device=torch.device(device).type)
            + " (or initialise torch.distributed first)")
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_devices:
        raise RuntimeError(f"'n devices' = {n_devices}, but the process "
                           f"group has {world} ranks")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    return Shards(rank, world, dev)


class GroupReduction(Reduction):
    """The solvers' inner products over the ranks' slabs: each rank's
    float64 product, summed by one ``all_reduce`` (a norm is the square
    root of the summed squares).  The sum runs in another order than one
    device's ``torch.dot``, as the JAX package's dots on sharded arrays
    do."""

    def __init__(self, shards: Shards):
        self.shards = shards
        self.world, self.rank = shards.world, shards.rank

    def dot_t(self, a, b):
        return self.shards.all_reduce(super().dot_t(a, b).reshape(1))[0]

    def norm_t(self, a):
        return torch.sqrt(self.dot_t(a, a))

    def dots(self, V, w):
        return self.shards.all_reduce(V @ w)


def slab(u: torch.Tensor, shards: Shards, n_local: int) -> torch.Tensor:
    """Rank's slab of the zero-padded vector: entries [rank·n_local,
    (rank + 1)·n_local) of ``u`` extended by zeros (the pad planes)."""
    lo = shards.rank * n_local
    part = u[lo:lo + n_local]
    if part.shape[0] < n_local:
        part = torch.cat([part, part.new_zeros(n_local - part.shape[0])])
    return part


class HaloSolverStep:
    """One smoothed Richardson step x ← x + cheb(b − A x) on the sharded
    operator and FDM smoother (``sharding.py:86-113``): Chebyshev of
    degree 2 with fixed eigenvalues (1.0, 1.2), no estimate."""

    def __init__(self, sl):
        from ..solvers.chebyshev import (ChebyshevPreconditioner,
                                         EigenvalueInfo)

        self.sl = sl
        self.cheb = ChebyshevPreconditioner(
            sl.vmult, sl.smoother_vmult, sl.n_local, degree=2,
            eigenvalues=EigenvalueInfo(1.0, 1.2, 0), device=sl.device)

    def step(self, x, b):
        return x + self.cheb.vmult(b - self.sl.vmult(x))


def sharded_solver_step(shards: Shards, dtype=torch.float32):
    """(step, x, b): the Dirichlet box of 4 × 4 × 2·world cells at Q2,
    whose z node count does not divide the rank count (the pad planes), its
    ``HaloSolverStep`` and this rank's slabs of x = 0 and a standard normal
    b from ``default_rng(0)`` (the JAX ``mode="halo"`` at its defaults,
    ``sharding.py:116-156``).  The host tables are built on the CPU; the
    rank keeps its slabs on its device."""
    from ..fem.dofs import DofHandler
    from ..mesh.grid import StructuredMesh
    from ..ops.laplace import LaplaceOperator
    from ..precond.asm import ASMPreconditioner
    from .halo import ShardedLattice

    dofs = DofHandler(StructuredMesh(3, (4, 4, 2 * shards.world)), 2)
    op = LaplaceOperator(dofs, dtype=dtype, device="cpu")
    asm = ASMPreconditioner(dofs, n_overlap=1, weighting_type="symm",
                            dtype=dtype, device="cpu")
    sl = ShardedLattice(op, asm, shards)
    rng = np.random.default_rng(0)
    b = sl.pad(torch.as_tensor(rng.standard_normal(dofs.n_dofs)))
    x = sl.pad(torch.zeros(dofs.n_dofs))
    return HaloSolverStep(sl), x, b
