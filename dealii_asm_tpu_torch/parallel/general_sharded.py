"""Multi-device solves on unstructured meshes: the sharded ball (PyTorch).

Counterpart of ``dealii_asm_tpu/parallel/general_sharded.py`` and of
``_build_sharded_general`` (``dealii_asm_tpu/models/poisson.py:209-327``),
with their design:

- **cells** are split into contiguous index ranges, one per rank (the
  mesh's cell order follows the refinement tree);
- **DoFs** are owned by the lowest rank whose cells touch them and
  renumbered owner-blocked: the global vector is padded to ``world·B``
  entries (B the largest owned count), and a rank holds its ``(B,)`` slab;
- an apply gathers the slabs (one ``all_gather``, the JAX "v1 fetch"),
  builds the rank's local vector (own slab, then its ghosts) through a
  fetch table, runs the local cell work, keeps its own part and exchanges
  the ghost block: each rank's ``(Gmax,)`` block is gathered and added into
  the owners, the sources in ascending rank order (a fixed-order sum, so
  repeats are bit-identical);
- the finest level is sharded; every coarser level, and the intermediate
  split, is held whole on every rank and built by the single-device
  factory (the reference's shrinking coarse sub-communicator).

The JAX package runs one controller under ``shard_map``; the port runs one
process per device (gloo on the CPU, NCCL on cards), as
``parallel/halo.py`` does.  The local cell apply of the operator is kernel
F (``kernels/lanes_laplace.py``) on the rank's local tables, in float32 on
the level and float64 for the outer operator; 2D meshes and bfloat16
levels take the plain sum-factorised form with a fixed-order sum, as
``ops/laplace_general.py`` does.  The JAX double-single outer apply is a
TPU workaround the card does not need.  ``GeneralPartition``'s tables are
host NumPy, identical on every rank and equal to the JAX ones entry for
entry; a sharded object sends only its rank's rows to ``shards.device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..device import KERNEL_DTYPES
from ..fem.lagrange import shape_1d
from ..kernels.lanes_laplace import (lanes_laplace, lanes_tables,
                                     sumfac_cell_apply)
from ..ops.fixed_sum import FixedOrderSum
from ..precond.asm import patch_apply, register_patch_tables, work_dtype
from ..precond.fdm import FDMCollection
from .sharding import GroupReduction, Shards

HOST = "cpu"


@dataclass
class SlotTables:
    """Per-rank tables of one slot map (``general_sharded.py:100-167``):
    ``bounds`` (D+1,) the contiguous split of its rows; ``gather_tab`` (D,
    L, Smax) local slot of each entry (own slots first, then the rank's
    ghosts; pads and missing rows ``n_loc``, the zero slot); ``fetch_tab``
    (D, n_loc + 1) padded-vector slot of each local slot (``NB`` for the
    zero slot); ``recv_tab`` (D, D·Gmax) owned slot of each source rank's
    ghost entry (``B`` where it is not this rank's)."""

    bounds: np.ndarray
    Gmax: int
    n_loc: int
    gather_tab: np.ndarray
    fetch_tab: np.ndarray
    recv_tab: np.ndarray

    def local_rows(self, rank: int) -> np.ndarray:
        """(S_rank, L) local slots of the rank's rows."""
        S = int(self.bounds[rank + 1] - self.bounds[rank])
        return np.ascontiguousarray(self.gather_tab[rank, :, :S].T)


class GeneralPartition:
    """Cell-contiguous D-way partition with owner-blocked DoF renumbering
    (``general_sharded.py:46-173``).

    New numbering: DoFs sorted by (owner rank, old id); rank d owns the new
    ids [offsets[d], offsets[d+1]).  The padded vector has NB = D·B
    entries; slot d·B + i holds new id offsets[d] + i (i < n_own[d]), the
    pads are zero.  ``cells`` are the slot tables of the cell DoF map."""

    def __init__(self, dofs, n_dev: int):
        self.dofs = dofs
        self.n_dev = D = int(n_dev)
        cd = np.asarray(dofs.cell_dofs, np.int64)  # (C, L)
        C = cd.shape[0]
        n = self.n_dofs = dofs.n_dofs
        bounds = np.linspace(0, C, D + 1).astype(np.int64)
        self.cell_bounds = bounds
        # the lowest rank touching a DoF owns it: ranks assigned from the
        # last, so a lower rank overwrites (the cell ranges ascend)
        owner = np.full(n, D, np.int64)
        for d in range(D - 1, -1, -1):
            owner[cd[bounds[d]:bounds[d + 1]].reshape(-1)] = d
        if owner.max() >= D:
            raise ValueError("a DoF is touched by no cell")
        self.owner = owner
        order = np.argsort(owner * (n + 1) + np.arange(n), kind="stable")
        self.new_of_old = np.empty(n, np.int64)
        self.new_of_old[order] = np.arange(n)
        self.old_of_new = order
        self.n_own = np.bincount(owner, minlength=D)
        self.offsets = np.concatenate([[0], np.cumsum(self.n_own)])
        self.B = int(self.n_own.max())
        dev_of_new = owner[order]
        self.slot_of_new = (dev_of_new * self.B + np.arange(n)
                            - self.offsets[dev_of_new])
        self.NB = D * self.B
        self.pad_perm = np.full(self.NB, n, np.int64)
        self.pad_perm[self.slot_of_new] = self.old_of_new
        self.unpad_perm = self.slot_of_new[self.new_of_old]
        self.cells = self.slot_tables(cd)
        self.Gmax, self.n_loc = self.cells.Gmax, self.cells.n_loc

    def slot_tables(self, idx) -> SlotTables:
        """The gather, fetch and recv tables of an (S, L) map of
        old-numbering DoFs (entries >= n_dofs are pads, read as zero) over
        the balanced contiguous split of its rows."""
        idx = np.asarray(idx, np.int64)
        S, L = idx.shape
        D, B, NB, n = self.n_dev, self.B, self.NB, self.n_dofs
        bounds = np.linspace(0, S, D + 1).astype(np.int64)
        Smax = int((bounds[1:] - bounds[:-1]).max())
        slot_of_old = np.concatenate([self.slot_of_new[self.new_of_old],
                                      [NB]])
        idx_slot = slot_of_old[np.minimum(idx, n)]  # pads -> NB
        ghosts, gmax = [], 1
        for d in range(D):
            rows = idx_slot[bounds[d]:bounds[d + 1]]
            lo = d * B
            g = np.unique(rows[((rows < lo) | (rows >= lo + B))
                               & (rows < NB)])
            ghosts.append(g)
            gmax = max(gmax, len(g))
        n_loc = B + gmax
        gtab = np.full((D, L, Smax), n_loc, np.int64)
        for d in range(D):
            rows = idx_slot[bounds[d]:bounds[d + 1]]
            lo = d * B
            local = np.where(
                (rows >= lo) & (rows < lo + B), rows - lo,
                np.where(rows >= NB, n_loc,
                         B + np.searchsorted(ghosts[d], rows)))
            gtab[d, :, :rows.shape[0]] = local.T
        ftab = np.full((D, n_loc + 1), NB, np.int64)
        for d in range(D):
            ftab[d, :B] = d * B + np.arange(B)
            ftab[d, B:B + len(ghosts[d])] = ghosts[d]
        rtab = np.full((D, D * gmax), B, np.int64)
        for src in range(D):
            g = ghosts[src]
            own_dev = g // B
            own_idx = g - own_dev * B
            for dst in range(D):
                sel = own_dev == dst
                rtab[dst, src * gmax + np.nonzero(sel)[0]] = own_idx[sel]
        return SlotTables(bounds, gmax, n_loc, gtab, ftab, rtab)

    def pad(self, u, rank: int | None = None) -> torch.Tensor:
        """(n,) old numbering → the (NB,) padded owner-blocked vector, or
        with ``rank`` that rank's (B,) slab of it."""
        u = torch.as_tensor(u)
        perm = self.pad_perm if rank is None else \
            self.pad_perm[rank * self.B:(rank + 1) * self.B]
        up = torch.cat([u, u.new_zeros(1)])
        return up[torch.as_tensor(perm, device=u.device)]

    def unpad(self, ub: torch.Tensor) -> torch.Tensor:
        """(NB,) padded owner-blocked → (n,) old numbering."""
        return ub[torch.as_tensor(self.unpad_perm, device=ub.device)]


class _RankPart:
    """A rank's view of one ``SlotTables`` on its device: the fetch of its
    local vector from the gathered slabs and the ghost exchange back."""

    def __init__(self, part: GeneralPartition, tabs: SlotTables,
                 shards: Shards):
        r, dev = shards.rank, shards.device
        self.shards, self.B, self.Gmax = shards, part.B, tabs.Gmax
        self.n_loc = tabs.n_loc
        self.rows = tabs.local_rows(r)  # (S_r, L) host
        self.index = torch.as_tensor(self.rows, device=dev)
        self.fetch = torch.as_tensor(tabs.fetch_tab[r], device=dev)
        # the ghosts sent here, in ascending source rank: a fixed order
        self.recv = FixedOrderSum(torch.as_tensor(tabs.recv_tab[r],
                                                  device=dev), part.B)
        self.scatter = None  # FixedOrderSum of the rows, built on demand

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's (n_loc + 1,) local vector (own slab, ghosts, the zero
        slot) from its slab ``x``: one ``all_gather``."""
        full = self.shards.all_gather(x)
        return torch.cat([full, full.new_zeros(1)])[self.fetch]

    def sum_rows(self, values: torch.Tensor) -> torch.Tensor:
        """(n_loc,) Σ of the (S_r, L) row values into their local slots, in
        a fixed order (pads dropped)."""
        if self.scatter is None:
            self.scatter = FixedOrderSum(self.index, self.n_loc)
        return self.scatter(values)

    def exchange(self, partv: torch.Tensor) -> torch.Tensor:
        """(B,) owned result: the own part of the (n_loc,) local sums plus
        every rank's ghost block summed into its owners (one
        ``all_gather``)."""
        ghost = partv[self.B:self.B + self.Gmax].contiguous()
        gall = self.shards.all_gather(ghost)
        return partv[:self.B] + self.recv(gall)


class _Slabs:
    """pad/unpad of the partition for one rank (``halo.py``'s layout:
    ``pad`` gives the rank's slab, ``unpad`` gathers every slab)."""

    def _init_slabs(self, part: GeneralPartition, shards: Shards, dtype):
        self.part, self.shards, self.dtype = part, shards, dtype
        self.device, self.rank = shards.device, shards.rank
        self.n_local, self.n_dofs = part.B, part.n_dofs
        self._unpad = torch.as_tensor(part.unpad_perm, device=self.device)

    def pad(self, u: torch.Tensor, dtype=None) -> torch.Tensor:
        """(n,) problem vector → this rank's (B,) slab, in ``dtype`` (the
        object's by default), on the rank's device."""
        return self.part.pad(torch.as_tensor(u).cpu(), self.rank).to(
            self.device, dtype or self.dtype)

    def unpad(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' slabs gathered (one ``all_gather``), renumbered to
        the problem's (n,) vector."""
        return self.shards.all_gather(y)[self._unpad]


class ShardedGeneralOperator(_Slabs):
    """The rank's twin of a ``GeneralLaplaceOperator``
    (``general_sharded.py:176-280``), in ``dtype`` (the host operator's by
    default; its float64 coefficients are cast, as the single-device
    operator packs them in float64 and casts).  ``op`` is a host operator:
    the rank's slice of its (C, 6, Q) coefficients and its local cell table
    go to ``shards.device``, no cell padded.  The local cell apply is kernel
    F on a CUDA tensor (3D, float32 or float64), over a local vector whose
    held slots are all free, so F computes the plain cell sum and the
    constraints stay outside, as in the JAX code; 2D and bfloat16 take the
    plain form."""

    def __init__(self, op, part: GeneralPartition, shards: Shards,
                 dtype=None):
        dtype = dtype or op.dtype
        self._init_slabs(part, shards, dtype)
        self.dim, self.degree = op.dim, op.degree
        r = shards.rank
        self.rp = _RankPart(part, part.cells, shards)
        lo, hi = part.cell_bounds[r], part.cell_bounds[r + 1]
        coeff = op.coeff6[lo:hi].to(self.device, dtype).contiguous()
        s = shape_1d(self.degree, self.degree + 1)
        shape_host = torch.tensor(np.stack([s.N, s.D, s.D, s.D]),
                                  dtype=dtype)
        self.shape = shape_host.to(self.device)
        self.kernel = self.dim == 3 and dtype in KERNEL_DTYPES
        # the local vector holds real DoFs only: every slot is "free"
        self.tables = lanes_tables(self.rp.rows, np.zeros(self.rp.n_loc,
                                                          bool),
                                   coeff, self.shape, shape_host,
                                   self.degree)
        self.constrained = self.pad(~op.tables.free.cpu(), torch.bool)
        # constrained rows and the slab's pads read as zero: the pads, which
        # no cell holds, then give zero, as the JAX scatter-add does
        self.zero_in = self.constrained | ~self.pad(
            torch.ones(part.n_dofs, dtype=torch.bool), torch.bool)

    def _local_apply(self, local: torch.Tensor) -> torch.Tensor:
        """(n_loc,) Σ_c P_cᵀ A_c P_c of the local vector."""
        if self.kernel:
            return lanes_laplace(local, self.tables)
        m = self.degree + 1
        W = local[self.rp.index].reshape((-1,) + (m,) * self.dim)
        cells = sumfac_cell_apply(W, self.tables.coeff, self.shape)
        return self.rp.sum_rows(cells.reshape(W.shape[0], -1))

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u on the rank's slab; constrained rows act as identity.
        Another input dtype is cast in and out."""
        if u.dtype != self.dtype:
            return self.vmult(u.to(self.dtype)).to(u.dtype)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        u0 = torch.where(self.zero_in, zero, u)
        local = self.rp.local(u0)[:self.rp.n_loc]
        own = self.rp.exchange(self._local_apply(local))
        return torch.where(self.constrained, u, own)


class ShardedGeneralASM(nn.Module, _Slabs):
    """The rank's twin of an element-patch ``GeneralASMPreconditioner``
    (``general_sharded.py:283-370``): the rank's range of patches (its
    slice of the FDM collection's ``ids`` and of the RAS mask), the weights
    in the blocked layout, the port's per-patch FDM (``patch_apply``), a
    fixed-order local sum and the operator's ghost exchange."""

    def __init__(self, asm, part: GeneralPartition, shards: Shards):
        nn.Module.__init__(self)
        self._init_slabs(part, shards, asm.dtype)
        self.dim, self.m = asm.dim, asm.m
        self.weighting_type = asm.weighting_type
        self.is_symmetric = asm.is_symmetric
        tabs = part.slot_tables(asm.patch_idx.cpu().numpy())
        self.rp = _RankPart(part, tabs, shards)
        lo, hi = tabs.bounds[shards.rank], tabs.bounds[shards.rank + 1]
        coll = asm.collection
        register_patch_tables(self, FDMCollection(
            coll.eigvecs, coll.eigvals, np.asarray(coll.ids)[lo:hi]))
        self.ras_mask = (None if asm.ras_mask is None else
                         asm.ras_mask[lo:hi].to(self.device))
        self.weights = self.pad(asm.weights.cpu())

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        dt = work_dtype(self.dtype, src)
        x = src.to(dt)
        w = self.weights.to(dt)
        if self.weighting_type in ("pre", "symm"):
            x = x * w
        W = self.rp.local(x)[self.rp.index].reshape(
            (-1,) + (self.m,) * self.dim)
        y = patch_apply(self, W, dt)
        if self.ras_mask is not None:
            y = y.reshape(self.ras_mask.shape) * self.ras_mask.to(dt)
        dst = self.rp.exchange(self.rp.sum_rows(y))
        if self.weighting_type in ("post", "symm"):
            dst = dst * w
        return dst.to(src.dtype)


class ShardedGeneralTransfer(_Slabs):
    """The sharded-fine, replicated-coarse junction of a
    ``GeneralTwoLevelTransfer`` (``general_sharded.py:373-455``), h or p,
    2D or 3D: the rank interpolates its rows of the fine lattice from the
    whole coarse vector, and restriction sums the ranks' partial coarse
    vectors in one ``all_reduce``.  ``tr`` is a host transfer."""

    def __init__(self, tr, part: GeneralPartition, shards: Shards):
        self._init_slabs(part, shards, tr.dtype)
        self.tr, dev = tr, self.device
        tabs = part.slot_tables(tr.fine_lat.cpu().numpy())
        self.rp = _RankPart(part, tabs, shards)
        lo, hi = tabs.bounds[shards.rank], tabs.bounds[shards.rank + 1]
        ccd = tr.coarse_cd[lo:hi].to(dev)
        self.coarse_cd = ccd
        self._to_coarse = FixedOrderSum(ccd, tr.n_coarse)
        self.T1 = tr.T1.to(dev)
        self.coarse_free = tr.coarse_free.to(dev)
        self.inv_valence = self.pad(tr.fine_inv_valence.cpu())
        self.fine_free = self.pad(tr.fine_free.cpu(), torch.bool)

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        """Whole coarse (nc,) → the rank's fine slab."""
        zero = torch.zeros((), dtype=u_coarse.dtype, device=self.device)
        u = torch.where(self.coarse_free, u_coarse, zero)
        vf = self.tr._tensor_apply(u[self.coarse_cd], self.T1)
        out = self.rp.exchange(self.rp.sum_rows(vf)) * self.inv_valence
        return torch.where(self.fine_free, out, zero)

    def restrict(self, r_fine: torch.Tensor) -> torch.Tensor:
        """The rank's fine slab → the whole coarse vector on every rank."""
        zero = torch.zeros((), dtype=r_fine.dtype, device=self.device)
        r = torch.where(self.fine_free, r_fine, zero) * self.inv_valence
        W = self.rp.local(r)[self.rp.index]
        vc = self._to_coarse(self.tr._tensor_apply(W, self.T1.T))
        vc = self.shards.all_reduce(vc)
        return torch.where(self.coarse_free, vc, zero)


def _padded_b0(part: GeneralPartition, rank: int) -> torch.Tensor:
    """The single-device eigenvalue start vector (i%11 over n_dofs, mean
    removed, constrained rows 0), this rank's slab of it, float64 (as
    ``parallel/driver.py::_padded_b0``)."""
    from ..solvers.chebyshev import eig_initial_guess

    dofs = part.dofs
    return part.pad(eig_initial_guess(dofs.n_dofs, dofs.boundary_mask,
                                      device=HOST), rank)


def build_sharded_general(precon_p: dict, family, fe_degree: int, log,
                          dtype, outer_op, shards: Shards):
    """The sharded twin of the JAX ``_build_sharded_general``
    (``dealii_asm_tpu/models/poisson.py:209-327``): the finest level a
    ``ShardedGeneralOperator`` in ``dtype`` with Chebyshev around a
    ``ShardedGeneralASM`` (element-centric FDM overlap 1 only) and a
    ``ShardedGeneralTransfer`` below it; every coarser level, and the
    intermediate split, built whole on the rank's device by the
    single-device factory.  ``outer_op`` is ``run_config``'s host float64
    operator; the outer Krylov loop runs over its ``ShardedGeneralOperator``.

    As in the JAX function, the fine Chebyshev takes only the degree, the
    polynomial type and the padded start vector (every other setting keeps
    the class default), and "n coarse cycles" is not passed (ROADMAP
    queue 3).  Returns a ``parallel/driver.py::ShardedMGSolve``."""
    from ..models.poisson import mg_level_layout
    from ..precond.asm_general import GeneralASMPreconditioner
    from ..precond.factory import create_system_preconditioner
    from ..precond.multigrid import Multigrid
    from ..solvers.chebyshev import ChebyshevPreconditioner
    from ..utils.config import get_child, get_param
    from .driver import ShardedMGSolve

    device = shards.device
    levels, intermediate = mg_level_layout(precon_p, family, fe_degree, log)
    top = len(levels) - 1
    if top < 1 or intermediate >= top:
        raise ValueError("the sharded unstructured fine level needs a "
                         "level below it and above the intermediate split")
    smoother_p = get_child(precon_p, "mg smoother")
    inner_p = get_child(smoother_p, "preconditioner")
    if (inner_p.get("type") != "FDM"
            or int(get_param(inner_p, "n overlap", 1)) != 1
            or not get_param(inner_p, "element centric", True)):
        raise ValueError("sharded unstructured fine smoother supports "
                         "element-centric FDM overlap 1")
    dofs_list = [family.dofs_at(r, d) for r, d in levels]
    # the fine level's host operator is the outer one: its float64
    # coefficients, cast, are the level's
    ops = [family.operator(d, dtype, device) for d in dofs_list[:-1]]
    for dofs in dofs_list:
        log(f"- Create operator:\n  - n cells:          "
            f"{dofs.mesh.n_cells_total}\n  - n dofs:           "
            f"{dofs.n_dofs}\n")
    transfers = [family.transfer(dofs_list[i], dofs_list[i + 1], dtype,
                                 device if i + 2 < len(levels) else HOST)
                 for i in range(len(levels) - 1)]
    coarse_p = get_child(precon_p, "mg coarse grid solver")
    one_sided = get_param(precon_p, "one-sided v-cycle", False)

    fine_dofs = dofs_list[-1]
    part = GeneralPartition(fine_dofs, shards.world)
    log(f" - n devices:  {shards.world} (sharded unstructured fine level; "
        f"B={part.B}, ghosts<={part.Gmax})")
    sop64 = ShardedGeneralOperator(outer_op, part, shards)
    sop = (sop64 if dtype == outer_op.dtype else
           ShardedGeneralOperator(outer_op, part, shards, dtype))
    asm = GeneralASMPreconditioner(
        fine_dofs, n_overlap=1,
        weighting_type=get_param(inner_p, "weighting type", "symm"),
        dtype=dtype, device=HOST)
    sasm = ShardedGeneralASM(asm, part, shards)
    del asm
    stransfer = ShardedGeneralTransfer(transfers[-1], part, shards)
    reduction = GroupReduction(shards)
    log("- Setting up smoother on the sharded fine level\n")
    cheb = ChebyshevPreconditioner(
        sop.vmult, sasm.vmult, part.B,
        degree=int(get_param(smoother_p, "degree", 1)),
        polynomial_type=get_param(smoother_p, "polynomial type", "1st kind"),
        eig_b0=_padded_b0(part, shards.rank).to(device),
        reduction=reduction, device=device)

    def make_smoother(level: int, p: dict):
        log(f"- Setting up smoother on level {level}\n")
        return create_system_preconditioner(ops[level], p, log)

    interm_p = get_child(precon_p, "mg intermediate smoother")
    if not interm_p.get("type"):
        interm_p = smoother_p
    log("- Setting up coarse-grid solver on level 0\n")
    coarse = create_system_preconditioner(ops[0], coarse_p, log)
    if intermediate > 0:
        inner = Multigrid(ops[:intermediate + 1],
                          [make_smoother(l, interm_p)
                           for l in range(1, intermediate + 1)],
                          transfers[:intermediate], coarse.vmult,
                          one_sided=one_sided)
        mg = Multigrid(ops[intermediate:] + [sop.vmult],
                       [make_smoother(l, smoother_p)
                        for l in range(intermediate + 1, top)] + [cheb],
                       transfers[intermediate:-1] + [stransfer], inner.vmult,
                       one_sided=one_sided)
    else:
        mg = Multigrid(ops + [sop.vmult],
                       [make_smoother(l, smoother_p)
                        for l in range(1, top)] + [cheb],
                       transfers[:-1] + [stransfer], coarse.vmult,
                       one_sided=one_sided)
    return ShardedMGSolve(mg, sop64, reduction)
