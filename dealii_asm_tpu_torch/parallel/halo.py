"""Explicit z-slab halo exchange for the lattice operators (PyTorch).

Counterpart of ``dealii_asm_tpu/parallel/halo.py``, with its design: the
grid's slowest axis (z) is split into equal slabs, one per rank; every
global 1D factor that contracts z (M̂_z/K̂_z of the separable Laplace,
G_z/G_zᵀ of the global FDM, Ev_z/Ed_z of the merged deformed form, P̂_z of
the transfers) is cut into per-rank banded blocks (``banded_stack``), and
each apply exchanges exactly ``hw`` boundary planes with each neighbour,
the reference's ghost export and import.  A z extent that does not divide
the rank count is zero-padded: pad planes carry zero rows and columns and
the free mask routes them through identity, so a solve on the padded vector
equals the unpadded one.

The JAX package runs one controller and ``jax.lax.ppermute`` inside
``shard_map``; here each rank runs the same code on its own slab and the
exchange is a ring of ``torch.distributed`` point-to-point ops
(``batch_isend_irecv``).  The ring is circular: on a non-periodic mesh the
first rank receives the last rank's planes, and its block carries zeros in
those columns (the block layout of ``banded_stack`` depends on the wrap).
A halo wider than a slab takes several hops.  On one rank the exchange is
the local concatenation, as in the JAX package.

The per-rank products are plain torch, as the JAX package's are XLA
einsums (no Pallas kernel reaches the sharded path): dense in-plane axis
products and the banded z blocks applied as one matrix product each.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.tensorops import axis_matmul, merged_coeff_qgrid, outer_grid
from .sharding import Shards, slab

# -- banded splitting of global factor matrices (host, NumPy) ----------------


def min_halo_width(A: np.ndarray, n_dev: int) -> int:
    """Minimal halo width so every shard's output rows read only its own
    input block ± hw (circular), given row/col splits into n_dev blocks."""
    R_out, R_in = A.shape
    assert R_out % n_dev == 0 and R_in % n_dev == 0, (A.shape, n_dev)
    r_out, r_in = R_out // n_dev, R_in // n_dev
    hw = 0
    for k in range(n_dev):
        rows = A[k * r_out: (k + 1) * r_out]
        nz = np.nonzero(np.any(rows != 0.0, axis=0))[0]
        lo, hi = k * r_in, (k + 1) * r_in
        for c in nz:
            if lo <= c < hi:
                continue
            d_lo = (lo - c) % R_in        # distance below the block (circular)
            d_hi = (c - (hi - 1)) % R_in  # distance above the block (circular)
            hw = max(hw, min(d_lo, d_hi))
    return hw


def banded_stack(A: np.ndarray, n_dev: int, hw: int | None = None):
    """Split a banded global matrix into per-shard local blocks.

    Returns (stack, hw): stack[k] is (r_out, r_in + 2*hw) acting on shard k's
    input block extended by hw circular halo rows on each side.  Asserts no
    nonzero entry of A is lost (hw covers the band, incl. periodic wrap).
    """
    R_out, R_in = A.shape
    r_out, r_in = R_out // n_dev, R_in // n_dev
    if hw is None:
        hw = min_halo_width(A, n_dev)
    assert n_dev == 1 or r_in + 2 * hw <= R_in, (
        f"halo {hw} overlaps itself: r_in={r_in}, R_in={R_in}")
    stack = np.zeros((n_dev, r_out, r_in + 2 * hw), A.dtype)
    for k in range(n_dev):
        cols = np.arange(k * r_in - hw, (k + 1) * r_in + hw) % R_in
        rows = A[k * r_out: (k + 1) * r_out]
        stack[k] = rows[:, cols]
        chk = rows.copy()
        chk[:, cols] = 0.0
        assert not np.any(chk), "banded_stack: matrix wider than halo window"
    return stack, hw


def pad_to(A: np.ndarray, n_rows: int, n_cols: int) -> np.ndarray:
    """Zero-pad a matrix to (n_rows, n_cols)."""
    out = np.zeros((n_rows, n_cols), A.dtype)
    out[: A.shape[0], : A.shape[1]] = A
    return out


def group_owners(anchors: np.ndarray, n_loc: int, n_dev: int) -> np.ndarray:
    """Shard owning each row-group, by the node shard of its anchor node."""
    return np.minimum(np.asarray(anchors) // n_loc, n_dev - 1).astype(int)


def grouped_row_layout(n_groups: int, owner: np.ndarray, n_dev: int):
    """Shard-aligned placement of row-groups (windows / cell-q blocks).

    Each group goes to its owner shard's contiguous region, padded so every
    shard holds G_max groups.  Returns (pos, G_max): pos[g] = padded group
    slot of group g.  Aligning group rows with the node slabs keeps the halo
    width at the operator's true bandwidth.
    """
    owner = np.asarray(owner)
    counts = np.bincount(owner, minlength=n_dev)
    G_max = int(counts.max())
    slot = np.zeros(n_dev, dtype=int)
    pos = np.zeros(n_groups, dtype=int)
    for g in range(n_groups):
        s = owner[g]
        pos[g] = s * G_max + slot[s]
        slot[s] += 1
    return pos, G_max


def place_grouped_rows(A: np.ndarray, gs: int, pos: np.ndarray, G_max: int,
                       n_dev: int) -> np.ndarray:
    """Scatter row-groups of A (n_groups·gs, N) into the padded layout."""
    out = np.zeros((n_dev * G_max * gs, A.shape[1]), A.dtype)
    for g, p_ in enumerate(pos):
        out[p_ * gs: (p_ + 1) * gs] = A[g * gs: (g + 1) * gs]
    return out


def place_grouped_vec(v: np.ndarray, gs: int, pos: np.ndarray, G_max: int,
                      n_dev: int, fill: float = 0.0) -> np.ndarray:
    out = np.full(n_dev * G_max * gs, fill, v.dtype)
    for g, p_ in enumerate(pos):
        out[p_ * gs: (p_ + 1) * gs] = v[g * gs: (g + 1) * gs]
    return out


def _ceil_to(n: int, q: int) -> int:
    return ((n + q - 1) // q) * q


# -- in-rank primitives ------------------------------------------------------


def halo_exchange(x: torch.Tensor, hw: int, shards: Shards) -> torch.Tensor:
    """x (n_loc, ...) extended along axis 0 by hw circular halo planes per
    side: the last hw planes of the rank below and the first hw of the rank
    above (``halo.py:133-156``).  A halo wider than the slab takes
    ceil(hw / n_loc) hops, each fetching the whole slab of the rank k
    below and above; one rank concatenates its own slab."""
    if hw == 0:
        return x
    n_loc, D, r = x.shape[0], shards.world, shards.rank
    if D == 1:
        reps = -(-hw // n_loc)
        ext = torch.cat([x] * (2 * reps + 1))
        return ext[reps * n_loc - hw: (reps + 1) * n_loc + hw]
    hops = -(-hw // n_loc)
    whole = hw >= n_loc
    ops, lo_parts, hi_parts = [], [], []
    for k in range(hops, 0, -1):
        up = (x if k > 1 or whole else x[-hw:]).contiguous()
        down = (x if k > 1 or whole else x[:hw]).contiguous()
        lo, hi = torch.empty_like(up), torch.empty_like(down)
        # every rank posts its ops in this order, so two ranks that are
        # each other's neighbour on both sides match them pairwise
        ops += [dist.P2POp(dist.isend, up, (r + k) % D, tag=2 * k),
                dist.P2POp(dist.irecv, lo, (r - k) % D, tag=2 * k),
                dist.P2POp(dist.isend, down, (r - k) % D, tag=2 * k + 1),
                dist.P2POp(dist.irecv, hi, (r + k) % D, tag=2 * k + 1)]
        lo_parts.append(lo)
        hi_parts.append(hi)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    shards.traffic["halo_bytes"] += sum(
        o.tensor.numel() * o.tensor.element_size() for o in ops
        if o.op is dist.isend)
    lo = torch.cat(lo_parts)            # from rank r − hops … r − 1
    hi = torch.cat(hi_parts[::-1])      # from rank r + 1 … r + hops
    return torch.cat([lo[lo.shape[0] - hw:], x, hi[:hw]])


def halo_matmul(x: torch.Tensor, M_loc: torch.Tensor, hw: int,
                shards: Shards) -> torch.Tensor:
    """y = M_loc @ x_ext along axis 0; x: (r_in, ...) local block, M_loc:
    (r_out, r_in + 2·hw)."""
    xe = halo_exchange(x, hw, shards)
    return (M_loc @ xe.reshape(xe.shape[0], -1)).reshape(
        (M_loc.shape[0],) + xe.shape[1:])


def _rounded(A, dtype) -> np.ndarray:
    """A host matrix as the level holds it: rounded to ``dtype`` and back to
    float64 (the JAX package reads its ``dtype`` tables back with
    ``np.asarray(..., np.float64)``)."""
    if isinstance(A, torch.Tensor):
        return A.to(dtype).double().cpu().numpy()
    return torch.as_tensor(np.asarray(A, np.float64)).to(dtype).double(
    ).numpy()


# -- sharded operator twins --------------------------------------------------


class ShardedLattice:
    """The rank's z-slab twin of a structured ``LaplaceOperator``
    (separable Cartesian or merged deformed) and, with ``asm``, of the
    global-FDM form of its ``ASMPreconditioner`` (``halo.py:184-485``).

    ``op`` and ``asm`` are host objects (built on any device; the port
    builds them on the CPU): their 1D tables are read, split into banded
    z blocks, and only this rank's blocks, slabs and the small replicated
    in-plane factors go to ``shards.device``.  Applies take and return the
    rank's slab of the padded vector, flat, of length ``n_local``;
    ``pad``/``unpad`` convert from and to the problem vector."""

    def __init__(self, op, asm, shards: Shards, dtype=None):
        if getattr(op, "compact", None):
            raise ValueError("the sharded operator takes the merged or "
                             "separable form, not a compact mapping type")
        self.shards = shards
        self.device = self.shards.device
        self.op = op
        self.asm = asm
        self.dtype = dtype or op.dtype
        self.dim = op.dim
        D, k = self.shards.world, self.shards.rank
        gz = tuple(op.grid_shape)  # (Nz, Ny, Nx)
        Nz_pad = _ceil_to(gz[0], D)
        self.grid_shape = gz
        self.grid_shape_pad = (Nz_pad,) + gz[1:]
        self.local_shape = (Nz_pad // D,) + gz[1:]
        self.n_padded = int(np.prod(self.grid_shape_pad))
        self.n_local = int(np.prod(self.local_shape))
        self.n_dofs = op.n_dofs
        self.plane = int(np.prod(gz[1:]))

        # free mask (x first): z padded, pad planes never free, the slab's
        free = [op.dofs.free_1d(d) > 0 for d in range(self.dim)]
        fz = np.zeros(Nz_pad, bool)
        fz[: gz[0]] = free[-1]
        n_loc = self.local_shape[0]
        free[-1] = fz[k * n_loc: (k + 1) * n_loc]
        self.free = outer_grid([torch.as_tensor(f, device=self.device)
                                for f in free])
        self.hw = {}
        if op.deformed:
            self._build_merged()
        else:
            self._build_separable()
        if asm is not None:
            self._build_fdm()

    # -- setup ----------------------------------------------------------------

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def _stack(self, name: str, A: np.ndarray) -> torch.Tensor:
        """This rank's banded block of the global z factor A; records its
        halo width under ``name``."""
        st, hw = banded_stack(A, self.shards.world)
        self.hw[name] = hw
        return self._tensor(st[self.shards.rank])

    def _build_separable(self):
        op, dz = self.op, self.dim - 1
        Nz_pad = self.grid_shape_pad[0]
        self._Mz = self._stack("Mz", pad_to(
            _rounded(op.M1d_global[dz], self.dtype), Nz_pad, Nz_pad))
        self._Kz = self._stack("Kz", pad_to(
            _rounded(op.K1d_global[dz], self.dtype), Nz_pad, Nz_pad))
        # replicated in-plane factors, per direction (x first)
        self._Mrest = [self._tensor(op.M1d_global[d])
                       for d in range(self.dim - 1)]
        self._Krest = [self._tensor(op.K1d_global[d])
                       for d in range(self.dim - 1)]

    def _zcell_layout(self, Cz: int):
        """Shard-aligned layout of the z-cell row groups: cell c anchors at
        node c·p and goes to the rank owning that node (``halo.py:248-
        262``).  Returns (pos, G_max)."""
        n_loc = self.local_shape[0]
        anchors = np.arange(Cz) * self.op.degree
        owner = group_owners(anchors, n_loc, self.shards.world)
        return grouped_row_layout(Cz, owner, self.shards.world)

    def _local_groups(self, c: torch.Tensor, gs: int, pos, G_max: int):
        """This rank's rows of ``c`` (groups of ``gs`` rows along axis 0)
        in the grouped layout, the empty slots zero."""
        k = self.shards.rank
        out = c.new_zeros((G_max * gs,) + c.shape[1:])
        for g, p_ in enumerate(pos):
            if k * G_max <= p_ < (k + 1) * G_max:
                s = p_ - k * G_max
                out[s * gs: (s + 1) * gs] = c[g * gs: (g + 1) * gs]
        return out.to(self.device)

    def _build_merged(self):
        op, dz, D = self.op, self.dim - 1, self.shards.world
        Nz_pad = self.grid_shape_pad[0]
        q = op.degree + 1
        Cz = op.dofs.mesh.n_cells[dz]
        pos, G_max = self._zcell_layout(Cz)
        Ev = place_grouped_rows(pad_to(_rounded(getattr(op, f"Ev{dz}"),
                                                self.dtype), Cz * q, Nz_pad),
                                q, pos, G_max, D)
        Ed = place_grouped_rows(pad_to(_rounded(getattr(op, f"Ed{dz}"),
                                                self.dtype), Cz * q, Nz_pad),
                                q, pos, G_max, D)
        self._Evz = self._stack("Evz", Ev)
        self._Edz = self._stack("Edz", Ed)
        self._Evzt = self._stack("Evzt", Ev.T)
        self._Edzt = self._stack("Edzt", Ed.T)
        rest = range(self.dim - 1)
        self._Ev_rest = [getattr(op, f"Ev{d}").to(self.device, self.dtype)
                         for d in rest]
        self._Ed_rest = [getattr(op, f"Ed{d}").to(self.device, self.dtype)
                         for d in rest]
        self._Evt_rest = [e.T.contiguous() for e in self._Ev_rest]
        self._Edt_rest = [e.T.contiguous() for e in self._Ed_rest]
        # coefficient q-grids: the z-q axis in the same grouped layout
        c6 = merged_coeff_qgrid(op.coeff6, op.tables.cells, q)
        self._coeff6 = tuple(self._local_groups(c.to(self.dtype), q, pos,
                                                G_max) for c in c6)

    def _build_fdm(self):
        asm, dz, D = self.asm, self.dim - 1, self.shards.world
        if asm.patch_type != "element" or asm.ras_masks is not None:
            raise ValueError(
                "the sharded FDM smoother takes element patches with a "
                "multiplicity weighting (the global-FDM form of the JAX "
                "package; not RAS, not vertex patches)")
        Nz_pad = self.grid_shape_pad[0]
        Gs, Gts, lams = asm.global_fdm
        m = asm.m
        Cz = asm.dofs.mesh.n_cells[dz]
        pos, G_max = self._zcell_layout(Cz)
        Gz = place_grouped_rows(pad_to(_rounded(Gs[dz], self.dtype), Cz * m,
                                       Nz_pad), m, pos, G_max, D)
        Gzt = place_grouped_rows(pad_to(_rounded(Gts[dz], self.dtype),
                                        Nz_pad, Cz * m).T,
                                 m, pos, G_max, D).T
        self._Gz = self._stack("Gz", Gz)
        self._Gzt = self._stack("Gzt", Gzt)
        rest = range(self.dim - 1)
        self._G_rest = [Gs[d].to(self.device, self.dtype) for d in rest]
        self._Gt_rest = [Gts[d].to(self.device, self.dtype) for d in rest]
        # z eigenvalue sums, pad slots 1 (their transform rows are zero)
        lz = place_grouped_vec(_rounded(lams[dz], self.dtype), m, pos,
                               G_max, D, fill=1.0)
        k = self.shards.rank
        denom = self._tensor(lz[k * G_max * m: (k + 1) * G_max * m]).reshape(
            (-1,) + (1,) * (self.dim - 1))
        for d in rest:
            shape = [1] * self.dim
            shape[self.dim - 1 - d] = lams[d].shape[0]
            denom = denom + lams[d].to(self.device, self.dtype).reshape(shape)
        self._denom = denom

    # -- pad / unpad ----------------------------------------------------------

    def pad(self, u: torch.Tensor, dtype=None) -> torch.Tensor:
        """Problem vector (n_dofs,) → this rank's slab of the padded vector,
        in ``dtype`` (the lattice's by default), on the rank's device."""
        u = u.to(self.device, dtype or self.dtype)
        return slab(u, self.shards, self.n_local)

    def unpad(self, y: torch.Tensor) -> torch.Tensor:
        """The ranks' slabs gathered (an ``all_gather``), pad planes cut."""
        return self.shards.all_gather(y)[: self.n_dofs]

    # -- rank-local cores ----------------------------------------------------

    def _hmm(self, x, M, name):
        return halo_matmul(x, M, self.hw[name], self.shards)

    def _separable_core(self, x):
        mm = axis_matmul
        if self.dim == 2:
            a = mm(x, self._Mrest[0], 1)
            kx = mm(x, self._Krest[0], 1)
            return self._hmm(a, self._Kz, "Kz") + self._hmm(kx, self._Mz,
                                                            "Mz")
        Mx, My = self._Mrest
        Kx, Ky = self._Krest
        a = mm(x, Mx, 2)
        b = mm(a, My, 1)
        t = mm(a, Ky, 1) + mm(mm(x, Kx, 2), My, 1)
        return self._hmm(b, self._Kz, "Kz") + self._hmm(t, self._Mz, "Mz")

    def _merged_core(self, x):
        mm, h = axis_matmul, self._hmm
        if self.dim == 2:
            a = mm(x, self._Ev_rest[0], 1)
            d1 = mm(x, self._Ed_rest[0], 1)
            gy = h(a, self._Edz, "Edz")
            gx = h(d1, self._Evz, "Evz")
            cxx, cyy, cxy = self._coeff6
            tx = cxx * gx + cxy * gy
            ty = cxy * gx + cyy * gy
            v = mm(h(ty, self._Edzt, "Edzt"), self._Evt_rest[0], 1)
            return v + mm(h(tx, self._Evzt, "Evzt"), self._Edt_rest[0], 1)
        Evx, Evy = self._Ev_rest
        Edx, Edy = self._Ed_rest
        Evxt, Evyt = self._Evt_rest
        Edxt, Edyt = self._Edt_rest
        a = mm(x, Evx, 2)
        d1 = mm(x, Edx, 2)
        b = mm(a, Evy, 1)
        c = mm(a, Edy, 1)
        e = mm(d1, Evy, 1)
        gz = h(b, self._Edz, "Edz")
        gy = h(c, self._Evz, "Evz")
        gx = h(e, self._Evz, "Evz")
        cxx, cyy, czz, cxy, cxz, cyz = self._coeff6
        tx = cxx * gx + cxy * gy + cxz * gz
        ty = cxy * gx + cyy * gy + cyz * gz
        tz = cxz * gx + cyz * gy + czz * gz
        w1 = h(tz, self._Edzt, "Edzt")
        w2 = h(ty, self._Evzt, "Evzt")
        w3 = h(tx, self._Evzt, "Evzt")
        r12 = mm(w1, Evyt, 1) + mm(w2, Edyt, 1)
        r3 = mm(w3, Evyt, 1)
        return mm(r12, Evxt, 2) + mm(r3, Edxt, 2)

    def _fdm_core(self, x):
        dim = self.dim
        t = self._hmm(x, self._Gz, "Gz")
        for d in range(dim - 1):
            t = axis_matmul(t, self._G_rest[d], dim - 1 - d)
        t = t / self._denom
        for d in range(dim - 1):
            t = axis_matmul(t, self._Gt_rest[d], dim - 1 - d)
        return self._hmm(t, self._Gzt, "Gzt")

    # -- applies on the rank's slab -------------------------------------------

    def vmult(self, u: torch.Tensor) -> torch.Tensor:
        """A·u on the slab; constrained and pad rows act as identity.
        Another input dtype is cast in and out, as ``LaplaceOperator``
        does."""
        if u.dtype != self.dtype:
            return self.vmult(u.to(self.dtype)).to(u.dtype)
        ug = u.reshape(self.local_shape)
        zero = torch.zeros((), dtype=u.dtype, device=u.device)
        u0 = torch.where(self.free, ug, zero)
        dst = (self._merged_core(u0) if self.op.deformed
               else self._separable_core(u0))
        return torch.where(self.free, dst, ug).reshape(-1)

    def smoother_vmult(self, r: torch.Tensor) -> torch.Tensor:
        """The FDM Schwarz apply on the slab: constraints and weights are
        folded into G, so constrained and pad rows come out 0."""
        if r.dtype != self.dtype:
            return self.smoother_vmult(r.to(self.dtype)).to(r.dtype)
        return self._fdm_core(r.reshape(self.local_shape)).reshape(-1)

    def ghost_planes(self, names) -> int:
        """The halo entries exchanged per apply: 2·hw·plane over the
        widest of the named factors (the benchmark's ghost column)."""
        return 2 * max(self.hw[n] for n in names) * self.plane


class ShardedTransfer:
    """The rank's twin of a structured ``TwoLevelTransfer``
    (``halo.py:488-644``): between two sharded levels (banded z blocks
    with halos both ways) or, with ``coarse_dofs`` in place of
    ``coarse_sl``, from a sharded fine level to a coarse level held whole
    on every rank.  There restriction is this slab's partial coarse vector
    summed by one ``all_reduce``, and prolongation reads the replicated
    coarse vector locally (the reference's coarse sub-communicator).
    Constrained rows and columns are zero in the 1D factors, which equals
    masking the coarse input and the fine output."""

    def __init__(self, transfer, fine_sl: ShardedLattice,
                 coarse_sl: ShardedLattice | None = None, coarse_dofs=None):
        self.fine_sl = fine_sl
        self.coarse_sl = coarse_sl
        self.shards = fine_sl.shards
        self.device = fine_sl.device
        self.dim = transfer.dim
        self.dtype = fine_sl.dtype
        self.replicated_coarse = coarse_sl is None
        D, k, dz = self.shards.world, self.shards.rank, self.dim - 1
        fine, coarse = transfer.fine, transfer.coarse
        masked = [fine.free_1d(d)[:, None] * transfer.P1d[d]
                  * coarse.free_1d(d)[None, :] for d in range(self.dim)]
        self._P_rest = [self._tensor(masked[d]) for d in range(dz)]
        self._PT_rest = [self._tensor(masked[d].T) for d in range(dz)]
        Nfz_pad = fine_sl.grid_shape_pad[0]
        Pz = _rounded(masked[dz], self.dtype)
        self.hw = {}
        if self.replicated_coarse:
            assert coarse_dofs is not None
            self.coarse_grid_shape = tuple(reversed(coarse_dofs.nodes_per_dim))
            # fine rows split over the ranks, coarse columns whole
            n_loc = Nfz_pad // D
            self._Pz = self._tensor(
                pad_to(Pz, Nfz_pad, Pz.shape[1])[k * n_loc: (k + 1) * n_loc])
        else:
            Ncz_pad = coarse_sl.grid_shape_pad[0]
            Pzp = pad_to(Pz, Nfz_pad, Ncz_pad)
            st, self.hw["P"] = banded_stack(Pzp, D)
            self._Pz = self._tensor(st[k])
            st, self.hw["Pt"] = banded_stack(Pzp.T, D)
            self._Pzt = self._tensor(st[k])

    def _tensor(self, a) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a), dtype=self.dtype,
                            device=self.device)

    def _inplane(self, t, mats):
        for d in range(self.dim - 1):
            t = axis_matmul(t, mats[d], self.dim - 1 - d)
        return t

    def prolongate(self, u_coarse: torch.Tensor) -> torch.Tensor:
        """Coarse (the rank's slab, or the whole replicated vector) → the
        fine slab."""
        if self.replicated_coarse:
            t = self._inplane(u_coarse.reshape(self.coarse_grid_shape),
                              self._P_rest)
            t = (self._Pz @ t.reshape(t.shape[0], -1)).reshape(
                (self._Pz.shape[0],) + t.shape[1:])
            return t.reshape(-1)
        t = self._inplane(u_coarse.reshape(self.coarse_sl.local_shape),
                          self._P_rest)
        return halo_matmul(t, self._Pz, self.hw["P"], self.shards).reshape(-1)

    def restrict(self, r_fine: torch.Tensor) -> torch.Tensor:
        """The fine slab → coarse (the rank's slab, or the whole vector on
        every rank)."""
        rf = r_fine.reshape(self.fine_sl.local_shape)
        if self.replicated_coarse:
            # this slab's partial coarse vector, then one all-reduce
            t = (self._Pz.T @ rf.reshape(rf.shape[0], -1)).reshape(
                (self._Pz.shape[1],) + rf.shape[1:])
            t = self.shards.all_reduce(t)
            return self._inplane(t, self._PT_rest).reshape(-1)
        t = self._inplane(rf, self._PT_rest)
        return halo_matmul(t, self._Pzt, self.hw["Pt"],
                           self.shards).reshape(-1)
