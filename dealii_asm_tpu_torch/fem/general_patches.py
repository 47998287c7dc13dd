"""Overlapping element and vertex-star patches on unstructured meshes (NumPy).

Carried over from ``dealii_asm_tpu/fem/general_patches.py``: the patch of a
cell (element, overlap o) or of an interior vertex (vertex star) reaches
into neighbouring cells whose local frames may be rotated (the ball).  Each
(cell, face) with a neighbour carries an affine lattice map into the
neighbour's frame (``_face_map_arrays`` :79: a signed permutation A and an
offset b, x_nbr = A x + b in unit-cell coordinates); a slot beyond the own
cell is resolved by composing the face maps axis by axis
(``_walk_patch_indices`` :158), vectorised over patches.  The tables are
(P, m^dim) int32 DoF ids, local slots x fastest, with the pad index
``n_dofs`` for slots outside the mesh and for constrained DoFs.
"""

from __future__ import annotations

import numpy as np

from ..mesh.unstructured import VERTEX_COORDS, face_vertices


def _face_map_arrays(mesh):
    """(nbr (C, F) neighbour id or -1, A (C, F, dim, dim), b (C, F, dim)):
    the affine lattice map x_nbr = A x + b across each face."""
    dim = mesh.dim
    fv = face_vertices(dim)
    vc = VERTEX_COORDS[dim]
    nbr = np.asarray(mesh.face_neighbors())
    nfc = np.asarray(mesh.face_neighbor_faces())
    C, F = nbr.shape
    Aall = np.zeros((C, F, dim, dim), dtype=np.int64)
    ball = np.zeros((C, F, dim), dtype=np.int64)
    for f in range(F):
        sel = np.where(nbr[:, f] >= 0)[0]
        if sel.size == 0:
            continue
        n = nbr[sel, f]
        gf = nfc[sel, f]
        d, s = f // 2, f % 2
        fvf = fv[f]
        g = mesh.cells[sel][:, fvf]
        # the neighbour's local index of each shared vertex
        loc = np.argmax(mesh.cells[n][:, None, :] == g[:, :, None], axis=2)
        x0 = vc[fvf[0]].astype(np.int64)
        y0 = vc[loc[:, 0]].astype(np.int64)
        A = np.zeros((sel.size, dim, dim), dtype=np.int64)
        for a in range(dim):
            if a == d:
                continue
            target = x0.copy()
            target[a] = 1 - target[a]
            j = next(j for j in range(len(fvf))
                     if (vc[fvf[j]] == target).all())
            A[:, :, a] = (vc[loc[:, j]].astype(np.int64) - y0) * (
                1 - 2 * int(x0[a]))
        # the depth axis: from the neighbour's matching face inwards
        A[np.arange(sel.size), gf // 2, d] = (1 - 2 * (gf % 2)) * (1 - 2 * s) * -1
        ball[sel, f] = y0 - np.einsum("cij,j->ci", A, x0)
        Aall[sel, f] = A
    return nbr, Aall, ball


def _walk_patch_indices(dofs, nall, Aall, ball, anchors, lat, off):
    """(P, L) int64 DoF ids of the slots ``lat`` (L, dim) (node coordinates
    in each anchor's frame, possibly outside [0, p]) with per-axis cell
    offsets ``off`` (L, dim) in {-1, 0, 1}; pad n_dofs where a walk leaves
    the mesh.  The slots of one offset pattern share a walk, composed for
    all patches at once; every node is then A·coords + p·b exactly."""
    dim = dofs.mesh.dim
    p = dofs.degree
    n = dofs.n_dofs
    cd = np.asarray(dofs.cell_dofs, dtype=np.int64)
    stride = np.array([(p + 1) ** d for d in range(dim)], dtype=np.int64)
    P = len(anchors)
    out = np.full((P, lat.shape[0]), n, dtype=np.int64)
    rows = np.arange(P)
    pats, inv = np.unique(off, axis=0, return_inverse=True)
    inv = np.asarray(inv).reshape(-1)
    for pi, pat in enumerate(pats):
        slots = np.where(inv == pi)[0]
        if (pat == 0).all():
            flat = (lat[slots] * stride).sum(axis=1)
            out[:, slots] = cd[anchors[:, None], flat[None, :]]
            continue
        cur = anchors.copy()
        A = np.broadcast_to(np.eye(dim, dtype=np.int64), (P, dim, dim)).copy()
        b = np.zeros((P, dim), dtype=np.int64)
        ok = np.ones(P, dtype=bool)
        for d2 in range(dim):
            if pat[d2] == 0:
                continue
            e = A[:, :, d2]
            axis = np.argmax(np.abs(e), axis=1)
            sign = e[rows, axis] * pat[d2]
            face = 2 * axis + (sign > 0)
            nxt = nall[cur, face]
            step_ok = ok & (nxt >= 0)
            A2 = Aall[cur, face]
            b2 = ball[cur, face]
            A = np.where(step_ok[:, None, None], A2 @ A, A)
            b = np.where(step_ok[:, None], np.einsum("cij,cj->ci", A2, b) + b2,
                         b)
            cur = np.where(step_ok, nxt, cur)
            ok = step_ok
        node = np.einsum("cij,lj->cli", A, lat[slots]) + p * b[:, None, :]
        valid = (ok[:, None] & (node >= 0).all(axis=2)
                 & (node <= p).all(axis=2))
        flat = np.clip((node * stride).sum(axis=2), 0, cd.shape[1] - 1)
        out[:, slots] = np.where(valid, cd[cur[:, None], flat], n)
    return out


def _mask_constrained(dofs, idx: np.ndarray) -> np.ndarray:
    n = dofs.n_dofs
    mask = dofs.boundary_mask
    return np.where((idx < n) & ~mask[np.clip(idx, 0, n - 1)], idx,
                    n).astype(np.int32)


def general_element_patch_indices(dofs, n_overlap: int) -> np.ndarray:
    """(C, m^dim) int32 element-patch DoF ids at overlap o, m = p − 1 + 2·o
    (``general_patches.py:124``)."""
    dim = dofs.mesh.dim
    p = dofs.degree
    o = n_overlap
    m = p - 1 + 2 * o
    nall, Aall, ball = _face_map_arrays(dofs.mesh)
    lat = np.stack([np.arange(m ** dim) // m ** d % m for d in range(dim)],
                   axis=1) - (o - 1)
    off = np.where(lat < 0, -1, np.where(lat > p, 1, 0))
    out = _walk_patch_indices(dofs, nall, Aall, ball,
                              np.arange(dofs.mesh.n_cells_total,
                                        dtype=np.int64), lat, off)
    return _mask_constrained(dofs, out)


def general_vertex_patch_indices(dofs):
    """Vertex-star patches of the interior vertices (``general_patches.py:
    216-288``): the (2p − 1)^dim interior nodes of the 2^dim cells around
    the vertex, in the frame of its anchor (the lowest-id adjacent cell).

    Returns (idx (P, (2p − 1)^dim) int32, pad n_dofs; extents (P, dim, 2):
    per anchor-frame axis the widths of the cell on the t < 0 side and on
    the t > 0 side, the operands of the 1D vertex-patch matrices)."""
    mesh = dofs.mesh
    dim = mesh.dim
    p = dofs.degree
    C = mesh.n_cells_total
    n = dofs.n_dofs
    m = 2 * p - 1
    nall, Aall, ball = _face_map_arrays(mesh)
    vc = VERTEX_COORDS[dim]

    bnd = mesh.boundary_vertex_mask()
    anchor = np.full(mesh.n_vertices, C, dtype=np.int64)
    np.minimum.at(anchor, mesh.cells.reshape(-1),
                  np.repeat(np.arange(C), 2 ** dim))
    vids = np.where(~bnd & (anchor < C))[0]
    corner = np.argmax(mesh.cells[anchor[vids]] == vids[:, None], axis=1)
    anchors_all = anchor[vids]
    ext_c = np.asarray(mesh.harmonic_patch_extents(p + 1))[:, :, 1]

    t = np.arange(m) - (p - 1)
    lat_t = np.stack([np.tile(np.repeat(t, m ** d), m ** (dim - 1 - d))
                      for d in range(dim)], axis=1)

    P = len(vids)
    idx = np.full((P, m ** dim), n, dtype=np.int64)
    extents = np.zeros((P, dim, 2))
    for q in range(2 ** dim):
        sel = np.where(corner == q)[0]
        if sel.size == 0:
            continue
        qv = vc[q].astype(np.int64)  # the vertex's corner in the anchor
        lat = lat_t + p * qv[None, :]
        off = np.where(lat < 0, -1, np.where(lat > p, 1, 0))
        anchors = anchors_all[sel]
        idx[sel] = _walk_patch_indices(dofs, nall, Aall, ball, anchors, lat,
                                       off)
        # per axis: the anchor's own width on its side of the vertex, the
        # neighbour's across face 2d + q[d] (measured along the image of
        # the axis in its frame) on the other; q[d] = 0 flips the sides
        for d in range(dim):
            face = 2 * d + int(qv[d])
            nbr = nall[anchors, face]
            ax_n = np.argmax(np.abs(Aall[anchors, face][:, :, d]), axis=1)
            h_own = ext_c[anchors, d]
            h_nbr = np.where(nbr >= 0, ext_c[np.clip(nbr, 0, C - 1), ax_n],
                             h_own)
            sides = (h_own, h_nbr) if qv[d] == 1 else (h_nbr, h_own)
            extents[sel, d, 0], extents[sel, d, 1] = sides
    return _mask_constrained(dofs, idx), extents
