"""Patch DoF tables of the Schwarz smoothers on structured meshes (NumPy).

Carried over from ``dealii_asm_tpu/fem/patches.py``:

- ``element_patch_indices`` (:22): the (p − 1 + 2·o)^dim window of each cell
  at overlap o, starting at node c·p − (o − 1) along each axis;
- ``vertex_patch_indices`` (:111): the (2p − 1)^dim interior nodes of the
  2^dim cells around each interior vertex, starting at node v·p − (p − 1)
  for vertex v (the anchor cell v − 1 is the lower-left cell of the star);
- ``vertex_all_patch_indices`` (:67): all (2p + 1)^dim nodes of those
  cells, starting at node v·p − p (the matrix-based "vertex_all"
  restriction).

On a periodic axis (N = p·C nodes) node ids wrap modulo N and every vertex
is interior: C windows per axis, vertex 0 first (``:80-160``).  A 1-cell
periodic axis (N = p) wraps a window onto itself, so a slot may repeat a
node.  Local nodes and patches are numbered x fastest; slots outside a
non-periodic mesh hold the pad index ``n_dofs``.  The port's applies take these windows as strided
views of the node grid (``ops/lattice.py``); the tables are the host-side
statement of the same windows.
"""

from __future__ import annotations

import numpy as np


def _tensor_table(per_dim: list, strides: np.ndarray, m: int) -> np.ndarray:
    """(P, m^dim) flat node ids from per-axis (P, m) node coordinates, local
    slots x fastest; -1 marks a slot outside the mesh."""
    dim = len(per_dim)
    P = per_dim[0].shape[0]
    out = np.zeros((P,) + (m,) * dim, dtype=np.int64)
    ok = np.ones_like(out, dtype=bool)
    for d, k in enumerate(per_dim):
        sh = [P] + [1] * dim
        sh[dim - d] = m  # local axis of direction d: x last
        out += np.clip(k, 0, None).reshape(sh) * int(strides[d])
        ok &= (k >= 0).reshape(sh)
    return np.where(ok, out, -1).reshape(P, m ** dim)


def element_patch_indices(dofs, n_overlap: int) -> np.ndarray:
    """(C, m^dim) int32 element-patch DoF ids, m = p − 1 + 2·overlap, pad
    index n_dofs."""
    mesh = dofs.mesh
    p = dofs.degree
    m = p - 1 + 2 * n_overlap
    N = dofs.nodes_per_dim
    mi = mesh.cell_multi_index()
    offsets = np.arange(m) - (n_overlap - 1)
    per_dim = []
    for d in range(mesh.dim):
        k = mi[:, d, None].astype(np.int64) * p + offsets[None, :]
        if mesh.periodic[d]:
            per_dim.append(k % N[d])
        else:
            per_dim.append(np.where((k >= 0) & (k <= N[d] - 1), k, -1))
    strides = np.cumprod([1] + list(N[:-1]))
    out = _tensor_table(per_dim, strides, m)
    return np.where(out < 0, dofs.n_dofs, out).astype(np.int32)


def interior_vertices(mesh) -> np.ndarray:
    """(P, dim) multi-indices of the interior vertices, x fastest: 1 .. C − 1
    along a non-periodic axis, 0 .. C − 1 along a periodic one."""
    ranges = [np.arange(0 if per else 1, n)
              for n, per in zip(mesh.n_cells, mesh.periodic)]
    grids = np.meshgrid(*reversed(ranges), indexing="ij")
    return np.stack([g.ravel() for g in reversed(grids)], axis=1)


def vertex_anchors(mesh) -> np.ndarray:
    """(P,) anchor cell of each interior vertex: the lower-left cell of the
    2^dim block around it (wrapped on a periodic axis)."""
    return mesh.cell_flat_index(
        (interior_vertices(mesh) - 1) % np.asarray(mesh.n_cells))


def vertex_patch_indices(dofs) -> tuple[np.ndarray, np.ndarray]:
    """(idx (P, (2p − 1)^dim) int32, anchors (P,) int32): the vertex-star
    DoF ids of each interior vertex and its anchor cell (the lower-left
    cell of the 2^dim block).  A star's nodes are interior to its cells, so
    no slot is outside the mesh; constrained DoFs are not masked here (the
    caller masks them)."""
    mesh = dofs.mesh
    p = dofs.degree
    m = 2 * p - 1
    verts = interior_vertices(mesh)
    offsets = np.arange(m) - (p - 1)
    N = dofs.nodes_per_dim
    per_dim = [(verts[:, d, None].astype(np.int64) * p + offsets[None, :])
               % N[d] for d in range(mesh.dim)]
    strides = np.cumprod([1] + list(dofs.nodes_per_dim[:-1]))
    idx = _tensor_table(per_dim, strides, m)
    return idx.astype(np.int32), vertex_anchors(mesh).astype(np.int32)


def vertex_all_patch_indices(dofs) -> tuple[np.ndarray, np.ndarray]:
    """(idx (P, (2p + 1)^dim) int32, anchors (P,) int32): every DoF of the
    2^dim cells around each interior vertex, and its anchor cell."""
    mesh = dofs.mesh
    p = dofs.degree
    m = 2 * p + 1
    verts = interior_vertices(mesh)
    offsets = np.arange(m) - p
    N = dofs.nodes_per_dim
    per_dim = [(verts[:, d, None].astype(np.int64) * p + offsets[None, :])
               % N[d] for d in range(mesh.dim)]
    strides = np.cumprod([1] + list(N[:-1]))
    idx = _tensor_table(per_dim, strides, m)
    return idx.astype(np.int32), vertex_anchors(mesh).astype(np.int32)
