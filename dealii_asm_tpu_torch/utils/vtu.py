"""VTU (unstructured-grid XML) output of lattice solutions and meshes
(NumPy, host).

Counterpart of ``dealii_asm_tpu/utils/vtu.py`` (``write_vtu`` :13,
``write_vtu_mesh`` :73), the reference's DataOut dumps: the nodes of a
solution file are the FE lattice points, its cells the p^dim linear
sub-cells of each element (deal.II's ``build_patches(degree)``); a mesh
file holds the mesh's own cells.  The ASCII text is the JAX writer's, byte
for byte.  Fields are NumPy arrays: a caller copies a device tensor to the
host first.
"""

from __future__ import annotations

import numpy as np

from ..mesh.unstructured import VERTEX_COORDS, UnstructuredMesh


def _header(f, n_points: int, n_cells: int) -> None:
    f.write('<?xml version="1.0"?>\n')
    f.write('<VTKFile type="UnstructuredGrid" version="0.1" '
            'byte_order="LittleEndian">\n<UnstructuredGrid>\n')
    f.write(f'<Piece NumberOfPoints="{n_points}" NumberOfCells="{n_cells}">\n')


def _points_and_cells(f, pts3, cells, ctype: int, npts: int) -> None:
    f.write('<Points><DataArray type="Float64" NumberOfComponents="3" '
            'format="ascii">\n')
    np.savetxt(f, pts3, fmt="%.10g")
    f.write("</DataArray></Points>\n<Cells>\n")
    f.write('<DataArray type="Int64" Name="connectivity" format="ascii">\n')
    np.savetxt(f, np.asarray(cells, dtype=np.int64), fmt="%d")
    f.write('</DataArray>\n<DataArray type="Int64" Name="offsets" '
            'format="ascii">\n')
    np.savetxt(f, np.arange(1, len(cells) + 1) * npts, fmt="%d")
    f.write('</DataArray>\n<DataArray type="UInt8" Name="types" '
            'format="ascii">\n')
    np.savetxt(f, np.full(len(cells), ctype, dtype=np.uint8), fmt="%d")


def _fields(f, tag: str, data: dict) -> None:
    f.write(f"</DataArray>\n</Cells>\n<{tag}>\n")
    for name, values in data.items():
        f.write(f'<DataArray type="Float64" Name="{name}" format="ascii">\n')
        np.savetxt(f, np.asarray(values).reshape(-1, 1), fmt="%.10g")
        f.write("</DataArray>\n")
    f.write(f"</{tag}>\n</Piece>\n</UnstructuredGrid>\n</VTKFile>\n")


def write_vtu(path: str, dofs, point_data: dict) -> None:
    """An ASCII .vtu of the DoF lattice of a structured ``DofHandler`` with
    the named nodal fields (NumPy, n_dofs each)."""
    dim = dofs.mesh.dim
    pts = dofs.node_points(np.arange(dofs.n_dofs))
    pts3 = np.zeros((dofs.n_dofs, 3))
    pts3[:, :dim] = pts
    N = dofs.nodes_per_dim
    strides = np.cumprod([1] + list(N[:-1]))
    # the lower corner of every linear sub-cell, x fastest (a periodic axis
    # wraps its last sub-cell onto node 0)
    ranges = [np.arange(N[d] if dofs.mesh.periodic[d] else N[d] - 1)
              for d in range(dim)]
    lo = np.stack([g.ravel() for g in reversed(np.meshgrid(
        *reversed(ranges), indexing="ij"))], axis=1)  # (S, dim)
    order = ([(0, 0), (1, 0), (1, 1), (0, 1)] if dim == 2 else
             [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
              (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)])
    cells = np.stack([((lo + np.asarray(c)) % np.asarray(N)) @ strides
                      for c in order], axis=1)
    ctype, npts = (9, 4) if dim == 2 else (12, 8)  # VTK_QUAD, VTK_HEXAHEDRON
    with open(path, "w") as f:
        _header(f, dofs.n_dofs, len(cells))
        _points_and_cells(f, pts3, cells, ctype, npts)
        _fields(f, "PointData", point_data)


def mesh_from_structured(mesh) -> UnstructuredMesh:
    """The cells of a ``StructuredMesh`` as an ``UnstructuredMesh``: the
    (transformed) corner points, numbered in the sorted order of their
    lattice coordinates, as the JAX package's ``create_mesh_from_cells``
    over all cells (``mesh/grid.py:275-296``)."""
    dim = mesh.dim
    corners = mesh.cell_multi_index()[:, None, :] + VERTEX_COORDS[dim][None]
    uniq, inv = np.unique(corners.reshape(-1, dim), axis=0,
                          return_inverse=True)
    pts = np.asarray(mesh.origin)[None, :] + uniq * mesh.h[None, :]
    if mesh.transform is not None:
        pts = np.asarray(mesh.transform(pts))
    return UnstructuredMesh(dim, pts.astype(np.float64),
                            inv.reshape(corners.shape[:2]).astype(np.int64))


def write_vtu_mesh(path: str, mesh, cell_data: dict | None = None) -> None:
    """A mesh (structured or unstructured) as a .vtu of its cells, with
    optional per-cell fields: the mesh gallery's output."""
    if not isinstance(mesh, UnstructuredMesh):
        mesh = mesh_from_structured(mesh)
    dim = mesh.dim
    pts3 = np.zeros((mesh.n_vertices, 3))
    pts3[:, :dim] = mesh.vertices
    # lexicographic → VTK vertex order
    perm = [0, 1, 3, 2] if dim == 2 else [0, 1, 3, 2, 4, 5, 7, 6]
    ctype, npts = (9, 4) if dim == 2 else (12, 8)
    with open(path, "w") as f:
        _header(f, mesh.n_vertices, mesh.n_cells_total)
        _points_and_cells(f, pts3, mesh.cells[:, perm], ctype, npts)
        _fields(f, "CellData", cell_data or {})
