"""setup_mesh_dofs_s (s): exclusive host seconds of the program's set-up
spans "setup.mesh" (the mesh family and each level's mesh) and
"setup.dofs" (each DoF table, built on first use inside an operator's
set-up), read in a second, warm set-up of the cell with the tracer on
(``fembench/spans.py``)."""

from fembench import spans


def read(run):
    s = spans.of(run)
    if not s:
        return None
    return s["setup_s"]["setup.mesh"] + s["setup_s"]["setup.dofs"]
