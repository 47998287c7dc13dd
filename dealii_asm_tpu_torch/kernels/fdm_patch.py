"""Kernel B: element-centric overlap-1 FDM Schwarz apply (csrc/fdm_patch.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/fdm_slab.py``
``FDMSlabKernel``.  ``fdm_patch(src, tables, omega, xold)`` computes

    omega · P⁻¹ src            (xold is None)
    xold + omega · P⁻¹ src     (the update epilogue of the smoother step)

with P⁻¹ the sum of the weighted patch inverses (weights and Dirichlet masks
folded per axis).  It launches the CUDA kernel for a CUDA tensor and runs
``fdm_patch_plain`` (the dense per-axis transforms G_d of the JAX package's
global-FDM path) for a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.tensorops import fdm_global_apply
from . import LAUNCHES
from .banded_laplace import _check_vec
from .build import check, load


@dataclass
class FDMTables:
    """Per-direction tables (x first), on the preconditioner's device/dtype.

    Kernel form: V (C_d, m, m) per-coordinate eigenvectors (node s, mode k),
    lam (C_d, m), fin/fout (N_d,) the input/output folds.
    Plain form: G (C_d·m, N_d) with fin folded, Gt (N_d, C_d·m) with fout
    folded, inv_denom the (C_z·m, C_y·m, C_x·m) reciprocal eigenvalue sums.
    """

    V: list
    lam: list
    fin: list
    fout: list
    G: list
    Gt: list
    inv_denom: torch.Tensor
    cells: tuple  # (Cz, Cy, Cx)
    p: int

    @property
    def grid_shape(self) -> tuple:
        return tuple(c * self.p + 1 for c in self.cells)


def fdm_patch_plain(src: torch.Tensor, t: FDMTables, omega: float = 1.0,
                    xold: torch.Tensor | None = None) -> torch.Tensor:
    y = fdm_global_apply(src.reshape(t.grid_shape), t.G, t.Gt,
                         t.inv_denom).reshape(-1) * omega
    return y if xold is None else xold + y


def _pointers(t: FDMTables) -> list:
    return [x.data_ptr() for x in (*t.V, *t.lam, *t.fin, *t.fout)]


def _kernel_fn(name: str, dtype):
    if dtype == torch.float32:
        return getattr(load(), f"dat_{name}_f32")
    if dtype == torch.float64:
        return getattr(load(), f"dat_{name}_f64")
    raise TypeError(f"{name}: unsupported dtype {dtype}")


def fdm_patch(src: torch.Tensor, t: FDMTables, omega: float = 1.0,
              xold: torch.Tensor | None = None) -> torch.Tensor:
    if src.device.type == "cpu":
        return fdm_patch_plain(src, t, omega, xold)
    if src.device.type != "cuda":
        raise TypeError(f"fdm_patch: unsupported device {src.device}")
    nz, ny, nx = t.grid_shape
    n = nz * ny * nx
    _check_vec(src, "src", t.V[0], n)
    if xold is not None:
        _check_vec(xold, "xold", t.V[0], n)
    fn = _kernel_fn("fdm_patch", src.dtype)
    out = torch.empty_like(src)
    cz, cy, cx = t.cells
    err = fn(src.data_ptr(), xold.data_ptr() if xold is not None else None,
             out.data_ptr(), *_pointers(t), cz, cy, cx, t.p, float(omega),
             0 if xold is None else 1,
             torch.cuda.current_stream(src.device).cuda_stream)
    check(err, "fdm_patch")
    LAUNCHES["fdm_patch"] += 1
    return out
