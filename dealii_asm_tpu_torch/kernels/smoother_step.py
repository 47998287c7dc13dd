"""Kernel C: one smoother step x' = x + ω·P⁻¹(b − A x) (csrc/smoother_step.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/smoother_step.py``
``SmootherStepKernel.step``.  One launch: each block computes the residual
b − A x on its tile's window in shared memory and applies kernel B's tiled
patch body to it with the update epilogue, so r never reaches device memory
(``launch_plan(p, itemsize, "smoother_step")`` gives its tiles).  The whole
step is float32 (the TPU kernel's FDM stage is bfloat16), so it equals the
composition of kernels A and B.  Constrained nodes keep x.
"""

from __future__ import annotations

import torch

from . import LAUNCHES
from .banded_laplace import BandedTables, _check_vec, banded_laplace_plain
from .build import check
from .fdm_patch import (FDMTables, _kernel_fn, _pointers,
                        check_kernel_tables, fdm_patch_plain)


def smoother_step_plain(x: torch.Tensor, b: torch.Tensor, a: BandedTables,
                        f: FDMTables, omega: float) -> torch.Tensor:
    return fdm_patch_plain(banded_laplace_plain(x, a, rhs=b), f, omega, xold=x)


def smoother_step(x: torch.Tensor, b: torch.Tensor, a: BandedTables,
                  f: FDMTables, omega: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return smoother_step_plain(x, b, a, f, omega)
    if x.device.type != "cuda":
        raise TypeError(f"smoother_step: unsupported device {x.device}")
    check_kernel_tables(f, "smoother_step")
    if a.p != f.p or tuple(a.grid_shape) != f.grid_shape:
        raise ValueError("smoother_step: operator and FDM tables disagree "
                         f"(p {a.p}/{f.p}, grid {a.grid_shape}/{f.grid_shape})")
    nz, ny, nx = a.grid_shape
    n = nz * ny * nx
    _check_vec(x, "x", a.Mdiags[0], n)
    _check_vec(b, "b", a.Mdiags[0], n)
    _check_vec(x, "x", f.V[0], n)
    fn = _kernel_fn("smoother_step", x.dtype)
    out = torch.empty_like(x)
    tabs = [t for d in range(3) for t in (a.Mdiags[d], a.Kdiags[d])]
    cz, cy, cx = f.cells
    err = fn(x.data_ptr(), b.data_ptr(), out.data_ptr(),
             *[t.data_ptr() for t in tabs], *_pointers(f), cz, cy, cx, f.p,
             float(omega), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "smoother_step")
    LAUNCHES["smoother_step"] += 1
    return out
