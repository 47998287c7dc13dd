"""Kernel D: a whole degree-k smoother sweep (csrc/smoother_sweep.cu).

Replaces the TPU kernel ``dealii_asm_tpu/ops/pallas/smoother_step.py``
``_call_chain`` (``SmootherStepKernel.sweep_padded``, and ``steps_padded``
with f1 ≡ 0).  ``smoother_sweep(x, b, a, f, coefs, zero_x)`` computes, for
the rows ``coefs[s] = (f1_s, f2_s)``,

    p_s = f1_s·p_{s−1} + f2_s·P⁻¹(b − A x_{s−1}),    x_s = x_{s−1} + p_s

from x_{−1} = x, or from x_{−1} = 0 under ``zero_x`` (then sub-step 0
applies no A and x is not read: pass None).  Chebyshev rows of either kind
make it a Chebyshev smoother apply; f1 ≡ 0 makes it Richardson steps.
Constrained nodes keep x (0 under ``zero_x``).  The whole sweep is float32
(the TPU kernel's FDM stage and residual ring are bfloat16), so it equals
the composition of kernels A and B, ``smoother_sweep_plain``.

On the card a sub-step with a residual is two launches, kernel A's
residual into r and kernel B's momentum step; the zero guess's first
sub-step is the momentum step alone.  A degree-k sweep is 2k launches
(2k − 1 from zero).
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES
from .banded_laplace import BandedTables, _check_vec, banded_laplace_plain
from .build import check
from .fdm_patch import (FDMTables, _kernel_fn, _pointers,
                        check_kernel_tables, fdm_patch_plain)

_C_SCALAR = {torch.float32: ctypes.c_float, torch.float64: ctypes.c_double}


def smoother_sweep_plain(x: torch.Tensor | None, b: torch.Tensor,
                         a: BandedTables, f: FDMTables, coefs,
                         zero_x: bool = False) -> torch.Tensor:
    """The Chebyshev/Richardson loop over ``banded_laplace_plain`` and
    ``fdm_patch_plain``, in the order the unfused smoothers run it."""
    p = None
    for s, (f1, f2) in enumerate(coefs):
        start = s == 0 and zero_x
        r = b if start else banded_laplace_plain(x, a, rhs=b)
        y = fdm_patch_plain(r, f, f2)
        p = y if s == 0 else f1 * p + y
        x = p if start else x + p
    return x


def smoother_sweep(x: torch.Tensor | None, b: torch.Tensor, a: BandedTables,
                   f: FDMTables, coefs, zero_x: bool = False) -> torch.Tensor:
    if b.device.type == "cpu":
        return smoother_sweep_plain(x, b, a, f, coefs, zero_x)
    if b.device.type != "cuda":
        raise TypeError(f"smoother_sweep: unsupported device {b.device}")
    check_kernel_tables(f, "smoother_sweep")
    if a.p != f.p or tuple(a.grid_shape) != f.grid_shape:
        raise ValueError("smoother_sweep: operator and FDM tables disagree "
                         f"(p {a.p}/{f.p}, grid {a.grid_shape}/{f.grid_shape})")
    k = len(coefs)
    if k < 1:
        raise ValueError("smoother_sweep: no sub-steps")
    nz, ny, nx = a.grid_shape
    n = nz * ny * nx
    _check_vec(b, "b", a.Mdiags[0], n)
    _check_vec(b, "b", f.V[0], n)
    if not zero_x:
        _check_vec(x, "x", a.Mdiags[0], n)
    fn = _kernel_fn("smoother_sweep", b.dtype)
    scalar = _C_SCALAR[b.dtype]
    flat = (scalar * (2 * k))(*[float(c) for row in coefs for c in row])
    empty = lambda need: torch.empty_like(b) if need else None
    r = empty(k > 1 or not zero_x)
    p = empty(any(float(f1) != 0.0 for f1, _ in coefs[1:]))
    out = torch.empty_like(b)
    tmp = empty(k > 1)
    ptr = lambda t: None if t is None else t.data_ptr()
    tabs = [t for d in range(3) for t in (a.Mdiags[d], a.Kdiags[d])]
    cz, cy, cx = f.cells
    err = fn(None if zero_x else x.data_ptr(), b.data_ptr(), ptr(r), ptr(p),
             out.data_ptr(), ptr(tmp), *[t.data_ptr() for t in tabs],
             *_pointers(f), cz, cy, cx, f.p, ctypes.addressof(flat), k,
             int(bool(zero_x)), torch.cuda.current_stream(b.device).cuda_stream)
    check(err, "smoother_sweep")
    LAUNCHES["smoother_sweep"] += 1
    return out
