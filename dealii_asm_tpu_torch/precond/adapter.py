"""Precision adapter: a preconditioner built in one dtype applied to vectors
of another (float64 outer Krylov over float32 multigrid levels).
Counterpart of ``dealii_asm_tpu/precond/adapter.py``."""

from __future__ import annotations

import torch


class PrecisionAdapter:
    """Casts in and out around an inner preconditioner's vmult/step."""

    def __init__(self, inner, inner_dtype=torch.float32):
        self.inner = inner
        self.inner_dtype = inner_dtype
        self.is_symmetric = getattr(inner, "is_symmetric", False)

    def vmult(self, x):
        return self.inner.vmult(x.to(self.inner_dtype)).to(x.dtype)

    def step(self, x, b):
        return self.inner.step(x.to(self.inner_dtype),
                               b.to(self.inner_dtype)).to(b.dtype)

    def __call__(self, x):
        return self.vmult(x)
