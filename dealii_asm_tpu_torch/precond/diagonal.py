"""Diagonal (Jacobi) preconditioner (PyTorch).

Counterpart of ``dealii_asm_tpu/precond/diagonal.py``: the inverse of the
operator's matrix-free diagonal (constrained rows 1), applied pointwise.
"""

from __future__ import annotations


class DiagonalPreconditioner:
    def __init__(self, op):
        self.inv_diag = op.compute_inverse_diagonal()

    def vmult(self, src):
        return self.inv_diag * src

    def __call__(self, src):
        return self.vmult(src)
