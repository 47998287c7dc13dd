"""Fixed-order scatter-add: the deterministic transpose of a gather table.

The unstructured operators gather cell (or patch) values through an index
table and sum them back onto shared DoFs.  On CUDA, ``index_add_`` on
floats sums with atomics in an order that changes from run to run, and
``run_config`` requires a repeated solve to take the same iteration count.
``FixedOrderSum`` sums in a fixed order instead: from the CSR inverse of the
table (``csr_inverse``), the target DoFs are grouped by their number k of
slots, and each group sums a (rows, k) gather along its last axis, with the
slots in ascending order.  No atomics, the same result on every run.
"""

from __future__ import annotations

import torch


def csr_inverse(index: torch.Tensor, n: int):
    """(row_ptr (n+1,), slots (nnz,)) int64 on ``index``'s device: the
    positions k of the flat ``index`` with index[k] == i, ascending, for each
    target i in [0, n); entries outside [0, n) are dropped."""
    flat = index.reshape(-1).long()
    keep = (flat >= 0) & (flat < n)
    order = torch.argsort(torch.where(keep, flat, n), stable=True)
    order = order[: int(keep.sum())]
    row_ptr = torch.zeros(n + 1, dtype=torch.long, device=flat.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(flat[order], minlength=n), 0)
    return row_ptr, order


class FixedOrderSum:
    """out[i] = Σ values[k] over the flat positions k with index[k] == i, in
    ascending k; entries of ``index`` outside [0, n) are dropped."""

    def __init__(self, index: torch.Tensor, n: int):
        row_ptr, slots = csr_inverse(index, n)
        counts = row_ptr[1:] - row_ptr[:-1]
        self.n = n
        self.groups = []
        for k in torch.unique(counts).tolist():
            if k == 0:
                continue
            rows = torch.nonzero(counts == k).reshape(-1)
            offsets = torch.arange(k, device=slots.device)
            self.groups.append((rows, slots[row_ptr[rows][:, None] + offsets]))

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        flat = values.reshape(-1)
        out = flat.new_zeros(self.n)
        for rows, table in self.groups:
            out[rows] = flat[table].sum(dim=1)
        return out
