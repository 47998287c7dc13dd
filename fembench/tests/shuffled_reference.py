"""A stand-in reference for the harness's tests: the multigrid reference
with its DoFs numbered in an order drawn from a fixed seed.  It states no
lattice and gives its support points, so the harness has to match the
program's DoFs to it by their points (``harness.numbering``).  ``MOVED``
points (the first ones of that order) are shifted by a tenth of the
extent, so that a stand-in with ``MOVED`` > 0 has a point set that differs
from the program's."""

from __future__ import annotations

import torch

from fembench.reference import multigrid
from fembench.reference.multigrid import cg  # noqa: F401 (the interface's)

MOVED = 0


def _order(n: int) -> torch.Tensor:
    """Stand-in DoF j is the lattice's DoF order[j]."""
    return torch.randperm(n, generator=torch.Generator().manual_seed(7))


class _Shuffled:
    """``vmult`` of a lattice-numbered apply, in the stand-in's numbering."""

    def __init__(self, inner, order: torch.Tensor):
        self.inner, self.order = inner, order
        self.inverse = torch.argsort(order)

    def vmult(self, v: torch.Tensor) -> torch.Tensor:
        return self.inner.vmult(v[self.inverse])[self.order]


def build(config: dict, device="cpu", outer_dtype=torch.float64,
          level_dtype=torch.float64):
    outer, V = multigrid.build(config, device, outer_dtype, level_dtype)
    order = _order(multigrid.n_dofs(config)).to(device)
    return _Shuffled(outer, order), _Shuffled(V, order)


def n_dofs(config: dict) -> int:
    return multigrid.n_dofs(config)


def lattice(config: dict):
    return None


def points(config: dict) -> tuple:
    support, free, unit = multigrid.points(config)
    order = _order(len(free)).numpy()
    support = support[order].copy()
    support[:MOVED] += 0.1 * float(support.max() - support.min())
    return support, free[order], unit[order]
