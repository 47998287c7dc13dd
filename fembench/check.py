"""The comparison that decides ``correct``.

After the window, for each sampled right-hand side b (drawn from the seed):

- ``residual_gap``: |‖b − A x‖ − r| / ‖b‖, with x the answer the window's
  solve returned, r the final residual norm the solve reported (its
  convergence test passed on r ≤ 1e-5 ‖b‖), and A the plain reference's
  float64 operator.  It holds the float64 outer operator and the returned
  solution: a solve whose outer operator or vectors lose precision, or
  whose answer is altered, reports a residual that the true one does not
  match.
- ``vcycle_gap``: ‖M b − M_ref b‖ / ‖M_ref b‖, M the program's
  preconditioner (its float32 V-cycle behind the precision adapter) and
  M_ref the reference's V-cycle in float64: the level operators, smoothers
  with their eigenvalue estimates, transfers and the dense coarse solve.

Each number is the largest over the sample and is held to the cell's limit
in ``fembench/workloads/<cell>.json``.  The reference runs once the program's
state is freed.  The reference is the cell's own (``harness.reference``).
Where its numbering is not the program's, a vector goes into the
reference's order before each of its applies and comes back into the
program's after it, so that every difference and norm is taken in the
program's numbering.
"""

from __future__ import annotations

import torch

from . import harness


class Judge:
    """The plain float64 reference of a cell's configuration, built once,
    and the compared numbers of a run's sampled answers; ``perm``
    (``harness.Numbering.perm``) places program DoF i at the reference's
    ``perm[i]``."""

    def __init__(self, cell: dict, device, perm=None):
        self.device = device
        self.outer, self.V = harness.reference(cell).build(cell["config"],
                                                           device=device)
        self.A, self.M = self.outer.vmult, self.V.vmult
        if perm is not None:
            back = perm.to(device)
            to = torch.argsort(back)
            self.A = lambda v, f=self.A: f(v[to])[back]
            self.M = lambda v, f=self.M: f(v[to])[back]

    def numbers(self, rhs, kept: dict, vcycles: dict) -> dict:
        """The compared numbers of the sampled answers ``kept`` (right-hand
        side → ``harness.Kept``) and V-cycle outputs ``vcycles`` (→ host
        tensor)."""
        gaps, vgaps = [], []
        for k in sorted(kept):
            kp = kept[k]
            b = rhs(k).to(torch.float64)
            x = kp.x.to(self.device)
            true = float(torch.linalg.vector_norm(b - self.A(x)))
            del x
            gaps.append(abs(true - kp.reported) / kp.norm_b)
            z = self.M(b)
            diff = vcycles[k].to(device=self.device, dtype=torch.float64) - z
            vgaps.append(float(torch.linalg.vector_norm(diff)
                               / torch.linalg.vector_norm(z)))
            del z, diff
        return {"residual_gap": max(gaps), "vcycle_gap": max(vgaps)}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(all within their limits, {name: {"value", "limit"}})."""
    checks = {name: {"value": numbers[name], "limit": limits[name]}
              for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def guarantees_kept(stated: dict, facts: dict) -> list:
    """The stated guarantees (a configuration file's ``guarantees``) that
    the program's set-up departs from, as 'name: stated, found' lines."""
    return [f"{k}: stated {v!r}, found {facts.get(k)!r}"
            for k, v in stated.items() if facts.get(k) != v]
