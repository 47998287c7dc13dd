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
state is freed.
"""

from __future__ import annotations

import torch

from .reference import multigrid as ref


class Judge:
    """The plain float64 reference of a configuration, built once, and the
    compared numbers of a run's sampled answers."""

    def __init__(self, config: dict, device):
        self.device = device
        self.outer, self.V = ref.build(config, device=device)

    def numbers(self, rhs, kept: dict, vcycles: dict) -> dict:
        """The compared numbers of the sampled answers ``kept`` (right-hand
        side → ``harness.Kept``) and V-cycle outputs ``vcycles`` (→ host
        tensor)."""
        gaps, vgaps = [], []
        for k in sorted(kept):
            kp = kept[k]
            b = rhs(k).to(torch.float64)
            x = kp.x.to(self.device)
            true = float(torch.linalg.vector_norm(b - self.outer.vmult(x)))
            del x
            gaps.append(abs(true - kp.reported) / kp.norm_b)
            z = self.V.vmult(b)
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
