"""smoother_idle_ms (ms): device idle time whose stretches have their
middle inside the program's "mg.pre_smooth" or "mg.post_smooth" spans
(every level), per V-cycle of the outer multigrid, over the span pass's
profiled solves (``fembench/spans.py``).  The profiler's host cost
inflates it, as it does ``idle_share``."""

from fembench import spans


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["mg.vcycle"]:
        return None
    idle = s["idle_s"]
    smoothing = idle.get("mg.pre_smooth", 0.0) + idle.get("mg.post_smooth", 0.0)
    return 1e3 * smoothing / s["tallies"]["mg.vcycle"]
