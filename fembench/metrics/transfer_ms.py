"""transfer_ms (ms): device time of the operations launched inside the
program's "mg.restrict" and "mg.prolongate" spans, on every level (the
inner multigrid of a nested layout too), per V-cycle of the outer
multigrid, over the span pass's profiled solves (``fembench/spans.py``)."""

from fembench import spans


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["mg.vcycle"]:
        return None
    busy = s["busy_s"]
    moved = busy.get("mg.restrict", 0.0) + busy.get("mg.prolongate", 0.0)
    return 1e3 * moved / s["tallies"]["mg.vcycle"]
