"""smoothing_idle_ms (ms): device idle time whose stretches have their
middle inside the program's "mg.pre_smooth" or "mg.post_smooth" spans or
inside the unstructured Schwarz apply's "asm.gather" and "asm.scatter"
spans nested in them (every level), per V-cycle of the
outer multigrid, over the span pass's profiled solves
(``fembench/spans.py``): the whole idle of smoothing on an unstructured
level.  The profiler's host cost inflates it, as it does
``idle_share``."""

from fembench import spans

SCHWARZ = ("asm.gather", "asm.scatter")
NAMES = ("mg.pre_smooth", "mg.post_smooth") + SCHWARZ


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["mg.vcycle"]:
        return None
    if not any(name in s["busy_s"] for name in SCHWARZ):
        return None  # a program without the Schwarz apply's spans
    idle = s["idle_s"]
    return 1e3 * sum(idle.get(n, 0.0) for n in NAMES) / s["tallies"]["mg.vcycle"]
