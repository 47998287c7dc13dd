"""patch_access_ms (ms): device time of the operations launched inside
the program's "asm.gather" and "asm.scatter" spans (the unstructured
Schwarz apply's patch gather through its index table and its fixed-order
scatter), on every level, per V-cycle of the outer multigrid, over the
span pass's profiled solves (``fembench/spans.py``)."""

from fembench import spans


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["mg.vcycle"]:
        return None
    busy = s["busy_s"]
    if "asm.gather" not in busy and "asm.scatter" not in busy:
        return None  # a program without these spans
    moved = busy.get("asm.gather", 0.0) + busy.get("asm.scatter", 0.0)
    return 1e3 * moved / s["tallies"]["mg.vcycle"]
