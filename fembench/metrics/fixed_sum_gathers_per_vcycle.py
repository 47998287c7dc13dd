"""fixed_sum_gathers_per_vcycle (gathers/vcycle): the program's counter
"fixed_sum.gathers" (one per valence group of each fixed-order scatter
call: the Schwarz apply's and the transfers' eager gather-and-sum pairs)
over the span pass's profiled solves, per V-cycle of the outer multigrid
(``fembench/spans.py``)."""

from fembench import spans


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["mg.vcycle"]:
        return None
    n = s.get("counters", {}).get("fixed_sum.gathers")
    return None if n is None else n / s["tallies"]["mg.vcycle"]
