"""krylov_vector_ms (ms): device time of the operations launched inside a
"cg.iteration" span and outside its "cg.operator" and "cg.precond" spans
(CG's float64 vector updates and inner products), per iteration, over the
span pass's profiled solves (``fembench/spans.py``)."""

from fembench import spans


def read(run):
    s = spans.pass_of(run)
    if not s or not s["tallies"]["cg.iteration"]:
        return None
    own = s["busy_s"].get("cg.iteration", 0.0)
    return 1e3 * own / s["tallies"]["cg.iteration"]
