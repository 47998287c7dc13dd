"""idle_share (%): the share of a profiled stretch of steady solves in
which no device operation runs (the union of their intervals in the
torch.profiler trace).  The profiler's host cost inflates it."""


def read(run):
    p = run["stages"].get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
