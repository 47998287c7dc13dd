"""solve_p90_s (s): the 90th percentile of the window's solve times."""

from fembench.harness import percentile


def read(run):
    return percentile(run["window"]["seconds"], 90)
