"""setup_s (s): process start to the first timed solve: imports, CUDA's
start-up, the kernel library's load (built on a checkout's first run),
``run_config`` with its warm-up solve, and the traffic's tables."""


def read(run):
    return run["setup_s"]
