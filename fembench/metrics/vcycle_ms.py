"""vcycle_ms (ms): CUDA-event time of one apply of the preconditioner (the
float32 V-cycle behind its precision adapter) on the window's sampled
right-hand sides."""


def read(run):
    s = run["stages"].get("vcycle_s")
    return None if s is None else 1e3 * s
