"""solve_s (s): the window's wall time over the solves completed in it
(the clock stops only while the harness copies a sampled answer out).
``solve_s.<group>`` reads the same in the cells of its group."""


def read(run):
    t = run["window"]["seconds"]
    return sum(t) / len(t)
