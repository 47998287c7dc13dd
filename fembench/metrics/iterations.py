"""iterations (it): CG iterations a solve, the mean over the K
right-hand sides of the traffic, each counted once, from the window's first
K solves (krylov.solve's n_iterations); the seed fixes it."""


def read(run):
    its = list(run["rhs_iterations"].values())
    return sum(its) / len(its)
