"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA tensor (or raises) and runs
the plain version for a CPU tensor.  ``LAUNCHES`` counts kernel launches per
wrapper: it is incremented only where a kernel is launched, so a run can show
that its main path went through the kernels.
"""

LAUNCHES = {
    "banded_laplace_f32": 0,
    "banded_laplace_f64": 0,
    "fdm_patch": 0,
    "lanes_laplace_f32": 0,
    "lanes_laplace_f64": 0,
    "merged_laplace_f32": 0,
    "merged_laplace_f64": 0,
    "smoother_step": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)
