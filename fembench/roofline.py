"""Work counts and peaks of the benchmark's roofline shares (frozen).

A share is the least time the card could take for a call, the larger of its
bytes over the memory rate and its operations over the peak rate of their
type, divided by the call's measured time.  Bytes count each input read
once and each output written once; operations are those the algorithm
needs, counted from the shapes.  The peaks are those of one H100 SXM
(NVIDIA data sheet, dense, at the full 700 W): 3.35 TB/s of device memory,
67 TFLOP/s in float32 and 34 TFLOP/s in float64 outside the tensor cores,
which the solver's kernels do not use.

The counts of the Cartesian operator (kernel A), the Cartesian Schwarz
apply (kernel B), the fused smoother step (kernel C), the deformed
operator (kernel E) and the unstructured operator (kernel F) are copies of
those the program's chip checks use; the count of the per-cell FDM apply
is derived here from its patch tables.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FLOP_S = {4: 67e12, 8: 34e12}


def least_seconds(n_bytes: float, n_flop: float, itemsize: int) -> float:
    return max(n_bytes / PEAK_BYTES_S, n_flop / PEAK_FLOP_S[itemsize])


def banded_work(n: int, p: int, itemsize: int) -> tuple:
    """(bytes, flop) of one Cartesian operator apply on n nodes of a cube:
    u in, v out, six banded 1D tables; 7 (2p+1) multiply-adds a node."""
    n_1d = round(n ** (1 / 3))
    return ((2 * n + 6 * (2 * p + 1) * n_1d) * itemsize,
            2.0 * 7 * (2 * p + 1) * n)


def fdm_work(cells: int, n: int, p: int, itemsize: int) -> tuple:
    """(bytes, flop) of one Cartesian Schwarz apply (overlap 1): src in, out
    out, the per-coordinate tables; per cell six m × m × m² transforms and
    the eigenvalue scaling, m = p + 1."""
    m = p + 1
    n_1d = round(n ** (1 / 3))
    tables = 3 * round(cells ** (1 / 3)) * (m * m + m) + 6 * n_1d
    return ((2 * n + tables) * itemsize, 2.0 * cells * (6 * m ** 4 + m ** 3))


def merged_work(cells: int, n: int, p: int, itemsize: int,
                residual: bool = False) -> tuple:
    """(bytes, flop) of one deformed operator apply: u (and rhs) in, v out,
    the (C, 6, Q) coefficients; per cell 16 m⁴ + 9 m³ multiply-adds and the
    summation of the cell results onto the nodes."""
    m = p + 1
    vectors = (3 if residual else 2) * n
    return ((vectors + 6 * cells * m ** 3 + 4 * m * m) * itemsize,
            2.0 * cells * (16 * m ** 4 + 9 * m ** 3) + 8.0 * n)


def lanes_work(cells: int, n: int, p: int, itemsize: int,
               residual: bool = False) -> tuple:
    """(bytes, flop) of one unstructured operator apply: u (and rhs) in, v
    out, the (C, 6, Q) coefficients and the int32 (C, m³) DoF table; per
    cell 16 m⁴ + 9 m³ multiply-adds and the summation of the cell results
    onto the DoFs."""
    m = p + 1
    vectors = (3 if residual else 2) * n
    return ((vectors + 6 * cells * m ** 3 + 4 * m * m) * itemsize
            + 4 * cells * m ** 3,
            2.0 * cells * (16 * m ** 4 + 9 * m ** 3) + cells * m ** 3)


def patch_fdm_work(patches: int, n: int, m: int, itemsize: int) -> tuple:
    """(bytes, flop) of one per-patch FDM apply: src in, out out, and the
    patch tables, three (P, m, m) eigenvector stacks and the (P, m, m, m)
    reciprocal eigenvalue sums; per patch six m × m × m² transforms and the
    scaling.  The count is that of the tables' shapes, whatever kernels the
    program launches for it."""
    return ((2 * n + patches * (3 * m * m + m ** 3)) * itemsize,
            2.0 * patches * (6 * m ** 4 + m ** 3))


def level_vmult_work(shape: dict) -> tuple:
    """(bytes, flop) of one apply of the finest level operator ``shape``
    (the run record's ``finest``)."""
    n, p, s = shape["n"], shape["p"], shape["itemsize"]
    if shape["kind"] == "cartesian":
        return banded_work(n, p, s)
    if shape["kind"] == "deformed":
        return merged_work(shape["cells"], n, p, s)
    return lanes_work(shape["cells"], n, p, s)


def smoother_step_work(shape: dict) -> tuple:
    """(bytes, flop) of one post-smoothing step of the finest level from a
    nonzero guess: x and b in, x' out, the operator's and the Schwarz
    apply's tables read once, and per Chebyshev sub-step one residual and
    one Schwarz apply (the step of degree 1 is kernel C's count)."""
    n, p, s, k = shape["n"], shape["p"], shape["itemsize"], shape["degree"]
    cells = shape["cells"]
    if shape["kind"] == "cartesian":
        ab, af = banded_work(n, p, s)
        fb, ff = fdm_work(cells, n, p, s)
    else:
        work = merged_work if shape["kind"] == "deformed" else lanes_work
        ab, af = work(cells, n, p, s, residual=True)
        ab -= n * s  # the rhs is the step's b, counted once below
        fb, ff = patch_fdm_work(shape["patches"], n, p + 1, s)
    tables = ab + fb - 4 * n * s  # the operator's u, v and the apply's src, out
    return 3 * n * s + tables, k * (af + ff)


def share_percent(work: tuple, itemsize: int, seconds: float) -> float:
    """100 × least time / measured time."""
    return 100.0 * least_seconds(work[0], work[1], itemsize) / seconds
