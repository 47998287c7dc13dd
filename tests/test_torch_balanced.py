"""The port's balanced hyper-cube decomposition
(dealii_asm_tpu_torch.mesh.balanced) against the JAX package's.

Every s in 0..50 in dim 2 and 3: the same (n_refine, subdivisions) and
the same (cells, lengths), exactly.  In 2D at s ≡ 1 (mod 6), s > 1, the
3×2×2 split needs a third axis: the JAX function raises an IndexError
there, and the port raises a ValueError instead of inventing a
decomposition.
"""

import pytest

from dealii_asm_tpu.mesh import balanced as jax_balanced
from dealii_asm_tpu_torch.mesh import balanced

S_RANGE = range(51)


def _no_split(dim, s):
    return dim == 2 and s % 6 == 1 and s > 1


@pytest.mark.parametrize("dim", [2, 3])
def test_decomposition_matches_jax(dim):
    for s in S_RANGE:
        if _no_split(dim, s):
            continue
        assert balanced.decompose_balanced(dim, s) == \
            jax_balanced.decompose_balanced(dim, s), s
        assert balanced.balanced_hyper_cube_subdivisions(dim, s) == \
            jax_balanced.balanced_hyper_cube_subdivisions(dim, s), s


@pytest.mark.parametrize("s", [s for s in S_RANGE if _no_split(2, s)])
def test_2d_without_a_split_raises_in_both(s):
    with pytest.raises(IndexError):
        jax_balanced.balanced_hyper_cube_subdivisions(2, s)
    with pytest.raises(ValueError, match="needs 3 axes"):
        balanced.balanced_hyper_cube_subdivisions(2, s)


@pytest.mark.parametrize("s,cells", [
    (45, [384, 128, 128]), (44, [256, 128, 128]), (40, [128, 128, 64]),
    (39, [192, 64, 64]), (38, [128, 64, 64]), (36, [64, 64, 64]),
    (6, [2, 2, 2]), (3, [3, 1, 1])])
def test_study_sizes(s, cells):
    """The cells of the matrix-free-loop configs (``experiments/
    sweep_mfl_*``, ``matrix_free_loop.json``) and of the 1-cell periodic
    case."""
    got, lengths = balanced.balanced_hyper_cube_subdivisions(3, s)
    assert got == cells
    assert [c / ln for c, ln in zip(got, lengths)] == [got[0] / lengths[0]] * 3
