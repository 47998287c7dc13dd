"""pytest settings of the benchmark's tests (``python -m pytest fembench``).

Tests that need a CUDA device carry the ``card`` marker and take the
``cuda_device`` fixture, which decides when the test runs, never when a
module is imported, whether there is a card, and skips without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark's card tests run on the H100")
    return torch.device("cuda")


@pytest.fixture
def tiny_cell():
    """A benchmark cell as ``harness.load_cell`` gives it, with its
    configuration cut to ``refinements`` so that it runs on the CPU."""
    import copy

    from fembench import harness

    def make(name: str, refinements: int) -> dict:
        cell = harness.load_cell(name)
        cell["config"] = copy.deepcopy(cell["config"])
        cell["config"]["n refinements"] = refinements
        return cell

    return make
