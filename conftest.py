"""pytest settings shared by the repository's test trees.

``fembench/tests/test_fembench_harness.py`` runs each cell of
``BENCHMARK.json`` on the CPU at the size its table ``TINY`` gives.  A
cell that the benchmark lists but that table does not yet name gets its
size from ``TINY_CELLS`` here, once the tests are collected; the table
itself belongs to the benchmark's own files."""

import sys

TINY_CELLS = {"ball_q4": 1}  # cell: refinements of its tiny CPU run


def pytest_collection_finish(session):
    harness_tests = sys.modules.get("fembench.tests.test_fembench_harness")
    if harness_tests is not None:
        for name, refinements in TINY_CELLS.items():
            harness_tests.TINY.setdefault(name, refinements)
