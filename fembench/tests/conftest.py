"""The span readers (``fembench/spans.py``) set up the cell named on the
``fembench.run`` command line again; a test that reads the record of a
run of a tiny cell hands them that cell, on the CPU, instead."""

import pytest

from fembench import spans


@pytest.fixture
def tiny_cell(tiny_cell, monkeypatch):
    def make(name: str, refinements: int) -> dict:
        cell = tiny_cell(name, refinements)
        monkeypatch.setattr(spans, "command_line", lambda: (cell, 0, "cpu"))
        return cell

    return make
