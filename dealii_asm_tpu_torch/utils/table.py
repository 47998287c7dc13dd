"""Org-mode convergence table, as the reference solver program prints it
(carried over from ``dealii_asm_tpu/utils/table.py``)."""

from __future__ import annotations


class ConvergenceTable:
    def __init__(self):
        self.columns: list[str] = []
        self.rows: list[dict] = []
        self._current: dict | None = None

    def add_value(self, key: str, value):
        if self._current is None:
            self._current = {}
        if key not in self.columns:
            self.columns.append(key)
        self._current[key] = value

    def end_row(self):
        if self._current is not None:
            self.rows.append(self._current)
            self._current = None

    @staticmethod
    def _fmt(v):
        return f"{v:.6g}" if isinstance(v, float) else str(v)

    def to_string(self) -> str:
        self.end_row()
        cols = self.columns
        cells = [[self._fmt(r.get(c, "")) for c in cols] for r in self.rows]
        widths = [max(len(c), *(len(row[i]) for row in cells)) if cells
                  else len(c) for i, c in enumerate(cols)]
        out = ["| " + " | ".join(c.ljust(w) for c, w in zip(cols, widths))
               + " | "]
        for row in cells:
            out.append("| " + " | ".join(v.ljust(w) for v, w in
                                         zip(row, widths)) + " | ")
        return "\n".join(out)

    def print(self, file=None):
        print(self.to_string(), file=file)
