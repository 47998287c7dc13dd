"""setup_levels_s (s): exclusive host seconds of the program's set-up
spans "setup.operator" (less the DoF tables built inside it),
"setup.transfer", "setup.smoother" (with its FDM tables and Lanczos
estimate) and "setup.coarse" (the dense inverse), read in a second, warm
set-up of the cell with the tracer on (``fembench/spans.py``)."""

from fembench import spans

NAMES = ("setup.operator", "setup.transfer", "setup.smoother", "setup.coarse")


def read(run):
    s = spans.of(run)
    if not s:
        return None
    return sum(s["setup_s"][name] for name in NAMES)
