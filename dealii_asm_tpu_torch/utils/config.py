"""JSON config helpers (carried over from ``dealii_asm_tpu/utils/config.py``)."""

from __future__ import annotations


def get_child(params: dict, key: str) -> dict:
    """Missing or non-dict child -> empty dict."""
    v = params.get(key)
    return v if isinstance(v, dict) else {}


def get_param(params: dict, key: str, default):
    """params[key] converted to the type of ``default`` where possible."""
    v = params.get(key, default)
    if isinstance(default, bool) and isinstance(v, str):
        return v.lower() in ("1", "true", "yes")
    if default is not None and not isinstance(v, type(default)):
        try:
            return type(default)(v)
        except (TypeError, ValueError):
            return v
    return v
