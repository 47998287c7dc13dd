"""Structured Cartesian meshes (NumPy)."""
