"""Finite-element host layer: 1D Lagrange elements and DoF lattices (NumPy)."""
