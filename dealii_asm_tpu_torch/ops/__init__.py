"""Operators on the structured node lattice (PyTorch)."""
