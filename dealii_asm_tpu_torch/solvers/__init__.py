"""Krylov solvers and Chebyshev smoothing."""
