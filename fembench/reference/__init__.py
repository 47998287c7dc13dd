"""Plain float64 reference of the benchmark's solves: NumPy and plain torch
only, nothing of the program under test."""
