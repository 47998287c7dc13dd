"""Preconditioners: FDM Schwarz, multigrid, precision adapter, factory."""
