"""Config helpers and the convergence table."""
