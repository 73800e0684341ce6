"""Solvers of the port: the dense eigensolve."""
