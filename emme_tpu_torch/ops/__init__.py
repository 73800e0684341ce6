"""Numerical building blocks of the port, and the CUDA kernel K1."""
