"""The work of a batched complex LU (``torch.linalg.lu_factor`` of a
(batch, n, n) complex64 tensor): (2/3) n^3 complex multiply-adds a matrix,
each 8 real operations (4 products, 4 sums), against the float32 peak of
``common``; bytes: each matrix read and its factors written once."""

from __future__ import annotations

from portbench.roofline import common

COMPLEX64_BYTES = 8


def work(n: int, batch: int = 1) -> tuple[float, float]:
    """(operations, bytes) of ``batch`` LUs of n x n."""
    flop = batch * (2.0 / 3.0) * n ** 3 * 8
    nbytes = batch * 2 * COMPLEX64_BYTES * n * n
    return flop, nbytes


def least_s(n: int, batch: int = 1) -> float:
    """The least time of ``batch`` LUs of n x n on the card."""
    return common.bound_s(*work(n, batch))[0]
