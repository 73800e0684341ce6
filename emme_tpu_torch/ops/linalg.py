"""Complex dense linear algebra for the eigensolve.

torch has complex LU and SVD on the CPU and on CUDA, so the solves run
directly on complex tensors (``emme_tpu`` needed a real 2n x 2n embedding on
the TPU; that workaround is not ported).
"""

from __future__ import annotations

import torch


def complex_solve(M, C):
    """Solve M X = C for complex square M, complex RHS C (matrix or vector)."""
    return torch.linalg.solve(M, C)


def complex_solve_trace(M, dM):
    """trace(M^{-1} dM) -- the Newton-trace-secant denominator
    (solver.h:129-139)."""
    return torch.trace(torch.linalg.solve(M, dM))


def null_space_vector(M, method: str = "svd"):
    """Null-space (least-singular right-singular) vector of M, conjugated to
    match the reference's nullSpace() output convention (solver.h:58-112)."""
    if method != "svd":
        raise ValueError(f"only method='svd' is ported, got {method!r}")
    _, _, vh = torch.linalg.svd(M)
    return vh[-1, :].conj().resolve_conj()
