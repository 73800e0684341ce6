"""Plain reference of the multi-shift survey: shift-invert Arnoldi on the
secant linearisation of M(omega) about a shift sigma.

For one input and one shift: the whole operator at sigma and at
sigma (1 + ``D_SIGMA_FRAC``) (``operator.assemble``), the secant
M' = (M(sigma (1 + f)) - M(sigma)) / (f sigma), one LU of M(sigma), an
``m``-step modified Gram-Schmidt Arnoldi on B = M^{-1} M' from the start
vector 1 + 0.3 i k / n (normalised), the eigenvalues of the m x m
Hessenberg, and the estimate sigma - 1 / mu of the one of largest |mu|:
the eigenvalue of the linearised pencil nearest sigma.  It imports
nothing of the program; every value is worked out again from the input
dict.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import operator

D_SIGMA_FRAC = 0.01   # the secant's step, a share of the shift


def secant_pair(inp: dict, sigma: complex, **assemble_kw):
    """M(sigma) and the secant M'(sigma)."""
    M = operator.assemble(inp, sigma, **assemble_kw)
    d = D_SIGMA_FRAC * sigma
    M2 = operator.assemble(inp, sigma + d, **assemble_kw)
    return M, (M2 - M) / d


def hessenberg(M, dM, m: int) -> np.ndarray:
    """The (m + 1, m) Hessenberg of ``m`` Arnoldi steps on M^{-1} M', by
    modified Gram-Schmidt with <a, b> = conj(a)^T b, as complex128 numpy."""
    n = M.shape[0]
    rdt = torch.float64 if M.dtype == torch.complex128 else torch.float32
    lu, piv = torch.linalg.lu_factor(M)
    k = torch.arange(n, dtype=rdt, device=M.device)
    v = torch.complex(torch.ones_like(k), 0.3 * k / n)
    V = [v / torch.linalg.vector_norm(v)]
    H = torch.zeros((m + 1, m), dtype=M.dtype, device=M.device)
    for j in range(m):
        w = torch.linalg.lu_solve(lu, piv, (dM @ V[j])[:, None])[:, 0]
        for i in range(j + 1):
            h = torch.dot(V[i].conj(), w)
            w = w - h * V[i]
            H[i, j] = h
        beta = torch.linalg.vector_norm(w)
        H[j + 1, j] = beta
        V.append(w / beta)
    return H.cpu().numpy().astype(np.complex128)


def estimate(inp: dict, sigma: complex, m: int = 24,
             **assemble_kw) -> complex:
    """The survey's estimate at ``sigma``: sigma - 1 / mu for the Ritz
    value mu of largest modulus.  ``assemble_kw``: ``operator.assemble``'s
    (dtype, device, mesh, chunk, round_bits)."""
    M, dM = secant_pair(inp, complex(sigma), **assemble_kw)
    mu = np.linalg.eigvals(hessenberg(M, dM, m)[:m, :m])
    return complex(sigma) - 1.0 / complex(mu[np.argmax(np.abs(mu))])
