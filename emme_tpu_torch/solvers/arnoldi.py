"""Shift-invert Arnoldi for the nonlinear eigenproblem M(omega) x = 0.

Counterpart of ``emme_tpu/solvers/arnoldi.py`` (its factorization and Ritz
extraction; the dense shift-invert solve and the batched shifts are not
ported yet).  Linearize about a shift sigma,

    M(omega) ~ M(sigma) + (omega - sigma) M'(sigma),

so nontrivial null vectors satisfy B x = mu x with B = M(sigma)^{-1}
M'(sigma) and omega = sigma - 1/mu: the eigenvalues of the pencil closest
to sigma map to the largest |mu|, which Arnoldi finds first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..params import default_device


def arnoldi_factorization(solve_B, n: int, m_krylov: int,
                          dtype=torch.complex128, device=None):
    """m-step Arnoldi on the operator x -> B x given as ``solve_B(x)``.

    Modified Gram-Schmidt on complex vectors with the conjugated inner
    product <a, b> = conj(a)^T b, from the JAX package's start vector
    1 + 0.3 i k / n.  Returns V (m+1, n) and H (m+1, m), complex ``dtype``
    tensors on ``device`` (None: the CUDA card); nothing is read back to the
    host."""
    rdtype = torch.float64 if dtype == torch.complex128 else torch.float32
    device = default_device(device)
    vi = 0.3 * torch.arange(n, dtype=rdtype, device=device) / n
    v = torch.complex(torch.ones_like(vi), vi)
    v = v / torch.linalg.vector_norm(v)
    V = torch.zeros((m_krylov + 1, n), dtype=dtype, device=v.device)
    H = torch.zeros((m_krylov + 1, m_krylov), dtype=dtype, device=v.device)
    V[0] = v
    for j in range(m_krylov):
        w = solve_B(V[j])
        for i in range(j + 1):
            h = torch.vdot(V[i], w)
            w = w - h * V[i]
            H[i, j] = h
        beta = torch.linalg.vector_norm(w)
        H[j + 1, j] = beta
        V[j + 1] = w / torch.clamp_min(beta, 1e-300)
    return V, H


def ritz_from_hessenberg(H, sigma, m_krylov: int):
    """Host-side: eig of the small Hessenberg -> omega estimates sorted by
    |mu| descending (closest to sigma first).  Returns numpy (omegas,
    eigvecs)."""
    if isinstance(H, torch.Tensor):
        H = H.detach().cpu().numpy()
    Hm = np.asarray(H, np.complex128)[:m_krylov, :m_krylov]
    mu, Y = np.linalg.eig(Hm)
    order = np.argsort(-np.abs(mu))
    mu, Y = mu[order], Y[:, order]
    with np.errstate(divide="ignore", invalid="ignore"):
        omegas = complex(sigma) - 1.0 / mu
    return omegas, Y
