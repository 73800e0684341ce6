"""Complex dense linear algebra for the eigensolve.

Counterpart of ``emme_tpu/ops/linalg.py``.  torch has complex LU, SVD and
triangular solves on the CPU and on CUDA, so everything here runs directly
on complex tensors (``emme_tpu`` needed (re, im) planes and a real 2n x 2n
embedding on the TPU; neither is ported).
"""

from __future__ import annotations

import torch


def complex_solve(M, C):
    """Solve M X = C for complex square M, complex RHS C (matrix or vector)."""
    return torch.linalg.solve(M, C)


def complex_solve_trace(M, dM):
    """trace(M^{-1} dM) -- the Newton-trace-secant denominator
    (solver.h:129-139).  ``solve_ex`` without its error check: the check
    is a host wait, and a singular M shows as a non-finite trace, which the
    solve loops test for."""
    X, _info = torch.linalg.solve_ex(M, dM, check_errors=False)
    return torch.trace(X)


def complex_bilinear(v, M):
    """v^T M v, unconjugated (M is complex symmetric: its left null vector
    is the transpose of the right one)."""
    return torch.dot(v, M @ v)


def _real_dtype(M):
    return torch.float64 if M.dtype == torch.complex128 else torch.float32


def qr_column_pivoted(M):
    """Householder QR with column pivoting (Businger-Golub greedy pivot on
    trailing column norms -- the algorithm family behind LAPACK ``zgeqp3``,
    which the reference's QR-secant iteration calls at solver.h:246-252).

    The pivot rule and the phase convention are ``emme_tpu``'s: the pivot
    is the first column of largest trailing norm, with the norms recomputed
    exactly every step (no downdating drift), and
    beta = -(alpha / |alpha|) * ||x||.  torch has no pivoted QR, so this is
    a host-driven loop of n steps of small tensor operations, none of which
    waits for the device (the pivot index stays a device tensor); on a card
    it is bound by its launches.

    Returns (V, tau, R, perm): packed unit-lower reflectors
    (V[:, k] = v_k, v_k[k] = 1), their taus, the triangular factor, and the
    column permutation (M[:, perm] = Q R, Q = H_0 ... H_{n-1},
    H_k = I - tau_k v_k v_k^H)."""
    n = M.shape[-1]
    rdtype = _real_dtype(M)
    dev = M.device
    A = M.clone()
    perm = torch.arange(n, device=dev)
    V = torch.zeros_like(A)
    tau = torch.zeros(n, dtype=M.dtype, device=dev)
    tiny = torch.finfo(rdtype).tiny
    one = torch.ones((), dtype=M.dtype, device=dev)
    zero = torch.zeros((), dtype=M.dtype, device=dev)

    for k in range(n):
        # greedy pivot: largest trailing column norm among columns >= k
        T = A[k:, k:]
        nrm2 = (T.real * T.real + T.imag * T.imag).sum(dim=0)
        j = (torch.argmax(nrm2) + k).reshape(1)

        # swap columns k <-> j (matrix + permutation record)
        col_k = A[:, k].clone()
        A[:, k] = A.index_select(1, j)[:, 0]
        A.index_copy_(1, j, col_k[:, None])
        p_k = perm[k].clone()
        perm[k] = perm.index_select(0, j)[0]
        perm.index_copy_(0, j, p_k.reshape(1))

        # Householder vector for x = A[k:, k]
        x = A[k:, k]
        normx = torch.sqrt((x.real * x.real + x.imag * x.imag).sum())
        alpha = x[0]
        absa = torch.sqrt(alpha.real * alpha.real + alpha.imag * alpha.imag)
        # beta = -(alpha / |alpha|) normx  (alpha = 0 -> beta = -normx)
        ph = torch.where(absa > 0, alpha / torch.clamp_min(absa, tiny), one)
        beta = -ph * normx
        # v = x - beta e_k, normalized to v[k] = 1: v = x / (alpha - beta)
        d = alpha - beta
        d2 = d.real * d.real + d.imag * d.imag
        degen = d2 < tiny                # x = 0: H = I (tau = 0)
        d2s = torch.where(degen, torch.ones_like(d2), d2)
        v = x * (d.conj() / d2s)
        v[0] = 1.0
        # tau = (beta - alpha) / beta = -d / beta
        b2 = beta.real * beta.real + beta.imag * beta.imag
        b2s = torch.where(degen, torch.ones_like(b2), b2)
        t = torch.where(degen, zero, -(d * beta.conj()) / b2s)

        # A <- (I - tau v v^H) A : w = v^H A, A -= v (tau w)
        w = v.conj() @ T
        T -= v[:, None] * (t * w)[None, :]
        # column k below the diagonal is exactly zero by construction
        A[k + 1:, k] = 0.0

        V[k:, k] = v
        tau[k] = t
    return V, tau, A, perm


def _apply_qH(V, tau, u):
    """u <- Q^H u for Q = H_0 ... H_{n-1} (packed reflectors): apply
    H_k^H = I - conj(tau_k) v_k v_k^H in ascending k."""
    u = u.clone()
    tc = tau.conj()
    for k in range(V.shape[1]):
        vk = V[k:, k]
        u[k:] -= vk * (tc[k] * torch.dot(vk.conj(), u[k:]))
    return u


def qr_secant_delta(M, dM):
    """The reference's TRUE QR-secant update (solver.h:210-383): column-
    pivoted QR M P = Q R; v = P [-R_11^{-1} r; 1] (so M v = R_nn q_n);
    d_omega = -R_nn / (Q^H dM v)_n.  Returns the complex d_omega as a 0-d
    tensor."""
    n = M.shape[-1]
    V, tau, R, perm = qr_column_pivoted(M)
    # back-substitution: R[0:n-1, 0:n-1] w = R[0:n-1, n-1]
    w = torch.linalg.solve_triangular(R[:n - 1, :n - 1], R[:n - 1, n - 1:],
                                      upper=True)[:, 0]
    # v[perm[i]] = -w[i] (i < n-1), v[perm[n-1]] = 1
    v = torch.empty(n, dtype=M.dtype, device=M.device)
    v[perm[:n - 1]] = -w
    v[perm[n - 1:]] = 1.0
    u = _apply_qH(V, tau, dM @ v)
    return -R[n - 1, n - 1] / u[n - 1]


NULL_VECTOR_ROUTE = {"svd": 0, "inverse": 0, "singular": 0}


def null_space_vector(M, method: str | None = None):
    """Null-space (least-singular right-singular) vector of M, conjugated to
    match the reference's nullSpace() output convention (solver.h:58-112).

    Methods, each call counted in ``NULL_VECTOR_ROUTE``:
      * ``svd`` (default for a CPU tensor): exact reference semantics.
      * ``inverse`` (default for a CUDA tensor, as ``emme_tpu`` picks it on
        its accelerator): inverse iteration -- one complex LU and two solves
        amplify the null direction by 1/sigma_min, from ``emme_tpu``'s start
        vector 1 + 0.3i in every entry, normalised each sweep.  This is the
        eigenvector of M's least eigenvalue, not the singular vector.
      * ``singular``: the SVD's vector without the SVD -- the same LU and
        start, and two sweeps of inverse iteration on M^H M, each an adjoint
        solve then a solve (M^{-1} M^{-H}: the right singular vector;
        the other order gives the left one).  A sweep shrinks the other
        directions by (sigma_min / sigma_2)^2, so near a root of det M two
        sweeps reach the SVD's vector to rounding.  No host read.
    """
    if method is None:
        method = "inverse" if M.is_cuda else "svd"
    if method not in NULL_VECTOR_ROUTE:
        raise ValueError(f"method must be one of {tuple(NULL_VECTOR_ROUTE)}, "
                         f"got {method!r}")
    NULL_VECTOR_ROUTE[method] += 1
    if method == "svd":
        _, _, vh = torch.linalg.svd(M)
        return vh[-1, :].conj().resolve_conj()
    lu, piv, _info = torch.linalg.lu_factor_ex(M, check_errors=False)
    z = torch.full((M.shape[-1], 1), 1.0 + 0.3j, dtype=M.dtype,
                   device=M.device)
    for _ in range(2):
        if method == "singular":
            z = torch.linalg.lu_solve(lu, piv, z, adjoint=True)
            z = z / torch.linalg.vector_norm(z)
        z = torch.linalg.lu_solve(lu, piv, z)
        z = z / torch.linalg.vector_norm(z)
    return z[:, 0]
