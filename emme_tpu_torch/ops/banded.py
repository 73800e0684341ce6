"""Block-banded complex LU factorization, triangular solves and selected
inversion, on complex tensors.

Counterpart of ``emme_tpu/ops/banded.py``.  The shifted systems of the
banded eigensolve (shift-invert Arnoldi, the Newton trace, inverse
iteration) need M(sigma)^{-1} without ever materializing the dense
operator.  The kernel-integral operator is banded (kappa decays in
|eta - eta'|; the singularity handler adds a width-5 band, reference
``src/singularity_handler.cpp:3-24``), so the factorization is a
block-banded LU **without pivoting**, as in the reference:

    for k in block rows:               (nb sequential steps)
        invD_k = inv(W[k, 0])
        for i in 1..h:   L_i = W[k+i, -i] @ invD_k          (stored in place)
        for i,j in 1..h: W[k+i, j-i] -= L_i @ W[k, j]

Banded LU has no fill outside the band, so the factors live in the same
(nb, 2h+1) block-row storage.  No pivoting is safe here in the shift-invert
sense: the diagonal blocks are dominated by the 1 + 1/tau identity term
(solver.h:439-459), and near-singularity at a converged shift is a
*globally* small singular value, which inverse iteration amplifies.

Each sequential step is a few batched complex ``torch.matmul`` calls and
one ``torch.linalg.inv_ex`` of a bs x bs block, so the nb-step chains are
launch-bound on a card.  The factorization and the selected inverse update
their block storage in place (one buffer per call instead of one per step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch


@dataclass(frozen=True)
class BandedLU:
    """Factored block-banded operator.

    W: (nb + h, 2h+1, bs, bs) block-row storage; W[i, h+d] holds the factor
       block at (row i, col i+d): U on d >= 0, unit-L on d < 0.
    invD: (nb, bs, bs) inverses of the U diagonal blocks.
    """
    W: Any
    invD: Any
    n: int
    block: int
    h: int

    @property
    def nb(self) -> int:
        return self.n // self.block


def rowmajor_from_bdia(op) -> tuple:
    """BDIAOperator (diagonal-major) -> (W, h): block-row-major banded
    storage (nb + h, 2h+1, bs, bs), padded with h zero rows so the
    factorization window never leaves the array."""
    nb = op.n // op.block
    h = max(abs(d) for d in op.offsets)
    W = torch.zeros((nb + h, 2 * h + 1, op.block, op.block),
                    dtype=op.data.dtype, device=op.data.device)
    for k, d in enumerate(op.offsets):
        W[:nb, h + d] = op.data[k]
    return W, h


def banded_lu(op) -> BandedLU:
    """Factor a BDIAOperator in place of its band storage: nb sequential
    steps, each one block inverse and two batched matmuls (L = rows @ invD
    over i; the update L_i U_j over (i, j)).  Row i of the window takes L_i
    at band column h-i and -L_i U_j at columns h+j-i (j = 1..h), written
    by two indexed stores.  ``W`` is updated in place."""
    W, h = rowmajor_from_bdia(op)
    nb, bs = op.n // op.block, op.block
    dev = W.device
    invD = torch.empty((nb, bs, bs), dtype=W.dtype, device=dev)
    ivec = torch.arange(1, h + 1, device=dev)
    rows_u = ivec[:, None].expand(h, h)                         # i
    cols_u = h + ivec[None, :] - ivec[:, None]                  # h + j - i
    for k in range(nb):
        iD = torch.linalg.inv_ex(W[k, h]).inverse   # no host sync on info
        invD[k] = iD
        if h:
            L = W[k + ivec, h - ivec] @ iD                      # (h, bs, bs)
            upd = L[:, None] @ W[k, h + 1:][None]               # (h, h, ...)
            W[k + rows_u, cols_u] -= upd      # (row, column) pairs unique
            W[k + ivec, h - ivec] = L
    return BandedLU(W=W, invD=invD, n=op.n, block=bs, h=h)


def banded_solve(lu: BandedLU, x):
    """Solve M z = x given the banded factorization; x of shape (n,) or
    (n, r).  Forward substitution with the unit-L band, then backward with
    U through the stored diagonal-block inverses; each step's h-term sum
    is one batched matmul over the window of h neighbouring segments."""
    nb, bs, h = lu.nb, lu.block, lu.h
    vec = x.dim() == 1
    b = (x[:, None] if vec else x).reshape(nb, bs, -1)
    r = b.shape[-1]
    W = lu.W
    # forward: y[k] = b[k] - sum_{i=1..h} L[k, -i] y[k-i]; Y holds h zero
    # segments in front so the window Y[k:k+h] = y[k-h .. k-1]
    Y = torch.zeros((nb + h, bs, r), dtype=b.dtype, device=b.device)
    for k in range(nb):
        Y[h + k] = b[k] - (W[k, :h] @ Y[k:k + h]).sum(0) if h else b[k]
    # backward: z[k] = invD[k] (y[k] - sum_{j=1..h} U[k, +j] z[k+j]); Z
    # holds h zero segments past the end
    Z = torch.zeros((nb + h, bs, r), dtype=b.dtype, device=b.device)
    for k in range(nb - 1, -1, -1):
        t = Y[h + k] - (W[k, h + 1:] @ Z[k + 1:k + 1 + h]).sum(0) \
            if h else Y[h + k]
        Z[k] = lu.invD[k] @ t
    z = Z[:nb].reshape(lu.n, r)
    return z[:, 0] if vec else z


def banded_selected_inverse(lu: BandedLU):
    """Upper-band blocks of Z = M^{-1} for complex-SYMMETRIC banded M, by
    block Takahashi recurrences on the banded LU (selected inversion).

    The Newton-trace update needs tr(M^{-1} dM) (solver.h:113-160); dM is
    banded, so only the entries of M^{-1} inside the band are required, and
    those close on themselves: with M = L D U~ (U~_ik = D_i^{-1} U_ik),

        Z_ij = -sum_{k=i+1..i+h} U~_ik Z_kj          (j > i)
        Z_ii = D_i^{-1} - sum_{k=i+1..i+h} U~_ik Z_ki

    evaluated backward from the bottom-right corner; lower entries mirror
    by the symmetry Z_kj = Z_jk^T (a transpose, not a conjugate).

    Returns Zu: (nb, h+1, bs, bs) with Zu[i, d] = Z_{i, i+d} (zero past
    the bottom edge).  Zu is filled in place, row by row."""
    nb, bs, h = lu.nb, lu.block, lu.h
    W, invD = lu.W, lu.invD
    dev = W.device
    Zu = torch.zeros((nb + h, h + 1, bs, bs), dtype=W.dtype, device=dev)
    if h == 0:
        Zu[:nb, 0] = invD
        return Zu[:nb]
    # Zsel[dj-1, dk-1] = Z_{i+dk, i+dj}: win[dk-1, dj-dk] when dj >= dk,
    # else the mirror transpose(win[dj-1, dk-dj])
    djv = np.arange(1, h + 1)[:, None]
    dkv = np.arange(1, h + 1)[None, :]
    lower = djv >= dkv
    sel_a = torch.as_tensor(np.where(lower, dkv - 1, djv - 1), device=dev)
    sel_b = torch.as_tensor(np.where(lower, djv - dkv, dkv - djv), device=dev)
    upper = torch.as_tensor(~lower, device=dev)[..., None, None]
    for i in range(nb - 1, -1, -1):
        iD = invD[i]
        ut = iD @ W[i, h + 1:]                            # (h, bs, bs)
        win = Zu[i + 1:i + 1 + h]                         # rows i+1 .. i+h
        Zsel = win[sel_a, sel_b]                          # (h, h, bs, bs)
        Zsel = torch.where(upper, Zsel.transpose(-1, -2), Zsel)
        z_off = -(ut[None] @ Zsel).sum(1)                 # rows dj = 1..h
        Zu[i, 0] = iD - (ut @ z_off.transpose(-1, -2)).sum(0)
        Zu[i, 1:] = z_off
    return Zu[:nb]


def banded_trace_product(Zu, op):
    """tr(M^{-1} A) for complex-symmetric banded M (Zu from
    ``banded_selected_inverse``) and complex-symmetric BDIAOperator A:
    since both are symmetric, tr(Z A) = sum over the band of Z_ij A_ij
    elementwise -- the diagonal block column once, the others twice.
    Returns a complex 0-d tensor."""
    h = max(op.offsets)
    tr = torch.zeros((), dtype=Zu.dtype, device=Zu.device)
    for d in range(h + 1):
        w = 1.0 if d == 0 else 2.0
        tr = tr + w * (Zu[:, d] * op.data[op.offsets.index(d)]).sum()
    return tr
